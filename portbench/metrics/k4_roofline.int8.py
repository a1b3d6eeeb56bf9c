"""K4 (deepsee_torch/ops/int8conv.py, csrc/int8conv.cu: the W8A8 conv) as a
share of its roofline: the least time of every quantized conv the traced
window's batches ran (the shapes the reference quantized; per conv the
larger of the unpadded activation, float32 weight, bias and output once at
the HBM rate and the multiply-adds at the int8 tensor-core rate) over the
device time of the kernels named below.  The zeroing memsets of the
weight quantization are not matched (a memset has no kernel name).
Nothing when the trace holds none of them."""

from portbench import work

KERNELS = ("absmax_partials_kernel", "absmax_merge_kernel", "quantize_weight_kernel",
           "quantize_activation_kernel", "igemm_kernel")


def read(record):
    seconds = record.trace.seconds_of(KERNELS)
    if seconds <= 0 or not record.work.k4_convs:
        return None
    bound_ms = work.k4_bound_ms(record.work.k4_convs, record.elt_bytes)
    return 100.0 * bound_ms * 1e-3 * record.units / seconds
