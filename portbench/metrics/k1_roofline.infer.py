"""K1 (deepsee_torch/ops/modnorm.py, csrc/modnorm.cu) on the inference path,
as a share of its roofline: the least time of every K1 launch the traced
window's batches made (shapes from the configuration: portbench.work.
path_norms, each input read once and the output written once at the HBM
rate, or the float32 operations at the CUDA cores' rate) over the device
time of the kernels named below.  Nothing when the trace holds none of
them."""

from portbench import work

KERNELS = ("modnorm_affine_kernel", "modnorm_instance_kernel", "modnorm_batch_kernel")


def read(record):
    seconds = record.trace.seconds_of(KERNELS)
    if seconds <= 0:
        return None
    bound_ms = work.infer_k1_bound_ms(record.cfg, record.batch, record.full_trunk,
                                      record.elt_bytes)
    return 100.0 * bound_ms * 1e-3 * record.units / seconds
