"""K1 (deepsee_torch/ops/modnorm.py, csrc/modnorm.cu) in the training step,
forward and backward, as a share of its roofline: the least time of every
K1 launch of the traced window's steps (shapes from the configuration:
portbench.work.train_norms; each input read once and each output written
once at the HBM rate, or the float32 operations at the CUDA cores' rate)
over the device time of the kernels named below.  Nothing when the trace
holds none of them."""

from portbench import work

KERNELS = ("modnorm_batch_kernel", "modnorm_instance_kernel", "modnorm_affine_kernel",
           "modnorm_instance_backward_kernel", "backward_partial_kernel",
           "backward_final_kernel", "backward_apply_kernel")


def read(record):
    seconds = record.trace.seconds_of(KERNELS)
    if seconds <= 0:
        return None
    bound_ms = work.train_k1_bound_ms(record.cfg, record.batch, record.elt_bytes)
    return 100.0 * bound_ms * 1e-3 * record.units / seconds
