"""Device ms per step of the two Adam updates (deepsee_torch/train/state.py,
TTUR): CUDA events the benchmark records around state.opt_g.step and
state.opt_d.step, summed per step and averaged over the traced window."""


def read(record):
    ms = record.optimizer_ms
    return sum(ms) / len(ms) if ms else None
