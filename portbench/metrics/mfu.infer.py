"""The whole inference path's share of the card's published peaks: the
least time the dense peaks allow for the traced window's model operations
(counted once at set-up over the reference on the meta device: the int8
convs' multiply-adds at the int8 rate, every other operation at the bf16
rate) over the window's length, in %."""

from portbench import work


def read(record):
    if record.trace.window_s <= 0 or not record.trace.ops:
        return None
    least = work.least_seconds(record.work.bf16_flops, record.work.int8_ops) * record.units
    return 100.0 * least / record.trace.window_s
