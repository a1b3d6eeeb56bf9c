"""The whole training step's share of the card's published bf16 peak: the
least time the dense peak allows for the traced window's model operations
(a step's forward and backward of the G update and the D update, the
regeneration included, counted once at set-up over the reference on the
meta device) over the window's length, in %."""

from portbench import work


def read(record):
    if record.trace.window_s <= 0 or not record.trace.ops:
        return None
    least = work.least_seconds(record.work.bf16_flops, record.work.int8_ops) * record.units
    return 100.0 * least / record.trace.window_s
