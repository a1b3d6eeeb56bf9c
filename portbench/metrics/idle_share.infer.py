"""The share of the traced inference window in which no operation ran on
the device: 1 - (the union of the device operations' intervals) / (the
window's length), in %."""


def read(record):
    if record.trace.window_s <= 0 or not record.trace.ops:
        return None
    return 100.0 * (1.0 - record.trace.busy_s / record.trace.window_s)
