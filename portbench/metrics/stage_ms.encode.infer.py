"""Device ms per batch of the style encode (SRSystem.encode_style ->
models/encoder.py): CUDA events the benchmark records before and after the
call, averaged over the traced window's batches."""


def read(record):
    ms = record.stage_ms.get("encode", [])
    return sum(ms) / len(ms) if ms else None
