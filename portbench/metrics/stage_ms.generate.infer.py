"""Device ms per batch of the generator (SRSystem.generate with the style
passed in -> models/generator.py, blocks.py, normalization.py, layers.py):
CUDA events the benchmark records before and after the call, averaged over
the traced window's batches."""


def read(record):
    ms = record.stage_ms.get("generate", [])
    return sum(ms) / len(ms) if ms else None
