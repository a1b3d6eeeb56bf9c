"""Device ops of the port: resize, preprocess, norms (plain versions) and
modnorm (hand-written CUDA kernel plus its plain version)."""
