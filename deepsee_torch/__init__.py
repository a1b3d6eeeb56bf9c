"""deepsee_torch: the PyTorch/CUDA port of deepsee_tpu for NVIDIA Hopper.

A second package beside the JAX one, ported slice by slice and held against
it by tests/test_torch_*.py.  It imports torch and numpy, never JAX or
deepsee_tpu.  This slice carries 8x 256^2 independent inference:

  config.py      own copy of the configuration the ported modules read
  ops/           resize, one-hot/HR->LR, plain norms, and `modnorm`, the
                 normalize -> modulate -> leaky-ReLU kernel (csrc/modnorm.cu)
  models/        layers, SPADE/SEAN, resblock, generator, style encoders
  system.py      SRSystem: preprocess, encode_style, generate
  weights.py     JAX variable trees -> the port's (reference-layout) state_dict

Activations are NCHW tensors in channels_last memory; public functions keep
the JAX package's NHWC layout.  Kernels are built with nvcc at first use
(ops/_build.py) and run on CUDA tensors only; on CPU tensors every kernel
wrapper computes its plain PyTorch version.
"""

__version__ = "0.1.0"
