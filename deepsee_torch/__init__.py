"""deepsee_torch: the PyTorch/CUDA port of deepsee_tpu for NVIDIA Hopper.

A second package beside the JAX one, ported slice by slice and held against
it by tests/test_torch_*.py.  It imports torch and numpy, never JAX or
deepsee_tpu.  It carries eval-mode inference of every preset, the serving
entry points, GAN training and evaluation on one card, and the data path:

  config.py      own copy of the configuration the ported modules read
  ops/           resize, one-hot/HR->LR, plain norms, pooling, and
                 `modnorm`, the normalize -> modulate -> leaky-ReLU kernel
                 (csrc/modnorm.cu), registered as the custom op
                 torch.ops.deepsee.modnorm, with its training forward and
                 backward (torch.ops.deepsee.modnorm_train / _backward)
  models/        layers, SPADE/SEAN, resblock, generator, style encoders
                 (with the learned style noise and random_style_matrix),
                 the multiscale discriminator, the VGG19 features
  system.py      SRSystem: preprocess, encode_style, generate; in training
                 also discriminate and the VGG features
  losses.py      GAN, feature-matching and VGG losses
  train/         train state and TTUR Adam, the step, the trainer,
                 python -m deepsee_torch.train
  data/          the native image codec (csrc/codec.cpp, built with g++ at
                 first use), transforms, the CelebA / CelebAMask-HQ and
                 synthetic datasets, the threaded loader, the pinned copy
                 of the next batch to the card
  eval/          the metrics, LPIPS, the FID Inception, the evaluator
                 (python -m deepsee_torch.evaluate, .evaluate_folder)
  weights.py     JAX variable trees and reference .pth files <-> state_dicts
  inference/     the explorative modes
  regions.py, utils/   region table, image and style-CSV IO, the
                 iteration counter, loss log and checkpoints of training
  demo.py        python -m deepsee_torch.demo
  serve.py       torch.export serving programs (python -m deepsee_torch.serve)
  server.py      the micro-batching HTTP daemon (python -m deepsee_torch.server)

Activations are NCHW tensors in channels_last memory; public functions keep
the JAX package's NHWC layout.  Kernels are built with nvcc at first use
(ops/_build.py) and run on CUDA tensors only; on CPU tensors every kernel
wrapper computes its plain PyTorch version.
"""

__version__ = "0.1.0"
