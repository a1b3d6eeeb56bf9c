"""The plain reference of the DeepSEE networks that the benchmark holds the
port against: float32 PyTorch functions over a flat dict of named tensors,
with no kernel, no cache and no batching tricks.

It imports nothing of the port (`deepsee_torch`), of JAX or of the JAX
package.  The benchmark makes the weights and the inputs from the seed and
hands the same tensors to both sides; everything the port derives from them
(LR images, one-hot maps, folded modulation weights, int8 scales and levels,
spectral sigmas) is worked out here again.

  ops.py   one-hot, the bicubic HR -> LR, nearest resizes, the instance and
           running-statistics norms, the W8A8 / W4A4 quantized conv
  nets.py  the parameter names and shapes of every network (`param_spec`),
           the generator (SPADE / SEAN / PureSEAN blocks), both style
           encoders, eval mode
"""
