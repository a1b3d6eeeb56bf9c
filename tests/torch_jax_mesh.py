"""The JAX package's int8 mesh program, for the port's layout tests: the
forward of tests/test_int8_inference.py's mesh test (preprocess -> encode ->
generate, no noise, eval mode) jitted on `make_mesh(MeshConfig(data,
model))`, the variables sharded by `shard_system_variables` (column/row
shards, or replicated for the spatial layout) and the batch by
`shard_batch` (rows over the data axis; with `spatial`, H over the model
axis too), under `int8_inference(min_ch)`.  Its dynamic scales are global
max-reduces over the whole batch and map."""

import jax
import numpy as np

from deepsee_tpu.config import MeshConfig
from deepsee_tpu.models.layers import int8_inference
from deepsee_tpu.parallel import make_mesh, shard_batch, shard_system_variables


def int8_mesh_fake(system, g, e, batch, *, spatial: bool, data_axis: int = 2,
                   model_axis: int = 2, min_ch: int = 8) -> np.ndarray:
    """The fake (B, H, W, 3) of the JAX SRSystem `system` holding the
    variables g and e, on the numpy `batch`, from the mesh program on the
    first data_axis x model_axis devices."""
    mesh = make_mesh(MeshConfig(data_axis, model_axis))

    def place(v):
        return shard_system_variables(v, mesh, shard_model=not spatial, min_shard_ch=min_ch)

    def fwd(gv, ev, b):
        pre = system.preprocess(b)
        return system.generate(gv, ev, pre, use_full=False, no_noise=True, train=False)[0]

    args = (place(g), place(e),
            shard_batch({k: np.asarray(v) for k, v in batch.items()}, mesh, spatial=spatial))
    with int8_inference(min_ch=min_ch):
        jitted = jax.jit(fwd)
        hlo = jitted.lower(*args).as_text()
        if not any("convolution" in ln and "i8>" in ln for ln in hlo.splitlines()):
            raise AssertionError("the JAX mesh program traced no int8 convolution")
        return np.asarray(jax.device_get(jitted(*args)))
