"""linearsfm-tpu on PyTorch: the hierarchical Linear SFM engine for CUDA GPUs.

The PyTorch port of `linearsfm_tpu` (the JAX reference, which stays beside
it). Module paths mirror the reference one for one (`types`, `ops/`, `core/`,
`utils/`); the one TPU kernel on the stereo main path,
`blockcoo_to_dense`, is a hand-written CUDA kernel (`csrc/`, bound in
`ops/kernels.py`).

Conventions that replace the reference's JAX configuration:

* Dtypes are explicit at every call: the information path is float64 and the
  Schur preconditioner float32. Nothing sets a global default dtype.
* The device is an explicit argument (`types.to_torch(..., device=...)`,
  `DeviceTreeSolver(..., device=...)`); nothing picks one by itself.
* float32 matmuls must run in full float32 on the GPU
  (`torch.backends.cuda.matmul.allow_tf32` False, the default), the
  counterpart of the reference's `jax_default_matmul_precision="highest"`;
  the solver refuses to run otherwise.
* `vmap` over the pairs of a tree level becomes an explicit leading lane
  dimension: every map-level function takes lane-stacked maps `[P, ...]`.
"""

from .types import Gauge, LocalMap  # noqa: F401
