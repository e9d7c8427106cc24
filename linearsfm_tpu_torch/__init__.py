"""linearsfm-tpu on PyTorch: the hierarchical Linear SFM engine for CUDA GPUs.

The PyTorch port of `linearsfm_tpu` (the JAX reference, which stays beside
it). Module paths mirror the reference one for one (`types`, `ops/`, `core/`,
`io/`, `native/`, `parallel/`, `utils/`, `cli`); both TPU kernels of the
reference, `blockcoo_to_dense` and `inv3x3_sym`, are hand-written CUDA
kernels (`csrc/`, bound in `ops/kernels.py`) on every path, all three
executors included; the second, fused with its consumer, also forms the
products W V^-1[wf] of the Schur complement.

Conventions that replace the reference's JAX configuration:

* Dtypes are explicit at every call: the information path is float64 and the
  Schur preconditioner float32. Nothing sets a global default dtype.
* The entry points (`DeviceTreeSolver`, `TreeSolver`, `DenseTreeSolver`,
  `pipeline.run`) take the reference's parameters and a keyword-only
  `device`, the card by default; `device="cpu"` runs on the CPU, and with
  no CUDA device they raise rather than fall back, as the CLI does
  without `--cpu`. Lower-level functions run where their tensors lie
  (`types.to_torch(..., device)`). `_parity.py` lists where the port's
  public API departs from the reference's, and why.
* float32 matmuls must run in full float32 on the GPU
  (`torch.backends.cuda.matmul.allow_tf32` False, the default), the
  counterpart of the reference's `jax_default_matmul_precision="highest"`;
  the solver refuses to run otherwise.
* `vmap` over the pairs of a tree level becomes an explicit leading lane
  dimension: every map-level function takes lane-stacked maps `[P, ...]`.
"""

from .types import Gauge, LocalMap  # noqa: F401
