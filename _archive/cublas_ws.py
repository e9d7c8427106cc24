"""Whether a process's first cuBLAS call decides the bits of a solve.

    python3 _archive/cublas_ws.py MODE [--maps 2048]

One process per MODE (run several, compare the digests): mono refine and
mono direct on the 2,048-map covis set (seed 7), each a warm run and a
second run, through `DeviceTreeSolver` on the card; prints each run's
`tools/common.pose_digest`. MODE:
  first-in-scope   no cuBLAS call before the solver's (inside
                   `segment.deterministic()`, which sets
                   CUBLAS_WORKSPACE_CONFIG=:4096:8 for its work when unset)
  matmul-first     one float64 matmul on the card before the solver
  env-first        CUBLAS_WORKSPACE_CONFIG=:4096:8 set at start, then the
                   matmul first
  no-env-*         the same two orders with a scope that leaves the
                   environment alone (`no-env-first-in-scope`,
                   `no-env-matmul-first`)
PyTorch reads CUBLAS_WORKSPACE_CONFIG once per process, at its first
cuBLAS workspace; cuBLAS may pick other algorithms for another workspace.
"""
import contextlib
import os
import sys

sys.path.insert(0, os.getcwd())


def main():
    mode = sys.argv[1]
    n = int(sys.argv[sys.argv.index("--maps") + 1]) if "--maps" in sys.argv \
        else 2048
    if mode == "env-first":
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch
    from synth import generate as gen
    from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
    from linearsfm_tpu_torch.ops import segment
    from linearsfm_tpu_torch.tools.common import pose_digest
    torch.backends.cuda.matmul.allow_tf32 = False
    if mode.startswith("no-env"):
        @contextlib.contextmanager
        def scope():
            segment._fixed += 1
            try:
                yield
            finally:
                segment._fixed -= 1
        segment.deterministic = scope
    if mode.endswith("matmul-first") or mode == "env-first":
        a = torch.ones(512, 512, dtype=torch.float64, device="cuda")
        (a @ a).sum().item()
    maps, _, _ = gen.make_dataset(n, "mono", noise=0.005, seed=7,
                                  covis_radius=6.0, covis_max=6)
    for method in ("refine", "direct"):
        s = DeviceTreeSolver("mono", method=method)
        d = [pose_digest(s.run(maps)) for _ in range(2)]
        print(f"{mode} mono {method}: warm {d[0][:16]} again {d[1][:16]} "
              f"(CUBLAS_WORKSPACE_CONFIG now "
              f"{os.environ.get('CUBLAS_WORKSPACE_CONFIG')})", flush=True)


if __name__ == "__main__":
    main()
