"""Breakdown of the root join's cost at real shapes, stereo.

    python3 -m linearsfm_tpu_torch.tools.bench_root [NUM_MAPS] [--cpu]

Counterpart of `tools/bench_root.py` (default 512 maps; the data is
`synth.generate.make_dataset(NUM, "stereo", noise=0.005, seed=7)`). Runs
`DeviceTreeSolver("stereo", method="refine")` up to the root level, then
times, as separate calls on the device at the root's real caps: the gauge
transform (f64), the join including its solve, the dense Schur assembly
(`schur._assemble_schur_dense` on the joined f64 map: kernel K1, with V^-1
and Y = W V^-1[wf] from one launch of kernel K2 and `schur.info_vector`),
the refine solve of that system (`solve.cholesky_solve_refine`, 3
sweeps), the plain f32 solve, the device compaction (`dcompact`) and the
f64 / f32 `Yd @ Wd.T` product alone. Each: one warm call, then the least
wall of 3 synchronised calls. Runs on the card unless --cpu is given (no
CUDA and no --cpu: exit 1).

Deliberate differences from the JAX tool: the tree is planned by
`plan_tree_exact`, as the port's solver plans (the JAX tool used
`plan_tree`), and the root join runs with the solver's own configuration
for the root (`DeviceTreeSolver._level_cfg`), where the JAX tool built a
`JoinConfig` of its own. Stereo only, as the JAX tool.

`root_parts(solver, maps)` does the timing for other callers.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))


def assemble(joined):
    """(S [1, 6M, 6M], E [1, 6M]) of a joined one-lane map, as the dense
    Schur assembly builds them: V^-1 and Y from one K2 launch, the
    information vector, then K1 and the product."""
    from linearsfm_tpu_torch.ops import schur
    j = joined
    _, Yb = schur.inv3x3_wy(j.V, j.W, j.Wpf)
    eP, eF = schur.info_vector(j.poses, j.feats, j.U, j.Uij, j.W, j.Wpf, j.V)
    return schur._assemble_schur_dense(j.U, j.Uij, j.W, j.Wpf, Yb, eP, eF,
                                       j.M)


def root_parts(solver, maps) -> dict:
    """Time the root join's pieces (printing a line each); returns {"ms":
    {piece: ms}, "caps_in", "caps_out", "joined": the joined root map,
    "S", "E": its assembled system}."""
    from linearsfm_tpu_torch.ops import segment

    if solver.datatype != "stereo":
        raise ValueError("bench_root is stereo only")
    # the solver's fixed order (`DeviceTreeSolver.run`)
    with segment.deterministic():
        return _root_parts(solver, maps)


def _root_parts(solver, maps) -> dict:
    import torch
    from linearsfm_tpu_torch import types
    from linearsfm_tpu_torch.core import dcompact
    from linearsfm_tpu_torch.core import join as join_mod
    from linearsfm_tpu_torch.ops import congruence, solve
    from linearsfm_tpu_torch.tools.common import best_ms

    tp, x = solver.prepare(maps)
    for lp in tp.levels[:-1]:
        x, _ = solver._level(x, lp)
    lp = tp.levels[-1]
    G, Mb = types.lanes(x, slice(0, 1)), types.lanes(x, slice(1, 2))
    del x
    cfg = solver._level_cfg(lp)
    print(f"root caps: in={lp.caps_in} out={lp.caps_out}", flush=True)
    ms = {}

    def bench(name, fn):
        ms[name], out = best_ms(fn, solver.device)
        print(f"{name:40s} {ms[name]:10.3f} ms", flush=True)
        return out

    end = bench("transform (root, f64)",
                lambda: congruence.transform_map_stereo(
                    G, Mb.gauge.ref, info_dtype=cfg.info_dtype))
    joined = bench("join incl solve (root)",
                   lambda: join_mod.join_stereo(end, Mb, cfg))[0]
    del end
    S, E = bench("assemble dense S (root, f64)", lambda: assemble(joined))
    bench("solve refine (root)",
          lambda: solve.cholesky_solve_refine(S, E, 3))
    bench("solve f32 (root)",
          lambda: solve.cholesky_solve(S.to(torch.float32),
                                       E.to(torch.float32)))
    bench("dcompact (root)",
          lambda: dcompact.compact_device(joined, *lp.caps_out)[0])
    shape = (6 * joined.M, 3 * joined.N)
    for dt, tag in ((torch.float64, "f64"), (torch.float32, "f32")):
        A = torch.zeros(shape, dtype=dt, device=solver.device)
        B = torch.zeros(shape, dtype=dt, device=solver.device)
        bench(f"matmul {tag} Yd@Wd.T only", lambda: A @ B.T)
        del A, B
    return dict(ms=ms, caps_in=lp.caps_in, caps_out=lp.caps_out,
                joined=joined, S=S, E=E)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("num", nargs="?", type=int, default=512)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from linearsfm_tpu_torch.tools.common import open_device
    device = open_device(args.cpu, "bench_root")
    if device is None:
        return 1
    from synth import generate as gen
    from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver

    maps, _, _ = gen.make_dataset(args.num, "stereo", noise=0.005, seed=7)
    root_parts(DeviceTreeSolver("stereo", method="refine", device=device),
               maps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
