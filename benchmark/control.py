"""The readings that the limits of a cell's check are set from (run on the
card, never by the benchmark's own runs):

    python3 benchmark/control.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 [--json PATH]

For each of --seeds, the first set of that seed's pool is solved by the
program (the cell's solver, as a run builds it) and by the float64
reference, and compared: the sound readings, whose largest is the lower
reading of each number. For each of --control-seeds the same set is
solved by the controls and compared with the float64 reference: the
reference computed in float32, and, where the program has a float32 path
of its own for the configuration (the device executor's float32
information levels, `mixed_max_m`, on method "refine"), the program with
that path on for every level. The smallest a control gives is the upper
reading. A control that raises or returns a non-finite state has failed
and gives no number. Each control reading is also judged against the
configuration's limits, as a run judges the program.

`ReferenceF32` is the float32 reference in the program's place, in the
form a run's window takes (the tests drive a whole run with it).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import compare, gen, reference, run  # noqa: E402


def _set(cfg, mix, seed):
    maps, _, _ = gen.make_dataset(
        cfg["maps"], cfg["datatype"], feats_per_pose=mix["feats_per_pose"],
        noise=mix["noise"], seed=gen.set_seed(seed, 0),
        pattern=mix["pattern"], covis_radius=mix["covis_radius"],
        covis_max=mix["covis_max"])
    return maps


def _program(solver, maps, device):
    import torch
    out = solver.run(maps)
    torch.cuda.synchronize(device)
    if not bool(compare.finite_flag(out)):
        raise FloatingPointError("non-finite pose or landmark")
    return compare.program_map(out)


def as_program_output(lv: reference.Level):
    """A one-map reference `Level` in the form of the program's fused map
    (tensors under the port's LocalMap field names): its information split
    into pose-pose blocks (upper triangle), pose-landmark blocks and
    landmark blocks, as `compare.program_map` reads them back."""
    import torch
    from types import SimpleNamespace
    NP, NF = lv.NP, len(lv.fid)
    D = lv.info.toarray()
    P = D[:6 * NP, :6 * NP].reshape(NP, 6, NP, 6).transpose(0, 2, 1, 3)
    ui, uj = np.nonzero(np.triu(np.abs(P).sum((2, 3)) > 0))
    Wd = D[:6 * NP, 6 * NP:].reshape(NP, 6, NF, 3).transpose(0, 2, 1, 3)
    wp, wf = np.nonzero(np.abs(Wd).sum((2, 3)) > 0)
    f = np.arange(NF)
    V = D[6 * NP:, 6 * NP:].reshape(NF, 3, NF, 3)[f, :, f, :]
    t = torch.from_numpy
    return SimpleNamespace(
        pose_ids=t(lv.pid), poses=t(np.ascontiguousarray(lv.X)),
        feat_ids=t(lv.fid), feats=t(np.ascontiguousarray(lv.F)),
        U=t(P[ui, uj]), Uij=t(np.stack([ui, uj], 1)), W=t(Wd[wp, wf]),
        Wpf=t(np.stack([wp, wf], 1)), V=t(np.ascontiguousarray(V)))


class ReferenceF32:
    """The control in the program's place: each run solves the maps by
    the reference in float32 (takes a solver's arguments)."""

    def __init__(self, datatype, method=None, device="cpu", **_):
        self.datatype, self.device = datatype, device

    def run(self, maps):
        return as_program_output(reference.solve_tree(
            maps, self.datatype, np.float32, device=self.device))


def verdict(gaps: dict, limits: dict) -> str:
    """'fails (...)' naming each number over its limit, else 'passes'."""
    over = [f"{k} {gaps.get(k)!r} > {v!r}" for k, v in limits.items()
            if not gaps.get(k, np.inf) <= v]
    return f"fails ({', '.join(over)})" if over else "passes"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--json")
    args = ap.parse_args(argv)
    import torch
    from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
    if not torch.cuda.is_available():
        run.log("needs a CUDA card")
        return 2
    device = "cuda"
    bench = run.Bench()
    cell = bench.cell(args.workload)
    cfg, mix = bench.config(cell["config"]), bench.mix(cell["traffic"])
    dt = cfg["datatype"]
    run.log(f"card: {run.card()}")
    solver = DeviceTreeSolver(dt, method=cfg["method"], device=device)
    own = (DeviceTreeSolver(dt, method=cfg["method"], mixed_max_m=10**9,
                            device=device)
           if cfg["method"] == "refine" else None)
    rec = dict(workload=args.workload, sound=[], reference_f32=[],
               program_f32=[])
    seeds = [int(s) for s in args.seeds.split(",")]
    cseeds = [int(s) for s in args.control_seeds.split(",")]
    for s in sorted(set(seeds) | set(cseeds)):
        maps = _set(cfg, mix, s)
        t = time.perf_counter()
        want = reference.solve_tree(maps, dt, np.float64, device=device)
        t_ref = time.perf_counter() - t
        if s in seeds:
            got = _program(solver, maps, device)
            rec["sound"].append(dict(seed=s, ref_s=t_ref,
                                     **compare.gaps(got, want)))
            run.log(f"seed {s} sound {rec['sound'][-1]}")
        if s in cseeds:
            for name, fn in (
                    ("reference_f32", lambda: reference.solve_tree(
                        maps, dt, np.float32, device=device)),
                    ("program_f32", None if own is None else
                     lambda: _program(own, maps, device))):
                if fn is None:
                    continue
                try:
                    g = compare.gaps(fn(), want)
                except Exception as exc:  # a control that fails gives no number
                    g = dict(failed=f"{type(exc).__name__}: {exc}")
                rec[name].append(dict(seed=s, **g))
                run.log(f"seed {s} {name} {rec[name][-1]}: "
                        f"{verdict(g, cfg['limits'])}")
        torch.cuda.empty_cache()
    for k in ("id_mismatch", "pose_gap", "feat_gap", "info_gap"):
        low = max((r[k] for r in rec["sound"]), default=None)
        ups = [r[k] for c in ("reference_f32", "program_f32")
               for r in rec[c] if k in r]
        print(f"{k}: lower {low!r} upper {min(ups) if ups else None!r}",
              flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(rec, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
