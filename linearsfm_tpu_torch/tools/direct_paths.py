"""Two measurements of the direct (float64 Cholesky) paths at 2,048 maps,
one GPU.

    python3 -m linearsfm_tpu_torch.tools.direct_paths [--parts schur,ate]
        [--paths stereo,mono] [--reps 3] [--out direct_paths_out]
        [--maps 2048] [--cpu]

The data is `chip_smoke.py`'s 2,048-map covis set (seed 7, noise 0.005,
covis radius 6, at most 6 co-visible features per map).

schur: grouped against dense Schur assembly on the host executor
(`TreeSolver(datatype, method="direct")`, the CLI's `--exec host`). One run
of the tree keeps each batched level's inputs (the lane stacks and
`JoinConfig` that `TreeSolver._merge` receives: levels 1-10; the root is a
single pair). Each level's join then runs again on those inputs as shipped
(grouped below `schur._DENSE_SCHUR_DIM`, else dense) and forced dense
(`dense_schur=True`), alternating shipped, dense, dense, shipped for --reps
rounds. Reported per level: the join's wall (synchronised before and after;
the host executor waits for exactly this), min and median, K1 and K2
launches per join, and the largest pose difference between the two.

ate: run-to-run spread of the device executor's direct path
(`DeviceTreeSolver(datatype, method="direct")`, the CLI's default) — --reps
runs with PyTorch's defaults, then --reps runs under
`torch.use_deterministic_algorithms(True, warn_only=True)` (index_add_ and
index_put_ sum in a fixed order; the operations that still warn are
listed). Each run prints its ATE to 12 digits and its largest pose
difference from the mode's first run. The first run also reports the
condition number of the root's reduced system over its free coordinates
(eigenvalues by `torch.linalg.eigvalsh`, float64).
CUBLAS_WORKSPACE_CONFIG=:4096:8 is set for the whole process, as the
deterministic mode requires.

The card's name and power limit come first; one JSON file per part goes to
--out. --cpu (with a small --maps) rehearses the tool on the CPU.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

ORACLE_ATE_2048 = {"stereo": 0.009758730, "mono": 0.014352172}
_run = {"device": "cuda", "maps": 2048}


def _sync():
    import torch
    if _run["device"] == "cuda":
        torch.cuda.synchronize()


@functools.lru_cache(maxsize=None)
def _dataset(datatype):
    from synth import generate as gen
    maps, poses_gt, _ = gen.make_dataset(_run["maps"], datatype, noise=0.005,
                                         seed=7, covis_radius=6.0,
                                         covis_max=6)
    return maps, poses_gt


def _poses(lm):
    """{pose id: pose} of a solved map (host form or one-lane stack)."""
    from linearsfm_tpu_torch import types
    h = types.host_fields(lm)
    return {int(i): h.poses[s] for s, i in enumerate(h.pose_ids) if i >= 0}


def _ate(poses, poses_gt):
    import numpy as np
    err = [float(np.linalg.norm(p[:3] - poses_gt[i][:3]))
           for i, p in poses.items()]
    return float(np.sqrt(np.mean(np.square(err))))


def _max_diff(a, b):
    import numpy as np
    if set(a) != set(b):
        return float("nan")
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


def schur_part(datatype, reps):
    """Grouped (as shipped) against forced-dense assembly per level of the
    host executor; returns one record per batched level."""
    import torch
    from linearsfm_tpu_torch.core.tree import TreeSolver
    from linearsfm_tpu_torch.ops import kernels, schur

    maps, poses_gt = _dataset(datatype)
    solver = TreeSolver(datatype, method="direct", device=_run["device"])
    kept = []
    merge = solver._merge

    def keep(G, Mb, cfg):
        kept.append((G, Mb, cfg))
        return merge(G, Mb, cfg)
    solver._merge = keep
    t0 = time.perf_counter()
    root = solver.run(maps)
    _sync()
    wall = time.perf_counter() - t0
    solver._merge = merge
    print(f"schur {datatype}: host executor run {wall:.3f} s, ATE "
          f"{_ate(_poses(root), poses_gt):.12f}, {len(kept)} batched levels "
          f"kept", flush=True)

    def timed(G, Mb, cfg):
        n0 = dict(kernels.launches)
        _sync()
        t = time.perf_counter()
        out = solver._merge(G, Mb, cfg)
        _sync()
        dt = time.perf_counter() - t
        return dt, out, {k: kernels.launches[k] - n0[k] for k in n0}

    rows = []
    for level, (G, Mb, cfg) in enumerate(kept, start=1):
        Mo = G.M + Mb.M
        shipped = ("dense" if cfg.dense_schur
                   or 6 * Mo >= schur._DENSE_SCHUR_DIM else "grouped")
        dense = cfg._replace(dense_schur=True)
        timed(G, Mb, cfg)          # warm-up of both
        timed(G, Mb, dense)
        ts, td = [], []
        for _ in range(reps):
            ts.append(timed(G, Mb, cfg)[0])
            td.append(timed(G, Mb, dense)[0])
            td.append(timed(G, Mb, dense)[0])
            ts.append(timed(G, Mb, cfg)[0])
        _, a, la = timed(G, Mb, cfg)
        _, b, lb = timed(G, Mb, dense)
        diff = float((a.poses - b.poses).abs().max())
        r = dict(level=level, lanes=int(G.poses.shape[0]), Mo=Mo,
                 six_M=6 * Mo, No=G.N + Mb.N, max_obs=cfg.max_obs,
                 shipped=shipped,
                 shipped_s=ts, dense_s=td, shipped_launches=la,
                 dense_launches=lb, max_pose_diff=diff)
        rows.append(r)
        print(f"schur {datatype} level {level:2d}: {r['lanes']:4d} lanes, "
              f"Mo {Mo:5d} (6M {6 * Mo:5d}), No {r['No']:6d}, max_obs "
              f"{cfg.max_obs:3d}; shipped ({shipped}) min "
              f"{min(ts) * 1e3:.3f} ms median "
              f"{statistics.median(ts) * 1e3:.3f} ms, launches {la}; forced "
              f"dense min {min(td) * 1e3:.3f} ms median "
              f"{statistics.median(td) * 1e3:.3f} ms, launches {lb}; max pose "
              f"diff {diff:.3e}", flush=True)
        del a, b
    tot_s = sum(min(r["shipped_s"]) for r in rows)
    tot_d = sum(min(r["dense_s"]) for r in rows)
    print(f"schur {datatype}: sum over levels of the min join wall: shipped "
          f"{tot_s * 1e3:.3f} ms, forced dense {tot_d * 1e3:.3f} ms",
          flush=True)
    return dict(datatype=datatype, run_s=wall, levels=rows)


def _root_condition(captured):
    """Condition number of the largest reduced system seen, over its free
    coordinates (float64 eigenvalues)."""
    import torch
    S, fixed = captured
    free = (~fixed[0]).nonzero().reshape(-1)
    Sf = S[0].index_select(0, free).index_select(1, free)
    ev = torch.linalg.eigvalsh(Sf)
    lo, hi = float(ev[0]), float(ev[-1])
    return dict(dim=int(Sf.shape[0]), eig_min=lo, eig_max=hi,
                cond=hi / lo if lo > 0 else float("inf"))


def ate_part(datatype, reps):
    """Run-to-run spread of the direct device executor, default and
    deterministic; returns the runs' ATEs and pose spreads."""
    import torch
    from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
    from linearsfm_tpu_torch.ops import solve

    maps, poses_gt = _dataset(datatype)
    solver = DeviceTreeSolver(datatype, method="direct",
                              device=_run["device"])
    solver.run(maps)                   # warm-up
    out = dict(datatype=datatype, oracle=ORACLE_ATE_2048[datatype])
    for mode in ("default", "deterministic"):
        torch.use_deterministic_algorithms(mode == "deterministic",
                                           warn_only=True)
        runs, first, warned = [], None, set()
        for rep in range(reps):
            captured = []
            reduced = solve.solve_reduced

            def keep(S, E, fixed_mask=None, *a, **k):
                big = not captured or S.shape[-1] > captured[0][0].shape[-1]
                if fixed_mask is not None and big:
                    captured[:] = [(S, fixed_mask)]
                return reduced(S, E, fixed_mask, *a, **k)
            if rep == 0 and mode == "default":
                solve.solve_reduced = keep
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t0 = time.perf_counter()
                try:
                    p = _poses(solver.run(maps))
                finally:
                    solve.solve_reduced = reduced
                wall = time.perf_counter() - t0
            warned |= {str(w.message).split("\n")[0][:160] for w in caught
                       if "deterministic" in str(w.message)}
            first = first or p
            r = dict(ate=_ate(p, poses_gt), wall_s=wall,
                     max_pose_diff_vs_first=_max_diff(p, first))
            runs.append(r)
            print(f"ate {datatype} {mode} run {rep}: ATE {r['ate']:.12f} "
                  f"(oracle {out['oracle']:.9f}, diff "
                  f"{r['ate'] - out['oracle']:+.3e}), max pose diff vs the "
                  f"first run {r['max_pose_diff_vs_first']:.3e}, wall "
                  f"{wall:.3f} s", flush=True)
            if captured:
                c = _root_condition(captured[0])
                out["root"] = c
                print(f"ate {datatype}: root reduced system over its "
                      f"{c['dim']} free coordinates: eigenvalues "
                      f"{c['eig_min']:.6e} .. {c['eig_max']:.6e}, condition "
                      f"number {c['cond']:.6e}", flush=True)
                del captured[:]
        spread = max(r["ate"] for r in runs) - min(r["ate"] for r in runs)
        out[mode] = dict(runs=runs, ate_spread=spread,
                         still_nondeterministic=sorted(warned))
        print(f"ate {datatype} {mode}: ATE spread over {reps} runs "
              f"{spread:.3e}; operations without a deterministic version "
              f"that ran: {sorted(warned) or 'none'}", flush=True)
    torch.use_deterministic_algorithms(False)
    return out


def main(argv=None) -> int:
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parts", default="schur,ate")
    ap.add_argument("--paths", default="stereo,mono")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default="direct_paths_out")
    ap.add_argument("--maps", type=int, default=2048)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    _run.update(device="cpu" if args.cpu else "cuda", maps=args.maps)
    if not args.cpu and not torch.cuda.is_available():
        print("direct_paths: no CUDA device", file=sys.stderr)
        return 2
    if not args.cpu:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)
    parts = {"schur": schur_part, "ate": ate_part}
    for part in args.parts.split(","):
        rep = [parts[part](d, args.reps) for d in args.paths.split(",")]
        with open(os.path.join(args.out, f"direct_paths_{part}.json"),
                  "w") as fh:
            json.dump(rep, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
