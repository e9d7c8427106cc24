"""How much of `schur_f64_roofline_pct`'s least bytes is padding: one solve
of each direct cell's first set, with `ops/schur._assemble_schur_dense`
wrapped so that each float64 assembly also counts, lane by lane, its live
shapes (U entries and W entries that are not all zero, poses with a
nonzero diagonal U block, landmarks with a nonzero W entry), and
`roofline_schur.least_bytes` of the capacities the span records against
that of the live shapes, per level and for the solve.

    python3 _archive/direct25/padding.py [--cells A,B] [--seed N]
        [--device cuda|cpu] [--root DIR]
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, ROOT)

CELLS = "rs468_mono.covis,rs468_mono.chain,nc3500_stereo_direct.covis"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default=CELLS)
    ap.add_argument("--seed", type=int, default=9250050001)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args()
    import torch
    from benchmark import gen, roofline_schur, run
    from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
    from linearsfm_tpu_torch.ops import kernels, schur
    if args.device == "cuda":
        kernels.build()
    calls = []
    inner = schur._assemble_schur_dense

    def counted(U, Uij, W, Wpf, Yb, eP, eF, M):
        out = inner(U, Uij, W, Wpf, Yb, eP, eF, M)
        if U.dtype != torch.float32:
            P, N = eF.shape[0], eF.shape[1]
            ulive = (U != 0).any(dim=(-1, -2))
            wlive = (W != 0).any(dim=(-1, -2))
            diag = ulive & (Uij[..., 0] == Uij[..., 1])
            m = torch.zeros(P, M, dtype=torch.bool, device=U.device)
            m.scatter_(1, torch.where(diag, Uij[..., 0], 0).long(),
                       diag)
            f = torch.zeros(P, N, dtype=torch.bool, device=U.device)
            f.scatter_(1, torch.where(wlive, Wpf[..., 1], 0).long(), wlive)
            mlive = m.sum(1).double()
            calls.append(dict(
                cap=(P * U.shape[1], P * W.shape[1], P * M, P * N,
                     P * M * M),
                live=(int(ulive.sum()), int(wlive.sum()),
                      int(mlive.sum()), int(f.sum()),
                      int((mlive ** 2).sum())),
                shape=(P, M, N, U.shape[1], W.shape[1])))
        return out

    schur._assemble_schur_dense = counted
    bench = run.Bench(args.root)
    for cell in args.cells.split(","):
        w = bench.cell(cell)
        cfg, mix = bench.config(w["config"]), bench.mix(w["traffic"])
        solver = DeviceTreeSolver(cfg["datatype"], method=cfg["method"],
                                  device=args.device)
        calls.clear()
        solver.run(gen.make_set(cfg, mix, args.seed, 0))
        tot_cap = tot_live = 0
        for i, c in enumerate(calls):
            bc = roofline_schur.least_bytes(*c["cap"])
            bl = roofline_schur.least_bytes(*c["live"])
            tot_cap, tot_live = tot_cap + bc, tot_live + bl
            print(f"{cell} assembly {i + 1} (P, M, N, KU, KW) {c['shape']}: "
                  f"live (U, W, poses, landmarks, poses^2) {c['live']}, "
                  f"bytes caps {bc:.4g} live {bl:.4g} ratio {bc / bl:.3f}",
                  flush=True)
        t = solver._last_timing
        assert roofline_schur.timing_bytes(t) == tot_cap, (
            roofline_schur.timing_bytes(t), tot_cap)
        print(f"{cell}: {len(calls)} assemblies, least bytes of the caps "
              f"{tot_cap:.6g}, of the live shapes {tot_live:.6g}, padding "
              f"factor {tot_cap / tot_live:.4f}", flush=True)
        del solver
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
