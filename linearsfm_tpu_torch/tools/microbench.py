"""Microbenchmark of join-internal pieces at a tree-level shape.

    python3 -m linearsfm_tpu_torch.tools.microbench [B] [M] [N] [KU] [KW] [O]
        [--cpu]

Counterpart of `tools/microbench.py`, with its positional shape arguments
and defaults (B 256 pairs, joint pose capacity M 32, feature capacity N
32, KU 128 and KW 128 block-list lengths, O 4 observations per feature;
random data from numpy's seed 0). Answers where the time of one batched
level goes, piece by piece, in torch: the batched Cholesky
(`torch.linalg.cholesky`) in f64 and f32, Cholesky + two triangular solves
(`ops/solve.solve_factored`), the dense S scatter-add (`index_put_` with
accumulate=True) and its one-hot einsum form, `schur.group_by_feature`
with the pair products, the eP segment sum (`index_add_`,
`ops/segment.seg_sum`), a stable argsort of [KW] x B and the 6x6
congruence einsum. Each: one warm call, then the least wall of 3
synchronised calls. Runs on the card unless --cpu is given (no CUDA and no
--cpu: exit 1).
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    for name, default in (("B", 256), ("M", 32), ("N", 32), ("KU", 128),
                          ("KW", 128), ("O", 4)):
        ap.add_argument(name, nargs="?", type=int, default=default)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from linearsfm_tpu_torch.tools.common import open_device
    dev = open_device(args.cpu, "microbench")
    if dev is None:
        return 1
    import numpy as np
    import torch
    from linearsfm_tpu_torch.ops import schur, solve
    from linearsfm_tpu_torch.ops.segment import seg_sum
    from linearsfm_tpu_torch.tools.common import best_ms

    B, M, N, KU, KW, O = (args.B, args.M, args.N, args.KU, args.KW, args.O)
    f32, f64 = torch.float32, torch.float64

    def bench(name, fn):
        ms, _ = best_ms(fn, dev)
        print(f"{name:38s} {ms:10.3f} ms", flush=True)

    def put(a):
        return torch.as_tensor(a).to(dev)

    rng = np.random.default_rng(0)
    D = 6 * M
    A = rng.normal(size=(B, D, D))
    S64 = put(np.einsum("bij,bkj->bik", A, A) + 10 * np.eye(D))
    E64 = put(rng.normal(size=(B, D)))
    S32, E32 = S64.to(f32), E64.to(f32)
    print(f"B={B} M={M} N={N} KU={KU} KW={KW} O={O}  (D={D})", flush=True)

    bench("cholesky f64", lambda: torch.linalg.cholesky(S64))
    bench("cholesky f32", lambda: torch.linalg.cholesky(S32))
    bench("cho+2tri f64",
          lambda: solve.solve_factored(torch.linalg.cholesky(S64), E64))
    bench("cho+2tri f32",
          lambda: solve.solve_factored(torch.linalg.cholesky(S32), E32))

    U = put(rng.normal(size=(B, KU, 6, 6)))
    ui = put(rng.integers(0, M, (B, KU)))
    uj = put(rng.integers(0, M, (B, KU)))
    lane = torch.arange(B, device=dev)[:, None].expand(B, KU)

    def scatter_S(U):
        S = torch.zeros((B, M, M, 6, 6), dtype=U.dtype, device=dev)
        S.index_put_((lane, ui, uj), U, accumulate=True)
        return S.transpose(2, 3)            # [B, M, 6, M, 6]

    bench("S scatter-add f64", lambda: scatter_S(U))
    bench("S scatter-add f32", lambda: scatter_S(U.to(f32)))

    def onehot_S(U):
        oi = torch.nn.functional.one_hot(ui, M).to(U.dtype)      # [B, KU, M]
        oj = torch.nn.functional.one_hot(uj, M).to(U.dtype)
        T = torch.einsum("zkij,zkb->zikbj", U, oj).reshape(B, 6, KU, 6 * M)
        return torch.einsum("zka,zikx->zaix", oi, T).reshape(B, M, 6, M, 6)

    bench("S one-hot einsum f64", lambda: onehot_S(U))
    bench("S one-hot einsum f32", lambda: onehot_S(U.to(f32)))

    W = put(rng.normal(size=(B, KW, 6, 3)))
    Wpf = torch.stack([put(rng.integers(0, M, (B, KW))),
                       put(rng.integers(0, N, (B, KW)))], dim=-1)
    Vi = put(rng.normal(size=(B, N, 3, 3)))
    lanes = torch.arange(B, device=dev)[:, None, None]

    def grouped():
        entry, valid, _ = schur.group_by_feature(Wpf, N, O)
        Wg = W[lanes, entry] * valid[..., None, None]       # [B, N, O, 6, 3]
        Yc = torch.einsum("znofk,znkl->znofl", Wg, Vi)
        return torch.einsum("znofk,znpgk->znopfg", Yc, Wg)

    bench("group_by_feature+pairprod f64", grouped)
    ones = torch.ones((B, KW, 3), dtype=f64, device=dev)
    bench("segment_sum eP f64",
          lambda: seg_sum(torch.einsum("zkif,zkf->zki", W, ones),
                          Wpf[..., 0], M))
    bench("argsort [KW] x B",
          lambda: torch.argsort(Wpf[..., 1], dim=1, stable=True))

    # congruence-transform analog: batched tiny jacobian products
    J = put(rng.normal(size=(B * KU, 6, 6)))
    Uf = U.reshape(B * KU, 6, 6)
    bench("congruence einsum f64",
          lambda: torch.einsum("kab,kbc,kdc->kad", J, Uf, J))
    return 0


if __name__ == "__main__":
    sys.exit(main())
