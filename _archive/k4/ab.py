"""K4 at every level of one warm solve of each refine cell, on the card:
each K4 call's inputs are kept (a hook on kernels.schur_pairs), then per
level the plan's shape, its heaviest block row, K4's CUDA-event time
(median of 3 after one warm launch) and whether it equals the plain
version (torch.equal); at the top two levels also a build of the kernel
with per-warp counters (`patched_stat`: cycles, cycles in the merge,
block products, seek calls) and the heaviest warps. (Its first version
built variants of the first kernel design: a per-warp clock64 record, and
one without S traffic.)

    python3 _archive/k4/ab.py [--cells nc3500_stereo.covis,...] [--seed N]
"""
import argparse
import ctypes
import os
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.abspath(os.path.join(HERE, "..", ".."))
sys.path.insert(0, ROOT)

SRC = os.path.join(ROOT, "linearsfm_tpu_torch", "csrc", "schur_pairs.cu")


def patched_stat():
    """The kernel with per-warp counters: cycles in all, cycles in the merge
    pass, block products (summed over the warp), merge steps (the warp's
    largest)."""
    s = open(SRC).read()
    rep = [
        ("namespace {\n", "__device__ long long g_stat[4 << 21];\nnamespace {\n"),
        ("  if (g >= a.warps) return;   // the whole warp\n",
         "  if (g >= a.warps) return;   // the whole warp\n"
         "  const long long c0 = clock64(); long long c1acc = 0; int nprod = 0, nstep = 0;\n"),
        ("    unsigned mask = 0;\n",
         "    unsigned mask = 0;\n    const long long t1 = clock64();\n"),
        ("    if (!e_warp) {\n",
         "    c1acc += clock64() - t1;\n    if (!e_warp) {\n"),
        ("      if (fq < f) seek(a.col, jend, f, jq, fq);\n",
         "      if (fq < f) { seek(a.col, jend, f, jq, fq); ++nstep; }\n"),
        ("      accumulate(s, y, v);\n      // the rest",
         "      accumulate(s, y, v); ++nprod;\n      // the rest"),
        ("        accumulate(s, y, v);\n      }\n", "        accumulate(s, y, v); ++nprod;\n      }\n"),
        ("   // eP - its sum\n}",
         "   // eP - its sum\n"
         "  nprod = __reduce_add_sync(kAll, nprod); nstep = __reduce_max_sync(kAll, nstep);\n"
         "  if (lane == 0 && g < (1 << 21)) { g_stat[4 * g] = clock64() - c0; g_stat[4 * g + 1] = c1acc;"
         " g_stat[4 * g + 2] = nprod; g_stat[4 * g + 3] = nstep; }\n}"),
    ]
    for a, b in rep:
        assert s.count(a) == 1, a
        s = s.replace(a, b)
    s += ('\nextern "C" int k4_stats(void* dst, int64_t n) {\n'
          '  return (int)cudaMemcpyFromSymbol(dst, g_stat, n * 8);\n}\n')
    return s


def build_stat(tmp):
    cu = os.path.join(tmp, "k4_stat.cu")
    so = os.path.join(tmp, "libk4_stat.so")
    with open(cu, "w") as fh:
        fh.write(patched_stat())
    r = subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode",
                        "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-Xcompiler", "-fPIC", "-shared", "-o", so, cu],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(r.stderr)
    lib = ctypes.CDLL(so)
    lib.schur_pairs_f32.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int64] * 3 + [ctypes.c_void_p]
    lib.k4_stats.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    return lib


def stats(lib, S0, E0, W, Y, eF, plan, tag):
    import torch
    S, E = S0.clone(), E0.clone()
    P, M, N = W.shape[0], plan.M, plan.N
    T = (M + 31) // 32
    nw = P * M * T
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    assert lib.schur_pairs_f32(
        S.data_ptr(), E.data_ptr(), W.data_ptr(), Y.data_ptr(),
        eF.data_ptr(), plan.row_ptr.data_ptr(), plan.perm.data_ptr(),
        plan.scol.data_ptr(), P, M, N,
        torch.cuda.current_stream().cuda_stream) == 0
    b.record()
    b.synchronize()
    st = torch.empty((min(nw, 1 << 21), 4), dtype=torch.int64)
    assert lib.k4_stats(st.data_ptr(), st.shape[0] * 4) == 0
    rlen = (plan.row_ptr[1:] - plan.row_ptr[:-1]).long().cpu()
    g = torch.arange(st.shape[0])
    r, tile = g // T, g % T
    lenp = rlen[r]
    cyc = st[:, 0].double()
    top = torch.argsort(cyc, descending=True)[:8]
    print(f"{tag}: stat variant {a.elapsed_time(b):.3f} ms; warps {nw}; "
          f"cycles sum {cyc.sum():.4e} max {cyc.max():.4e} mean {cyc.mean():.4e}; "
          f"merge share {st[:, 1].sum() / cyc.sum():.3f}; products {int(st[:, 2].sum())}",
          flush=True)
    heavy = lenp > 1000
    print(f"{tag}: rows > 1000 entries: {int((rlen > 1000).sum())}, their warps' "
          f"cycles {cyc[heavy].sum():.4e}; warps with a max step count > 1000: "
          f"{int((st[:, 3] > 1000).sum())}, their cycles {cyc[st[:, 3] > 1000].sum():.4e}",
          flush=True)
    for i in top.tolist():
        print(f"  warp {i}: row {int(r[i])} tile {int(tile[i])} len_p {int(lenp[i])} "
              f"cycles {int(cyc[i])} merge {int(st[i, 1])} products {int(st[i, 2])} "
              f"steps {int(st[i, 3])}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default="nc3500_stereo.covis,mono3499_refine.covis")
    ap.add_argument("--seed", type=int, default=9210002001)
    args = ap.parse_args()
    import torch
    from benchmark import gen, run
    from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
    from linearsfm_tpu_torch.ops import kernels
    kernels.build()
    stat_lib = build_stat(tempfile.mkdtemp())
    bench = run.Bench(ROOT)
    for cell in args.cells.split(","):
        w = bench.cell(cell)
        cfg, mix = bench.config(w["config"]), bench.mix(w["traffic"])
        solver = DeviceTreeSolver(cfg["datatype"], method=cfg["method"],
                                  device="cuda")
        kept = []
        k4 = kernels.schur_pairs

        def hook(S, E, W, Y, eF, plan):
            kept.append((S.clone(), E.clone(), W, Y, eF, plan))
            return k4(S, E, W, Y, eF, plan)
        kernels.schur_pairs = hook
        try:
            solver.run(gen.make_set(cfg, mix, args.seed, 0))
        finally:
            kernels.schur_pairs = k4
        torch.cuda.synchronize()
        total = 0.0
        for lv, (S0, E0, W, Y, eF, plan) in enumerate(kept, start=1):
            rptr = plan.row_ptr.long()
            rlen = rptr[1:] - rptr[:-1]
            S, E = torch.empty_like(S0), torch.empty_like(E0)
            ts = []
            for _ in range(4):
                S.copy_(S0)
                E.copy_(E0)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                kernels.schur_pairs(S, E, W, Y, eF, plan)
                b.record()
                b.synchronize()
                ts.append(a.elapsed_time(b))
            want = kernels.schur_pairs_ref(S0.clone(), E0.clone(), W, Y, eF, plan)
            same = torch.equal(S, want[0]) and torch.equal(E, want[1])
            ms = statistics.median(ts[1:])
            total += ms
            if lv >= len(kept) - 1:
                stats(stat_lib, S0, E0, W, Y, eF, plan, f"{cell} level {lv}")
            print(f"{cell} level {lv}: P {W.shape[0]} M {plan.M} N {plan.N} "
                  f"live {int(rptr[-1])} max_row {int(rlen.max())} "
                  f"K4 {ms:.4f} ms, torch.equal plain {same}", flush=True)
        print(f"{cell}: K4 over the solve's {len(kept)} launches {total:.3f} ms", flush=True)
        del kept
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
