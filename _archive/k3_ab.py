"""K3 on the card: ptxas's report, phase 4b (chip_smoke.phase_k3) with the
port's build, then the earlier kernel, a thread per (row, column) walking
its segment (_archive/k3_thread/segment_sum_thread.cu, other symbols),
against ring variants of csrc/segment_sum.cu, each built alone from a
patched copy of the source, at the synthetic level-1 and root shapes and
at the real launches with the most values on one chain (device executor
direct mono 2,048, host executor direct mono 512, kept by
chip_smoke._K3InSitu), in turns (earlier kernel, variants, variants
reversed, earlier kernel), CUDA events; every variant's output torch.equal
to the port's.

    python3 _archive/k3_ab.py [--variants 4x8192,3x16384d64,...]

(a variant: kStages x kStageBytes [d kDirectMax] [a ablation]; an ablated
variant, which skips the ring's adds (a1), its value copies (a2) or kernel
B (a3), is timed only). Then the fold alone (_archive/k3_micro/
fold_bench.cu).
"""
import argparse
import ctypes
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from linearsfm_tpu_torch.ops import kernels  # noqa: E402

SRC = os.path.join(ROOT, "linearsfm_tpu_torch", "csrc", "segment_sum.cu")
THREAD = os.path.join(HERE, "k3_thread", "segment_sum_thread.cu")
OUT = os.path.join(HERE, "k3_build")


def build(name, src, defs):
    so = os.path.join(OUT, f"lib_{name}.so")
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, *defs, "-shared", "-o", so,
           src]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)


# each ablation: (text of csrc/segment_sum.cu, its replacement), each text
# found exactly once
ABLATE = {
    "1": [("          if (w.folds && n > 0)\n            acc = fold_run",
           "          if (false)\n            acc = fold_run")],
    "2": [("          if (row_bytes) {     // a bulk copy per row",
           "          if (false) {"),
          ("          } else {\n            int q = lane / tail",
           "          } else if (false) {\n            int q = lane / tail")],
    "3": [("  if (e != cudaSuccess) return static_cast<int>(e);\n"
           "  cudaLaunchConfig_t cfg",
           "  return static_cast<int>(e);\n  cudaLaunchConfig_t cfg")],
}


def variant_source(name, stages, stage_bytes, direct_max, ablate):
    """A copy of the port's K3 source with the ring's constants set and an
    ablation applied, written under OUT."""
    text = open(SRC).read()
    subs = [(r"constexpr int kStages = \d+;", f"constexpr int kStages = {stages};"),
            (r"constexpr int kStageBytes = \d+;",
             f"constexpr int kStageBytes = {stage_bytes};")]
    if direct_max:
        subs.append((r"constexpr int kDirectMax = \d+;",
                     f"constexpr int kDirectMax = {direct_max};"))
    for pat, rep in subs:
        text, n = re.subn(pat, rep, text)
        if n != 1:
            raise RuntimeError(f"{name}: {pat} found {n} times")
    for old, new in ABLATE.get(ablate, []) if ablate else []:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: ablation text found "
                               f"{text.count(old)} times")
        text = text.replace(old, new)
    path = os.path.join(OUT, f"segment_sum_{name}.cu")
    with open(path, "w") as fh:
        fh.write(text)
    return path


def bind(so, prefix):
    """The library's two entries by dtype; the earlier kernel's take no
    flags."""
    lib = ctypes.CDLL(so)
    fns = {}
    ptrs = 5 if prefix == "seg_sum_thread" else 6
    for dt, suf in ((torch.float32, "f32"), (torch.float64, "f64")):
        fn = getattr(lib, f"{prefix}_{suf}")
        fn.argtypes = [ctypes.c_void_p] * ptrs + [ctypes.c_int64] * 3 + [
            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[dt] = (fn, ptrs == 6)
    return fns


def caller(fns, vals, plan):
    out = torch.empty((plan.P, plan.num) + tuple(vals.shape[2:]),
                      dtype=vals.dtype, device="cuda")
    T = out[0, 0].numel() if out.numel() else 1
    fn, listed = fns[vals.dtype]
    work = torch.empty(plan.P * plan.num, dtype=torch.int8, device="cuda")
    lead = [work.data_ptr()] if listed else []

    def go():
        err = fn(plan.off.data_ptr(), plan.perm.data_ptr(), vals.data_ptr(),
                 None, out.data_ptr(), *lead, plan.P * plan.num, plan.num,
                 T, 0, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch error {err}")
        return out
    return go


def micro(so):
    """The ring's fold alone (_archive/k3_micro/fold_bench.cu): ns per
    entry folded, at chunks of 113 (6x3) and 56 (6x6) entries, with a CTA
    barrier between steps (mode 0), without (1), from registers (2)."""
    lib = ctypes.CDLL(so)
    fn = lib.fold_bench
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(64, dtype=torch.float64, device="cuda")
    for chunk, tail in ((113, 18), (56, 36), (227, 18)):
        for mode in (0, 1, 2):
            def go(steps):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                if fn(out.data_ptr(), steps, chunk, tail, mode,
                      torch.cuda.current_stream().cuda_stream):
                    raise RuntimeError("fold_bench launch")
                b.record()
                b.synchronize()
                return a.elapsed_time(b)
            go(100)
            ms = min(go(2000) - go(1000) for _ in range(3))
            print(f"micro fold chunk {chunk} tail {tail} mode {mode}: "
                  f"{ms * 1e6 / 1000 / chunk:.3f} ns per entry, "
                  f"{ms * 1e3:.3f} us per 1000 steps", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="6x32768,8x16384,6x32768a1,6x32768a2")
    ap.add_argument("--skip-4b", action="store_true",
                    help="leave out phase 4b (the port's build unchanged)")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(OUT, exist_ok=True)
    t0 = time.perf_counter()
    ptx = subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS,
                            "-Xptxas", "-v", "-c", "-o", os.devnull, SRC],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    jobs = {"thread": build("thread", THREAD, [])}
    for v in args.variants.split(","):
        st, rest = v.split("x")
        rest, _, abl = rest.partition("a")
        by, _, dmax = rest.partition("d")
        jobs[v] = build(v, variant_source(v, st, by, dmax, abl), [])
    micro_so, micro_job = build("micro", os.path.join(HERE, "k3_micro",
                                                      "fold_bench.cu"), [])
    kernels.build()
    if micro_job.wait():
        raise RuntimeError(micro_job.stderr.read())
    libs_micro = micro_so
    out, err = ptx.communicate()
    print("ptxas:", err.strip(), flush=True)
    libs = {}
    for name, (so, p) in jobs.items():
        _, e = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{name}: {e}")
        libs[name] = bind(so, "seg_sum_thread" if name == "thread"
                          else "seg_sum")
    print(f"builds {time.perf_counter() - t0:.1f} s", flush=True)

    maps, gt, tp = cs.make_dataset("mono")
    shapes = cs._k2_shapes({"mono": (maps, gt, tp)})
    if not args.skip_4b:
        t0 = time.perf_counter()
        err, times, add_ns = cs.phase_k3(shapes)
        print(f"phase 4b {time.perf_counter() - t0:.1f} s, max err {err}",
              flush=True)

    from synth import generate as gen
    from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
    from linearsfm_tpu_torch.core.tree import TreeSolver
    g = torch.Generator(device="cuda").manual_seed(44)
    cases = {}
    for level in ("level1", "root"):
        P, N, K = shapes[f"mono {level}"]
        for dt in (torch.float32, torch.float64):
            vals, wf, _ = cs._k3_case(g, P, K, N, (6, 3), dt, lo=0, hi=N,
                                      pad_every=17)
            cases[f"{level} {str(dt)[6:]}"] = (vals, kernels.seg_plan(wf, N))
    m512, _, _ = gen.make_dataset(512, "mono", noise=0.005, seed=7,
                                  covis_radius=6.0, covis_max=6)
    for key, run in (("device real", lambda: DeviceTreeSolver(
            "mono", method="direct").run(maps)),
            ("host real", lambda: TreeSolver("mono", method="direct")
             .run(m512))):
        with cs._K3InSitu() as k3:
            run()
        site, vals, _, _, plan, _, _ = k3.chain[1]
        cases[f"{key} {site} float64"] = (vals, plan)
    names = list(libs)
    order = ["thread"] + names[1:] + names[1:][::-1] + ["thread"]
    for cname, (vals, plan) in cases.items():
        ref = kernels.seg_sum_fixed(vals, plan)
        fns = {n: caller(libs[n], vals, plan) for n in names}
        for n, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            if "a" not in n and not torch.equal(got, ref):
                raise AssertionError(f"{cname}: {n} != the port's K3")
        reps = 20
        res = {n: [] for n in names}
        for n in order:
            res[n].append(cs._loop_ms(fns[n], reps))
        lens = (plan.off[1:] - plan.off[:-1]).view(plan.P, plan.num + 1)[
            :, :plan.num]
        print(f"ab {cname} (P, K, num) ({plan.P}, {plan.K}, {plan.num}) tail "
              f"{tuple(vals.shape[2:])} longest {int(lens.max())}: " +
              ", ".join(f"{n} {min(t):.4f} ms ({'/'.join(f'{x:.4f}' for x in t)})"
                        for n, t in res.items()), flush=True)
        del ref, fns
    micro(libs_micro)
    print("k3_ab done", flush=True)


if __name__ == "__main__":
    main()
