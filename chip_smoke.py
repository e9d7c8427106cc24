#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`linearsfm_tpu_torch`) on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure exits non-zero:

1. the card's name and power limit (nvidia-smi); no CUDA device -> exit 2;
2. build the port's CUDA kernels from `linearsfm_tpu_torch/csrc` (one nvcc
   per source, all at once, linked into one library);
3. kernel K1 (`blockcoo_to_dense`) against its plain PyTorch version on the
   card: K = 0, padding rows, duplicates, unsorted rows, lane-folded
   batches, float64, and the level-1 and root shapes of the main path,
   including a feature stripe as a list of its own and column windows of
   one plan (`coo_plan`, `blockcoo_to_dense_planned`'s window): the root
   stripe and stereo level 10's two stripes. Every main-path list runs in
   float32 and again in float64 (the direct levels of the entry point's
   paths), each through both wrappers: a plan of its own list
   (`blockcoo_to_dense`) and a shared plan (`blockcoo_to_dense_planned`).
   Exact where no two entries share a coordinate, else rtol 1e-6 (plus
   1e-6 of the largest magnitude); each line says whether the result was
   exact. At the main-path shapes, in both dtypes, CUDA-event times over
   loops of calls: the kernel alone
   on a prebuilt plan (and its device time, as phase 4 takes it), the
   wrapper (plan + launch), the plain version and the
   library yardstick (torch.zeros + one index_put_ with accumulate=True on
   element indices built beforehand), beside the bound: the output's bytes
   written once plus the entries' read once, over 3.35 TB/s;
4. kernel K2, fused (`inv3x3_wy`: the inverses V^-1 of the feature blocks
   and Y = W V^-1[wf] in one launch; `inv3x3_sym` is the launch with K = 0)
   against its plain versions, exactly (`torch.equal`, NaN where the plain
   version has NaN, both outputs), in float32 and float64: the inverse alone
   on zero, NaN and near-singular blocks and two mono shapes; the fused
   launch with K = 0, N = 0 on padding, special blocks with entries on
   them and entries whose wf is outside [0, N), tile-edge counts, and the
   level-1 and root shapes of both paths' plans (`core/plan`). At those
   shapes (float64 too at the roots), device times from torch.profiler
   (median of 10 calls, the L2 flushed before each): the fused kernel, the
   inverse alone, the unfused sequence (K2 with K = 0, `take`,
   `torch.matmul`), the library yardstick (`torch.linalg.inv`, `take`,
   `torch.matmul`) and the plain version, beside the bound;
4b. kernel K3 (`seg_sum_fixed`, the port's fixed-order segment sum, which
   the device and host executors run inside `ops/segment.deterministic()`)
   against its plain
   version, bit for bit (torch.equal, signed zeros included; NaN where
   the plain version has NaN), in float32 and float64: K = 0, every index
   dropped, empty segments, one long run of equal keys, unsorted keys,
   lane-folded batches of every tail ((), 3, 6, 6x3, 3x3, 6x6), segments
   of 2,017 entries at the start and the end of lanes (tails 1, 18, 36),
   NaN, +-inf, subnormals and signed zeros (a base of -0.0s), the
   accumulate-into form with alpha = -1 of each, `segment.seg_sum` inside
   the scope, the direct mono path's W lists at level 1 and the root (the
   mono plan's (P, N, K), a [P, K, 6, 3] sum over wf into N, every 17th
   entry padding); every case also bit for bit the CPU's `index_add_` on
   the raw index list, which shares no sort or offsets with the card.
   The chain-floor probe (`kernels.add_chain`, one thread's dependent
   adds) measures the card's add latency in both dtypes. At the
   main-path shapes, CUDA events over loops of calls: the kernel on a prebuilt
   plan, plan + launch, the plain version, `index_add_` (atomics) and
   `index_add_` under `torch.use_deterministic_algorithms(True)`, beside
   both bounds: bytes (the kept entries' values and positions and the
   offsets read once plus the output written once, over 3.35 TB/s) and
   the chain floor (the longest segment times the add latency);
5. small trees solved on the GPU and on the CPU, by "refine" and by
   "direct" (K1 and K2 in float64): 13 stereo maps and 11 mono maps; poses
   agree to atol 1e-9;
5b. K5 (`phase_k5`, after phases 6-7): the first set (seed 0) of the
   benchmark's `rs468_mono.covis` (direct mono) and `nc3500_stereo.covis`
   (stereo refine) through `DeviceTreeSolver`, every K5 call held against
   the plain transform in situ (`_K5InSitu`: each float field within 1e-10
   (float64) / 1e-5 (float32) of its largest magnitude, indices, ids and
   gauge tags equal), then the level-1 and root calls timed alone with
   CUDA events beside the byte bound and the plain transform;
6. the stereo main path: the 2,048-map stereo loop-closure set (seed 7,
   noise 0.005, covis radius 6, at most 6 co-visible features per map; made
   with its plan before phase 3) through `DeviceTreeSolver("stereo",
   method="refine")`, as `bench.py` builds it (no device argument: the
   card by default), one warm run, with every K3 call and plan held
   against the plain version in situ (`_K3InSitu`) and every K4 call
   (`_K4InSitu`: the refine joins' float32 Schur complement from the W
   block list, `torch.equal` on S and E) and every K5 call
   (`_K5InSitu`), and one timed run.
   Fails unless the root lies on cuda:0, every pose id 1..2,048 is there
   and finite, the ATE is within
   1e-6 of the oracle's 0.009758730, every level's PCG residual is <= 1e-10,
   K1, K2, K3 and K4 launched and the two runs' pose ids, poses and
   features are `torch.equal`. It also prints the `utils/flops` model's f32
   rate of the timed run and its share of the H100's 67 TFLOP/s f32 peak (a
   model figure: the per-block constants are not calibrated on the GPU);
7. the mono main path: the same set in mono (pose 0 is an explicit block:
   ids 0..2,049) through `DeviceTreeSolver("mono", ...)`, checked the same
   way against the oracle's 0.014352172; its root K4 launch (mono
   refine) is timed alone as 11b's;
8. the entry points: both 2,048-map sets written as localmap_<i>.txt with
   the port's writer; `python3 -m linearsfm_tpu_torch.cli ... --check` as
   a subprocess with the default flags (device executor, `--method
   direct`, on the GPU) for stereo and mono; `cli.main([..., "--exec",
   "host"])` in process for stereo. Each must exit 0 with `LinearSFM
   Check: OK`, read with the C parser, and write a pose file with every id
   and an ATE within 1e-6 of the oracle's; the host run's poses agree with
   the device executor's within 2e-6. The CLI's solve, stereo and mono,
   and the host executor run once more in process with every K1 call held
   against the plain version on its own inputs (exact, or rtol 1e-6 with
   duplicates), and as many float64 calls as the runs above launched; the
   CLI's solve is then timed warm. Then checkpoint/resume of both
   executors on the 13-map stereo and 11-map mono trees: resumed from the
   newest checkpoint and from level 2's, poses within 1e-9 of the full run.
   Each run prints its wall, reader, host phases and kernel launches. The
   CLI's mono solve runs twice: the two pose files must be identical; the
   in-process direct solves (held, then timed) and the host executor's
   solve inside `cli.main` and once more on the maps it read must give
   `torch.equal` results;
9. the mesh paths on this card, every mesh four shards of cuda:0: (a) the
   stereo main path's set through `DeviceTreeSolver(..., mesh=Mesh(
   ("cuda:0",) * 4))`: its level modes (dp levels must be there and the
   root tp), a warm run with every K1 and K2 call of the tp level held
   against the plain version in situ (`_K1InSitu`, `_K2InSitu`), a timed
   run (counts from 0) with the main path's checks and a pose max |diff|
   against phase 6's run of at most 1e-8; (b) the same for mono (1e-6
   against phase 7's); (c) multi-host, stereo, direct: 4 hosts simulated
   in process (`parallel/multihost`, the gather stubbed) and (d) two real
   processes of `linearsfm_tpu_torch.tools.multihost_worker` on cuda:0
   over gloo (a free port, a 600 s timeout): ATE within 1e-6 of the
   oracle's and poses within 1e-8 of the single-process direct solve
   (and (d) of (c)); (e) the host executor over a pairs and an fs mesh on
   a 64-map stereo tree, within 1e-9 of it without meshes. Each path runs
   twice with `torch.equal` results: (a), (b) the warm and the timed run,
   (c) local phases and top again, (d) the two ranks, (e) again;
10. the dense planned executor (`core/dense_tree.DenseTreeSolver`): (a)
   both 2,048-map sets with method="refine" (stereo with the default f32
   information at the levels of at most 32 joined poses, the bench's
   BENCH_EXEC=dense; mono with f64 information everywhere, mixed_max_m=0,
   since the default gives NaN poses there, as it does in the JAX
   package): a warm run with its 3 level-0 K1 calls and its K2 call of
   every level held against the plain versions in situ, then a timed run
   (wall, maps_joined/s, host phases, per-level CUDA-event walls, peak
   memory, launches, ATE beside the oracle's, pose max |diff| against
   phases 6-7), failing unless every pose id is there and finite and K1
   and K2 launched; level 0's first K1 call (A of every map, [2048, 96,
   96]) timed alone on its own inputs as phase 3 times K1; K2 at the dense
   stereo root's shape, fused against the inverse alone + `torch.einsum`
   and the plain version; (b) `python3 -m linearsfm_tpu_torch.cli ...
   --exec dense --check` on phase 8's stereo text set (direct): exit 0,
   `LinearSFM Check: OK`, pose-file ATE within 1e-6 of the oracle's and
   poses within 2e-6 of the device executor's CLI pose file;
11. the tools and scale: (a) `linearsfm_tpu_torch.tools.compare_ate`
   through its `main` at 512 covis maps (seed 7, noise 0.005, device
   executor, refine), stereo then mono, against the oracle binary
   `tools/oracle/linearsfm_oracle` run live on the same files: the oracle
   must run, every pose id be there and finite, the ATE be within 1e-6 of
   that run's oracle ATE and the pose files within 1e-5; (b) the stereo
   3,499-map covis set (seed 7, noise 0.005, covis 6 / 6) through phase
   6's checks against `ate_3499_covis.json`'s oracle ATE, every K1, K2 and
   K4 call of its warm run held in situ, and its root K4 launch timed
   alone with CUDA events (`_K4InSitu.time_root`: a fresh copy of A and
   eP before each launch) beside its byte bound (W, Y and eF read once,
   the touched S blocks read and written once, over 3.35 TB/s), the f32
   flop bound of its nonzero block products (216 each, over 67 TFLOP/s),
   and the plain version; (c) the
   profiling tools on phases 6-7's sets: `profile_level_parts.level_parts`
   at every level of both (T / TJ / full ms), `profile_device_tree.profile`
   and `bench_root.root_parts` on stereo, then `microbench` at its defaults
   and `profile_tree` at 512 stereo maps through their `main`: each must
   exit 0 and print its labelled lines, and K1 and K2 must launch in
   `bench_root`;
12. the JAX package's call forms, no device argument (`phase_call_forms`):
   direct mono through `DeviceTreeSolver.run` called directly, three times
   (identical poses, ATE within 1e-6 of the oracle's), and through
   `DenseTreeSolver.run` twice (identical poses); pin="zero" at 2,048
   maps (ATE within 1e-6 of the oracle's) and on the 11-map set against
   the CPU; `TreeSolver("stereo")` and `DenseTreeSolver("stereo",
   method="refine")` at 512 maps on cuda:0, and `pipeline.run(path, 512,
   "stereo")`, each against phase 11a's live oracle on the same set (ATE
   within 1e-6, poses within 1e-5; the dense executor's default refine,
   f32 at its low levels, 1e-4 and 5e-4, and with f64 at every level
   1e-6 and 1e-5); `__graft_entry__`'s
   `merge_one_stereo(g, m, JoinConfig(max_obs=8))` against the CPU; (e)
   direct mono on the host executor, `TreeSolver("mono",
   method="direct")` and `pipeline.run(path, 512, "mono")`, twice each on
   phase 11a's 512-map mono set: the two runs' poses equal, each run's ATE
   within 1e-6 of that set's live oracle ATE and its poses within 1e-5 of
   the oracle's file. Every K1, K2 and K3 call of the paths it counts is
   held against its plain version in situ (in (e) those of the solver's
   second run; the host executor's K3 calls of (c) run unheld), and
   every K3 plan built in a held run against the CPU's plan of the same
   index list; K3 must run on every path but the dense executor's, and on
   no dense path. The K3
   launch with the most values on one chain of 12a's held run (device
   executor, 2,048 maps) and of (e)'s (host executor, 512 maps) is held
   once more as phase 4b holds its cases and timed as phase 4b times its
   shapes;
13. the bench (`phase_bench`): `python3 -m linearsfm_tpu_torch.tools.bench`
   as a subprocess on the card at its defaults (2,048 covis maps) for
   stereo, mono (`BENCH_TYPE=mono`), direct mono (`BENCH_METHOD=direct`,
   the K3 path) and dense stereo (`BENCH_EXEC=dense`,
   `BENCH_PROFILE_LEVELS=0`). Each must exit 0 and print one stdout line
   with bench.py's keys, res_max <= 1e-10 where the solve computes one
   (the device executor's refine), a logged ATE within 1e-6 of the
   oracle's (dense stereo's default f32 levels: 1e-4, as phase 12) and
   the card's line; the SHA-256 of its warm and timed runs' poses equal
   to each other and to this process's run of the same solve (phases 6-7,
   12a, 10a); its value is printed beside phase 6/7's timed rate, as a
   record;
14. grid mono 2,048 (`phase_grid_mono`): the set of
   `_archive/grid_mono_2048.py` (pattern "grid", written as text and read
   back) through `DeviceTreeSolver("mono", method=M)`, three runs for
   each of refine and direct: `torch.equal` results, K1, K2 and K3 in
   each run, and the ATE, res_max and non-finite count printed beside the
   oracle's 2.572875460 (record only: the set amplifies rounding, PERF.md
   §7).

The kernel launch counts are set to 0 just before each main path's timed
run (phases 6, 7, 9a, 9b, 9c's simulated run, 10a, 11b) and read just
after it, and likewise around each `compare_ate` run and `bench_root`
(phase 11), each of phase 12's runs and each of phase 14's; each bench
process of phase 13 does the same around its timed run and logs them.
The warm run checks
that K2 ran at the shapes phase 4 timed.
The CLI runs report their own counts (pipeline log); the host run's are
set to 0 before `cli.main` and read after it. Every path must launch K1
and K2; K3 and K5 must launch on every path of the device and host
executors, which sum in the fixed order and transform on the card, and on
no path of the dense executor (phase 10, 12's dense runs, the bench's dense
stereo). 11b and 12a's held run also hold every K5 call in situ. The line before the last is the
kernel record (per kernel: launches, max error, kernel, plain, bound and
library times and what the library yardstick is; K1 at the root stripe,
K2 fused at the stereo root in float32, K3 at the direct mono root in
float64, with its chain floor, K4 at the stereo 3,499 root, K5 at the
NC3500 set's root call); the last
line is {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# oracle ATEs of the 2,048-map covis sets, seed 7 (ate_2048_covis*.json)
ORACLE_ATE_2048 = {"stereo": 0.009758730, "mono": 0.014352172}
# oracle ATE of the 3,499-map stereo covis set, seed 7 (ate_3499_covis.json)
ORACLE_ATE_3499 = 0.01174630460707857


def _loop_ms(fn, reps):
    """Device time per call: CUDA events around `reps` calls queued back to
    back (after two warm-up calls), so the host's launch work overlaps the
    device's; no result is kept alive between calls."""
    import torch
    for _ in range(2):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


# K1 and K2 run on every path; K3 on every path but the dense executor's:
# the device and host executors sum in the fixed order of
# `segment.deterministic()`, the dense executor's sums repeat without it
PATH_KERNELS = ("blockcoo_to_dense", "inv3x3_sym")
K3 = "seg_sum_fixed"
# K4 runs in every refine join's float32 assembly
K4 = "schur_pairs"
# K5 runs every gauge transform of the device and host executors
K5 = "gauge_congruence"


def _require_launched(tag, counts, dense=False):
    """Fails unless K1 and K2 launched in `counts`, and K3 and K5 too
    unless the path is the dense executor's, where K3 and K5 must not have
    launched (it sums without the fixed-order scope and transforms in its
    own dense form)."""
    for k in PATH_KERNELS + (() if dense else (K3, K5)):
        if counts.get(k, 0) <= 0:
            raise AssertionError(f"{tag}: kernel {k} was never launched")
    for k in (K3, K5) if dense else ():
        if counts.get(k, 0):
            raise AssertionError(f"{tag}: {k} launched {counts[k]} times on "
                                 f"the dense executor")


# `common.pose_digest` of a path's run, by tag, for phase 13's bench
# processes to meet
DIGESTS = {}


def pose_digest(lm):
    from linearsfm_tpu_torch.tools.common import pose_digest as digest
    return digest(lm)


def _repeats(tag, a, b):
    """Fails unless two solved maps (one-lane stacks or host form) have
    equal pose ids, poses and features, bit for bit (`torch.equal`)."""
    import torch
    from linearsfm_tpu_torch import types
    ha, hb = types.host_fields(a), types.host_fields(b)
    same = all(torch.equal(torch.as_tensor(getattr(ha, f)),
                           torch.as_tensor(getattr(hb, f)))
               for f in ("pose_ids", "poses", "feat_ids", "feats"))
    print(f"{tag}: two runs' pose ids, poses and features torch.equal "
          f"{same}", flush=True)
    if not same:
        raise AssertionError(f"{tag}: two runs differ")


# H100 SXM HBM rate and non-tensor f64 peak (NVIDIA data sheet, 700 W); the
# f32 peak is `utils/flops.PEAK_F32`
HBM_BYTES_PER_S = 3.35e12
F64_FLOP_PER_S = 34e12


def _coo_case(g, P, K, M, N, C, *, pad_every=0, sort_rows=False,
              zero_frac=0.0, col_window=None, dtype=None):
    """Random lane-stacked block-COO list on the card (R = 6)."""
    import torch
    dev = "cuda"
    rows = torch.randint(0, M, (P, K), generator=g, device=dev)
    if sort_rows:   # two concatenated row-sorted runs, as a join emits them
        h = K // 2
        rows[:, :h] = rows[:, :h].sort(dim=1).values
        rows[:, h:] = rows[:, h:].sort(dim=1).values
    cols = torch.randint(0, N, (P, K), generator=g, device=dev)
    vals = torch.randn((P, K, 6, C), generator=g, device=dev, dtype=dtype)
    if pad_every:
        rows[:, ::pad_every] = -1
    if zero_frac:
        z = torch.rand((P, K), generator=g, device=dev) < zero_frac
        rows = torch.where(z, -1, rows)
    if col_window is not None:   # a feature stripe: entries outside skip
        lo, width = col_window
        return (*_masked_stripe(rows, cols, lo, width), vals, M, width)
    return rows, cols, vals, M, N


def _masked_stripe(rows, cols, lo, width):
    """A stripe as a list of its own: rows outside [lo, lo + width) masked
    to -1, columns shifted and clamped (the plain version's input)."""
    import torch
    own = (cols >= lo) & (cols < lo + width)
    return torch.where(own, rows, -1), torch.clamp(cols - lo, 0, width - 1)


def _has_duplicates(rows, cols, M, N):
    import torch
    ok = (rows >= 0) & (rows < M) & (cols >= 0) & (cols < N)
    lane = torch.arange(rows.shape[0], device=rows.device)[:, None]
    key = ((lane * M + rows) * N + cols)[ok]
    return key.numel() != torch.unique(key).numel()


def _library_inputs(rows, cols, vals, M, N):
    """Element indices and values of the valid entries, in list order, for
    the yardstick torch.zeros + index_put_(accumulate=True)."""
    import torch
    P, K, R, C = vals.shape
    ok = (rows >= 0) & (rows < M) & (cols >= 0) & (cols < N)
    lane = torch.arange(P, device=rows.device)[:, None]
    frow = (rows + lane * M)[ok]
    rr = frow[:, None, None] * R + torch.arange(R, device=rows.device)[:, None]
    cc = cols[ok][:, None, None] * C + torch.arange(C, device=rows.device)
    rr, cc = torch.broadcast_tensors(rr, cc)
    return ((P * M * R, C * N), (rr.reshape(-1), cc.reshape(-1)),
            vals[ok].reshape(-1))


def _k1_check(name, got, ref, dup, quiet=False):
    """K1's output against its plain version's: exact where no two entries
    share a coordinate, else rtol 1e-6 (plus 1e-6 of the largest
    magnitude). Returns the largest absolute error."""
    import torch
    err = float((got - ref).abs().max()) if ref.numel() else 0.0
    exact = torch.equal(got, ref)
    if dup:
        scale = float(ref.abs().max()) if ref.numel() else 0.0
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6 * scale)
    elif not exact:
        raise AssertionError(f"K1 {name}: not exact, max err {err}")
    if not quiet:
        print(f"k1 {name}: out {list(got.shape)} max_abs_err={err:.3e} "
              f"duplicates={'yes' if dup else 'no'} "
              f"{'exact' if exact else 'within rtol 1e-6'} ok", flush=True)
    return err


def _k1_bound_ms(P, M, N, R, C, esz, nnz):
    """Least time of one K1 launch: its output written once plus its
    entries (values, permutation and column, 4 bytes each) and row offsets
    read once, over the HBM rate."""
    out = P * R * M * C * N * esz
    entries = nnz * (R * C * esz + 8) + (P * M + 1) * 4
    return (out + entries) / HBM_BYTES_PER_S * 1e3


def _k1_time(name, kernel, wrapper, plain, library, bound):
    """K1's times at one shape, printed on one line: CUDA events over loops
    of 10 calls, in the order plain, kernel, wrapper, library, kernel,
    plain (the kernel and plain figures the lesser of their two rounds),
    then the kernel alone by device time, which no host pacing of the
    loops can lengthen."""
    reps = 10
    p1 = _loop_ms(plain, reps)
    k1 = _loop_ms(kernel, reps)
    w = _loop_ms(wrapper, reps)
    lib = _loop_ms(library, reps)
    k2 = _loop_ms(kernel, reps)
    p2 = _loop_ms(plain, reps)
    ms, plain_ms = min(k1, k2), min(p1, p2)
    dev = _device_ms({"kernel": kernel})["kernel"]
    print(f"k1 time {name}: kernel {k1:.4f}/{k2:.4f} ms on a prebuilt "
          f"plan (device time {dev:.4f} ms), wrapper {w:.4f} ms, bound "
          f"{bound:.4f} ms (bytes) = {bound / ms:.1%} of the kernel's "
          f"time, {bound / w:.1%} of the wrapper's; library (zeros + "
          f"index_put_) {lib:.4f} ms; plain {p1:.3f}/{p2:.3f} ms "
          f"(loops of {reps})", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, wrapper_ms=w, library_ms=lib,
                bound_ms=bound, device_ms=dev)


def _k1_list_fns(rows, cols, vals, M, N):
    """`_k1_time`'s arguments for one whole list: the kernel on a prebuilt
    plan, the wrapper (plan + launch), the plain version, the library
    yardstick on element indices built beforehand, and the bound of the
    list's valid entries."""
    import torch
    from linearsfm_tpu_torch.ops import kernels
    plan = kernels.coo_plan(rows, cols, M, N)
    shape, idx, v = _library_inputs(rows, cols, vals, M, N)
    P, _, R, C = vals.shape
    return (lambda: kernels.blockcoo_to_dense_planned(plan, vals),
            lambda: kernels.blockcoo_to_dense(rows, cols, vals, M, N),
            lambda: kernels.blockcoo_to_dense_ref(rows, cols, vals, M, N),
            lambda: torch.zeros(shape, device="cuda",
                                dtype=vals.dtype).index_put_(
                idx, v, accumulate=True),
            _k1_bound_ms(P, M, N, R, C, vals.element_size(),
                         int(idx[0].numel()) // (R * C)))


def phase_kernels():
    import torch
    from linearsfm_tpu_torch.ops import kernels

    g = torch.Generator(device="cuda").manual_seed(41)
    cases = {
        "K=0": (torch.zeros((1, 0), dtype=torch.int64, device="cuda"),
                torch.zeros((1, 0), dtype=torch.int64, device="cuda"),
                torch.zeros((1, 0, 6, 3), device="cuda"), 5, 7),
        "padding+duplicates+unsorted 6x3": _coo_case(g, 1, 700, 37, 53, 3,
                                                     pad_every=13),
        "sorted 6x6": _coo_case(g, 1, 500, 29, 29, 6, sort_rows=True),
        "lane-folded 8 lanes 6x3": _coo_case(g, 8, 300, 20, 40, 3,
                                             pad_every=7),
        "float64 lane-folded 4 lanes 6x6": _coo_case(
            g, 4, 400, 24, 24, 6, pad_every=11, dtype=torch.float64),
        # level 1 of the 2,048-map tree: 1,024 pair lanes, Mo = No = 32
        "level1 A 6x6": _coo_case(g, 1024, 145, 32, 32, 6, sort_rows=True,
                                  zero_frac=0.1),
        "level1 W 6x3": _coo_case(g, 1024, 144, 32, 32, 3, sort_rows=True,
                                  zero_frac=0.05),
        # root join: Mo = 2048, No = 11712 -> 4 stripes of 2928 features
        "root A 6x6": _coo_case(g, 1, 19585, 2048, 2048, 6, sort_rows=True,
                                zero_frac=0.05),
        "root W stripe 6x3": _coo_case(g, 1, 196320, 2048, 11712, 3,
                                       sort_rows=True, zero_frac=0.03,
                                       col_window=(2928, 2928)),
    }
    # stripes of one plan of the whole W list, one launch per window
    # (name: list, windows)
    windowed = {
        "root W stripe 6x3 (plan)": (
            _coo_case(g, 1, 196320, 2048, 11712, 3, sort_rows=True,
                      zero_frac=0.03), [(2928, 2928)]),
        # stereo level 10: 2 pair lanes, Mo = 1024, No = 7712 in 2 stripes
        # of 3,856, 2 x 44,800 W blocks per lane
        "level10 W stripes 6x3 (plan)": (
            _coo_case(g, 2, 89600, 1024, 7712, 3, sort_rows=True,
                      zero_frac=0.03), [(0, 3856), (3856, 3856)]),
    }
    # the main path's lists run again in float64 (the direct levels: the
    # CLI's default and the host executor's dense levels), each through
    # both wrappers (a plan of its own list, and a shared plan)
    main = ("level1 A 6x6", "level1 W 6x3", "root A 6x6", "root W stripe 6x3")
    timed = ("level1 A 6x6", "level1 W 6x3", "root A 6x6",
             "root W stripe 6x3 (plan)", "level10 W stripes 6x3 (plan)")
    max_err = 0.0
    times = {}

    def check(name, got, ref, dup):
        nonlocal max_err
        max_err = max(max_err, _k1_check(name, got, ref, dup))

    def dtypes(name, vals):
        """(tag, values) in the case's own dtype, and in float64 for the
        main path's lists."""
        out = [(name, vals)]
        if name in main or name.endswith("(plan)"):
            out.append((f"float64 {name}", vals.to(torch.float64)))
        return out

    for name, (rows, cols, vals0, M, N) in cases.items():
        dup = _has_duplicates(rows, cols, M, N)
        for tag, vals in dtypes(name, vals0):
            ref = kernels.blockcoo_to_dense_ref(rows, cols, vals, M, N)
            got = kernels.blockcoo_to_dense(rows, cols, vals, M, N)
            torch.cuda.synchronize()
            check(tag, got, ref, dup)
            del got
            if name in main:
                plan = kernels.coo_plan(rows, cols, M, N)
                got = kernels.blockcoo_to_dense_planned(plan, vals)
                torch.cuda.synchronize()
                check(f"{tag} (plan)", got, ref, dup)
                del got, plan
            del ref
            if name in timed:
                times[tag] = _k1_time(tag, *_k1_list_fns(rows, cols, vals,
                                                         M, N))

    for name, ((rows, cols, vals0, M, N), wins) in windowed.items():
        plan = kernels.coo_plan(rows, cols, M, N)
        for tag, vals in dtypes(name, vals0):
            for lo, width in wins:
                srows, scols = _masked_stripe(rows, cols, lo, width)
                dup = _has_duplicates(srows, scols, M, width)
                ref = kernels.blockcoo_to_dense_ref(srows, scols, vals, M,
                                                    width)
                got = kernels.blockcoo_to_dense_planned(plan, vals, lo, width)
                torch.cuda.synchronize()
                check(f"{tag} window [{lo}, {lo + width})", got, ref, dup)
                del got
                # the same stripe through the wrapper: a plan of its own list
                got = kernels.blockcoo_to_dense(srows, scols, vals, M, width)
                torch.cuda.synchronize()
                check(f"{tag} window [{lo}, {lo + width}) (own list)", got,
                      ref, dup)
                del got, ref
            lo, width = wins[0]
            srows, scols = _masked_stripe(rows, cols, lo, width)
            shape, idx, v = _library_inputs(srows, scols, vals, M, width)
            P, _, R, C = vals.shape
            # the wrapper: a plan of the stripe's own list and one launch
            times[tag] = _k1_time(
                tag,
                lambda: kernels.blockcoo_to_dense_planned(plan, vals, lo,
                                                          width),
                lambda: kernels.blockcoo_to_dense(srows, scols, vals, M,
                                                  width),
                lambda: kernels.blockcoo_to_dense_ref(srows, scols, vals, M,
                                                      width),
                lambda: torch.zeros(shape, device="cuda",
                                    dtype=vals.dtype).index_put_(
                    idx, v, accumulate=True),
                _k1_bound_ms(P, M, width, R, C, vals.element_size(),
                             int(idx[0].numel()) // (R * C)))
            del idx, v
        del plan
    return max_err, times


def _device_ms(fns, reps=10):
    """Device time of one call of each function of `fns` ({name: fn}): the
    summed durations of the kernels, fills and copies the call launches, from
    a torch.profiler trace, median of `reps` calls (after two warm-up calls
    each; the calls of the functions alternate). Before each call a 256 MB
    fill, outside the measured range, evicts the 50 MB L2, so every call
    reads its inputs from HBM. Late in a long process the profiler drops
    the device records of a session's first launches (a range would read
    as zero or short), so each session opens with 64 small fills outside
    the ranges and profiles `reps` + 10 calls of each function; a call
    counts only if every launch, fill and copy issued inside its range has
    its device record, and the median is of the last `reps` calls that
    count. If fewer count, the calls are profiled again, at most three
    times in all; then it fails."""
    import statistics
    import torch
    from linearsfm_tpu_torch.ops import kernels
    from linearsfm_tpu_torch.tools.profile_k1 import device_events_by_range

    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    pad = torch.empty(1024, dtype=torch.float32, device="cuda")
    for fn in fns.values():
        fn()
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    attempts = 3
    for attempt in range(1, attempts + 1):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(64):
                pad.zero_()
            torch.cuda.synchronize()
            for _ in range(reps + 10):
                for name, fn in fns.items():
                    flush.zero_()
                    with torch.profiler.record_function(f"time/{name}"):
                        fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tmp:
            trace = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(trace)
            per = device_events_by_range(trace, "time/")
        whole = {name: [us for us, n, k in per.get(f"time/{name}", [])
                        if n == k and n] for name in fns}
        lost = {name: [(n, k) for _, n, k in per.get(f"time/{name}", [])
                       if n != k or not n] for name in fns}
        if all(len(us) >= reps for us in whole.values()):
            if any(lost.values()):
                print(f"device time: calls left out, the profiler having "
                      f"lost their device records ((device events, "
                      f"launches) of each): {lost}", flush=True)
            return {name: statistics.median(us[-reps:]) / 1e3
                    for name, us in whole.items()}
        print(f"device time, attempt {attempt} of {attempts}: the profiler "
              f"lost device records; (device events, launches) per call: "
              f"{lost}", flush=True)
    raise AssertionError(f"device time of "
                         f"{sorted(n for n, c in lost.items() if c)}: device "
                         f"records lost in {attempts} profiled runs")


def _inv3x3_cases(dtype):
    """K2 inputs on the card: random SPD blocks with a zero, a NaN and two
    near-singular blocks; the mono plan's level-1 lane stack (1,024 pairs of
    feature capacity 32) and its root join (two lanes of capacity 5,824)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(43)

    def spd(*lead):
        A = torch.randn(lead + (3, 3), generator=g, device="cuda", dtype=dtype)
        return A @ A.transpose(-1, -2) + 0.1 * torch.eye(3, device="cuda",
                                                         dtype=dtype)
    V = spd(300)
    V[7] = 0.0
    V[11, 1, 2] = V[11, 2, 1] = float("nan")
    v = torch.randn(3, generator=g, device="cuda", dtype=dtype)
    V[13] = torch.outer(v, v)                           # rank 1
    V[17] = torch.outer(v, v) + 1e-5 * torch.eye(3, device="cuda", dtype=dtype)
    return {"special": V, "level1 [1024, 64]": spd(1024, 64),
            "root [1, 11648]": spd(1, 11648)}


def _wy_lists(g, V, K, pad_every=17):
    """A W list [P, K] over the feature blocks V [P, N]: random 6x3 blocks
    at random features, every pad_every-th entry padding (W = 0, wf = 0) as
    the joins pad."""
    import torch
    P, N = V.shape[:2]
    W = torch.randn((P, K, 6, 3), generator=g, device="cuda", dtype=V.dtype)
    wf = torch.randint(0, max(N, 1), (P, K), generator=g, device="cuda")
    wp = torch.randint(0, 64, (P, K), generator=g, device="cuda")
    Wpf = torch.stack([wp, wf], dim=-1)
    W[:, ::pad_every] = 0.0
    Wpf[:, ::pad_every] = 0
    return W, Wpf


def _wy_cases(dtype, shapes):
    """Fused K2 inputs (V, W, Wpf) on the card: K = 0; N = 0 with K > 0 on
    padding; zero, NaN and near-singular blocks with entries on them and
    entries whose wf is outside [0, N); tile-edge counts (256 entries a
    tile: 255, 256, 257, an odd count over two tiles, three lanes of 171);
    and the main path's shapes (`shapes`: name -> (P, N, K))."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(45)

    def spd(P, N):
        A = torch.randn((P, N, 3, 3), generator=g, device="cuda", dtype=dtype)
        return A @ A.transpose(-1, -2) + 0.1 * torch.eye(3, device="cuda",
                                                         dtype=dtype)

    def case(P, N, K):
        V = spd(P, N)
        return (V, *_wy_lists(g, V, K))
    out = {"K=0": case(4, 300, 0),
           "N=0, K>0 padding": (spd(2, 0),
                                torch.zeros((2, 300, 6, 3), device="cuda",
                                            dtype=dtype),
                                torch.zeros((2, 300, 2), device="cuda",
                                            dtype=torch.int64))}
    V = _inv3x3_cases(dtype)["special"][None]
    W, Wpf = _wy_lists(g, V, 1000)
    for k, f in enumerate((7, 11, 13, 17, -1, 300, 10**6)):
        Wpf[0, 3 + 10 * k:1000:70, 1] = f
    out["zero/NaN/near-singular blocks, wf outside [0, N)"] = (V, W, Wpf)
    for K in (255, 256, 257, 515):
        out[f"K={K}"] = case(1, 64, K)
    out["3 lanes K=171"] = case(3, 70, 171)
    for name, (P, N, K) in shapes.items():
        out[name] = case(P, N, K)
    return out


def _k2_bound_ms(P, N, K, esz, peak):
    """(least time of one fused K2 launch, what bounds it): its bytes (see
    `profile_k1.k2_bytes`) over the HBM rate, or its operations (33 per V
    block for the inverse, 90 per W entry for the 6x3 by 3x3 product) over
    the card's non-tensor peak, whichever is larger."""
    from linearsfm_tpu_torch.tools.profile_k1 import k2_bytes
    by_bytes = k2_bytes(P, N, K, esz) / HBM_BYTES_PER_S * 1e3
    by_ops = (P * N * 33 + P * K * 90) / peak * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def _exact(got, ref):
    """torch.equal, NaN where the plain version has NaN."""
    import torch
    return (torch.equal(torch.isnan(got), torch.isnan(ref))
            and torch.equal(torch.nan_to_num(got), torch.nan_to_num(ref)))


def phase_k2(shapes):
    """K2 against its plain versions, exactly, and its device times at the
    main path's shapes (`shapes`: name -> (P, N, K), from the planner)."""
    import torch
    from linearsfm_tpu_torch.ops import kernels
    from linearsfm_tpu_torch.ops.segment import take
    from linearsfm_tpu_torch.utils.flops import PEAK_F32

    max_err = 0.0
    times = {}

    def err_of(got, ref):
        fin = torch.isfinite(ref)
        return float((got[fin] - ref[fin]).abs().max()) if fin.any() else 0.0

    for dtype in (torch.float32, torch.float64):
        dn = str(dtype).split(".")[-1]
        # the inverse alone (the fused launch with K = 0)
        for name, V in _inv3x3_cases(dtype).items():
            got = kernels.inv3x3_sym(V)
            ref = kernels.inv3x3_sym_ref(V)
            torch.cuda.synchronize()
            if not _exact(got, ref):
                raise AssertionError(f"K2 {name} {dn}: kernel != plain")
            err = err_of(got, ref)
            max_err = max(max_err, err)
            print(f"k2 {name} {dn}: {list(V.shape)} max_abs_err={err:.3e} "
                  f"nan blocks {int(torch.isnan(got).any(-1).any(-1).sum())} "
                  f"(torch.equal) ok", flush=True)
        # fused: V^-1 and Y = W V^-1[wf] in one launch
        for name, (V, W, Wpf) in _wy_cases(dtype, shapes).items():
            n0 = kernels.launches["inv3x3_sym"]
            got = kernels.inv3x3_wy(V, W, Wpf)
            ref = kernels.inv3x3_wy_ref(V, W, Wpf)
            torch.cuda.synchronize()
            if kernels.launches["inv3x3_sym"] != n0 + 1:
                raise AssertionError(f"K2 fused {name} {dn}: not one launch")
            for what, a, b in zip(("Vinv", "Y"), got, ref):
                if a.shape != b.shape or not _exact(a, b):
                    raise AssertionError(f"K2 fused {name} {dn}: {what} "
                                         f"kernel != plain")
            err = max(err_of(got[0], ref[0]), err_of(got[1], ref[1]))
            max_err = max(max_err, err)
            print(f"k2 fused {name} {dn}: V {list(V.shape)} W "
                  f"{list(W.shape)} max_abs_err={err:.3e} NaN Y blocks "
                  f"{int(torch.isnan(got[1]).any(-1).any(-1).sum())} "
                  f"(torch.equal, both outputs) ok", flush=True)
            del got, ref
    for name, (P, N, K) in shapes.items():
        for dtype in (torch.float32, torch.float64):
            if dtype == torch.float64 and "root" not in name:
                continue
            dn = str(dtype).split(".")[-1]
            g = torch.Generator(device="cuda").manual_seed(P + N + K)
            A = torch.randn((P, N, 3, 3), generator=g, device="cuda",
                            dtype=dtype)
            V = A @ A.transpose(-1, -2) + 0.1 * torch.eye(3, device="cuda",
                                                          dtype=dtype)
            W, Wpf = _wy_lists(g, V, K)
            wf = Wpf[..., 1]
            t = _device_ms({
                "fused": lambda: kernels.inv3x3_wy(V, W, Wpf),
                "inverse": lambda: kernels.inv3x3_sym(V),
                "unfused": lambda: W @ take(kernels.inv3x3_sym(V), wf),
                "library": lambda: W @ take(torch.linalg.inv(V), wf),
                "plain": lambda: kernels.inv3x3_wy_ref(V, W, Wpf)})
            peak = PEAK_F32 if dtype == torch.float32 else F64_FLOP_PER_S
            bound, by = _k2_bound_ms(P, N, K, V.element_size(), peak)
            inv_bound, _ = _k2_bound_ms(P, N, 0, V.element_size(), peak)
            times[(name, dn)] = dict(ms=t["fused"], plain_ms=t["plain"],
                                     library_ms=t["library"], bound_ms=bound,
                                     bound_by=by, inverse_ms=t["inverse"],
                                     inverse_bound_ms=inv_bound,
                                     unfused_ms=t["unfused"])
            print(f"k2 time {name} P {P} N {N} K {K} {dn}: fused "
                  f"{t['fused']:.5f} ms, bound {bound:.5f} ms ({by}) = "
                  f"{bound / t['fused']:.1%}; inverse alone (K = 0) "
                  f"{t['inverse']:.5f} ms vs {inv_bound:.5f} ms; unfused "
                  f"(K2 K = 0 + take + torch.matmul) {t['unfused']:.5f} ms; "
                  f"library (torch.linalg.inv + take + torch.matmul) "
                  f"{t['library']:.5f} ms; plain {t['plain']:.5f} ms (device "
                  f"time, median of 10 calls, L2 flushed)", flush=True)
            del V, W, Wpf, wf, A
    return max_err, times


TAILS = [(), (3,), (6,), (6, 3), (3, 3), (6, 6)]


def _k3_case(g, P, K, num, tail, dtype, lo=-3, hi=None, pad_every=0):
    """(vals [P, K, *tail], idx [P, K], num) on the card: indices in [lo,
    hi) (by default dropped ones on both sides); every pad_every-th entry
    padding as the joins pad (value 0, index 0)."""
    import torch
    hi = num + 3 if hi is None else hi
    idx = torch.randint(lo, hi, (P, K), generator=g, device="cuda")
    vals = torch.randn((P, K) + tail, generator=g, device="cuda",
                       dtype=dtype)
    if pad_every:
        idx[:, ::pad_every] = 0
        vals[:, ::pad_every] = 0.0
    return vals, idx, num


def _k3_long(g, tail, dtype, n=2017, num=7):
    """(vals, idx, num) on the card: three lanes whose long segments (n
    entries: many of K3's shared-memory stages, no multiple of 32) lie at a
    lane's start (lane 0, segment 0), at its end (lane 1, segment num - 1)
    and at both (lane 2), among 300 entries of random index per lane
    (dropped ones too), in shuffled list order."""
    import torch
    lanes = []
    for segs in ([0], [num - 1], [0, num - 1]):
        i = torch.cat([torch.full((n,), s, device="cuda") for s in segs]
                      + [torch.randint(-3, num + 3, (300,), generator=g,
                                       device="cuda")])
        i = torch.cat([i, torch.full((2 * n - len(i) + 300,), num + 1,
                                     device="cuda")])
        lanes.append(i[torch.randperm(len(i), generator=g, device="cuda")])
    idx = torch.stack(lanes)
    vals = torch.randn(idx.shape + tail, generator=g, device="cuda",
                       dtype=dtype)
    return vals, idx, num


def _k3_special(g, tail, dtype, P=2, K=900, num=300):
    """(vals, idx, num, base) on the card: values with NaN, +-inf,
    subnormals and signed zeros among normal ones (one in ten), and a base
    for the accumulate-into form whose every other element is -0.0 (many
    segments empty)."""
    import torch
    idx = torch.randint(-2, num + 2, (P, K), generator=g, device="cuda")
    tiny = torch.finfo(dtype).smallest_normal / 4
    pool = torch.tensor([math.nan, math.inf, -math.inf, tiny, -tiny,
                         3 * tiny, 0.0, -0.0], dtype=dtype, device="cuda")
    vals = torch.randn((P, K) + tail, generator=g, device="cuda",
                       dtype=dtype)
    pick = torch.rand(vals.shape, generator=g, device="cuda") < 0.1
    which = torch.randint(0, len(pool), vals.shape, generator=g,
                          device="cuda")
    vals = torch.where(pick, pool[which], vals)
    base = torch.randn((P, num) + tail, generator=g, device="cuda",
                       dtype=dtype)
    base.view(-1)[::2] = -0.0
    return vals, idx, num, base


def _same_bits(a, b) -> bool:
    """a and b (one device) bit for bit equal, NaN against NaN whatever its
    payload (the card's NaN need not carry the CPU's): the same NaN places
    and the same bits, signed zeros included, everywhere else. Stricter
    than torch.equal outside NaN (-0.0 != 0.0 here)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    na, nb = torch.isnan(a), torch.isnan(b)
    ints = torch.int32 if a.dtype == torch.float32 else torch.int64
    return bool(torch.equal(na, nb) and torch.equal(
        a.masked_fill(na, 0).view(ints), b.masked_fill(nb, 0).view(ints)))


def _k3_bound_ms(plan, T, esz, add_ns):
    """Least time of one K3 launch, both terms: bytes (the kept entries'
    values and positions, the offsets and the output, once each:
    `kernels.seg_sum_bytes`) over the HBM rate, and the chain floor (the
    longest segment's adds, each waiting for the last, at the measured
    dependent add latency `add_ns`). Returns (bytes ms, chain ms, longest
    segment)."""
    from linearsfm_tpu_torch.ops import kernels
    P, num = plan.P, plan.num
    lens = (plan.off[1:] - plan.off[:-1]).view(P, num + 1)[:, :num]
    longest = int(lens.max()) if lens.numel() else 0
    nbytes = kernels.seg_sum_bytes(int(lens.sum()), P, num, T, esz)
    return nbytes / HBM_BYTES_PER_S * 1e3, longest * add_ns * 1e-6, longest


def _max_err(a, b) -> float:
    """Largest |a - b|, on a's device, where the two differ (NaN against
    NaN and equal infinities count as equal); 0.0 for empty tensors."""
    import torch
    if not a.numel():
        return 0.0
    b = b.to(a.device)
    d = (a - b).abs()
    d[(a == b) | (torch.isnan(a) & torch.isnan(b))] = 0
    return float(d.max())


def _k3_cpu_sum(vals, idx, num, out=None, alpha=1):
    """The CPU's `index_add_` on the raw inputs, with no plan: the flat key
    of entry (p, k) is p*num + idx[p, k], an index outside [0, num) goes to
    a spare row; into zeros, or a copy of `out` [P, num, *tail]. The
    reference the card's sort and offsets are held against."""
    import torch
    vals, idx = vals.cpu(), idx.cpu()
    P, tail = idx.shape[0], tuple(vals.shape[2:])
    ok = (idx >= 0) & (idx < num)
    flat = torch.where(ok, idx + torch.arange(P)[:, None] * num, P * num)
    res = vals.new_zeros((P * num + 1,) + tail)
    if out is not None:
        res[:P * num] = out.cpu().reshape((P * num,) + tail)
    res.index_add_(0, flat.reshape(-1), vals.reshape((-1,) + tail),
                   alpha=alpha)
    return res[:P * num].view((P, num) + tail)


def _k3_hold(name, vals, plan, idx, out=None, alpha=1):
    """K3 on (vals, plan[, out, alpha]) against its plain version on the same
    inputs and against the CPU's `index_add_` on vals and the raw index
    list idx (`_k3_cpu_sum`, which shares no sort or offsets with the
    card), both bit for bit (`_same_bits`: torch.equal, signed zeros
    included, and NaN where the reference has NaN); one launch (none for
    an empty output).
    Returns the largest |kernel - reference| (0.0 when equal)."""
    import torch
    from linearsfm_tpu_torch.ops import kernels
    base = None if out is None else out.clone()
    ref = kernels.seg_sum_fixed_ref(vals, plan, None if out is None
                                    else out.clone(), alpha)
    n0 = kernels.launches[K3]
    got = kernels.seg_sum_fixed(vals, plan, out, alpha)
    torch.cuda.synchronize()
    if kernels.launches[K3] != n0 + (got.numel() > 0):
        raise AssertionError(f"K3 {name}: not one launch")
    cpu = _k3_cpu_sum(vals, idx, plan.num, base, alpha)
    err = max(_max_err(got, ref), _max_err(got, cpu))
    if not _same_bits(got, ref):
        raise AssertionError(f"K3 {name}: kernel != plain, max err {err}")
    if not _same_bits(got.cpu(), cpu):
        raise AssertionError(f"K3 {name}: kernel != the CPU's index_add_ on "
                             f"the raw index list, max err {err}")
    return err


def _k3_times(tag, vals, plan, idx, N, add_ns, reps=20):
    """CUDA-event times of K3 on one input, as a new sum: the kernel on a
    prebuilt plan (the lesser of two loops), plan + launch, the plain
    version and two library yardsticks over the same flat keys,
    `index_add_` (atomics) and `index_add_` under
    `torch.use_deterministic_algorithms(True)`, beside the two bounds
    (bytes, and the chain floor at `add_ns` per add); prints one line.
    `bound_ms` is the larger of the two: `bound_by` "bytes", or
    "operations" where the chain of dependent adds bounds the launch
    (`floor_by` "chain"); `bytes_ms` and `chain_floor_ms` keep both."""
    import torch
    from linearsfm_tpu_torch.ops import kernels
    P = idx.shape[0]
    tail = tuple(vals.shape[2:])
    T = math.prod(tail)
    keep = (idx >= 0) & (idx < N)
    flat = torch.where(keep, idx + torch.arange(P, device="cuda")[:, None]
                       * N, P * N).reshape(-1)
    v2 = vals.reshape((-1,) + tail)
    lib_out = torch.zeros((P * N + 1,) + tail, device="cuda",
                          dtype=vals.dtype)

    def library():
        lib_out.zero_().index_add_(0, flat, v2)

    def library_det():
        torch.use_deterministic_algorithms(True)
        try:
            lib_out.zero_().index_add_(0, flat, v2)
        finally:
            torch.use_deterministic_algorithms(False)
    kernel = lambda: kernels.seg_sum_fixed(vals, plan)  # noqa: E731
    wrapper = lambda: kernels.seg_sum_fixed(  # noqa: E731
        vals, kernels.seg_plan(idx, N))
    plain = lambda: kernels.seg_sum_fixed_ref(vals, plan)  # noqa: E731
    k1, w = _loop_ms(kernel, reps), _loop_ms(wrapper, reps)
    p = _loop_ms(plain, 3)
    lib, det = _loop_ms(library, reps), _loop_ms(library_det, reps)
    k2 = _loop_ms(kernel, reps)
    ms = min(k1, k2)
    byte_ms, chain_ms, longest = _k3_bound_ms(plan, T,
                                              vals.element_size(), add_ns)
    floor = max(byte_ms, chain_ms)
    by = "bytes" if byte_ms >= chain_ms else "chain"
    print(f"k3 time {tag} (tail {tail}, longest segment {longest} "
          f"entries): kernel {k1:.4f}/{k2:.4f} ms on a prebuilt plan, plan "
          f"+ launch {w:.4f} ms; bound: bytes {byte_ms:.4f} ms, chain floor "
          f"{chain_ms:.4f} ms ({longest} adds at {add_ns:.3f} ns), so "
          f"{by}: {floor / ms:.1%} of the kernel's time; library "
          f"index_add_ (atomics) {lib:.4f} ms ({lib / ms:.2f}x the "
          f"kernel's time), index_add_ under use_deterministic_algorithms "
          f"{det:.4f} ms; plain {p:.3f} ms (CUDA events, loops of {reps}, "
          f"plain 3)", flush=True)
    return dict(ms=ms, wrapper_ms=w, plain_ms=p, library_ms=lib,
                library_det_ms=det, bound_ms=floor,
                bound_by="bytes" if by == "bytes" else "operations",
                bytes_ms=byte_ms, chain_floor_ms=chain_ms, longest=longest,
                floor_by=by)


def phase_k3(shapes):
    """K3 (`seg_sum_fixed`) against its plain version on the card, bit for
    bit (`_k3_hold`), float32 and float64: K = 0, every index dropped,
    empty segments, one long run, unsorted keys, lane-folded batches of
    every tail, long segments (2,017 entries) at the start and the end of
    lanes at tails 1, 18 and 36, NaN, +-inf, subnormals and signed zeros
    (a base of -0.0s in the accumulate-into form), the accumulate-into form
    (alpha = -1) of every case, and the direct mono path's W lists at level
    1 and the root (`shapes`: (P, N, K) of the mono plan; the congruence's
    [P, K, 6, 3] sum over wf into N features, every 17th entry padding).
    Every case is also held against the CPU's `index_add_` on the raw
    index list (`_k3_cpu_sum`), so the card's sort and offsets face a
    reference that shares neither. The chain-floor probe measures the
    card's dependent add latency in both dtypes
    (`direct_paths.add_latency_ns`). At the main-path shapes (both dtypes),
    CUDA events over loops of calls (`_k3_times`). The real paths' worst
    launches are held and timed where phase 12 runs those paths
    (`_K3InSitu.time_worst`). Returns (the largest |kernel - reference|
    measured, the times by (shape, dtype), the add latencies by dtype)."""
    import torch
    from linearsfm_tpu_torch.ops import kernels, segment

    t_phase = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(43)
    times, max_err = {}, 0.0
    for dtype in (torch.float32, torch.float64):
        dn = str(dtype).split(".")[-1]
        cases = {f"lane-folded 8 lanes {tail}": _k3_case(g, 8, 300, 40, tail,
                                                         dtype)
                 for tail in TAILS}
        long_idx = torch.full((2, 5000), 4, dtype=torch.int64,
                              device="cuda")
        long_idx[1, ::7] = 2
        cases.update({
            "K=0": _k3_case(g, 2, 0, 6, (6,), dtype),
            "all dropped": _k3_case(g, 2, 100, 5, (6, 3), dtype, lo=5,
                                    hi=12),
            "empty segments": _k3_case(g, 3, 5, 200, (3,), dtype),
            "one long run": (torch.randn((2, 5000, 6, 6), generator=g,
                                         device="cuda", dtype=dtype),
                             long_idx, 6),
            "unsorted wide": _k3_case(g, 1, 20000, 3000, (6, 3), dtype),
        })
        cases.update({f"long segments at lane ends {tail}":
                      _k3_long(g, tail, dtype)
                      for tail in ((), (6, 3), (6, 6))})
        bases = {f"special values {tail}": _k3_special(g, tail, dtype)
                 for tail in ((), (6, 3), (6, 6))}
        cases.update({k: v[:3] for k, v in bases.items()})
        for name, (vals, idx, num) in cases.items():
            plan = kernels.seg_plan(idx, num)
            err = _k3_hold(f"{name} {dn}", vals, plan, idx)
            base = (bases[name][3] if name in bases else
                    torch.randn((idx.shape[0], num) + tuple(vals.shape[2:]),
                                generator=g, device="cuda", dtype=dtype))
            err = max(err, _k3_hold(f"{name} {dn} into, alpha -1", vals,
                                    plan, idx, base, alpha=-1))
            with segment.deterministic():
                got = segment.seg_sum(vals, idx, num)
            cpu = _k3_cpu_sum(vals, idx, num)
            err = max(err, _max_err(got, cpu))
            if not _same_bits(got.cpu(), cpu):
                raise AssertionError(f"K3 {name} {dn}: seg_sum in the scope "
                                     f"!= the CPU's index_add_")
            max_err = max(max_err, err)
            print(f"k3 {name} {dn}: vals {list(vals.shape)} into {num} "
                  f"segments, sum and accumulate-into (alpha -1) bit for bit "
                  f"the plain version and the CPU's index_add_ on the raw "
                  f"index list, max err {err:.3e} ok", flush=True)
        del cases, bases

    from linearsfm_tpu_torch.tools.direct_paths import add_latency_ns
    add_ns = {str(d).split(".")[-1]: add_latency_ns(d)
              for d in (torch.float32, torch.float64)}
    print(f"k3 chain-floor probe: dependent add latency {add_ns['float32']:.4f}"
          f" ns (float32), {add_ns['float64']:.4f} ns (float64), one thread, "
          f"CUDA events at 2**20 and 2**21 adds", flush=True)

    for level in ("level1", "root"):
        P, N, K = shapes[f"mono {level}"]
        for dtype in (torch.float32, torch.float64):
            dn = str(dtype).split(".")[-1]
            tag = f"mono {level} P {P} N {N} K {K} {dn}"
            vals, wf, _ = _k3_case(g, P, K, N, (6, 3), dtype, lo=0, hi=N,
                                   pad_every=17)
            plan = kernels.seg_plan(wf, N)
            base = torch.randn((P, N, 6, 3), generator=g, device="cuda",
                               dtype=dtype)
            max_err = max(max_err, _k3_hold(tag, vals, plan, wf),
                          _k3_hold(f"{tag} into, alpha -1", vals, plan, wf,
                                   base, alpha=-1))
            times[(level, dn)] = _k3_times(f"{tag} (6x3 over wf, every 17th "
                                           f"entry padding)", vals, plan, wf,
                                           N, add_ns[dn])
            del vals, wf, plan, base

    print(f"k3: phase {time.perf_counter() - t_phase:.2f} s, max |kernel - "
          f"reference| {max_err:.3e}", flush=True)
    return max_err, times, add_ns


class _K3InSitu:
    """While active, every K3 call (`kernels.seg_sum_fixed`, which
    `ops/segment` calls) is held against its plain version on its own
    inputs, `torch.equal` (in the accumulate-into form the plain version
    runs on a copy of the input taken before the kernel), and every plan
    built on the card (`kernels.seg_plan`) against the plan the CPU builds
    from the same index list, `torch.equal` permutation and offsets: so
    each sum is the CPU's in-order `index_add_` of the raw list. Counts
    the calls by dtype and the plans, keeps the largest (P, K, num, tail)
    seen and, across every instance, the largest |kernel - plain|
    (`worst`). Keeps a copy of the inputs of the launch with the most
    values on one chain (the longest segment times the values per entry,
    then P*K), with its call site and index list, for `time_worst`. Every
    plan built while active is kept with its index list until the exit
    (a join's sums reuse its plans)."""

    worst = 0.0

    def __enter__(self):
        from linearsfm_tpu_torch.ops import kernels
        from linearsfm_tpu_torch.tools.direct_paths import _call_site
        self.calls, self.plans, self.largest = {}, 0, (0, 0, 0, ())
        self.chain, self._lists = ((-1, 0), None), {}
        self._saved = kernels.seg_sum_fixed, kernels.seg_plan
        k3, seg_plan = self._saved

        def keep_if_longest(vals, plan, out, alpha):
            # a join's sums share the plans of its lists (ops/segment's
            # `planned`): each plan is kept with its list for the run
            idx = self._lists.get(id(plan), (None, None))[1]
            lens = (plan.off[1:] - plan.off[:-1]).view(
                plan.P, plan.num + 1)[:, :plan.num]
            key = ((int(lens.max()) if lens.numel() else 0)
                   * math.prod(vals.shape[2:]), plan.P * plan.K)
            if key > self.chain[0]:
                if idx is None:
                    raise AssertionError("K3 in situ: a plan not built by "
                                         "kernels.seg_plan in this run")
                self.chain = (key, (
                    _call_site(), vals.clone(), idx.clone(), plan.num, plan,
                    None if out is None else out.clone(), alpha))

        def held(vals, plan, out=None, alpha=1):
            import torch
            keep_if_longest(vals, plan, out, alpha)
            ref = kernels.seg_sum_fixed_ref(
                vals, plan, None if out is None else out.clone(), alpha)
            got = k3(vals, plan, out, alpha)
            torch.cuda.synchronize()
            err = _max_err(got, ref)
            _K3InSitu.worst = max(_K3InSitu.worst, err)
            if not torch.equal(got, ref):
                raise AssertionError(f"K3 in situ {list(vals.shape)} into "
                                     f"{plan.num}: kernel != plain, max err "
                                     f"{err}")
            dn = str(vals.dtype).split(".")[-1]
            self.calls[dn] = self.calls.get(dn, 0) + 1
            if plan.P * plan.K > self.largest[0] * self.largest[1]:
                self.largest = (plan.P, plan.K, plan.num,
                                tuple(vals.shape[2:]))
            return got

        def planned(idx, num):
            import torch
            plan = seg_plan(idx, num)
            cpu = seg_plan(idx.cpu(), num)
            if not (torch.equal(plan.perm.cpu(), cpu.perm)
                    and torch.equal(plan.off.cpu(), cpu.off)):
                raise AssertionError(f"K3 in situ: the card's plan of "
                                     f"{list(idx.shape)} over {num} != the "
                                     f"CPU's")
            self.plans += 1
            self._lists[id(plan)] = (plan, idx)
            return plan
        kernels.seg_sum_fixed, kernels.seg_plan = held, planned
        return self

    def __exit__(self, *exc):
        from linearsfm_tpu_torch.ops import kernels
        kernels.seg_sum_fixed, kernels.seg_plan = self._saved
        self._lists = {}
        return False

    def time_worst(self, tag, add_ns):
        """The kept launch with the most values on one chain, held once
        more in its own form (`_k3_hold`: bit for bit the plain version and
        the CPU's `index_add_` on its raw index list) and timed as a new
        sum in both dtypes (`_k3_times`); its error joins `worst`. Fails
        if no launch was kept."""
        import torch
        if self.chain[1] is None:
            raise AssertionError(f"{tag}: no K3 launch kept")
        site, vals, idx, num, plan, out, alpha = self.chain[1]
        self.chain = ((-1, 0), None)
        dn = str(vals.dtype).split(".")[-1]
        what = (f"{tag}: the launch with the most values on one chain, at "
                f"{site} (P, K, num) ({plan.P}, {plan.K}, {num}) {dn}")
        form = "" if out is None else f" into, alpha {alpha}"
        err = _k3_hold(what + form, vals, plan, idx, out, alpha)
        _K3InSitu.worst = max(_K3InSitu.worst, err)
        print(f"k3 {what}{form}: bit for bit the plain version and the "
              f"CPU's index_add_ on the raw index list, max err {err:.3e} "
              f"ok", flush=True)
        for dtype in (torch.float32, torch.float64):
            d = str(dtype).split(".")[-1]
            _k3_times(f"{what} as a {d} new sum", vals.to(dtype), plan, idx,
                      num, add_ns[d])

    def report(self, tag):
        """One line of what was held; fails if no call was held."""
        print(f"{tag}: every K3 call held against the plain version in situ "
              f"(torch.equal) and every plan against the CPU's: calls by "
              f"dtype {self.calls}, {self.plans} plans, largest (P, K, num, "
              f"tail) {self.largest}, max err {_K3InSitu.worst:.3e} ok",
              flush=True)
        if not self.calls or not self.plans:
            raise AssertionError(f"{tag}: no K3 call or plan held in situ")


class _K4InSitu:
    """While active, every K4 call (`kernels.schur_pairs`, which the f32
    branch of `schur._assemble_schur_dense` calls) is held against its plain
    version on copies of its own inputs, run on the card, `torch.equal` on
    S and E. Counts the calls and those on one lane (`root`: a tree's root
    join), and keeps copies of the inputs of the last call on one lane for
    `time_root`."""

    def __enter__(self):
        from linearsfm_tpu_torch.ops import kernels
        self.calls, self.root, self.kept = 0, 0, None
        self._saved = kernels.schur_pairs
        k4 = self._saved

        def held(S, E, W, Y, eF, plan):
            import torch
            S0, E0 = S.clone(), E.clone()
            got = k4(S, E, W, Y, eF, plan)
            want = kernels.schur_pairs_ref(S0.clone(), E0.clone(), W, Y, eF,
                                           plan)
            torch.cuda.synchronize()
            if not (torch.equal(S, want[0]) and torch.equal(E, want[1])):
                raise AssertionError(
                    f"K4 in situ {list(S.shape)}: kernel != plain, max err "
                    f"{max(_max_err(S, want[0]), _max_err(E, want[1]))}")
            self.calls += 1
            if S.shape[0] == 1:
                self.root += 1
                self.kept = (S0, E0, W.clone(), Y.clone(), eF.clone(), plan)
            return got
        kernels.schur_pairs = held
        return self

    def __exit__(self, *exc):
        from linearsfm_tpu_torch.ops import kernels
        kernels.schur_pairs = self._saved
        return False

    def report(self, tag):
        """One line of what was held; fails unless calls were held at the
        root."""
        print(f"{tag}: every K4 call held against the plain version in situ "
              f"(torch.equal, S and E): {self.calls} calls, {self.root} on "
              f"one lane ok", flush=True)
        if not self.root:
            raise AssertionError(f"{tag}: no K4 call held at the root")

    def time_root(self, tag, reps=5):
        """The kept root launch timed alone (CUDA events, A and eP copied
        in before each launch, outside the events; median of `reps` after
        one warm launch), beside its bounds and the plain version. Returns
        the kernel record's times."""
        import statistics
        import torch
        from linearsfm_tpu_torch.ops import kernels
        from linearsfm_tpu_torch.utils import flops
        S0, E0, W, Y, eF, plan = self.kept
        P, M, N = W.shape[0], plan.M, plan.N
        live, products, touched = _k4_work(plan)
        nbytes = live * 72 * 2 + P * N * 12 + touched * 144 * 2
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        flop_ms = products * 216 / flops.PEAK_F32 * 1e3

        def timed(fn, n):
            S, E = torch.empty_like(S0), torch.empty_like(E0)
            ts = []
            for _ in range(n + 1):
                S.copy_(S0)
                E.copy_(E0)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn(S, E)
                b.record()
                b.synchronize()
                ts.append(a.elapsed_time(b))
            return statistics.median(ts[1:])
        ms = timed(lambda S, E: kernels.schur_pairs(S, E, W, Y, eF, plan),
                   reps)
        plain_ms = timed(lambda S, E: kernels.schur_pairs_ref(
            S, E, W, Y, eF, plan), 2)
        bound = max(bytes_ms, flop_ms)
        by = "bytes" if bytes_ms >= flop_ms else "flops"
        print(f"{tag}: K4 at the root (P, M, N) ({P}, {M}, {N}): {live} live "
              f"W entries, {products} block products, {touched} touched S "
              f"blocks ({touched / (P * M * M):.1%} of S); kernel "
              f"{ms:.4f} ms vs bound {bound:.4f} ms ({by}; bytes "
              f"{bytes_ms:.4f}, flops {flop_ms:.4f}) = {bound / ms:.1%}; "
              f"plain version {plain_ms:.3f} ms", flush=True)
        return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                    library_ms=None, bytes_ms=bytes_ms, flop_ms=flop_ms,
                    products=products, touched_blocks=touched)


def _k4_work(plan):
    """(live W entries, block products, touched S blocks) of one K4 launch,
    from its plan: each live entry (p, f) meets every live entry of feature
    f, and the products land on the distinct (lane, p, q)."""
    import torch
    dev = plan.perm.device
    M, N = plan.M, plan.N
    rptr = plan.row_ptr.long()
    live = int(rptr[-1])
    r = torch.repeat_interleave(torch.arange(rptr.numel() - 1, device=dev),
                                rptr[1:] - rptr[:-1])
    f = (r // M) * N + plan.scol[:live].long()
    by_f = torch.argsort(f, stable=True)
    cptr = torch.searchsorted(f[by_f], torch.arange(
        (rptr.numel() - 1) // M * N + 1, device=dev))
    c0 = cptr[f]
    cnt = cptr[f + 1] - c0
    src = torch.repeat_interleave(cnt)
    i = torch.arange(src.numel(), device=dev)
    other = by_f[c0[src] + i - (torch.cumsum(cnt, 0) - cnt)[src]]
    key = r[src] * M + r[other] % M
    return live, int(src.numel()), int(torch.unique(key).numel())


# K4's root launch timed by `_K4InSitu.time_root`, by run tag
K4_TIMES = {}

# K5 against the plain transform in situ: |kernel - plain| <= tol x the
# plain field's largest magnitude (the reasons: tests/test_torch_kernels.py,
# K5_TOL)
K5_TOL = {"torch.float64": 1e-10, "torch.float32": 1e-5}


def _k5_err(tag, got, want):
    """The largest relative difference of K5's map `got` from the plain
    version's `want` over the float fields (each over that field's largest
    magnitude); fails on a shape, dtype, index, id or gauge tag that
    differs, on a non-finite value, or past K5_TOL."""
    import torch
    from linearsfm_tpu_torch import types
    worst = 0.0
    pairs = [(f, getattr(got, f), getattr(want, f)) for f in types.MAP_FIELDS]
    pairs += [(f"gauge.{f}", getattr(got.gauge, f), getattr(want.gauge, f))
              for f in types.GAUGE_FIELDS]
    for f, a, b in pairs:
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{tag}: {f} {list(a.shape)} {a.dtype}, "
                                 f"plain {list(b.shape)} {b.dtype}")
        if not a.is_floating_point():
            if not torch.equal(a, b):
                raise AssertionError(f"{tag}: {f} differs from the plain "
                                     f"version's")
            continue
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"{tag}: {f} not finite")
        if not b.numel():
            continue
        scale = float(b.abs().max())
        err = float((a - b).abs().max()) / scale if scale else float(
            (a - b).abs().max())
        if not err <= K5_TOL[str(a.dtype)]:
            raise AssertionError(f"{tag}: {f} off the plain version by "
                                 f"{err:.3e} of its largest magnitude")
        worst = max(worst, err)
    return worst


class _K5InSitu:
    """While active, every K5 call (`kernels.gauge_congruence`, which
    `congruence.transform_map_*` call) is held against the plain transform
    (`transform_map_*_ref`, on the card) on its own inputs (`_k5_err`).
    The plain transform's own K3 launches are taken back out of
    `kernels.launches`, so a held run counts the path's launches alone.
    Counts the calls and those on one lane, and keeps the inputs of the
    first call (level 1's) and of the last call on one lane (the root's)
    for `time_calls`."""
    worst = 0.0   # the largest relative difference held in this process

    def __enter__(self):
        from linearsfm_tpu_torch.ops import congruence, kernels
        self.calls, self.root, self.kept = 0, 0, {}
        self._saved = fn = kernels.gauge_congruence
        self._refs = {False: congruence.transform_map_stereo_ref,
                      True: congruence.transform_map_mono_ref}

        def held(lm, mono, new, info_dtype=None):
            got = fn(lm, mono, new, info_dtype)
            counts = dict(kernels.launches)
            want = self._refs[mono](lm, *new, info_dtype)
            kernels.launches.update(counts)
            err = _k5_err(f"K5 in situ {list(lm.U.shape[:2])}", got, want)
            _K5InSitu.worst = max(_K5InSitu.worst, err)
            self.calls += 1
            call = (lm, mono, new, info_dtype)
            self.kept.setdefault("level 1", call)
            if lm.poses.shape[0] == 1:
                self.root += 1
                self.kept["root"] = call
            return got
        kernels.gauge_congruence = held
        return self

    def __exit__(self, *exc):
        from linearsfm_tpu_torch.ops import kernels
        kernels.gauge_congruence = self._saved
        return False

    def report(self, tag):
        """One line of what was held; fails unless calls were held at the
        root."""
        print(f"{tag}: every K5 call held against the plain transform in "
              f"situ (float64 within {K5_TOL['torch.float64']:g}, float32 "
              f"{K5_TOL['torch.float32']:g} of each field's largest "
              f"magnitude; worst so far {_K5InSitu.worst:.3e}): "
              f"{self.calls} calls, {self.root} on one lane ok", flush=True)
        if not self.root:
            raise AssertionError(f"{tag}: no K5 call held at the root")

    def time_calls(self, tag, reps=10):
        """The kept calls timed again (CUDA events around one call, the
        host's issue included; median of `reps` after one warm call), beside
        the byte bound (`kernels.gauge_congruence_bytes` over 3.35 TB/s) and
        the plain transform's time. Returns {where: times}."""
        import statistics
        import torch
        from linearsfm_tpu_torch import types
        from linearsfm_tpu_torch.ops import kernels, segment

        def timed(fn, n):
            ts = []
            for _ in range(n + 1):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                a.record()
                fn()
                b.record()
                b.synchronize()
                ts.append(a.elapsed_time(b))
            return statistics.median(ts[1:])
        out = {}
        for where, (lm, mono, new, info) in self.kept.items():
            P, M, N, KU, KW = (lm.poses.shape[0], lm.M, lm.N, lm.KU, lm.KW)
            esz = (types.as_dtype(info) or lm.U.dtype).itemsize
            bound = (kernels.gauge_congruence_bytes(P, M, N, KU, KW, mono,
                                                    esz)
                     / HBM_BYTES_PER_S * 1e3)
            with segment.deterministic():
                ms = timed(lambda: self._saved(lm, mono, new, info), reps)
                plain_ms = timed(lambda: self._refs[mono](lm, *new, info), 3)
            print(f"{tag} {where}: K5 (P, M, N, KU, KW) ({P}, {M}, {N}, "
                  f"{KU}, {KW}) {'mono' if mono else 'stereo'}: {ms:.4f} ms "
                  f"a call vs byte bound {bound:.4f} ms = {bound / ms:.1%}; "
                  f"plain transform {plain_ms:.3f} ms", flush=True)
            out[where] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                              bound_by="bytes", library_ms=None,
                              shape=[P, M, N, KU, KW])
        return out


# K5's times at the benchmark cells' level-1 and root calls, by cell
K5_TIMES = {}


def phase_k5():
    """Phase 5b, K5 in the benchmark's cells: the first set (seed 0) of
    `rs468_mono.covis` (direct mono) and of `nc3500_stereo.covis` through
    `DeviceTreeSolver` as the benchmark builds it, every K5 call held
    against the plain transform in situ (`_K5InSitu`), then K5's level-1
    and root calls timed alone (`_K5InSitu.time_calls`). Returns each
    solve's kernel launches."""
    from benchmark import gen
    from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
    launched = {}
    with open(os.path.join(HERE, "benchmark", "traffic", "covis.json")) as f:
        mix = json.load(f)
    for cell in ("rs468_mono", "nc3500_stereo"):
        with open(os.path.join(HERE, "benchmark", "configs",
                               f"{cell}.json")) as f:
            cfg = json.load(f)
        maps = gen.make_set(cfg, mix, 0, 0)
        solver = DeviceTreeSolver(cfg["datatype"], method=cfg["method"])
        with _K5InSitu() as k5:
            _, launched[f"k5 {cell}"], wall = _counted(
                lambda: solver.run(maps))
        k5.report(f"k5 {cell} ({wall:.2f} s held)")
        K5_TIMES[cell] = k5.time_calls(f"k5 {cell}")
        if launched[f"k5 {cell}"].get(K5, 0) != k5.calls:
            raise AssertionError(f"k5 {cell}: {k5.calls} calls held, "
                                 f"{launched[f'k5 {cell}'].get(K5)} counted")
        _require_launched(f"k5 {cell}", launched[f"k5 {cell}"])
        del k5, maps, solver
    return launched


def _k2_shapes(datasets):
    """The fused K2's (P, N, K) at level 1 and at the root of each path's
    plan (`core/plan.plan_tree_exact`): a level of `count` maps joins
    count // 2 lanes of N = 2 N_in features, whose W lists hold the
    transformed end map's KW_in + N_in (stereo) or KW_in + 2 N_in (mono,
    one more feature family) entries plus cur's KW_in."""
    out = {}
    for d, (_, _, tp) in datasets.items():
        levels = tp.levels
        per = 1 if d == "stereo" else 2
        for tag, lp in (("level1", levels[0]), ("root", levels[-1])):
            _, N_in, _, KW_in = lp.caps_in
            out[f"{d} {tag}"] = (lp.count // 2, 2 * N_in,
                                 2 * KW_in + per * N_in)
    return out


def _poses_by_id(lm):
    from linearsfm_tpu_torch import types
    h = types.host_fields(lm)
    return {int(i): h.poses[s] for s, i in enumerate(h.pose_ids) if i >= 0}


def phase_small_trees():
    import numpy as np
    from synth import generate as gen
    from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver

    for datatype, n in (("stereo", 13), ("mono", 11)):
        maps, _, _ = gen.make_dataset(n, datatype, noise=0.01, seed=5)
        # refine is the main path; direct runs K1 and K2 in float64
        for method in ("refine", "direct"):
            a = _poses_by_id(DeviceTreeSolver(datatype, method=method,
                                              device="cuda").run(maps))
            b = _poses_by_id(DeviceTreeSolver(datatype, method=method,
                                              device="cpu").run(maps))
            if set(a) != set(b):
                raise AssertionError(f"{n}-map {datatype} tree: GPU and CPU "
                                     f"pose ids differ")
            diff = max(float(np.abs(a[k] - b[k]).max()) for k in a)
            if not diff <= 1e-9:
                raise AssertionError(f"{n}-map {datatype} tree {method}: GPU "
                                     f"vs CPU pose diff {diff:.3e}")
            print(f"tree{n} {datatype} {method}: GPU vs CPU max pose diff "
                  f"{diff:.3e} (atol 1e-9) ok", flush=True)


def make_dataset(datatype):
    """The 2,048-map covis set (seed 7) and its tree plan
    (`core/plan.plan_tree_exact`, as `DeviceTreeSolver.run` plans it)."""
    from synth import generate as gen
    from linearsfm_tpu_torch.core import compact, plan
    from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver

    t0 = time.perf_counter()
    maps, poses_gt, _ = gen.make_dataset(2048, datatype, noise=0.005, seed=7,
                                         covis_radius=6.0, covis_max=6)
    s = DeviceTreeSolver(datatype, device="cuda")
    tp = plan.plan_tree_exact(
        plan.sym_of_stacked(compact.compact_stack(maps, s.bucket,
                                                  s.u_bucket)),
        datatype, s.bucket, s.u_bucket)
    print(f"main {datatype}: dataset 2048 maps and plan ({len(tp.levels)} "
          f"levels) in {time.perf_counter() - t0:.2f} s", flush=True)
    return maps, poses_gt, tp


def phase_main_path(datatype, maps, poses_gt, tp, shapes, n=2048,
                    oracle=None, tag=None, in_situ=False, hold_k3=False,
                    hold_k4=False, hold_k5=False):
    """One warm and one timed run of the `n`-map covis set (`tp`: its tree
    plan, or None); returns the kernel launch counts of the timed run, its
    poses by id and its maps_joined/s. Fails unless every pose id is there
    and finite, the ATE is within 1e-6 of `oracle` (default: the 2,048-map
    oracle's), every level's res_max is <= 1e-10, K1, K2 and K3 launched
    and the two runs' poses and features are `torch.equal` (the solver
    sums in a fixed order). Given `shapes`, the warm run's fused K2
    launches must have the shapes phase 4 timed at level 1 and the root.
    With `in_situ`, every K1 and K2 call of the warm run is held against
    its plain version on its own inputs (`_K1InSitu`, `_K2InSitu`), those
    of the root included; with `hold_k3`, every K3 call and plan of the
    warm run (`_K3InSitu`); with `hold_k4`, every K4 call of the warm run
    (`_K4InSitu`), and its root launch is timed alone into
    `K4_TIMES[tag]`; with `hold_k5`, every K5 call of the warm run
    (`_K5InSitu`). Given `tp`, it also prints the `utils/flops`
    model's f32 rate of the timed run (a model figure: the model's
    per-block constants are not calibrated on the GPU). The timed run's
    `common.pose_digest` goes to `DIGESTS[tag]`."""
    import numpy as np
    import torch
    from linearsfm_tpu_torch import types
    from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
    from linearsfm_tpu_torch.ops import kernels
    from linearsfm_tpu_torch.utils import flops
    from linearsfm_tpu_torch.utils.metrics import LevelMetrics

    tag = tag or f"main {datatype}"
    oracle = ORACLE_ATE_2048[datatype] if oracle is None else oracle
    # bench.py's call form: no device argument, the card by default
    solver = DeviceTreeSolver(datatype, method="refine")
    fused, seen = kernels.inv3x3_wy, []

    def record(V, W, Wpf):
        seen.append((V.shape[0], V.shape[1], W.shape[1]))
        return fused(V, W, Wpf)
    kernels.inv3x3_wy = record
    held = contextlib.ExitStack()
    t0 = time.perf_counter()
    try:
        with held:
            if in_situ:
                k1, k2 = (held.enter_context(_K1InSitu()),
                          held.enter_context(_K2InSitu()))
            if hold_k3:
                k3 = held.enter_context(_K3InSitu())
            if hold_k4:
                k4 = held.enter_context(_K4InSitu())
            if hold_k5:
                k5 = held.enter_context(_K5InSitu())
            warm = solver.run(maps)
    finally:
        kernels.inv3x3_wy = fused
    print(f"{tag}: warm run {time.perf_counter() - t0:.3f} s "
          f"{solver._last_timing}"
          f"{' (in-situ checks included)' * (in_situ or hold_k3)}; "
          f"fused K2 shapes (P, N, K) by level {seen}", flush=True)
    if hold_k3:
        k3.report(f"{tag} warm run")
    if hold_k4:
        k4.report(f"{tag} warm run")
        K4_TIMES[tag] = k4.time_root(f"{tag} warm run")
        del k4
    if hold_k5:
        k5.report(f"{tag} warm run")
        del k5
    if in_situ:
        _held_at_root(f"{tag} warm run", k1, k2)
        if k2.shapes != seen:
            raise AssertionError(f"{tag}: K2 held at {k2.shapes}, launched "
                                 f"at {seen}")
    if shapes is not None:
        want = [shapes[f"{datatype} level1"], shapes[f"{datatype} root"]]
        if not seen or [seen[0], seen[-1]] != want:
            raise AssertionError(f"{tag}: fused K2 ran at {seen}, phase 4 "
                                 f"timed {want}")

    torch.cuda.reset_peak_memory_stats()
    for k in kernels.launches:
        kernels.launches[k] = 0
    metrics = LevelMetrics()
    t0 = time.perf_counter()
    out = solver.run(maps, metrics=metrics, time_levels=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30

    if out.poses.device != torch.device("cuda", 0):
        raise AssertionError(f"{tag}: the root lies on {out.poses.device}")
    h = types.to_numpy(out)
    ids, poses = h.pose_ids, h.poses
    valid = ids >= 0
    # stereo: pose 0 is the frame itself; mono keeps it as an explicit block
    want_ids = set(range(1, n + 1)) if datatype == "stereo" else set(range(n + 2))
    if (sorted(int(i) for i in ids[valid]) != sorted(want_ids)
            or not np.isfinite(poses[valid]).all()):
        raise AssertionError(f"{tag}: {int(valid.sum())} valid poses (want "
                             f"{len(want_ids)} ids), finite="
                             f"{np.isfinite(poses[valid]).all()}")
    err = [float(np.linalg.norm(poses[s][:3] - poses_gt[int(i)][:3]))
           for s, i in enumerate(ids) if i >= 0]
    ate = float(np.sqrt(np.mean(np.square(err))))
    res = [r.get("res_max", float("nan")) for r in metrics.records]
    res_max = max(res)
    print(f"{tag}: timed run {wall:.4f} s = {(n - 1) / wall:.2f} "
          f"maps_joined/s, peak device memory {peak:.2f} GiB, host phases "
          f"{ {k: round(v, 4) for k, v in solver._last_timing.items()} }",
          flush=True)
    for r in metrics.records:
        print(f"{tag}: level {r['level']:2d} joins {r['n_joins']:4d} "
              f"join_m {r['join_m']:5d} exec_wall {r['exec_wall'] * 1e3:9.3f} ms "
              f"res_max {r.get('res_max', float('nan')):.3e}", flush=True)
    print(f"{tag}: ATE {ate:.9f} (oracle {oracle:.9f}, diff "
          f"{ate - oracle:+.3e}), res_max {res_max:.3e}, {len(err)} poses, "
          f"kernel launches {launched}", flush=True)
    if tp is not None:
        model = flops.mfu(tp, datatype, lambda m: (solver.top_iters
                                                   if m >= solver.top_min_m
                                                   else solver.refine_iters),
                          wall)
        print(f"{tag}: model figure (utils/flops, uncalibrated constants, "
              f"PCG sweeps at their caps): {model['f32_flops']:.4e} f32 FLOP "
              f"in {wall:.4f} s = {model['achieved_f32_tflops']:.4f} TFLOP/s "
              f"= {model['mfu_f32']:.4%} of the {flops.PEAK_F32 / 1e12:g} "
              f"TFLOP/s f32 peak; {model['f64_flops']:.4e} f64 FLOP, "
              f"{model['gbytes']:.3f} GB modelled traffic", flush=True)
    if not abs(ate - oracle) <= 1e-6:
        raise AssertionError(f"{tag}: ATE {ate} off the oracle's")
    if not res_max <= 1e-10:
        raise AssertionError(f"{tag}: res_max {res_max} > 1e-10")
    _require_launched(tag, launched)
    if launched.get(K4, 0) <= 0:
        raise AssertionError(f"{tag}: kernel {K4} was never launched")
    _repeats(f"{tag} warm and timed", warm, out)
    DIGESTS[tag] = pose_digest(out)
    return launched, _poses_by_id(out), (n - 1) / wall


def _pose_file_check(tag, path, datatype, n, poses_gt):
    """Ids and ATE of a pose file against the oracle's; returns the poses
    by id."""
    import numpy as np
    from linearsfm_tpu_torch.io import localmap as lio
    ids, poses = lio.read_poses(path)
    want = set(range(1, n + 1)) if datatype == "stereo" else set(range(n + 2))
    if sorted(ids.tolist()) != sorted(want) or not np.isfinite(poses).all():
        raise AssertionError(f"{tag}: pose file holds {len(ids)} ids "
                             f"(want {len(want)}), finite="
                             f"{np.isfinite(poses).all()}")
    err = np.linalg.norm(poses[:, :3] - poses_gt[ids, :3], axis=1)
    ate = float(np.sqrt(np.mean(np.square(err))))
    oracle = ORACLE_ATE_2048[datatype]
    print(f"{tag}: pose file ATE {ate:.9f} (oracle {oracle:.9f}, diff "
          f"{ate - oracle:+.3e}), {len(ids)} poses", flush=True)
    if not abs(ate - oracle) <= 1e-6:
        raise AssertionError(f"{tag}: ATE {ate} off the oracle's")
    return dict(zip(ids.tolist(), poses))


def _run_log(text):
    """What a pipeline run logged: reader, kernel launches, host phases."""
    import ast
    import re
    m = re.search(r"Read (\d+) local maps in ([0-9.]+) s \((\w+) parser\)",
                  text)
    k = re.search(r"Kernel launches: (\{.*\})", text)
    h = re.search(r"Solver host phases: (\{.*\})", text)
    w = re.search(r"Wrote the results in ([0-9.]+) s", text)
    p = re.search(r"Peak device memory: ([0-9.]+) GiB", text)
    if not (m and k and h and w and p):
        raise AssertionError(f"pipeline log lines missing:\n{text[-2000:]}")
    return dict(read_s=float(m.group(2)), parser=m.group(3),
                launches=ast.literal_eval(k.group(1)), phases=h.group(1),
                write_s=float(w.group(1)), peak_gib=float(p.group(1)))


def _cli_subprocess(tag, data, datatype, n, poses_gt, out_dir, run=0,
                    flags=()):
    """`python3 -m linearsfm_tpu_torch.cli` with the default flags (device
    executor, --method direct, on the GPU), `flags` and --check; its pose
    file is pose_cli_<datatype><run>.txt in out_dir."""
    typ = "Stereo" if datatype == "stereo" else "Monocular"
    pose = os.path.join(out_dir, f"pose_cli_{datatype}{run}.txt")
    cmd = [sys.executable, "-m", "linearsfm_tpu_torch.cli", "-path", data,
           "-num", str(n), "-type", typ, "-p", pose,
           "-f", os.path.join(out_dir, f"feat_cli_{datatype}.txt"),
           "-st", os.path.join(out_dir, f"state_cli_{datatype}.txt"),
           *flags, "--check"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                       timeout=600)
    wall = time.perf_counter() - t0
    if r.returncode != 0 or "LinearSFM Check: OK" not in r.stdout:
        raise AssertionError(f"{tag}: exit {r.returncode}\n{r.stdout[-2000:]}"
                             f"\n{r.stderr[-3000:]}")
    got = _run_log(r.stderr)
    solve = float(r.stdout.split("Total Used Time:")[1].split()[0])
    print(f"{tag}: exit 0, LinearSFM Check: OK; process wall {wall:.3f} s, "
          f"read {got['read_s']:.3f} s ({got['parser']} parser), solve "
          f"{solve:.3f} s, write {got['write_s']:.3f} s, peak device memory "
          f"{got['peak_gib']:.2f} GiB, host phases {got['phases']}, kernel "
          f"launches {got['launches']}", flush=True)
    if got["parser"] != "C":
        raise AssertionError(f"{tag}: the C parser was not used")
    return _pose_file_check(tag, pose, datatype, n, poses_gt), got


class _K1InSitu:
    """While active, every K1 call of the Schur assembly
    (`schur.densify_blocks`, `schur.densify_planned`) is held against the
    plain version on its own inputs, by the rule of phase 3 (`_k1_check`):
    the main path's own shapes and dtypes. Counts the calls by dtype and
    those on one lane (`root`: a tree's root join, whose outputs are [1,
    6M, w]), and keeps the largest error, the largest output and the first
    call's inputs (rows, cols, vals, M, N) as `first`."""

    def __enter__(self):
        from linearsfm_tpu_torch.ops import kernels, schur
        self.calls, self.max_err, self.largest = {}, 0.0, ()
        self.first, self.root = None, 0
        self._saved = schur.densify_blocks, schur.densify_planned
        blocks, planned = self._saved

        def held(got, rows, cols, vals, M, N):
            import torch
            if self.first is None:
                self.first = (rows, cols, vals, M, N)
            ref = kernels.blockcoo_to_dense_ref(rows, cols, vals, M, N)
            torch.cuda.synchronize()
            dn = str(vals.dtype).split(".")[-1]
            err = _k1_check(f"in situ {dn} {list(got.shape)}", got, ref,
                            _has_duplicates(rows, cols, M, N), quiet=True)
            self.calls[dn] = self.calls.get(dn, 0) + 1
            self.root += got.dim() == 3 and got.shape[0] == 1
            self.max_err = max(self.max_err, err)
            if got.numel() > math.prod(self.largest):
                self.largest = tuple(got.shape)
            return got

        def densify_blocks(rows, cols, vals, M, N):
            return held(blocks(rows, cols, vals, M, N), rows, cols, vals, M, N)

        def densify_planned(plan, vals, col_lo=0, width=None):
            w = plan.N - col_lo if width is None else width
            rows, cols = _masked_stripe(plan.rows, plan.cols, col_lo, w)
            return held(planned(plan, vals, col_lo, width), rows, cols, vals,
                        plan.M, w)
        schur.densify_blocks, schur.densify_planned = (densify_blocks,
                                                       densify_planned)
        return self

    def __exit__(self, *exc):
        from linearsfm_tpu_torch.ops import schur
        schur.densify_blocks, schur.densify_planned = self._saved
        return False

    def report(self, tag, want=None):
        """One line of what was held; fails if no call (or, given `want`,
        not that many float64 calls) was seen."""
        print(f"{tag}: every K1 call held against the plain version in situ "
              f"(exact, or rtol 1e-6 with duplicates): calls by dtype "
              f"{self.calls}, {self.root} on one lane, largest output "
              f"{list(self.largest)}, "
              f"max_abs_err {self.max_err:.3e} ok", flush=True)
        if not self.calls or (want is not None
                              and self.calls.get("float64") != want):
            raise AssertionError(f"{tag}: K1 calls held in situ "
                                 f"{self.calls}, want {want} float64")


def _warm_direct(datatype, maps, want_k1):
    """The CLI's solve in this warm process: `DeviceTreeSolver(datatype,
    method="direct")` once to warm up, with every K1 call held against the
    plain version in situ (`_K1InSitu`; `want_k1` float64 calls), then
    timed with per-level CUDA-event walls (the CLI subprocess pays CUDA and
    library start-up in its solve). The two runs' poses must be equal."""
    import torch
    from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
    from linearsfm_tpu_torch.utils.metrics import LevelMetrics
    tag = f"entry warm device direct {datatype}"
    solver = DeviceTreeSolver(datatype, method="direct", device="cuda")
    with _K1InSitu() as held:
        first = solver.run(maps)
    held.report(tag, want_k1)
    metrics = LevelMetrics()
    t0 = time.perf_counter()
    again = solver.run(maps, metrics=metrics, time_levels=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _repeats(tag, first, again)
    print(f"{tag}: solve {wall:.3f} s in process (warm), host phases "
          f"{ {k: round(v, 4) for k, v in solver._last_timing.items()} }, "
          f"level walls ms "
          f"{[round(r['exec_wall'] * 1e3, 1) for r in metrics.records]}",
          flush=True)


def _ckpt_resume(tag, make_solver, maps):
    """A full run with checkpoints, a resumed run from the newest one and
    one from an earlier level's, copied aside: poses within 1e-9."""
    import json
    import shutil
    import numpy as np
    from linearsfm_tpu_torch.ops import kernels
    from linearsfm_tpu_torch.utils.metrics import LevelMetrics

    poses = _poses_by_id
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tmp:
        ck, early = os.path.join(tmp, "ckpt"), os.path.join(tmp, "early")
        metrics = LevelMetrics()
        full = poses(make_solver().run(maps, ckpt_dir=ck, metrics=metrics))
        newest = poses(make_solver().run(maps, ckpt_dir=ck, resume=True))
        shutil.copytree(ck, early)
        level = 2
        count = next(r["n_maps"] for r in metrics.records
                     if r["level"] == level)
        if os.path.exists(os.path.join(early, "manifest.json")):
            man = ("manifest.json", dict(level=level, count=count))
        else:
            man = ("stacked_manifest.json", dict(level=level))
        with open(os.path.join(early, man[0]), "w") as fh:
            json.dump(man[1], fh)
        again = poses(make_solver().run(maps, ckpt_dir=early, resume=True))
        files = len(os.listdir(ck))
    diff = 0.0
    for name, run in (("newest", newest), (f"level {level}", again)):
        if set(run) != set(full):
            raise AssertionError(f"{tag}: resumed from {name}: pose ids "
                                 f"differ")
        diff = max(diff, max(float(np.abs(run[k] - full[k]).max())
                             for k in full))
    print(f"{tag}: full run ({len(metrics.records)} levels, {files} "
          f"checkpoint files), resumed from the newest and from level "
          f"{level}: max pose diff {diff:.3e} (atol 1e-9) ok", flush=True)
    if not diff <= 1e-9:
        raise AssertionError(f"{tag}: resumed poses differ by {diff}")


def phase_entry_points(datasets, tmp):
    """The reference-compatible entry point at 2,048 maps: text datasets
    written with the port's writer into `tmp` (tmp/stereo, tmp/mono; they
    stay for phase 10), the CLI as a subprocess (defaults: device executor,
    direct, GPU) for stereo and mono, the host executor in process through
    `cli.main` for stereo, and checkpoint/resume of both executors on the
    small trees. Returns the kernel launches of the stereo host run and of
    each CLI run, and the CLI runs' poses by id."""
    import contextlib
    import io
    import logging
    import re
    import numpy as np
    from synth import generate as gen
    from linearsfm_tpu_torch import cli, native
    from linearsfm_tpu_torch.core import pipeline
    from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
    from linearsfm_tpu_torch.core.tree import TreeSolver
    from linearsfm_tpu_torch.io import localmap as lio
    from linearsfm_tpu_torch.ops import kernels

    n = 2048
    t_phase = time.perf_counter()
    launched = {}
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    if native.get_fastparse() is None:
        raise AssertionError("entry: the C local-map parser did not build")
    print(f"entry: C local-map parser built (gcc) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    data = {}
    for d, (maps, _, _) in datasets.items():
        data[d] = os.path.join(tmp, d)
        os.makedirs(data[d])
        t0 = time.perf_counter()
        lio.write_dataset(maps, data[d])
        size = sum(os.path.getsize(os.path.join(data[d], f))
                   for f in os.listdir(data[d]))
        print(f"entry {d}: wrote {n} local maps ({size / 2**20:.1f} MiB) "
              f"with the port's writer in {time.perf_counter() - t0:.3f} "
              f"s", flush=True)
    cli_poses = {}
    for d in ("stereo", "mono"):
        cli_poses[d], got = _cli_subprocess(
            f"entry cli {d}", data[d], d, n, datasets[d][1], tmp)
        launched[f"cli {d}"] = got["launches"]
    # the device executor sums in a fixed order (ops/segment.deterministic):
    # a second process writes the same pose file, byte for byte
    _cli_subprocess("entry cli mono (again)", data["mono"], "mono", n,
                    datasets["mono"][1], tmp, run=1)
    same = [open(os.path.join(tmp, f"pose_cli_mono{r}.txt"), "rb").read()
            for r in (0, 1)]
    print(f"entry cli mono: two processes wrote "
          f"{'identical' if same[0] == same[1] else 'DIFFERENT'} pose "
          f"files ({len(same[0])} bytes)", flush=True)
    if same[0] != same[1]:
        raise AssertionError("entry cli mono: pose files differ between "
                             "two runs")
    for d in ("stereo", "mono"):
        _warm_direct(d, datasets[d][0], launched[f"cli {d}"][
            "blockcoo_to_dense"])

    # the host executor, in process, counts from 0
    tag = "entry host stereo"
    pose = os.path.join(tmp, "pose_host_stereo.txt")
    logs = io.StringIO()
    handler = logging.StreamHandler(logs)
    pkg_log = logging.getLogger("linearsfm_tpu_torch")
    pkg_log.addHandler(handler)
    pkg_log.setLevel(logging.INFO)
    out = io.StringIO()
    # the root the CLI's solver returns, for the repeat check below
    solved, run = [], TreeSolver.run

    def keep_root(self, *a, **k):
        solved.append(run(self, *a, **k))
        return solved[-1]
    for k in kernels.launches:
        kernels.launches[k] = 0
    TreeSolver.run = keep_root
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(["-path", data["stereo"], "-num", str(n),
                           "-type", "Stereo", "-p", pose, "--exec",
                           "host", "--check"])
    finally:
        pkg_log.removeHandler(handler)
        TreeSolver.run = run
    wall = time.perf_counter() - t0
    launched["host stereo"] = dict(kernels.launches)
    if rc != 0 or "LinearSFM Check: OK" not in out.getvalue():
        raise AssertionError(f"{tag}: exit {rc}\n{out.getvalue()[-2000:]}")
    got = _run_log(logs.getvalue())
    solve = float(out.getvalue().split("Total Used Time:")[1].split()[0])
    print(f"{tag}: exit 0, LinearSFM Check: OK; wall {wall:.3f} s, read "
          f"{got['read_s']:.3f} s ({got['parser']} parser), solve "
          f"{solve:.3f} s, write {got['write_s']:.3f} s, peak device "
          f"memory {got['peak_gib']:.2f} GiB, host phases of the last "
          f"level {got['phases']}, kernel launches "
          f"{launched['host stereo']}", flush=True)
    if got["parser"] != "C":
        raise AssertionError(f"{tag}: the C parser was not used")
    levels = re.findall(r"Level (\d+) done \(\d+ maps, ([0-9.]+)s\)",
                        logs.getvalue())
    print(f"{tag}: seconds from the tree's start to the end of each "
          f"level {[float(t) for _, t in levels]}", flush=True)
    host = _pose_file_check(tag, pose, "stereo", n, datasets["stereo"][1])
    diff = max(float(np.abs(host[k] - cli_poses["stereo"][k]).max())
               for k in host)
    print(f"{tag}: pose file vs the device executor's: max |diff| "
          f"{diff:.3e} (limit 2e-6)", flush=True)
    if not diff <= 2e-6:
        raise AssertionError(f"{tag}: pose files differ by {diff}")
    # the host executor once more on the maps the CLI read, its K1 calls
    # held in situ
    text_maps = pipeline.load_local_maps(data["stereo"], n, "stereo")
    t0 = time.perf_counter()
    with _K1InSitu() as held:
        again = TreeSolver("stereo", device="cuda").run(text_maps)
    held.report(f"{tag} (again, {time.perf_counter() - t0:.1f} s)",
                launched["host stereo"]["blockcoo_to_dense"])
    if len(solved) != 1:
        raise AssertionError(f"{tag}: the CLI solved {len(solved)} times")
    _repeats(f"{tag}, the CLI's solve and again", solved[0], again)
    for path, counts in launched.items():
        _require_launched(f"entry {path}", counts)

    for datatype, m in (("stereo", 13), ("mono", 11)):
        maps, _, _ = gen.make_dataset(m, datatype, noise=0.01, seed=5)
        for name, make in (
                ("device", lambda: DeviceTreeSolver(datatype, device="cuda")),
                ("host", lambda: TreeSolver(datatype, device="cuda"))):
            _ckpt_resume(f"entry ckpt {m}-map {datatype} {name}", make, maps)
    print(f"entry points: phase {time.perf_counter() - t_phase:.2f} s",
          flush=True)
    return launched, cli_poses


class _K2InSitu:
    """While active, every fused K2 call (`schur.inv3x3_wy`) is held against
    its plain version on its own inputs: both outputs `torch.equal` (NaN
    where the plain version has NaN). Counts the calls and those on one
    lane (`root`: V [1, N, 3, 3], a tree's root join); `shapes` lists each
    call's (P, N, K)."""

    def __enter__(self):
        from linearsfm_tpu_torch.ops import kernels, schur
        self.calls, self.root, self.shapes = 0, 0, []
        self._saved = schur.inv3x3_wy
        fused = self._saved

        def held(V, W, Wpf):
            import torch
            got = fused(V, W, Wpf)
            ref = kernels.inv3x3_wy_ref(V.contiguous(), W.contiguous(),
                                        Wpf.contiguous())
            torch.cuda.synchronize()
            for what, a, b in zip(("Vinv", "Y"), got, ref):
                if a.shape != b.shape or not _exact(a, b):
                    raise AssertionError(f"K2 in situ {list(V.shape)} "
                                         f"{list(W.shape)}: {what} kernel != "
                                         f"plain")
            self.calls += 1
            self.root += V.shape[0] == 1
            self.shapes.append((V.shape[0], V.shape[1], W.shape[1]))
            return got
        schur.inv3x3_wy = held
        return self

    def __exit__(self, *exc):
        from linearsfm_tpu_torch.ops import schur
        schur.inv3x3_wy = self._saved
        return False


def _held_at_root(tag, k1, k2):
    """Reports what `_K1InSitu` k1 and `_K2InSitu` k2 held; fails unless
    both held calls at the root (on one lane)."""
    k1.report(tag)
    print(f"{tag}: every fused K2 call held against the plain version in "
          f"situ (torch.equal, both outputs): {k2.calls} calls, {k2.root} on "
          f"one lane, (P, N, K) of the last {k2.shapes[-1:]} ok", flush=True)
    if not k1.root or not k2.root:
        raise AssertionError(f"{tag}: calls held at the root: K1 {k1.root}, "
                             f"K2 {k2.root}")


def _ate_of(poses, poses_gt):
    import numpy as np
    err = [float(np.linalg.norm(p[:3] - poses_gt[i][:3]))
           for i, p in poses.items()]
    return float(np.sqrt(np.mean(np.square(err))))


def _max_diff(tag, a, b):
    import numpy as np
    if set(a) != set(b):
        raise AssertionError(f"{tag}: pose ids differ")
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


def _mesh_main_path(datatype, maps, poses_gt, levels, mesh, single):
    """The main path's set through `DeviceTreeSolver(datatype,
    method="refine", mesh=mesh)`: the level modes, a warm run with every K1
    and K2 call of the tp level held in situ, then a timed run (counts from
    0) against the oracle's ATE and the single-device run's poses
    (`single`), and equal to the warm run. Returns the timed run's
    launches."""
    import torch
    from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
    from linearsfm_tpu_torch.ops import kernels
    from linearsfm_tpu_torch.utils.metrics import LevelMetrics

    n, tag = 2048, f"mesh {datatype}"
    oracle = ORACLE_ATE_2048[datatype]
    solver = DeviceTreeSolver(datatype, method="refine", mesh=mesh,
                              device="cuda")
    modes = [solver._level_mode(lp, solver._level_cfg(lp)) for lp in levels]
    print(f"{tag}: {mesh}, level modes {modes}", flush=True)
    if "dp" not in modes or modes[-1] != "tp":
        raise AssertionError(f"{tag}: want dp levels and a tp root, got "
                             f"{modes}")
    tp_level = solver._level_tp
    held = {}

    def tp_in_situ(*a):
        with _K1InSitu() as k1, _K2InSitu() as k2:
            out = tp_level(*a)
        held.update(k1=k1, k2=k2)
        return out
    solver._level_tp = tp_in_situ
    t0 = time.perf_counter()
    try:
        warm = solver.run(maps)
    finally:
        del solver._level_tp
    print(f"{tag}: warm run {time.perf_counter() - t0:.3f} s", flush=True)
    held["k1"].report(f"{tag} tp level")
    print(f"{tag} tp level: every fused K2 call held against the plain "
          f"version in situ (torch.equal, both outputs): {held['k2'].calls} "
          f"calls ok", flush=True)
    if held["k2"].calls != mesh.size:
        raise AssertionError(f"{tag}: {held['k2'].calls} K2 calls at the tp "
                             f"level, want one per shard")

    torch.cuda.reset_peak_memory_stats()
    for k in kernels.launches:
        kernels.launches[k] = 0
    metrics = LevelMetrics()
    t0 = time.perf_counter()
    out = solver.run(maps, metrics=metrics, time_levels=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    poses = _poses_by_id(out)
    ate = _ate_of(poses, poses_gt)
    diff = _max_diff(tag, poses, single)
    res_max = max(r.get("res_max", float("nan")) for r in metrics.records)
    print(f"{tag}: timed run {wall:.4f} s = {(n - 1) / wall:.2f} "
          f"maps_joined/s, peak device memory {peak:.2f} GiB, host phases "
          f"{ {k: round(v, 4) for k, v in solver._last_timing.items()} }",
          flush=True)
    for r, mode in zip(metrics.records, modes):
        print(f"{tag}: level {r['level']:2d} {mode:4s} joins "
              f"{r['n_joins']:4d} join_m {r['join_m']:5d} exec_wall "
              f"{r['exec_wall'] * 1e3:9.3f} ms res_max "
              f"{r.get('res_max', float('nan')):.3e}", flush=True)
    limit = 1e-8 if datatype == "stereo" else 1e-6
    print(f"{tag}: ATE {ate:.9f} (oracle {oracle:.9f}, diff "
          f"{ate - oracle:+.3e}), res_max {res_max:.3e}, pose max |diff| vs "
          f"the single-device run {diff:.3e} (limit {limit:g}), kernel "
          f"launches {launched}", flush=True)
    if not abs(ate - oracle) <= 1e-6:
        raise AssertionError(f"{tag}: ATE {ate} off the oracle's")
    if not res_max <= 1e-10:
        raise AssertionError(f"{tag}: res_max {res_max} > 1e-10")
    if not diff <= limit:
        raise AssertionError(f"{tag}: poses differ from the single-device "
                             f"run by {diff}")
    _require_launched(tag, launched)
    if launched.get(K4, 0) <= 0:
        raise AssertionError(f"{tag}: kernel {K4} was never launched")
    _repeats(f"{tag} warm and timed", warm, out)
    return launched


def _multihost(maps, poses_gt):
    """Multi-host on the stereo set, direct: 4 hosts simulated in this
    process (the gather stubbed with every host's contribution), then two
    real processes of the port's worker on this card over gloo; both
    against the single-process direct device solve. Returns the simulated
    run's launches."""
    import gc
    import socket
    import numpy as np
    import torch
    from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
    from linearsfm_tpu_torch.ops import kernels
    from linearsfm_tpu_torch.parallel import multihost as MH

    oracle = ORACLE_ATE_2048["stereo"]
    kw = dict(method="direct", device="cuda")
    t0 = time.perf_counter()
    single = _poses_by_id(DeviceTreeSolver("stereo", **kw).run(maps))
    print(f"multihost: single-process direct solve {time.perf_counter() - t0:.3f} "
          f"s, ATE {_ate_of(single, poses_gt):.9f}", flush=True)

    def check(tag, poses):
        ate, diff = _ate_of(poses, poses_gt), _max_diff(tag, poses, single)
        print(f"{tag}: ATE {ate:.9f} (oracle {oracle:.9f}, diff "
              f"{ate - oracle:+.3e}), pose max |diff| vs the single-process "
              f"solve {diff:.3e} (limit 1e-8)", flush=True)
        if not abs(ate - oracle) <= 1e-6 or not diff <= 1e-8:
            raise AssertionError(f"{tag}: ATE {ate}, pose diff {diff}")

    def simulated():
        stacks = [MH.local_stacked(maps, "stereo", 4, h, kw)
                  for h in range(4)]
        t1 = time.perf_counter()
        root = MH.run_multihost(maps, "stereo", n_hosts=4, host_id=0,
                                gather=lambda _mine: stacks, solver_kw=kw)
        return root, time.perf_counter() - t1

    for k in kernels.launches:
        kernels.launches[k] = 0
    t0 = time.perf_counter()
    first, top = simulated()
    launched = dict(kernels.launches)
    sim = _poses_by_id(first)
    L, block, owners = MH.plan_chunks(len(maps), 4)
    print(f"multihost simulated: 4 hosts, blocks of {block} maps, owners "
          f"{owners}; local phases {time.perf_counter() - t0 - top:.3f} s, "
          f"gather and top {top:.3f} s; kernel launches {launched}",
          flush=True)
    check("multihost simulated", sim)
    _require_launched("multihost", launched)
    _repeats("multihost simulated, local phases and top", first,
             simulated()[0])
    del first

    # the workers share the card: hand back this process's cached blocks
    gc.collect()
    torch.cuda.empty_cache()
    print(f"multihost: this process keeps "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB of the card while "
          f"the workers run", flush=True)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tmp:
        cmd = [sys.executable, "-m", "linearsfm_tpu_torch.tools.multihost_worker",
               f"127.0.0.1:{port}", "2", "RANK", tmp, "--device", "cuda:0",
               "--maps", "2048", "--seed", "7", "--noise", "0.005",
               "--covis-radius", "6.0", "--covis-max", "6"]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([str(r) if a == "RANK" else a for a in cmd],
                                  cwd=HERE, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        try:
            outs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        for r, p in enumerate(procs):
            if p.returncode != 0:
                raise AssertionError(f"multihost rank {r}: exit "
                                     f"{p.returncode}\n{outs[r][-3000:]}")
        print(f"multihost two processes (gloo, both on cuda:0): exit 0 and "
              f"0 in {wall:.3f} s", flush=True)
        ranks = [np.load(os.path.join(tmp, f"result_{r}.npz"))
                 for r in range(2)]
        # each rank runs the top levels itself, from the same gathered roots
        same = all(np.array_equal(ranks[0][k], ranks[1][k])
                   for k in ("ids", "poses"))
        print(f"multihost two processes: the ranks' pose ids and poses "
              f"equal {same}", flush=True)
        if not same:
            raise AssertionError("multihost: the two ranks' roots differ")
        for r, f in enumerate(ranks):
            got = {int(i): p for i, p in zip(f["ids"], f["poses"])}
            check(f"multihost rank {r}", got)
            d = _max_diff(f"multihost rank {r}", got, sim)
            print(f"multihost rank {r}: pose max |diff| vs the simulated "
                  f"4-host run {d:.3e} (limit 1e-8)", flush=True)
            if not d <= 1e-8:
                raise AssertionError(f"multihost rank {r}: {d} from the "
                                     f"simulated run")
    return launched


def _host_mesh():
    """The host executor with a pairs mesh and an fs root mesh (cuda:0 four
    times each; root joins of at least 32 poses sharded) on a 64-map stereo
    tree, against the same executor without meshes."""
    from synth import generate as gen
    from linearsfm_tpu_torch.core.tree import TreeSolver
    from linearsfm_tpu_torch.ops import kernels
    from linearsfm_tpu_torch.parallel import shard_solve
    from linearsfm_tpu_torch.parallel.mesh import Mesh

    maps, _, _ = gen.make_dataset(64, "stereo", noise=0.01, seed=5)
    plain = _poses_by_id(TreeSolver("stereo", device="cuda").run(maps))
    sharded, fn = [], shard_solve.sharded_schur_solve

    def count(*a, **k):
        sharded.append(a[7])
        return fn(*a, **k)
    def meshes():
        return TreeSolver(
            "stereo", device="cuda", mesh=Mesh(("cuda:0",) * 4, "pairs"),
            root_mesh=Mesh(("cuda:0",) * 4, "fs"), root_shard_min=32,
        ).run(maps)
    for k in kernels.launches:
        kernels.launches[k] = 0
    shard_solve.sharded_schur_solve = count
    t0 = time.perf_counter()
    try:
        root = meshes()
    finally:
        shard_solve.sharded_schur_solve = fn
    got = _poses_by_id(root)
    diff = _max_diff("host mesh", got, plain)
    print(f"host mesh: 64-map stereo tree, host executor over a 4-shard "
          f"pairs mesh and fs root mesh in {time.perf_counter() - t0:.3f} s "
          f"(feature-sharded root joins at M {sharded}), kernel launches "
          f"{dict(kernels.launches)}; pose max |diff| vs no mesh "
          f"{diff:.3e} (limit 1e-9)", flush=True)
    if not sharded or not diff <= 1e-9:
        raise AssertionError(f"host mesh: sharded joins {sharded}, diff "
                             f"{diff}")
    _repeats("host mesh", root, meshes())


def phase_mesh(datasets, single):
    """Phase 9: the mesh paths on this card, a 4-shard mesh of cuda:0
    (`single`: phase 6-7's poses by id). Returns the launches of each
    path."""
    from linearsfm_tpu_torch.parallel.mesh import Mesh
    t_phase = time.perf_counter()
    mesh = Mesh(("cuda:0",) * 4, "pairs")
    launched = {}
    for d in ("stereo", "mono"):
        maps, gt, tp = datasets[d]
        launched[f"mesh {d}"] = _mesh_main_path(d, maps, gt, tp.levels, mesh,
                                                single[d])
    launched["multihost"] = _multihost(*datasets["stereo"][:2])
    _host_mesh()
    print(f"mesh: phase {time.perf_counter() - t_phase:.2f} s", flush=True)
    return launched


def _dense_main_path(datatype, maps, poses_gt, single, **solver_kw):
    """The 2,048-map set through `DenseTreeSolver(datatype, method="refine",
    device="cuda", **solver_kw)`: a warm run with every K2 call and the
    level-0 K1 calls held against their plain versions in situ, then a
    timed run (counts from 0). Fails unless every pose id is there and
    finite, K1 and K2 launched and K3 did not; prints the ATE beside the
    oracle's and the poses' max |diff| from phases 6-7's (`single`).
    Returns the timed run's launches and the root's caps (M, N); the timed
    run's `common.pose_digest` goes to `DIGESTS[tag]`."""
    import numpy as np
    import torch
    from linearsfm_tpu_torch.core.dense_tree import DenseTreeSolver
    from linearsfm_tpu_torch.ops import kernels
    from linearsfm_tpu_torch.utils.metrics import LevelMetrics

    n, tag = 2048, f"dense {datatype}"
    oracle = ORACLE_ATE_2048[datatype]
    solver = DenseTreeSolver(datatype, method="refine", device="cuda",
                             **solver_kw)
    print(f"{tag}: DenseTreeSolver(method='refine', mixed_max_m="
          f"{solver.mixed_max_m})", flush=True)
    t0 = time.perf_counter()
    with _K1InSitu() as k1, _K2InSitu() as k2:
        solver.run(maps)
    nlev = len(solver._prep[0].levels)
    print(f"{tag}: warm run {time.perf_counter() - t0:.3f} s (in-situ "
          f"checks included), {nlev} levels", flush=True)
    k1.report(f"{tag} level 0")
    print(f"{tag}: every fused K2 call held against the plain version in "
          f"situ (torch.equal, both outputs): {k2.calls} calls ok",
          flush=True)
    if k1.calls.get("float32", 0) + k1.calls.get("float64", 0) != 3:
        raise AssertionError(f"{tag}: K1 calls {k1.calls}, want 3")
    if k2.calls != nlev:
        raise AssertionError(f"{tag}: {k2.calls} K2 calls, want one per "
                             f"level ({nlev})")
    # level 0's first K1 call (A from the U lists of every map) timed alone
    rows, cols, vals, M, N = k1.first
    shape = [vals.shape[0], 6 * M, vals.shape[-1] * N]
    _k1_time(f"{tag} level 0 A {shape} {str(vals.dtype).split('.')[-1]}",
             *_k1_list_fns(rows, cols, vals, M, N))
    del rows, cols, vals, k1

    torch.cuda.reset_peak_memory_stats()
    for k in kernels.launches:
        kernels.launches[k] = 0
    metrics = LevelMetrics()
    t0 = time.perf_counter()
    out = solver.run(maps, metrics=metrics, time_levels=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ids, poses = out.pose_ids, out.poses
    valid = ids >= 0
    want_ids = (set(range(1, n + 1)) if datatype == "stereo"
                else set(range(n + 2)))
    if (sorted(int(i) for i in ids[valid]) != sorted(want_ids)
            or not np.isfinite(poses[valid]).all()):
        raise AssertionError(f"{tag}: {int(valid.sum())} valid poses (want "
                             f"{len(want_ids)} ids), finite="
                             f"{np.isfinite(poses[valid]).all()}")
    got = _poses_by_id(out)
    ate, diff = _ate_of(got, poses_gt), _max_diff(tag, got, single)
    print(f"{tag}: timed run {wall:.4f} s = {(n - 1) / wall:.2f} "
          f"maps_joined/s, peak device memory {peak:.2f} GiB, host phases "
          f"{ {k: round(v, 4) for k, v in solver._last_timing.items()} }",
          flush=True)
    plan = solver._prep[0]
    for r, lp in zip(metrics.records, plan.levels):
        idt, meth = solver._policy(2 * lp.caps_in[0])
        print(f"{tag}: level {r['level']:2d} joins {r['n_joins']:4d} caps "
              f"in {lp.caps_in} out {lp.caps_out} "
              f"{str(idt).split('.')[-1]}/{meth} exec_wall "
              f"{r['exec_wall'] * 1e3:9.3f} ms", flush=True)
    print(f"{tag}: ATE {ate:.9f} (oracle {oracle:.9f}, diff "
          f"{ate - oracle:+.3e}), pose max |diff| vs the device executor's "
          f"main path {diff:.3e}, {len(got)} poses, kernel launches "
          f"{launched}", flush=True)
    _require_launched(tag, launched, dense=True)
    DIGESTS[tag] = pose_digest(out)
    return launched, plan.levels[-1].caps_out


def _dense_k2_cost(M, N):
    """K2 at a dense root's shape, float32 (the refine path's): the fused
    launch (V^-1 and Yd = Wd V^-1 of the dense W read as a list of M*N
    entries, `ops/dense.entry_pairs`) against the inverse alone plus
    `torch.einsum` (the JAX package's form) and the plain version
    (`inv3x3_wy_ref`), by device time (median of 10, L2 flushed), beside
    the fused launch's bound."""
    import torch
    from linearsfm_tpu_torch.ops import dense, kernels
    from linearsfm_tpu_torch.utils.flops import PEAK_F32
    g = torch.Generator(device="cuda").manual_seed(47)
    B = torch.randn((1, N, 3, 3), generator=g, device="cuda")
    V = B @ B.mT + 0.1 * torch.eye(3, device="cuda")
    Wd = torch.randn((1, M, N, 6, 3), generator=g, device="cuda")
    W = Wd.view(1, M * N, 6, 3)
    Wpf = dense.entry_pairs(1, M, N, torch.device("cuda"))
    t = _device_ms({
        "fused": lambda: kernels.inv3x3_wy(V, W, Wpf),
        "einsum": lambda: torch.einsum("pmnif,pnfg->pmnig", Wd,
                                       kernels.inv3x3_sym(V)),
        "plain": lambda: kernels.inv3x3_wy_ref(V, W, Wpf)})
    bound, by = _k2_bound_ms(1, N, M * N, 4, PEAK_F32)
    print(f"dense K2 at the stereo root (M {M}, N {N}, K {M * N}) float32: "
          f"fused {t['fused']:.4f} ms, bound {bound:.4f} ms ({by}) = "
          f"{bound / t['fused']:.1%}; inverse alone (K = 0) + torch.einsum "
          f"{t['einsum']:.4f} ms; plain (inv3x3_wy_ref) {t['plain']:.4f} ms; "
          f"the pair list {Wpf.numel() * 8 / 2**20:.1f} MiB (device time, "
          f"median of 10 calls, L2 flushed)", flush=True)
    del V, Wd, W, B


def phase_dense(datasets, single, text_dir, cli_poses):
    """Phase 10: the dense planned executor (`core/dense_tree.py`) — both
    2,048-map sets in process (`_dense_main_path`; `single`: phase 6-7's
    poses), then `python3 -m linearsfm_tpu_torch.cli ... --exec dense
    --check` on phase 8's stereo text set (direct, the CLI's default): exit
    0, `LinearSFM Check: OK`, the pose file's ATE within 1e-6 of the
    oracle's and its poses within 2e-6 of the device executor's CLI pose
    file (`cli_poses`). Returns the launches of each path."""
    import gc
    import numpy as np
    import torch
    t_phase = time.perf_counter()
    launched = {}
    # stereo: the bench's BENCH_EXEC=dense configuration (f32 information
    # at the levels of at most 32 joined poses); mono with f64 information
    # at every level, as the device executor runs it: with the f32 levels
    # the mono set's Schur matrices turn indefinite in the f32 factor and
    # the poses NaN, in the JAX package too (PERF.md)
    caps = {}
    for d, kw in (("stereo", {}), ("mono", dict(mixed_max_m=0))):
        maps, gt, _ = datasets[d]
        launched[f"dense {d}"], caps[d] = _dense_main_path(
            d, maps, gt, single[d], **kw)
    _dense_k2_cost(*caps["stereo"])
    # the CLI process needs the card's memory this process has cached
    gc.collect()
    torch.cuda.empty_cache()
    poses, got = _cli_subprocess(
        "dense cli stereo", os.path.join(text_dir, "stereo"), "stereo", 2048,
        datasets["stereo"][1], text_dir, run="_dense",
        flags=("--exec", "dense"))
    launched["CLI dense stereo"] = got["launches"]
    diff = max(float(np.abs(poses[k] - cli_poses["stereo"][k]).max())
               for k in poses)
    print(f"dense cli stereo: pose file vs the device executor's: max "
          f"|diff| {diff:.3e} (limit 2e-6)", flush=True)
    if not diff <= 2e-6:
        raise AssertionError(f"dense cli stereo: pose files differ by {diff}")
    for path, counts in launched.items():
        _require_launched(path, counts, dense=True)
    print(f"dense: phase {time.perf_counter() - t_phase:.2f} s", flush=True)
    return launched


def _captured(fn, *args, **kw):
    """(fn's result, what it printed): its standard output is captured and
    then printed as it was."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    print(buf.getvalue(), end="", flush=True)
    return out, buf.getvalue()


def _labelled(tag, text, labels):
    missing = [lb for lb in labels if lb not in text]
    if missing:
        raise AssertionError(f"{tag}: labelled lines missing {missing}")


def _compare_ate_512(datatype, tmp):
    """`compare_ate` (through its `main`) on the 512-map covis set, seed 7,
    device executor, refine, against the oracle binary run live on the same
    files: the oracle must run, every pose id be there and finite, the
    port's ATE be within 1e-6 of the oracle's from this run and the pose
    files within 1e-5. Then the port's side runs again (`--phase port` on
    the same files) with every K1 and K2 call held against its plain
    version in situ, those at the root included, and must pass the same
    checks. Returns the first pipeline run's kernel launches and the
    oracle's result: its ATE and its poses by id (from its pose file)."""
    import numpy as np
    from linearsfm_tpu_torch.io import localmap as lio
    from linearsfm_tpu_torch.ops import kernels
    from linearsfm_tpu_torch.tools import compare_ate

    n, tag = 512, f"tools compare_ate {datatype}"
    d, rec_path = os.path.join(tmp, datatype), os.path.join(tmp,
                                                           f"{datatype}.json")
    for k in kernels.launches:
        kernels.launches[k] = 0
    t0 = time.perf_counter()
    rc, text = _captured(compare_ate.main, [
        "--num", str(n), "--type", datatype, "--covis", "--seed", "7",
        "--noise", "0.005", "--exec", "device", "--method", "refine",
        "--dir", d, "--json", rec_path])
    launched = dict(kernels.launches)
    if rc != 0:
        raise AssertionError(f"{tag}: exit {rc}")
    _labelled(tag, text, ("oracle wall:", "port wall:", "pose diff vs oracle:",
                          "ATE vs gt: oracle"))
    with open(rec_path) as fh:
        rec = json.load(fh)
    ids, poses = lio.read_poses(os.path.join(d, "pose_port.txt"))
    want = set(range(1, n + 1)) if datatype == "stereo" else set(range(n + 2))
    diff = rec["ate_port"] - rec["ate_oracle"]
    print(f"{tag}: {n} covis maps, oracle wall {rec['oracle_wall_s']:.3f} s, "
          f"port wall {rec['port_wall_s']:.3f} s (pipeline solve, cold "
          f"solver), ATE oracle {rec['ate_oracle']:.12f} port "
          f"{rec['ate_port']:.12f} (diff {diff:+.3e}, limit 1e-6), pose "
          f"max |diff| {rec['pose_diff_max']:.3e} (limit 1e-5) rms "
          f"{rec['pose_diff_rms']:.3e}, {len(ids)} poses, kernel launches "
          f"{launched}; tool wall {time.perf_counter() - t0:.2f} s",
          flush=True)
    if (sorted(ids.tolist()) != sorted(want) or not np.isfinite(poses).all()
            or rec["nonfinite_oracle"]):
        raise AssertionError(f"{tag}: {len(ids)} pose ids (want "
                             f"{len(want)}), non-finite port "
                             f"{rec['nonfinite_port']}, oracle "
                             f"{rec['nonfinite_oracle']}")
    if not abs(diff) <= 1e-6:
        raise AssertionError(f"{tag}: ATE {rec['ate_port']} off the "
                             f"oracle's {rec['ate_oracle']}")
    if not rec["pose_diff_max"] <= 1e-5:
        raise AssertionError(f"{tag}: poses differ from the oracle's by "
                             f"{rec['pose_diff_max']}")
    ids_r, pr = lio.read_poses(os.path.join(d, "pose_ref.txt"))
    oracle = dict(ate=rec["ate_oracle"],
                  poses={int(i): p for i, p in zip(ids_r, pr)})
    with _K1InSitu() as k1, _K2InSitu() as k2:
        rc, _ = _captured(compare_ate.main, [
            "--num", str(n), "--type", datatype, "--covis", "--exec",
            "device", "--method", "refine", "--dir", d, "--json", rec_path,
            "--phase", "port"])
    if rc != 0:
        raise AssertionError(f"{tag} in situ: exit {rc}")
    _held_at_root(f"{tag} in situ", k1, k2)
    with open(rec_path) as fh:
        rec = json.load(fh)
    if not (abs(rec["ate_port"] - rec["ate_oracle"]) <= 1e-6
            and rec["pose_diff_max"] <= 1e-5 and not rec["nonfinite_port"]):
        raise AssertionError(f"{tag} in situ: ATE {rec['ate_port']} (oracle "
                             f"{rec['ate_oracle']}), pose max |diff| "
                             f"{rec['pose_diff_max']}, non-finite "
                             f"{rec['nonfinite_port']}")
    return launched, oracle


def phase_tools(datasets):
    """Phase 11, the tools and scale: (a) `compare_ate` against the live
    oracle at 512 covis maps, stereo and mono; (b) the stereo 3,499-map
    covis set (`ate_3499_covis.json`) through the main path's checks; (c)
    the profiling tools on the main path's 2,048-map sets: `level_parts`
    at every level of both, `profile_device_tree.profile` and
    `bench_root.root_parts` on stereo (K1 and K2 counted around it),
    `microbench` and `profile_tree` (512 stereo maps) through their
    `main`. The K1 and K2 calls of (a), (b) and `bench_root`'s root
    assembly are held against their plain versions in situ, those at the
    root included. Returns the launches of each path and the live
    oracle's result on each 512-map set (`_compare_ate_512`)."""
    import torch
    from synth import generate as gen
    from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
    from linearsfm_tpu_torch.ops import kernels
    from linearsfm_tpu_torch.tools import (bench_root, microbench,
                                           profile_device_tree,
                                           profile_level_parts, profile_tree)

    t_phase = time.perf_counter()
    launched, oracle = {}, {}
    # (a) the live oracle
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tmp:
        for d in ("stereo", "mono"):
            launched[f"compare_ate {d} 512"], oracle[d] = _compare_ate_512(
                d, tmp)
    t_a = time.perf_counter()

    # (b) stereo 3,499
    t0 = time.perf_counter()
    maps, gt, _ = gen.make_dataset(3499, "stereo", noise=0.005, seed=7,
                                   covis_radius=6.0, covis_max=6)
    print(f"scale stereo 3499: dataset in {time.perf_counter() - t0:.2f} s",
          flush=True)
    launched["stereo 3499"], _, _ = phase_main_path(
        "stereo", maps, gt, None, None, n=3499, oracle=ORACLE_ATE_3499,
        tag="scale stereo 3499", in_situ=True, hold_k4=True, hold_k5=True)
    del maps, gt
    t_b = time.perf_counter()

    # (c) the profiling tools on the main path's sets
    for d, (maps, _, _) in datasets.items():
        solver = DeviceTreeSolver(d, method="refine", device="cuda")
        t0 = time.perf_counter()
        parts = profile_level_parts.level_parts(solver, maps)
        if sorted(parts) != list(range(1, len(parts) + 1)):
            raise AssertionError(f"tools level_parts {d}: levels "
                                 f"{sorted(parts)}")
        for li, rec in parts.items():
            print(f"tools level_parts {d} L{li:2d} count {rec['count']:4d} "
                  f"in {rec['caps_in']} out {rec['caps_out']}: T "
                  f"{rec['T']:.3f} ms, TJ {rec['TJ']:.3f} ms, full "
                  f"{rec['full']:.3f} ms", flush=True)
        print(f"tools level_parts {d}: totals T "
              f"{sum(r['T'] for r in parts.values()):.3f} ms, TJ "
              f"{sum(r['TJ'] for r in parts.values()):.3f} ms, full "
              f"{sum(r['full'] for r in parts.values()):.3f} ms "
              f"({time.perf_counter() - t0:.2f} s)", flush=True)
        del parts, solver
    maps = datasets["stereo"][0]
    _, text = _captured(profile_device_tree.profile,
                        DeviceTreeSolver("stereo", method="refine",
                                         device="cuda"), maps)
    _labelled("tools profile_device_tree", text,
              ("cold:", "warm:", "warm2:", "timing=", "L 1 count=",
               "L11 count="))
    for k in kernels.launches:
        kernels.launches[k] = 0
    got, text = _captured(bench_root.root_parts,
                          DeviceTreeSolver("stereo", method="refine",
                                           device="cuda"), maps)
    launched["bench_root stereo"] = dict(kernels.launches)
    # the root's assembly once more, every K1 and K2 call held in situ,
    # against the system bench_root assembled
    with _K1InSitu() as k1, _K2InSitu() as k2:
        S, E = bench_root.assemble(got["joined"])
    _held_at_root("tools bench_root assembly", k1, k2)
    err = max(float((S - got["S"]).abs().max() / got["S"].abs().max()),
              float((E - got["E"]).abs().max() / got["E"].abs().max()))
    print(f"tools bench_root: the held assembly's (S, E) vs the timed "
          f"one's: max |diff| / max |value| {err:.3e} (limit 1e-12)",
          flush=True)
    if not err <= 1e-12:
        raise AssertionError(f"tools bench_root: held assembly differs by "
                             f"{err}")
    del got, S, E, k1, k2
    torch.cuda.empty_cache()
    _labelled("tools bench_root", text,
              ("root caps:", "transform (root, f64)", "join incl solve (root)",
               "assemble dense S (root, f64)", "solve refine (root)",
               "solve f32 (root)", "dcompact (root)",
               "matmul f64 Yd@Wd.T only", "matmul f32 Yd@Wd.T only"))
    print(f"tools bench_root: kernel launches {launched['bench_root stereo']}",
          flush=True)
    for tool, argv, labels in (
            (microbench, [], ("B=256 M=32 N=32 KU=128 KW=128 O=4",
                              "cholesky f64", "S scatter-add f64",
                              "group_by_feature+pairprod f64",
                              "congruence einsum f64")),
            (profile_tree, ["512", "stereo"],
             ("cold L 1 npair=", "warm L 9 npair=", "WARM TOTAL:"))):
        name = tool.__name__.rsplit(".", 1)[-1]
        rc, text = _captured(tool.main, argv)
        if rc != 0:
            raise AssertionError(f"tools {name}: exit {rc}")
        _labelled(f"tools {name}", text, labels)
    for path, counts in launched.items():
        _require_launched(f"tools {path}", counts)
    print(f"tools: phase {time.perf_counter() - t_phase:.2f} s ((a) "
          f"{t_a - t_phase:.2f} s, (b) {t_b - t_a:.2f} s, (c) "
          f"{time.perf_counter() - t_b:.2f} s)", flush=True)
    return launched, oracle


def _counted(fn):
    """fn() with the kernel launch counts set to 0 just before it and read
    just after it: (its result, the launches, its wall in seconds)."""
    import torch
    from linearsfm_tpu_torch.ops import kernels
    for k in kernels.launches:
        kernels.launches[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(kernels.launches), time.perf_counter() - t0


def _held_counted(tag, fn, k1_at_root=True, dense=False, hold_k3=True,
                  add_ns=None, hold_k5=False):
    """`_counted(fn)` with every K1, K2 and K3 call held against its plain
    version in situ (`_K1InSitu`, `_K2InSitu`, `_K3InSitu`): K2 and (given
    `k1_at_root`) K1 must have been held at the root; the dense executor
    calls K1 at level 0 only. K3 must have been held, unless the path is
    the dense executor's (`dense`), where it must not have run, or
    `hold_k3` is False (its calls then run unheld: each held call costs a
    copy to the host and the CPU's sum); given `add_ns` (the add latencies
    by dtype), the run's K3 launch with the most values on one chain is
    then held and timed (`_K3InSitu.time_worst`). With `hold_k5`, every K5
    call too (`_K5InSitu`). The wall includes the checks, not the
    timing."""
    with contextlib.ExitStack() as held:
        k1, k2 = (held.enter_context(_K1InSitu()),
                  held.enter_context(_K2InSitu()))
        k3 = held.enter_context(_K3InSitu()) if hold_k3 or dense else None
        k5 = held.enter_context(_K5InSitu()) if hold_k5 else None
        got = _counted(fn)
    if k5 is not None:
        k5.report(tag)
    if dense:
        if k3.calls:
            raise AssertionError(f"{tag}: K3 ran on the dense executor "
                                 f"{k3.calls}")
    elif hold_k3:
        k3.report(tag)
        if add_ns is not None:
            k3.time_worst(tag, add_ns)
    if k1_at_root:
        _held_at_root(tag, k1, k2)
    else:
        k1.report(tag)
        print(f"{tag}: every fused K2 call held against the plain version "
              f"in situ (torch.equal, both outputs): {k2.calls} calls, "
              f"{k2.root} on one lane ok", flush=True)
        if not k2.root:
            raise AssertionError(f"{tag}: no K2 call held at the root")
    return got


def phase_call_forms(datasets, oracle512, add_ns):
    """Phase 12, the JAX package's call forms on the port, no device
    argument anywhere (the card is the default). Every run whose launches
    it returns holds each K1, K2 and K3 call against its plain version in
    situ (`_held_counted`). (a) `DeviceTreeSolver("mono", method="direct")` run
    directly (no pipeline) on the 2,048-map mono set three times, the last
    held in situ: every pose id there and finite, the three runs'
    poses `torch.equal` (the solver sums direct mono in a fixed order), the
    ATE within 1e-6 of the oracle's; both plain walls printed;
    `DenseTreeSolver("mono", method="direct")` twice, the second held in
    situ: equal poses with PyTorch's default sums, ATE within 1e-6; (b)
    `DeviceTreeSolver("mono", method="direct", pin="zero")` at 2,048 maps:
    every pose finite, the ATE within 1e-6 of the oracle's; the 11-map mono
    set with pin="zero", direct and refine, on the card against the CPU
    within 1e-9; (c) `TreeSolver("stereo")` and `DenseTreeSolver("stereo",
    method="refine")` at 512 covis maps (seed 7), on cuda:0, and
    `pipeline.run(path, 512, "stereo")` on that set written as text: every
    pose id there and finite, the ATE within 1e-6 of the live oracle's on
    the same set (`oracle512`, phase 11a) and every pose within 1e-5 of
    the oracle's pose file, as phase 11a holds the port (the dense
    executor's default refine, f32 at its low levels: 1e-4 and 5e-4; then
    again with `mixed_max_m=0` at 1e-6 and 1e-5); (d)
    `__graft_entry__.entry`'s single-pair merge, `merge_one_stereo(g, m,
    JoinConfig(max_obs=8))` on two maps of the 2-map stereo set (2
    features per pose, seed 0, compacted at buckets 8 / 16), on the card
    against the CPU within 1e-9; (e) `TreeSolver("mono", method="direct")`
    and `pipeline.run(path, 512, "mono")` (the host executor, direct) twice
    each on phase 11a's mono set, the solver's second run held in situ (K1,
    K2 and K3): equal poses, each run within 1e-6 (ATE) and 1e-5 (poses) of
    the live oracle. Returns the launches of each path."""
    import numpy as np
    import torch
    from synth import generate as gen
    from linearsfm_tpu_torch import types
    from linearsfm_tpu_torch.core import compact, pipeline
    from linearsfm_tpu_torch.core.dense_tree import DenseTreeSolver
    from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
    from linearsfm_tpu_torch.core.join import JoinConfig
    from linearsfm_tpu_torch.core.tree import TreeSolver
    from linearsfm_tpu_torch.io import localmap as lio
    from linearsfm_tpu_torch.ops import kernels
    from linearsfm_tpu_torch.parallel import level

    t_phase = time.perf_counter()
    card = torch.device("cuda", 0)
    launched = {}
    maps, gt, _ = datasets["mono"]
    oracle = ORACLE_ATE_2048["mono"]
    mono_ids = set(range(len(maps) + 2))   # pose 0 an explicit block

    def check(tag, lm, want_ids):
        h = types.host_fields(lm)
        ok = h.pose_ids >= 0
        if (sorted(int(i) for i in h.pose_ids[ok]) != sorted(want_ids)
                or not np.isfinite(h.poses[ok]).all()):
            raise AssertionError(f"{tag}: {int(ok.sum())} valid poses (want "
                                 f"{len(want_ids)}), finite="
                                 f"{np.isfinite(h.poses[ok]).all()}")

    def near_oracle(tag, ate, ref, limit=1e-6):
        print(f"{tag}: ATE {ate:.9f} (oracle {ref:.9f}, diff "
              f"{ate - ref:+.3e}, limit {limit:g})", flush=True)
        if not abs(ate - ref) <= limit:
            raise AssertionError(f"{tag}: ATE {ate} off the oracle's {ref}")

    # (a) fixed-order direct mono, called directly
    tag = "call forms mono direct"
    solver = DeviceTreeSolver("mono", method="direct")
    if solver.device != card:
        raise AssertionError(f"{tag}: DeviceTreeSolver('mono', "
                             f"method='direct') on {solver.device}")
    runs = []
    for k in range(2):
        out, counts, wall = _counted(lambda: solver.run(maps))
        check(tag, out, mono_ids)
        runs.append((wall, out.poses))
        print(f"{tag} run {k}: wall {wall:.4f} s, kernel launches {counts}",
              flush=True)
        del out
    out, launched[tag], wall = _held_counted(f"{tag} in situ",
                                             lambda: solver.run(maps),
                                             add_ns=add_ns, hold_k5=True)
    check(f"{tag} in situ", out, mono_ids)
    pa = _poses_by_id(out)
    same = [torch.equal(runs[0][1], p) for p in (runs[1][1], out.poses)]
    print(f"{tag}: runs 0 and 1 torch.equal {same[0]}, run 0 and the in-situ "
          f"run {same[1]}; walls {runs[0][0]:.4f} / {runs[1][0]:.4f} s "
          f"(in situ {wall:.4f} s); kernel launches {launched[tag]}",
          flush=True)
    if not all(same):
        raise AssertionError(f"{tag}: the runs' poses differ")
    if launched[tag] != counts:
        raise AssertionError(f"{tag}: the in-situ run counted {launched[tag]}"
                             f" launches, the plain runs {counts}")
    near_oracle(tag, _ate_of(pa, gt), oracle)
    DIGESTS[tag] = pose_digest(out)
    del runs, out, solver
    # the dense executor's default sums already give the same poses on
    # every run (PERF.md §6), so it sums without the fixed-order scope
    tag = "call forms dense mono direct"
    dense = DenseTreeSolver("mono", method="direct")
    first, _, wall = _counted(lambda: dense.run(maps))
    out, launched[tag], wall_held = _held_counted(
        tag, lambda: dense.run(maps), k1_at_root=False, dense=True)
    check(tag, out, mono_ids)
    same = np.array_equal(first.poses, out.poses)
    print(f"{tag}: two runs' poses equal {same}; walls {wall:.4f} s, in "
          f"situ {wall_held:.4f} s; kernel launches {launched[tag]}",
          flush=True)
    if not same:
        raise AssertionError(f"{tag}: the runs' poses differ")
    near_oracle(tag, _ate_of(_poses_by_id(out), gt), oracle)
    del first, out, dense
    t_a = time.perf_counter()

    # (b) pin="zero"
    tag = "call forms mono direct pin zero"
    zero = DeviceTreeSolver("mono", method="direct", pin="zero")
    out, launched[tag], wall = _held_counted(tag, lambda: zero.run(maps))
    check(tag, out, mono_ids)
    p = _poses_by_id(out)
    print(f"{tag}: wall {wall:.4f} s (in situ), max pose diff vs pin='sign' "
          f"{_max_diff('pin', p, pa):.3e}, kernel launches {launched[tag]}",
          flush=True)
    near_oracle(tag, _ate_of(p, gt), oracle)
    del out, zero
    small, _, _ = gen.make_dataset(11, "mono", noise=0.01, seed=5)
    for method in ("direct", "refine"):
        a = _poses_by_id(DeviceTreeSolver("mono", method=method,
                                          pin="zero").run(small))
        b = _poses_by_id(DeviceTreeSolver("mono", method=method, pin="zero",
                                          device="cpu").run(small))
        diff = _max_diff(f"tree11 mono {method} pin zero", a, b)
        print(f"call forms tree11 mono {method} pin='zero': GPU vs CPU max "
              f"pose diff {diff:.3e} (atol 1e-9)", flush=True)
        if not diff <= 1e-9:
            raise AssertionError(f"call forms tree11 mono {method} pin zero: "
                                 f"GPU vs CPU {diff:.3e}")
    t_b = time.perf_counter()

    # (c) the host and dense executors and pipeline.run at 512 covis maps,
    # against the live oracle on the same set
    m512, gt512, _ = gen.make_dataset(512, "stereo", noise=0.005, seed=7,
                                      covis_radius=6.0, covis_max=6)

    def vs_oracle(tag, out, ate_limit=1e-6, pose_limit=1e-5,
                  datatype="stereo", gt=gt512):
        check(tag, out, set(range(1, 513)) if datatype == "stereo"
              else set(range(514)))
        p = _poses_by_id(out)
        diff = _max_diff(tag, p, oracle512[datatype]["poses"])
        print(f"{tag}: pose max |diff| vs the oracle's pose file {diff:.3e} "
              f"(limit {pose_limit:g})", flush=True)
        if not diff <= pose_limit:
            raise AssertionError(f"{tag}: poses differ from the oracle's by "
                                 f"{diff}")
        near_oracle(tag, _ate_of(p, gt), oracle512[datatype]["ate"],
                    ate_limit)
        return out.poses

    # the dense executor's default refine keeps f32 information at its
    # low levels: at 512 maps it lands +2.690e-5 (ATE) and 1.494e-4
    # (poses) from the oracle on the H100, and the JAX package's as far
    # on the CPU (ROADMAP queue 3 item 5), so it is held to 1e-4 and 5e-4;
    # with f64 information at every level (mixed_max_m=0) to the exact
    # solve's limits
    # (the host executor's K3 calls run unheld here: (e) holds them)
    for tag, make, at_root, limits in (
            ("host stereo 512", lambda: TreeSolver("stereo"), True,
             (1e-6, 1e-5)),
            ("dense stereo 512 refine",
             lambda: DenseTreeSolver("stereo", method="refine"), False,
             (1e-4, 5e-4)),
            ("dense stereo 512 refine f64",
             lambda: DenseTreeSolver("stereo", method="refine",
                                     mixed_max_m=0), False, (1e-6, 1e-5))):
        tag = f"call forms {tag}"
        s = make()
        if s.device != card:
            raise AssertionError(f"{tag}: on {s.device}")
        out, launched[tag], wall = _held_counted(
            tag, lambda: s.run(m512), at_root, dense=not at_root,
            hold_k3=False)
        print(f"{tag}: on {s.device}, wall {wall:.4f} s (in situ), kernel "
              f"launches {launched[tag]}", flush=True)
        vs_oracle(tag, out, *limits)
        del s, out
    # pipeline.run(path, num, datatype): the host executor, direct
    tag = "call forms pipeline.run stereo 512"
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as text:
        lio.write_dataset(m512, text)
        (out, _), launched[tag], wall = _held_counted(
            tag, lambda: pipeline.run(text, 512, "stereo", progress=False),
            hold_k3=False)
    print(f"{tag}: pipeline.run(path, 512, 'stereo') wall {wall:.4f} s (in "
          f"situ), kernel launches {launched[tag]}", flush=True)
    vs_oracle(tag, out)
    del out

    # (e) direct mono on the host executor, which sums in the fixed order:
    # TreeSolver and pipeline.run twice each on phase 11a's mono set
    mono512, gtm, _ = gen.make_dataset(512, "mono", noise=0.005, seed=7,
                                       covis_radius=6.0, covis_max=6)
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as text:
        lio.write_dataset(mono512, text)
        # pipeline.run solves with the same TreeSolver, so the solver's
        # second run alone is held in situ (each held run costs about
        # three plain ones)
        for tag, run, held in (
                ("host mono 512 direct",
                 lambda: TreeSolver("mono", method="direct").run(mono512),
                 True),
                ("pipeline.run mono 512",
                 lambda: pipeline.run(text, 512, "mono", progress=False)[0],
                 False)):
            tag = f"call forms {tag}"
            first, counts, wall = _counted(run)
            first = vs_oracle(f"{tag} run 0", first, datatype="mono",
                              gt=gtm)
            if held:
                out, launched[tag], wall2 = _held_counted(
                    tag, run, add_ns=add_ns)
            else:
                out, launched[tag], wall2 = _counted(run)
            again = vs_oracle(f"{tag} run 1", out, datatype="mono", gt=gtm)
            same = (torch.equal(first, again) if torch.is_tensor(first)
                    else np.array_equal(first, again))
            print(f"{tag}: two runs' poses torch.equal {same}; walls "
                  f"{wall:.4f} s, {wall2:.4f} s{' in situ' if held else ''};"
                  f" kernel launches {counts}, {launched[tag]}", flush=True)
            if not same:
                raise AssertionError(f"{tag}: the runs' poses differ")
            del first, out, again
    t_c = time.perf_counter()

    # (d) the single-pair merge of __graft_entry__.entry
    two, _, _ = gen.make_dataset(2, "stereo", feats_per_pose=2, noise=0.01,
                                 seed=0)
    lms = [compact.compact(m, bucket=8, u_bucket=16) for m in two]
    got = {}
    for dev in ("cuda", "cpu"):
        g, m = (types.stack([types.to_torch(lm, dev)]) for lm in lms)
        got[dev] = level.merge_one_stereo(g, m, JoinConfig(max_obs=8))
    diff = max(float((got["cuda"].poses.cpu() - got["cpu"].poses).abs().max()),
               float((got["cuda"].feats.cpu() - got["cpu"].feats).abs().max()))
    print(f"call forms merge_one_stereo(JoinConfig(max_obs=8)): GPU vs CPU "
          f"max state diff {diff:.3e} (atol 1e-9)", flush=True)
    if not diff <= 1e-9:
        raise AssertionError(f"call forms merge_one_stereo: GPU vs CPU "
                             f"{diff:.3e}")
    for path, counts in launched.items():
        _require_launched(path, counts, dense="dense" in path)
    print(f"call forms: phase {time.perf_counter() - t_phase:.2f} s ((a) "
          f"{t_a - t_phase:.2f} s, (b) {t_b - t_a:.2f} s, (c) "
          f"{t_c - t_b:.2f} s, (d) {time.perf_counter() - t_c:.2f} s)",
          flush=True)
    return launched


# phase 13's cases: (path, the bench's environment knobs)
BENCH_CASES = (
    ("bench stereo", {}),
    ("bench mono", {"BENCH_TYPE": "mono"}),
    ("bench mono direct", {"BENCH_TYPE": "mono", "BENCH_METHOD": "direct"}),
    ("bench dense stereo", {"BENCH_EXEC": "dense",
                            "BENCH_PROFILE_LEVELS": "0"}),
)
# the run of this process whose poses each case must repeat, bit for bit
# (`DIGESTS`: the same solver call form on the same set)
BENCH_SAME = {"bench stereo": "main stereo", "bench mono": "main mono",
              "bench mono direct": "call forms mono direct",
              "bench dense stereo": "dense stereo"}


def phase_bench(smi, rates):
    """13. `python3 -m linearsfm_tpu_torch.tools.bench` as a subprocess on
    the card for each of `BENCH_CASES` (2,048 covis maps): exit 0, one
    stdout line with bench.py's keys (res_max, mfu and
    achieved_f32_tflops on the device executor; no res_max on the direct
    solve, which computes no PCG residual, as in bench.py), res_max <=
    1e-10, the logged ATE within 1e-6 of the oracle's (the dense
    executor's default refine, f32 information at its low levels, 1e-4,
    as phase 12 holds it), K1 and K2 in the timed run's logged launches
    and K3 on every case but the dense executor's, where it must not run;
    the card's line (`smi`) on stderr; the logged SHA-256 of the warm and
    the timed run's poses equal to each other and to this process's run
    of the same solve (`BENCH_SAME`, `DIGESTS`). Each value is printed
    beside phase 6/7's own timed rate (`rates`, by data type), as a
    record. Returns the launches by path."""
    import re
    import torch

    t_phase = time.perf_counter()
    # the bench processes need the card's memory this process has cached
    torch.cuda.empty_cache()
    paths = {}
    for tag, knobs in BENCH_CASES:
        datatype = knobs.get("BENCH_TYPE", "stereo")
        device_exec = "BENCH_EXEC" not in knobs
        direct = knobs.get("BENCH_METHOD") == "direct"
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "linearsfm_tpu_torch.tools.bench"],
            cwd=HERE, env=dict(os.environ, **knobs), capture_output=True,
            text=True, timeout=600)
        wall = time.perf_counter() - t0
        if p.returncode != 0:
            raise AssertionError(f"{tag}: exit {p.returncode}\n"
                                 f"{p.stderr[-3000:]}")
        lines = p.stdout.strip().splitlines()
        if len(lines) != 1:
            raise AssertionError(f"{tag}: stdout is not one line:\n"
                                 f"{p.stdout[-2000:]}")
        rec = json.loads(lines[0])
        keys = {"metric", "value", "unit", "vs_baseline"}
        if device_exec:
            keys |= {"mfu", "achieved_f32_tflops"} | (
                set() if direct else {"res_max"})
        if set(rec) != keys or rec["unit"] != "maps_joined/s":
            raise AssertionError(f"{tag}: keys {sorted(rec)}, want "
                                 f"{sorted(keys)}: {rec}")
        ate = float(re.search(r"ATE (\d+\.\d{9}) over", p.stderr).group(1))
        warm, timed_digest = re.search(
            r"poses sha256 \(warm run\) (\w+) \(timed run\) (\w+)",
            p.stderr).groups()
        launched = json.loads(re.search(
            r"kernel launches \(timed run\): (\{.*\})", p.stderr).group(1))
        timed = re.search(r"timed run: (.*)", p.stderr).group(1)
        peak = re.search(r"peak device memory \(timed run\): (.*)",
                         p.stderr).group(1)
        oracle = ORACLE_ATE_2048[datatype]
        tol = 1e-6 if device_exec else 1e-4
        rate = rates[datatype]
        print(f"{tag}: {rec['value']} maps_joined/s (phase 6/7's timed run "
              f"{rate:.3f}, record only), res_max {rec.get('res_max')}, mfu "
              f"{rec.get('mfu')}, {rec.get('achieved_f32_tflops')} TF/s, "
              f"ATE {ate:.9f} (oracle {oracle:.9f}, diff {ate - oracle:+.3e}, "
              f"tol {tol:g}), kernel launches {launched}, peak device "
              f"memory {peak}, timed run {timed}, process {wall:.1f} s",
              flush=True)
        print(f"{tag}: {lines[0]}", flush=True)
        if smi not in p.stderr:
            raise AssertionError(f"{tag}: the card's line {smi!r} is not on "
                                 f"stderr")
        if not abs(ate - oracle) <= tol:
            raise AssertionError(f"{tag}: ATE {ate} off the oracle's")
        if "res_max" in keys and not rec["res_max"] <= 1e-10:
            raise AssertionError(f"{tag}: res_max {rec['res_max']} > 1e-10")
        _require_launched(tag, launched, dense=not device_exec)
        # the bench's warm and timed runs, and this process's run of the
        # same solve (another process), give the same bits
        mine = DIGESTS.get(BENCH_SAME[tag])
        print(f"{tag}: poses sha256 warm run {warm[:16]}..., timed run "
              f"{timed_digest[:16]}..., {BENCH_SAME[tag]} in this process "
              f"{str(mine)[:16]}...", flush=True)
        if warm != timed_digest or timed_digest != mine:
            raise AssertionError(f"{tag}: the runs' poses differ (sha256 "
                                 f"{warm}, {timed_digest}, {mine})")
        paths[tag] = launched
    print(f"bench: phase {time.perf_counter() - t_phase:.2f} s", flush=True)
    return paths


# oracle ATE of the grid mono 2,048-map covis set, seed 7: the oracle
# binary on the files `_archive/grid_mono_2048.py` writes (PERF.md)
ORACLE_ATE_GRID_2048 = 2.572875460


def phase_grid_mono():
    """14. grid mono 2,048 (`phase_grid_mono`): the set of
    `_archive/grid_mono_2048.py` (`synth.generate.make_dataset(2048,
    "mono", noise=0.005, seed=7, pattern="grid", covis_radius=6.0,
    covis_max=6)` written as text with the port's writer and read back
    with `pipeline.load_local_maps`) through `DeviceTreeSolver("mono",
    method=M)` (no device argument) three times for each of refine and
    direct, the counts from 0 around each run: the three runs' pose ids,
    poses and features `torch.equal`, and K1, K2 and K3 launched in each.
    The data amplify rounding by orders of magnitude more than the loop
    set (PERF.md §7), so no tolerance to the oracle or to the JAX package
    holds here: the ATE (over the finite poses), res_max and the count of
    non-finite poses are printed beside the oracle's ATE, as a record.
    Returns the launches of each method's last run."""
    import numpy as np
    from synth import generate as gen
    from linearsfm_tpu_torch import types
    from linearsfm_tpu_torch.core import pipeline
    from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
    from linearsfm_tpu_torch.io import localmap as lio
    from linearsfm_tpu_torch.ops import kernels
    from linearsfm_tpu_torch.utils.metrics import LevelMetrics

    t_phase = time.perf_counter()
    n = 2048
    maps, gt, _ = gen.make_dataset(n, "mono", noise=0.005, seed=7,
                                   pattern="grid", covis_radius=6.0,
                                   covis_max=6)
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as text:
        lio.write_dataset(maps, text)
        maps = pipeline.load_local_maps(text, n, "mono")
    print(f"grid mono: {n} maps made, written and read back in "
          f"{time.perf_counter() - t_phase:.2f} s", flush=True)
    launched = {}
    for method in ("refine", "direct"):
        tag = f"grid mono {method}"
        solver = DeviceTreeSolver("mono", method=method)
        first = None
        for k in range(3):
            metrics = LevelMetrics()
            out, counts, wall = _counted(
                lambda: solver.run(maps, metrics=metrics))
            h = types.to_numpy(out)
            del out
            v = h.pose_ids >= 0
            fin = np.isfinite(h.poses[v]).all(axis=1)
            err = np.linalg.norm(h.poses[v][fin, :3]
                                 - gt[h.pose_ids[v][fin], :3], axis=1)
            ate = (float(np.sqrt(np.mean(np.square(err)))) if fin.any()
                   else float("nan"))
            res = [r.get("res_max", float("nan")) for r in metrics.records]
            res_max = (max(res) if method == "refine" and res
                       else float("nan"))
            print(f"{tag} run {k}: wall {wall:.4f} s, {int(v.sum())} poses, "
                  f"{int((~fin).sum())} non-finite, ATE over the finite "
                  f"{ate:.9f} (oracle {ORACLE_ATE_GRID_2048:.9f}, record "
                  f"only), res_max {res_max:.3e}"
                  f"{' (the direct solve computes none)' * (method == 'direct')}"
                  f", kernel launches {counts}", flush=True)
            _require_launched(f"{tag} run {k}", counts)
            if first is None:
                first = h
            else:
                _repeats(f"{tag} runs 0 and {k}", first, h)
        launched[tag] = counts
        del first, solver
    print(f"grid mono: phase {time.perf_counter() - t_phase:.2f} s",
          flush=True)
    return launched


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs one CUDA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    # full-f32 matmuls (the port refuses TF32 on its f32 Schur products)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # phase 9's two worker processes share the card: this process caches at
    # most half of it (the direct float64 root, its largest, needs about
    # 16 GB with the in-situ checks)
    torch.cuda.set_per_process_memory_fraction(0.5)

    sys.path.insert(0, HERE)
    from linearsfm_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.build()
    print(f"build: {', '.join(os.path.basename(s) for s in kernels.SOURCES)} "
          f"(nvcc sm_90a) {time.perf_counter() - t0:.2f} s", flush=True)

    datasets = {d: make_dataset(d) for d in ("stereo", "mono")}
    shapes = _k2_shapes(datasets)
    k1_err, k1_times = phase_kernels()
    k2_err, k2_times = phase_k2(shapes)
    k3_err, k3_times, add_ns = phase_k3(shapes)
    phase_small_trees()
    paths, single, rates = {}, {}, {}
    for d, (maps, gt, tp) in datasets.items():
        paths[d], single[d], rates[d] = phase_main_path(
            d, maps, gt, tp, shapes, hold_k3=True, hold_k4=True,
            hold_k5=True)
    paths.update(phase_k5())
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as text_dir:
        launched, cli_poses = phase_entry_points(datasets, text_dir)
        paths.update(launched)
        paths.update(phase_mesh(datasets, single))
        paths.update(phase_dense(datasets, single, text_dir, cli_poses))
    launched, oracle512 = phase_tools(datasets)
    paths.update(launched)
    paths.update(phase_call_forms(datasets, oracle512, add_ns))
    paths.update(phase_bench(smi, rates))
    paths.update(phase_grid_mono())

    def record(name, source, replaces, max_err, t, library, **extra):
        by_path = {d: c.get(name, 0) for d, c in paths.items()}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path, "max_abs_err": max_err,
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"],
                "bound_by": t.get("bound_by", "bytes"),
                "library_ms": t["library_ms"], "library": library, **extra}

    print(f"chip_smoke: all phases {time.perf_counter() - t_start:.1f} s",
          flush=True)
    # K2's figures: the fused kernel (V^-1 and Y = W V^-1[wf]) at the stereo
    # root, float32, by device time; K3's: the direct mono root's [1,
    # 351360, 6, 3] float64 sum over wf, CUDA events
    print(json.dumps({"kernels": [
        record("blockcoo_to_dense",
               "linearsfm_tpu_torch/csrc/blockcoo_dense.cu",
               "linearsfm_tpu/ops/pallas_kernels.py:156", k1_err,
               k1_times["root W stripe 6x3 (plan)"],
               "torch.zeros + index_put_(accumulate=True)"),
        record("inv3x3_sym", "linearsfm_tpu_torch/csrc/inv3x3_sym.cu",
               "linearsfm_tpu/ops/pallas_kernels.py:57", k2_err,
               k2_times[("stereo root", "float32")],
               "torch.linalg.inv + take + torch.matmul"),
        record(K3, "linearsfm_tpu_torch/csrc/segment_sum.cu",
               "linearsfm_tpu/ops/schur.py:70",
               max(k3_err, _K3InSitu.worst),
               k3_times[("root", "float64")], "index_add_ (atomics)",
               library_det_ms=k3_times[("root", "float64")]["library_det_ms"],
               bytes_ms=k3_times[("root", "float64")]["bytes_ms"],
               chain_floor_ms=k3_times[("root", "float64")]["chain_floor_ms"],
               add_latency_ns=add_ns["float64"],
               note="the port's own kernel, no TPU kernel: a fixed-order "
                    "sum where the JAX package calls jax.ops.segment_sum"),
        record(K4, "linearsfm_tpu_torch/csrc/schur_pairs.cu",
               "linearsfm_tpu/ops/schur.py:176", 0.0,
               K4_TIMES["scale stereo 3499"],
               "none: the dense product it replaced is deleted (K1's W/Y "
               "stripes + torch.baddbmm, timed in PERF.md)",
               bytes_ms=K4_TIMES["scale stereo 3499"]["bytes_ms"],
               flop_ms=K4_TIMES["scale stereo 3499"]["flop_ms"],
               note="the port's own kernel, no TPU kernel: the refine "
                    "preconditioner's f32 Schur complement from the W "
                    "block list, where the JAX package multiplies dense "
                    "layouts; held exactly (torch.equal) in situ"),
        record(K5, "linearsfm_tpu_torch/csrc/gauge_congruence.cu",
               "linearsfm_tpu/ops/congruence.py:118", _K5InSitu.worst,
               K5_TIMES["nc3500_stereo"]["root"],
               "none: the plain transform (about 1,000-1,500 PyTorch "
               "operations a call) is its yardstick",
               times={c: t for c, t in K5_TIMES.items()},
               note="the port's own kernel, no TPU kernel: the gauge "
                    "transform and its congruence, where the JAX package "
                    "takes jacfwd and array operations; held in situ "
                    "within K5_TOL (max_abs_err: the largest relative "
                    "difference held)")
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
