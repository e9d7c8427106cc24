"""Hand-written GPU kernels of the port, their plain versions and their build.

Each kernel replaces a TPU kernel of `linearsfm_tpu/ops/pallas_kernels.py`;
its CUDA source under `csrc/` notes its design and what bounds it:

* K1 `blockcoo_to_dense` (`csrc/blockcoo_dense.cu`): dense matrices from
  block-COO lists, the Schur assembly's scatter; `coo_plan` sorts a list
  once and `blockcoo_to_dense_planned` launches K1 on a column window of it;
* K2 (`csrc/inv3x3_sym.cu`), fused: `inv3x3_wy` computes in one launch the
  closed-form inverses Vinv of the symmetric 3x3 feature blocks and the
  products Y = W Vinv[wf] of every W entry; `inv3x3_sym` is the same launch
  with no W entries (the inverse alone).

K3 `seg_sum_fixed` (`csrc/segment_sum.cu`) replaces no TPU kernel: it is
the port's own fixed-order segment sum, for the sums that PyTorch would add
with atomics on the card and XLA adds in a fixed order (`ops/segment`
runs it inside `segment.deterministic()`); `seg_plan` sorts an index list
once for it. `add_chain`, beside it, is the probe that measures the card's
dependent add latency (K3's chain floor), no kernel of the port.

K4 `schur_pairs` (`csrc/schur_pairs.cu`) replaces no TPU kernel either: it
forms the refine preconditioner's float32 Schur complement from the W
block list, in a fixed order, where the JAX package densifies W and Y and
multiplies the dense layouts (`ops/schur._assemble_schur_dense`).

K5 `gauge_congruence` (`csrc/gauge_congruence.cu`) replaces no TPU kernel:
the gauge transform of a stack of maps and the congruence of its
information (`ops/congruence.transform_map_stereo` / `_mono`), where the
JAX package, like the plain version, takes the Jacobians with jacfwd and
forms the congruence as about a thousand array operations; the kernel's
launches and one sort take their place (`gauge_congruence`).

All sources are compiled with nvcc for sm_90a (one process per source, all
started together) and linked into one shared library with a plain C
interface, at first use, into `_build/` beside the package, and bound with
ctypes.

Dispatch: a tensor on the CPU takes the plain PyTorch version; a CUDA tensor
launches the kernel or raises. `launches` counts kernel launches, and only
those, so a run can show that it went through the kernels (K5: one per
call, whatever number of launches it takes).
"""

from __future__ import annotations

import ctypes
import dataclasses
import glob
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from typing import NamedTuple

import torch

from .. import types
from .segment import lane_ids, take

launches = {"blockcoo_to_dense": 0, "inv3x3_sym": 0, "seg_sum_fixed": 0,
            "schur_pairs": 0, "gauge_congruence": 0}

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = tuple(sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cu"))))
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
_lib: ctypes.CDLL | None = None   # loaded once per process
_K2: dict = {}   # torch dtype -> K2's bound ctypes function, set by build()
_K3: dict = {}   # torch dtype -> K3's bound ctypes function, set by build()
_CHAIN: dict = {}   # torch dtype -> the add-latency probe, set by build()
K3_MAX_TAIL = 256   # elements of an entry's value row K3 takes: its CTA size


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "linearsfm_tpu_torch/csrc at first use")


def _run_all(cmds: list[list[str]]):
    """Run the commands concurrently; raise with the first failure's stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (_, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed:\n{err}")


def build() -> ctypes.CDLL:
    """Compile the kernel library (once per content of the sources and the
    flags) and load it."""
    global _lib
    if _lib is not None:
        return _lib
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as fh:
            h.update(fh.read())
    tag = h.hexdigest()[:12]
    so = os.path.join(BUILD_DIR, f"libkernels_{tag}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        # objects live in a private directory, removed on success and failure
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [os.path.join(tmp, os.path.basename(s) + ".o")
                    for s in SOURCES]
            _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, s]
                      for s, o in zip(SOURCES, objs)])
            lib_tmp = os.path.join(tmp, "libkernels.so")
            _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib_tmp, *objs]])
            os.replace(lib_tmp, so)
    lib = ctypes.CDLL(so)
    for fn in (lib.blockcoo_dense_f32, lib.blockcoo_dense_f64):
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int64,
                                               ctypes.c_int, ctypes.c_int,
                                               ctypes.c_int64, ctypes.c_int64,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for dtype, fn in ((torch.float32, lib.inv3x3_wy_f32),
                      (torch.float64, lib.inv3x3_wy_f64)):
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _K2[dtype] = fn
    for dtype, fn in ((torch.float32, lib.seg_sum_f32),
                      (torch.float64, lib.seg_sum_f64)):
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 3 + [
            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _K3[dtype] = fn
    for dtype, fn in ((torch.float32, lib.add_chain_f32),
                      (torch.float64, lib.add_chain_f64)):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _CHAIN[dtype] = fn
    lib.schur_pairs_f32.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int64] * 3 + [ctypes.c_void_p]
    lib.schur_pairs_f32.restype = ctypes.c_int
    lib.gauge_congruence_scratch.argtypes = [ctypes.c_void_p]
    lib.gauge_congruence_scratch.restype = ctypes.c_int64
    for fn in (lib.gauge_congruence_a, lib.gauge_congruence_b):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def _valid(rows, cols, M, N):
    return (rows >= 0) & (rows < M) & (cols >= 0) & (cols < N)


def blockcoo_to_dense_ref(rows: torch.Tensor, cols: torch.Tensor,
                          vals: torch.Tensor, M: int, N: int) -> torch.Tensor:
    """Plain version of K1: dense [..., R*M, C*N] from block-COO lists.

    rows/cols [..., K] block coordinates, vals [..., K, R, C]; an optional
    leading lane dimension gives one dense matrix per lane. Entries with a
    row < 0 (padding), or any coordinate out of range, are skipped; duplicate
    coordinates add up (sequentially, in list order, on the CPU).
    """
    K, R, C = vals.shape[-3:]
    lead = rows.shape[:-1]
    P = math.prod(lead)
    rows, cols = rows.reshape(P, K), cols.reshape(P, K)
    dev = vals.device
    ok = _valid(rows, cols, M, N)
    # skipped entries go to a dummy block row P*M, sliced off below
    frow = torch.where(ok, rows + lane_ids(P, dev) * M, P * M)
    rr = frow[..., None, None] * R + torch.arange(R, device=dev)[:, None]
    cc = (torch.where(ok, cols, 0)[..., None, None] * C
          + torch.arange(C, device=dev)[None, :])
    rr, cc = torch.broadcast_tensors(rr, cc)
    out = vals.new_zeros(((P * M + 1) * R, C * N))
    out.index_put_((rr.reshape(-1), cc.reshape(-1)), vals.reshape(-1),
                   accumulate=True)
    return out[:P * M * R].view(lead + (R * M, C * N))


class CooPlan(NamedTuple):
    """One block list sorted for K1 (`coo_plan`); any number of launches,
    each on a column window, reuse it."""
    rows: torch.Tensor      # [..., K] as given (the plain version reads them)
    cols: torch.Tensor
    perm: torch.Tensor      # int32 [P*K]: flat entry index of each position
    scol: torch.Tensor      # int32 [P*K]: block column of each position
    row_ptr: torch.Tensor   # int32 [P*M + 1]: CSR offsets per folded row
    M: int
    N: int


def coo_plan(rows: torch.Tensor, cols: torch.Tensor, M: int,
             N: int) -> CooPlan:
    """Sort a (lane-stacked) block list once for K1.

    One stable sort of the key (lane*M + row)*N + col, entries out of range
    (row < 0 is padding) last: `perm` lists the entries block row by block
    row (lanes folded: row + lane*M), each row's entries by column, and the
    duplicates of a coordinate next to each other in list order. `row_ptr`
    holds each folded row's first sorted position. The same code runs on the
    CPU (the tests check it there) and on the card.
    """
    if rows.is_floating_point() or cols.is_floating_point():
        raise TypeError("coo_plan: integer block coordinates only")
    if cols.shape != rows.shape or rows.dim() < 1:
        raise ValueError("coo_plan: rows and cols must be [..., K] alike")
    if cols.device != rows.device:
        raise ValueError("coo_plan: rows and cols on different devices")
    K = rows.shape[-1]
    P = math.prod(rows.shape[:-1])
    dev = rows.device
    if P * K >= 2**31 or P * M >= 2**31:
        raise ValueError("coo_plan: more than 2**31 entries or block rows")
    r = rows.reshape(P, K).to(torch.int64)
    c = cols.reshape(P, K).to(torch.int64)
    key = torch.where(_valid(r, c, M, N), (r + lane_ids(P, dev) * M) * N + c,
                      P * M * N).reshape(-1)
    skey, perm = torch.sort(key, stable=True)
    row_ptr = torch.searchsorted(
        skey, torch.arange(P * M + 1, device=dev, dtype=torch.int64) * N,
        out_int32=True)
    scol = torch.remainder(skey, max(N, 1)).to(torch.int32)
    return CooPlan(rows, cols, perm.to(torch.int32), scol, row_ptr, M, N)


def blockcoo_to_dense_planned(plan: CooPlan, vals: torch.Tensor,
                              col_lo: int = 0,
                              width: int | None = None) -> torch.Tensor:
    """K1 on a plan: dense [..., R*M, C*width] from the plan's entries whose
    block column lies in [col_lo, col_lo + width) (default: all N columns);
    column c lands at c - col_lo. vals [..., K, R, C] matches the plan's
    list.

    On the CPU: the plain version over the list with the other entries
    masked out. On a CUDA tensor: one launch of the kernel, into an output
    allocated with torch.empty (the kernel writes every element).
    """
    if width is None:
        width = plan.N - col_lo
    if vals.device.type == "cpu":
        rows, cols = plan.rows, plan.cols
        if col_lo or width != plan.N:
            rows = torch.where(cols < plan.N, rows, -1)
            cols = cols - col_lo
        return blockcoo_to_dense_ref(rows, cols, vals, plan.M, width)
    if vals.device.type != "cuda":
        raise ValueError(f"blockcoo_to_dense: no kernel for {vals.device}")
    if vals.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"blockcoo_to_dense: float32/float64 only, got "
                        f"{vals.dtype}")
    if vals.dim() not in (3, 4) or not vals.is_contiguous():
        raise ValueError("blockcoo_to_dense: vals must be contiguous "
                         "[K, R, C] or [P, K, R, C]")
    K, R, C = vals.shape[-3:]
    if R * C > 64:
        raise ValueError(f"blockcoo_to_dense: {R}x{C} blocks exceed 64 elements")
    if plan.rows.shape != vals.shape[:-2]:
        raise ValueError("blockcoo_to_dense: the plan's rows/cols must match "
                         "vals[..., K]")
    if vals.numel() >= 2**31:
        raise ValueError("blockcoo_to_dense: more than 2**31 values")
    if plan.perm.device != vals.device:
        raise ValueError("blockcoo_to_dense: plan and vals on different "
                         "devices")
    if col_lo < 0 or width < 0:
        raise ValueError("blockcoo_to_dense: negative column window")
    lead = plan.rows.shape[:-1]
    P, M = math.prod(lead), plan.M
    shape = lead + (R * M, C * width)
    if K == 0:
        return torch.zeros(shape, dtype=vals.dtype, device=vals.device)
    out = torch.empty((P * R * M, C * width), dtype=vals.dtype,
                      device=vals.device)
    if out.numel() == 0:
        return out.view(shape)
    lib = build()
    fn = (lib.blockcoo_dense_f32 if vals.dtype == torch.float32
          else lib.blockcoo_dense_f64)
    err = fn(plan.row_ptr.data_ptr(), plan.perm.data_ptr(),
             plan.scol.data_ptr(), vals.data_ptr(), out.data_ptr(), P * M,
             plan.N, R, C, col_lo, width,
             torch.cuda.current_stream(vals.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"blockcoo_to_dense: CUDA launch failed (error {err})")
    launches["blockcoo_to_dense"] += 1
    return out.view(shape)


def blockcoo_to_dense(rows: torch.Tensor, cols: torch.Tensor,
                      vals: torch.Tensor, M: int, N: int) -> torch.Tensor:
    """K1: dense [..., R*M, C*N] from block-COO lists (scatter-add).

    Same contract as `blockcoo_to_dense_ref`, for float32 (the main path)
    and float64 values. On a CUDA tensor: a plan (`coo_plan`) and one launch
    (`blockcoo_to_dense_planned`); each lane's rows are folded into one tall
    matrix (row + lane*M; skipped entries stay out).
    """
    if vals.device.type == "cpu":
        return blockcoo_to_dense_ref(rows, cols, vals, M, N)
    if rows.shape != vals.shape[:-2]:
        raise ValueError("blockcoo_to_dense: rows/cols must match vals[..., K]")
    if rows.device != vals.device:
        raise ValueError("blockcoo_to_dense: operands on different devices")
    if vals.device.type != "cuda":
        raise ValueError(f"blockcoo_to_dense: no kernel for {vals.device}")
    return blockcoo_to_dense_planned(coo_plan(rows, cols, M, N), vals)


def inv3x3_sym_ref(V: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: batched closed-form inverse of symmetric 3x3
    blocks [..., 3, 3] from their upper triangle; exactly-singular blocks
    (zero padding) return zero, a NaN determinant gives NaN."""
    a, b, c = V[..., 0, 0], V[..., 0, 1], V[..., 0, 2]
    d, e, f = V[..., 1, 1], V[..., 1, 2], V[..., 2, 2]
    A = d * f - e * e
    B = c * e - b * f
    C = b * e - c * d
    D = a * f - c * c
    E = b * c - a * e
    F = a * d - b * b
    det = a * A + b * B + c * C
    zero = det == 0
    inv_det = torch.where(zero, torch.zeros_like(det),
                          1.0 / torch.where(zero, torch.ones_like(det), det))
    row0 = torch.stack([A, B, C], dim=-1)
    row1 = torch.stack([B, D, E], dim=-1)
    row2 = torch.stack([C, E, F], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2) * inv_det[..., None, None]


def inv3x3_wy_ref(V: torch.Tensor, W: torch.Tensor,
                  Wpf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the fused K2: (Vinv, Y) with Vinv = inv3x3_sym_ref(V)
    [P, N, 3, 3] and Y[p, k] = W[p, k] @ Vinv[p, wf[p, k]] [P, K, 6, 3],
    wf = Wpf[..., 1].

    The product is taken element by element in the kernel's order, not with
    a matmul: Y[i, j] = (W[i,0] G[0,j] + W[i,1] G[1,j]) + W[i,2] G[2,j]. An
    entry whose wf lies outside [0, N) gets Y = 0.
    """
    Vinv = inv3x3_sym_ref(V)
    P, N = V.shape[0], V.shape[1]
    wf = Wpf[..., 1]
    ok = (wf >= 0) & (wf < N)
    # a zero block at slot N takes the out-of-range entries (and N = 0)
    G = take(torch.cat([Vinv, Vinv.new_zeros((P, 1, 3, 3))], dim=1),
             torch.where(ok, wf, N))
    Y = (W[..., 0:1] * G[..., 0:1, :] + W[..., 1:2] * G[..., 1:2, :]
         + W[..., 2:3] * G[..., 2:3, :])
    return Vinv, torch.where(ok[..., None, None], Y, Y.new_zeros(()))


def _k2_launch(V, W, Wpf, Vinv, Y, P: int, N: int, K: int):
    """One launch of K2 on V's current stream (W, Wpf, Y None when K = 0);
    raises if it fails. Nothing to compute launches nothing."""
    if P * (N + K) == 0:
        return
    fn = _K2.get(V.dtype)
    if fn is None:
        build()
        fn = _K2[V.dtype]
    err = fn(V.data_ptr(), W.data_ptr() if K else None,
             Wpf.data_ptr() if K else None, Vinv.data_ptr(),
             Y.data_ptr() if K else None, P, N, K,
             torch.cuda.current_stream(V.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"inv3x3_wy: CUDA launch failed (error {err})")
    launches["inv3x3_sym"] += 1


def _k2_check(name: str, V: torch.Tensor):
    if V.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {V.device}")
    if V.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: float32/float64 only, got {V.dtype}")


def inv3x3_wy(V: torch.Tensor, W: torch.Tensor,
              Wpf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K2 (fused): (Vinv, Y) as `inv3x3_wy_ref`, from one launch.

    V [P, N, 3, 3] and W [P, K, 6, 3] of one dtype, float32 (the PCG
    preconditioner) or float64 (the plain-Cholesky levels), and the int64
    pair list Wpf [P, K, 2], all contiguous on one CUDA device; the kernel
    reads wf = Wpf[..., 1] in place. It equals the plain version bit for bit.
    """
    if V.device.type == "cpu":
        return inv3x3_wy_ref(V, W, Wpf)
    _k2_check("inv3x3_wy", V)
    if V.dim() != 4 or V.shape[2:] != (3, 3):
        raise ValueError(f"inv3x3_wy: V must be [P, N, 3, 3], got "
                         f"{list(V.shape)}")
    P, N, K = V.shape[0], V.shape[1], W.shape[1] if W.dim() == 4 else -1
    if W.shape != (P, K, 6, 3) or Wpf.shape != (P, K, 2):
        raise ValueError(f"inv3x3_wy: W [P, K, 6, 3] and Wpf [P, K, 2] must "
                         f"match V's P, got {list(W.shape)}, "
                         f"{list(Wpf.shape)}")
    if W.dtype != V.dtype or Wpf.dtype != torch.int64:
        raise TypeError(f"inv3x3_wy: W must be {V.dtype} and Wpf int64, got "
                        f"{W.dtype}, {Wpf.dtype}")
    if not (W.device == Wpf.device == V.device):
        raise ValueError("inv3x3_wy: operands on different devices")
    if not (V.is_contiguous() and W.is_contiguous() and Wpf.is_contiguous()):
        raise ValueError("inv3x3_wy: V, W and Wpf must be contiguous")
    Vinv, Y = torch.empty_like(V), torch.empty_like(W)
    _k2_launch(V, W, Wpf, Vinv, Y, P, N, K)
    return Vinv, Y


def inv3x3_sym(V: torch.Tensor) -> torch.Tensor:
    """K2 with no W entries: the inverse of every symmetric 3x3 block of V
    [..., 3, 3].

    Same contract as `inv3x3_sym_ref`, for contiguous float32 and float64
    tensors; on a CUDA tensor the fused kernel's launch with K = 0, bit-equal
    to the plain version. An empty batch launches nothing.
    """
    if V.device.type == "cpu":
        return inv3x3_sym_ref(V)
    _k2_check("inv3x3_sym", V)
    if (V.layout != torch.strided or V.dim() < 2 or V.shape[-2:] != (3, 3)
            or not V.is_contiguous()):
        raise ValueError("inv3x3_sym: V must be a contiguous [..., 3, 3] "
                         "tensor")
    out = torch.empty_like(V)
    _k2_launch(V, None, None, out, None, 1, V.numel() // 9, 0)
    return out


class SegPlan(NamedTuple):
    """One lane-stacked index list sorted for K3 (`seg_plan`); any number of
    sums over values of that list reuse it."""
    perm: torch.Tensor   # int32 [P*K]: flat entry index of each sorted position
    off: torch.Tensor    # int32 [P*(num+1) + 1]: each segment's first position
    P: int
    K: int
    num: int


def seg_plan(idx: torch.Tensor, num: int) -> SegPlan:
    """Sort the index list idx [P, K] once for K3: the flat key of entry
    (p, k) is idx[p, k] + p*(num + 1), an index outside [0, num) going to
    the lane's drop segment num (`segment.seg_sum`'s keys); one stable
    sort lists the entries segment by segment, each segment's in list
    order, and `off` holds each segment's first sorted position (integer
    work, exact in any order). The same code runs on the CPU and on the
    card."""
    if idx.is_floating_point() or idx.dim() != 2:
        raise TypeError("seg_plan: integer indices [P, K] only")
    P, K = idx.shape
    S = P * (num + 1)
    if P * K >= 2**31 or S >= 2**31:
        raise ValueError("seg_plan: more than 2**31 entries or segments")
    dev = idx.device
    key = (torch.where((idx >= 0) & (idx < num), idx, num)
           + lane_ids(P, dev) * (num + 1)).to(torch.int32).reshape(-1)
    skey, perm = torch.sort(key, stable=True)
    off = torch.searchsorted(
        skey, torch.arange(S + 1, dtype=torch.int32, device=dev),
        out_int32=True)
    return SegPlan(perm.to(torch.int32), off, P, K, num)


def seg_sum_bytes(kept: int, P: int, num: int, T: int, esz: int,
                  into: bool = False) -> int:
    """The bytes one K3 launch must move: the `kept` entries' T values and
    their int32 positions read once, the plan's P*(num + 1) + 1 offsets
    read once, the P*num output rows of T values written once (and read
    once in the accumulate-into form)."""
    rows = P * num
    return (kept * (T * esz + 4) + (P * (num + 1) + 1) * 4
            + rows * T * esz * (2 if into else 1))


def _seg_alpha(alpha) -> bool:
    """True to subtract; K3 adds (alpha 1) or subtracts (alpha -1)."""
    if alpha not in (1, -1):
        raise ValueError(f"seg_sum_fixed: alpha must be 1 or -1, got {alpha}")
    return alpha == -1


def seg_sum_fixed_ref(vals: torch.Tensor, plan: SegPlan,
                      out: torch.Tensor | None = None,
                      alpha: int = 1) -> torch.Tensor:
    """Plain version of K3: out[p, s] = base + alpha*vals[p, k0] +
    alpha*vals[p, k1] + ..., added left to right over the entries k0 < k1
    < ... whose flat key is segment s of lane p (`seg_plan`); dropped
    entries are left out. vals [P, K, *tail]; base is zero, or `out` [P,
    num, *tail] (contiguous), which then takes the result in place (the
    accumulate-into form). Returns [P, num, *tail] on vals' device.

    The plan's stable sort lists each segment's entries in list order, and
    the CPU's `index_add_` adds them one after another in that order, so
    this runs on the CPU whatever the device of its inputs (a CUDA tensor's
    values go to the CPU and the result comes back).
    """
    _seg_alpha(alpha)
    P, K, num = plan.P, plan.K, plan.num
    tail = tuple(vals.shape[2:])
    T = math.prod(tail)
    cpu = torch.device("cpu")
    off = plan.off.to(cpu, torch.int64)
    seg = torch.repeat_interleave(torch.arange(P * (num + 1)),
                                  off[1:] - off[:-1])
    lane, s = seg // (num + 1), seg % (num + 1)
    # segment s < num of lane p is output row p*num + s; drops to row P*num
    row = torch.where(s < num, lane * num + s, P * num)
    res = torch.zeros((P * num + 1, T), dtype=vals.dtype)
    if out is not None:
        res[:P * num] = out.reshape(P * num, T).to(cpu)
    v = vals.reshape(P * K, T).to(cpu)[plan.perm.to(cpu, torch.int64)]
    res.index_add_(0, row, v, alpha=alpha)
    res = res[:P * num].view((P, num) + tail)
    if out is None:
        return res.to(vals.device)
    return out.copy_(res)


def seg_sum_fixed(vals: torch.Tensor, plan: SegPlan,
                  out: torch.Tensor | None = None,
                  alpha: int = 1) -> torch.Tensor:
    """K3: the fixed-order segment sum of `seg_sum_fixed_ref`, bit-equal to
    it, from one launch on a CUDA tensor (float32 or float64; the plain
    version on the CPU). vals [P, K, *tail] contiguous and the plan on one
    device; `out` [P, num, *tail] (contiguous, vals' dtype) is the
    accumulate-into form's input and output, updated in place; else a new
    tensor from torch.empty (the kernel writes every element). The card
    takes entries of at most K3_MAX_TAIL values (prod(tail))."""
    if vals.device.type == "cpu":
        return seg_sum_fixed_ref(vals, plan, out, alpha)
    neg = _seg_alpha(alpha)
    if vals.device.type != "cuda":
        raise ValueError(f"seg_sum_fixed: no kernel for {vals.device}")
    if vals.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"seg_sum_fixed: float32/float64 only, got "
                        f"{vals.dtype}")
    P, K, num = plan.P, plan.K, plan.num
    if vals.dim() < 2 or tuple(vals.shape[:2]) != (P, K):
        raise ValueError(f"seg_sum_fixed: vals [P, K, ...] must match the "
                         f"plan's ({P}, {K}), got {list(vals.shape)}")
    if not vals.is_contiguous():
        raise ValueError("seg_sum_fixed: vals must be contiguous")
    if plan.perm.device != vals.device:
        raise ValueError("seg_sum_fixed: plan and vals on different devices")
    shape = (P, num) + tuple(vals.shape[2:])
    if out is None:
        out, base = torch.empty(shape, dtype=vals.dtype,
                                device=vals.device), None
    else:
        if (tuple(out.shape) != shape or out.dtype != vals.dtype
                or out.device != vals.device or not out.is_contiguous()):
            raise ValueError(f"seg_sum_fixed: out must be a contiguous "
                             f"{vals.dtype} {list(shape)} on {vals.device}")
        base = out
    T = math.prod(shape[2:])
    if T > K3_MAX_TAIL:
        raise ValueError(f"seg_sum_fixed: at most {K3_MAX_TAIL} values per "
                         f"entry on the card, got {T}")
    if out.numel() == 0:
        return out
    fn = _K3.get(vals.dtype)
    if fn is None:
        build()
        fn = _K3[vals.dtype]
    # one flag per row block of K3_MAX_TAIL // T rows: which blocks the
    # ring kernel sums
    flags = torch.empty(P * -(-num // (K3_MAX_TAIL // T)), dtype=torch.int8,
                        device=vals.device)
    err = fn(plan.off.data_ptr(), plan.perm.data_ptr(), vals.data_ptr(),
             None if base is None else base.data_ptr(), out.data_ptr(),
             flags.data_ptr(), P * num, num, T, int(neg),
             torch.cuda.current_stream(vals.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"seg_sum_fixed: CUDA launch failed (error {err})")
    launches["seg_sum_fixed"] += 1
    return out


def _fma32(a: torch.Tensor, b: torch.Tensor,
           c: torch.Tensor) -> torch.Tensor:
    """fma(a, b, c) of float32 tensors with one rounding to nearest, as the
    card's fmaf: a b is exact in float64; a b + c is summed there with its
    error (TwoSum) and rounded to odd (toward zero, the last bit set if
    inexact), so that the one rounding to float32 is the correct one (53 >=
    24 + 2 bits)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    # the exact sum lies strictly between s and its neighbour toward zero
    # where err and s have opposite signs (s != 0 whenever err != 0)
    trunc = torch.where((err != 0) & ((err > 0) != (s > 0)),
                        torch.nextafter(s, torch.zeros_like(s)), s)
    odd = torch.where(err != 0, (trunc.view(torch.int64) | 1).view(
        torch.float64), trunc)
    return odd.float()


def _ordered_fma(acc: torch.Tensor, base: torch.Tensor, off: torch.Tensor,
                 rank: torch.Tensor, y, w) -> None:
    """acc[base[j] + off] += y(sel)[j] . w(sel)[j] over their last axis
    (three values), as three fused multiply-adds in order (`_fma32`), for
    every j, in increasing rank: step r takes the j of rank r at once (one
    per element, so no step writes an element twice); y(sel) and w(sel)
    give the operands of the indices sel."""
    if not rank.numel():
        return
    order = torch.argsort(rank, stable=True)
    for sel in torch.split(order, torch.bincount(rank).tolist()):
        at = base[sel].view((-1,) + (1,) * off.dim()) + off
        a, ys, ws = acc[at], y(sel), w(sel)
        for k in range(3):
            a = _fma32(ys[..., k], ws[..., k], a)
        acc[at] = a


def schur_pairs_ref(S: torch.Tensor, E: torch.Tensor, W: torch.Tensor,
                    Y: torch.Tensor, eF: torch.Tensor,
                    plan: CooPlan) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4: S[p, q] -= sum_f Y[p, f] W[q, f]^T and E[p] -=
    sum_f Y[p, f] eF[f], in place, in the kernel's fixed order; returns (S,
    E).

    S [P, 6M, 6M] and E [P, 6M] (contiguous) hold A and eP on entry; W and
    Y [P, K, 6, 3], eF [P, N, 3]; `plan` is the W list's plan by (lane,
    pose, feature) over (M, N) (`schur.w_plan`), whose left-out entries
    (row < 0) contribute nothing. Block (p, q) takes, for each of row p's
    entries (p, f) in the plan's order, each entry (q, f) in the plan's
    order, into a sum from zero, acc[i, j] = fma(Y[i, 2], W[j, 2],
    fma(Y[i, 1], W[j, 1], fma(Y[i, 0], W[j, 0], acc[i, j]))), each step
    rounded once (`_fma32`); then S = A - acc, E = eP - its sum with eF[f]
    for W[j]. Runs on the device of its inputs: the pairs are listed at
    once, then each step adds the terms of one rank within their block.
    """
    P, K = W.shape[:2]
    M, N = plan.M, plan.N
    dev = S.device
    W, Y = W.reshape(P * K, 6, 3), Y.reshape(P * K, 6, 3)
    eF = eF.reshape(P * N, 3)
    rptr = plan.row_ptr.long()
    n = int(rptr[-1])                         # live entries, by row
    r = torch.repeat_interleave(torch.arange(P * M, device=dev),
                                rptr[1:] - rptr[:-1])   # folded rows l M + p
    e1 = plan.perm[:n].long()
    f = (r // M) * N + plan.scol[:n].long()   # folded features l N + f
    pos = torch.arange(n, device=dev)
    six = torch.arange(6, device=dev)
    # block row p of lane l is row 6 (l M + p) = 6 r of the stack
    acc = torch.zeros_like(E)
    _ordered_fma(acc.view(-1), 6 * r, six, pos - rptr[r],
                 lambda sel: Y[e1[sel]], lambda sel: eF[f[sel]][:, None, :])
    E.sub_(acc)
    # the entries of each feature, by pose, then in list order (a stable
    # sort of the row-ordered entries); every pair (row entry, entry of its
    # feature) in the order (row position, feature position), and its rank
    # within its block (p, q)
    by_f = torch.argsort(f, stable=True)
    cptr = torch.searchsorted(f[by_f], torch.arange(P * N + 1, device=dev))
    c0 = cptr[f]
    cnt = cptr[f + 1] - c0
    src = torch.repeat_interleave(cnt)
    i = torch.arange(src.numel(), device=dev)
    other = by_f[c0[src] + i - (torch.cumsum(cnt, 0) - cnt)[src]]
    q = r[other] % M
    skey, order = torch.sort(r[src] * M + q, stable=True)
    rank = torch.empty_like(order)
    rank[order] = i - torch.searchsorted(skey, skey)
    d = 6 * M
    acc = torch.zeros_like(S)   # A - 0 leaves an untouched element as it is
    _ordered_fma(acc.view(-1), 6 * r[src] * d + 6 * q,
                 six[:, None] * d + six, rank,
                 lambda sel: Y[e1[src[sel]]][:, :, None, :],
                 lambda sel: W[e1[other[sel]]][:, None, :, :])
    S.sub_(acc)
    return S, E


def schur_pairs(S: torch.Tensor, E: torch.Tensor, W: torch.Tensor,
                Y: torch.Tensor, eF: torch.Tensor,
                plan: CooPlan) -> tuple[torch.Tensor, torch.Tensor]:
    """K4: `schur_pairs_ref`'s update of S and E, in place, bit-equal to it,
    from one launch on CUDA tensors (the plain version on the CPU).

    float32 only (the refine preconditioner): S [P, 6M, 6M], E [P, 6M], W
    and Y [P, K, 6, 3], eF [P, N, 3], all contiguous on one device, and the
    W list's plan built there (`schur.w_plan`). Returns (S, E)."""
    if S.device.type == "cpu":
        return schur_pairs_ref(S, E, W, Y, eF, plan)
    if S.device.type != "cuda":
        raise ValueError(f"schur_pairs: no kernel for {S.device}")
    ops = (S, E, W, Y, eF)
    if any(t.dtype != torch.float32 for t in ops):
        raise TypeError("schur_pairs: float32 only, got "
                        f"{[str(t.dtype) for t in ops]}")
    P, K = W.shape[:2]
    M, N = plan.M, plan.N
    shapes = ((P, 6 * M, 6 * M), (P, 6 * M), (P, K, 6, 3), (P, K, 6, 3),
              (P, N, 3))
    if [tuple(t.shape) for t in ops] != list(shapes):
        raise ValueError(f"schur_pairs: want S, E, W, Y, eF of shapes "
                         f"{list(shapes)}, got {[list(t.shape) for t in ops]}")
    if plan.rows.shape != (P, K):
        raise ValueError("schur_pairs: the plan must be of the [P, K] list")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("schur_pairs: S, E, W, Y and eF must be contiguous")
    if any(t.device != S.device for t in ops + (plan.perm,)):
        raise ValueError("schur_pairs: operands on different devices")
    if any(t.data_ptr() % 8 for t in (S, W, Y)):
        raise ValueError("schur_pairs: S, W and Y must be 8-byte aligned")
    if P * M == 0:
        return S, E
    build()
    err = _lib.schur_pairs_f32(
        S.data_ptr(), E.data_ptr(), W.data_ptr(), Y.data_ptr(),
        eF.data_ptr(), plan.row_ptr.data_ptr(), plan.perm.data_ptr(),
        plan.scol.data_ptr(), P, M, N,
        torch.cuda.current_stream(S.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"schur_pairs: CUDA launch failed (error {err})")
    launches["schur_pairs"] += 1
    return S, E


def add_chain(x: torch.Tensor, n: int) -> torch.Tensor:
    """The chain-floor probe beside K3 (no kernel of the port, not counted
    in `launches`): one thread on the card adds x[1] to x[0] n times (n a
    multiple of 8), each add waiting for the last, in x's dtype (float32 or
    float64) and with K3's add; returns the sum [1]. Its time over n is the
    card's dependent add latency, which times K3's longest segment bounds
    a launch from below."""
    if (x.device.type != "cuda" or x.shape != (2,)
            or x.dtype not in (torch.float32, torch.float64)):
        raise ValueError("add_chain: a float32/float64 [2] CUDA tensor")
    build()
    out = torch.empty(1, dtype=x.dtype, device=x.device)
    err = _CHAIN[x.dtype](x.data_ptr(), out.data_ptr(), n,
                          torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"add_chain: CUDA launch failed (error {err})")
    return out


class _GcArgs(ctypes.Structure):
    """K5's arguments, the layout of `GcArgs` in csrc/gauge_congruence.cu."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "pose_ids", "poses", "feats", "U", "Uij", "W", "Wpf", "V", "ref",
        "scap", "fix", "new_ref", "new_scap", "new_fix", "ids_out",
        "poses_out", "feats_out", "U_out", "Uij_out", "W_out", "Wpf_out",
        "V_out", "sign_out", "scratch", "keys", "skeys", "perm")] + [
        (n, ctypes.c_int64) for n in ("P", "M", "N", "KU", "KW", "mono",
                                      "f32")]


def gauge_congruence_bytes(P: int, M: int, N: int, KU: int, KW: int,
                           mono: bool, esz: int) -> int:
    """The bytes one K5 call must move: the state, the block lists and
    their indices read once, the new state, lists and indices written once
    (esz: the information dtype's size; states and indices are 8 bytes)."""
    XU, XW = (2 * M + 3, 2 * N) if mono else (M + 1, N)
    state = P * (M * 6 + N * 3) * 8
    lists = P * ((KU * 36 + KW * 18 + N * 9) * esz + (KU + KW) * 16)
    new = P * (((KU + XU) * 36 + (KW + XW) * 18 + N * 9) * esz
               + (KU + XU + KW + XW) * 16)
    return 2 * state + lists + new + (0 if mono else 2 * P * M * 8)


def _k5_check(lm: types.LocalMap, mono: bool, new: tuple,
              idt: torch.dtype):
    """Raise unless `lm` and the new gauge ids are K5's inputs: one CUDA
    device, float64 state, float32/float64 information, int64 indices,
    the LocalMap shapes, contiguous."""
    name = f"gauge_congruence ({'mono' if mono else 'stereo'})"
    dev = lm.poses.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for {dev}")
    g = lm.gauge
    ints = [lm.pose_ids, lm.Uij, lm.Wpf, g.ref, *new]
    if mono:
        ints += [g.scap, g.fix]
    floats = [lm.U, lm.W, lm.V]
    every = [lm.poses, lm.feats, *floats, *ints]
    if any(not isinstance(t, torch.Tensor) or t.device != dev
           for t in every):
        raise ValueError(f"{name}: every input must be a tensor on {dev}")
    if lm.poses.dtype != torch.float64 or lm.feats.dtype != torch.float64:
        raise TypeError(f"{name}: float64 states only, got "
                        f"{lm.poses.dtype}, {lm.feats.dtype}")
    if idt not in (torch.float32, torch.float64) or any(
            t.dtype not in (torch.float32, torch.float64) for t in floats):
        raise TypeError(f"{name}: float32/float64 information only")
    if any(t.dtype != torch.int64 for t in ints):
        raise TypeError(f"{name}: int64 ids and block indices only")
    P, M, N = lm.poses.shape[0], lm.M, lm.N
    KU, KW = lm.KU, lm.KW
    shapes = {"pose_ids": (P, M), "poses": (P, M, 6), "feats": (P, N, 3),
              "U": (P, KU, 6, 6), "Uij": (P, KU, 2), "W": (P, KW, 6, 3),
              "Wpf": (P, KW, 2), "V": (P, N, 3, 3)}
    for f, want in shapes.items():
        if tuple(getattr(lm, f).shape) != want:
            raise ValueError(f"{name}: {f} must be {list(want)}, got "
                             f"{list(getattr(lm, f).shape)}")
    if any(tuple(t.shape) != (P,) for t in ints[3:]):
        raise ValueError(f"{name}: gauge ids must be [P] = [{P}]")
    if not all(t.is_contiguous() for t in every):
        raise ValueError(f"{name}: every input must be contiguous")


def _k5_launch(lm: types.LocalMap, mono: bool, new: tuple,
               idt: torch.dtype, lib, stream) -> dict:
    """K5's launches (through `lib`, on `stream`) and its sort; returns
    the new state and lists by the LocalMap field names, and the mono
    sign."""
    P, M, N, KU, KW = lm.poses.shape[0], lm.M, lm.N, lm.KU, lm.KW
    dev = lm.poses.device
    XU, XW = (2 * M + 3, 2 * N) if mono else (M + 1, N)
    U, W, V = (t if t.dtype == idt else t.to(idt) for t in (lm.U, lm.W,
                                                             lm.V))
    i64 = dict(dtype=torch.int64, device=dev)
    out = dict(
        poses=torch.empty_like(lm.poses), feats=torch.empty_like(lm.feats),
        U=torch.empty((P, KU + XU, 6, 6), dtype=idt, device=dev),
        Uij=torch.empty((P, KU + XU, 2), **i64),
        W=torch.empty((P, KW + XW, 6, 3), dtype=idt, device=dev),
        Wpf=torch.empty((P, KW + XW, 2), **i64),
        V=torch.empty_like(V))
    if mono:
        out["sign"] = torch.empty(P, **i64)
    else:
        out["pose_ids"] = torch.empty_like(lm.pose_ids)
    if P == 0:
        return out
    keys = torch.empty(P * (2 * KU + 2 * KW), dtype=torch.int32, device=dev)
    g = lm.gauge
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    a = _GcArgs(
        ptr(lm.pose_ids), ptr(lm.poses), ptr(lm.feats), ptr(U), ptr(lm.Uij),
        ptr(W), ptr(lm.Wpf), ptr(V), ptr(g.ref),
        ptr(g.scap) if mono else None, ptr(g.fix) if mono else None,
        ptr(new[0]), ptr(new[1]) if mono else None,
        ptr(new[2]) if mono else None, ptr(out.get("pose_ids")),
        ptr(out["poses"]), ptr(out["feats"]), ptr(out["U"]),
        ptr(out["Uij"]), ptr(out["W"]), ptr(out["Wpf"]), ptr(out["V"]),
        ptr(out.get("sign")), None, ptr(keys), None, None,
        P, M, N, KU, KW, int(mono), int(idt == torch.float32))
    nbytes = lib.gauge_congruence_scratch(ctypes.byref(a))
    if nbytes < 0:
        raise ValueError(f"gauge_congruence: sizes (P, M, N, KU, KW) = "
                         f"{(P, M, N, KU, KW)} out of the kernel's range")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    a.scratch = scratch.data_ptr()
    err = lib.gauge_congruence_a(ctypes.byref(a), stream)
    if err != 0:
        raise RuntimeError(f"gauge_congruence: CUDA launch failed (error "
                           f"{err})")
    # each emission term's (lane, segment), in list order within a segment
    skeys, perm = torch.sort(keys, stable=True)
    a.skeys, a.perm = skeys.data_ptr(), perm.data_ptr()
    err = lib.gauge_congruence_b(ctypes.byref(a), stream)
    if err != 0:
        raise RuntimeError(f"gauge_congruence: CUDA launch failed (error "
                           f"{err})")
    return out


def gauge_congruence(lm: types.LocalMap, mono: bool, new: tuple,
                     info_dtype=None) -> types.LocalMap:
    """K5: `congruence.transform_map_stereo_ref`'s (`mono` False, `new` =
    (new_ref_id,)) or `transform_map_mono_ref`'s (`mono` True, `new` =
    (new_ref_id, new_scap_id, new_fix)) transform of every lane of the
    CUDA map `lm` and its congruence, from six launches and one sort. The
    Jacobians come from dual numbers, not jacfwd, and the sums run in
    another fixed order: the result equals the plain version's to
    rounding, and two calls give the same bits. A pinned coordinate
    `new_fix[p]` outside 0-2, which the plain version refuses, gives NaN
    states in lane p (checking it would cost a sync a call).

    float64 state, float32/float64 information (cast to `info_dtype`, the
    products' dtype, as the plain version does), int64 indices and ids
    [P], all contiguous on one CUDA device; anything else raises."""
    idt = types.as_dtype(info_dtype) or lm.U.dtype
    _k5_check(lm, mono, new, idt)
    dev = lm.poses.device
    out = _k5_launch(lm, mono, new, idt, build(),
                     torch.cuda.current_stream(dev).cuda_stream)
    launches["gauge_congruence"] += 1
    P = lm.poses.shape[0]
    count = lambda k: torch.full((P,), k, dtype=types.INDEX,  # noqa: E731
                                 device=dev)
    sign = out.pop("sign", None)
    gauge = (dataclasses.replace(lm.gauge, ref=new[0], scap=new[1],
                                 fix=new[2], sign=sign) if mono
             else dataclasses.replace(lm.gauge, ref=new[0]))
    return dataclasses.replace(lm, **out, n_U=count(out["U"].shape[1]),
                               n_W=count(out["W"].shape[1]), gauge=gauge)

