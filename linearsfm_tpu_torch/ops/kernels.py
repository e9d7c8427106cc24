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
once for it.

All sources are compiled with nvcc for sm_90a (one process per source, all
started together) and linked into one shared library with a plain C
interface, at first use, into `_build/` beside the package, and bound with
ctypes.

Dispatch: a tensor on the CPU takes the plain PyTorch version; a CUDA tensor
launches the kernel or raises. `launches` counts kernel launches, and only
those, so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from typing import NamedTuple

import torch

from .segment import lane_ids, take

launches = {"blockcoo_to_dense": 0, "inv3x3_sym": 0, "seg_sum_fixed": 0}

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = tuple(sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cu"))))
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
_lib: ctypes.CDLL | None = None   # loaded once per process
_K2: dict = {}   # torch dtype -> K2's bound ctypes function, set by build()
_K3: dict = {}   # torch dtype -> K3's bound ctypes function, set by build()


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
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 3 + [
            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _K3[dtype] = fn
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
    tensor from torch.empty (the kernel writes every element)."""
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
    if out.numel() == 0:
        return out
    fn = _K3.get(vals.dtype)
    if fn is None:
        build()
        fn = _K3[vals.dtype]
    err = fn(plan.off.data_ptr(), plan.perm.data_ptr(), vals.data_ptr(),
             None if base is None else base.data_ptr(), out.data_ptr(),
             P * num, num, T, int(neg),
             torch.cuda.current_stream(vals.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"seg_sum_fixed: CUDA launch failed (error {err})")
    launches["seg_sum_fixed"] += 1
    return out
