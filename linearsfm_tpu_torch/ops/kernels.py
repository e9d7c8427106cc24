"""Hand-written GPU kernels of the port, their plain versions and their build.

K1 `blockcoo_to_dense` replaces the TPU kernel
`linearsfm_tpu/ops/pallas_kernels.py:blockcoo_to_dense`; its CUDA source is
`csrc/blockcoo_dense.cu` (design and bounds are noted there). It is built
with nvcc for sm_90a into a shared library with a plain C interface, at first
use, into `_build/` beside the package, and bound with ctypes.

Dispatch: a tensor on the CPU takes the plain PyTorch version; a CUDA tensor
launches the kernel or raises. `launches` counts kernel launches, and only
those, so a run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess

import torch

from .segment import lane_ids

launches = {"blockcoo_to_dense": 0}

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "blockcoo_dense.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
_lib: ctypes.CDLL | None = None   # loaded once per process


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "linearsfm_tpu_torch/csrc at first use")


def build() -> ctypes.CDLL:
    """Compile the kernel library (once per source content) and load it."""
    global _lib
    if _lib is not None:
        return _lib
    with open(SOURCE, "rb") as fh:
        tag = hashlib.sha256(fh.read()).hexdigest()[:12]
    so = os.path.join(BUILD_DIR, f"libblockcoo_dense_{tag}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    for fn in (lib.blockcoo_dense_f32, lib.blockcoo_dense_f64):
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_int64,
                                               ctypes.c_void_p]
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


def blockcoo_to_dense(rows: torch.Tensor, cols: torch.Tensor,
                      vals: torch.Tensor, M: int, N: int) -> torch.Tensor:
    """K1: dense [..., R*M, C*N] from block-COO lists (scatter-add).

    Same contract as `blockcoo_to_dense_ref`, for float32 (the main path)
    and float64 values. On a CUDA tensor each lane's rows are folded into one
    tall matrix (row + lane*M; skipped entries stay out) and the CUDA kernel
    writes it in one launch.
    """
    if vals.device.type == "cpu":
        return blockcoo_to_dense_ref(rows, cols, vals, M, N)
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
    if rows.shape != vals.shape[:-2] or cols.shape != rows.shape:
        raise ValueError("blockcoo_to_dense: rows/cols must match vals[..., K]")
    if rows.is_floating_point() or cols.is_floating_point():
        raise TypeError("blockcoo_to_dense: integer block coordinates only")
    if rows.device != vals.device or cols.device != vals.device:
        raise ValueError("blockcoo_to_dense: operands on different devices")
    lead = rows.shape[:-1]
    P = math.prod(lead)
    rows2 = rows.reshape(P, K).to(torch.int64)
    cols2 = cols.reshape(P, K).to(torch.int64)
    out = torch.zeros((P * R * M, C * N), dtype=vals.dtype,
                      device=vals.device)
    if K == 0 or P == 0 or M == 0 or N == 0:
        return out.view(lead + (R * M, C * N))
    ok = _valid(rows2, cols2, M, N)
    frow = torch.where(ok, rows2 + lane_ids(P, vals.device) * M, -1)
    srt, perm = torch.sort(frow.reshape(-1), stable=True)
    row_ptr = torch.searchsorted(
        srt, torch.arange(P * M + 1, device=vals.device, dtype=torch.int64))
    cols_flat = cols2.reshape(-1).contiguous()
    lib = build()
    fn = (lib.blockcoo_dense_f32 if vals.dtype == torch.float32
          else lib.blockcoo_dense_f64)
    err = fn(
        row_ptr.data_ptr(), perm.data_ptr(), cols_flat.data_ptr(),
        vals.data_ptr(), out.data_ptr(), P * M, R, C, C * N,
        torch.cuda.current_stream(vals.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"blockcoo_to_dense: CUDA launch failed (error {err})")
    launches["blockcoo_to_dense"] += 1
    return out.view(lead + (R * M, C * N))
