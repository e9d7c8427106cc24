"""The least bytes of one K1 and one K3 launch against hand counts, and
the traced run's recording of them on plans built on the CPU."""

import torch

from benchmark import roofline, trace


def test_k1_bytes_hand_count():
    # 5 entries of 6x3 float32 blocks in the window, 4 lanes x 10 block
    # rows, a window 7 block columns wide:
    # values 5*18*4 = 360, indices 5*8 = 40, offsets 41*4 = 164,
    # output 40 rows * 6 * 7 cols * 3 * 4 = 20160
    assert roofline.k1_bytes(5, 40, 6, 3, 7, 4) == 360 + 40 + 164 + 20160


def test_k3_bytes_hand_count():
    # 9 kept entries of 36 float64 values, 2 lanes of 5 segments:
    # values 9*36*8 = 2592, positions 9*4 = 36, offsets (2*6+1)*4 = 52,
    # output 10*36*8 = 2880 (twice in the accumulate-into form)
    assert roofline.k3_bytes(9, 2, 5, 36, 8) == 2592 + 36 + 52 + 2880
    assert roofline.k3_bytes(9, 2, 5, 36, 8, into=True) == (
        2592 + 36 + 52 + 2 * 2880)


def test_k3_bytes_is_the_ports_count():
    from linearsfm_tpu_torch.ops import kernels
    for args in ((0, 1, 1, 1, 4), (123, 7, 33, 18, 8), (5, 2, 9, 36, 4)):
        for into in (False, True):
            assert roofline.k3_bytes(*args, into) == kernels.seg_sum_bytes(
                *args, into)


class _Solver:
    pass


def test_recorder_counts_entries_in_the_window():
    from linearsfm_tpu_torch.ops import kernels
    rec = trace.Recorder(_Solver())
    # one lane, M = 3 block rows, N = 6 block columns; one entry padded
    rows = torch.tensor([[0, 2, 1, -1, 2, 0]])
    cols = torch.tensor([[5, 1, 3, 0, 2, 4]])
    plan = kernels.coo_plan(rows, cols, 3, 6)
    # the window [2, 5): columns 3, 2 and 4 -> 3 entries
    rec.k1.append((plan, 6, 3, 2, 3, 8))
    idx = torch.tensor([[0, 3, 3, -1, 1, 7], [2, 2, 0, 0, 9, 1]])
    splan = kernels.seg_plan(idx, 4)
    # kept: entries with 0 <= idx < 4: 4 in lane 0, 5 in lane 1
    rec.k3.append((splan, 6, 4, False))
    k1, k3 = rec.take_bytes()
    assert k1 == [roofline.k1_bytes(3, 3, 6, 3, 3, 8)]
    assert k3 == [roofline.k3_bytes(9, 2, 4, 6, 4)]
    assert rec.take_bytes() == ([], [])


def test_record_counts_and_lost_records():
    ev = [
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1,
         "args": {"correlation": 1}},
        {"cat": "cuda_runtime", "name": "cudaMemsetAsync", "ts": 2,
         "args": {"correlation": 2}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 9,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 3, "dur": 1,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 10, "dur": 1,
         "args": {"correlation": 3}},
    ]
    assert trace.record_counts(ev) == (3, 2)
    assert trace.record_counts(ev, start=5) == (1, 1)
    trace.require_records(ev, "x", start=5)
    try:
        trace.require_records(ev, "x")
    except trace.LostRecords as exc:
        assert "3 kernel launches" in str(exc)
    else:
        raise AssertionError("lost records not caught")


def test_reduce_session_busy_gaps_and_kernels():
    ev = [
        {"cat": "user_annotation", "ph": "X", "name": "solve", "ts": 100,
         "dur": 100},
        {"cat": "user_annotation", "ph": "X", "name": "ingest_plan",
         "ts": 100, "dur": 40},
        {"cat": "user_annotation", "ph": "X", "name": "levels", "ts": 140,
         "dur": 55},
        {"ph": "X", "cat": "kernel", "name": "blockcoo_dense_kernel",
         "ts": 150, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "seg_sum_direct<double>",
         "ts": 155, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 180,
         "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "before", "ts": 50, "dur": 5},
    ]
    r = trace.reduce_session(ev, 100)
    assert abs(r["wall_s"] - 100e-6) < 1e-12
    assert abs(r["busy_s"] - 20e-6) < 1e-12      # [150, 165] and [180, 185]
    assert abs(r["k1_s"] - 10e-6) < 1e-12 and abs(r["k3_s"] - 10e-6) < 1e-12
    assert r["k1_launches"] == 1
    gaps = sorted(r["gaps"], key=lambda g: -g[1])
    # [100, 150): middle 125 in ingest_plan; [165, 180) in levels;
    # [185, 200): middle 192.5 in levels
    assert gaps[0][0] == "ingest_plan" and abs(gaps[0][1] - 50e-6) < 1e-12
    assert [g[0] for g in gaps[1:]] == ["levels", "levels"]
