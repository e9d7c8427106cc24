"""The port's fixed-order segment sum (`ops/segment`, kernel K3 in
`ops/kernels`) against the CPU's `index_add_` and the JAX package's
`jax.ops.segment_sum`.

The inputs are made from seeded numpy generators. On the CPU `index_add_`
adds each segment's values sequentially in list order, and so does K3's
plain version (`seg_sum_fixed_ref`): the two must be `torch.equal`, in
float32 and float64. The `cuda` test holds the kernel against the plain
version on the card (it skips here). JAX is imported inside its one test,
so the file also runs on a machine without JAX (`--noconftest -m cuda`).
"""

import os

import numpy as np
import pytest
import torch

from linearsfm_tpu_torch.ops import kernels, segment

# one intra-op thread: the suite's workers share the machine's cores, and
# an oversubscribed thread pool slows the trees' small ops many times over
torch.set_num_threads(1)

TAILS = [(), (3,), (6,), (6, 3), (3, 3), (6, 6)]
DTYPES = [torch.float32, torch.float64]


def _case(seed, P, K, num, tail, dtype, lo=-3, hi=None):
    """(vals [P, K, *tail], idx [P, K]) with indices in [lo, hi): the
    default range holds dropped indices on both sides, and a small K
    leaves segments empty."""
    g = np.random.default_rng(seed)
    hi = num + 3 if hi is None else hi
    idx = torch.tensor(g.integers(lo, hi, size=(P, K)))
    vals = torch.tensor(g.standard_normal((P, K) + tail)).to(dtype)
    return vals, idx


def _index_add(vals, idx, num, base=None, alpha=1):
    """The CPU's `index_add_` on flat keys, dropped entries to a spare row,
    into zeros or a copy of `base` [P, num, *tail]."""
    P, tail = idx.shape[0], tuple(vals.shape[2:])
    ok = (idx >= 0) & (idx < num)
    flat = torch.where(ok, idx + torch.arange(P)[:, None] * num, P * num)
    out = vals.new_zeros((P * num + 1,) + tail)
    if base is not None:
        out[:P * num] = base.reshape((P * num,) + tail)
    out.index_add_(0, flat.reshape(-1), vals.reshape((-1,) + tail),
                   alpha=alpha)
    return out[:P * num].view((P, num) + tail)


def _long_segments(seed, tail, dtype, n=2017, num=7):
    """(vals, idx, num): three lanes whose long segments (n entries, more
    than several of K3's shared-memory stages and no multiple of 32) lie at
    a lane's start (lane 0, segment 0), at its end (lane 1, segment num -
    1) and at both (lane 2), among 300 entries of random index per lane
    (dropped ones too), all in shuffled list order."""
    g = np.random.default_rng(seed)
    lanes = []
    for segs in ([0], [num - 1], [0, num - 1]):
        i = np.concatenate([np.full(n, s) for s in segs]
                           + [g.integers(-3, num + 3, 300)])
        i = np.concatenate([i, np.full(2 * n - len(i) + 300, num + 1)])
        lanes.append(g.permutation(i))
    idx = torch.tensor(np.stack(lanes))
    vals = torch.tensor(g.standard_normal(idx.shape + tail)).to(dtype)
    return vals, idx, num


def _cases(dtype, tail):
    """Named (vals, idx, num): lane-folded with dropped and negative
    indices, empty segments, K = 0, every index dropped, one long run of
    equal keys, unsorted keys on a wide segment range, and long segments at
    the start and the end of lanes (`_long_segments`)."""
    g = np.random.default_rng(7)
    long_idx = torch.full((2, 300), 4, dtype=torch.int64)
    long_idx[1, ::7] = 2
    return {
        "lane-folded, dropped": (*_case(1, 4, 120, 9, tail, dtype), 9),
        "empty segments": (*_case(2, 3, 5, 40, tail, dtype), 40),
        "K = 0": (*_case(3, 2, 0, 6, tail, dtype), 6),
        "all dropped": (*_case(4, 2, 50, 5, tail, dtype, lo=5, hi=12), 5),
        "one long run": (torch.tensor(g.standard_normal(
            (2, 300) + tail)).to(dtype), long_idx, 6),
        "unsorted, wide": (*_case(5, 1, 2000, 700, tail, dtype), 700),
        "long segments at lane ends": _long_segments(13, tail, dtype),
    }


def _special(dtype, tail, subnormals=True):
    """(vals, idx, num, base): values with NaN, +-inf, subnormals (unless
    `subnormals` is False) and signed zeros among normal ones, and a base
    for the accumulate-into form whose every other element is -0.0 (some
    of its segments empty)."""
    g = np.random.default_rng(17)
    P, K, num = 2, 900, 300
    idx = torch.tensor(g.integers(-2, num + 2, (P, K)))
    tiny = np.finfo(np.float32 if dtype == torch.float32 else np.float64
                    ).smallest_subnormal
    if not subnormals:
        tiny = 1.0
    pool = np.array([np.nan, np.inf, -np.inf, tiny, -tiny, 3 * tiny, 0.0,
                     -0.0])
    v = g.standard_normal((P, K) + tail)
    pick = g.random(v.shape)
    v = np.where(pick < 0.1, g.choice(pool, v.shape), v)
    vals = torch.tensor(v).to(dtype)
    base = torch.tensor(g.standard_normal((P, num) + tail)).to(dtype)
    base.view(-1)[::2] = -0.0
    return vals, idx, num, base


def _same_bits(a, b):
    """True where a and b are bit for bit equal, NaN against NaN whatever
    its payload (the card's NaN need not carry the CPU's): the same NaN
    places and the same bits (signed zeros, subnormals, infinities)
    everywhere else."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    na, nb = torch.isnan(a), torch.isnan(b)
    ints = torch.int32 if a.dtype == torch.float32 else torch.int64
    return bool(torch.equal(na, nb) and torch.equal(
        a.masked_fill(na, 0).view(ints), b.masked_fill(nb, 0).view(ints)))


@pytest.mark.parametrize("tail", TAILS, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_fixed_sum_plain_equals_cpu_index_add(dtype, tail):
    """K3's plain version is `torch.equal` to the CPU's `index_add_` and to
    `seg_sum` (unchanged on the CPU, in and out of the scope) in every
    case; so is the accumulate-into form with alpha = -1 (`index_add`'s
    form, as `schur.subtract_pairs` uses it) against `index_add_`."""
    before = dict(kernels.launches)
    for name, (vals, idx, num) in _cases(dtype, tail).items():
        plan = kernels.seg_plan(idx, num)
        got = kernels.seg_sum_fixed_ref(vals, plan)
        assert torch.equal(got, _index_add(vals, idx, num)), name
        assert torch.equal(got, segment.seg_sum(vals, idx, num)), name
        with segment.deterministic():
            assert torch.equal(got, segment.seg_sum(vals, idx, num)), name
        assert torch.equal(kernels.seg_sum_fixed(vals, plan), got), name
        base = torch.tensor(np.random.default_rng(9).standard_normal(
            (idx.shape[0], num) + tail)).to(dtype)
        want = _index_add(vals, idx, num, base, alpha=-1)
        into = base.clone()
        assert kernels.seg_sum_fixed_ref(vals, plan, out=into,
                                         alpha=-1) is into
        assert torch.equal(into, want), name
    # the flat accumulate-into form on a kept index list
    vals, idx = _case(6, 1, 400, 30, tail, dtype, lo=0, hi=30)
    base = torch.tensor(np.random.default_rng(8).standard_normal(
        (30,) + tail)).to(dtype)
    want = base.clone().index_add_(0, idx[0], vals[0], alpha=-1)
    got = kernels.seg_sum_fixed_ref(vals, kernels.seg_plan(idx, 30),
                                    out=base.clone()[None], alpha=-1)
    assert torch.equal(got[0], want)
    with segment.deterministic():
        got = segment.index_add(base.clone(), idx[0], vals[0], alpha=-1)
    assert torch.equal(got, want)
    assert kernels.launches == before        # the CPU launches nothing


@pytest.mark.parametrize("tail", [(), (6, 3), (6, 6)], ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_fixed_sum_special_values(dtype, tail):
    """NaN, +-inf, subnormals and signed zeros: K3's plain version is bit
    for bit the CPU's `index_add_` (NaN where it has NaN), as a new sum and
    accumulate-into with alpha = -1 on a base of -0.0s."""
    vals, idx, num, base = _special(dtype, tail)
    plan = kernels.seg_plan(idx, num)
    got = kernels.seg_sum_fixed_ref(vals, plan)
    assert _same_bits(got, _index_add(vals, idx, num))
    assert torch.isnan(got).any() and torch.isinf(got).any()
    into = kernels.seg_sum_fixed_ref(vals, plan, out=base.clone(), alpha=-1)
    assert _same_bits(into, _index_add(vals, idx, num, base, alpha=-1))
    # empty segments keep their -0.0
    assert (torch.signbit(into) & (into == 0)).any()


def test_fixed_sum_matches_jax_segment_sum():
    """Float64, against `jax.ops.segment_sum` per lane on the same numpy
    inputs (dropped and negative indices, empty segments, long segments at
    lane ends, every tail; NaN, +-inf and signed zeros): tolerance 0.
    XLA's CPU scatter adds each segment's values in list order too, and the
    two agree bit for bit."""
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_enable_x64", True)
    for tail in TAILS:
        for name, (vals, idx, num) in _cases(torch.float64, tail).items():
            got = kernels.seg_sum_fixed_ref(vals, kernels.seg_plan(idx,
                                                                   num))
            want = jax.vmap(lambda v, i: jax.ops.segment_sum(
                v, i, num_segments=num))(jnp.asarray(vals.numpy()),
                                         jnp.asarray(idx.numpy()))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"{tail} {name}")
        # XLA's CPU backend flushes subnormal sums to zero, index_add_ and
        # the card keep them (test_fixed_sum_special_values): no subnormals
        vals, idx, num, _ = _special(torch.float64, tail, subnormals=False)
        got = kernels.seg_sum_fixed_ref(vals, kernels.seg_plan(idx, num))
        want = jax.vmap(lambda v, i: jax.ops.segment_sum(
            v, i, num_segments=num))(jnp.asarray(vals.numpy()),
                                     jnp.asarray(idx.numpy()))
        assert _same_bits(got, torch.tensor(np.asarray(want))), tail


def test_reused_plan_equals_fresh_plan():
    """One `SegPlan` summed over several value tensors, in both forms,
    gives what a fresh plan of the same list gives each time, and two
    plans of one list are equal (the plan is a function of the list and
    the segment count alone)."""
    vals, idx = _case(11, 3, 90, 12, (6,), torch.float64)
    plan = kernels.seg_plan(idx, 12)
    base = torch.tensor(np.random.default_rng(12).standard_normal(
        (3, 12, 6)))
    for k in range(3):
        v = vals * (k + 1)
        fresh = kernels.seg_plan(idx, 12)
        assert torch.equal(fresh.perm, plan.perm)
        assert torch.equal(fresh.off, plan.off)
        assert torch.equal(kernels.seg_sum_fixed(v, plan),
                           kernels.seg_sum_fixed(v, fresh))
        assert torch.equal(
            kernels.seg_sum_fixed(v, plan, out=base.clone(), alpha=-1),
            kernels.seg_sum_fixed(v, fresh, out=base.clone(), alpha=-1))


def test_scope_leaves_pytorch_mode_alone(monkeypatch):
    """`deterministic()` marks the fixed-order scope and sets
    CUBLAS_WORKSPACE_CONFIG for it; it no longer switches on PyTorch's
    global deterministic mode, and it restores what it found."""
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    mode = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    assert not segment._fixed
    with segment.deterministic():
        assert segment._fixed
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
        assert (torch.are_deterministic_algorithms_enabled(),
                torch.is_deterministic_algorithms_warn_only_enabled()
                ) == mode
    assert not segment._fixed
    assert "CUBLAS_WORKSPACE_CONFIG" not in os.environ
    with pytest.raises(ValueError, match="alpha"):
        kernels.seg_sum_fixed_ref(*_case(1, 1, 3, 2, (), torch.float64)[:1],
                                  kernels.seg_plan(torch.zeros(
                                      (1, 3), dtype=torch.int64), 2),
                                  alpha=2)
    meta = torch.empty((1, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        kernels.seg_sum_fixed(meta, kernels.SegPlan(
            torch.empty(3, dtype=torch.int32, device="meta"),
            torch.empty(4, dtype=torch.int32, device="meta"), 1, 3, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_kernel_matches_plain_on_cuda(dtype):
    """On the card K3 is `torch.equal` to its plain version in every case
    and tail (the special values bit for bit, NaN where the plain version
    has NaN), in both forms, one launch per call, and to the CPU's
    `index_add_` on the raw index list (which shares no sort or offsets
    with the card's plan); `seg_sum` and `index_add` launch it inside
    `deterministic()` and only there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for tail in TAILS:
        for name, (vals, idx, num) in _cases(dtype, tail).items():
            vals, idx = vals.cuda(), idx.cuda()
            plan = kernels.seg_plan(idx, num)
            n0 = kernels.launches["seg_sum_fixed"]
            got = kernels.seg_sum_fixed(vals, plan)
            assert kernels.launches["seg_sum_fixed"] == n0 + (
                got.numel() > 0)
            assert torch.equal(got, kernels.seg_sum_fixed_ref(vals, plan)), (
                tail, name)
            assert torch.equal(got.cpu(), _index_add(vals.cpu(), idx.cpu(),
                                                     num)), (tail, name)
            base = torch.randn((idx.shape[0], num) + tail, dtype=dtype,
                               device="cuda")
            into = base.clone()
            kernels.seg_sum_fixed(vals, plan, out=into, alpha=-1)
            assert torch.equal(into, kernels.seg_sum_fixed_ref(
                vals, plan, out=base.clone(), alpha=-1)), (tail, name)
            assert torch.equal(into.cpu(), _index_add(
                vals.cpu(), idx.cpu(), num, base.cpu(), alpha=-1)), (
                tail, name)
            n0 = kernels.launches["seg_sum_fixed"]
            segment.seg_sum(vals, idx, num)
            assert kernels.launches["seg_sum_fixed"] == n0
            with segment.deterministic():
                assert torch.equal(segment.seg_sum(vals, idx, num), got)
            assert kernels.launches["seg_sum_fixed"] == n0 + (
                got.numel() > 0)
        vals, idx, num, base = _special(dtype, tail)
        vals, idx, base = vals.cuda(), idx.cuda(), base.cuda()
        plan = kernels.seg_plan(idx, num)
        got = kernels.seg_sum_fixed(vals, plan)
        assert _same_bits(got, kernels.seg_sum_fixed_ref(vals, plan)), tail
        assert _same_bits(got.cpu(), _index_add(vals.cpu(), idx.cpu(),
                                                num)), tail
        into = kernels.seg_sum_fixed(vals, plan, out=base.clone(), alpha=-1)
        assert _same_bits(into, kernels.seg_sum_fixed_ref(
            vals, plan, out=base.clone(), alpha=-1)), tail
        assert _same_bits(into.cpu(), _index_add(
            vals.cpu(), idx.cpu(), num, base.cpu(), alpha=-1)), tail
    # an entry of more values than a CTA has threads is refused
    wide = torch.zeros((1, 3, kernels.K3_MAX_TAIL + 1), dtype=dtype,
                       device="cuda")
    with pytest.raises(ValueError, match="values per entry"):
        kernels.seg_sum_fixed(wide, kernels.seg_plan(
            torch.zeros((1, 3), dtype=torch.int64, device="cuda"), 2))
    torch.cuda.synchronize()
