"""The benchmark's generator against the repository's own (`synth`): the
same sets, array for array."""

import numpy as np
import pytest

from benchmark import gen

FIELDS = ("pose_ids", "poses", "feat_ids", "feats", "U", "Uij", "W", "Wpf",
          "V")


@pytest.mark.parametrize("datatype", ["stereo", "mono"])
@pytest.mark.parametrize("covis", [(0.0, 0), (6.0, 6)])
def test_gen_matches_synth(datatype, covis):
    from synth import generate
    kw = dict(noise=0.005, seed=2**31 + 11, covis_radius=covis[0],
              covis_max=covis[1])
    a, pa, fa = gen.make_dataset(64, datatype, **kw)
    b, pb, fb = generate.make_dataset(64, datatype, **kw)
    np.testing.assert_allclose(pa, pb, rtol=0, atol=1e-12)
    np.testing.assert_allclose(fa, fb, rtol=0, atol=1e-12)
    assert len(a) == len(b) == 64
    for x, y in zip(a, b):
        assert x.gauge == y.gauge
        for f in FIELDS:
            u, v = np.asarray(getattr(x, f)), np.asarray(getattr(y, f))
            assert u.shape == v.shape, f
            np.testing.assert_allclose(u, v, rtol=0, atol=1e-12, err_msg=f)


def test_set_seeds_distinct():
    seeds = {gen.set_seed(s, j) for s in (0, 7, 2**31 + 5, 2**33)
             for j in (-1, 0, 1, 2)}
    assert len(seeds) == 16
    assert gen.set_seed(2**31 + 5, 3) == gen.set_seed(2**31 + 5, 3)


def test_pool_same_in_worker_processes(monkeypatch):
    from benchmark import run
    b = run.Bench()
    cfg = dict(b.config("rs468_mono"), maps=6)
    mix = dict(b.mix("covis"), pool_maps=18)
    monkeypatch.setattr(run, "GEN_PROCS", 2)
    a, wa = run.pool_sets(cfg, mix, 2**31 + 3)
    monkeypatch.setattr(run, "GEN_PROCS", 1)
    c, wc = run.pool_sets(cfg, mix, 2**31 + 3)
    assert len(a) == len(c) == 3
    for x, y in zip(a + [wa], c + [wc]):
        for m, n in zip(x, y):
            for f in FIELDS:
                assert np.array_equal(getattr(m, f), getattr(n, f)), f
    assert not np.array_equal(a[0][0].poses, a[1][0].poses)
