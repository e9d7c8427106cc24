"""Dense refine on the CPU: the port against the JAX package.

    python _archive/dense_refine_parity.py torch|jax|direct|compare
        [--maps N] [--type stereo|mono] [--mixed M]

Each side solves the seed-7 covis set (noise 0.005, covis radius 6, at most
6 co-visible features per map) on the CPU and writes its poses to
_archive/dense_<type>_<side>_<N>_<M>.npz: "torch" and "jax" with
DenseTreeSolver(type, method="refine", mixed_max_m=M) (default 32, the
executor's default), "direct" with the port's DenseTreeSolver(type,
method="direct") — the exact f64 solution the oracle computes. "compare"
prints the three ATEs, the number of non-finite poses, and the pose max
|diff| between the sides.
"""

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def arg(name, default):
    return (type(default)(sys.argv[sys.argv.index(name) + 1])
            if name in sys.argv else default)


def dataset(n, typ):
    from synth import generate as gen
    return gen.make_dataset(n, typ, noise=0.005, seed=7, covis_radius=6.0,
                            covis_max=6)


def ate(ids, poses, gt):
    err = np.linalg.norm(poses[:, :3] - gt[ids, :3], axis=1)
    return float(np.sqrt(np.mean(np.square(err))))


def main():
    side = sys.argv[1]
    n, typ, mm = arg("--maps", 2048), arg("--type", "stereo"), arg("--mixed",
                                                                    32)
    out = os.path.join(HERE, f"dense_{typ}_{{}}_{n}_{mm}.npz")
    maps, gt, _ = dataset(n, typ)
    if side == "compare":
        got = {s: np.load(out.format(s)) for s in ("torch", "jax", "direct")}
        for s, f in got.items():
            bad = int((~np.isfinite(f["poses"]).all(axis=1)).sum())
            print(f"{typ} {n} maps, mixed_max_m {mm}: {s} ATE "
                  f"{ate(f['ids'], f['poses'], gt):.12f} ({f['wall']:.1f} s, "
                  f"{bad} non-finite poses)")
        for a, b in (("torch", "jax"), ("torch", "direct"), ("jax", "direct")):
            assert np.array_equal(got[a]["ids"], got[b]["ids"])
            d = np.abs(got[a]["poses"] - got[b]["poses"]).max()
            print(f"pose max |diff| {a} vs {b}: {d:.3e}")
        return
    t0 = time.perf_counter()
    if side in ("torch", "direct"):
        import torch
        torch.set_num_threads(4)
        from linearsfm_tpu_torch.core.dense_tree import DenseTreeSolver
        kw = (dict(method="refine", mixed_max_m=mm) if side == "torch"
              else dict(method="direct"))
        y = DenseTreeSolver(typ, device="cpu", **kw).run(maps)
    else:
        os.environ["LINEARSFM_JAX_CACHE"] = "0"
        import jax
        jax.config.update("jax_platforms", "cpu")
        from linearsfm_tpu.core.dense_tree import DenseTreeSolver
        y = DenseTreeSolver(typ, method="refine", mixed_max_m=mm).run(
            [m.to_local_map() for m in maps])
    ids, poses = np.asarray(y.pose_ids), np.asarray(y.poses)
    wall = time.perf_counter() - t0
    keep = ids >= 0
    order = np.argsort(ids[keep])
    ids, poses = ids[keep][order], poses[keep][order]
    np.savez(out.format(side), ids=ids, poses=poses, wall=wall)
    import resource
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"{side} {typ} {n} maps: ATE {ate(ids, poses, gt):.12f}, wall "
          f"{wall:.1f} s, peak RSS {rss:.2f} GiB")


if __name__ == "__main__":
    main()
