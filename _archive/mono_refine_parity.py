"""Mono refine at 2,048 maps on the CPU: the port against the JAX package.

    python _archive/mono_refine_parity.py torch|jax|compare [--maps N]

Each side solves the seed-7 covis set (noise 0.005, covis radius 6, at most
6 co-visible features per map) with DeviceTreeSolver("mono",
method="refine") on the CPU and writes its poses to
_archive/mono_refine_<side>_<N>.npz; "compare" prints both ATEs and the
pose max |diff|.
"""

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def dataset(n):
    from synth import generate as gen
    return gen.make_dataset(n, "mono", noise=0.005, seed=7, covis_radius=6.0,
                            covis_max=6)


def ate(ids, poses, gt):
    err = np.linalg.norm(poses[:, :3] - gt[ids, :3], axis=1)
    return float(np.sqrt(np.mean(np.square(err))))


def main():
    side = sys.argv[1]
    n = int(sys.argv[sys.argv.index("--maps") + 1]) if "--maps" in sys.argv \
        else 2048
    out = os.path.join(HERE, f"mono_refine_{{}}_{n}.npz")
    if side == "compare":
        maps, gt, _ = dataset(n)
        a, b = np.load(out.format("torch")), np.load(out.format("jax"))
        assert np.array_equal(a["ids"], b["ids"])
        d = np.abs(a["poses"] - b["poses"]).max()
        print(f"{n} maps: port ATE {ate(a['ids'], a['poses'], gt):.12f} "
              f"({a['wall']:.1f} s), JAX ATE "
              f"{ate(b['ids'], b['poses'], gt):.12f} ({b['wall']:.1f} s), "
              f"pose max |diff| {d:.3e}")
        return
    maps, gt, _ = dataset(n)
    t0 = time.perf_counter()
    if side == "torch":
        import torch
        torch.set_num_threads(4)
        from linearsfm_tpu_torch import types
        from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
        s = DeviceTreeSolver("mono", method="refine", device="cpu")
        h = types.to_numpy(s.run(maps))
        ids, poses = h.pose_ids, h.poses
        res = max(float(np.max(r)) for r in s.last_residuals.values())
    else:
        os.environ["LINEARSFM_JAX_CACHE"] = "0"
        import jax
        jax.config.update("jax_platforms", "cpu")
        from linearsfm_tpu.core.device_tree import DeviceTreeSolver
        s = DeviceTreeSolver("mono", method="refine")
        y = s.run([m.to_local_map() for m in maps])
        ids, poses = np.asarray(y.pose_ids), np.asarray(y.poses)
        res = max(float(np.nanmax(r)) for r in s.last_residuals.values())
    wall = time.perf_counter() - t0
    keep = ids >= 0
    order = np.argsort(ids[keep])
    ids, poses = ids[keep][order], poses[keep][order]
    np.savez(out.format(side), ids=ids, poses=poses, wall=wall)
    import resource
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"{side} {n} maps: ATE {ate(ids, poses, gt):.12f}, res_max "
          f"{res:.3e}, wall {wall:.1f} s, peak RSS {rss:.2f} GiB")


if __name__ == "__main__":
    main()
