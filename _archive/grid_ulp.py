"""How far one ulp of input moves the mono device tree, level by level, in
either package (CPU).

    python3 _archive/grid_ulp.py run --pkg jax|torch --out DIR [--ulp]
        [--num 1024] [--pattern grid] [--method direct]
    python3 _archive/grid_ulp.py compare DIR_A DIR_B [--num 1024]
        [--pattern grid]

`run` builds `synth.generate.make_dataset(num, "mono", noise=0.005,
seed=7, pattern=P, covis_radius=6.0, covis_max=6)`, with `--ulp` moves
every input pose by one ulp (`np.nextafter` towards +inf), and solves it
with the package's `DeviceTreeSolver("mono", method=M)` on the CPU
(`JAX_PLATFORMS=cpu` for the JAX package; `device="cpu"` for the port),
with `ckpt_dir=DIR`: every level's output stack is saved there
(`stacked_level<L>.npz`, the same format in both packages); the root's
poses go to `DIR/root.npz`.

`compare` holds two such runs level by level: the largest |difference| of
the poses and features of every level's output (slots whose ids agree),
its growth over the level before (level 0: the input's), the lane that
moved most, and, for every join of the level, the mono scale that the
join's transform divides by: `scale = |ts[fix]|`, ts = R (s - t), with (t,
R) the pose of the right map's ref and s the translation of its scale pose,
both read from the left map of the pair (`linearsfm_tpu/ops/gauge.py:69-79`,
`mono_scale`). It prints the smallest scale of the level, the scale of the
lane that moved most, and the first level whose spread grew more than 1e3
times over its input's.
"""
import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402


def dataset(num, pattern):
    from synth import generate as gen
    maps, gt, _ = gen.make_dataset(num, "mono", noise=0.005, seed=7,
                                   pattern=pattern, covis_radius=6.0,
                                   covis_max=6)
    return maps, gt


def run(args):
    maps, gt = dataset(args.num, args.pattern)
    if args.ulp:
        for m in maps:
            m.poses = np.nextafter(m.poses, np.inf)
    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    if args.pkg == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        from linearsfm_tpu.core.device_tree import DeviceTreeSolver
        root = DeviceTreeSolver("mono", method=args.method).run(
            [m.to_local_map() for m in maps], ckpt_dir=args.out)
        ids, poses = np.asarray(root.pose_ids), np.asarray(root.poses)
    else:
        import torch
        torch.set_num_threads(4)
        from linearsfm_tpu_torch import types
        from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
        root = types.host_fields(DeviceTreeSolver(
            "mono", method=args.method, device="cpu").run(
                maps, ckpt_dir=args.out))
        ids, poses = root.pose_ids, root.poses
    np.savez(os.path.join(args.out, "root.npz"), pose_ids=ids, poses=poses)
    v = ids >= 0
    err = np.linalg.norm(poses[v, :3] - gt[ids[v], :3], axis=1)
    print(f"{args.pkg} {args.pattern} mono {args.num} {args.method}"
          f"{' +1 ulp' if args.ulp else ''}: {time.perf_counter() - t0:.1f} s"
          f", ATE {float(np.sqrt(np.mean(err ** 2))):.9f}", flush=True)


def _euler_to_r(e):
    """Rotation of Euler angles e [3] (the packages' `euler_to_r`)."""
    from linearsfm_tpu_torch.ops import rotations
    import torch
    return rotations.euler_to_r(torch.as_tensor(e, dtype=torch.float64)
                                ).numpy()


def _scale(g_ids, g_poses, ref, scap, fix):
    """|ts[fix]| of the transform into (ref, scap, fix), read from a map
    whose poses hold ref and scap (NaN if either is missing)."""
    slot = {int(i): k for k, i in enumerate(g_ids) if i >= 0}
    if int(ref) not in slot or int(scap) not in slot:
        return float("nan")
    g = g_poses[slot[int(ref)]]
    s = g_poses[slot[int(scap)]][:3]
    ts = _euler_to_r(g[3:6]) @ (s - g[:3])
    return abs(float(ts[int(fix)]))


def _level_input(d, level, maps):
    """(pose_ids [P, M], poses [P, M, 6], gauge ref/scap/fix [P]) of the
    level's input lanes: the maps themselves at level 1."""
    if level == 1:
        return ([m.pose_ids for m in maps], [m.poses for m in maps],
                [m.gauge["ref"] for m in maps],
                [m.gauge["scap"] for m in maps],
                [m.gauge["fix"] for m in maps])
    f = np.load(os.path.join(d, f"stacked_level{level - 1}.npz"))
    return (f["pose_ids"], f["poses"], f["gauge_ref"], f["gauge_scap"],
            f["gauge_fix"])


def _spread(fa, fb, ids, vals):
    """Largest |a - b| of one field over the slots whose ids agree, and the
    lane where it is."""
    same = (fa[ids] == fb[ids]) & (fa[ids] >= 0)
    d = np.abs(fa[vals] - fb[vals]).reshape(same.shape + (-1,)).max(axis=-1)
    d = np.where(same, d, 0.0)
    lane = int(np.argmax(d.max(axis=1)))
    return float(d.max()), lane


def compare(args):
    maps, _ = dataset(args.num, args.pattern)
    a, b = args.dirs
    level = 1
    prev = float(np.max(np.abs(np.nextafter(np.concatenate(
        [m.poses for m in maps]), np.inf) - np.concatenate(
        [m.poses for m in maps]))))
    print(f"level 0 (input poses): spread {prev:.3e}")
    first = None
    while os.path.exists(os.path.join(a, f"stacked_level{level}.npz")):
        fa = np.load(os.path.join(a, f"stacked_level{level}.npz"))
        fb = np.load(os.path.join(b, f"stacked_level{level}.npz"))
        sp, lane = _spread(fa, fb, "pose_ids", "poses")
        sf, _ = _spread(fa, fb, "feat_ids", "feats")
        ids, poses, ref, scap, fix = _level_input(a, level, maps)
        count = len(ids)
        scales = [_scale(ids[2 * i], poses[2 * i], ref[2 * i + 1],
                         scap[2 * i + 1], fix[2 * i + 1])
                  for i in range(count // 2)]
        smin = np.nanmin(scales) if scales else float("nan")
        s_lane = scales[lane] if lane < len(scales) else float("nan")
        growth = max(sp, sf) / prev if prev > 0 else float("inf")
        print(f"level {level}: {count} lanes in; spread poses {sp:.3e}, "
              f"feats {sf:.3e}, growth {growth:.3e}; lane {lane} moved most, "
              f"its join's scale {s_lane:.6e}; smallest scale of the level "
              f"{smin:.6e} (lane {int(np.nanargmin(scales)) if scales else -1})"
              f"; median {np.nanmedian(scales) if scales else float('nan'):.6e}",
              flush=True)
        if first is None and growth > 1e3:
            first = level
        prev = max(sp, sf, prev)
        level += 1
    ra, rb = (np.load(os.path.join(d, "root.npz")) for d in (a, b))
    same = ra["pose_ids"] == rb["pose_ids"]
    print(f"root: max |dpose| {float(np.abs(ra['poses'] - rb['poses'])[same].max()):.3e}"
          f"; first level grown > 1e3 over its input: {first}")


def main():
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--pkg", choices=("jax", "torch"), required=True)
    r.add_argument("--out", required=True)
    r.add_argument("--ulp", action="store_true")
    c = sub.add_parser("compare")
    c.add_argument("dirs", nargs=2)
    for p in (r, c):
        p.add_argument("--num", type=int, default=1024)
        p.add_argument("--pattern", default="grid")
        p.add_argument("--method", default="direct")
    args = ap.parse_args()
    run(args) if args.cmd == "run" else compare(args)


if __name__ == "__main__":
    main()
