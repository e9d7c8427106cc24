"""ATE comparison: the port's pipeline against the reference oracle on a
shared dataset.

    python3 -m linearsfm_tpu_torch.tools.compare_ate [--num 64]
        [--type stereo|mono] [--noise 0.005] [--seed 7] [--pattern loop]
        [--exec device] [--method refine] [--covis] [--json PATH]
        [--dir DIR] [--phase both|oracle|port] [--cpu]

Counterpart of `tools/compare_ate.py`, with its flags. The oracle phase
makes the dataset (`synth.generate.make_dataset`), writes it as text with
the port's writer (`io/localmap.write_dataset`) and runs the reference
binary `tools/oracle/linearsfm_oracle` on it, recording its wall in
DIR/oracle_meta.json; the port phase runs `core/pipeline.run(executor=,
method=, device=)` on the same files and compares the two pose files pose
for pose and each one's ATE against the ground truth. A missing oracle, or
one that fails, ends the tool with exit 1: the comparison is never skipped.
The port phase runs on the card unless --cpu is given (no CUDA and no
--cpu: exit 1).

Deliberate differences from the JAX tool: the port's phase is `--phase
port` (the JAX tool's "tpu"), and the record's `tpu_wall_s` / `ate_tpu`
keys are `port_wall_s` / `ate_port`; the ATEs print with 9 decimals (the
oracle's limit is 1e-6) and the pose file is pose_port.txt; the record
also holds the executor, method, device, pattern, the pose count and the
non-finite poses of each side; pose files with different ids end the tool
with exit 1, where the JAX tool asserts.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ORACLE = os.path.join(REPO, "tools", "oracle", "linearsfm_oracle")


def run_oracle(d: str, num: int, datatype: str, timeout: float = 7200):
    """The reference binary on the dataset in `d` (pose_ref.txt,
    feat_ref.txt there): (wall seconds, its reported solve seconds or
    None). Raises OSError if it cannot start and CalledProcessError if it
    fails."""
    typ = "Stereo" if datatype == "stereo" else "Monocular"
    t0 = time.perf_counter()
    r = subprocess.run([ORACLE, "-path", d, "-num", str(num), "-type", typ,
                        "-p", os.path.join(d, "pose_ref.txt"),
                        "-f", os.path.join(d, "feat_ref.txt")],
                       check=True, capture_output=True, timeout=timeout)
    wall = time.perf_counter() - t0
    m = re.search(r"Total Used Time:\s*([0-9.]+)", r.stdout.decode())
    return wall, float(m.group(1)) if m else None


def ate(poses, ids, poses_gt) -> float:
    """RMS of the pose translations' distances to the ground truth."""
    err = np.linalg.norm(poses[:, :3] - poses_gt[ids, :3], axis=1)
    return float(np.sqrt(np.mean(np.square(err))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num", type=int, default=64)
    ap.add_argument("--type", choices=["stereo", "mono"], default="stereo")
    ap.add_argument("--noise", type=float, default=0.005)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--pattern", default="loop")
    ap.add_argument("--exec", dest="executor", default="device",
                    help="tree executor (production default: device)")
    ap.add_argument("--method", default="refine",
                    help="solver method (production default: refine)")
    ap.add_argument("--covis", action="store_true",
                    help="loop-closure co-visibility (radius 6, max 6 — the "
                         "bench/baseline dataset family)")
    ap.add_argument("--json", default=None,
                    help="write the comparison record to this path")
    ap.add_argument("--dir", default=None,
                    help="persistent working dir (default: fresh tempdir)")
    ap.add_argument("--phase", choices=["both", "oracle", "port"],
                    default="both",
                    help="'oracle': generate data + run the reference only "
                         "(records timing in DIR/oracle_meta.json); 'port': "
                         "reuse DIR from a previous oracle phase and "
                         "run/compare the port's side")
    args = ap.parse_args(argv)

    from linearsfm_tpu_torch.tools.common import open_device
    device = None
    if args.phase != "oracle":
        device = open_device(args.cpu, "compare_ate")
        if device is None:
            return 1

    d = args.dir or tempfile.mkdtemp(prefix="ate_")
    os.makedirs(d, exist_ok=True)
    meta_path = os.path.join(d, "oracle_meta.json")

    if args.phase in ("both", "oracle"):
        from synth import generate as gen
        from linearsfm_tpu_torch.io import localmap as lio
        cov = dict(covis_radius=6.0, covis_max=6) if args.covis else {}
        maps, poses_gt, _ = gen.make_dataset(args.num, args.type,
                                             noise=args.noise, seed=args.seed,
                                             pattern=args.pattern, **cov)
        lio.write_dataset(maps, d)
        np.save(os.path.join(d, "poses_gt.npy"), poses_gt)
        try:
            t_oracle, solve = run_oracle(d, args.num, args.type)
        except (OSError, subprocess.SubprocessError) as e:
            print(f"compare_ate: the oracle {ORACLE} did not run: {e}",
                  file=sys.stderr)
            return 1
        with open(meta_path, "w") as fh:
            json.dump(dict(num=args.num, type=args.type, noise=args.noise,
                           seed=args.seed, covis=bool(args.covis),
                           pattern=args.pattern, oracle_wall_s=t_oracle,
                           oracle_solve_s=solve), fh, indent=1)
        if args.phase == "oracle":
            print(f"oracle phase done: wall {t_oracle:.2f}s -> {meta_path}")
            return 0
    else:
        with open(meta_path) as fh:
            meta = json.load(fh)
        for k in ("num", "type", "covis", "pattern"):
            got, want = getattr(args, k), meta[k]
            if got != want:
                print(f"compare_ate: --{k}={got} mismatches the oracle dir "
                      f"({want})", file=sys.stderr)
                return 1
        t_oracle = meta["oracle_wall_s"]

    from linearsfm_tpu_torch.core import pipeline
    from linearsfm_tpu_torch.io import localmap as lio
    poses_gt = np.load(os.path.join(d, "poses_gt.npy"))
    _, t_port = pipeline.run(d, args.num, args.type,
                             pose_path=os.path.join(d, "pose_port.txt"),
                             feat_path=os.path.join(d, "feat_port.txt"),
                             progress=False, executor=args.executor,
                             method=args.method, device=device)

    ids_r, pr = lio.read_poses(os.path.join(d, "pose_ref.txt"))
    ids_t, pt = lio.read_poses(os.path.join(d, "pose_port.txt"))
    if ids_r.shape != ids_t.shape or not (ids_r == ids_t).all():
        print(f"compare_ate: the pose files hold different ids ({len(ids_r)} "
              f"oracle, {len(ids_t)} port)", file=sys.stderr)
        return 1
    d_ref = np.abs(pr - pt)
    ate_r, ate_t = ate(pr, ids_r, poses_gt), ate(pt, ids_t, poses_gt)
    print(f"maps={args.num} type={args.type} noise={args.noise} "
          f"covis={args.covis}")
    print(f"oracle wall: {t_oracle:.2f}s   port wall: {t_port:.2f}s")
    print(f"pose diff vs oracle: max {d_ref.max():.3e}  "
          f"rms {np.sqrt((d_ref ** 2).mean()):.3e}")
    print(f"ATE vs gt: oracle {ate_r:.9f}  port {ate_t:.9f}", flush=True)
    if args.json:
        rec = dict(num=args.num, type=args.type, noise=args.noise,
                   seed=args.seed, covis=bool(args.covis),
                   pattern=args.pattern, executor=args.executor,
                   method=args.method, device=device,
                   oracle_wall_s=round(t_oracle, 3),
                   port_wall_s=round(t_port, 3),
                   pose_diff_max=float(d_ref.max()),
                   pose_diff_rms=float(np.sqrt((d_ref ** 2).mean())),
                   ate_oracle=ate_r, ate_port=ate_t, n_poses=len(ids_t),
                   nonfinite_oracle=int((~np.isfinite(pr)).any(1).sum()),
                   nonfinite_port=int((~np.isfinite(pt)).any(1).sum()))
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(rec, fh, indent=1)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
