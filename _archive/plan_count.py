"""K3's plans and launches per run, in the fixed order, on the tree it is
run from (so a parent commit unpacked beside this one counts its own).

    python3 _archive/plan_count.py [--maps 2048] [--host-maps 512]
        [--out FILE.json] [--cpu]

From the root of a checkout (it imports `linearsfm_tpu_torch` from the
current directory). For each path: stereo refine, mono refine and mono
direct on the device executor at --maps, and stereo direct on the host
executor at --host-maps, on the 2,048-map benchmark's data (covis, seed 7,
noise 0.005). One warm run, then one counted run inside
`ops/segment.deterministic()` (entered here too, for trees whose solvers
enter it only for direct mono): the calls of `kernels.seg_plan` (one
stable sort and one search each) and the launches of K3
(`kernels.launches["seg_sum_fixed"]`). Prints one line per path and the
JSON record.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--maps", type=int, default=2048)
    ap.add_argument("--host-maps", type=int, default=512)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    import torch
    from synth import generate as gen
    from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
    from linearsfm_tpu_torch.core.tree import TreeSolver
    from linearsfm_tpu_torch.ops import kernels, segment
    dev = "cpu" if args.cpu else "cuda"
    if dev == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    calls = [0]
    seg_plan = kernels.seg_plan

    def counted(idx, num):
        calls[0] += 1
        return seg_plan(idx, num)
    kernels.seg_plan = counted
    if dev == "cpu":   # the card's route, K3's plain version here
        segment._k3 = lambda x: segment._fixed > 0 and x.is_floating_point()
    rec = {}
    for tag, cls, datatype, method, n in (
            ("device stereo refine", DeviceTreeSolver, "stereo", "refine",
             args.maps),
            ("device mono refine", DeviceTreeSolver, "mono", "refine",
             args.maps),
            ("device mono direct", DeviceTreeSolver, "mono", "direct",
             args.maps),
            ("host stereo direct", TreeSolver, "stereo", "direct",
             args.host_maps)):
        maps, _, _ = gen.make_dataset(n, datatype, noise=0.005, seed=7,
                                      covis_radius=6.0, covis_max=6)
        solver = cls(datatype, method=method, device=dev)
        with segment.deterministic():
            solver.run(maps)
            calls[0] = 0
            kernels.launches["seg_sum_fixed"] = 0
            t0 = time.perf_counter()
            solver.run(maps)
            if dev == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rec[tag] = dict(maps=n, seg_plan_calls=calls[0],
                        k3_launches=kernels.launches["seg_sum_fixed"],
                        wall_s=wall)
        print(f"{tag} {n} maps: {calls[0]} seg_plan calls, "
              f"{rec[tag]['k3_launches']} K3 launches, wall {wall:.4f} s",
              flush=True)
        del solver, maps
    print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rec, fh, indent=1)


if __name__ == "__main__":
    main()
