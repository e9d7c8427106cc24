"""Measure the reference oracle's wall-clock on synthetic datasets.

    python3 -m linearsfm_tpu_torch.tools.measure_baseline [--covis]
        [--pattern loop|grid] [--types stereo,mono] [--sizes 64,128,...]
        [--keep-data DIR] [--json PATH]

Counterpart of `tools/measure_baseline.py`, with its flags and keys
``{type}[_covis][_grid]_{maps_per_s,wall_s,solve_s}_{num}``: the datasets
are made by `synth.generate.make_dataset` and written with the port's
writer (`io/localmap.write_dataset`), and the oracle binary
`tools/oracle/linearsfm_oracle` solves each (a failed run prints FAILED
and is left out). It times only the oracle on the CPU, so it has no
`--cpu` and needs no card.

Deliberate difference: the results go to `--json`, by default
`chiprun_out/baseline_measured.json` under the repo root (a gitignored
directory), which the tool reads first and rewrites after every run (keys
already there are skipped, so a cut run keeps its partial results); the
JAX tool rewrites the root `baseline_measured.json`, which this tool never
touches.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_JSON = os.path.join(REPO, "chiprun_out", "baseline_measured.json")


def run_one(datatype, num, covis, seed=7, noise=0.005, keep_dir=None,
            pattern="loop") -> dict:
    """Make, write and solve one dataset with the oracle: {"wall", "solve"
    (the oracle's own "Total Used Time", else the wall), "gen"} in
    seconds."""
    from synth import generate as gen
    from linearsfm_tpu_torch.io import localmap as lio
    from linearsfm_tpu_torch.tools.compare_ate import run_oracle
    kw = dict(covis_radius=6.0, covis_max=6) if covis else {}
    t0 = time.perf_counter()
    maps, _, _ = gen.make_dataset(num, datatype, noise=noise, seed=seed,
                                  pattern=pattern, **kw)
    d = keep_dir or tempfile.mkdtemp(prefix=f"base_{datatype}_{num}_")
    try:
        lio.write_dataset(maps, d)
        gen_s = time.perf_counter() - t0
        wall, solve = run_oracle(d, num, datatype)
    finally:
        if not keep_dir:
            shutil.rmtree(d, ignore_errors=True)
    return dict(wall=wall, solve=wall if solve is None else solve, gen=gen_s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--covis", action="store_true")
    ap.add_argument("--pattern", default="loop", choices=["loop", "grid"],
                    help="'grid' = aerial lawnmower sweep; keys gain a _grid "
                         "tag, matching bench.py")
    ap.add_argument("--types", default="stereo,mono")
    ap.add_argument("--sizes", default="")
    ap.add_argument("--keep-data", default=None)
    ap.add_argument("--json", default=DEFAULT_JSON,
                    help="results file, read first and rewritten after "
                         "every run")
    args = ap.parse_args(argv)

    sizes = {
        "stereo": [64, 128, 256, 512, 1024, 2048, 3499, 4096],
        "mono": [64, 128, 256, 512, 1024, 2048],
    }
    if args.sizes:
        ss = [int(x) for x in args.sizes.split(",")]
        sizes = {k: ss for k in sizes}

    data = {}
    if os.path.exists(args.json):
        with open(args.json) as fh:
            data = json.load(fh)
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)

    tag = ("_covis" if args.covis else "") + \
          ("_grid" if args.pattern == "grid" else "")
    for datatype in args.types.split(","):
        for num in sizes[datatype]:
            key = f"{datatype}{tag}_maps_per_s_{num}"
            if key in data:
                print(f"skip {key} (have {data[key]:.1f})", flush=True)
                continue
            print(f"measuring {datatype}{tag} {num} ...", flush=True)
            keep = None
            if args.keep_data:
                keep = os.path.join(args.keep_data, f"{datatype}{tag}_{num}")
                os.makedirs(keep, exist_ok=True)
            try:
                r = run_one(datatype, num, args.covis, keep_dir=keep,
                            pattern=args.pattern)
            except Exception as e:  # noqa: BLE001  (one size failing must not end the sweep)
                print(f"  FAILED: {e}", flush=True)
                continue
            data[key] = (num - 1) / r["solve"]  # reference-reported solve time
            data[f"{datatype}{tag}_wall_s_{num}"] = r["wall"]
            data[f"{datatype}{tag}_solve_s_{num}"] = r["solve"]
            with open(args.json, "w") as fh:
                json.dump(data, fh, indent=1)
            print(f"  wall {r['wall']:.2f}s solve {r['solve']:.2f}s "
                  f"({data[key]:.1f} maps/s; gen {r['gen']:.1f}s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
