"""Fused maps of both joins on every solve route, this checkout against
another (the parent commit's), each in a process of its own.

    python3 _archive/join_routes_parity.py --other DIR [--cuda] [--seed N]

CPU (default): small stereo and mono sets (`benchmark/gen.py`); the root
join of a refine `DeviceTreeSolver` run is kept and joined again on every
route of the joins' router: stereo {refine, direct} and mono {refine,
direct} x pin {sign, zero}, each without a mesh and over a four-shard CPU
feature mesh; then the same sets through `DeviceTreeSolver` for each
route, without a mesh and over a two-shard CPU mesh (root level
feature-sharded). Each run records which solvers it called. The fused maps must be
torch.equal, field by field, except on the routes of the feature-sharded
PCG (`shard_solve.sharded_full_mixed`), whose float32 preconditioner the
change forms another way: there the solver's inputs must be torch.equal
and the poses' max |diff| is printed.

--cuda: the benchmark cells' first sets (`gen.make_set(cfg, mix, seed,
0)`) through each cell's solver on the card; every cell's fused map must
be torch.equal.

Prints one line a run and a JSON summary last; exits 1 on a difference.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

ROUTES = [(dt, method, pin, mesh)
          for dt, pins in (("stereo", ("sign",)), ("mono", ("sign", "zero")))
          for method in ("refine", "direct") for pin in pins
          for mesh in (False, True)]
CPU_SETS = {"stereo": (8, 5), "mono": (9, 5)}   # maps, seed
SOLVERS = (("schur", "solve_full_mixed"), ("shard_solve", "sharded_full_mixed"),
           ("shard_solve", "sharded_schur_solve"), ("solve", "solve_reduced"))


def _side(root, jobs_path, out_path):
    """Runs the jobs with the package under `root`; saves the results."""
    sys.path.insert(0, root)
    import torch
    import linearsfm_tpu_torch
    from linearsfm_tpu_torch.core.device_tree import DeviceTreeSolver
    from linearsfm_tpu_torch.core import join
    from linearsfm_tpu_torch.parallel.mesh import Mesh
    from linearsfm_tpu_torch.types import MAP_FIELDS
    assert linearsfm_tpu_torch.__file__.startswith(root), \
        linearsfm_tpu_torch.__file__
    if torch.cuda.is_available():
        torch.backends.cuda.matmul.allow_tf32 = False
    with open(jobs_path, "rb") as fh:
        jobs = pickle.load(fh)
    mods = {n: getattr(join, n) for n, _ in SOLVERS}
    calls, pcg_in = [], []

    def recording(mod, name):
        fn = getattr(mod, name)

        def inner(*a, **k):
            calls.append(name)
            if name == "sharded_full_mixed":
                pcg_in.append([t.clone() for t in a
                               if isinstance(t, torch.Tensor)]
                              + [k.get("fixc"), k.get("sign")])
            return fn(*a, **k)
        return inner
    for m, name in SOLVERS:
        setattr(mods[m], name, recording(mods[m], name))
    results = []

    def keep(name, out, res=None):
        results.append(dict(
            name=name, calls=sorted(set(calls)),
            map={f: getattr(out, f).detach().cpu()
                 if isinstance(getattr(out, f), torch.Tensor)
                 else getattr(out, f) for f in MAP_FIELDS + ("gauge",)},
            res=None if res is None else res.detach().cpu(),
            pcg_in=[[None if t is None else t.detach().cpu() for t in c]
                    for c in pcg_in]))
        calls.clear()
        pcg_in.clear()

    for job in jobs:
        calls.clear()
        pcg_in.clear()
        dev, dt = job["device"], job["datatype"]
        if job["kind"] == "join":
            # the root join's inputs of a refine tree without a mesh, then
            # that join again on every route
            jname = f"join_{dt}"
            jfn, root = getattr(join, jname), []

            def capture(end, cur, cfg, jfn=jfn, root=root):
                root[:] = [end, cur, cfg]
                return jfn(end, cur, cfg)
            setattr(join, jname, capture)
            try:
                DeviceTreeSolver(dt, "refine", device=dev).run(job["maps"])
            finally:
                setattr(join, jname, jfn)
            end, cur, cfg = root
            keep(f"{dt} root join inputs (end)", end)
            keep(f"{dt} root join inputs (cur)", cur)
            for method, pin, mesh in job["routes"]:
                c = cfg._replace(method=method, pin=pin, with_res=True,
                                 mesh=Mesh((dev,) * 4, "fs") if mesh
                                 else None)
                out, res = jfn(end, cur, c)
                keep(f"{dt} join {method} pin {pin} "
                     f"{'mesh' if mesh else 'no mesh'}", out, res)
            continue
        kw = dict(device=dev, pin=job["pin"])
        if job["mesh"]:
            kw.update(mesh=Mesh((dev,) * 2, "pairs"), root_shard_min=0)
        out = DeviceTreeSolver(dt, job["method"], **kw).run(job["maps"])
        if dev != "cpu":
            torch.cuda.synchronize()
        keep(job["name"], out)
    torch.save(results, out_path)


def _jobs(cuda, seed):
    sys.path.insert(0, ROOT)
    from benchmark import gen
    jobs = []
    if cuda:
        with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
            bench = json.load(fh)
        for cell in bench["workloads"]:
            cfg = json.load(open(os.path.join(ROOT, "benchmark", "configs",
                                              cell["config"] + ".json")))
            mix = json.load(open(os.path.join(ROOT, "benchmark", "traffic",
                                              cell["traffic"] + ".json")))
            jobs.append(dict(name=cell["name"], kind="tree",
                             datatype=cfg["datatype"],
                             method=cfg["method"], pin="sign", mesh=False,
                             device="cuda",
                             maps=gen.make_set(cfg, mix, seed, 0)))
        return jobs
    sets = {dt: gen.make_dataset(n, dt, noise=0.01, seed=s)[0]
            for dt, (n, s) in CPU_SETS.items()}
    for dt, maps in sets.items():
        jobs.append(dict(name=f"{dt} joins", kind="join", datatype=dt,
                         device="cpu", maps=maps,
                         routes=[r[1:] for r in ROUTES if r[0] == dt]))
    for dt, method, pin, mesh in ROUTES:
        jobs.append(dict(name=f"{dt} tree {method} pin {pin} "
                              f"{'mesh' if mesh else 'no mesh'}",
                         kind="tree", datatype=dt, method=method, pin=pin,
                         mesh=mesh, device="cpu", maps=sets[dt]))
    return jobs


def _equal(a, b):
    import dataclasses
    import torch
    if dataclasses.is_dataclass(a):
        return type(a) is type(b) and all(
            _equal(getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a))
    if isinstance(a, torch.Tensor):
        # NaN where the other is NaN (the residual of a direct solve)
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape
                and bool(torch.equal(a.isnan(), b.isnan()))
                and bool(torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_equal(x, y) for x, y in zip(a, b)))
    return a == b


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True)
    ap.add_argument("--cuda", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--side", nargs=3, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.side:
        return _side(*args.side)
    import torch
    other = os.path.abspath(args.other)
    with tempfile.TemporaryDirectory() as tmp:
        jobs_path = os.path.join(tmp, "jobs.pkl")
        with open(jobs_path, "wb") as fh:
            pickle.dump(_jobs(args.cuda, args.seed), fh)
        res = {}
        for tag, root in (("other", other), ("this", ROOT)):
            out = os.path.join(tmp, f"{tag}.pt")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--other", other, "--side", root, jobs_path, out],
                           check=True, cwd=tmp)
            res[tag] = torch.load(out, weights_only=False)   # our own file
    bad, summary = [], []
    for a, b in zip(res["other"], res["this"]):
        name = a["name"]
        same_calls = a["calls"] == b["calls"]
        fields = [f for f in a["map"] if not _equal(a["map"][f], b["map"][f])]
        if not _equal(a["res"], b["res"]):
            fields.append("res")
        pcg = "sharded_full_mixed" in b["calls"]
        line = dict(run=name, solvers=b["calls"], same_solvers=same_calls,
                    fields_differing=fields)
        if pcg:
            line["pcg_inputs_equal"] = _equal(a["pcg_in"], b["pcg_in"])
            line["poses_max_abs_diff"] = float(
                (a["map"]["poses"] - b["map"]["poses"]).abs().max())
            ok = same_calls and line["pcg_inputs_equal"]
        else:
            ok = same_calls and not fields
        line["ok"] = ok
        print(json.dumps(line), flush=True)
        summary.append(line)
        if not ok:
            bad.append(name)
    print(json.dumps({"runs": len(summary), "bad": bad,
                      "solvers_seen": sorted({c for s in summary
                                              for c in s["solvers"]})}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
