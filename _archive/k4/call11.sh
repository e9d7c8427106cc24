#!/bin/sh
# Sweeps and escalations per set, the change against the parent on the
# same sets: mono refine 14 sets and NC3500 6 sets of the traced runs'
# seed (9210010003), per-level rows; fused maps under /tmp
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
top=$(pwd); out=$top/chiprun_out/k4/c11; mkdir -p $out
timeout 600 python3 _archive/k4/probe.py --root . --maps-out /tmp/c --cells mono3499_refine.covis:14,nc3500_stereo.covis:6 --seed 9210010003 > $out/c.log 2>&1; echo "change rc $?"
cd _archive/parent
timeout 600 python3 ../k4/probe.py --root . --maps-out /tmp/p --cells mono3499_refine.covis:14,nc3500_stereo.covis:6 --seed 9210010003 > $out/p.log 2>&1; echo "parent rc $?"
cd $top
python3 _archive/k4/diff.py /tmp/p /tmp/c | cut -c1-200
python3 - $out/p.log $out/c.log <<'PY'
import json, sys
rows = {}
for path in sys.argv[1:]:
    for line in open(path):
        if line.startswith("{"):
            r = json.loads(line)
            t = r["timing"]
            key = (r["cell"], r["set"])
            rows.setdefault(key, []).append((path.split("/")[-1][0], r["solve_s"], t["pcg_sweeps"], t["pcg_escalations"], [(l["level"], l["sweeps"], l["esc"]) for l in r["levels"] if l["level"] >= 9], max(l["res_max"] or 0 for l in r["levels"])))
for k, v in rows.items():
    print(k, v)
PY
