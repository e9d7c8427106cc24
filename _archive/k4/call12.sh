#!/bin/sh
# K4, each term's dot product by fused multiply-adds then one subtraction:
# its cuda tests (stop if they fail), then sweeps per set on the sets of
# call 11 (seed 9210010003: the parent's rows are in c11/p.log)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
timeout 300 python3 -m pytest --noconftest tests/test_torch_kernels.py -m cuda -q -x -p no:cacheprovider -k "schur_pairs" 2>&1 | tail -3 | tee /tmp/t.txt
grep -q failed /tmp/t.txt && exit 1
top=$(pwd); out=$top/chiprun_out/k4/c12; mkdir -p $out
timeout 600 python3 _archive/k4/probe.py --root . --maps-out /tmp/c --cells mono3499_refine.covis:14,nc3500_stereo.covis:6 --seed 9210010003 > $out/c.log 2>&1; echo "change rc $?"
python3 - chiprun_out/k4/c11/p.log $out/c.log <<'PY'
import json, sys
rows = {}
for path in sys.argv[1:]:
    for line in open(path):
        if line.startswith("{"):
            r = json.loads(line)
            t = r["timing"]
            rows.setdefault((r["cell"], r["set"]), []).append((path.split("/")[-2][-1], r["solve_s"], t["pcg_sweeps"], t["pcg_escalations"], [l["sweeps"] for l in r["levels"] if l["level"] >= 9], "%.2e" % max(l["res_max"] or 0 for l in r["levels"])))
for k, v in rows.items():
    print(k, v)
PY
