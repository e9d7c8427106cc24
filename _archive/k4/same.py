"""Compare the fused maps that two trees' `probe.py` runs saved, bit for
bit, and the counts the two runs printed.

    python3 _archive/mono20/same.py MAPS_A MAPS_B LOG_A LOG_B
"""
import json
import os
import sys

import torch

a, b, log_a, log_b = sys.argv[1:5]
ok = True
for f in sorted(os.listdir(a)):
    if not f.endswith(".pt"):
        continue
    x, y = torch.load(os.path.join(a, f)), torch.load(os.path.join(b, f))
    diff = [k for k in x if not torch.equal(x[k], y[k])]
    ok &= not diff
    print(f"{f}: torch.equal on every field: {not diff} {diff}")


def rows(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.startswith("{")]


for ra, rb in zip(rows(log_a), rows(log_b)):
    keys = ("k2_launches", "k3_launches", "pcg_sweeps",
            "pcg_escalations")
    same = {k: ra["timing"].get(k) == rb["timing"].get(k) for k in keys}
    ok &= all(same.values())
    print(f"{ra['cell']} set {ra['set']}: counts equal {same}; solve "
          f"{ra['solve_s']} s vs {rb['solve_s']} s; join "
          f"{ra['timing']['join']} + mono_gauge {ra['timing']['mono_gauge']}"
          f" vs join {rb['timing']['join']}")
sys.exit(0 if ok else 1)
