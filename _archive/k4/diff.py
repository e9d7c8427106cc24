"""Largest |a - b| per field between two trees' fused maps (probe.py's
--maps-out), and whether they are bit-equal.

    python3 _archive/k4/diff.py MAPS_A MAPS_B
"""
import os
import sys

import torch

a, b = sys.argv[1:3]
for f in sorted(os.listdir(a)):
    if not f.endswith(".pt"):
        continue
    x, y = torch.load(os.path.join(a, f)), torch.load(os.path.join(b, f))
    out = {}
    for k in ("pose_ids", "poses", "feat_ids", "feats"):
        if x[k].is_floating_point():
            ok = torch.isfinite(x[k]) & torch.isfinite(y[k])
            out[k] = float((x[k] - y[k])[ok].abs().max()) if ok.any() else 0.0
        else:
            out[k] = bool(torch.equal(x[k], y[k]))
    same = all(torch.equal(x[k], y[k]) for k in x)
    print(f"{f}: bit-equal {same}; {out}")
