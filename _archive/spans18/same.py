"""Compare the fused maps that two trees' probe runs saved, bit for bit.

    python3 _archive/spans18/same.py DIR_A DIR_B
"""
import os
import sys

import torch

a, b = sys.argv[1:3]
ok = True
for f in sorted(os.listdir(a)):
    if not f.endswith(".pt"):
        continue
    x, y = torch.load(os.path.join(a, f)), torch.load(os.path.join(b, f))
    diff = [k for k in x if not torch.equal(x[k], y[k])]
    ok &= not diff
    print(f"{f}: torch.equal on every field: {not diff} {diff}")
sys.exit(0 if ok else 1)
