#!/bin/sh
# First call: K4's ptxas report, its cuda tests, then each refine cell's
# warm solve with every K4 call held in situ and the root launch timed,
# two sets (set 0 again: two runs bit-equal), per-level walls; then the
# parent (_archive/parent) on the same sets; fused maps compared.
top=$(pwd); out=$top/chiprun_out/k4/c1; t0=$(date +%s)
mkdir -p $out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
/usr/local/cuda/bin/nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC -Xptxas -v -c -o /tmp/sp.o linearsfm_tpu_torch/csrc/schur_pairs.cu 2>&1 | tail -4
timeout 400 python3 -m pytest --noconftest tests/test_torch_kernels.py -m cuda -q -x -p no:cacheprovider -k "schur_pairs or sharded or pcg_preconditioner" 2>&1 | tail -4
echo "tests done at $(( $(date +%s) - t0 )) s"
timeout 700 python3 _archive/k4/probe.py --root . --maps-out $out/c --cells nc3500_stereo.covis:2,mono3499_refine.covis:2 --seed 9210001001 --hold > $out/c.log 2>&1
echo "change rc $? at $(( $(date +%s) - t0 )) s"
grep -v '^{' $out/c.log | tail -30
cd _archive/parent
timeout 500 python3 ../k4/probe.py --root . --maps-out $out/p --cells nc3500_stereo.covis:2,mono3499_refine.covis:2 --seed 9210001001 > $out/p.log 2>&1
echo "parent rc $? at $(( $(date +%s) - t0 )) s"
cd $top
grep -v '^{' $out/p.log | tail -8
python3 _archive/k4/diff.py $out/p $out/c
python3 - $out/p.log $out/c.log <<'PY'
import json, sys
for path in sys.argv[1:]:
    for line in open(path):
        if line.startswith("{"):
            r = json.loads(line)
            t = r["timing"]
            print(path.split("/")[-1], r["cell"], r["set"], r["solve_s"], {k: t.get(k) for k in ("levels", "join", "sync", "pcg_sweeps", "pcg_escalations", "k1_launches", "k4_launches")}, "walls ms", [l["device_ms"] for l in r["levels"]], "res", max(l["res_max"] or 0 for l in r["levels"]))
PY
