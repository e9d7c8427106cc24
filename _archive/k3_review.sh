#!/bin/bash
# One chip call: K3's holds (_archive/k3_review.py), the plan cache on
# and off (_archive/k3_plan_ab.py) and the cuda tests of K3.
out=chiprun_out/k3_review
mkdir -p $out
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
python3 _archive/k3_review.py > $out/review.log 2>&1; rc=$?
echo "review rc=$rc"; grep -vE "^k3 (lane|K=0|all|empty|one|unsorted)" $out/review.log | cut -c1-700 | tail -25
python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_segment.py -m cuda > $out/cuda_tests.log 2>&1
echo "cuda tests rc=$?"; tail -3 $out/cuda_tests.log
python3 _archive/k3_plan_ab.py --reps 10 --out $out/plan_ab.json > $out/plan_ab.log 2>&1
echo "plan ab rc=$?"; grep -E "^NVIDIA|: cache off vs on|Error|error" $out/plan_ab.log | cut -c1-600
grep -E "pair [01] " $out/plan_ab.log | cut -c1-300
exit $rc
