#!/bin/bash
# First chip call of K3: build, phase 4b, direct mono 2,048, the cuda tests
# of tests/test_torch_segment.py.
out=chiprun_out/k3_first
mkdir -p $out
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
python3 _archive/k3_check.py > $out/k3_check.log 2>&1; rc=$?
echo "k3_check rc=$rc"; grep -vE "^k3 (lane|K=0|all|empty|one|unsorted)" $out/k3_check.log | cut -c1-900 | tail -40
python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_segment.py -m cuda > $out/cuda_tests.log 2>&1
echo "cuda tests rc=$?"; tail -15 $out/cuda_tests.log
exit $rc
