#!/bin/sh
# From the committed files alone (_archive/final: `git archive` of the
# staged tree): the cuda tests of the kernels' file, then chip_smoke.py
# whole (every K4 call of the 2,048-map main paths' warm runs and of the
# 3,499-map stereo run held in situ, their root launches timed)
top=$(pwd); out=$top/chiprun_out/k4/c14; mkdir -p $out
cd _archive/final
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
timeout 400 python3 -m pytest --noconftest tests/test_torch_kernels.py -m cuda -q -p no:cacheprovider 2>&1 | tail -3
timeout 1700 python3 chip_smoke.py > $out/smoke.out 2> $out/smoke.err
echo "smoke rc $?"
grep -i "K4\|chip_smoke: all\|\"ok\"\|Error\|Traceback\|AssertionError\|timed run" $out/smoke.out | cut -c1-700
tail -5 $out/smoke.err
