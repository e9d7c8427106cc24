#!/bin/sh
# Card checks of the change: the cuda tests of the kernels' file, the
# three cells' fused maps against the parent's (_archive/parent, `git
# archive` of the parent commit), then chip_smoke.py whole.
top=$(pwd); out=$top/chiprun_out/one_router/c1; mkdir -p $out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
timeout 600 python3 -m pytest --noconftest tests/test_torch_kernels.py -m cuda -q -p no:cacheprovider > $out/tests.log 2>&1
echo "tests rc $?"; tail -3 $out/tests.log
timeout 900 python3 _archive/join_routes_parity.py --other _archive/parent --cuda > $out/parity.log 2> $out/parity.err
echo "parity rc $?"; cut -c1-400 $out/parity.log; tail -3 $out/parity.err
timeout 1700 python3 chip_smoke.py > $out/smoke.out 2> $out/smoke.err
echo "smoke rc $?"
grep -i "K4\|chip_smoke: all\|\"ok\"\|Error\|Traceback\|AssertionError\|timed run\|^mesh" $out/smoke.out | cut -c1-600 | head -80
tail -5 $out/smoke.err
