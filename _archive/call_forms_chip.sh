#!/bin/bash
# One chip call: the whole smoke run, the cuda tests, and the fixed-order
# timings of direct mono (default sums against ops/segment.deterministic):
# the device and dense executors at 2,048 maps in 10 warm pairs with one
# profiled run of each mode, the host executor at 512 maps in 3 pairs.
out=chiprun_out/call_forms
mkdir -p $out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
t0=$(date +%s)
python3 chip_smoke.py > $out/smoke.log 2>&1; rc=$?
echo "smoke rc=$rc in $(( $(date +%s) - t0 )) s"
grep -E "^call forms|^main (stereo|mono): (ATE|timed)|chip_smoke: all phases|: phase [0-9.]+ s|^tools compare_ate stereo: 512" $out/smoke.log | cut -c1-400
tail -3 $out/smoke.log | cut -c1-3000
python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_kernels.py tests/test_torch_dense.py tests/test_torch_entry_points.py -m cuda > $out/cuda_tests.log 2>&1
echo "cuda tests rc=$?"; tail -2 $out/cuda_tests.log
python3 -m linearsfm_tpu_torch.tools.direct_paths --parts order --paths mono --exec device,dense --reps 10 --profile --out $out/dp_2048 > $out/dp_2048.log 2>&1
echo "dp 2048 rc=$?"; grep -E "^order mono (device|dense)(:| profile)" $out/dp_2048.log | cut -c1-600
python3 -m linearsfm_tpu_torch.tools.direct_paths --parts order --paths mono --exec host --maps 512 --reps 3 --out $out/dp_host > $out/dp_host.log 2>&1
echo "dp host rc=$?"; grep -E "^order mono host:" $out/dp_host.log
exit $rc
