#!/bin/bash
# One chip call: the whole smoke run, the cuda tests, and the fixed-order
# timings (default sums against ops/segment.deterministic, kernel K3):
# direct mono on the device executor at 2,048 maps and on the host
# executor at 512 maps, 10 warm pairs each with one profiled run of each
# mode; the ate part on direct mono 2,048 (default, PyTorch's mode, K3);
# and what the scope would cost the stereo refine main path (5 pairs).
out=chiprun_out/k3
mkdir -p $out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
t0=$(date +%s)
python3 chip_smoke.py > $out/smoke.log 2>&1; rc=$?
echo "smoke rc=$rc in $(( $(date +%s) - t0 )) s"
grep -E "^k3 time|^call forms|^main (stereo|mono): (ATE|timed)|^entry cli mono|chip_smoke: all phases|: phase [0-9.]+ s|^build" $out/smoke.log | cut -c1-420
tail -3 $out/smoke.log | cut -c1-3500
python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_kernels.py tests/test_torch_dense.py tests/test_torch_entry_points.py tests/test_torch_segment.py -m cuda > $out/cuda_tests.log 2>&1
echo "cuda tests rc=$?"; tail -2 $out/cuda_tests.log
dp="python3 -m linearsfm_tpu_torch.tools.direct_paths"
$dp --parts order --paths mono --exec device --reps 10 --profile --out $out/dp_dev > $out/dp_dev.log 2>&1
echo "dp device rc=$?"; grep -E "^order mono device(:| profile)" $out/dp_dev.log | cut -c1-900
$dp --parts order --paths mono --exec host --maps 512 --reps 10 --profile --out $out/dp_host > $out/dp_host.log 2>&1
echo "dp host rc=$?"; grep -E "^order mono host(:| profile)" $out/dp_host.log | cut -c1-900
$dp --parts ate --paths mono --reps 3 --out $out/dp_ate > $out/dp_ate.log 2>&1
echo "dp ate rc=$?"; grep -E "^ate mono [a-z]+:|^ate mono: root" $out/dp_ate.log | cut -c1-900
$dp --parts order --paths stereo --method refine --exec device --reps 5 --profile --out $out/dp_refine > $out/dp_refine.log 2>&1
echo "dp refine rc=$?"; grep -E "^order stereo device(:| profile)" $out/dp_refine.log | cut -c1-900
exit $rc
