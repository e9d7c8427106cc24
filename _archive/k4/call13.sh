#!/bin/sh
# Sweeps per set with the dense product's accumulation (variant_g.py, on a
# copy of the tree under /tmp/g) on call 11's sets
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
top=$(pwd); out=$top/chiprun_out/k4/c13; mkdir -p $out /tmp/g
cp -r benchmark BENCHMARK.json synth linearsfm_tpu_torch chip_smoke.py _archive /tmp/g/ 2>/dev/null; rm -rf /tmp/g/_archive/parent /tmp/g/linearsfm_tpu_torch/_build
python3 _archive/k4/variant_g.py /tmp/g || exit 1
cd /tmp/g
timeout 600 python3 _archive/k4/probe.py --root . --maps-out /tmp/gm --cells mono3499_refine.covis:14,nc3500_stereo.covis:6 --seed 9210010003 > $out/g.log 2>&1; echo "g rc $?"
tail -3 $out/g.log | cut -c1-300
