#!/bin/sh
# K4 with fused multiply-adds: ptxas, its cuda tests (stop if they fail),
# every level of each refine cell against the plain version and timed
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
/usr/local/cuda/bin/nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC -Xptxas -v -c -o /tmp/sp.o linearsfm_tpu_torch/csrc/schur_pairs.cu 2>&1 | grep -i "registers\|spill\|error\|warning" | head
timeout 300 python3 -m pytest --noconftest tests/test_torch_kernels.py -m cuda -q -x -p no:cacheprovider -k "schur_pairs" 2>&1 | tail -3 | tee /tmp/t.txt
grep -q failed /tmp/t.txt && exit 1
timeout 600 python3 _archive/k4/ab.py 2>&1 | grep "level\|K4 over\|stat" | grep -v "^  warp"
