#!/bin/sh
# K4 (warp per 32 blocks of a row, staged walk): ptxas, cuda tests, every
# level of each refine cell against the plain version and timed
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
/usr/local/cuda/bin/nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC -Xptxas -v -c -o /tmp/sp.o linearsfm_tpu_torch/csrc/schur_pairs.cu 2>&1 | grep -i "registers\|spill\|error\|warning" | head
timeout 300 python3 -m pytest --noconftest tests/test_torch_kernels.py -m cuda -q -x -p no:cacheprovider -k "schur_pairs" 2>&1 | tail -3
timeout 600 python3 _archive/k4/ab.py 2>&1 | grep -v Warning | tail -30
