#!/bin/sh
# K5 with the emission prefetch: ptxas, the cuda tests, phase 5b's timings
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
/usr/local/cuda/bin/nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
  -Xptxas -v -c -o chiprun_out/k5/gc.o linearsfm_tpu_torch/csrc/gauge_congruence.cu 2>&1 | grep -A2 "gc_emit" | grep -E "registers|spill" | head -8
timeout 600 python3 -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels.py -m cuda -k gauge_congruence 2>&1 | tail -3
timeout 600 python3 _archive/k5/phase5b.py 2>&1 | tail -20
