#!/bin/sh
# K5's first call on the card: build with ptxas's report, the cuda tests of
# K5, and a short timing of K5 against the plain transform.
set -x
nvidia-smi --query-gpu=name,power.limit,clocks.sm --format=csv,noheader
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
mkdir -p chiprun_out/k5
/usr/local/cuda/bin/nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
  -Xptxas -v -c -o chiprun_out/k5/gc.o linearsfm_tpu_torch/csrc/gauge_congruence.cu 2>&1 | grep -E "Function properties|registers|spill|error" | head -60
timeout 900 python3 -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels.py -m cuda -k gauge_congruence -x 2>&1 | tail -30
timeout 300 python3 _archive/k5/time.py 2>&1 | tail -40
