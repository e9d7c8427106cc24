#!/bin/sh
# K3's device time by call site (direct_paths --profile) on the device
# executor's direct mono 2,048 and the host executor's direct mono 512, one
# warm pair each; summary lines to stdout, JSON under chiprun_out/step0_*.
set -e
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)'
python3 -m linearsfm_tpu_torch.tools.direct_paths --parts order --paths mono \
  --exec device --maps 2048 --reps 1 --profile --out chiprun_out/step0_device \
  | grep -v " pair "
python3 -m linearsfm_tpu_torch.tools.direct_paths --parts order --paths mono \
  --exec host --maps 512 --reps 1 --profile --out chiprun_out/step0_host \
  | grep -v " pair "
