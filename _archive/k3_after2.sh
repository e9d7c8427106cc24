#!/bin/sh
# After the K3 redesign, the part of k3_after.sh that follows the device
# executor's census: K3 by call site on the host executor's direct mono 512
# (one warm pair) and the summation-order cost of stereo refine 2,048 (ten
# warm pairs), every total from a trace with every device record of the run.
set -e
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -m linearsfm_tpu_torch.tools.direct_paths --parts order --paths mono \
  --exec host --maps 512 --reps 1 --profile --out chiprun_out/after_host
python3 -m linearsfm_tpu_torch.tools.direct_paths --parts order --paths stereo \
  --exec device --method refine --maps 2048 --reps 10 --profile \
  --out chiprun_out/order_stereo
