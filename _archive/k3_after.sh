#!/bin/sh
# After the K3 redesign: ptxas and phase 4b with the earlier kernel beside
# the new one (_archive/k3_ab.py), the cuda tests of K3, K3's device time by call
# site on direct mono (device executor 2,048, three warm pairs; host executor
# 512, one pair) and the summation-order cost on stereo refine 2,048 (ten
# warm pairs), every total from a trace with every device record.
set -e
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 _archive/k3_ab.py --variants 6x32768
python3 -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_segment.py -m cuda
python3 -m linearsfm_tpu_torch.tools.direct_paths --parts order --paths mono \
  --exec device --maps 2048 --reps 3 --profile --out chiprun_out/after_device
python3 -m linearsfm_tpu_torch.tools.direct_paths --parts order --paths mono \
  --exec host --maps 512 --reps 1 --profile --out chiprun_out/after_host
python3 -m linearsfm_tpu_torch.tools.direct_paths --parts order --paths stereo \
  --exec device --method refine --maps 2048 --reps 10 --profile \
  --out chiprun_out/order_stereo
