#!/bin/bash
# The final run: the proof (_archive/archive_proof.sh: chip_smoke.py from
# an archive of the staged tree, the cuda tests, the script alone), then
# K3's census with chain floors on both executors' direct mono.
cd "$(dirname "$0")/.." || exit 9
bash _archive/archive_proof.sh; rc=$?
python3 -m linearsfm_tpu_torch.tools.direct_paths --parts order --paths mono \
  --exec device --maps 2048 --reps 1 --profile --out chiprun_out/final_device \
  | grep -E "in all|longest launch|median"
python3 -m linearsfm_tpu_torch.tools.direct_paths --parts order --paths mono \
  --exec host --maps 512 --reps 1 --profile --out chiprun_out/final_host \
  | grep -E "in all|longest launch|median"
exit $rc
