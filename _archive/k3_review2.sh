#!/bin/bash
# After the K3 review: the proof (_archive/archive_proof.sh: chip_smoke.py
# from an archive of the staged tree unpacked into _archive/proof, the cuda
# tests, the script alone), the archive's A/B script on patched copies of
# the port's source (the ring's constants and two ablations), then K3's
# census by call site on both executors' direct mono, every total from a
# trace with every device record and every K3 range.
cd "$(dirname "$0")/.." || exit 9
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
bash _archive/archive_proof.sh; rc=$?
python3 _archive/k3_ab.py --skip-4b --variants 6x32768,8x16384,6x32768a1,6x32768a3 \
  > chiprun_out/k3_ab_review.log 2>&1; echo "k3_ab rc=$?"
grep -E "^ab |^ptxas|^builds|^micro" chiprun_out/k3_ab_review.log | cut -c1-600
tail -2 chiprun_out/k3_ab_review.log | cut -c1-400
for ex in "device 2048" "host 512"; do
  set -- $ex
  python3 -m linearsfm_tpu_torch.tools.direct_paths --parts order --paths mono \
    --exec $1 --maps $2 --reps 1 --profile --out chiprun_out/review_$1 \
    > chiprun_out/review_$1.log 2>&1; echo "census $1 rc=$?"
  grep -E "in all|longest launch|median|attempt" chiprun_out/review_$1.log | cut -c1-400
done
exit $rc
