#!/bin/sh
# The fixed order's chip measurements (one H100, about 10 min of command):
# K3's plans and launches per run on this tree and on the parent commit
# unpacked (`git archive`) under _archive/parent, then fixed vs atomic
# order over 10 warm pairs on four paths (`direct_paths --parts order`;
# stereo refine with --profile). Output under chiprun_out/fixed_order/.
#     sh _archive/fixed_order.sh
O=chiprun_out/fixed_order
mkdir -p $O
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
python3 _archive/plan_count.py --out $O/plans_change.json
(cd _archive/parent && python3 ../plan_count.py --out ../../$O/plans_parent.json)
python3 _archive/plan_count.py --out $O/plans_change2.json
DP="python3 -m linearsfm_tpu_torch.tools.direct_paths --parts order --reps 10"
$DP --paths stereo --exec device --method refine --profile --out $O/dp_stereo_refine
$DP --paths mono --exec device --method refine --out $O/dp_mono_refine
$DP --paths mono --exec device --method direct --out $O/dp_mono_direct
$DP --paths stereo --exec host --method direct --maps 512 --out $O/dp_host_stereo
