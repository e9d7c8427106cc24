#!/bin/sh
# The final tree from a git archive of it (unpacked under _archive/final):
# the per-level table of the profiling tool, then both cells traced
top=$(pwd); out=$top/chiprun_out/s18/c5
mkdir -p $out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
cd _archive/final
python3 -m linearsfm_tpu_torch.tools.profile_device_tree 512 stereo refine > $out/pdt.log 2>&1; echo "profile_device_tree rc $?"
cut -c1-400 $out/pdt.log | tail -14
for w in rs468_mono.covis nc3500_stereo.covis; do
  python3 benchmark/run.py --workload $w --seed 9180000051 --seconds 51 --trace 1 > $out/$w.out 2> $out/$w.err
  echo "archive $w trace 1 rc $?"; tail -1 $out/$w.out | cut -c1-1100; grep "check:\|set-up" $out/$w.err | cut -c1-200
done
