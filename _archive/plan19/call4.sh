#!/bin/sh
# The tree after review (_archive/final, a git archive of the staged
# files) against the parent (_archive/parent): chip.py on both (fused maps
# and the multi-host root bit for bit, counts, the planner and
# common_root_caps alone), both cells traced, then --trace 0 in turns,
# each pair on a seed of its own, the side that runs first alternating
top=$(pwd); out=$top/chiprun_out/plan19/c4; maps=$(mktemp -d)
mkdir -p $out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
python3 _archive/plan19/chip.py --root _archive/final --maps-out $maps/change --seed 9190000003 > $out/probe.change.log 2>&1; echo "probe change rc $?"
python3 _archive/plan19/chip.py --root _archive/parent --maps-out $maps/parent --seed 9190000003 > $out/probe.parent.log 2>&1; echo "probe parent rc $?"
python3 _archive/plan19/same.py $maps/change $maps/parent $out/probe.change.log $out/probe.parent.log; echo "same rc $?"
rm -rf $maps
cut -c1-600 $out/probe.change.log | tail -7; cut -c1-600 $out/probe.parent.log | tail -7
one() {  # side workload seed trace
  if [ $1 = p ]; then cd _archive/parent; else cd _archive/final; fi
  python3 benchmark/run.py --workload $2 --seed $3 --seconds 51 --trace $4 > $out/$2.$1.$3.$4.out 2> $out/$2.$1.$3.$4.err
  echo "$1 $2 $3 trace $4 rc $?"; tail -1 $out/$2.$1.$3.$4.out | cut -c1-${5:-700}; grep "check:\|set-up" $out/$2.$1.$3.$4.err | cut -c1-200
  cd $top
}
for w in nc3500_stereo.covis rs468_mono.covis; do
  one c $w 9190000061 1 3000
done
for w in nc3500_stereo.covis rs468_mono.covis; do
  one p $w 9190000071 0; one c $w 9190000071 0
  one c $w 9190000072 0; one p $w 9190000072 0
done
