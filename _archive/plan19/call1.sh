#!/bin/sh
# The array planner on the card: chip.py on this tree and the parent's
# (fused maps compared bit for bit, counts, the planner alone), then
# --trace 1 in each cell on both trees, then --trace 0 in turns: parent,
# change, change, parent, the two sides of a pair on one seed
top=$(pwd); out=$top/chiprun_out/plan19/c1; maps=$(mktemp -d)
mkdir -p $out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
python3 _archive/plan19/chip.py --root . --maps-out $maps/change > $out/probe.change.log 2>&1; echo "probe change rc $?"
python3 _archive/plan19/chip.py --root _archive/parent --maps-out $maps/parent > $out/probe.parent.log 2>&1; echo "probe parent rc $?"
python3 _archive/plan19/same.py $maps/change $maps/parent $out/probe.change.log $out/probe.parent.log; echo "same rc $?"
rm -rf $maps
cut -c1-600 $out/probe.change.log; cut -c1-600 $out/probe.parent.log
one() {  # side workload seed trace
  if [ $1 = p ]; then cd _archive/parent; fi
  python3 benchmark/run.py --workload $2 --seed $3 --seconds 51 --trace $4 > $out/$2.$1.$3.$4.out 2> $out/$2.$1.$3.$4.err
  echo "$1 $2 $3 trace $4 rc $?"; tail -1 $out/$2.$1.$3.$4.out | cut -c1-${5:-700}; grep "check:\|set-up" $out/$2.$1.$3.$4.err | cut -c1-200
  cd $top
}
for w in nc3500_stereo.covis rs468_mono.covis; do
  one c $w 9190000011 1 3000; one p $w 9190000011 1 3000
done
for w in nc3500_stereo.covis rs468_mono.covis; do
  one p $w 9190000021 0; one c $w 9190000021 0
  one c $w 9190000022 0; one p $w 9190000022 0
done
