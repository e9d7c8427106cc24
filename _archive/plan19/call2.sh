#!/bin/sh
# The final tree from a git archive of the staged files (_archive/final)
# against the parent (_archive/parent): chip.py on both (fused maps bit
# for bit, counts, the planner alone), both cells traced from the
# archive, then --trace 0 in turns, each pair on a seed of its own, the
# side that runs first alternating
top=$(pwd); out=$top/chiprun_out/plan19/c2; maps=$(mktemp -d)
mkdir -p $out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 _archive/plan19/chip.py --root _archive/final --maps-out $maps/change --seed 9190000002 > $out/probe.change.log 2>&1; echo "probe change rc $?"
python3 _archive/plan19/chip.py --root _archive/parent --maps-out $maps/parent --seed 9190000002 > $out/probe.parent.log 2>&1; echo "probe parent rc $?"
python3 _archive/plan19/same.py $maps/change $maps/parent $out/probe.change.log $out/probe.parent.log; echo "same rc $?"
rm -rf $maps
one() {  # side workload seed trace
  if [ $1 = p ]; then cd _archive/parent; else cd _archive/final; fi
  python3 benchmark/run.py --workload $2 --seed $3 --seconds 51 --trace $4 > $out/$2.$1.$3.$4.out 2> $out/$2.$1.$3.$4.err
  echo "$1 $2 $3 trace $4 rc $?"; tail -1 $out/$2.$1.$3.$4.out | cut -c1-${5:-700}; grep "check:\|set-up" $out/$2.$1.$3.$4.err | cut -c1-200
  cd $top
}
for w in nc3500_stereo.covis rs468_mono.covis; do
  one c $w 9190000031 1 1500
done
for w in nc3500_stereo.covis rs468_mono.covis; do
  one c $w 9190000041 0; one p $w 9190000041 0
  one p $w 9190000042 0; one c $w 9190000042 0
  one c $w 9190000043 0; one p $w 9190000043 0
done
