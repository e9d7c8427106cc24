#!/bin/sh
# 1. the probe on this tree and the parent's (fused maps compared bit for
# bit); 2. end to end with tracing off: parent, change, change, parent in
# each cell, the two sides of a pair on one seed
top=$(pwd); out=$top/chiprun_out/s18/c2; maps=$(mktemp -d)
mkdir -p $out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 _archive/spans18/probe.py --root . --maps-out $maps/change --pairs 2 > $out/change.log 2>&1; echo "probe change rc $?"
python3 _archive/spans18/probe.py --root _archive/parent --maps-out $maps/parent --save-only > $out/parent.log 2>&1; echo "probe parent rc $?"
python3 _archive/spans18/same.py $maps/change $maps/parent; echo "same rc $?"
rm -rf $maps
grep -v "level {" $out/change.log | cut -c1-1200
cut -c1-400 $out/parent.log
one() {  # side workload seed
  if [ $1 = p ]; then cd _archive/parent; fi
  python3 benchmark/run.py --workload $2 --seed $3 --seconds 51 --trace 0 > $out/$2.$1.$3.out 2> $out/$2.$1.$3.err
  echo "$1 $2 $3 rc $?"; tail -1 $out/$2.$1.$3.out | cut -c1-600; grep "check:\|set-up" $out/$2.$1.$3.err | cut -c1-200
  cd $top
}
for w in rs468_mono.covis nc3500_stereo.covis; do
  one p $w 9180000021; one c $w 9180000021
  one c $w 9180000022; one p $w 9180000022
done
# 3. the committed files alone: both cells traced from a git archive of
# the staged tree (unpacked under _archive/final)
cd _archive/final
for w in rs468_mono.covis nc3500_stereo.covis; do
  python3 benchmark/run.py --workload $w --seed 9180000031 --seconds 51 --trace 1 > $out/$w.final.out 2> $out/$w.final.err
  echo "archive $w trace 1 rc $?"; tail -1 $out/$w.final.out | cut -c1-1100; grep "check:\|set-up" $out/$w.final.err | cut -c1-200
done
cd $top
