#!/bin/sh
# Five more pairs a cell, --trace 0, the final tree (_archive/final, a
# git archive of the staged files) against the parent (_archive/parent),
# each pair on a seed of its own, the side that runs first alternating
top=$(pwd); out=$top/chiprun_out/plan19/c3
mkdir -p $out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
one() {  # side workload seed
  if [ $1 = p ]; then cd _archive/parent; else cd _archive/final; fi
  python3 benchmark/run.py --workload $2 --seed $3 --seconds 51 --trace 0 > $out/$2.$1.$3.0.out 2> $out/$2.$1.$3.0.err
  echo "$1 $2 $3 rc $?"; tail -1 $out/$2.$1.$3.0.out | cut -c1-330; grep "set-up" $out/$2.$1.$3.0.err | cut -c1-200
  cd $top
}
for w in rs468_mono.covis nc3500_stereo.covis; do
  one p $w 9190000051; one c $w 9190000051
  one c $w 9190000052; one p $w 9190000052
  one p $w 9190000053; one c $w 9190000053
  one c $w 9190000054; one p $w 9190000054
  one p $w 9190000055; one c $w 9190000055
done
