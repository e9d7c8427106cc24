#!/bin/sh
# The mono cell at 3,498 maps (NC3500's 3,500 frames through one camera),
# from the committed files alone (_archive/final: `git archive` of the
# staged tree): its limits (control.py, 12 seeds, 3 control seeds), then
# 3 runs with --trace 0 and 3 with --trace 1, each on a seed of its own;
# one old cell traced; the parent with this tree's benchmark files
# (_archive/parent) in the mono cell, traced (it must fail fast or finish)
top=$(pwd); out=$top/chiprun_out/mono20/c6
mkdir -p $out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
cd _archive/final
S=9200006001,9200006002,9200006003,9200006004,9200006005,9200006006,9200006007,9200006008,9200006009,9200006010,9200006011,9200006012
timeout 1300 python3 benchmark/control.py --workload mono3499_refine.covis --seeds $S --control-seeds 9200006001,9200006002,9200006003 --json $out/control.mono.json > $out/control.mono.out 2> $out/control.mono.err
echo "control mono rc $?"; cat $out/control.mono.out; grep "sound\|fails" $out/control.mono.err | cut -c1-330
cd $top
one() {  # side workload seed trace [cut]
  if [ $1 = p ]; then cd _archive/parent; else cd _archive/final; fi
  timeout 420 python3 benchmark/run.py --workload $2 --seed $3 --seconds 51 --trace $4 > $out/$2.$1.$3.$4.out 2> $out/$2.$1.$3.$4.err
  echo "$1 $2 $3 trace $4 rc $?"; tail -1 $out/$2.$1.$3.$4.out | cut -c1-${5:-900}; grep "check:\|set-up\|solves \|raised\|Traceback\|Error" $out/$2.$1.$3.$4.err | cut -c1-300
  cd $top
}
for s in 9200006021 9200006022 9200006023; do one c mono3499_refine.covis $s 0; done
for s in 9200006031 9200006032 9200006033; do one c mono3499_refine.covis $s 1 2600; done
one c nc3500_stereo.covis 9200006041 1 1400
one p mono3499_refine.covis 9200006051 1 1400
