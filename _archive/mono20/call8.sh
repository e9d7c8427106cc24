#!/bin/sh
# The mono cell at 3,498 maps from the committed files alone
# (_archive/final): runs with --trace 1 and --trace 0 in turns, each on a
# seed of its own; last, the parent with this tree's benchmark files
# (_archive/parent), traced (it must fail fast or finish). No run starts
# after 1,250 s.
top=$(pwd); out=$top/chiprun_out/mono20/c8; t0=$(date +%s)
mkdir -p $out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
one() {  # side workload seed trace [cut]
  [ $(( $(date +%s) - t0 )) -gt 1250 ] && { echo "skip $1 $3 $4"; return; }
  if [ $1 = p ]; then cd _archive/parent; else cd _archive/final; fi
  timeout 330 python3 benchmark/run.py --workload $2 --seed $3 --seconds 51 --trace $4 > $out/$2.$1.$3.$4.out 2> $out/$2.$1.$3.$4.err
  echo "$1 $2 $3 trace $4 rc $? at $(( $(date +%s) - t0 )) s"; tail -1 $out/$2.$1.$3.$4.out | cut -c1-${5:-700}; grep "check:\|set-up\|solves \|raised\|Traceback\|Error" $out/$2.$1.$3.$4.err | cut -c1-300
  cd $top
}
W=mono3499_refine.covis
one c $W 9200008001 1 2600; one c $W 9200008002 0
one c $W 9200008003 1 2600; one c $W 9200008004 0
one c $W 9200008005 1 2600; one c $W 9200008006 0
one p $W 9200008007 1 1600
