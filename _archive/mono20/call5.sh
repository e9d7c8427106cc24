#!/bin/sh
# From the committed files alone (_archive/final: `git archive` of the
# staged tree) and the parent with those benchmark files laid over it
# (_archive/parent): the mono cell traced and plain, one old cell traced,
# the mono cell traced on the parent; RS468 traced in turns (join_pct
# against join_pct + mono_gauge_pct); then --trace 0 in turns, parent,
# change, change, parent, the two sides of a pair on one seed
top=$(pwd); out=$top/chiprun_out/mono20/c5
mkdir -p $out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
one() {  # side workload seed trace [cut]
  if [ $1 = p ]; then cd _archive/parent; else cd _archive/final; fi
  timeout 600 python3 benchmark/run.py --workload $2 --seed $3 --seconds 51 --trace $4 > $out/$2.$1.$3.$4.out 2> $out/$2.$1.$3.$4.err
  echo "$1 $2 $3 trace $4 rc $?"; tail -1 $out/$2.$1.$3.$4.out | cut -c1-${5:-900}; grep "check:\|set-up\|solves \|raised\|mono_pcg\|Traceback\|Error" $out/$2.$1.$3.$4.err | cut -c1-300
  cd $top
}
one c mono3499_refine.covis 9200005001 1 1400
one c mono3499_refine.covis 9200005002 0
one c nc3500_stereo.covis 9200005003 1 1400
one p mono3499_refine.covis 9200005004 1 1400
one p rs468_mono.covis 9200005011 1 1400; one c rs468_mono.covis 9200005011 1 1400
one c rs468_mono.covis 9200005012 1 1400; one p rs468_mono.covis 9200005012 1 1400
one p rs468_mono.covis 9200005013 1 1400; one c rs468_mono.covis 9200005013 1 1400
for w in nc3500_stereo.covis rs468_mono.covis; do
  one p $w 9200005021 0; one c $w 9200005021 0
  one c $w 9200005022 0; one p $w 9200005022 0
done
