#!/bin/sh
# A second round for the mono cells, the other order (c p / p c) on new
# seeds, then the parent's traced run on call 2's traced seed; from
# _archive/final (the staged tree) and _archive/parent. No run starts
# after 1,500 s.
top=$(pwd); out=$top/chiprun_out/one_router/c3; t0=$(date +%s)
mkdir -p $out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
one() {  # side workload seed trace
  [ $(( $(date +%s) - t0 )) -gt 1500 ] && { echo "skip $1 $2 $3 $4"; return; }
  if [ $1 = p ]; then cd _archive/parent; else cd _archive/final; fi
  timeout 330 python3 benchmark/run.py --workload $2 --seed $3 --seconds 51 --trace $4 > $out/$2.$1.$3.$4.out 2> $out/$2.$1.$3.$4.err
  echo "$1 $2 $3 trace $4 rc $? at $(( $(date +%s) - t0 )) s"; tail -1 $out/$2.$1.$3.$4.out | cut -c1-300; grep "raised\|Traceback\|Error" $out/$2.$1.$3.$4.err | cut -c1-300
  cd $top
}
for w in mono3499_refine.covis rs468_mono.covis; do
  one c $w 9220003001 0; one p $w 9220003001 0
  one p $w 9220003002 0; one c $w 9220003002 0
  one p $w 9220002003 1
done
