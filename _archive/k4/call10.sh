#!/bin/sh
# The benchmark (K4 with fused multiply-adds): the change (this tree) and
# the parent (_archive/parent) in turns, the two sides of a pair on one
# seed: NC3500 and mono refine p c / c p plain and c p traced, RS468 p c
# plain and c traced. No run starts after 2,100 s.
top=$(pwd); out=$top/chiprun_out/k4/c10; t0=$(date +%s)
mkdir -p $out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
one() {  # side workload seed trace
  [ $(( $(date +%s) - t0 )) -gt 2100 ] && { echo "skip $1 $2 $3 $4"; return; }
  if [ $1 = p ]; then cd _archive/parent; fi
  timeout 330 python3 benchmark/run.py --workload $2 --seed $3 --seconds 51 --trace $4 > $out/$2.$1.$3.$4.out 2> $out/$2.$1.$3.$4.err
  echo "$1 $2 $3 trace $4 rc $? at $(( $(date +%s) - t0 )) s"; tail -1 $out/$2.$1.$3.$4.out | cut -c1-1500; grep "check:\|raised\|Traceback\|Error" $out/$2.$1.$3.$4.err | cut -c1-300
  cd $top
}
for w in nc3500_stereo.covis mono3499_refine.covis; do
  one p $w 9210010001 0; one c $w 9210010001 0
  one c $w 9210010002 0; one p $w 9210010002 0
  one c $w 9210010003 1; one p $w 9210010003 1
done
one p rs468_mono.covis 9210010011 0; one c rs468_mono.covis 9210010011 0
one c rs468_mono.covis 9210010012 1
