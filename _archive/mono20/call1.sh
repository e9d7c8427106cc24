#!/bin/sh
# First look on the card: the mono 3,499 refine solves with their level
# rows, one run of each new cell, and the parent with the new benchmark
# files in the mono cell (it must fail fast or finish)
top=$(pwd); out=$top/chiprun_out/mono20/c1; maps=$(mktemp -d)
mkdir -p $out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
timeout 600 python3 _archive/mono20/probe.py --root . --maps-out $maps/change --cells mono3499_refine.covis:2,nc3500_stereo.chain:1 > $out/probe.change.log 2>&1; echo "probe change rc $?"
cut -c1-3000 $out/probe.change.log | grep -v Warning
rm -rf $maps
one() {  # side workload seed trace
  if [ $1 = p ]; then cd _archive/parent; fi
  timeout 600 python3 benchmark/run.py --workload $2 --seed $3 --seconds 51 --trace $4 > $out/$2.$1.$3.$4.out 2> $out/$2.$1.$3.$4.err
  echo "$1 $2 $3 trace $4 rc $?"; tail -1 $out/$2.$1.$3.$4.out | cut -c1-${5:-900}; grep "check:\|set-up\|solves \|raised" $out/$2.$1.$3.$4.err | cut -c1-300
  cd $top
}
one c mono3499_refine.covis 9200000101 0
one c nc3500_stereo.chain 9200000102 0
one p mono3499_refine.covis 9200000103 0
