#!/bin/sh
# The two old cells traced from the committed files alone
# (_archive/final), on this tree's BENCHMARK.json
top=$(pwd); out=$top/chiprun_out/mono20/c9
mkdir -p $out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
cd _archive/final
for c in "rs468_mono.covis 9200009001" "nc3500_stereo.covis 9200009002"; do
  set -- $c
  timeout 300 python3 benchmark/run.py --workload $1 --seed $2 --seconds 51 --trace 1 > $out/$1.$2.out 2> $out/$1.$2.err
  echo "$1 $2 rc $?"; tail -1 $out/$1.$2.out | cut -c1-1300; grep "check:\|set-up\|Traceback\|Error" $out/$1.$2.err | cut -c1-300
done
