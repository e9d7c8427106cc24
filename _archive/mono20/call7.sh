#!/bin/sh
# The limits of the mono cell at 3,498 maps, from the committed files
# alone (_archive/final: `git archive` of the staged tree): control.py,
# 12 seeds, 3 control seeds
top=$(pwd); out=$top/chiprun_out/mono20/c7
mkdir -p $out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
cd _archive/final
S=9200007001,9200007002,9200007003,9200007004,9200007005,9200007006,9200007007,9200007008,9200007009,9200007010,9200007011,9200007012
timeout 960 python3 benchmark/control.py --workload mono3499_refine.covis --seeds $S --control-seeds 9200007001,9200007002,9200007003 --json $out/control.mono.json > $out/control.mono.out 2> $out/control.mono.err
echo "control mono rc $?"; cat $out/control.mono.out; grep "sound\|fails" $out/control.mono.err | cut -c1-330
