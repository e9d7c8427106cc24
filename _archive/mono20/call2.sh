#!/bin/sh
# The limits of the mono refine cell (control.py, 12 seeds, 3 control
# seeds), the chain mix's readings (4 seeds, 2 control seeds), then the
# probe on this tree and the parent: fused maps bit for bit
top=$(pwd); out=$top/chiprun_out/mono20/c2; maps=$(mktemp -d)
mkdir -p $out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
S=9200001001,9200001002,9200001003,9200001004,9200001005,9200001006,9200001007,9200001008,9200001009,9200001010,9200001011,9200001012
timeout 1500 python3 benchmark/control.py --workload mono3499_refine.covis --seeds $S --control-seeds 9200001001,9200001002,9200001003 --json $out/control.mono.json > $out/control.mono.out 2> $out/control.mono.err
echo "control mono rc $?"; cat $out/control.mono.out; grep "control\|f32\|sound" $out/control.mono.err | cut -c1-400
timeout 600 python3 benchmark/control.py --workload nc3500_stereo.chain --seeds 9200001021,9200001022,9200001023,9200001024 --control-seeds 9200001021,9200001022 --json $out/control.chain.json > $out/control.chain.out 2> $out/control.chain.err
echo "control chain rc $?"; cat $out/control.chain.out; grep "control\|f32\|sound" $out/control.chain.err | cut -c1-400
C=rs468_mono.covis:3,nc3500_stereo.covis:3,mono3499_refine.covis:2
timeout 400 python3 _archive/mono20/probe.py --root . --maps-out $maps/change --cells $C > $out/probe.change.log 2>&1; echo "probe change rc $?"
timeout 400 python3 _archive/mono20/probe.py --root _archive/parent --maps-out $maps/parent --cells $C > $out/probe.parent.log 2>&1; echo "probe parent rc $?"
python3 _archive/mono20/same.py $maps/change $maps/parent $out/probe.change.log $out/probe.parent.log; echo "same rc $?"
rm -rf $maps
