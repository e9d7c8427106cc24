#!/bin/sh
# The RS468 chain's readings over 48 more seeds; the fused maps of one or two sets of every cell, this tree against the
# parent (unpacked under _archive/parent with this tree's benchmark files
# laid over it), torch.equal field by field; then six untraced runs
# (distinct seeds) and two traced runs of each new cell
top=$(pwd); out=$top/chiprun_out/direct25/c2; maps=$(mktemp -d)
mkdir -p $out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
# the chain's tail: the first set of 48 more seeds against the reference
S=$(seq -s, 9250023001 9250023048)
timeout 900 python3 benchmark/control.py --workload rs468_mono.chain --seeds $S --control-seeds 9250023001 --json $out/control.chain48.json > $out/control.chain48.out 2> $out/control.chain48.err
echo "control chain48 rc $?"; cat $out/control.chain48.out
C=rs468_mono.covis:2,nc3500_stereo.covis:1,mono3499_refine.covis:1,rs468_mono.chain:2,nc3500_stereo_direct.covis:1
timeout 600 python3 _archive/direct25/probe.py --root . --maps-out $maps/change --seed 9250020001 --cells $C > $out/probe.change.log 2>&1; echo "probe change rc $?"
timeout 600 python3 _archive/direct25/probe.py --root _archive/parent --maps-out $maps/parent --seed 9250020001 --cells $C > $out/probe.parent.log 2>&1; echo "probe parent rc $?"
python3 _archive/mono20/same.py $maps/change $maps/parent $out/probe.change.log $out/probe.parent.log; echo "same rc $?"
rm -rf $maps
grep -v Warning $out/probe.change.log | cut -c1-1500
one() {  # workload seed trace
  timeout 900 python3 benchmark/run.py --workload $1 --seed $2 --seconds 51 --trace $3 > $out/$1.$2.$3.out 2> $out/$1.$2.$3.err
  echo "$1 $2 trace $3 rc $?"; tail -1 $out/$1.$2.$3.out | cut -c1-${4:-700}; grep "check\|set-up\|solves \|raised" $out/$1.$2.$3.err | cut -c1-300
}
for s in 9250021001 9250021002 9250021003 9250021004 9250021005 9250021006; do one nc3500_stereo_direct.covis $s 0; done
for s in 9250021011 9250021012; do one nc3500_stereo_direct.covis $s 1 3000; done
for s in 9250022001 9250022002 9250022003 9250022004 9250022005 9250022006; do one rs468_mono.chain $s 0; done
for s in 9250022011 9250022012; do one rs468_mono.chain $s 1 3000; done
