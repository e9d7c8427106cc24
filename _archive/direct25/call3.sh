#!/bin/sh
# The committed tree (git archive of the staged tree, unpacked under
# _archive/final) on its own: each new cell traced and untraced; then the
# parent (_archive/parent, this tree's benchmark files laid over it)
# against it in each existing cell on shared seeds, in turns, and the
# parent's traced runs of the new cells (they must not fail)
top=$(pwd); out=$top/chiprun_out/direct25/c3
mkdir -p $out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
one() {  # side workload seed trace
  case $1 in p) cd $top/_archive/parent;; c) cd $top/_archive/final;; esac
  timeout 900 python3 benchmark/run.py --workload $2 --seed $3 --seconds 51 --trace $4 > $out/$2.$1.$3.$4.out 2> $out/$2.$1.$3.$4.err
  echo "$1 $2 $3 trace $4 rc $?"; tail -1 $out/$2.$1.$3.$4.out | cut -c1-${5:-600}; grep "check\|set-up\|solves \|raised" $out/$2.$1.$3.$4.err | cut -c1-300
  cd $top
}
# the fused maps of every cell, committed tree against the parent, bit for
# bit (same.py's lines kept in a file as well as printed)
C=rs468_mono.covis:2,nc3500_stereo.covis:1,mono3499_refine.covis:1,rs468_mono.chain:1,nc3500_stereo_direct.covis:1
maps=$(mktemp -d); cd $top/_archive/final
timeout 600 python3 _archive/direct25/probe.py --root . --maps-out $maps/change --seed 9250030001 --cells $C > $out/probe.change.log 2>&1; echo "probe change rc $?"
timeout 600 python3 _archive/direct25/probe.py --root ../parent --maps-out $maps/parent --seed 9250030001 --cells $C > $out/probe.parent.log 2>&1; echo "probe parent rc $?"
python3 _archive/mono20/same.py $maps/change $maps/parent $out/probe.change.log $out/probe.parent.log > $out/same.log 2>&1; echo "same rc $?"; cat $out/same.log
cd $top; rm -rf $maps
one c nc3500_stereo_direct.covis 9250031001 1 2500
one c rs468_mono.chain 9250031002 1 2500
one c nc3500_stereo_direct.covis 9250031003 0
one c rs468_mono.chain 9250031004 0
one p nc3500_stereo.covis 9250032001 0
one c nc3500_stereo.covis 9250032001 0
one c rs468_mono.covis 9250032002 0
one p rs468_mono.covis 9250032002 0
one p mono3499_refine.covis 9250032003 0
one c mono3499_refine.covis 9250032003 0
one p nc3500_stereo_direct.covis 9250033001 1 2500
one p rs468_mono.chain 9250033002 1 2500
cd $top/_archive/final && timeout 300 python3 _archive/direct25/allocs.py --sets 2 > $out/allocs.log 2>&1; echo "allocs rc $?"; grep -v Warning $out/allocs.log | cut -c1-1200
