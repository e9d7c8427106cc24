#!/bin/sh
# The committed tree (git archive of the staged tree, under
# _archive/final) against the parent (_archive/parent, this tree's
# benchmark files laid over it). Fused maps of every cell bit for bit; the
# direct cell traced and untraced; the parent's traced run of the direct
# cell (must not fail); RS468 traced on both sides on one seed (the step
# in join_pct once schur_f64's host time leaves it); one untraced pair in
# each existing cell
top=$(pwd); out=$top/chiprun_out/direct25/c5
mkdir -p $out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
one() {  # side workload seed trace [cut]
  case $1 in p) cd $top/_archive/parent;; c) cd $top/_archive/final;; esac
  timeout 600 python3 benchmark/run.py --workload $2 --seed $3 --seconds 51 --trace $4 > $out/$2.$1.$3.$4.out 2> $out/$2.$1.$3.$4.err
  echo "$1 $2 $3 trace $4 rc $?"; tail -1 $out/$2.$1.$3.$4.out | cut -c1-${5:-600}; grep "check\|set-up\|solves \|raised\|host over" $out/$2.$1.$3.$4.err | cut -c1-300
  cd $top
}
C=rs468_mono.covis:2,nc3500_stereo.covis:1,mono3499_refine.covis:1,nc3500_stereo_direct.covis:1
maps=$(mktemp -d); cd $top/_archive/final
timeout 600 python3 _archive/direct25/probe.py --root . --maps-out $maps/change --seed 9250050001 --cells $C > $out/probe.change.log 2>&1; echo "probe change rc $?"
timeout 600 python3 _archive/direct25/probe.py --root ../parent --maps-out $maps/parent --seed 9250050001 --cells $C > $out/probe.parent.log 2>&1; echo "probe parent rc $?"
python3 _archive/mono20/same.py $maps/change $maps/parent $out/probe.change.log $out/probe.parent.log > $out/same.log 2>&1; echo "same rc $?"; cat $out/same.log | cut -c1-400
cd $top; rm -rf $maps
one c nc3500_stereo_direct.covis 9250051001 1 2500
one p nc3500_stereo_direct.covis 9250051002 1 2500
one c nc3500_stereo_direct.covis 9250051003 0
one p rs468_mono.covis 9250052001 1 2500
one c rs468_mono.covis 9250052001 1 2500
one c nc3500_stereo.covis 9250053001 0
one p nc3500_stereo.covis 9250053001 0
one p rs468_mono.covis 9250053002 0
one c rs468_mono.covis 9250053002 0
one c mono3499_refine.covis 9250053003 0
one p mono3499_refine.covis 9250053003 0
