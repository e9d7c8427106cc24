#!/bin/sh
# The spans on the card: the probe on this tree and the parent's (fused
# maps compared), then --trace 1 runs: two a cell on this tree, one a cell
# on the parent with this tree's benchmark files laid over it
top=$(pwd); out=$top/chiprun_out/s18/c1
mkdir -p $out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
python3 _archive/spans18/probe.py --root . --out $out/change --pairs 2 > $out/change.log 2>&1; echo "probe change rc $?"
python3 _archive/spans18/probe.py --root _archive/parent --out $out/parent --save-only > $out/parent.log 2>&1; echo "probe parent rc $?"
python3 _archive/spans18/same.py $out/change $out/parent; echo "same rc $?"
grep -v "level {" $out/change.log | cut -c1-1800
grep "level {" $out/change.log | cut -c1-420
cut -c1-700 $out/parent.log
for w in rs468_mono.covis nc3500_stereo.covis; do
  for s in 9180000011 9180000012; do
    python3 benchmark/run.py --workload $w --seed $s --seconds 51 --trace 1 > $out/$w.c.$s.out 2> $out/$w.c.$s.err
    echo "change $w $s trace 1 rc $?"; tail -1 $out/$w.c.$s.out | cut -c1-2500; grep "check:\|set-up\|profil" $out/$w.c.$s.err
  done
  cd _archive/parent
  s=9180000013
  python3 benchmark/run.py --workload $w --seed $s --seconds 51 --trace 1 > $out/$w.p.$s.out 2> $out/$w.p.$s.err
  echo "parent $w $s trace 1 rc $?"; tail -1 $out/$w.p.$s.out | cut -c1-1500; grep "check:\|set-up\|profil" $out/$w.p.$s.err
  cd $top
done
