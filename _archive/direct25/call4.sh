#!/bin/sh
# Which phase of the RS468 solves switches between the two speeds:
# `regimes.py` over a 51 s window of the chain cell and of the covis cell
# (the torch CPU threads as the benchmark leaves them), then the chain with
# one torch CPU thread; then the padding probe
out=chiprun_out/direct25/c4; mkdir -p $out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
nproc
for a in "rs468_mono.chain 9250040001 0" "rs468_mono.covis 9250040002 0" "rs468_mono.chain 9250040003 1"; do
  set -- $a
  timeout 300 python3 _archive/direct25/regimes.py --cell $1 --seed $2 --threads $3 --json $out/$1.$2.$3.json > $out/$1.$2.$3.log 2>&1
  echo "$1 $2 threads $3 rc $?"; grep -v "Warn\|sparse_csr\|^walls\|^py_probe" $out/$1.$2.$3.log | cut -c1-200
done
# the padding in schur_f64_roofline_pct's least bytes: caps against live
# shapes, one set of each direct cell
timeout 400 python3 _archive/direct25/padding.py > $out/padding.log 2>&1; echo "padding rc $?"
grep -v "Warn\|sparse_csr" $out/padding.log | grep -v "assembly" | cut -c1-300
grep "nc3500_stereo_direct.covis assembly" $out/padding.log | cut -c1-300
