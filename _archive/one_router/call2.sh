#!/bin/sh
# From the committed files alone (_archive/final: `git archive` of the
# staged tree): the card tests of the sharded PCG, K4 and the root-sized
# K1 list; then the benchmark against the parent (_archive/parent), in
# turns on shared seeds: each cell p c / c p plain, then c traced. No run
# starts after 2,300 s.
top=$(pwd); out=$top/chiprun_out/one_router/c2; t0=$(date +%s)
mkdir -p $out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
(cd _archive/final && timeout 500 python3 -m pytest --noconftest tests/test_torch_kernels.py -m cuda -q -p no:cacheprovider -k "sharded or schur_pairs or main_path_stripe or tile_edges" > $out/tests.log 2>&1; echo "tests rc $?"; tail -2 $out/tests.log)
one() {  # side workload seed trace
  [ $(( $(date +%s) - t0 )) -gt 2300 ] && { echo "skip $1 $2 $3 $4"; return; }
  if [ $1 = p ]; then cd _archive/parent; else cd _archive/final; fi
  timeout 330 python3 benchmark/run.py --workload $2 --seed $3 --seconds 51 --trace $4 > $out/$2.$1.$3.$4.out 2> $out/$2.$1.$3.$4.err
  echo "$1 $2 $3 trace $4 rc $? at $(( $(date +%s) - t0 )) s"; tail -1 $out/$2.$1.$3.$4.out | cut -c1-600; grep "raised\|Traceback\|Error" $out/$2.$1.$3.$4.err | cut -c1-300
  cd $top
}
for w in nc3500_stereo.covis mono3499_refine.covis rs468_mono.covis; do
  one p $w 9220002001 0; one c $w 9220002001 0
  one c $w 9220002002 0; one p $w 9220002002 0
  one c $w 9220002003 1
done
