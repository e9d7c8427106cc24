#!/bin/sh
# The mono refine cell on the card: 6 runs with --trace 0 and 3 with
# --trace 1, each on a seed of its own; then where the chain mix's gap
# comes from (NC3500 under the chain mix, refine and direct against the
# reference)
top=$(pwd); out=$top/chiprun_out/mono20/c3
mkdir -p $out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
one() {  # side workload seed trace
  if [ $1 = p ]; then cd _archive/parent; fi
  timeout 600 python3 benchmark/run.py --workload $2 --seed $3 --seconds 51 --trace $4 > $out/$2.$1.$3.$4.out 2> $out/$2.$1.$3.$4.err
  echo "$1 $2 $3 trace $4 rc $?"; tail -1 $out/$2.$1.$3.$4.out | cut -c1-${5:-1200}; grep "check:\|set-up\|solves \|raised\|mono_pcg" $out/$2.$1.$3.$4.err | cut -c1-300
  cd $top
}
for s in 9200002001 9200002002 9200002003 9200002004 9200002005 9200002006; do
  one c mono3499_refine.covis $s 0
done
for s in 9200002011 9200002012 9200002013; do
  one c mono3499_refine.covis $s 1 4000
done
timeout 400 python3 _archive/mono20/chain_diag.py nc3500_stereo chain 9200001021 9200001022 > $out/chain_diag.log 2>&1; echo "chain diag rc $?"; grep -v Warn $out/chain_diag.log | cut -c1-900
