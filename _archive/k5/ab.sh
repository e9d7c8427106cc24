#!/bin/sh
# Parent (_archive/parent, `git archive` of the parent commit) against this
# tree on one benchmark cell, in turns on shared seeds, each run's last
# line appended to chiprun_out/k5/ab_CELL.jsonl, its stderr kept beside.
# usage: sh _archive/k5/ab.sh CELL "SIDE:SEED:TRACE ..."   (SIDE p or c)
# from the change's root; PARENT (default _archive/parent) and OUT
# (default chiprun_out/k5) may name other directories.
cell=$1
top=$(pwd)
parent=${PARENT:-$top/_archive/parent}
odir=${OUT:-$top/chiprun_out/k5}
out=$odir/ab_$cell.jsonl
mkdir -p $odir
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for spec in $2; do
  side=${spec%%:*}; rest=${spec#*:}; seed=${rest%%:*}; trace=${rest#*:}
  if [ "$side" = p ]; then dir=$parent; else dir=$top; fi
  err=$odir/err_${cell}_${side}_${seed}_${trace}.log
  line=$(cd $dir && python3 benchmark/run.py --workload $cell --seed $seed \
         --seconds 51 --trace $trace 2>$err | tail -n 1)
  echo "{\"side\": \"$side\", \"seed\": $seed, \"trace\": $trace, \"result\": $line}" >> $out
  echo "$side $seed $trace: $(echo "$line" | cut -c1-900)"
done
