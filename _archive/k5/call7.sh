#!/bin/sh
# chip_smoke.py from the committed tree (unpacked from `git archive` into
# _archive/final), the log into chiprun_out/k5/final/
root=$(pwd)
mkdir -p $root/chiprun_out/k5/final
cd _archive/final || exit 1
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 chip_smoke.py > $root/chiprun_out/k5/final/smoke.log 2>&1
rc=$?
grep -nE "K5|k5 |Traceback|AssertionError|all phases" $root/chiprun_out/k5/final/smoke.log | cut -c1-400 | head -40
tail -n 1 $root/chiprun_out/k5/final/smoke.log
exit $rc
