#!/bin/sh
mkdir -p chiprun_out/k5
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 chip_smoke.py > chiprun_out/k5/smoke.log 2>&1
rc=$?
grep -nE "K5|k5 |Error|error|Traceback|assert" chiprun_out/k5/smoke.log | head -80
tail -c 6000 chiprun_out/k5/smoke.log
exit $rc
