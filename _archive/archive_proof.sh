#!/bin/bash
# The proof run: chip_smoke.py from an archive of the staged tree, then
# the script alone in an empty directory (it must fail there).
cd "$(dirname "$0")/proof" || exit 9
mkdir -p ../../chiprun_out/archive_proof
python3 chip_smoke.py > ../../chiprun_out/archive_proof/smoke.log 2>&1; rc=$?
echo "smoke rc=$rc"
grep -E "^call forms|^main (stereo|mono): (ATE|timed)|chip_smoke: all phases|: phase [0-9.]+ s" ../../chiprun_out/archive_proof/smoke.log | cut -c1-300
tail -3 ../../chiprun_out/archive_proof/smoke.log | cut -c1-3000
python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_entry_points.py -m cuda 2>&1 | tail -1
alone=$(mktemp -d); cp chip_smoke.py "$alone"/; (cd "$alone" && python3 chip_smoke.py > out.log 2>&1; echo "alone rc=$?"; tail -2 out.log); rm -rf "$alone"
exit $rc
