#!/bin/bash
# The proof run: chip_smoke.py from an archive of the staged tree, the
# cuda tests of the entry points and of K3, then the script alone in an
# empty directory (it must fail there). Unpack the archive into
# _archive/proof first; the logs go to chiprun_out/archive_proof.
cd "$(dirname "$0")/proof" || exit 9
out=../../chiprun_out/archive_proof
mkdir -p $out
python3 chip_smoke.py > $out/smoke.log 2>&1; rc=$?
echo "smoke rc=$rc"
grep -E "^k3 time|^k3: phase|^call forms .*(torch.equal|ATE)|^main (stereo|mono): (ATE|timed)|^entry cli mono: two|chip_smoke: all phases|: phase [0-9.]+ s|^build" $out/smoke.log | cut -c1-400
tail -3 $out/smoke.log | cut -c1-3500
python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_entry_points.py tests/test_torch_segment.py -m cuda 2>&1 | tail -1
alone=$(mktemp -d); cp chip_smoke.py "$alone"/; (cd "$alone" && python3 chip_smoke.py > out.log 2>&1; echo "alone rc=$?"; tail -2 out.log); rm -rf "$alone"
exit $rc
