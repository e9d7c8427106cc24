#!/bin/sh
# The committed tree (unpacked from `git archive` into _archive/final)
# against the parent: K5's cuda tests there, then the three cells in
# turns on new seeds, and one traced run of the change in each cell.
root=$(pwd)
cd _archive/final || exit 1
export PARENT=$root/_archive/parent OUT=$root/chiprun_out/k5/final
mkdir -p $OUT
timeout 600 python3 -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels.py -m cuda -k gauge_congruence 2>&1 | tail -2
sh _archive/k5/ab.sh rs468_mono.covis "c:4242424242:0 p:4242424242:0 p:3737373737:0 c:3737373737:0 c:2323232323:1"
sh _archive/k5/ab.sh nc3500_stereo.covis "p:2929292929:0 c:2929292929:0 c:2525252525:1"
sh _archive/k5/ab.sh mono3499_refine.covis "c:3131313131:0 p:3131313131:0 c:2121212121:1"
