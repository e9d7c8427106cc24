#!/bin/sh
# the entry points' cuda test, the refine cells in turns (p c c p), then
# one traced run of each side
timeout 300 python3 -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_entry_points.py -m cuda -vv 2>&1 | grep -E "PASS|FAIL|Error|assert|Extra|^E " | head -30
sh _archive/k5/ab.sh nc3500_stereo.covis "p:2236067977:0 c:2236067977:0 c:1732050807:0 p:1732050807:0 c:2645751311:1 p:2645751311:1"
sh _archive/k5/ab.sh mono3499_refine.covis "c:3316624790:0 p:3316624790:0 p:2449489742:0 c:2449489742:0 p:2828427124:1 c:2828427124:1"
