#!/bin/sh
# the claimed cell (RS468) in turns, then the entry points' cuda test
sh _archive/k5/ab.sh rs468_mono.covis "p:3141592653:0 c:3141592653:0 c:2718281828:0 p:2718281828:0 p:1618033988:0 c:1618033988:0 c:1414213562:1 p:1414213562:1"
timeout 300 python3 -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_entry_points.py -m cuda 2>&1 | tail -15
