#!/bin/sh
# The ring's parts: ablated variants and the fold micro-benchmark.
set -e
python3 _archive/k3_ab.py --skip-4b --variants 4x16384,3x32768,4x16384a1,4x16384a2
