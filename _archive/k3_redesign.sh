#!/bin/sh
# The redesigned K3 on the card: ptxas, phase 4b, and the earlier kernel
# against ring variants at the main-path and real shapes (_archive/k3_ab.py).
set -e
python3 _archive/k3_ab.py --variants 6x32768,8x16384,4x32768,6x32768a1,6x32768a2
