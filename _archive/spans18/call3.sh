#!/bin/sh
# This tree against the parent's in one process, solves alternating
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 _archive/spans18/ab.py --parent _archive/parent --cell rs468_mono.covis --pairs 40 --sets 8; echo "ab rs468 rc $?"
python3 _archive/spans18/ab.py --parent _archive/parent --cell nc3500_stereo.covis --pairs 10 --sets 3; echo "ab nc3500 rc $?"
