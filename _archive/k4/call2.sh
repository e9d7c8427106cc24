#!/bin/sh
# K4 variants at every level of one warm solve of each refine cell
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
timeout 800 python3 _archive/k4/ab.py 2>&1 | grep -v Warning | tail -40
