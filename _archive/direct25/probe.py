"""`_archive/mono20/probe.py` with the float64 Schur assembly's numbers
in each solve's row (`_last_timing`'s schur_f64_* keys; a tree without
them prints null): the same arguments.

    python3 _archive/direct25/probe.py --root TREE --maps-out DIR
        --cells CELL:SETS,... [--seed N] [--device cpu --maps N]
"""
import importlib.util
import os
import sys

spec = importlib.util.spec_from_file_location(
    "probe20", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "..", "mono20", "probe.py"))
probe = importlib.util.module_from_spec(spec)
spec.loader.exec_module(probe)
probe.KEYS = probe.KEYS + ("k4_launches", "k5_launches", "schur_f64_s",
                           "schur_f64_u_blocks", "schur_f64_w_blocks",
                           "schur_f64_pose_rows", "schur_f64_feat_rows",
                           "schur_f64_s_entries")
sys.exit(probe.main())
