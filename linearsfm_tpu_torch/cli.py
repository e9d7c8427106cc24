"""Reference-compatible command line of the PyTorch port.

Counterpart of `linearsfm_tpu/cli.py`, with the flags of the reference
binary (lmj_parseArgs, LinearSFMImp.cpp:7989-8106):

    python -m linearsfm_tpu_torch.cli -path DATA -num N -type {Monocular,Stereo}
                                      [-st state.txt] [-p pose.txt] [-f feat.txt]

plus the JAX package's extensions: --method, --exec, --cpu, --quiet, --ckpt,
--resume, --trace, --check. The solve runs on the CUDA GPU; --cpu runs it on
the CPU instead. Without --cpu and without a CUDA device the command fails:
it never moves to the CPU by itself. Exit codes: 0 done, 1 bad arguments or
no CUDA device, 2 --check found problems.
"""

from __future__ import annotations

import sys


def _print_help():
    print("Linear SFM (TPU) General Options\n")
    print("-path          Set Data Path.")
    print("-st            Set Path to Save Final State Vector")
    print("-p             Set Path to Save Poses")
    print("-f             Set Path to Save Features")
    print("-num           Number of Initial Reconstruction")
    print("-type          Set Data Type: Monocular | Stereo")
    print("--method       Solver precision: direct | refine (f32+refinement)")
    print("--exec         Tree executor: device (resident, fastest) | host |")
    print("               dense (host-planned dense block tensors; no ckpt)")
    print("--cpu          Run on the CPU (default: the CUDA GPU)")
    print("--ckpt DIR     Save per-level checkpoints to DIR")
    print("--resume       Resume from the latest checkpoint in --ckpt DIR")
    print("--trace DIR    Write a torch.profiler trace to DIR")
    print("--check        Validate the solved map (finite values, block")
    print("               ranges, gauge ids); non-zero exit on problems")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = {"path": None, "st": None, "p": None, "f": None, "num": None,
            "type": None, "method": "direct", "cpu": False, "quiet": False,
            "ckpt": None, "resume": False, "trace": None, "exec": None,
            "check": False}
    i = 0
    while i < len(argv):
        name = argv[i].lstrip("-")
        if name == "help":
            _print_help()
            return 0
        if name in ("cpu", "quiet", "resume", "check"):
            opts[name] = True
            i += 1
            continue
        if name not in opts:
            print(f"LinearSFM Error: unknown flag -{name}")
            return 1
        i += 1
        if i >= len(argv):
            print(f"LinearSFM Error: flag -{name} needs a value")
            return 1
        opts[name] = argv[i]
        i += 1

    if not opts["path"]:
        print("LinerSFM Error: Please Input Right File Path:")
        return 1
    if not opts["num"]:
        print("LinerSFM Error: Please Set Local Map Number:")
        return 1
    if opts["type"] not in ("Monocular", "Stereo"):
        print("LinerSFM Error: Please Set Data Type:")
        return 1

    import torch
    if not opts["cpu"] and not torch.cuda.is_available():
        print("LinearSFM Error: no CUDA device; pass --cpu to solve on the "
              "CPU")
        return 1
    device = "cpu" if opts["cpu"] else "cuda"

    import logging
    logging.basicConfig(level=logging.WARNING if opts["quiet"] else logging.INFO,
                        format="%(message)s")

    from .core import pipeline
    datatype = "mono" if opts["type"] == "Monocular" else "stereo"
    # the device-resident executor by default (it checkpoints too)
    executor = opts["exec"] or "device"
    final, wall = pipeline.run(
        opts["path"], int(opts["num"]), datatype,
        st_path=opts["st"], pose_path=opts["p"], feat_path=opts["f"],
        method=opts["method"], progress=not opts["quiet"],
        ckpt_dir=opts["ckpt"], resume=opts["resume"], trace_dir=opts["trace"],
        executor=executor, device=device)
    print(f"Total Used Time:  {wall:f}  sec")
    if opts["check"]:
        from .utils import debug
        probs = debug.check_map(final)
        for p in probs:
            print(f"LinearSFM Check: {p}")
        if probs:
            return 2
        print("LinearSFM Check: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
