"""Native (C) runtime components, built on demand, with a Python fallback.

Counterpart of `linearsfm_tpu/native/__init__.py`. Currently `fastparse`,
the local-map text reader's hot path (`fastparse.c`). At first use gcc
compiles it into the package's `_build/` directory (beside the CUDA kernel
library, not in the package itself), under a name tagged with a hash of the
source, the flags, the interpreter and numpy, so an edited source (or
another environment) builds its own. When the build or the
import fails, a WARNING says so and `io/localmap` parses in Python.
"""

from __future__ import annotations

import functools
import hashlib
import importlib.machinery
import importlib.util
import logging
import os
import subprocess
import sys
import sysconfig
import tempfile

log = logging.getLogger("linearsfm_tpu_torch")

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "fastparse.c")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CFLAGS = ("-O2", "-shared", "-fPIC")


def _build() -> str:
    """Compile fastparse.c (once per content of the source and the flags)
    and return the path of the extension; raises on failure."""
    import numpy as np
    with open(SOURCE, "rb") as fh:
        # the interpreter and numpy it is built against are part of the tag
        tag = hashlib.sha256(fh.read() + " ".join(
            (*CFLAGS, sys.version, np.__version__)).encode()).hexdigest()[:12]
    suffix = importlib.machinery.EXTENSION_SUFFIXES[0]
    out = os.path.join(BUILD_DIR, f"fastparse_{tag}{suffix}")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=suffix, dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = ["gcc", *CFLAGS, SOURCE, f"-I{sysconfig.get_paths()['include']}",
               f"-I{np.get_include()}", "-o", tmp]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if r.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed:\n{r.stderr[-800:]}")
        os.replace(tmp, out)   # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.cache
def get_fastparse():
    """The compiled `fastparse` module, or None (with a WARNING) when it
    cannot be built or loaded."""
    try:
        path = _build()
        # the init function is found by the last part of the name
        spec = importlib.util.spec_from_file_location(
            "linearsfm_tpu_torch.native.fastparse", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    except (OSError, RuntimeError, ImportError,
            subprocess.SubprocessError) as e:
        log.warning("native local-map parser unavailable, parsing in Python "
                    "(several times slower): %s", e)
        return None
