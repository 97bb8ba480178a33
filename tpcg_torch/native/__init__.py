"""Host-side native helpers of the port (counterpart of ``tpcg/native``).

The C++ sources are the repository's own, under ``tpcg/native/``, reached
by file path (importing ``tpcg.native`` would import JAX); :func:`gxx_build`
compiles one into ``tpcg_torch/_build/`` at first use.
"""
from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
BUILD_DIR = ROOT / "tpcg_torch" / "_build"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


def gxx_build(src: pathlib.Path, stem: str) -> pathlib.Path:
    """g++'s shared library of ``src`` in ``BUILD_DIR``, named ``stem`` and
    a hash of the source and the flags; built unless it exists.  Raises
    ``OSError`` or ``CalledProcessError`` when it cannot build."""
    h = hashlib.sha256(" ".join(_FLAGS).encode() + src.read_bytes())
    lib = BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        subprocess.run(["g++", *_FLAGS, str(src), "-o", str(tmp)],
                       check=True, capture_output=True)
        os.replace(tmp, lib)
    return lib
