"""Build and load the port's CUDA kernels.

Route: nvcc compiles ``tpcg_torch/csrc/*.cu`` into one shared library with a
plain C interface, which ctypes loads; no PyTorch header is compiled.  The
build happens at first use, into ``tpcg_torch/_build/`` (listed in
``.gitignore``), under a file name that carries a hash of the sources and
the flags, so a changed source is rebuilt and an unchanged one is loaded.
The compiler's report (registers, shared memory, spills from
``-Xptxas -v``) is kept beside the library in a ``.log`` file.

Flags: ``-O3`` for ``sm_90a`` and no ``--use_fast_math``, which would turn
on flush-to-zero and approximate division and sqrt, and so move the CG
freeze guard and the Smith division.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points of csrc/*.cu: name -> argument types (all return an int
# cudaError_t, except tpcg_error_string)
_SIGNATURES = {
    "tpcg_fused_cg_limits": (ctypes.POINTER(_I), ctypes.POINTER(_I)),
    "tpcg_fused_cg_grid": (_I, ctypes.POINTER(_I)),
    "tpcg_fused_cg_stencil": (_P,) * 10 + (_I,) * 4
    + (ctypes.POINTER(_I), _I, _I, _I, _P),
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to a CUDA toolkit")
    return found


def _tag(sources) -> str:
    h = hashlib.sha256()
    for flag in NVCC_FLAGS:
        h.update(flag.encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the library unless a build of the same sources and flags
    exists; return its path."""
    sources = sorted(CSRC.glob("*.cu"))
    lib = BUILD_DIR / f"libtpcg_kernels_{_tag(sources)}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    lib.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, then load the library and declare its entry points."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = _I
    lib.tpcg_error_string.argtypes = [_I]
    lib.tpcg_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = load().tpcg_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
