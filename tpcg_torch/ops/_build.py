"""Build and load the port's CUDA kernels.

Route: nvcc compiles each ``tpcg_torch/csrc/*.cu`` into an object file, all
sources at once in parallel processes, and links the objects into one
shared library with a plain C interface, which ctypes loads; no PyTorch
header is compiled.  The build happens at first use, into
``tpcg_torch/_build/`` (listed in ``.gitignore``), under file names that
carry a hash of the sources and the flags, so a changed source is rebuilt
and an unchanged one is loaded.  The compiler's report (registers, shared
memory, spills from ``-Xptxas -v``) is kept beside each object and the
library in ``.log`` files.

Flags: ``-O3`` for ``sm_90a`` and no ``--use_fast_math``, which would turn
on flush-to-zero and approximate division and sqrt, and so move the CG
freeze guards and the Smith division.
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_IP = ctypes.POINTER(_I)
# C entry points of csrc/*.cu: name -> argument types (all return an int
# cudaError_t, except tpcg_error_string)
_SIGNATURES = {
    "tpcg_fused_cg_limits": (_IP, _IP),
    "tpcg_fused_cg_grid": (_I, _IP),
    "tpcg_fused_cg_stencil": (_P,) * 10 + (_I,) * 4 + (_IP, _I, _I, _I, _P),
    "tpcg_stream_dia_limits": (_IP, _IP),
    "tpcg_stream_dia_grid": (_I, _I, _I, _I, _IP),
    "tpcg_stream_dia": (_I,) + (_P,) * 11 + (_I,) * 6 + (_P,),
    "tpcg_fused_dia_limits": (_IP, _IP),
    "tpcg_fused_dia": (_P,) * 6 + (_I,) * 5 + (_P,),
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


def _run_all(cmds):
    """Start every command at once; wait for all; raise on the first
    failure with its compiler output.  Each command's output goes to the
    ``.log`` file named beside it."""
    procs = [(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True), cmd, log)
             for cmd, log in cmds]
    failed = None
    for proc, cmd, log in procs:
        out, _ = proc.communicate()
        log.write_text(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed with exit code {proc.returncode}:\n{out}"
    if failed:
        raise RuntimeError(failed)


def build() -> pathlib.Path:
    """Compile the library unless a build of the same sources and flags
    exists; return its path."""
    sources = sorted(CSRC.glob("*.cu"))
    lib = BUILD_DIR / f"libtpcg_kernels_{_tag(sources)}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    objs, cmds, done = [], [], []
    for src in sources:
        obj = BUILD_DIR / f"{src.stem}_{_tag([src])}.o"
        objs.append(obj)
        if not obj.exists():
            tmp = obj.with_name(f"{obj.stem}.{os.getpid()}.tmp.o")
            cmds.append(([nvcc, *NVCC_FLAGS, "-c", "-o", str(tmp),
                          str(src)], obj.with_suffix(".log")))
            done.append((tmp, obj))
    _run_all(cmds)
    for tmp, obj in done:
        os.replace(tmp, obj)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    _run_all([([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                "-o", str(tmp), *map(str, objs)], lib.with_suffix(".log"))])
    os.replace(tmp, lib)
    return lib


def compiler_report() -> str:
    """The ``-Xptxas -v`` output of the current build's objects."""
    sources = sorted(CSRC.glob("*.cu"))
    logs = [BUILD_DIR / f"{s.stem}_{_tag([s])}.log" for s in sources]
    return "\n".join(p.read_text() for p in logs if p.exists())


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
