"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded through ``ctypes`` (no PyTorch headers, so a
build takes seconds). Libraries are built at first use into ``_build/`` next
to the package, named by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one is reused. Nothing is built at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
)
KERNELS = ("attention", "bilinear_sample")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the entry points (argtypes, restype int = cudaError_t)
_SIGNATURES = {
    "attention": (
        "cd360_attention_fwd",
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float,
         ctypes.POINTER(ctypes.c_longlong), _P],
    ),
    "bilinear_sample": (
        "cd360_bilinear_sample",
        [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    ),
}

_LIBS: dict = {}
BUILD_LOGS: dict = {}  # name -> nvcc/ptxas output of the build in this process


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names=KERNELS) -> dict:
    """Compile every missing library in ``names``, one nvcc process per
    source, all started together. Returns {name: seconds or 0.0 if cached}."""
    import time

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.time()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    times = {n: 0.0 for n in names}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        times[name] = time.time() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def load(name: str):
    """The loaded library for ``csrc/<name>.cu``, built first if needed;
    returns its entry-point function with argtypes set."""
    fn = _LIBS.get(name)
    if fn is None:
        path = library_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        sym, argtypes = _SIGNATURES[name]
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LIBS[name] = fn
    return fn


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error {rc}")
