"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded through ``ctypes`` (no PyTorch headers, so a
build takes seconds). Libraries are built at first use into ``_build/`` next
to the package, named by a hash of the source, the local headers it
includes (``#include "x.cuh"``) and the flags, so an edited source or header
rebuilds and an unchanged one is reused. Nothing is built at import.
``attention_sm90``, ``attention512_sm90`` and ``conv3x3`` (wgmma + TMA,
their helpers in ``csrc/sm90.cuh``) reach libcuda's
``cuTensorMapEncodeTiled`` through ``cudaGetDriverEntryPoint``, so no
library links ``-lcuda``.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
)
KERNELS = ("attention_sm90", "attention512_sm90", "bilinear_sample", "bilinear_sample_bwd",
           "layer_norm", "group_norm", "conv3x3")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the entry points (argtypes, restype int = cudaError_t)
_SIGNATURES = {
    "attention_sm90": (
        "cd360_attention_sm90",
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float,
         ctypes.POINTER(ctypes.c_longlong), _P],
    ),
    "attention512_sm90": (
        "cd360_attention512",
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I,
         ctypes.POINTER(ctypes.c_longlong), _P],
    ),
    "bilinear_sample": (
        "cd360_bilinear_sample",
        [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    ),
    "bilinear_sample_bwd": (
        "cd360_bilinear_sample_bwd",
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    ),
    "layer_norm": (
        "cd360_layer_norm",
        [_P, _P, _P, _P, ctypes.c_longlong, _I, _F, _I, _I, _P],
    ),
    "group_norm": (
        "cd360_group_norm",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P],
    ),
    "conv3x3": (
        "cd360_conv3x3",
        [_P, _P, _P, _P, ctypes.POINTER(ctypes.c_longlong), _P],
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


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(path: Path, seen=None) -> list:
    """``path`` and the local headers it includes, recursively, in order."""
    seen = [] if seen is None else seen
    if path in seen:
        return seen
    seen.append(path)
    for inc in _LOCAL_INCLUDE.findall(path.read_bytes()):
        header = path.parent / inc.decode()
        if header.exists():
            _sources(header, seen)
    return seen


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(CSRC / f"{name}.cu"):
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


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
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def build_log(name: str) -> str:
    """nvcc's and ptxas's output (``-Xptxas -v``) of the build of
    ``csrc/<name>.cu``, from this process or kept beside the library."""
    if name in BUILD_LOGS:
        return BUILD_LOGS[name]
    path = library_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


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


def on_device(index: int):
    """A context that makes CUDA device ``index`` current; nothing to enter
    when it already is (the common case, kept off the launch path)."""
    if index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(index)


@functools.lru_cache(maxsize=None)
def num_sms(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``: the kernels size
    their splits to fill one wave of them."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def current_stream(index: int) -> int:
    """The raw handle of the current stream on CUDA device ``index``, for a
    launch (no Stream object: the host's time per launch is the step's
    time on the sampling paths)."""
    return torch._C._cuda_getCurrentRawStream(index)


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error {rc}")
