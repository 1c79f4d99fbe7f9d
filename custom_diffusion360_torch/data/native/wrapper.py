"""ctypes wrapper over preprocess.cpp (a copy of the JAX package's host
preprocessing library).

The library is built once with ``g++`` at first use into the package's
git-ignored ``_build/`` directory, named by a hash of the source and the
flags. Where the build fails (no compiler), the functions take their numpy
or PIL path, which tests/test_native.py holds equal to the library's.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "preprocess.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "_build"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")
_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)


def library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD_DIR / f"libpreprocess-{h.hexdigest()[:16]}.so"


def _build_and_load():
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        lib_path = library_path()
        try:
            if not lib_path.exists():
                _BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)], check=True,
                               capture_output=True)
                os.replace(tmp, lib_path)
            lib = ctypes.CDLL(str(lib_path))
            i = ctypes.c_int
            lib.resize_bicubic_u8_to_pm1.argtypes = [_U8P, i, i, i, _F32P, i, i]
            lib.dilate7_f32.argtypes = [_F32P, i, i, _F32P]
            lib.crop_u8.argtypes = [_U8P, i, i, i, i, i, i, i, _U8P]
            _LIB = lib
        except (OSError, subprocess.CalledProcessError):
            _LIB = None
        return _LIB


def native_available() -> bool:
    return _build_and_load() is not None


def resize_bicubic_to_pm1(img_u8: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(H, W, C) u8 -> (out_h, out_w, C) f32 in [-1, 1], antialiased bicubic."""
    lib = _build_and_load()
    img_u8 = np.ascontiguousarray(img_u8, np.uint8)
    h, w, c = img_u8.shape
    if lib is not None:
        out = np.empty((out_h, out_w, c), np.float32)
        lib.resize_bicubic_u8_to_pm1(img_u8.ctypes.data_as(_U8P), h, w, c,
                                     out.ctypes.data_as(_F32P), out_h, out_w)
        return out
    from PIL import Image

    im = Image.fromarray(img_u8).resize((out_w, out_h), Image.BICUBIC)
    return np.asarray(im, np.float32) / 255.0 * 2.0 - 1.0


def dilate7(mask: np.ndarray) -> np.ndarray:
    """(H, W) f32 -> 7x7 binary dilation, same padding, clipped to [0, 1]."""
    lib = _build_and_load()
    mask = np.ascontiguousarray(mask, np.float32)
    h, w = mask.shape
    if lib is not None:
        out = np.empty_like(mask)
        lib.dilate7_f32(mask.ctypes.data_as(_F32P), h, w, out.ctypes.data_as(_F32P))
        return out
    p = np.zeros((h + 6, w + 6), np.float32)
    p[3: 3 + h, 3: 3 + w] = mask
    out = np.zeros_like(mask)
    for dy in range(7):
        for dx in range(7):
            out = np.maximum(out, p[dy: dy + h, dx: dx + w])
    return np.clip(out, 0, 1)


def crop_u8(img: np.ndarray, x0: int, y0: int, out_h: int, out_w: int) -> np.ndarray:
    """(H, W, C) u8 crop with zero padding outside bounds."""
    lib = _build_and_load()
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    if lib is not None:
        out = np.empty((out_h, out_w, c), np.uint8)
        lib.crop_u8(img.ctypes.data_as(_U8P), h, w, c, int(x0), int(y0), out_h, out_w,
                    out.ctypes.data_as(_U8P))
        return out
    out = np.zeros((out_h, out_w, c), np.uint8)
    sy0, sx0 = max(0, y0), max(0, x0)
    sy1, sx1 = min(h, y0 + out_h), min(w, x0 + out_w)
    if sy0 < sy1 and sx0 < sx1:
        out[sy0 - y0: sy1 - y0, sx0 - x0: sx1 - x0] = img[sy0:sy1, sx0:sx1]
    return out
