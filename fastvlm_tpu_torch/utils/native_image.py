"""ctypes bindings for the native image loader (``native/image_loader.cpp``).

The port's copy of ``fastvlm_tpu/utils/native_image.py``, with the same C
interface: threaded JPEG decode + PIL-compatible bicubic preprocessing in
C++, the host-side data path of training (``data/sft.py``), off the GIL.
The library is built on first use with the flags of ``native/Makefile``

    g++ -O3 -march=native -funroll-loops -fPIC -shared -std=c++17 -Wall \
        -o fastvlm_tpu_torch/_build/libfvlm_image.so native/image_loader.cpp \
        -ljpeg -lpthread

into the port's git-ignored ``_build/`` (nothing is written under
``native/``); where the toolchain or libjpeg is missing, ``available()`` is
False and callers take the PIL path, as in JAX.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

MODE_RESIZE_CROP = 0
MODE_PAD_SQUARE = 1

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(os.path.dirname(_PKG), "native", "image_loader.cpp")
_LIB_PATH = os.path.join(_PKG, "_build", "libfvlm_image.so")
CXXFLAGS = ["-O3", "-march=native", "-funroll-loops", "-fPIC", "-shared",
            "-std=c++17", "-Wall"]
LIBS = ["-ljpeg", "-lpthread"]


def _build() -> None:
    """Compile the loader to a temporary name and rename it into place, so
    two processes building at once never load a half-written library."""
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run([os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", tmp,
                        _SOURCE, *LIBS], check=True, capture_output=True)
        os.replace(tmp, _LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)

_lib: Optional[ctypes.CDLL] = None
_tried = False
load_error: Optional[str] = None  # why the library is unavailable, if so


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, load_error
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH):
        try:
            _build()
        except Exception as e:
            err = getattr(e, "stderr", None) or b""
            load_error = f"{e}: {err.decode(errors='replace')[-300:]}"
            logger.info("native image loader unavailable (%s); using PIL",
                        load_error)
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as e:
        load_error = str(e)
        logger.info("failed to load %s (%s); using PIL", _LIB_PATH, e)
        return None
    lib.fvlm_preprocess_jpeg.restype = ctypes.c_int
    lib.fvlm_preprocess_jpeg.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float)]
    lib.fvlm_preprocess_rgb.restype = ctypes.c_int
    lib.fvlm_preprocess_rgb.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float)]
    lib.fvlm_preprocess_files.restype = ctypes.c_int
    lib.fvlm_preprocess_files.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def preprocess_jpeg_bytes(data: bytes, size: int,
                          mode: int = MODE_PAD_SQUARE) -> np.ndarray:
    """JPEG bytes -> (size, size, 3) f32 in [0, 1]."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native image loader not available")
    out = np.empty((size, size, 3), np.float32)
    rc = lib.fvlm_preprocess_jpeg(
        data, len(data), size, mode,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc:
        raise ValueError("JPEG decode failed")
    return out


def preprocess_rgb(rgb: np.ndarray, size: int,
                   mode: int = MODE_PAD_SQUARE) -> np.ndarray:
    """(H, W, 3) u8 -> (size, size, 3) f32 in [0, 1]."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native image loader not available")
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    out = np.empty((size, size, 3), np.float32)
    lib.fvlm_preprocess_rgb(
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h, size, mode,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def preprocess_files(paths: Sequence[str], size: int,
                     mode: int = MODE_PAD_SQUARE,
                     num_threads: int = 8) -> tuple:
    """Threaded batch: JPEG paths -> ((N, size, size, 3) f32, ok (N,) bool)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native image loader not available")
    n = len(paths)
    out = np.empty((n, size, size, 3), np.float32)
    ok = np.empty((n,), np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.fvlm_preprocess_files(
        arr, n, size, mode,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), num_threads)
    return out, ok == 0
