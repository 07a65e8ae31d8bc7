"""The dataset decoder of the command-line drivers: an ordered iterator of
grayscale frames decoded ahead of the tracker.

The ``native`` backend is the repository's prefetching loader,
``native/eao_loader.cpp`` (decoder threads fill a bounded ring of
grayscale float frames, libpng / libjpeg, BT.601 luma), compiled with
``g++`` at first use into ``build/eao_slam_torch/libeao_loader.so`` and
bound through ctypes. Where it cannot be built, the ``cv2`` backend
decodes on the calling thread. ``SequenceLoader.backend`` says which one
runs; with neither, constructing a loader raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "native", "eao_loader.cpp")
BUILD_DIR = os.path.join(_REPO, "build", "eao_slam_torch")
LIBRARY = os.path.join(BUILD_DIR, "libeao_loader.so")

_lib = None
_build_error: Optional[str] = None
_lock = threading.Lock()


def gxx_command(source: str = SOURCE, output: str = LIBRARY) -> list:
    return ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-o", output, source,
            "-lpng", "-ljpeg", "-lpthread"]


def build() -> str:
    """Compile native/eao_loader.cpp into build/eao_slam_torch/ (rebuilt
    when the source is newer than the library); raises on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    if os.path.exists(LIBRARY) and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE):
        return LIBRARY
    if shutil.which("g++") is None:
        raise RuntimeError("g++ is not on the PATH")
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    proc = subprocess.run(gxx_command(SOURCE, tmp), capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed building {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, LIBRARY)
    return LIBRARY


def _load():
    """The bound library, built on the first call; None (and the reason in
    ``_build_error``) when it cannot be built."""
    global _lib, _build_error
    with _lock:
        if _lib is None and _build_error is None:
            try:
                lib = ctypes.CDLL(build())
            except (RuntimeError, OSError, subprocess.SubprocessError) as exc:
                _build_error = str(exc)
                return None
            lib.eao_loader_open.restype = ctypes.c_void_p
            lib.eao_loader_open.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ]
            lib.eao_loader_next.restype = ctypes.c_int
            lib.eao_loader_next.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_double),
            ]
            lib.eao_loader_close.restype = None
            lib.eao_loader_close.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


class SequenceLoader:
    """Ordered iterator of (index, timestamp, grayscale float32 [H, W])
    frames, resized by nearest-pixel drop where a file's size differs;
    unreadable files are skipped. ``backend`` is ``"native"`` (decoder
    threads and a prefetch ring) or ``"cv2"`` (with ``force_fallback``, or
    where the native library cannot be built). A context manager: the
    native handle closes on exit."""

    def __init__(self, directory: str, filenames: Sequence[str], timestamps: Sequence[float],
                 width: int, height: int, n_threads: int = 2, ring: int = 8,
                 force_fallback: bool = False):
        self.dir = directory
        self.files = list(filenames)
        self.stamps = [float(t) for t in timestamps]
        self.w, self.h = width, height
        self._handle = None
        lib = None if force_fallback else _load()
        if lib is not None:
            self.backend = "native"
            names = (ctypes.c_char_p * len(self.files))(*[f.encode() for f in self.files])
            stamps = (ctypes.c_double * len(self.stamps))(*self.stamps)
            self._handle = lib.eao_loader_open(directory.encode(), names, stamps,
                                               len(self.files), width, height, n_threads, ring)
        elif _cv2() is not None:
            self.backend = "cv2"
        else:
            why = "not asked for" if force_fallback else f"not built: {_build_error}"
            raise RuntimeError(f"no image decoder: the native loader was {why}, "
                               "and cv2 is not installed")

    def __iter__(self) -> Iterator[Tuple[int, float, np.ndarray]]:
        if self.backend == "native":
            buf = np.empty((self.h, self.w), np.float32)
            stamp = ctypes.c_double()
            while True:
                rc = _lib.eao_loader_next(self._handle,
                                          buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                          ctypes.byref(stamp))
                if rc == -1:
                    return
                if rc == -2:            # unreadable frame: skipped
                    continue
                yield rc, stamp.value, buf.copy()
        else:
            cv2 = _cv2()
            for i, (f, t) in enumerate(zip(self.files, self.stamps)):
                img = cv2.imread(os.path.join(self.dir, f), cv2.IMREAD_GRAYSCALE)
                if img is None:
                    continue
                if img.shape != (self.h, self.w):
                    img = cv2.resize(img, (self.w, self.h), interpolation=cv2.INTER_NEAREST)
                yield i, t, img.astype(np.float32)

    def close(self) -> None:
        if self._handle is not None:
            _lib.eao_loader_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
