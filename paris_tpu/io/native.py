"""ctypes bindings for the native I/O library (native/paris_io.cpp).

The library is built from the committed source on the first
``available()`` call (not at import), with ``c++`` or ``$CXX``, into
``native/build/libparis_io-<source hash>.so``: a gitignored path keyed
by the source, so an edited source is rebuilt, and concurrent first
users never load a half-written file.
``PARIS_IO_LIB`` names a prebuilt library instead.  The bindings expose
fast HIS decode and threaded ddbvf block I/O.  Every entry point answers
``available()`` so callers (io/his.py, io/ddbvf.py) can fall back to the
pure-Python implementations — behavior is identical either way; the
native path just decodes/writes without the GIL and in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger("paris_tpu.native")

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "..", "..", "native")
_SOURCE = os.path.normpath(os.path.join(_NATIVE_DIR, "paris_io.cpp"))

OK = 0
_ERRORS = {
    -1: "cannot open file",
    -2: "bad file format",
    -3: "truncated file",
    -4: "out of bounds",
    -5: "I/O error",
}


class _HisInfo(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("frames", ctypes.c_int32),
        ("number_type", ctypes.c_int32),
        ("image_header_size", ctypes.c_int32),
    ]


def built_library_path(source: str = _SOURCE) -> str:
    """Where the library built from ``source`` lives (keyed by hash)."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(os.path.dirname(source), "build",
                        f"libparis_io-{digest}.so")


def build_library(source: str = _SOURCE) -> str:
    """Compile ``source`` (once per source hash); returns the .so path.
    Raises ``OSError``/``subprocess.CalledProcessError`` on failure."""
    out = built_library_path(source)
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
    os.close(fd)
    try:
        subprocess.run(
            [os.environ.get("CXX", "c++"), "-O3", "-std=c++17", "-fPIC",
             "-shared", "-pthread", "-fno-math-errno", "-o", tmp, source],
            check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)          # atomic vs concurrent builders
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    logger.info("built native I/O library %s", out)
    return out


def _load() -> Optional[ctypes.CDLL]:
    path = os.environ.get("PARIS_IO_LIB")
    if not path:
        if not os.path.exists(_SOURCE):
            return None
        try:
            path = build_library()
        except (OSError, subprocess.SubprocessError) as e:
            logger.warning("native I/O library unavailable (%s); using the "
                           "Python I/O path", e)
            return None
    try:
        lib = ctypes.CDLL(os.path.abspath(path))
    except OSError:
        return None
    lib.paris_his_info.argtypes = [ctypes.c_char_p,
                                   ctypes.POINTER(_HisInfo)]
    lib.paris_his_read.argtypes = [ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_float),
                                   ctypes.c_int64]
    lib.paris_ddbvf_create.argtypes = [ctypes.c_char_p, ctypes.c_uint32,
                                       ctypes.c_uint32, ctypes.c_uint32]
    lib.paris_ddbvf_open.argtypes = [ctypes.c_char_p,
                                     ctypes.POINTER(ctypes.c_uint32)]
    lib.paris_ddbvf_write.argtypes = [ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_float),
                                      ctypes.c_uint32, ctypes.c_uint32]
    lib.paris_ddbvf_read.argtypes = [ctypes.c_char_p,
                                     ctypes.POINTER(ctypes.c_float),
                                     ctypes.c_uint32, ctypes.c_uint32]
    fns = ["paris_his_info", "paris_his_read", "paris_ddbvf_create",
           "paris_ddbvf_open", "paris_ddbvf_write", "paris_ddbvf_read"]
    for fn in fns:
        getattr(lib, fn).restype = ctypes.c_int
    return lib


_lib: Optional[ctypes.CDLL] = None
_lib_loaded = False
_lib_lock = threading.Lock()


def _library() -> Optional[ctypes.CDLL]:
    """The library, built and loaded on first call (not at import)."""
    global _lib, _lib_loaded
    with _lib_lock:
        if not _lib_loaded:
            _lib = _load()
            _lib_loaded = True
    return _lib


def available() -> bool:
    return os.environ.get("PARIS_IO_NO_NATIVE") != "1" and \
        _library() is not None


class NativeIoError(OSError):
    def __init__(self, rc: int, path: str):
        super().__init__(f"{path}: {_ERRORS.get(rc, f'error {rc}')}")
        self.rc = rc


def his_read(path: str) -> np.ndarray:
    """Native HIS decode -> (frames, height, width) f32."""
    info = _HisInfo()
    rc = _library().paris_his_info(path.encode(), ctypes.byref(info))
    if rc != OK:
        raise NativeIoError(rc, path)
    out = np.empty((info.frames, info.height, info.width), dtype=np.float32)
    rc = _library().paris_his_read(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.size)
    if rc != OK:
        raise NativeIoError(rc, path)
    return out


def ddbvf_create(path: str, dim_x: int, dim_y: int, dim_z: int) -> None:
    rc = _library().paris_ddbvf_create(path.encode(), dim_x, dim_y, dim_z)
    if rc != OK:
        raise NativeIoError(rc, path)


def ddbvf_open(path: str) -> Tuple[int, int, int]:
    dims = (ctypes.c_uint32 * 3)()
    rc = _library().paris_ddbvf_open(path.encode(), dims)
    if rc != OK:
        raise NativeIoError(rc, path)
    return tuple(int(d) for d in dims)


def ddbvf_write(path: str, volume: np.ndarray, first: int) -> None:
    vol = np.ascontiguousarray(volume, dtype=np.float32)
    rc = _library().paris_ddbvf_write(
        path.encode(), vol.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        vol.shape[0], first)
    if rc != OK:
        raise NativeIoError(rc, path)


def ddbvf_read(path: str, first: int, count: int) -> np.ndarray:
    dims = ddbvf_open(path)
    out = np.empty((count, dims[1], dims[0]), dtype=np.float32)
    rc = _library().paris_ddbvf_read(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        first, count)
    if rc != OK:
        raise NativeIoError(rc, path)
    return out
