"""ctypes binding of the port's C++ JPEG ingest (the port's copy of
construction_clip_tpu/data/native_loader.py; the C++ is
construction_clip_tpu_torch/native/image_loader.cpp).

load_image_native(path, size) decodes a JPEG with libjpeg's DCT-domain
prescaling, box-downscales the short side to `size` and centre-crops: the fused
C version of pipeline.host_shape_unify(default_load_image(path), size). It
falls back to that PIL + numpy path for non-JPEGs, for a decode error, and
where the library is unavailable.

At first use `g++ -O3 -fPIC -shared ... -ljpeg` builds the library into
`build/torch_native/` at the root of the checkout, under a name that carries a
hash of the source and the flags; it compiles to a temporary name and renames
it into place, so that processes building at once never load a half-written
file. A failed build is remembered and the library calls take the PIL path
from then on, as the JAX package does; `native_available()` reports whether the
library loaded. Set CCTPU_NO_NATIVE=1 to force the Python path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "image_loader.cpp"
BUILD_DIR = SOURCE.parents[2] / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-Wall")
LIBS = ("-ljpeg",)

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libcct_image_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    """g++ into a name of this process's own, then an atomic rename."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
    finally:
        tmp.unlink(missing_ok=True)


def _load_library():
    global _lib, _build_failed
    if _lib is not None or _build_failed or os.environ.get("CCTPU_NO_NATIVE"):
        return _lib
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        so = library_path()
        if not so.exists():
            try:
                _build(so)
            except (OSError, subprocess.SubprocessError):
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(str(so))
            lib.cctpu_decode_resize_crop.restype = ctypes.c_int
            lib.cctpu_decode_resize_crop.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8)]
            lib.cctpu_jpeg_dims.restype = ctypes.c_int
            lib.cctpu_jpeg_dims.argtypes = [
                ctypes.c_char_p, ctypes.c_long,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
            _lib = lib
        except OSError:
            _build_failed = True
    return _lib


def native_available() -> bool:
    return _load_library() is not None


def load_image_native(path: str, size: int) -> np.ndarray:
    """-> [size, size, 3] uint8. JPEG fast path in C; PIL fallback otherwise."""
    lib = _load_library()
    if lib is not None and path.lower().endswith((".jpg", ".jpeg", ".jpe")):
        with open(path, "rb") as f:
            data = f.read()
        out = np.empty((size, size, 3), dtype=np.uint8)
        rc = lib.cctpu_decode_resize_crop(
            data, len(data), size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if rc == 0:
            return out
        # fall through to PIL on decode errors
    from construction_clip_tpu_torch.data.pipeline import default_load_image, host_shape_unify

    return host_shape_unify(default_load_image(path), size)


def make_native_loader(size: int):
    """load_image hook for the image-text loaders: images arrive already staged
    at `size`, so host_shape_unify becomes a no-op."""
    return lambda path: load_image_native(path, size)
