"""ctypes bindings to the native (C++) picture decoder.

Counterpart of doomtpu/ops/native.py.  Load-time hot spots (decoding
hundreds of picture lumps per WAD) go through csrc/doomdec.cpp, the
port's own copy of the JAX package's native/doomdec.cpp, once it is
built; until then `decode_picture` returns None and the caller
(assets/pictures.py) decodes in NumPy, with identical output.

Build it with `build()` (ops/build.py::build_host_library: the host C++
compiler, into build/doomtpu_torch/ under a hash of the source).  A
process looks for the library once, at its first decode, and again only
in `build()`.  The port never loads the JAX package's library.
"""

from __future__ import annotations

import ctypes

import numpy as np

_lib = None
_tried = False      # looked for the library once (built or not)


def build():
    """Build the decoder (if not built) and load it; raises without a C++
    compiler or on a failed build."""
    global _tried
    from doomtpu_torch.ops.build import build_host_library

    build_host_library("doomdec")
    _tried = False
    return _load()


def _load():
    global _tried, _lib
    if _tried:
        return _lib
    _tried = True
    from doomtpu_torch.ops.build import host_library_path

    path = host_library_path("doomdec")
    if not path.exists():
        return None
    lib = ctypes.CDLL(str(path))
    lib.doomdec_picture.restype = ctypes.c_int
    lib.doomdec_picture.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_char_p,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def decode_picture(raw: np.ndarray, w: int, h: int):
    """Native picture decode; returns (pixels, mask), or None if the
    library is not built or the lump is malformed."""
    lib = _load()
    if lib is None or w <= 0 or h <= 0:
        return None
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    pixels = np.zeros((h, w), dtype=np.uint8)
    mask = np.zeros((h, w), dtype=np.uint8)
    rc = lib.doomdec_picture(
        raw.ctypes.data_as(ctypes.c_char_p), raw.nbytes, w, h,
        pixels.ctypes.data_as(ctypes.c_char_p),
        mask.ctypes.data_as(ctypes.c_char_p),
    )
    if rc != 0:
        return None
    return pixels, mask.astype(bool)
