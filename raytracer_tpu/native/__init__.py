"""ctypes loader for the native image-export runtime (libfastpng.so).

Builds on demand with the system toolchain if the shared object is missing;
falls back cleanly (``LIB is None``) so pure-Python PNG encoding
(raytracer_tpu.app.io) keeps everything working without a compiler.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libfastpng.so")
_STAMP = os.path.join(_DIR, ".buildstamp")


def _sources() -> list[str]:
    """Sorted source/Makefile names the build depends on ([] on OSError)."""
    try:
        return sorted(
            n for n in os.listdir(_DIR)
            if n.endswith((".cpp", ".h")) or n == "Makefile"
        )
    except OSError:
        return []


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-C", _DIR],
            check=True,
            capture_output=True,
            timeout=120,
        )
        if os.path.exists(_SO):
            # record the source SET the .so was built from: mtimes alone
            # can't see a deleted source file
            with open(_STAMP, "w") as f:
                f.write("\n".join(_sources()))
            return True
        return False
    except Exception:
        return False


def _is_current() -> bool:
    """True when the .so exists, is newer than every source/Makefile, AND
    was built from the same source set (a deleted source file changes the
    set without touching any surviving mtime) — the common case, where
    spawning `make` (fork + subprocess, up to the 120 s timeout on a
    broken toolchain) at import would be pure waste."""
    try:
        so_m = os.path.getmtime(_SO)
        with open(_STAMP) as f:
            stamped = f.read().split("\n")
        srcs = _sources()
        if not srcs or srcs != stamped:
            return False
        for name in srcs:
            if os.path.getmtime(os.path.join(_DIR, name)) >= so_m:
                return False
    except OSError:
        return False
    return True


def _load():
    # run make only when the .so is missing or older than the sources: a
    # stale .so from an older source set would load but miss newer
    # symbols, while an up-to-date one makes the subprocess pure startup
    # cost for every importing process
    if not _is_current() and not _build() and not os.path.exists(_SO):
        return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    lib.rt_tonemap_u8.restype = ctypes.c_int
    lib.rt_tonemap_u8.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.rt_write_png.restype = ctypes.c_int
    lib.rt_write_png.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_size_t),
    ]
    if not hasattr(lib, "rt_ansi_halfblocks"):
        return None  # stale library that a rebuild could not refresh
    lib.rt_ansi_halfblocks.restype = ctypes.c_long
    lib.rt_ansi_halfblocks.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_size_t,
    ]
    return lib


LIB = _load()


def encode_png_native(rgb_f32, flip_vertical: bool = True) -> bytes | None:
    """float32 (H, W, 3) framebuffer → PNG bytes via the C++ runtime,
    or None if the native library is unavailable."""
    if LIB is None:
        return None
    import numpy as np

    arr = np.ascontiguousarray(rgb_f32, dtype=np.float32)
    h, w, _ = arr.shape
    cap = ctypes.c_size_t(h * w * 3 + (h * w * 3) // 2 + 4096)
    out = (ctypes.c_uint8 * cap.value)()
    rc = LIB.rt_write_png(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        h,
        w,
        1 if flip_vertical else 0,
        out,
        ctypes.byref(cap),
    )
    if rc != 0:
        return None
    return bytes(bytearray(out)[: cap.value])


def ansi_halfblocks_native(rgb_f32, stride: int) -> str | None:
    """f32 (H, W, 3) GL-row-order framebuffer → ANSI half-block string via
    the C++ encoder, or None if the native library is unavailable. Matches
    :func:`raytracer_tpu.app.viewer.frame_to_ansi` byte-for-byte."""
    if LIB is None:
        return None
    import numpy as np

    arr = np.ascontiguousarray(rgb_f32, dtype=np.float32)
    h, w, _ = arr.shape
    sub_w = -(-w // stride)
    sub_h = -(-h // stride)
    cap = ctypes.c_size_t((sub_h // 2) * (sub_w * 41 + 5) + 64)
    out = (ctypes.c_uint8 * cap.value)()
    n = LIB.rt_ansi_halfblocks(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        h, w, stride, out, cap,
    )
    if n < 0:
        return None
    # copy only the n encoded bytes (this runs every displayed frame)
    return ctypes.string_at(out, n).decode("utf-8")
