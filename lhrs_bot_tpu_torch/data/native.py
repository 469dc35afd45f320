"""ctypes bindings of the native host image path (`native/lhrs_host.cc`).

Counterpart of `lhrs_bot_tpu/data/native.py`: the C++ library fuses JPEG
decode (libjpeg), the PIL-parity bicubic shortest-edge resize and the
center crop, threaded across a batch. Here it is built from that source at
first use, with `native/Makefile`'s flags (`g++ -O3 -fPIC -std=c++17
-Wall -Wextra -shared -ljpeg -lpthread`), into
`build/host/<hash of the source and flags>/liblhrs_host.so` beside the
package (nothing is written under `native/`); the compiler's output is
kept in `build.log` there. A failed build (or a library that does not
load, such as one built on a machine with libjpeg and copied to one
without) is tried once a process.

Without the library, JPEG bytes go through PIL where it can be imported;
where neither is there, decoding a JPEG raises RuntimeError naming the
build log (never a zero image). `resize_batch` falls back to the port's
own resize (`data.transforms.clip_preprocess_uint8`), which needs no PIL.
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import logging
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger("lhrs_torch")

SOURCE = Path(__file__).resolve().parents[2] / "native" / "lhrs_host.cc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "host"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra")
LD_FLAGS = ("-shared", "-ljpeg", "-lpthread")

_LOCK = threading.Lock()
_STATE = {"tried": False, "lib": None}


def library_path() -> Path:
    """Where the library of the current source goes: a directory named by
    the hash of the flags and the source."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    h.update(SOURCE.read_bytes() if SOURCE.exists() else b"")
    return BUILD_ROOT / h.hexdigest()[:16] / "liblhrs_host.so"


def build_log_path() -> Path:
    return library_path().parent / "build.log"


def build() -> Optional[Path]:
    """Compile the library if it is missing; its path, or None when the
    build failed (the reason is in `build_log_path()`)."""
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", tmp, *LD_FLAGS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        out, rc = proc.stdout + proc.stderr, proc.returncode
    except OSError as exc:
        out, rc = f"{exc}\n", -1
    build_log_path().write_text(" ".join(cmd) + "\n" + out
                                + f"exit code {rc}\n")
    if rc != 0:
        os.unlink(tmp)
        return None
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so


def load_library() -> Optional[ctypes.CDLL]:
    """The built and loaded library with typed entries, or None when it
    cannot be built (tried once a process)."""
    with _LOCK:
        if _STATE["tried"]:
            return _STATE["lib"]
        _STATE["tried"] = True
        so = build()
        if so is None:
            logger.info("native host library not built (see %s); JPEGs go "
                        "through PIL", build_log_path())
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as exc:  # built elsewhere: libjpeg missing here
            with open(build_log_path(), "a") as fh:
                fh.write(f"loading {so} failed: {exc}\n")
            logger.info("native host library does not load (%s); JPEGs go "
                        "through PIL", exc)
            return None
        u8 = ctypes.POINTER(ctypes.c_uint8)
        i64 = ctypes.POINTER(ctypes.c_int64)
        lib.lhrs_decode_resize_batch.restype = ctypes.c_int
        lib.lhrs_decode_resize_batch.argtypes = [
            u8, i64, ctypes.c_int, ctypes.c_int, u8, u8, ctypes.c_int]
        lib.lhrs_resize_batch.restype = None
        lib.lhrs_resize_batch.argtypes = [
            u8, i64, ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.c_int, u8, ctypes.c_int]
        _STATE["lib"] = lib
        return lib


def available() -> bool:
    return load_library() is not None


def jpeg_decoder() -> Optional[str]:
    """Which decoder reads JPEGs here: "native", "PIL", or None."""
    if available():
        return "native"
    try:
        import PIL.Image  # noqa: F401
    except ImportError:
        return None
    return "PIL"


def require_jpeg_decoder() -> str:
    """`jpeg_decoder()`, or RuntimeError (naming the build log) where there
    is none."""
    name = jpeg_decoder()
    if name is None:
        raise RuntimeError(
            "JPEG decode needs the native host library or PIL: the library "
            f"did not build (see {build_log_path()}) and PIL is not "
            "installed")
    return name


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def decode_resize_batch(jpeg_buffers: Sequence[bytes], size: int = 224,
                        num_threads: int = 0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """JPEG bytes -> ((n, size, size, 3) uint8, ok mask): a corrupt buffer
    gives ok False and a zero slot. Through the native library, else PIL;
    RuntimeError where neither is there."""
    n = len(jpeg_buffers)
    out = np.zeros((n, size, size, 3), np.uint8)
    ok = np.zeros((n,), np.uint8)
    lib = load_library()
    if lib is not None:
        if n:
            data = np.frombuffer(b"".join(jpeg_buffers), np.uint8).copy()
            offsets = np.zeros((n + 1,), np.int64)
            np.cumsum([len(b) for b in jpeg_buffers], out=offsets[1:])
            lib.lhrs_decode_resize_batch(
                _u8(data),
                offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                n, size, _u8(out), _u8(ok), num_threads)
        return out, ok.astype(bool)
    require_jpeg_decoder()
    from PIL import Image

    from .transforms import clip_preprocess_uint8

    for i, buf in enumerate(jpeg_buffers):
        try:
            with Image.open(io.BytesIO(buf)) as img:
                out[i] = clip_preprocess_uint8(np.asarray(img.convert("RGB")),
                                               size)
            ok[i] = 1
        except Exception:  # noqa: BLE001 - a corrupt sample, flagged
            pass
    return out, ok.astype(bool)


def resize_batch(images: List[np.ndarray], size: int = 224,
                 num_threads: int = 0) -> np.ndarray:
    """Decoded RGB uint8 images (any sizes) -> (n, size, size, 3)."""
    n = len(images)
    out = np.zeros((n, size, size, 3), np.uint8)
    lib = load_library()
    if lib is not None and n:
        flat = np.concatenate([img.reshape(-1) for img in images])
        offsets = np.zeros((n,), np.int64)
        np.cumsum([img.size for img in images[:-1]], out=offsets[1:])
        dims = np.asarray([[img.shape[0], img.shape[1]] for img in images],
                          np.int32).reshape(-1)
        lib.lhrs_resize_batch(
            _u8(np.ascontiguousarray(flat)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n, size, _u8(out), num_threads)
        return out
    from .transforms import clip_preprocess_uint8

    for i, img in enumerate(images):
        out[i] = clip_preprocess_uint8(img, size)
    return out
