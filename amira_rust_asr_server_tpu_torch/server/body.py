"""The batch route's native body decoder (``csrc/body.cc``).

``amira_body_decode`` finds a batch body's top-level ``audio_buffer``
string, checks and decodes its base64 and turns the i16LE PCM into f32
samples in one pass over the request bytes, and declines every body that
is not that plain case (``csrc/body.cc`` lists them), which then takes the
Python path of ``server/app.py`` unchanged. It is a plain C function loaded
with ``ctypes.CDLL``, which releases the interpreter lock around each call,
so the server runs it on a small thread pool (``AppState.body_pool``) while
the event loop serves other requests.

The source is built with ``g++ -O3`` at first use into the package's
``build/`` directory, under a name that carries a hash of the source and
flags (as ``ops/kernels/_build.py`` builds the CUDA library), and
:func:`library` loads it once per process. Importing this module builds
nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .. import constants as C

PKG = Path(__file__).resolve().parents[1]
SOURCE = PKG / "csrc" / "body.cc"
BUILD = PKG / "build"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD / f"libamira_body-{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        so = str(Path(tmp) / "lib.so")
        cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", so]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed "
                               f"({proc.returncode}):\n{proc.stderr}")
        os.replace(so, out)  # atomic: another process never loads half a file


def library() -> ctypes.CDLL:
    """The body decoder's shared library, built on first call if needed."""
    global _lib
    with _lock:
        if _lib is None:
            path = _lib_path()
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            fn = lib.amira_body_decode
            fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                           ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
                           ctypes.c_double, ctypes.c_void_p]
            fn.restype = ctypes.c_int64
            _lib = lib
        return _lib


def decode(lib: ctypes.CDLL, raw: bytes, max_secs: float
           ) -> Optional[Tuple[np.ndarray, int, int]]:
    """(samples, start, end) of a batch body whose audio the native routine
    takes: the f32 samples, exactly as the Python path would make them, and
    the byte span ``raw[start:end]`` of the ``audio_buffer`` string token;
    None when it declines the body. One native call, without the
    interpreter lock."""
    # room for every sample the limits allow, and no more than the body
    # could hold (4 base64 characters are 3 bytes)
    cap = min(len(raw) * 3 // 8, C.MAX_AUDIO_BYTES // 2)
    if max_secs * C.SAMPLE_RATE < cap:
        cap = int(max_secs * C.SAMPLE_RATE)
    out = np.empty(cap + 2, dtype=np.float32)
    span = np.zeros(2, dtype=np.int64)
    n = lib.amira_body_decode(raw, len(raw), out.ctypes.data, out.shape[0],
                              C.MAX_AUDIO_BYTES, float(max_secs),
                              C.SAMPLE_RATE * 2.0, span.ctypes.data)
    if n <= 0:
        return None
    return out[:n], int(span[0]), int(span[1])
