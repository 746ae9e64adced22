"""Build and load the hand-written CUDA kernels of ``csrc/``.

The sources are compiled at first use with ``nvcc``, one process per source
started together, and linked into one shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds). ``-Xptxas=-v`` reports each kernel's registers, shared memory and
spills; :data:`build_log` keeps that output per source. The library lands in the package's ``build/``
directory under a name that carries a hash of the sources and flags, so an
edited source is rebuilt and a stale library is never loaded. Importing this
module needs neither ``nvcc`` nor a GPU.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises when that is not 0, since a
refused launch never runs and a later synchronize would not report it.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD = PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build
build_log: Dict[str, str] = {}  # source name -> nvcc's report (this build)

P = ctypes.c_void_p
I = ctypes.c_int
I64 = ctypes.c_int64

# C signatures: name -> argtypes. Entries return an int (a cudaError_t)
# unless RESTYPES says otherwise.
SIGNATURES = {
    "amira_log_mel": [P, I64, I, I, P, P, I, P, P],
    "amira_greedy_loop_scratch_bytes": [I] * 5,
    "amira_greedy_loop": [I] * 16 + [P] * 32,
    "amira_beam_loop_scratch_bytes": [I] * 12,
    "amira_beam_loop": [I] * 16 + [P] * 31,
    "amira_quant_matmul": [I] * 5 + [P] * 6,
    "amira_joint_argmax_scratch_bytes": [I] * 4,
    "amira_joint_argmax": [I] * 9 + [P] * 10,
}
RESTYPES = {"amira_beam_loop_scratch_bytes": ctypes.c_longlong,
            "amira_greedy_loop_scratch_bytes": ctypes.c_longlong,
            "amira_joint_argmax_scratch_bytes": ctypes.c_longlong}


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # sources and their headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD / f"libamira_kernels-{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    global build_seconds
    BUILD.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = str(Path(tmp) / f"{src.stem}.o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
            objs.append(obj)
            procs.append((src.name, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for name, cmd, proc in procs:
            build_log[name] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{build_log[name]}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        so = str(Path(tmp) / "lib.so")
        cmd = [nvcc, "-shared", "-o", so, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(so, out)  # atomic: another process never loads half a file
    build_seconds = time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call if needed."""
    global _lib
    with _lock:
        if _lib is None:
            path = _lib_path()
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = RESTYPES.get(name, ctypes.c_int)
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


class LaunchCount:
    """The launch count of one branch of a kernel (a wrapper's own count is
    an attribute of the function)."""

    def __init__(self) -> None:
        self.launches = 0


count_lock = threading.Lock()  # guards every ``launches`` count
_recording = threading.local()


def count_launch(counter) -> None:
    """One launch by a wrapper: ``counter`` is the wrapper (or the
    :class:`LaunchCount` of its branch). While this thread captures a CUDA
    graph (:func:`recording_launches`) the launch is only recorded, and it
    goes to the capture's record instead of the count."""
    record = getattr(_recording, "launches", None)
    if record is not None:
        record[counter] = record.get(counter, 0) + 1
        return
    with count_lock:
        counter.launches += 1


@contextlib.contextmanager
def recording_launches():
    """Within it, this thread's launches go to the yielded record,
    ``{counter: launches}``, and no count moves."""
    record: Dict[object, int] = {}
    _recording.launches = record
    try:
        yield record
    finally:
        _recording.launches = None
