"""Lazy nvcc build of the CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. The first
call to ``library`` builds every source at once (one ``nvcc`` per source,
started together) into ``csrc/build/``, keyed by a hash of the source,
every header in ``csrc/`` and the flags, so a changed source or header is
rebuilt and an unchanged one is reused.
Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"
# -fmad=false: no mul+add contraction anywhere, so float expressions round
# exactly as the reference's separately rounded ops. -Xptxas -v reports
# registers, shared memory and spills per kernel (kept in `build_log`).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}
build_log: dict = {}       # source name -> nvcc output of this process's build
build_seconds = 0.0        # wall time this process spent building


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "build on first use from gs2mesh_torch/csrc")
    return found


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def _build_all() -> None:
    global build_seconds
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        out = _target(src)
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((src, out, tmp, proc))
    failed = []
    for src, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        build_log[src.stem] = log
        if proc.returncode != 0:
            failed.append(f"{src.name} (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    build_seconds += time.perf_counter() - t0
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    for src in sorted(CSRC.glob("*.cu")):
        _libs[src.stem] = ctypes.CDLL(str(_target(src)))


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library built from ``csrc/<name>.cu``."""
    with _lock:
        if not _libs:
            _build_all()
        return _libs[name]


def kernel_info(fn, which: int = 0) -> dict:
    """Calls a library's ``int fn(int which, int out[3])`` and names what it
    fills in: a kernel's registers per thread, static shared memory bytes
    and the blocks the occupancy API fits on one SM."""
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 3)()
    err = fn(which, out)
    if err != 0:
        raise RuntimeError(f"kernel attribute query failed: CUDA error {err}")
    return {"registers": out[0], "shared_bytes": out[1],
            "blocks_per_sm": out[2]}
