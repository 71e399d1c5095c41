"""Build the port's CUDA sources into shared libraries, at first use.

Every ``kernels/*/csrc/*.cu`` becomes ``build/<stem>-<digest>.so`` next to
this file (the directory is git-ignored), compiled by ``nvcc`` for
``sm_90a`` with a plain C interface and loaded with ``ctypes``.  All
sources that are not built yet compile in parallel, one ``nvcc`` each.
The digest covers the source and the flags, so an edited source rebuilds
and an unchanged one is reused.

Processes that reach first use together (the rank processes of a
sharded run) build once: ``load`` holds a ``threading.Lock`` against the
other threads of its process and ``build_lock``, an exclusive
``fcntl.flock`` on a file in the build directory, against other processes;
the second process to take it finds the libraries built.  The kernel holds
the lock only while its process lives, so a build cut off leaves no lock
behind.

Nothing here runs at import time: a machine without ``nvcc`` (the CPU test
environment) imports every kernel module and only fails if it asks for a
CUDA launch.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def sources() -> dict[str, Path]:
    """Kernel name (source stem) -> ``.cu`` path, for every port kernel."""
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("*/csrc/*.cu"))}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the port's CUDA kernels are built on the GPU machine")
    return found


def _lib_path(src: Path) -> Path:
    h = hashlib.sha1(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:12]}.so"


def build_all() -> dict[str, dict]:
    """Compile every source whose library is missing, all at once.

    Returns ``{name: {"path", "seconds", "log", "built"}}``; ``log`` is
    nvcc's output (register and spill counts from ``-Xptxas=-v``) and
    ``built`` is False for a library reused from an earlier build.
    Raises ``RuntimeError`` with nvcc's output if any compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: dict[str, dict] = {}
    procs = {}
    for name, src in sources().items():
        lib = _lib_path(src)
        if lib.is_file():
            out[name] = {"path": lib, "seconds": 0.0, "log": "", "built": False}
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib, time.perf_counter())
    failed = []
    for name, (proc, tmp, lib, t0) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, lib)
        out[name] = {"path": lib, "seconds": secs, "log": log, "built": True}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


@contextlib.contextmanager
def build_lock(path: Path | None = None):
    """Hold an exclusive ``flock`` on ``path`` (``BUILD_DIR / "build.lock"``
    by default) for the ``with`` block: one process at a time builds."""
    path = BUILD_DIR / "build.lock" if path is None else Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building sources on first use
    (under ``build_lock``, so that processes starting together build once)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            with build_lock():
                built = build_all()
            if name not in built:
                raise KeyError(f"no CUDA source for kernel {name!r}")
            lib = ctypes.CDLL(str(built[name]["path"]))
            _libs[name] = lib
        return lib
