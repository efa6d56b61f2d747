"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each `ydf_tpu_torch/csrc/<name>.cu` compiles on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>.so csrc/<name>.cu

into `ydf_tpu_torch/build/` (git-ignored). A library is rebuilt when its
source is newer. The sources have a plain C interface and do not include
PyTorch's headers, so a build takes seconds. A missing nvcc or a failed
build raises with nvcc's log; nothing falls back.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, Iterable, Optional

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
# Where the CUDA toolkit lives when neither CUDA_HOME nor PATH names it.
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_ENTRY_POINTS: Dict[tuple, Callable[..., int]] = {}
#: nvcc's output (ptxas registers / shared memory) of the last build of
#: each library in this process.
BUILD_LOGS: Dict[str, str] = {}


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then DEFAULT_NVCC."""
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append(DEFAULT_NVCC)
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        f"{DEFAULT_NVCC}); the CUDA kernels of ydf_tpu_torch need the CUDA "
        "toolkit. Pass device='cpu' to run the plain PyTorch versions."
    )


def source_path(name: str) -> str:
    return os.path.join(SRC_DIR, f"{name}.cu")


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    lib = library_path(name)
    return not os.path.isfile(lib) or (
        os.path.getmtime(lib) < os.path.getmtime(source_path(name))
    )


def build_all(names: Iterable[str], force: bool = False) -> float:
    """Compiles every stale (or, with force, every) library among
    `names`, one nvcc process per source, all started together. Returns
    the wall seconds; raises RuntimeError with nvcc's log on failure."""
    names = [n for n in names if force or _stale(n)]
    t0 = time.perf_counter()
    if not names:
        return 0.0
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        # Write beside the target and rename: a concurrent loader never
        # sees a half-written library.
        tmp = f"{library_path(name)}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, source_path(name)]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for name, (tmp, p) in procs.items():
        log, _ = p.communicate()
        BUILD_LOGS[name] = log
        if p.returncode != 0:
            failed.append(f"--- nvcc {source_path(name)} "
                          f"(exit {p.returncode}):\n{log}")
            if os.path.exists(tmp):
                os.remove(tmp)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of lib<name>.so, built first when stale."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(library_path(name))
            _LIBS[name] = lib
        return lib


def entry_point(name: str, symbol: str, num_pointers: int,
                num_ints: int) -> Callable[..., int]:
    """C function `symbol` of lib<name>.so taking `num_pointers`
    pointers, `num_ints` ints and a stream, returning an int status.
    Its argtypes are declared once per process: without them ctypes
    would pass a Python int as a 32-bit C int and cut the pointers."""
    key = (name, symbol)
    fn = _ENTRY_POINTS.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = ([ctypes.c_void_p] * num_pointers
                       + [ctypes.c_int] * num_ints + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _ENTRY_POINTS[key] = fn
    return fn


def on_device(dev):
    """The context a wrapper launches in: nothing when `dev` is already
    the current card (the common case; entering torch.cuda.device costs
    host time on every call), else torch.cuda.device(dev)."""
    import contextlib

    import torch

    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


#: When a list, the training kernels' wrappers append (name, start event,
#: end event) around each launch (CUDA events; they add no sync). None,
#: the default, records nothing. chip_smoke.py sums them per kernel.
LAUNCH_EVENTS: Optional[list] = None


def launch_timer(name: str):
    """Start of one timed launch, or None when LAUNCH_EVENTS is off."""
    if LAUNCH_EVENTS is None:
        return None
    import torch

    start = torch.cuda.Event(enable_timing=True)
    start.record()
    return name, start


def launch_done(timer) -> None:
    if timer is None or LAUNCH_EVENTS is None:
        return
    import torch

    end = torch.cuda.Event(enable_timing=True)
    end.record()
    LAUNCH_EVENTS.append((timer[0], timer[1], end))


def check_status(status: int, what: str) -> None:
    """Raises when a kernel's C entry point returned a CUDA error."""
    if status != 0:
        raise RuntimeError(
            f"{what} failed with cudaError {status} at launch"
        )
