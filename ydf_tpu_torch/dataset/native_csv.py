"""ctypes bridge to the port's CSV loader, csrc/csv_loader.cc
(counterpart of ydf_tpu/dataset/native_csv.py).

The loader is host C++, not a kernel. It is compiled at first use with

    g++ -O3 -std=c++17 -shared -fPIC -o build/libydfcsv.so csrc/csv_loader.cc

into `ydf_tpu_torch/build/` (git-ignored), rebuilt when the source is
newer, and loaded with ctypes. Nothing falls back: a failed build raises
with g++'s log, and a file the loader refuses raises naming the file and
the loader's error (the JAX package falls back to pandas there; the
card's machine has no pandas).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time
from typing import Dict

import numpy as np

from ydf_tpu_torch.utils.cuda_build import BUILD_DIR, SRC_DIR

SOURCE = os.path.join(SRC_DIR, "csv_loader.cc")
LIBRARY = os.path.join(BUILD_DIR, "libydfcsv.so")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIB = None


def gxx_build(source: str, library: str, what: str,
              force: bool = False) -> float:
    """Compiles the host C++ `source` into the shared `library` with
    GXX_FLAGS when stale (or, with force, always). Returns the wall
    seconds; raises RuntimeError naming `what` with g++'s log on
    failure."""
    if not force and os.path.isfile(library) and (
            os.path.getmtime(library) >= os.path.getmtime(source)):
        return 0.0
    t0 = time.perf_counter()
    os.makedirs(os.path.dirname(library), exist_ok=True)
    # Write beside the target and rename: a concurrent loader never sees
    # a half-written library.
    tmp = f"{library}.{os.getpid()}.tmp"
    cmd = ["g++", *GXX_FLAGS, "-o", tmp, source]
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(
            f"{what} cannot be built: {' '.join(cmd)}: {e}") from e
    if p.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"{what}'s build failed (exit {p.returncode}): "
            f"{' '.join(cmd)}\n{p.stdout}{p.stderr}")
    os.replace(tmp, library)
    return time.perf_counter() - t0


def build(force: bool = False) -> float:
    """Compiles the loader when stale (or, with force, always): the wall
    seconds (gxx_build)."""
    return gxx_build(SOURCE, LIBRARY, "the CSV loader", force)


def _declare(lib) -> None:
    p, i32 = ctypes.c_void_p, ctypes.c_int32
    sigs = {
        "ydf_csv_load": (p, [ctypes.c_char_p]),
        "ydf_csv_free": (None, [p]),
        "ydf_csv_error": (ctypes.c_char_p, [p]),
        "ydf_csv_num_rows": (ctypes.c_int64, [p]),
        "ydf_csv_num_cols": (i32, [p]),
        "ydf_csv_col_name": (ctypes.c_char_p, [p, i32]),
        "ydf_csv_col_is_numeric": (i32, [p, i32]),
        "ydf_csv_col_numeric": (ctypes.POINTER(ctypes.c_double), [p, i32]),
        "ydf_csv_col_codes": (ctypes.POINTER(ctypes.c_int32), [p, i32]),
        "ydf_csv_col_dict_size": (i32, [p, i32]),
        "ydf_csv_col_dict_value": (ctypes.c_char_p, [p, i32, i32]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def load_library():
    """The loader's ctypes handle, built first when stale."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            build()
            lib = ctypes.CDLL(LIBRARY)
            _declare(lib)
            _LIB = lib
        return _LIB


def read_csv(path: str) -> Dict[str, np.ndarray]:
    """name -> column: float64 with NaN missing, or an object array of
    strings with "" missing (the JAX package's native_csv.read_csv)."""
    lib = load_library()
    handle = lib.ydf_csv_load(path.encode("utf-8"))
    if not handle:
        raise RuntimeError(f"the CSV loader returned no handle for {path!r}")
    try:
        err = lib.ydf_csv_error(handle)
        if err:
            raise ValueError(
                f"the CSV loader refused {path!r}: {err.decode('utf-8')}")
        n = lib.ydf_csv_num_rows(handle)
        out: Dict[str, np.ndarray] = {}
        for i in range(lib.ydf_csv_num_cols(handle)):
            name = lib.ydf_csv_col_name(handle, i).decode("utf-8")
            if n == 0:
                out[name] = np.zeros((0,), object)  # no value: not numeric
            elif lib.ydf_csv_col_is_numeric(handle, i):
                out[name] = np.ctypeslib.as_array(
                    lib.ydf_csv_col_numeric(handle, i), shape=(n,)).copy()
            else:
                codes = np.ctypeslib.as_array(
                    lib.ydf_csv_col_codes(handle, i), shape=(n,)).copy()
                vocab = np.array(
                    [lib.ydf_csv_col_dict_value(handle, i, j).decode("utf-8")
                     for j in range(lib.ydf_csv_col_dict_size(handle, i))]
                    + [""],  # code -1 (missing) indexes the sentinel
                    dtype=object)
                out[name] = vocab[codes]
        return out
    finally:
        lib.ydf_csv_free(handle)
