"""ctypes binding to the native CSV writer (``native/csvio.cpp``), with a
numpy fallback when the shared library can't be built.

The native path replaces the reference's per-particle Python write loop
(``src/s01-dataset-generation.py:218-241``): one C pass over contiguous
column arrays.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

from nbody_sim.data.schema import CSV_FIELDS

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libnbodyio.so"))

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def _load_lib() -> Optional[ctypes.CDLL]:
    """Load (building on first use if a toolchain is available) the native IO
    library; returns None when unavailable — callers fall back to numpy."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(
                ["make", "-C", os.path.abspath(_NATIVE_DIR)],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.nbody_write_csv.restype = ctypes.c_int
        lib.nbody_write_csv.argtypes = [
            ctypes.c_char_p,  # path
            ctypes.c_char_p,  # header
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,  # int cols
            ctypes.POINTER(ctypes.c_int32),  # str idx
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,  # str names
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,  # dbl cols
            ctypes.c_int64,  # n_rows
        ]
        _lib = lib
    except OSError:
        _lib = None
    return _lib


_INT_COLS = ["scene", "step"]
_STR_COL = "scene_type"
_DBL_COLS = [c for c in CSV_FIELDS if c not in _INT_COLS and c != _STR_COL]


def _write_csv_numpy(cols, path: str) -> None:
    """Row-at-a-time fallback with the native writer's number formats."""
    fmt = ",".join(
        "%d" if c in _INT_COLS else "%s" if c == _STR_COL else "%.9g"
        for c in CSV_FIELDS)
    table = np.empty((len(cols[CSV_FIELDS[0]]), len(CSV_FIELDS)), object)
    for i, c in enumerate(CSV_FIELDS):
        table[:, i] = cols[c]
    np.savetxt(path, table, fmt=fmt, header=",".join(CSV_FIELDS),
               comments="")


def write_csv(cols, path: str) -> None:
    """Write trajectory columns in the reference schema to ``path``.

    :param cols: mapping from every name in ``CSV_FIELDS`` to a 1-D numpy
        column of one common length.

    Uses the native writer when available, a numpy writer with the same
    number formats otherwise.
    """
    lib = _load_lib()
    if lib is None:
        _write_csv_numpy(cols, path)
        return

    n = len(cols[CSV_FIELDS[0]])
    ints = np.ascontiguousarray(
        np.stack([np.asarray(cols[c], np.int64) for c in _INT_COLS])
    )
    types, str_idx = np.unique(np.asarray(cols[_STR_COL], object),
                               return_inverse=True)
    str_idx = np.ascontiguousarray(str_idx.astype(np.int32))
    names = (ctypes.c_char_p * len(types))(
        *[str(t).encode() for t in types]
    )
    dbls = np.ascontiguousarray(
        np.stack([np.asarray(cols[c], np.float64) for c in _DBL_COLS])
    )
    header = ",".join(CSV_FIELDS).encode()
    rc = lib.nbody_write_csv(
        path.encode(),
        header,
        ints.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(_INT_COLS),
        str_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        names,
        len(types),
        dbls.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(_DBL_COLS),
        n,
    )
    if rc != 0:
        raise IOError(f"native CSV writer failed with code {rc} for {path}")


def native_available() -> bool:
    return _load_lib() is not None
