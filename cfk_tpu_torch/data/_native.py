"""ctypes bindings to the port's host ingest library (``csrc/host/``).

The port's own copy of ``cfk_tpu/data/_native.py``: the same functions and
error semantics over the port's own C++ source, which ``_build.py`` compiles
with the host C++ compiler into ``cfk_tpu_torch/_build/`` the first time
``available()`` or ``load_library()`` is called (never at import).  A
library that does not load, lacks a symbol or reports another ABI version is
rebuilt, never used.  Where no library can be built, ``available()`` is False
and every caller takes its numpy / pure-Python plain version, which the
tests hold bit-identical to this route.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from cfk_tpu_torch import _build
from cfk_tpu_torch.data.blocks import RatingsCOO

_IO_ERROR = -0x7FFFFFFF
# Must match cfk_native_abi_version() in csrc/host/cfk_native.cpp.
ABI_VERSION = 1
# Raw-id range above which the presence-table indexer would waste memory;
# callers take the sort path (np.unique) past it.
INDEX_DENSE_MAX_RAW = 1 << 28

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_error: Exception | None = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64 = ctypes.c_longlong
    p64 = ctypes.POINTER(ctypes.c_int64)
    pll = ctypes.POINTER(ctypes.c_longlong)
    pf = ctypes.POINTER(ctypes.c_float)
    lib.cfk_parse_netflix.restype = i64
    lib.cfk_parse_netflix.argtypes = [ctypes.c_char_p, pll, pll, pf, i64]
    lib.cfk_parse_movielens.restype = i64
    lib.cfk_parse_movielens.argtypes = [ctypes.c_char_p, pll, pll, pf, i64,
                                        ctypes.c_float]
    lib.cfk_group_by.restype = ctypes.c_int
    lib.cfk_group_by.argtypes = [p64, i64, i64, p64,
                                 ctypes.POINTER(ctypes.c_int32), p64]
    lib.cfk_index_dense.restype = i64
    lib.cfk_index_dense.argtypes = [p64, i64, ctypes.c_int64, p64,
                                    ctypes.POINTER(ctypes.c_int32)]
    lib.cfk_native_abi_version.restype = ctypes.c_int
    lib.cfk_native_abi_version.argtypes = []
    return lib


def load_library() -> ctypes.CDLL:
    """The host library, built first if it is missing, stale or of another
    ABI version.  A rebuild is compiled under a name of its own, loaded and
    checked from there, and only then renamed into place, so a process
    never loads a file another process is still writing.  Raises
    RuntimeError if it cannot be built."""
    path = _build.host_library_path()
    if path.exists():
        try:
            lib = _bind(ctypes.CDLL(str(path)))
            if lib.cfk_native_abi_version() == ABI_VERSION:
                return lib
        except (OSError, AttributeError):
            pass  # unloadable, or a symbol missing: rebuild below
    tmp = _build.compile_host_library()
    try:
        lib = _bind(ctypes.CDLL(str(tmp)))
        version = lib.cfk_native_abi_version()
        if version != ABI_VERSION:
            raise RuntimeError(
                f"{_build.HOST_SOURCE} reports ABI version {version}, the "
                f"bindings expect {ABI_VERSION}")
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    return lib


def available() -> bool:
    """True once the host library is loaded (built on the first call); False
    if it cannot be built, in which case callers take their plain
    versions."""
    global _lib, _load_error
    with _lock:
        if _lib is None and _load_error is None:
            try:
                _lib = load_library()
            except (OSError, RuntimeError) as e:
                _load_error = e
    return _lib is not None


def _library() -> ctypes.CDLL:
    if not available():
        raise RuntimeError(f"host ingest library unavailable: {_load_error}")
    return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _parse(fn, path, *extra) -> RatingsCOO:
    name = os.fsencode(path)
    null64 = ctypes.POINTER(ctypes.c_longlong)()
    nullf = ctypes.POINTER(ctypes.c_float)()
    n = fn(name, null64, null64, nullf, 0, *extra)
    if n == _IO_ERROR:
        raise OSError(f"cannot read {path}")
    if n < 0:
        raise ValueError(f"{path}:{-n}: malformed line")
    movie = np.empty(n, dtype=np.int64)
    user = np.empty(n, dtype=np.int64)
    rating = np.empty(n, dtype=np.float32)
    n2 = fn(name, _ptr(movie, ctypes.c_longlong),
            _ptr(user, ctypes.c_longlong), _ptr(rating, ctypes.c_float), n,
            *extra)
    if n2 != n:
        raise RuntimeError(f"{path}: changed during parse ({n} vs {n2} "
                           "records)")
    return RatingsCOO(movie_raw=movie, user_raw=user, rating=rating)


def parse_netflix(path) -> RatingsCOO:
    return _parse(_library().cfk_parse_netflix, path)


def parse_movielens(path, min_rating: float = 0.0) -> RatingsCOO:
    return _parse(_library().cfk_parse_movielens, path,
                  ctypes.c_float(min_rating))


def group_by(keys: np.ndarray, num_keys: int):
    """Stable counting-sort group-by over dense int keys: (order int64[nnz],
    count int32[num_keys], start int64[num_keys]) with the semantics of
    ``blocks.group_by_dense_numpy`` — ``order`` the stable argsort of
    ``keys``, ``start`` the exclusive prefix sum of ``count``."""
    # int64 end to end, so the C-side range check sees corrupt values (an
    # int32 downcast would wrap them into range).
    k64 = np.ascontiguousarray(keys, dtype=np.int64)
    order = np.empty(k64.shape[0], dtype=np.int64)
    count = np.empty(num_keys, dtype=np.int32)
    start = np.empty(num_keys, dtype=np.int64)
    rc = _library().cfk_group_by(
        _ptr(k64, ctypes.c_int64), k64.shape[0], num_keys,
        _ptr(order, ctypes.c_int64), _ptr(count, ctypes.c_int32),
        _ptr(start, ctypes.c_int64))
    if rc != 0:
        raise ValueError(f"group_by: key outside [0, {num_keys})")
    return order, count, start


def index_dense(raw: np.ndarray, max_raw: int | None = None
                ) -> tuple[np.ndarray, np.ndarray]:
    """(sorted unique ids int64, dense rank int32 per element) through a
    presence table, O(n + max_raw); ids must lie in [0, max_raw] (raises
    ValueError otherwise — the caller takes the sort path).  ``max_raw``
    skips a pass when the caller knows it."""
    r64 = np.ascontiguousarray(raw, dtype=np.int64)
    if r64.size == 0:
        return np.empty(0, np.int64), np.empty(0, np.int32)
    if max_raw is None:
        max_raw = int(r64.max())
    if max_raw < 0:
        raise ValueError("index_dense: negative raw id")
    unique = np.empty(min(r64.shape[0], max_raw + 1), dtype=np.int64)
    dense = np.empty(r64.shape[0], dtype=np.int32)
    n = _library().cfk_index_dense(
        _ptr(r64, ctypes.c_int64), r64.shape[0], max_raw,
        _ptr(unique, ctypes.c_int64), _ptr(dense, ctypes.c_int32))
    if n < 0:
        raise ValueError("index_dense: raw id outside [0, max_raw]")
    return unique[:n].copy(), dense
