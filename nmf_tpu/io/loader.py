"""Sparse-matrix ingest: MatrixMarket loading and COO->CSR conversion.

The hot path is the native C++ library built from ``native/nmf_host.cpp``
(multithreaded mmap-free parser + counting-sort CSR build), reached through
ctypes.  It is compiled into ``native/build/`` at first use (or ahead of
time with ``make -C native``), with portable flags, since the machine that
runs the program may not be the one that built it.  A pure-numpy fallback,
announced by a warning, keeps everything working when the build fails.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import warnings
from typing import NamedTuple

import numpy as np

__all__ = [
    "load_mtx", "coo_to_csr", "native_available", "to_bcoo",
    "stable_argsort", "gather3",
]

_LIB = None
_LIB_TRIED = False


class _MtxResult(ctypes.Structure):
    _fields_ = [
        ("rows", ctypes.c_int64),
        ("cols", ctypes.c_int64),
        ("nnz", ctypes.c_int64),
        ("row_idx", ctypes.POINTER(ctypes.c_int32)),
        ("col_idx", ctypes.POINTER(ctypes.c_int32)),
        ("values", ctypes.POINTER(ctypes.c_float)),
        ("error", ctypes.c_int32),
    ]


_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_NATIVE_SRC = os.path.join(_NATIVE_DIR, "nmf_host.cpp")
LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libnmf_host.so")
# keep in step with native/Makefile
_CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]


def _build_lib() -> None:
    """Compile the library into ``LIB_PATH`` when it is missing or older
    than its source.  Concurrent builders (test workers) each write their
    own file and rename it into place, so a reader never sees half a
    library."""
    if (os.path.exists(LIB_PATH)
            and os.path.getmtime(LIB_PATH) >= os.path.getmtime(_NATIVE_SRC)):
        return
    os.makedirs(os.path.dirname(LIB_PATH), exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "c++"), *_CXXFLAGS, "-o", tmp, _NATIVE_SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=600)
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load_lib():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    try:
        _build_lib()
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        warnings.warn(
            f"building {LIB_PATH} failed ({e}); host ingest falls back to "
            f"numpy. {detail.decode(errors='replace')[-2000:]}",
            RuntimeWarning,
            stacklevel=2,
        )
        return None
    path = LIB_PATH
    try:
        lib = ctypes.CDLL(path)
        lib.nmf_load_mtx.argtypes = [ctypes.c_char_p, ctypes.POINTER(_MtxResult)]
        lib.nmf_load_mtx.restype = ctypes.c_int32
        lib.nmf_free.argtypes = [ctypes.c_void_p]
        lib.nmf_coo_to_csr.argtypes = [
            ctypes.c_int64,
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.float32),
            np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.float32),
        ]
        lib.nmf_coo_to_csr.restype = ctypes.c_int64
        lib.nmf_argsort64.argtypes = [
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.int64),
        ]
        lib.nmf_argsort64.restype = ctypes.c_int64
        lib.nmf_gather3.argtypes = [
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.float32),
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.float32),
        ]
        lib.nmf_gather3.restype = None
        _LIB = lib
    except (OSError, AttributeError) as e:
        # AttributeError: a library missing a symbol the bindings declare
        warnings.warn(
            f"loading {path} failed ({e}); host ingest falls back to numpy",
            RuntimeWarning,
            stacklevel=2,
        )
        _LIB = None
    return _LIB


def native_available() -> bool:
    return _load_lib() is not None


class COO(NamedTuple):
    rows: int
    cols: int
    row_idx: np.ndarray
    col_idx: np.ndarray
    values: np.ndarray


class CSR(NamedTuple):
    rows: int
    cols: int
    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray


def load_mtx(path: str) -> COO:
    """Parse a MatrixMarket coordinate file into COO arrays."""
    lib = _load_lib()
    if lib is not None:
        res = _MtxResult()
        rc = lib.nmf_load_mtx(str(path).encode(), ctypes.byref(res))
        if rc == 0:
            n = res.nnz
            ri = np.ctypeslib.as_array(res.row_idx, (n,)).copy()
            ci = np.ctypeslib.as_array(res.col_idx, (n,)).copy()
            v = np.ctypeslib.as_array(res.values, (n,)).copy()
            lib.nmf_free(res.row_idx)
            lib.nmf_free(res.col_idx)
            lib.nmf_free(res.values)
            return COO(int(res.rows), int(res.cols), ri, ci, v)
        if rc == 2:
            raise ValueError(f"Unsupported MatrixMarket format: {path}")
        # rc == 1: IO error -> fall through to numpy for the error message
    return _load_mtx_numpy(path)


def _load_mtx_numpy(path: str) -> COO:
    import scipy.io

    m = scipy.io.mmread(path).tocoo()
    return COO(
        m.shape[0],
        m.shape[1],
        m.row.astype(np.int32),
        m.col.astype(np.int32),
        m.data.astype(np.float32),
    )


def coo_to_csr(coo: COO) -> CSR:
    """COO -> CSR with duplicate summing."""
    lib = _load_lib()
    nnz = len(coo.values)
    if lib is not None:
        indptr = np.zeros(coo.rows + 1, np.int64)
        indices = np.empty(nnz, np.int32)
        data = np.empty(nnz, np.float32)
        new_nnz = lib.nmf_coo_to_csr(
            coo.rows,
            nnz,
            np.ascontiguousarray(coo.row_idx, np.int32),
            np.ascontiguousarray(coo.col_idx, np.int32),
            np.ascontiguousarray(coo.values, np.float32),
            indptr,
            indices,
            data,
        )
        return CSR(coo.rows, coo.cols, indptr, indices[:new_nnz], data[:new_nnz])
    import scipy.sparse

    m = scipy.sparse.coo_matrix(
        (coo.values, (coo.row_idx, coo.col_idx)), shape=(coo.rows, coo.cols)
    ).tocsr()
    m.sum_duplicates()
    return CSR(
        coo.rows,
        coo.cols,
        m.indptr.astype(np.int64),
        m.indices.astype(np.int32),
        m.data.astype(np.float32),
    )


def stable_argsort(keys: np.ndarray) -> np.ndarray:
    """Stable argsort of a non-negative int64 key array — the native
    parallel radix sort when available, numpy otherwise."""
    lib = _load_lib()
    keys = np.ascontiguousarray(keys, np.int64)
    # The radix path orders two's-complement digits, which puts negative
    # keys AFTER positives — guard with one cheap O(n) min scan (all current
    # call sites build non-negative keys, but a silent size-and-build-
    # dependent ordering would be a brutal debug).
    if (
        lib is not None
        and (1 << 16) <= len(keys) < (1 << 31)
        and int(keys.min(initial=0)) >= 0
    ):
        order = np.empty(len(keys), np.int64)
        lib.nmf_argsort64(len(keys), keys, order)
        return order
    return np.argsort(keys, kind="stable")


def gather3(order, r, c, v):
    """(r[order], c[order], v[order]) in one parallel native pass."""
    lib = _load_lib()
    if lib is None or len(order) < (1 << 16):
        return r[order], c[order], v[order]
    n = len(order)
    ro = np.empty(n, np.int32)
    co = np.empty(n, np.int32)
    vo = np.empty(n, np.float32)
    lib.nmf_gather3(
        n, np.ascontiguousarray(order, np.int64),
        np.ascontiguousarray(r, np.int32),
        np.ascontiguousarray(c, np.int32),
        np.ascontiguousarray(v, np.float32), ro, co, vo,
    )
    return ro, co, vo


def to_bcoo(x, dtype=np.float32):
    """COO/CSR -> jax BCOO (sorted, deduped)."""
    import jax.numpy as jnp
    from jax.experimental import sparse as jsparse

    if isinstance(x, CSR):
        rows = np.repeat(
            np.arange(x.rows, dtype=np.int32), np.diff(x.indptr).astype(np.int64)
        )
        idx = np.stack([rows, x.indices], axis=1)
        vals = x.data
        shape = (x.rows, x.cols)
        return jsparse.BCOO(
            (jnp.asarray(vals, dtype), jnp.asarray(idx)),
            shape=shape,
            indices_sorted=True,
            unique_indices=True,
        )
    csr = coo_to_csr(x)
    return to_bcoo(csr, dtype)
