"""The native (C++) graph precompute, loaded with ctypes (counterpart of
`bsms_gnn_tpu/graph/native/`): the boolean-semiring square of a CSR
pattern, which the bi-stride build uses to square each level's adjacency,
and a CSR BFS.

`spgemm.cpp` compiles with `g++` at first use into `build/` beside it
(git-ignored), under a temporary name renamed into place, so that several
processes may build at once; a library older than the source is rebuilt.
Nothing builds at import. Where no compiler is found `square_pattern`
takes SciPy's sparse product, the same pattern bit for bit, and
`native_available()` says which route runs.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np
import scipy.sparse

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "spgemm.cpp")
BUILD_DIR = os.path.join(_DIR, "build")
_SO = os.path.join(BUILD_DIR, "libbsms_graph.so")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
# Why the library is not available, where it is not.
error: Optional[str] = None

_I64P = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")


def _build() -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, _SRC], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if (not os.path.exists(_SO)
                    or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
                _build()
            lib = ctypes.CDLL(_SO)
        except subprocess.CalledProcessError as e:
            error = f"g++ failed: {e.stderr.strip()}"
            return None
        except OSError as e:  # no g++, or a library that does not load
            error = f"{type(e).__name__}: {e}"
            return None
        lib.spgemm_bool_sq_count.restype = ctypes.c_int64
        lib.spgemm_bool_sq_count.argtypes = [
            ctypes.c_int64, _I64P, _I64P, ctypes.c_int, _I64P]
        lib.spgemm_bool_sq_fill.restype = None
        lib.spgemm_bool_sq_fill.argtypes = [
            ctypes.c_int64, _I64P, _I64P, ctypes.c_int, _I64P, _I64P]
        lib.csr_bfs.restype = None
        lib.csr_bfs.argtypes = [ctypes.c_int64, _I64P, _I64P, ctypes.c_int64,
                                _I64P]
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the C++ library is built and loaded (building it if need
    be)."""
    return _load() is not None


def square_pattern_scipy(adj: scipy.sparse.csr_matrix, drop_diag: bool = True
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """`square_pattern` by SciPy's sparse product (the route where no
    compiler is found)."""
    adj = adj.tocsr()
    out = (adj.astype(bool) @ adj.astype(bool)).tocsr()
    if drop_diag:
        out.setdiag(False)
        out.eliminate_zeros()
    out.sort_indices()
    return out.indptr.astype(np.int64), out.indices.astype(np.int64)


def square_pattern(adj: scipy.sparse.csr_matrix, drop_diag: bool = True
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """The sparsity pattern of adj @ adj as (indptr, indices) int64 CSR
    arrays, each row's columns sorted, in the boolean semiring (only the
    pattern matters downstream): the bi-stride build's squaring of A + I."""
    adj = adj.tocsr()
    lib = _load()
    if lib is None:
        return square_pattern_scipy(adj, drop_diag)
    n = adj.shape[0]
    indptr = np.ascontiguousarray(adj.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(adj.indices, dtype=np.int64)
    counts = np.zeros(n, dtype=np.int64)
    total = lib.spgemm_bool_sq_count(n, indptr, indices, int(drop_diag),
                                     counts)
    out_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=out_indptr[1:])
    out_indices = np.empty(total, dtype=np.int64)
    lib.spgemm_bool_sq_fill(n, indptr, indices, int(drop_diag), out_indptr,
                            out_indices)
    return out_indptr, out_indices


def bfs(indptr: np.ndarray, indices: np.ndarray, seed: int
        ) -> Optional[np.ndarray]:
    """Hop distances from `seed` over a CSR graph, -1 where unreachable; None
    where the library is not available."""
    lib = _load()
    if lib is None:
        return None
    n = indptr.shape[0] - 1
    dist = np.full(n, -1, dtype=np.int64)
    lib.csr_bfs(n, np.ascontiguousarray(indptr, dtype=np.int64),
                np.ascontiguousarray(indices, dtype=np.int64), int(seed), dist)
    return dist
