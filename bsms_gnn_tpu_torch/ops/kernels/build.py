"""Build and load the hand-written CUDA kernels.

Each `csrc/<name>.cu` compiles with `nvcc` for `sm_90a` into its own shared
library with a plain C interface under `build/` (git-ignored), loaded with
`ctypes`. All stale libraries build together, one `nvcc` process per
source, on the first call that needs any of them; a library newer than
every source in `csrc/` is reused as it is. Nothing builds at import.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

import torch

_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_DIR, "csrc")
BUILD_DIR = os.path.join(_DIR, "build")
SOURCES = ("windowed", "compact_resid", "node_mlp", "fused_gmp",
           "fused_gmp_bwd", "node_mlp_bwd", "windowed_send", "segment_sum",
           "agg_node", "fused_gmp_dyn", "fused_gmp_dyn_bwd", "fused_gmp_stream",
           "fused_gmp_stream_bwd", "segment_sum_accum", "fused_gmp_k",
           "fused_gmp_k_bwd", "subwin_conv")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not os.path.exists(lib):
        return True
    newest = max(os.path.getmtime(os.path.join(CSRC, f))
                 for f in os.listdir(CSRC))
    return os.path.getmtime(lib) < newest


def build_all() -> float:
    """Compile every stale kernel library, all `nvcc`s at once. Returns
    the wall seconds spent (0 when nothing was stale). Raises with the
    compiler's output when a build fails."""
    with _lock:
        todo = [n for n in SOURCES if _stale(n)]
        if not todo:
            return 0.0
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = {}
        for name in todo:
            tmp = f"{_lib_path(name)}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC, f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for name, (tmp, p) in procs.items():
            log, _ = p.communicate()
            with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
                f.write(log)
            if p.returncode != 0:
                failed.append(f"--- {name}.cu ---\n{log}")
            else:
                os.replace(tmp, _lib_path(name))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        return time.perf_counter() - t0


def build_log(name: str) -> str:
    """What `nvcc -Xptxas -v` printed for `name` (registers, spills)."""
    path = os.path.join(BUILD_DIR, f"{name}.log")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def library(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if stale. Each
    entry of `signatures` declares one C function's argument types; every
    C function returns its `cudaError_t` as an int."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all()
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(_lib_path(name))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
    return lib


def require(what: str, device, *tables) -> None:
    """Raise unless every layout table is a contiguous int32 tensor on
    `device` (the kernels index them as int32)."""
    for t in tables:
        if t is None:
            raise ValueError(f"{what}: a layout table is missing (the "
                             f"layout did not pass through to_device)")
        if t.dtype != torch.int32 or t.device != device or not t.is_contiguous():
            raise ValueError(f"{what}: layout tables must be contiguous int32 "
                             f"on {device}, got {t.dtype} on {t.device}")


# The most samples one launch takes (the gathers' grid y extent,
# `csrc/row_gather.cuh`'s MAX_BATCH).
MAX_BATCH = 65535


def check_batch(x, batched: bool) -> None:
    """x is [rows, C], or [B, rows, C] (1 <= B <= MAX_BATCH) where the
    function takes the batch axis (a shared mesh's); anything else
    raises."""
    if x.dim() == 2:
        return
    if not batched or x.dim() != 3:
        raise NotImplementedError("batch axis")
    if not 1 <= x.shape[0] <= MAX_BATCH:
        raise ValueError(f"batch {x.shape[0]} outside [1, {MAX_BATCH}]")


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


_stacks: Dict[tuple, tuple] = {}
_STACKS_MAX = 256


def stacked(tensors, transpose: bool = False,
            to_bf16: bool = False) -> torch.Tensor:
    """torch.stack(tensors) in f32, contiguous (with each matrix transposed
    when `transpose`, each value rounded to bf16 and kept in f32 when
    `to_bf16`: the operands a bf16-mode kernel would round at staging),
    made once and reused while the same tensors keep
    their storage and their values (version counters unchanged): the
    kernels take each MLP's tail weights as one buffer, and restacking them
    on every call costs a copy launch per call. The entry holds the
    tensors, so their ids stay theirs while it lives. Detached: gradients
    reach the weights through the kernels' autograd Functions, never
    through the stack."""
    tensors = tuple(tensors)
    key = (transpose, to_bf16) + tuple(id(t) for t in tensors)
    state = tuple((t.data_ptr(), t._version) for t in tensors)
    hit = _stacks.get(key)
    if hit is not None and hit[1] == state:
        return hit[2]
    out = torch.stack([t.detach().float() for t in tensors])
    out = (out.transpose(-2, -1) if transpose else out).contiguous()
    if to_bf16:
        out = out.to(torch.bfloat16).float()
    if len(_stacks) >= _STACKS_MAX:
        _stacks.clear()
    _stacks[key] = (tensors, state, out)
    return out


P = ctypes.c_void_p
I = ctypes.c_int
