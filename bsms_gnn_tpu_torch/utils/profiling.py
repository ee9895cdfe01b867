"""Device profiling helpers (counterpart of `bsms_gnn_tpu/utils/profiling.py`):
a `torch.profiler` trace written as a Chrome trace (chrome://tracing,
Perfetto), and a sustained-throughput report."""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable, Iterable, Optional

import torch

from bsms_gnn_tpu_torch.utils.timing import device_sync


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """`with device_trace(d): ...` profiles the block (the host, and the
    CUDA card where there is one) and writes its Chrome trace into `d`
    (by default `bsms-trace` under the temporary directory) as
    `trace_<pid>_<ns>.json` when the block ends. Yields `d`."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "bsms-trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    try:
        with prof:
            yield log_dir
    finally:
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def throughput(
    fn: Callable,
    args: Iterable,
    edges: Optional[int] = None,
    steps: int = 50,
    warmup: int = 3,
) -> dict:
    """Sustained throughput: `warmup` calls each waited for, then `steps`
    calls issued back to back and the card waited for once. Returns
    {"ms_per_step"} (and "edges_per_s" where `edges` is given)."""
    args = tuple(args)
    for _ in range(warmup):
        device_sync(fn(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(steps):
        out = fn(*args)
    device_sync(out)
    dt = (time.perf_counter() - t0) / steps
    result = {"ms_per_step": dt * 1e3}
    if edges is not None:
        result["edges_per_s"] = edges / dt
    return result
