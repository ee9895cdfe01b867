"""Wall-clock timing and ETA (counterpart of `bsms_gnn_tpu/utils/timing.py`).
A timed call that returns tensors on the CUDA card is waited for by
synchronizing the card, where JAX blocks on the array."""

from __future__ import annotations

import time
from datetime import datetime, timedelta
from functools import wraps

import torch


def _fmt(seconds: float) -> str:
    seconds = int(seconds)
    d, seconds = divmod(seconds, 86400)
    h, seconds = divmod(seconds, 3600)
    m, s = divmod(seconds, 60)
    return f"{d}-{h:02d}:{m:02d}:{s:02d}"


class TicToc:
    def __init__(self):
        self.start_time = {}

    def tic(self, name: str) -> None:
        self.start_time[name] = time.perf_counter()

    def toc(self, name: str) -> float:
        total = time.perf_counter() - self.start_time[name]
        print(f"{name} took {total:.4f} s", flush=True)
        return total

    def estimate_time(self, name: str, ratio: float) -> None:
        """Print elapsed / remaining / total estimates at `ratio` progress."""
        elapsed = time.perf_counter() - self.start_time[name]
        ratio = max(ratio, 1e-9)
        remaining = elapsed * (1 - ratio) / ratio
        finish = datetime.now() + timedelta(seconds=remaining)
        print(
            f"[eta] {ratio*100:.2f}% done | elapsed {_fmt(elapsed)} | "
            f"remaining {_fmt(remaining)} | total {_fmt(elapsed / ratio)} | "
            f"finish {finish:%Y-%m-%d %H:%M:%S}",
            flush=True,
        )


def timeit(func):
    @wraps(func)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = func(*args, **kwargs)
        device_sync(out)
        print(f"{func.__name__} took {time.perf_counter() - t0:.4f} s",
              flush=True)
        return out

    return wrapper


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def device_sync(x) -> None:
    """Wait for the CUDA card when `x` holds a tensor on it."""
    if any(t.is_cuda for t in _tensors(x)):
        torch.cuda.synchronize()


def simple_timeit(f, tries: int = 10, warmup: int = 2) -> float:
    """Median seconds per call of `f`, each waited for (`device_sync`)."""
    for _ in range(warmup):
        device_sync(f())
    times = []
    for _ in range(tries):
        t0 = time.perf_counter()
        device_sync(f())
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
