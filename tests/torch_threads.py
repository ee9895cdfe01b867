"""PyTorch's intra-op threads for the port's tests: under pytest-xdist each
worker takes its share of the CPU cores (at least one thread), not every
core. Each of the n workers would otherwise start one thread per core, and
their spinning barriers starve one another: six workers on eight cores ran
`test_torch_port_stream_fwd_tiles.py`'s walk-order cases about ten times
slower than with one thread each. Imported by every
`test_torch_port_*.py`; outside xdist PyTorch keeps its default."""

import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if _WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))
