"""The data feed (counterpart of `bsms_gnn_tpu/data/pipeline.py`): the
bucket plan of a variable-mesh dataset on disk, shuffled infinite batches
from worker threads, the copy of batches to the device ahead of use, the
rollout iterator, and the union of a batch's hierarchies.

A batch is `[B, N_pad, C]` arrays with one hierarchy on the device: on a
consistent-mesh dataset the one hierarchy its readers share; on a
variable-mesh dataset the union of its samples' hierarchies
(`stack_hierarchies`): one hierarchy of B·N_pad rows per level,
block-diagonal, on which the batch runs every route and kernel as one
sample does, each kernel once a call. Each trajectory's hierarchy is
padded to its size group's buckets (`plan_buckets`), moved to the device
once by its reader and kept. JAX stacks the hierarchies leaf-wise and
vmaps the forward over them, which computes the same function sample by
sample.

Batches hold clean frames: the trainer adds the noise on the device.
"""

from __future__ import annotations

import collections
import glob
import json
import os
import queue
import threading
from collections.abc import Sequence as SequenceABC
from dataclasses import dataclass
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bsms_gnn_tpu_torch.config import DatasetConfig
from bsms_gnn_tpu_torch.data.trajectory import TrajectoryReader
from bsms_gnn_tpu_torch.graph import buckets
from bsms_gnn_tpu_torch.graph.hierarchy import (
    Hierarchy,
    load_or_build_levels,
    union,
)
from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
from bsms_gnn_tpu_torch.graph.order import reorder_mesh


@dataclass
class Batch:
    node_in: Any  # [B, N_pad, C + pos + 1]: numpy, or a tensor once on the device
    node_tar: Any  # [B, N_pad, C]
    node_mask: Any  # [B, N_pad, 1]
    hierarchy: Hierarchy  # on the device: shared, or the samples' union


def stack_hierarchies(hs: Sequence[Hierarchy]) -> Hierarchy:
    """The union of B device hierarchies (each through `to_device`) of one
    size group, on their device: every index offset by its sample's base,
    the derived tables of `to_device` included. Hierarchies of different
    padded shapes, devices or kinds (unbucketed ones, which carry fused
    transition operators) raise ValueError."""
    hs = list(hs)
    if not hs:
        raise ValueError("no hierarchy to stack")
    devices = {lv.senders.device if isinstance(lv.senders, torch.Tensor)
               else None for h in hs for lv in h.levels}
    if len(devices) != 1 or None in devices:
        raise ValueError("stack_hierarchies takes hierarchies on one device "
                         "(graph.hierarchy.to_device)")
    return union(hs)


def dataset_files(cfg: DatasetConfig, mode: str) -> List[str]:
    """The trajectory files of a split; "rollout" reads the test split."""
    disk_mode = "test" if mode == "rollout" else mode
    files = sorted(glob.glob(os.path.join(cfg.root, cfg.name, disk_mode,
                                          "*.h5")))
    if not files:
        raise FileNotFoundError(
            f"No trajectories under {os.path.join(cfg.root, cfg.name, disk_mode)}")
    return files


def _plan_key(path: str) -> str:
    """Split-qualified key: train/0.h5 and test/0.h5 are different files."""
    return os.path.join(os.path.basename(os.path.dirname(path)),
                        os.path.basename(path))


@dataclass
class BucketPlan:
    """The per-level padded shapes of each size group of a variable-mesh
    dataset (`graph.buckets.plan_buckets`) and the group of each file."""

    groups: List[dict]  # {"node_buckets", "edge_buckets", "ell_buckets",
    #                      "resid_buckets" ([e_pad, k] per level, or None)}
    file_group: dict  # "split/basename" -> group index

    def for_file(self, path: str) -> dict:
        """`TrajectoryReader` keyword arguments of a file."""
        g = self.groups[self.file_group[_plan_key(path)]]
        return {"node_buckets": g["node_buckets"],
                "edge_buckets": g["edge_buckets"],
                "ell_buckets": g.get("ell_buckets"),
                "resid_buckets": (None if g.get("resid_buckets") is None
                                  else [tuple(r) for r in g["resid_buckets"]])}


def _load_levels_for(cfg: DatasetConfig, path: str):
    """A file's raw bi-stride levels (cached), on its mesh as the reader
    builds it: Morton-ordered under the reader's "_mrt" name when
    windowed."""
    import h5py

    with h5py.File(path, "r") as f:
        cells = np.asarray(f["cells"][0])
        pos = np.asarray(f["mesh_pos"][0], np.float64)
    name = os.path.splitext(os.path.basename(path))[0]
    if cfg.window:
        pos, cells, _, _ = reorder_mesh(pos, cells)
        name += "_mrt"
    return load_or_build_levels(os.path.dirname(path), name,
                                to_flat_edge(cells, cfg.mesh_type),
                                cfg.unet_depth, pos.shape[0], pos)


class _FileLevels(SequenceABC):
    """The files' levels, each loaded (from its cache) when indexed, so
    the planner holds one mesh's levels at a time."""

    def __init__(self, cfg: DatasetConfig, files: List[str]):
        self.cfg, self.files = cfg, files

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, i):
        return _load_levels_for(self.cfg, self.files[i])


def plan_buckets(cfg: DatasetConfig, mode: str = "train") -> BucketPlan:
    """The bucket plan of a variable-mesh dataset on disk, over its train
    and test files together (the split `mode` alone when neither exists),
    sized by `graph.buckets.plan_buckets` and cached as JSON beside the
    data under the port's own name, valid while the files' names, sizes
    and times are the same."""
    if cfg.window < 0:
        raise ValueError("window=-1 (auto per-level widths) cannot be "
                         "pinned by a bucket plan")
    all_files = []
    for m in ("train", "test"):
        try:
            all_files += dataset_files(cfg, m)
        except FileNotFoundError:
            pass
    if not all_files:
        all_files = dataset_files(cfg, mode)
    k = max(1, int(cfg.size_buckets))
    plan_path = os.path.join(
        cfg.root, cfg.name,
        f"torch_buckets_d{cfg.unet_depth}_p{cfg.pad_multiple}_k{k}"
        + (f"_eb{cfg.edge_block}" if cfg.edge_block != 128 else "")
        + (f"_w{cfg.window}" if cfg.window else "") + ".json")
    fingerprint = [[_plan_key(p), os.path.getsize(p),
                    int(os.path.getmtime(p))] for p in all_files]
    fingerprint.sort()
    if os.path.isfile(plan_path):
        with open(plan_path) as f:
            plan = json.load(f)
        if plan.get("fingerprint") == fingerprint:
            return BucketPlan(plan["groups"], plan["file_group"])

    sized = buckets.plan_buckets(_FileLevels(cfg, all_files), cfg)
    file_group = {_plan_key(p): g for p, g in zip(all_files, sized.mesh_group)}
    tmp = f"{plan_path}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "w") as f:
        json.dump({"n_files": len(all_files), "fingerprint": fingerprint,
                   "groups": sized.groups, "file_group": file_group}, f)
    os.replace(tmp, plan_path)
    return BucketPlan(sized.groups, file_group)


class TrajectorySampler:
    """Infinite shuffled batches from worker threads, each worker with its
    own generator `np.random.default_rng((base_seed, worker_id, 0xB5))`:
    every pass it permutes the files, takes its share
    (`order[worker_id::workers]`), and cuts a permutation of each file's
    frames into whole batches of `batch_size` (a trajectory shorter than
    the batch gives none). With one worker the batches come in the JAX
    package's order.

    `TrajectorySampler(cfg, batch_size, ...)` reads the split `mode` of
    the dataset on disk, opening each file's reader when a worker first
    draws it; `from_readers(cfg, readers, batch_size, ...)` draws from
    readers already made. A worker's exception is raised to the consumer.
    `timeout` (seconds, None: none) bounds the wait for a batch, which
    then raises TimeoutError. `close()` stops the workers."""

    def __init__(self, cfg: DatasetConfig, batch_size: int,
                 num_workers: int = 2, base_seed: int = 42,
                 mode: str = "train", prefetch: int = 4, device=None,
                 timeout: Optional[float] = None):
        files = dataset_files(cfg, mode)
        plan = None if cfg.consist_mesh else plan_buckets(cfg, mode)
        self._start(cfg, batch_size, num_workers, base_seed, prefetch,
                    timeout, files, plan, device, [None] * len(files))

    @classmethod
    def from_readers(cls, cfg: DatasetConfig,
                     readers: Sequence[TrajectoryReader], batch_size: int,
                     num_workers: int = 2, base_seed: int = 42,
                     prefetch: int = 4,
                     timeout: Optional[float] = None) -> "TrajectorySampler":
        readers = list(readers)
        if not any(len(r) >= batch_size for r in readers):
            raise ValueError(f"no trajectory holds a batch of {batch_size} "
                             f"frames: {[len(r) for r in readers]}")
        self = cls.__new__(cls)
        self._start(cfg, batch_size, num_workers, base_seed, prefetch,
                    timeout, [None] * len(readers), None, None, readers)
        return self

    def _start(self, cfg, batch_size, num_workers, base_seed, prefetch,
               timeout, files, plan, device, readers):
        self.cfg, self.batch_size, self.timeout = cfg, batch_size, timeout
        self.files, self.plan, self.device = files, plan, device
        self._readers = readers
        self._readers_lock = threading.Lock()
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._worker, args=(w, base_seed),
                             daemon=True)
            for w in range(max(1, num_workers))]
        for t in self._threads:
            t.start()

    def _get_reader(self, i: int) -> TrajectoryReader:
        with self._readers_lock:
            r = self._readers[i]
            shared = next((x for x in self._readers if x is not None), None)
        if r is None:
            path = self.files[i]
            bk = {} if self.plan is None else self.plan.for_file(path)
            r = TrajectoryReader(
                self.cfg, path, device=self.device,
                shared=shared if self.cfg.consist_mesh else None, **bk)
            with self._readers_lock:
                self._readers[i] = r
        return r

    def _put(self, item) -> bool:
        """Queue `item`, waiting while the queue is full; False once the
        sampler is closed."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def _worker(self, worker_id: int, base_seed: int) -> None:
        rng = np.random.default_rng((base_seed, worker_id, 0xB5))
        n_workers = len(self._threads)
        try:
            while not self._stop.is_set():
                file_order = rng.permutation(len(self.files))
                for fi in file_order[worker_id::n_workers]:
                    reader = self._get_reader(int(fi))
                    t_ids = rng.permutation(len(reader))
                    for start in range(0, len(t_ids) - self.batch_size + 1,
                                       self.batch_size):
                        batch = self._collate(
                            [(reader, int(t)) for t in
                             t_ids[start:start + self.batch_size]])
                        if not self._put(batch):
                            return
        except Exception as e:  # surfaced to the consumer by __next__
            self._put(e)

    def _collate(self, samples: List[Tuple[TrajectoryReader, int]]) -> Batch:
        ins, tars, masks = zip(*(r.sample(t) for r, t in samples))
        if self.cfg.consist_mesh:
            hierarchy = samples[0][0].hd
        else:
            hierarchy = stack_hierarchies([r.hd for r, _ in samples])
        return Batch(np.stack(ins), np.stack(tars), np.stack(masks),
                     hierarchy)

    def __iter__(self) -> Iterator[Batch]:
        return self

    def __next__(self) -> Batch:
        try:
            item = self._queue.get(timeout=self.timeout)
        except queue.Empty:
            raise TimeoutError(f"no batch of {self.batch_size} frames within "
                               f"{self.timeout} s") from None
        if isinstance(item, Exception):
            raise RuntimeError("TrajectorySampler worker failed") from item
        return item

    def close(self) -> None:
        """Stop the workers and drop the queued batches (again after the
        workers end: one may have queued a last batch meanwhile)."""
        self._stop.set()
        self._drain()
        for t in self._threads:
            t.join(timeout=10)
        self._drain()

    def _drain(self) -> None:
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass


def batch_to_device(b: Batch) -> Batch:
    """The batch's arrays as tensors on its hierarchy's device: on a CUDA
    device copied from pinned host memory with `non_blocking` on the
    current stream, so the copy overlaps the work queued before it."""
    device = b.hierarchy.levels[0].senders.device

    def move(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    return Batch(move(b.node_in), move(b.node_tar), move(b.node_mask),
                 b.hierarchy)


def device_prefetch(batches: Iterator[Batch], depth: int = 2
                    ) -> Iterator[Batch]:
    """`batch_to_device` of each batch, `depth` batches ahead of use."""
    q: "collections.deque[Batch]" = collections.deque()
    it = iter(batches)
    try:
        while True:
            while len(q) <= depth:
                q.append(batch_to_device(next(it)))
            yield q.popleft()
    except StopIteration:
        while q:
            yield q.popleft()


def rollout_iterator(cfg: DatasetConfig, base_seed: int = 42, device=None
                     ) -> Iterator[Tuple[TrajectoryReader, np.ndarray,
                                         np.ndarray, np.ndarray]]:
    """Whole test trajectories for closed-loop rollout: (reader, inputs
    [T-1, N_pad, C_in], targets [T-1, N_pad, C], masks [T-1, N_pad, 1]).
    `base_seed` is unused, as in the JAX package (the order is the
    files')."""
    plan = None if cfg.consist_mesh else plan_buckets(cfg, "rollout")
    shared = None
    for path in dataset_files(cfg, "rollout"):
        bk = {} if plan is None else plan.for_file(path)
        reader = TrajectoryReader(cfg, path, device=device, shared=shared,
                                  **bk)
        if cfg.consist_mesh:
            shared = reader
        inp, tar, mask = reader.full()
        yield reader, inp, tar, mask
