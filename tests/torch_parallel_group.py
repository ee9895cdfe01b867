"""Start one gloo group of `torch_parallel_worker.py` ranks on the CPU and
collect what each rank returns (the port's parallel tests share one group
per module)."""

import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import torch

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_parallel_worker.py")


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Group:
    """`world` ranks running `cases` (name → case dict), started at once;
    `results()` waits for them and returns each rank's {name: result}, in
    rank order. A rank that fails fails the group: its exit code and
    output are raised (the others are stopped)."""

    def __init__(self, cases: dict, world: int, timeout: float = 240.0):
        self.tmp = tempfile.TemporaryDirectory()
        self.world, self.timeout = world, timeout
        task = os.path.join(self.tmp.name, "task.pt")
        torch.save({"cases": cases}, task)
        port = free_port()
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [os.path.dirname(os.path.dirname(WORKER))]
            + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        self.procs = [subprocess.Popen(
            [sys.executable, WORKER, task, str(r), str(world), str(port),
             self._out(r)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env) for r in range(world)]
        self._results = None

    def _out(self, r):
        return os.path.join(self.tmp.name, f"out{r}.pt")

    def results(self):
        if self._results is not None:
            return self._results
        outs = []
        try:
            for p in self.procs:
                outs.append(p.communicate(timeout=self.timeout)[0])
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [(r, p.returncode, o) for r, (p, o) in
               enumerate(zip(self.procs, outs)) if p.returncode != 0]
        try:
            if bad:
                raise RuntimeError("\n".join(
                    f"rank {r} exited with {rc}:\n{o[-4000:]}"
                    for r, rc, o in bad))
            self._results = [torch.load(self._out(r), weights_only=False)
                             for r in range(self.world)]
        finally:
            self.tmp.cleanup()
        return self._results


def run_group(cases: dict, world: int, timeout: float = 240.0):
    """`Group(cases, world, timeout).results()`."""
    return Group(cases, world, timeout).results()


def gather_shards(results, name, key, n_shards):
    """Shard-major [S, ...] of one output of case `name`, from ranks
    0 .. S-1 (each holds shard r)."""
    for r in range(n_shards):
        assert results[r][name]["shard"] == r
    return np.stack([results[r][name][key] for r in range(n_shards)])


def step_grads(trainer):
    """The gradients a train step just applied (summed over the group,
    clipped), as numpy copies by name, or None after a warmup gate step."""
    params = dict(trainer.sim.named_parameters())
    if any(p.grad is None for p in params.values()):
        return None
    return {k: p.grad.detach().cpu().numpy().copy()
            for k, p in params.items()}


def _rms(a):
    return float(np.sqrt(np.mean(np.asarray(a, np.float64) ** 2)))


def grad_errors(got, want):
    """Each gradient tensor's RMS error over the reference's RMS (0 where
    both are zero, inf where only the reference is)."""
    out = {}
    for k, w in want.items():
        err, rms = _rms(got[k] - w), _rms(w)
        out[k] = err / rms if rms > 0 else (0.0 if err == 0 else float("inf"))
    return out


def update_errors(got, want, init):
    """Each parameter tensor's update (after − before) against the
    reference's: RMS error over the reference update's RMS (which must
    not be zero)."""
    out = {}
    for k, p0 in init.items():
        p0 = p0.numpy()
        rms = _rms(want[k] - p0)
        assert rms > 0, k
        out[k] = _rms((got[k] - p0) - (want[k] - p0)) / rms
    return out
