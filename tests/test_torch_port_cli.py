"""The port's CLIs by subprocess, as `tests/test_cli_subprocess.py` runs
the JAX package's: `python -m bsms_gnn_tpu_torch.train` on a
consistent-mesh and a variable-mesh synthetic dataset, and on
`datasets=deforming_plate` over synthetic tetra blocks (the windowed
`fused` method, world edges on residual sub-levels), writes checkpoints,
a rerun with `restore_dir` resumes from the newest and ends where an
uninterrupted run would, `python -m bsms_gnn_tpu_torch.rollout` restores
one and prints the summaries (its overall mean equal to an in-process
`run_rollout` on the same checkpoint), a bad override fails loudly, and
without `device=cpu` the CLI refuses to run on a machine with no card
(there is no CPU fallback). Every run passes the JAX test's overrides
plus `device=cpu`. The runs that do not depend on one another run at
once, each with one PyTorch thread."""

import glob
import os
import re
import subprocess
import sys

import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from bsms_gnn_tpu_torch.config import load_config
from bsms_gnn_tpu_torch.data.synthetic import (
    generate_synthetic_dataset,
    generate_synthetic_tetra_dataset,
)
from bsms_gnn_tpu_torch.rollout import run_rollout

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATASETS = ("synthetic_airfoil", "synthetic_cylinder_flow", "deforming_plate")
# deforming_plate on synthetic tetra blocks through the windowed `fused`
# method (kernel 13, v4's residual sub-level branch, kernel 9), whose
# kernels take a latent width of 128 only.
EXTRA = {"deforming_plate": ["datasets.name=synthetic_deforming_plate",
                             "model.latent_dim=128",
                             "model.aggregation=fused",
                             "datasets.window=256",
                             "datasets.edge_block=512"]}
# tests/test_cli_subprocess.py's overrides but the dataset.
OVERRIDES = [
    "model.unet_depth=2", "datasets.unet_depth=2",
    "model.latent_dim=8", "model.hidden_layer=1",
    "model.accumulation_steps=1",
    "datasets.pad_multiple=32",
    "opt.warmup_steps=2", "opt.decay_steps=10",
    "batch=2", "epochs=1", "steps_per_epoch=3",
    "loss_freq=2", "save_freq=3", "time_freq=100", "dataset_workers=1",
    "plot=false",
]


def _start(args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-m", *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=REPO)


def _finish(procs, timeout=300):
    """{key: (returncode, stdout, stderr)} of started processes."""
    out = {}
    for key, p in procs.items():
        try:
            stdout, stderr = p.communicate(timeout=timeout)
        finally:
            p.kill()
        out[key] = (p.returncode, stdout, stderr)
    return out


def overrides(dataset, root, dump, *extra, device="cpu"):
    return [f"datasets={dataset}", *OVERRIDES, *EXTRA.get(dataset, ()),
            f"datasets.root={root}", f"dump_dir={dump}",
            *([f"device={device}"] if device else []), *extra]


def steps(ckpt_dir):
    return sorted(int(p.rsplit("_", 1)[1])
                  for p in glob.glob(os.path.join(ckpt_dir, "step_*")))


def one_dir(dump, name):
    name = "synthetic_" + name if name == "deforming_plate" else name
    dirs = glob.glob(os.path.join(dump, "ckpts", "train", name, "*"))
    assert len(dirs) == 1, dirs
    return dirs[0]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each dataset's training run; then at once, each dataset's resumed
    run (two epochs from the first run's newest step) and rollout (from
    its step 3), a run without `device` and one with a bad override."""
    root = str(tmp_path_factory.mktemp("port_cli_data"))
    generate_synthetic_dataset(root, "synthetic_airfoil", n_train=1,
                               n_test=1, n_nodes=120, n_frames=6, seed=3)
    generate_synthetic_dataset(root, "synthetic_cylinder_flow", n_train=2,
                               n_test=1, n_nodes=160, n_frames=6,
                               consistent_mesh=False, seed=4)
    generate_synthetic_tetra_dataset(root, n_train=2, n_test=1, n_nodes=200,
                                     n_frames=6, seed=2)
    dumps = {(kind, name): str(tmp_path_factory.mktemp(f"dump_{kind}"))
             for kind in ("train", "resume") for name in DATASETS}
    first = _finish({name: _start(["bsms_gnn_tpu_torch.train",
                                   *overrides(name, root,
                                              dumps["train", name])])
                     for name in DATASETS})
    out = {("train", name): first[name] for name in DATASETS}
    for name in DATASETS:
        assert first[name][0] == 0, first[name][2][-3000:]
    ckpt = {name: one_dir(dumps["train", name], name) for name in DATASETS}
    procs = {}
    for name in DATASETS:
        procs["resume", name] = _start([
            "bsms_gnn_tpu_torch.train",
            *overrides(name, root, dumps["resume", name],
                       f"restore_dir={ckpt[name]}", "epochs=2")])
        procs["rollout", name] = _start([
            "bsms_gnn_tpu_torch.rollout",
            *rollout_args(name, root, dumps["train", name], ckpt[name])])
    procs["no_device"] = _start([
        "bsms_gnn_tpu_torch.train",
        *overrides(DATASETS[0], root, dumps["train", DATASETS[0]],
                   device=None)])
    procs["bad"] = _start(["bsms_gnn_tpu_torch.train", "nonexistent.knob=1",
                           "device=cpu"])
    out.update(_finish(procs))
    return root, dumps, ckpt, out


def rollout_args(name, root, dump, ckpt_dir):
    return overrides(name, root, dump, f"restore_dir={ckpt_dir}",
                     "restore_step=3")


@pytest.mark.parametrize("name", DATASETS)
def test_train_writes_checkpoints(runs, name):
    _, _, ckpt, out = runs
    stdout = out["train", name][1]
    assert "[train] step 0: loss" in stdout and "[test] step" in stdout
    # save_freq 3 over steps_per_epoch 3: step 3, then the end (step 4).
    assert steps(ckpt[name]) == [3, 4]
    state = torch.load(os.path.join(ckpt[name], "step_4", "state.pt"),
                       weights_only=True)
    assert state["step"] == 4 and state["updates"] == 3
    assert state["adam"] and state["noise_generator"]["device"] == "cpu"


@pytest.mark.parametrize("name", DATASETS)
def test_rerun_resumes_at_the_newest_step(runs, name):
    _, dumps, ckpt, out = runs
    code, stdout, stderr = out["resume", name]
    assert code == 0, stderr[-3000:]
    assert f"restored step 4 from {ckpt[name]}" in stdout
    new_dir = one_dir(dumps["resume", name], name)
    # Two epochs of 3 steps end at step 7 (total + 1), resumed or not.
    assert steps(new_dir) == [6, 7]
    state = torch.load(os.path.join(new_dir, "step_7", "state.pt"),
                       weights_only=True)
    assert state["step"] == 7 and state["updates"] == 6


@pytest.mark.parametrize("name", DATASETS)
def test_rollout_restores_and_matches_in_process(runs, name):
    root, dumps, ckpt, out = runs
    code, stdout, stderr = out["rollout", name]
    assert code == 0, stderr[-3000:]
    assert f"restored step 3 from {ckpt[name]}" in stdout
    assert "traj 1: rollout RMSE" in stdout
    for head in ("error averaged over time and channel", "error per channel",
                 "error at steps 0, 5, 10, 50, last"):
        assert head in stdout
    printed = re.search(r"^mean (\S+)  std (\S+)$", stdout, re.M)
    got = run_rollout(load_config(rollout_args(
        name, root, dumps["train", name], ckpt[name])))
    assert printed.group(1) == f"{got['overall_mean']:.6f}"
    assert printed.group(2) == f"{got['overall_std']:.6f}"


def test_train_needs_a_device_or_cpu(runs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    code, _, stderr = runs[3]["no_device"]
    assert code != 0
    assert "no CUDA device" in stderr


def test_train_bad_override_fails_loudly(runs):
    code, stdout, stderr = runs[3]["bad"]
    assert code != 0
    assert "nonexistent" in stderr + stdout


def test_logging_and_timing_utils(capsys, tmp_path):
    """The console lines equal the JAX package's; the timers time a call
    and `plot_fields` writes a PNG (None without matplotlib)."""
    import numpy as np

    from bsms_gnn_tpu.utils import logging as jax_logging
    from bsms_gnn_tpu_torch.utils import (
        MetricLogger,
        TicToc,
        board_loss,
        print_error_table,
        simple_timeit,
        timeit,
    )
    from bsms_gnn_tpu_torch.utils.plotting import plot_fields

    mean, std = np.array([0.5, 1.25]), np.array([0.1, 0.2])
    for lg, table, module in (
            (MetricLogger(), print_error_table, board_loss),
            (jax_logging.MetricLogger(), jax_logging.print_error_table,
             jax_logging.board_loss)):
        module(lg, "train", 7, 0.25)
        table("test", 7, mean, std)
        lg.finish()
    out = capsys.readouterr().out.splitlines()
    half = len(out) // 2
    assert out[:half] == out[half:] and "[train] step 7: loss 0.250000" in out
    timer = TicToc()
    timer.tic("x")
    assert timer.toc("x") >= 0
    timer.estimate_time("x", 0.5)
    assert "[eta] 50.00% done" in capsys.readouterr().out
    assert simple_timeit(lambda: torch.ones(3), tries=3, warmup=1) >= 0
    assert torch.equal(timeit(torch.ones)(2), torch.ones(2))
    pos = np.array([[0, 0], [1, 0], [0, 1], [1, 1]], np.float64)
    fig = plot_fields(pos, np.array([[0, 1, 2], [1, 3, 2]]),
                      np.ones((4, 2)), np.zeros((4, 2)),
                      save_path=str(tmp_path / "p" / "f.png"), title="t")
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        assert fig is None
    else:
        assert (tmp_path / "p" / "f.png").stat().st_size > 0


@pytest.mark.parametrize("axis", ["data_axis", "graph_axis"])
def test_multi_device_configs_are_not_ported(axis):
    from bsms_gnn_tpu_torch.train import run_train

    with pytest.raises(NotImplementedError, match="library calls in"):
        run_train(load_config([f"parallel.{axis}=2", "device=cpu"]))
    with pytest.raises(NotImplementedError, match="library calls in"):
        run_rollout(load_config([f"parallel.{axis}=2", "device=cpu"]))
