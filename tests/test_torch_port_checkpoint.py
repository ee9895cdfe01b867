"""Checkpoints of the port's train state (`training/checkpoint.py`,
`Trainer.state_dict`): save then restore is bit-exact for the parameters,
the normalizers, the AdamW state, the counts, MultiSteps' running mean and
the noise generator; k steps, a save, a restore into a fresh `Trainer`
and the same batches equal the uninterrupted run bit for bit, at
`gradient_accumulation_steps` 1 and 2 (saved mid-accumulation); and
`latest_step`. On the CPU, on a 300-node Delaunay mesh at depth 2 (latent
32, hidden 1) on the `ell` method."""

import os

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from bsms_gnn_tpu_torch.config import Config, ModelConfig, OptConfig
from bsms_gnn_tpu_torch.data.synthetic import make_delaunay_mesh
from bsms_gnn_tpu_torch.graph.hierarchy import build_hierarchy, to_device
from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
from bsms_gnn_tpu_torch.training.checkpoint import (
    STATE_FILE,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from bsms_gnn_tpu_torch.training.trainer import Trainer

GATE, STEPS, SAVE_AT = 1, 6, 4


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    pos, cells, node_type = make_delaunay_mesh(300, rng)
    n = len(pos)
    hd = to_device(build_hierarchy(to_flat_edge(cells, "tri"), 2, n,
                                   pos.astype(np.float64)), "cpu")
    n_pad = hd.levels[0].n_pad_nodes
    frames = []
    for _ in range(STEPS):
        node_in = np.zeros((2, n_pad, 6), np.float32)
        node_in[:, :n, :3] = rng.standard_normal((2, n, 3))
        node_in[:, :n, 3:5] = pos
        node_in[:, :n, 5] = node_type[:, 0]
        tar = node_in[..., :3] + 0.1 * rng.standard_normal(
            (2, n_pad, 3)).astype(np.float32)
        mask = np.zeros((2, n_pad, 1), np.float32)
        mask[:, :n, 0] = node_type[:, 0] == 0
        frames.append(tuple(torch.from_numpy(a) for a in (node_in, tar * mask,
                                                          mask)))
    return hd, frames


def trainer(k):
    cfg = Config(model=ModelConfig(latent_dim=32, hidden_layer=1,
                                   unet_depth=2, accumulation_steps=GATE),
                 opt=OptConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=20,
                               gradient_accumulation_steps=k))
    return Trainer(cfg, device="cpu")


def run(tr, hd, frames):
    return [float(tr.iter(hd, *f)) for f in frames]


def assert_states_equal(a, b, path="state"):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            assert_states_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, path
        assert torch.equal(a, b), path
    else:
        assert a == b and type(a) is type(b), path


@pytest.mark.parametrize("k", [1, 2])
def test_save_restore_is_bit_exact(case, tmp_path, k):
    hd, frames = case
    tr = trainer(k)
    run(tr, hd, frames[:3])
    assert tr.updates == (2 if k == 1 else 1) and tr.step == 3
    path = save_checkpoint(str(tmp_path), tr.step, tr)
    assert path == os.path.join(str(tmp_path), "step_3")
    assert os.listdir(path) == [STATE_FILE]
    fresh = trainer(k)
    restore_checkpoint(str(tmp_path), 3, fresh)
    want, got = tr.state_dict(), fresh.state_dict()
    assert_states_equal(want, got)
    assert want["adam"] and len(want["adam"]) == len(want["params"])
    assert (want["acc_grads"] is None) == (k == 1)
    for name in ("norm_in", "norm_out"):
        assert float(want[name]["num_accumulations"]) == GATE
    # The generators continue alike: the next draws are the same.
    z = [torch.randn(5, generator=t.noise_generator) for t in (tr, fresh)]
    assert torch.equal(*z)


@pytest.mark.parametrize("k", [1, 2])
def test_resumed_run_equals_uninterrupted(case, tmp_path, k):
    """SAVE_AT steps, a checkpoint (with k = 2 after an odd number of
    mini-steps: mid-accumulation), a fresh trainer restored from it and
    the same remaining batches: losses and the final state bit for bit."""
    hd, frames = case
    full = trainer(k)
    losses = run(full, hd, frames)
    part = trainer(k)
    run(part, hd, frames[:SAVE_AT])
    if k == 2:
        assert part.mini_step == 1  # saved mid-accumulation
    save_checkpoint(str(tmp_path), SAVE_AT, part)
    resumed = trainer(k)
    restore_checkpoint(str(tmp_path), latest_step(str(tmp_path)), resumed)
    rest = run(resumed, hd, frames[SAVE_AT:])
    assert rest == losses[SAVE_AT:]
    assert_states_equal(full.state_dict(), resumed.state_dict())
    assert full.updates == (STEPS - GATE) // k


def test_latest_step(tmp_path):
    d = str(tmp_path / "ckpts")
    assert latest_step(d) == -1
    os.makedirs(d)
    assert latest_step(d) == -1
    tr = trainer(1)
    for step in (3, 12, 7):
        save_checkpoint(d, step, tr)
    os.makedirs(os.path.join(d, "step_40"))  # no state file: not a checkpoint
    os.makedirs(os.path.join(d, "step_x"))
    open(os.path.join(d, "notes.txt"), "w").close()
    assert latest_step(d) == 12


def test_restore_refuses_another_generator_kind():
    tr = trainer(1)
    state = tr.state_dict()
    state["noise_generator"]["device"] = "cuda"
    with pytest.raises(ValueError, match="noise generator"):
        trainer(1).load_state_dict(state)
    state = tr.state_dict()
    state["adam"] = {"not.a.parameter": {}}
    with pytest.raises(KeyError, match="unknown parameters"):
        trainer(1).load_state_dict(state)


def test_trainer_reads_opt_and_compute_dtype_from_the_config():
    """`opt` None is `cfg.opt`; `compute_dtype` None is the config's
    ("float32": None, f32; "bfloat16": torch.bfloat16); an explicit dtype
    wins."""
    cfg = Config(model=ModelConfig(latent_dim=8, hidden_layer=1,
                                   unet_depth=1),
                 opt=OptConfig(peak_lr=3e-3, gradient_accumulation_steps=3))
    tr = Trainer(cfg, device="cpu")
    assert tr.opt_cfg is cfg.opt and tr.compute_dtype is None
    assert Trainer(cfg, OptConfig(), device="cpu").opt_cfg == OptConfig()
    cfg.model.compute_dtype = "bfloat16"
    assert Trainer(cfg, device="cpu").compute_dtype == torch.bfloat16
    assert Trainer(cfg, device="cpu",
                   compute_dtype=torch.float16).compute_dtype == torch.float16
