"""Guards of the PyTorch port: it imports nothing of JAX, flax, optax,
orbax or the JAX package, and importing it (the CLIs and the data feed
among it) loads neither PyYAML nor h5py, which the card machine lacks;
its entry points default to the CUDA card and raise without one;
a kernel wrapper given CPU tensors runs its plain version once and counts
no launch, forward and backward, on the fused path (windowed and
unwindowed, with and without world edges, and `"fused4"`), the pallas
path and the sub-window conv, and given tensors on another device raises; layouts and options the port does not
support raise NotImplementedError; world-edge streams on bucketed
hierarchies run (the explicit transitions' narrow route, v4's residual
sub-level branch); kernel 8 refuses a skip-empty layout; the native graph
module and the profiling helpers import nothing of JAX and build nothing
at import; and chip_smoke.py fails
without a card or without the package beside it, train_spread.py without
a card."""

import ast
import functools
import os
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from test_torch_port_buckets import WINDOW, group
from test_torch_port_hierarchy import scrambled_grid

from bsms_gnn_tpu_torch.config import Config, ModelConfig, OptConfig
from bsms_gnn_tpu_torch.convert import normalizer_from_numpy
from bsms_gnn_tpu_torch.graph.hierarchy import build_hierarchy, to_device
from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
from bsms_gnn_tpu_torch.models.normalizer import init_normalizer
from bsms_gnn_tpu_torch.models.simulator import Simulator
from bsms_gnn_tpu_torch.ops.kernels import (
    agg_node,
    build,
    compact_resid,
    fused_gmp,
    fused_gmp_dyn,
    fused_gmp_k,
    fused_gmp_stream,
    node_mlp,
    segment_sum,
    segment_sum_accum,
    subwin_conv,
    windowed,
)
from bsms_gnn_tpu_torch.ops.message import (
    GMP,
    cal_ew,
    edge_conv_down,
    edge_conv_up,
)
from bsms_gnn_tpu_torch.parallel import (
    HaloTrainer,
    build_partition,
    data_parallel_step,
    halo_forward,
    halo_rollout,
    halo_train_step,
    init_distributed,
    rank_hierarchy,
    shard_hierarchy,
)
from bsms_gnn_tpu_torch.training.trainer import Trainer

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "bsms_gnn_tpu_torch"
FORBIDDEN = re.compile(r"^(jax|flax|optax|orbax)(\.|$)|^bsms_gnn_tpu(?!_torch)")
# Imported only inside the functions that read or write HDF5 (and by the
# tests): the card machine has neither.
NOT_AT_IMPORT = re.compile(r"^(yaml|h5py)(\.|$)")


def _sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                          REPO / "train_spread.py",
                                          REPO / "build_times.py",
                                          REPO / "level_times.py",
                                          REPO / "bwd_plan_sweep.py",
                                          REPO / "bits_probe.py",
                                          REPO / "bf16_order.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax(path):
    bad = [m for m in _imported_modules(path) if FORBIDDEN.search(m)]
    assert not bad, f"{path} imports {bad}"


def test_import_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import bsms_gnn_tpu_torch as p, chip_smoke, train_spread\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "print(' '.join(sorted(sys.modules)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods = out.stdout.split()
    assert "bsms_gnn_tpu_torch.ops.kernels.fused_gmp" in mods
    assert not [m for m in mods if FORBIDDEN.search(m)]
    assert not [m for m in mods if NOT_AT_IMPORT.search(m)]


@pytest.mark.parametrize("module", ["bsms_gnn_tpu_torch.train",
                                    "bsms_gnn_tpu_torch.rollout",
                                    "bsms_gnn_tpu_torch.data.pipeline"])
def test_cli_imports_load_no_yaml_h5py_or_jax(module):
    code = (f"import sys, {module}\n"
            "print(' '.join(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods = out.stdout.split()
    assert module in mods
    bad = [m for m in mods if FORBIDDEN.search(m) or NOT_AT_IMPORT.search(m)]
    assert not bad, bad


@pytest.mark.parametrize("module", ["bsms_gnn_tpu_torch.graph.native",
                                    "bsms_gnn_tpu_torch.utils.profiling"])
def test_native_and_profiling_import_no_jax_and_build_nothing(module):
    """Importing the native graph module or the profiling helpers (and the
    graph package that uses the first) loads nothing of JAX or the JAX
    package and starts no process: the C++ library builds at its first
    use, not at import. Its build directory is git-ignored."""
    # numpy, scipy and torch start processes of their own at import.
    code = ("import subprocess, sys, numpy.testing, scipy.sparse, torch\n"
            "def refuse(*a, **k):\n"
            "    raise AssertionError('a process started at import')\n"
            "subprocess.run = subprocess.Popen = refuse\n"
            f"import {module}\n"
            "import bsms_gnn_tpu_torch.graph.hierarchy\n"
            "from bsms_gnn_tpu_torch.graph import native\n"
            "assert native._lib is None and not native._tried\n"
            "print(' '.join(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods = out.stdout.split()
    assert module in mods
    assert not [m for m in mods if FORBIDDEN.search(m)]
    ignored = subprocess.run(
        ["git", "check-ignore", "-q",
         "bsms_gnn_tpu_torch/graph/native/build/libbsms_graph.so"],
        cwd=REPO)
    assert ignored.returncode == 0


@pytest.fixture(scope="module")
def hier():
    pos, cells = scrambled_grid()
    return build_hierarchy(to_flat_edge(cells, "tri"), 2, len(pos), pos,
                           edge_block=128, window=128)


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")


@pytest.fixture(scope="module")
def parallel_args():
    """A two-shard plan of the scrambled grid, a CPU trainer and one
    shard's tensors: the arguments of the parallel entry points."""
    from bsms_gnn_tpu_torch.graph.bistride import build_bistride_levels

    pos, cells = scrambled_grid()
    levels = build_bistride_levels(to_flat_edge(cells, "tri"), 2, len(pos),
                                   pos)
    plan = build_partition(levels, 2, 640, pos, local_layouts=True,
                           window=128)
    cfg = Config(model=ModelConfig(unet_depth=2))
    tr = Trainer(cfg, OptConfig(), device="cpu")
    n_loc = plan.hierarchy.levels[0].n_pad_nodes
    x, t, m = torch.zeros(n_loc, 6), torch.zeros(n_loc, 3), torch.ones(n_loc, 1)
    hd = to_device(build_hierarchy(to_flat_edge(cells, "tri"), 2, len(pos),
                                   pos), "cpu")
    return dict(plan=plan, shard=to_device(shard_hierarchy(plan, 0), "cpu"),
                cfg=cfg, tr=tr, x=x, t=t, m=m, hd=hd)


@pytest.mark.parametrize("entry", ["to_device", "Simulator", "init_normalizer",
                                   "normalizer_from_numpy", "Trainer",
                                   "halo_forward", "halo_rollout",
                                   "halo_train_step", "HaloTrainer",
                                   "rank_hierarchy", "data_parallel_step",
                                   "init_distributed"])
def test_default_device_is_cuda_and_raises_without_it(hier, parallel_args,
                                                      entry):
    _no_cuda()
    a = parallel_args
    calls = {
        "to_device": lambda: to_device(hier),
        "Simulator": lambda: Simulator(ModelConfig(unet_depth=2)),
        "init_normalizer": lambda: init_normalizer(4),
        "normalizer_from_numpy": lambda: normalizer_from_numpy(dict(
            acc_weight=0.0, num_accumulations=0.0, e_x=np.zeros(3),
            e_x2=np.zeros(3), max_accumulations=5e5, unit=1e6,
            std_epsilon=1e-8)),
        "Trainer": lambda: Trainer(Config(model=ModelConfig(unet_depth=2)),
                                   OptConfig()),
        "halo_forward": lambda: halo_forward(a["tr"].sim, a["shard"], a["x"],
                                             a["m"]),
        "halo_rollout": lambda: halo_rollout(a["tr"].sim, a["shard"], a["x"],
                                             a["m"], 2),
        "halo_train_step": lambda: halo_train_step(
            a["tr"], a["shard"], a["x"], a["t"], a["m"]),
        "HaloTrainer": lambda: HaloTrainer(a["cfg"], a["plan"]),
        "rank_hierarchy": lambda: rank_hierarchy(a["plan"]),
        "data_parallel_step": lambda: data_parallel_step(
            a["tr"], a["hd"], a["x"], a["t"], a["m"]),
        "init_distributed": lambda: init_distributed(
            "gloo", init_method="tcp://localhost:1"),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_nccl_needs_a_card_per_rank():
    """NCCL takes one card per rank: fewer cards than ranks raises before
    any process group starts (two ranks on one card run over gloo)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="a card per rank"):
        init_distributed("nccl", 0, n + 1, init_method="tcp://localhost:1")
    with pytest.raises(ValueError, match="backend"):
        init_distributed("mpi", init_method="tcp://localhost:1")


KERNELS = (fused_gmp.fused_edge_phase_win_fwd, node_mlp.fused_node_phase_fwd,
           windowed.windowed_rect_conv, compact_resid.compact_accum_raw,
           fused_gmp.fused_edge_phase_win_bwd, node_mlp.fused_node_phase_bwd,
           windowed.windowed_send_sum, segment_sum.segment_sum_raw,
           agg_node.fused_aggregate_node_phase_fwd,
           fused_gmp_dyn.fused_edge_phase_win_dyn_fwd,
           fused_gmp_dyn.fused_edge_phase_win_dyn_bwd,
           fused_gmp_stream.fused_edge_phase_fwd,
           fused_gmp_stream.fused_edge_phase_bwd,
           fused_gmp_stream.fused_edge_mlp_aggregate_fwd,
           fused_gmp_stream.fused_edge_mlp_aggregate_bwd,
           windowed.windowed_conv, segment_sum_accum.segment_sum_accum_raw,
           fused_gmp_k.fused_edge_phase_win_k_fwd,
           fused_gmp_k.fused_edge_phase_win_k_bwd, subwin_conv.subwin_conv)
PLAIN_FORWARDS = (fused_gmp.fused_edge_phase_win_plain,
                  node_mlp.fused_node_phase_plain,
                  windowed.windowed_rect_conv_plain,
                  compact_resid.compact_accum_plain,
                  segment_sum.segment_sum_plain,
                  agg_node.fused_aggregate_node_phase_plain,
                  fused_gmp_dyn.fused_edge_phase_win_dyn_plain,
                  fused_gmp_stream.fused_edge_phase_plain,
                  fused_gmp_stream.fused_edge_mlp_aggregate_plain,
                  windowed.windowed_conv_plain,
                  segment_sum_accum.segment_sum_accum_plain,
                  fused_gmp_k.fused_edge_phase_win_k_plain,
                  subwin_conv.subwin_conv_plain)
PLAIN_BACKWARDS = (fused_gmp.fused_edge_phase_win_bwd_plain,
                   node_mlp.fused_node_phase_bwd_plain,
                   windowed.windowed_send_sum_plain,
                   fused_gmp_dyn.fused_edge_phase_win_dyn_bwd_plain,
                   fused_gmp_stream.fused_edge_phase_bwd_plain,
                   fused_gmp_stream.fused_edge_mlp_aggregate_bwd_plain,
                   fused_gmp_k.fused_edge_phase_win_k_bwd_plain)


@pytest.fixture(scope="module")
def flat():
    """The same grid, unwindowed (the pallas method's layout)."""
    pos, cells = scrambled_grid()
    return to_device(build_hierarchy(to_flat_edge(cells, "tri"), 2, len(pos),
                                     pos), "cpu")


@pytest.fixture(scope="module")
def bucketed():
    """The variable-mesh group's 450-node mesh, bucketed and windowed
    (residual sub-level at level 0, no TransOp), on the CPU."""
    return to_device(group(WINDOW)[2][0][1], "cpu")


@pytest.fixture
def counters():
    def reset():
        for f in KERNELS:
            f.launches = 0
        for f in PLAIN_FORWARDS + PLAIN_BACKWARDS:
            f.calls = 0
    reset()
    yield KERNELS
    reset()


def test_cpu_tensors_take_the_plain_versions(hier, flat, bucketed, counters):
    """Each wrapper, given CPU tensors, calls its plain version once and
    launches nothing. Its result is held to a direct call of the plain
    version at 1e-6: both run the same ops, but the CPU BLAS may split a
    matmul over another number of threads from one call to the next (it
    does under load), which moves the last bits."""
    hd = to_device(hier, "cpu")
    g = torch.Generator().manual_seed(1)
    lvl, op, flvl = hd.levels[0], hd.transitions[0].down_op, flat.levels[0]
    n, nf = lvl.n_pad_nodes, flvl.n_pad_nodes
    x = torch.randn(n, 128, generator=g)
    xf = torch.randn(nf, 128, generator=g)
    feat = torch.randn(flvl.n_pad_edges, 128, generator=g)
    ef = torch.randn(flvl.n_pad_edges, 128, generator=g)
    cr = lvl.cresid
    vals = torch.randn(cr.n_rows, 128, generator=g)
    gmp = GMP(128, 1, 2, torch.Generator().manual_seed(0))
    ws, bs = list(gmp.mlp_edge.weights)[1:], list(gmp.mlp_edge.biases)[1:]
    wf8 = torch.randn(8, 128, generator=g)
    pos = torch.randn(n, 3, generator=g)
    wfd, wfn = torch.randn(3, 128, generator=g), torch.randn(128, generator=g)
    send = dict(send=True)
    blvl = bucketed.levels[0]
    xb = torch.randn(blvl.n_pad_nodes, 128, generator=g)
    rfeat = torch.randn(blvl.resid.n_pad_edges, 128, generator=g)
    sub_base, send_sub, _ = (torch.from_numpy(a) for a in
                             subwin_conv.build_sub_tables(lvl))
    ew = torch.randn(lvl.n_pad_edges, generator=g)
    cases = [  # (wrapper, its plain version, a fresh copy of the arguments,
        #         keyword arguments)
        (fused_gmp.fused_edge_phase_win, fused_gmp.fused_edge_phase_win_plain,
         lambda: (lvl, x, x, wf8, ws, bs), {}),
        (node_mlp.fused_node_phase, node_mlp.fused_node_phase_plain,
         lambda: (x, x, gmp.mlp_node), {}),
        (windowed.windowed_rect_conv, windowed.windowed_rect_conv_plain,
         lambda: (op, x[:op.n_in_pad]), {}),
        (compact_resid.compact_accum, compact_resid.compact_accum_plain,
         lambda: (cr, vals, x.clone()), {}),
        (segment_sum.segment_sum_raw, segment_sum.segment_sum_plain,
         lambda: (flvl, feat), {}),
        (segment_sum.segment_sum_raw, segment_sum.segment_sum_plain,
         lambda: (flvl, feat), send),
        (agg_node.fused_aggregate_node_phase,
         agg_node.fused_aggregate_node_phase_plain,
         lambda: (flvl, feat, xf, gmp.mlp_node), {}),
        (fused_gmp_dyn.fused_edge_phase_win_dyn,
         fused_gmp_dyn.fused_edge_phase_win_dyn_plain,
         lambda: (lvl, x, x, pos, wf8, wfd, wfn, ws, bs), {}),
        (fused_gmp_stream.fused_edge_phase,
         fused_gmp_stream.fused_edge_phase_plain,
         lambda: (flvl, ef, xf, ws, bs), {}),
        (fused_gmp_stream.fused_edge_mlp_aggregate,
         fused_gmp_stream.fused_edge_mlp_aggregate_plain,
         lambda: (flvl, ef, ws, bs), {}),
        (windowed.windowed_conv, windowed.windowed_conv_plain,
         lambda: (blvl, xb, blvl.ew_rev), {}),
        (segment_sum_accum.segment_sum_accum_raw,
         segment_sum_accum.segment_sum_accum_plain,
         lambda: (blvl.resid, rfeat, xb), {}),
        (segment_sum_accum.segment_sum_accum_raw,
         segment_sum_accum.segment_sum_accum_plain,
         lambda: (blvl.resid, rfeat, xb), send),
        (functools.partial(fused_gmp_k.fused_edge_phase_win_k,
                           min_density=0),
         fused_gmp_k.fused_edge_phase_win_k_plain,
         lambda: (lvl, x, x, wf8, ws, bs, 4), {}),
        (subwin_conv.subwin_conv, subwin_conv.subwin_conv_plain,
         lambda: (lvl, x, ew, sub_base, send_sub), {}),
    ]
    with torch.no_grad():
        for wrapper, plain, args, kw in cases:
            for f in PLAIN_FORWARDS:
                f.calls = 0
            got = wrapper(*args(), **kw)
            assert plain.calls == 1, wrapper
            torch.testing.assert_close(got, plain(*args(), **kw), rtol=1e-6,
                                       atol=1e-6)
        for method in ("fused", "fused4"):
            sim = Simulator(ModelConfig(unet_depth=2, hidden_layer=1,
                                        aggregation=method),
                            torch.Generator().manual_seed(0), device="cpu")
            sim(hd, torch.randn(n, 6, generator=g), torch.ones(n, 1))
        cfg = ModelConfig(unet_depth=2, hidden_layer=1, pos_dim=2,
                          world_edges=True, aggregation="pallas")
        sim = Simulator(cfg, torch.Generator().manual_seed(0), device="cpu")
        sim(flat, torch.randn(nf, 6, generator=g), torch.ones(nf, 1))
        cfg = ModelConfig(unet_depth=2, hidden_layer=1, pos_dim=2,
                          world_edges=True, world_dim=3, aggregation="fused")
        sim = Simulator(cfg, torch.Generator().manual_seed(0), device="cpu")
        sim(hd, torch.randn(n, 6, generator=g), torch.ones(n, 1))
        # The fused method on the unwindowed hierarchy: kernel 12's route,
        # then with world edges kernel 11's.
        for world in (False, True):
            cfg = ModelConfig(unet_depth=2, hidden_layer=1, pos_dim=2,
                              world_edges=world, world_dim=3 if world else 0,
                              aggregation="fused")
            sim = Simulator(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
            sim(flat, torch.randn(nf, 6, generator=g), torch.ones(nf, 1))
        # The explicit transitions and the residual sub-level of a bucketed
        # hierarchy: kernel 1's level form and kernel 9's routes.
        sim = Simulator(ModelConfig(unet_depth=2, hidden_layer=1, out_dim=2,
                                    aggregation="fused"),
                        torch.Generator().manual_seed(0), device="cpu")
        nb = blvl.n_pad_nodes
        sim(bucketed, torch.randn(nb, 5, generator=g), torch.ones(nb, 1))
    assert [f.launches for f in counters] == [0] * len(KERNELS)


def test_cpu_backward_takes_the_plain_versions(hier, counters):
    """Under autograd on the CPU, one GMP's backward runs the plain
    versions of kernels 5, 6 and 7 once each and launches no kernel; every
    parameter gets a finite gradient."""
    hd = to_device(hier, "cpu")
    gmp = GMP(128, 1, 2, torch.Generator().manual_seed(0))
    n = hd.levels[0].n_pad_nodes
    x = torch.randn(n, 128, generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    gmp(hd.levels[0], x).square().sum().backward()
    assert [f.calls for f in PLAIN_BACKWARDS] == [1, 1, 1, 0, 0, 0, 0]
    assert [f.launches for f in counters] == [0] * len(KERNELS)
    assert x.grad is not None and torch.isfinite(x.grad).all()
    for name, p in gmp.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


def test_cpu_backward_of_the_world_edge_fused_gmp_takes_the_plain_versions(
        hier, counters):
    """A world-edge GMP on the fused method, on the CPU: its forward runs
    kernel 13's plain version once, its backward kernel 13's backward, 7's
    and 6's plain versions once each (and kernel 5's not at all), and
    nothing launches. The world positions carry no gradient."""
    hd = to_device(hier, "cpu")
    gmp = GMP(128, 1, 2, torch.Generator().manual_seed(0), fiber_dims=(3, 2))
    lvl = hd.levels[0]
    g = torch.Generator().manual_seed(1)
    x = torch.randn(lvl.n_pad_nodes, 128, generator=g, requires_grad=True)
    pos = torch.randn(lvl.n_pad_nodes, 3, generator=g, requires_grad=True)
    out = gmp(lvl, x, pos=pos, method="fused")
    assert fused_gmp_dyn.fused_edge_phase_win_dyn_plain.calls == 1
    out.square().sum().backward()
    assert [f.calls for f in PLAIN_BACKWARDS] == [0, 1, 1, 1, 0, 0, 0]
    assert [f.launches for f in counters] == [0] * len(KERNELS)
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert pos.grad is None
    for name, p in gmp.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


def test_cpu_backward_of_the_pallas_gmp_takes_the_plain_versions(flat,
                                                                  counters):
    """A world-edge GMP on the pallas method, on the CPU: its backward runs
    kernel 10's (the aggregate again through kernel 8's plain version, then
    kernel 6's) and the two gathers' (kernel 8's, sender and receiver
    forms), and launches nothing. The world positions carry no gradient."""
    gmp = GMP(128, 1, 2, torch.Generator().manual_seed(0), fiber_dims=(3, 2))
    lvl = flat.levels[0]
    g = torch.Generator().manual_seed(1)
    x = torch.randn(lvl.n_pad_nodes, 128, generator=g, requires_grad=True)
    pos = torch.randn(lvl.n_pad_nodes, 3, generator=g)
    out = gmp(lvl, x, pos=pos, method="pallas")
    segment_sum.segment_sum_plain.calls = 0
    out.square().sum().backward()
    assert node_mlp.fused_node_phase_bwd_plain.calls == 1
    assert segment_sum.segment_sum_plain.calls == 3
    assert [f.launches for f in counters] == [0] * len(KERNELS)
    assert x.grad is not None and torch.isfinite(x.grad).all()
    for name, p in gmp.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


@pytest.mark.parametrize("world", [False, True])
def test_cpu_backward_of_the_unwindowed_fused_gmp_takes_the_plain_versions(
        flat, counters, world):
    """A GMP on the fused method on an unwindowed level, on the CPU: its
    forward runs kernel 12's plain version once (kernel 11's with world
    edges), its backward that kernel's backward's and kernel 6's once each,
    and kernel 8's for the gathers' backwards (the sender gather; with world
    edges the receiver gather too), and nothing launches."""
    gmp = GMP(128, 1, 2, torch.Generator().manual_seed(0),
              fiber_dims=(3, 2) if world else None)
    lvl = flat.levels[0]
    g = torch.Generator().manual_seed(1)
    x = torch.randn(lvl.n_pad_nodes, 128, generator=g, requires_grad=True)
    pos = torch.randn(lvl.n_pad_nodes, 3, generator=g) if world else None
    out = gmp(lvl, x, pos=pos, method="fused")
    fwd = (fused_gmp_stream.fused_edge_mlp_aggregate_plain if world
           else fused_gmp_stream.fused_edge_phase_plain)
    assert fwd.calls == 1
    segment_sum.segment_sum_plain.calls = 0
    out.square().sum().backward()
    assert [f.calls for f in PLAIN_BACKWARDS] == (
        [0, 1, 0, 0, 0, 1, 0] if world else [0, 1, 0, 0, 1, 0, 0])
    assert segment_sum.segment_sum_plain.calls == (2 if world else 1)
    assert [f.launches for f in counters] == [0] * len(KERNELS)
    assert x.grad is not None and torch.isfinite(x.grad).all()
    for name, p in gmp.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


@pytest.mark.parametrize("name", ["fused_edge_phase_fwd",
                                  "fused_edge_phase_bwd",
                                  "fused_edge_mlp_aggregate_fwd",
                                  "fused_edge_mlp_aggregate_bwd"])
def test_stream_kernel_wrappers_raise_on_another_device(flat, name):
    """Kernels 11 and 12's wrappers take the plain version on the CPU,
    launch on CUDA and raise on any other device (here `meta`)."""
    lvl = flat.levels[0]
    gmp = GMP(128, 1, 2, torch.Generator().manual_seed(0))
    ws, bs = list(gmp.mlp_edge.weights)[1:], list(gmp.mlp_edge.biases)[1:]
    meta = dict(device="meta")
    rows = [torch.empty(lvl.n_pad_edges, 128, **meta)]
    if name.startswith("fused_edge_phase"):
        rows.append(torch.empty(lvl.n_pad_nodes, 128, **meta))
    extra = ([torch.empty(lvl.n_pad_nodes, 128, **meta)]
             if name.endswith("bwd") else [])
    with torch.no_grad(), pytest.raises(RuntimeError,
                                        match="no kernel for device meta"):
        getattr(fused_gmp_stream, name)(lvl, *rows, ws, bs, *extra)


def test_kernel8_refuses_a_skip_empty_layout(bucketed):
    """Kernel 8 leaves a block that owns no chunk without rows: JAX's
    `_supported` refuses skip-empty layouts, and so does the port, on the
    CPU as on the card; kernel 9 sums them."""
    r = bucketed.levels[0].resid
    assert r.skip_empty
    feat = torch.randn(r.n_pad_edges, 128)
    for send in (False, True):
        with pytest.raises(ValueError, match="skip-empty"):
            segment_sum.segment_sum_raw(r, feat, send=send)
    with pytest.raises(ValueError, match="skip-empty"):
        segment_sum.segment_sum(r, feat)
    zeros = torch.zeros(r.n_pad_nodes, 128)
    assert segment_sum_accum.segment_sum_accum_raw(r, feat, zeros).shape == (
        r.n_pad_nodes, 128)


def test_world_edges_on_bucketed_hierarchies_raise(bucketed):
    """World-edge streams on a bucketed hierarchy: the explicit conv + pool
    transitions take the narrow stream through the conv's generic form
    (the `ell` scatter ops, as JAX's ELL path does) on every method, and
    v4's residual sub-level branch (a windowed level with a residual
    sub-level and no compact tables), which raised before it was ported,
    now runs: the fused GMP computes the generic `ell` route's function on
    the real rows (`test_torch_port_contact_resid.py` holds it against
    JAX)."""
    lvl = bucketed.levels[0]
    assert lvl.resid is not None and lvl.cresid is None
    n = lvl.n_pad_nodes
    cfg = ModelConfig(unet_depth=2, hidden_layer=1, pos_dim=2,
                      world_edges=True, world_dim=3, aggregation="fused")
    sim = Simulator(cfg, torch.Generator().manual_seed(0), device="cpu")
    gmp = GMP(128, 1, 2, torch.Generator().manual_seed(0), fiber_dims=(3, 2))
    g = torch.Generator().manual_seed(3)
    pos = torch.randn(n, 3, generator=g) * lvl.node_mask
    with torch.no_grad():
        out = sim.process(bucketed, torch.randn(n, 128, generator=g) * 0.1,
                          pos=pos, method="pallas")
        assert out.shape == (n, 128) and bool(torch.isfinite(out).all())
        x = torch.randn(n, 128, generator=g)
        got = gmp(lvl, x, pos=pos, method="fused")
        want = gmp(lvl, x, pos=pos, method="ell")
        real = lvl.n_nodes
        torch.testing.assert_close(got[:real], want[:real], rtol=1e-5,
                                   atol=1e-5)
        for method in ("fused", "pallas"):
            torch.testing.assert_close(
                edge_conv_down(lvl, pos, method=method),
                edge_conv_down(lvl, pos, method="ell"), rtol=0, atol=0)


def _kernel_entry_points():
    """(module, name) of every function of the kernel modules that the
    ops modules call (the wrappers and helpers they import)."""
    from bsms_gnn_tpu_torch.ops import bsgmp, message, pool, scatter
    from bsms_gnn_tpu_torch.ops import transition

    return [(mod, name) for mod in (bsgmp, message, pool, scatter, transition)
            for name, f in vars(mod).items()
            if callable(f) and getattr(f, "__module__", "").startswith(
                "bsms_gnn_tpu_torch.ops.kernels")]


@pytest.mark.parametrize("method", ["ell", "segment"])
def test_ell_and_segment_call_no_kernel_wrapper(hier, bucketed, monkeypatch,
                                                method):
    """With every kernel entry point of the ops modules patched to raise,
    the `ell` and `segment` methods still run the simulator forward and
    backward on a windowed hierarchy (one frame and a batch of two), an
    unwindowed one with world edges, a bucketed one with residual
    sub-levels (a frame, and a batch on its union), and the explicit convs
    and `cal_ew` on narrow rows: JAX keeps these methods on XLA."""
    entries = _kernel_entry_points()
    assert len(entries) >= 15

    def refuse(*args, **kwargs):
        raise AssertionError("a kernel entry point ran")

    for mod, name in entries:
        monkeypatch.setattr(mod, name, refuse)
    pos, cells = scrambled_grid()
    flat = to_device(build_hierarchy(to_flat_edge(cells, "tri"), 2,
                                     len(pos), pos), "cpu")
    hd = to_device(hier, "cpu")
    g = torch.Generator().manual_seed(0)
    cases = [
        (hd, ModelConfig(unet_depth=2, hidden_layer=1,
                         aggregation=method), 6, (None, 2)),
        (flat, ModelConfig(unet_depth=2, hidden_layer=1, world_edges=True,
                           world_dim=3, aggregation=method), 6, (None,)),
        (bucketed, ModelConfig(unet_depth=2, hidden_layer=1, out_dim=2,
                               aggregation=method), 5, (None, 2)),
    ]
    for h, cfg, width, batches in cases:
        sim = Simulator(cfg, torch.Generator().manual_seed(0), device="cpu")
        n = h.levels[0].n_pad_nodes
        for b in batches:
            lead = () if b is None else (b,)
            out = sim(h, torch.randn(*lead, n, width, generator=g),
                      torch.ones(*lead, n, 1))
            out.square().mean().backward()
            assert all(p.grad is not None and bool(torch.isfinite(p.grad)
                                                   .all())
                       for p in sim.parameters())
            sim.zero_grad(set_to_none=True)
    lvl = bucketed.levels[0]
    x = torch.randn(lvl.n_pad_nodes, 3, generator=g, requires_grad=True)
    edge_conv_up(lvl, edge_conv_down(lvl, x, method=method),
                 method=method).sum().backward()
    cal_ew(lvl, torch.rand(lvl.n_pad_nodes, 1, generator=g), method)


def test_model_config_defaults_equal_jax():
    """The port's `ModelConfig` has the JAX package's fields, each with
    JAX's default (the aggregation `ell` among them)."""
    import dataclasses

    from bsms_gnn_tpu.config import ModelConfig as JaxModelConfig

    port = {f.name: getattr(ModelConfig(), f.name)
            for f in dataclasses.fields(ModelConfig)}
    jax_ = {f.name: getattr(JaxModelConfig(), f.name)
            for f in dataclasses.fields(JaxModelConfig)}
    assert set(jax_) == set(port)
    for name, value in port.items():
        assert value == jax_[name], name
    assert port["aggregation"] == "ell"


@pytest.mark.parametrize("name", ["windowed_conv", "segment_sum_accum_raw"])
def test_new_kernel_wrappers_raise_on_another_device(bucketed, name):
    """Kernel 1's level form and kernel 9 take the plain version on the
    CPU, launch on CUDA and raise on any other device (here `meta`)."""
    lvl = bucketed.levels[0]
    meta = dict(device="meta")
    x = torch.empty(lvl.n_pad_nodes, 128, **meta)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        if name == "windowed_conv":
            windowed.windowed_conv(lvl, x, lvl.ew)
        else:
            segment_sum_accum.segment_sum_accum_raw(
                lvl.resid, torch.empty(lvl.resid.n_pad_edges, 128, **meta), x)


def test_unsupported_layouts_raise(hier):
    pos, cells = scrambled_grid()
    h_flat = to_device(build_hierarchy(to_flat_edge(cells, "tri"), 2,
                                       len(pos), pos), "cpu")
    hd = to_device(hier, "cpu")
    gmp = GMP(128, 1, 2, torch.Generator().manual_seed(0))
    n = hd.levels[0].n_pad_nodes
    with torch.no_grad():
        with pytest.raises(NotImplementedError, match="aggregation method"):
            gmp(h_flat.levels[0], torch.zeros(h_flat.levels[0].n_pad_nodes,
                                              128), method="csr")
        with pytest.raises(NotImplementedError, match="aggregation method"):
            edge_conv_down(h_flat.levels[0],
                           torch.zeros(h_flat.levels[0].n_pad_nodes, 3),
                           method="csr")
        for method in ("ell", "segment"):
            assert gmp(h_flat.levels[0], torch.zeros(
                2, h_flat.levels[0].n_pad_nodes, 128),
                method=method).shape == (2, h_flat.levels[0].n_pad_nodes, 128)
        # A batch runs the windowed fused route (v3), the pallas method and
        # fused on an unwindowed level (v2), and the explicit conv's kernel
        # route (kernel 1's level form and kernel 2 batched) and its ell
        # and segment forms.
        assert gmp(hd.levels[0], torch.zeros(2, n, 128)).shape == (2, n, 128)
        assert gmp(hd.levels[0], torch.zeros(2, n, 128),
                   method="pallas").shape == (2, n, 128)
        nf = h_flat.levels[0].n_pad_nodes
        assert gmp(h_flat.levels[0], torch.zeros(2, nf, 128)).shape == (
            2, nf, 128)
        assert edge_conv_down(hd.levels[0], torch.zeros(2, n, 128)).shape == (
            2, n, 128)
        for method in ("ell", "segment"):
            assert edge_conv_down(hd.levels[0], torch.zeros(2, n, 128),
                                  method=method).shape == (2, n, 128)
        with pytest.raises(NotImplementedError, match="latent width"):
            GMP(64, 1, 2)(hd.levels[0], torch.zeros(n, 64))
        with pytest.raises(NotImplementedError, match="windowed"):
            windowed.windowed_rect_conv(h_flat.transitions[0].down_op,
                                        torch.zeros(n, 128))


def test_stacked_weights_are_reused_until_they_change():
    g = torch.Generator().manual_seed(0)
    ws = [torch.nn.Parameter(torch.randn(4, 4, generator=g)) for _ in range(3)]
    first = build.stacked(ws)
    assert build.stacked(ws) is first
    torch.testing.assert_close(first, torch.stack(ws).detach(), rtol=0, atol=0)
    with torch.no_grad():
        ws[1].add_(1.0)
    again = build.stacked(ws)
    assert again is not first
    torch.testing.assert_close(again, torch.stack(ws).detach(), rtol=0, atol=0)
    assert build.stacked(ws[:2]) is not again


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_card_or_package(tmp_path, alone):
    _no_cuda()
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_train_spread_fails_without_card():
    _no_cuda()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(REPO / "train_spread.py")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
