"""Variable-mesh batches in the port: B per-sample bucketed hierarchies of
one size group as their union (`data.pipeline.stack_hierarchies`,
`graph.hierarchy.union`), one block-diagonal hierarchy of B·N_pad rows per
level, against the JAX package's stacked, vmapped path on the CPU.

The batch: `test_torch_port_buckets.py`'s group (two Morton-ordered
Delaunay meshes of 450 and 600 nodes, depth 2, window 256, edge_block 512)
plus a third sample on the 450-node mesh again with another frame; sample
s is frame 0 of the analytic flow drawn with seed s, its target frame 1.
The model is `test_torch_port_variable_mesh.py`'s (cylinder_flow cut to
depth 2, hidden 1; the JAX kernels in interpret mode).

The tables: every index of sample s's block of the union is its own table
offset by its sample's base (rows, slots, chunks, half-windows, or the
earlier samples' list lengths), the union of the device hierarchies equals
`to_device` of the union of the host ones, and no window, row list or
pool map of a sample reaches another sample's rows.

The JAX reference stacks the group's hierarchies with
`bsms_gnn_tpu.data.pipeline.stack_hierarchies`, which keeps each level's
real counts as static pytree data and so refuses two different meshes
(and, without the plan's ELL widths, their ELL tables differ in shape):
the JAX hierarchies here are built with the plan's `ell_buckets` and each
level's (and residual's) `n_nodes` / `n_edges` set to the group's largest,
in this test only (the compute path reads padded shapes alone).

Tolerances (`test_torch_port_variable_mesh.py`'s), on the rows of real
nodes, relative to the reference's largest |value|: the taps 1e-4, the
prediction 5e-4; bf16 2e-2 of the predicted delta's scale.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from test_torch_port_buckets import DEPTH, EDGE_BLOCK, WINDOW, group
from test_torch_port_train import assert_close
from test_torch_port_variable_mesh import F32_TOL, TOL, _tap_level, model

from bsms_gnn_tpu.data.pipeline import stack_hierarchies as jax_stack
from bsms_gnn_tpu.graph.bistride import build_bistride_levels as jax_levels
from bsms_gnn_tpu.graph.hierarchy import pad_levels as jax_pad_levels
from bsms_gnn_tpu.graph.mesh import to_flat_edge as jax_flat_edge
from bsms_gnn_tpu.models.normalizer import normalize as jax_normalize
from bsms_gnn_tpu.models.simulator import (
    simulator_forward,
    simulator_forward_auto,
    split_node_input,
)
from bsms_gnn_tpu.ops.bsgmp import bsgmp_apply
from bsms_gnn_tpu.ops.dense import mlp_apply
from bsms_gnn_tpu_torch.data.pipeline import stack_hierarchies
from bsms_gnn_tpu_torch.data.synthetic import (
    cylinder_mask,
    generate_trajectory,
)
from bsms_gnn_tpu_torch.graph.bistride import build_bistride_levels
from bsms_gnn_tpu_torch.graph.hierarchy import (
    NODE_BLOCK,
    build_hierarchy,
    pad_levels,
    to_device,
    union,
)
from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
from bsms_gnn_tpu_torch.models.simulator import UNION_CACHE
from bsms_gnn_tpu_torch.ops.kernels import segment_sum_accum as ssa
from bsms_gnn_tpu_torch.ops.kernels import windowed

# The mesh of each sample of the batch (sample s's frame drawn with seed s).
ORDER = (0, 1, 0)
BF16_REL = 2e-2


def jax_group_hierarchy(h, n_nodes, n_edges, r_nodes, r_edges):
    """A JAX hierarchy with each level's (and residual's) real counts set
    to the group's largest, so that JAX's `stack_hierarchies` takes it."""
    levels = []
    for l, lv in enumerate(h.levels):
        r = lv.resid
        if r is not None:
            r = dataclasses.replace(r, n_nodes=r_nodes[l], n_edges=r_edges[l])
        levels.append(dataclasses.replace(lv, n_nodes=n_nodes[l],
                                          n_edges=n_edges[l], resid=r))
    return dataclasses.replace(h, levels=tuple(levels))


def _group_max(hs, get):
    return [max(get(h.levels[l]) for h in hs) for l in range(len(hs[0].levels))]


@functools.lru_cache(maxsize=None)
def batch():
    """(JAX stacked hierarchy, port host hierarchies of the samples, the
    port's union on the CPU, the JAX hierarchy of each mesh as built,
    node_in [B, N_pad, 5], target [B, N_pad, 2], mask [B, N_pad, 1], real
    node counts), numpy arrays."""
    meshes, plan, pairs = group(WINDOW)
    jhs = []
    for i, (pos, cells, _) in enumerate(meshes):
        jl = jax_levels(jax_flat_edge(cells, "tri"), DEPTH, len(pos), pos)
        jhs.append(jax_pad_levels(jl, 128, pos=pos, edge_block=EDGE_BLOCK,
                                  window=WINDOW, **plan.for_mesh(i)))

    def resid(get):
        return lambda lv: 0 if lv.resid is None else get(lv.resid)

    maxed = [jax_group_hierarchy(
        h, _group_max(jhs, lambda lv: lv.n_nodes),
        _group_max(jhs, lambda lv: lv.n_edges),
        _group_max(jhs, resid(lambda r: r.n_nodes)),
        _group_max(jhs, resid(lambda r: r.n_edges))) for h in jhs]
    ins, tars, masks, real = [], [], [], []
    for s, i in enumerate(ORDER):
        pos, cells, node_type = meshes[i]
        fields = generate_trajectory((pos, cells, node_type), 2,
                                     np.random.default_rng(s))
        n, n_pad = len(pos), pairs[i][1].levels[0].n_pad_nodes
        node_in = np.zeros((n_pad, 5), np.float32)
        node_in[:n, :2] = fields["velocity"][0]
        node_in[:n, 2:4] = pos
        node_in[:n, 4] = node_type[:, 0]
        target = np.zeros((n_pad, 2), np.float32)
        target[:n] = fields["velocity"][1]
        mask = np.zeros((n_pad, 1), np.float32)
        mask[:n] = cylinder_mask(node_type)
        ins.append(node_in)
        tars.append(target)
        masks.append(mask)
        real.append(n)
    hosts = [pairs[i][1] for i in ORDER]
    hd = stack_hierarchies([to_device(h, "cpu") for h in hosts])
    return (jax_stack([maxed[i] for i in ORDER]), hosts, hd, jhs,
            np.stack(ins), np.stack(tars), np.stack(masks), real)


def _layouts(h):
    """(where, layout) of every level and residual sub-level."""
    out = []
    for l, lv in enumerate(h.levels):
        out.append((f"level {l}", lv))
        if lv.resid is not None:
            out.append((f"level {l} resid", lv.resid))
    return out


def _np(t):
    return t.numpy().astype(np.int64)


# -- the union's tables ---------------------------------------------------------

# Index tables and what their entries count: node rows, edge slots, 128-row
# node blocks, half-windows.
ROW_TABLES = ("senders", "receivers", "row_long", "win_long", "send_long")
SLOT_TABLES = ("reverse_perm", "row_slots", "row_send", "win_row_slots",
               "send_row_slots")
POINTERS = {"recv_indptr": "senders", "chunk_ptr": "chunk_block",
            "row_ptr": "row_slots", "win_row_ptr": "win_row_slots",
            "send_row_ptr": "send_row_slots"}


def _blocks(own, name, lists):
    """The ragged tables of each sample laid end to end (their lengths
    are each sample's own)."""
    sizes = [getattr(o, name).shape[0] for o in own]
    return np.split(_np(lists), np.cumsum(sizes)[:-1])


def test_union_tables_are_each_samples_own_offset():
    """Sample s's block of every index table of the union (the layout's,
    and `to_device`'s derived tables, at every level and residual
    sub-level) is sample s's own table plus its base: s·N_pad rows, s·E_pad
    slots, s·N_pad/128 node blocks, s·N_pad/(W/2) half-windows; each
    pointer table is its own plus the earlier samples' list lengths."""
    _, hosts, hd, *_ = batch()
    own_h = [to_device(h, "cpu") for h in hosts]
    b = len(ORDER)
    assert hd.samples == b
    checked = 0
    for k, (where, lu) in enumerate(_layouts(hd)):
        own = [_layouts(h)[k][1] for h in own_h]
        n, e = own[0].n_pad_nodes, own[0].n_pad_edges
        assert (lu.n_pad_nodes, lu.n_pad_edges) == (b * n, b * e), where
        step = {**{t: n for t in ROW_TABLES}, **{t: e for t in SLOT_TABLES},
                "chunk_block": n // NODE_BLOCK}
        if lu.window:
            step["win_base"] = n // (lu.window // 2)
        for name, s_ in step.items():
            if getattr(lu, name) is None:
                continue
            for s, (got, o) in enumerate(zip(_blocks(own, name,
                                                     getattr(lu, name)),
                                             own)):
                np.testing.assert_array_equal(
                    got, _np(getattr(o, name)) + s * s_,
                    err_msg=f"{where} {name} sample {s}")
                checked += 1
        for name, lst in POINTERS.items():
            ptr = getattr(lu, name)
            if ptr is None:
                continue
            rows = len(getattr(own[0], name)) - 1
            base = 0
            for s, o in enumerate(own):
                np.testing.assert_array_equal(
                    _np(ptr[s * rows:(s + 1) * rows]),
                    _np(getattr(o, name)[:-1]) + base,
                    err_msg=f"{where} {name} sample {s}")
                base += getattr(o, lst).shape[0]
            assert int(ptr[-1]) == base == getattr(lu, lst).shape[0]
            checked += 1
        for name in ("deg", "node_mask", "edge_mask", "ew", "ew_rev",
                     "send_win", "fiber"):
            if getattr(lu, name) is None:
                continue
            torch.testing.assert_close(
                getattr(lu, name),
                torch.cat([getattr(o, name) for o in own]), rtol=0, atol=0)
        torch.testing.assert_close(
            lu.fiber_t, torch.cat([o.fiber_t for o in own], dim=-1), rtol=0,
            atol=0)
        assert lu.n_nodes == sum(o.n_nodes for o in own)
    assert checked > 40
    assert hd.sample_nodes == tuple(
        tuple(h.levels[l].n_nodes for h in hosts)
        for l in range(len(hosts[0].levels)))


def test_union_pool_maps_and_unpool_zero_slot():
    """pool_ids adds s·N_pad of the parent, unpool_inv s·M_pad of the
    child; the dropped parents of every sample point at the union's zero
    slot B·M_pad (not s·M_pad + M_pad, a row of the next sample)."""
    _, hosts, hd, *_ = batch()
    b = len(ORDER)
    for l, t in enumerate(hd.transitions):
        n = hosts[0].levels[l].n_pad_nodes
        m = hosts[0].levels[l + 1].n_pad_nodes
        pool, unpool = _np(t.pool_ids), _np(t.unpool_inv)
        assert pool.shape == (b * m,) and unpool.shape == (b * n,)
        for s, h in enumerate(hosts):
            own = h.transitions[l]
            np.testing.assert_array_equal(pool[s * m:(s + 1) * m],
                                          own.pool_ids + s * n)
            got = unpool[s * n:(s + 1) * n]
            dropped = own.unpool_inv == m
            assert dropped.any()
            assert (got[dropped] == b * m).all()
            np.testing.assert_array_equal(got[~dropped],
                                          own.unpool_inv[~dropped] + s * m)


def test_union_derived_tables_equal_to_device_of_host_union():
    """`stack_hierarchies` of the device hierarchies equals `to_device` of
    the union of the numpy hierarchies, field for field: the derived
    tables (`row_*`, `win_row_*`, `send_row_*`, `chunk_*`, the long rows)
    computed on the union's arrays are the offset concatenation of each
    sample's."""
    _, hosts, hd, *_ = batch()
    want = to_device(union(hosts), "cpu")

    def same(a, b, path):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if dataclasses.is_dataclass(x):
                same(x, y, f"{path}.{f.name}")
            elif isinstance(x, tuple) and x and dataclasses.is_dataclass(x[0]):
                for i, (p, q) in enumerate(zip(x, y)):
                    same(p, q, f"{path}.{f.name}[{i}]")
            elif isinstance(x, torch.Tensor):
                assert x.dtype == y.dtype and torch.equal(x, y), (
                    f"{path}.{f.name}")
            else:
                assert x == y, f"{path}.{f.name}: {x} != {y}"

    same(hd, want, "union")


def test_union_keeps_every_sample_in_its_rows():
    """No table of the union reaches past its sample: every chunk's source
    window (win_base·W/2 .. + W), every slot's sender and receiver, every
    in-window sender row of kernel 7's lists and every pad slot's row lie
    in the rows of the sample whose slots they are."""
    hd = batch()[2]
    b = len(ORDER)
    for where, lv in _layouts(hd):
        n, e = lv.n_pad_nodes // b, lv.n_pad_edges // b
        slot_sample = np.arange(lv.n_pad_edges) // e
        for name in ("senders", "receivers"):
            assert (_np(getattr(lv, name)) // n == slot_sample).all(), (
                where, name)
        if lv.window:
            wh = lv.window // 2
            nc = e // lv.edge_block
            base = _np(lv.win_base)
            chunk_sample = np.arange(len(base)) // nc
            assert (base * wh // n == chunk_sample).all(), where
            assert ((base * wh + lv.window - 1) // n == chunk_sample).all(), (
                where)
            ptr, slots = _np(lv.send_row_ptr), _np(lv.send_row_slots)
            rows = np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))
            assert (rows // n == slots // e).all(), where
        ptr, slots = _np(lv.row_ptr), _np(lv.row_slots)
        rows = np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))
        assert (rows // n == slots // e).all(), where


def test_stack_refuses_other_groups_and_layouts():
    """Hierarchies of another size group, unbucketed ones (fused transition
    operators, compact residuals), numpy hierarchies in
    `stack_hierarchies`, and a batch on a union of another size."""
    meshes, plan, pairs = group(WINDOW)
    h0 = pairs[0][1]
    pos, cells, _ = meshes[0]
    lv = build_bistride_levels(to_flat_edge(cells, "tri"), DEPTH, len(pos),
                               pos)
    kw = plan.for_mesh(0)
    kw["node_buckets"] = [b + 128 for b in kw["node_buckets"]]
    kw["edge_buckets"] = None
    other = pad_levels(lv, 128, pos=pos, edge_block=EDGE_BLOCK, window=WINDOW,
                       **kw)
    with pytest.raises(ValueError, match="layouts differ"):
        stack_hierarchies([to_device(h0, "cpu"), to_device(other, "cpu")])
    flat = build_hierarchy(to_flat_edge(cells, "tri"), DEPTH, len(pos), pos,
                           edge_block=EDGE_BLOCK, window=WINDOW)
    with pytest.raises(ValueError, match="compact residual|fused operator"):
        stack_hierarchies([to_device(flat, "cpu")] * 2)
    with pytest.raises(ValueError, match="one device"):
        stack_hierarchies([h0, h0])
    with pytest.raises(ValueError, match="single hierarchies"):
        union([batch()[2], batch()[2]])
    sim = model()[3]
    ni, _, m = (torch.from_numpy(a) for a in batch()[4:7])
    with pytest.raises(ValueError, match="a batch of 2 on a union of 3"):
        sim(batch()[2], ni[:2], m[:2])


def test_batch_union_is_built_once_per_batch():
    """The simulator builds the union of b references to a shared bucketed
    hierarchy once per (hierarchy, b), keeps the UNION_CACHE most recently
    used, each entry holding its hierarchy, and drops the oldest."""
    sim = model()[3]
    sim.unions.clear()
    h = to_device(group(WINDOW)[2][1][1], "cpu")
    u2 = sim.batch_union(h, 2)
    assert sim.batch_union(h, 2) is u2 and u2.samples == 2
    assert sim.batch_union(h, 3) is not u2
    assert list(sim.unions) == [(id(h), 2), (id(h), 3)]
    assert all(k[0] == id(v[0]) for k, v in sim.unions.items())
    sim.batch_union(h, 2)  # now the most recent
    others = [to_device(group(WINDOW)[2][1][1], "cpu")
              for _ in range(UNION_CACHE - 1)]
    for g in others:
        sim.batch_union(g, 2)
    assert len(sim.unions) == UNION_CACHE
    assert (id(h), 3) not in sim.unions
    assert sim.batch_union(h, 2) is u2


# -- the forward ----------------------------------------------------------------


def test_union_forward_f32_matches_jax_with_taps():
    """The prediction and each GMP's output of the three samples (the
    taps, [B, N_pad_l, C] on the union) against JAX's stacked forward,
    vmapped over the samples (one JAX compile); kernel 9 and kernel 1's
    level form each run once per call, as at B = 1."""
    jcfg, _, state, sim = model()
    hstack, hosts, hd, _, node_in, _, mask, real = batch()

    def forward_and_taps(hh, ni, m):
        pred = simulator_forward(state.params, state.norm_in, state.norm_out,
                                 hh, ni, m, jcfg, None)
        latent, _, _ = split_node_input(ni, jcfg.pos_dim)
        x0 = mlp_apply(state.params.encode,
                       jax_normalize(state.norm_in, latent))
        taps = {}
        bsgmp_apply(state.params.process, hh, x0, None, method="fused",
                    tap=taps.__setitem__)
        return pred, taps

    want, taps_j = jax.jit(jax.vmap(forward_and_taps))(
        hstack, jnp.asarray(node_in), jnp.asarray(mask))
    np.testing.assert_allclose(
        np.asarray(jax.jit(lambda h, a, b: simulator_forward_auto(
            state.params, state.norm_in, state.norm_out, h, a, b, jcfg,
            None))(hstack, jnp.asarray(node_in), jnp.asarray(mask))),
        np.asarray(want), rtol=0, atol=0)
    taps_t = {}
    ssa.segment_sum_accum_plain.calls = 0
    windowed.windowed_conv_plain.calls = 0
    with torch.no_grad():
        got = sim(hd, torch.from_numpy(node_in), torch.from_numpy(mask),
                  tap=lambda k, v: taps_t.__setitem__(k, v))
    # B = 1's counts: the down and up GMPs' residual phases and convs of
    # level 0, the only level with a residual; 2 convs per transition.
    assert ssa.segment_sum_accum_plain.calls == 4
    assert windowed.windowed_conv_plain.calls == 2 * DEPTH
    assert got.shape == node_in[..., :2].shape
    assert sorted(taps_t) == sorted(taps_j) and len(taps_t) == 2 * DEPTH + 1
    for s, n in enumerate(real):
        np.testing.assert_allclose(got[s, :n].numpy(), np.asarray(want)[s, :n],
                                   rtol=F32_TOL, atol=F32_TOL)
        for k, v in taps_j.items():
            n_k = hd.sample_nodes[_tap_level(k)][s]
            assert taps_t[k].shape[:2] == (len(ORDER), hosts[0].levels[
                _tap_level(k)].n_pad_nodes)
            assert_close(taps_t[k][s, :n_k], np.asarray(v)[s, :n_k], TOL,
                         f"{k} sample {s}")


def test_union_forward_bf16_matches_jax():
    jcfg, _, state, sim = model()
    hstack, _, hd, _, node_in, _, mask, real = batch()
    want = np.asarray(jax.jit(lambda h, a, b: simulator_forward_auto(
        state.params, state.norm_in, state.norm_out, h, a, b, jcfg,
        jnp.bfloat16))(hstack, jnp.asarray(node_in), jnp.asarray(mask)))
    with torch.no_grad():
        got = sim(hd, torch.from_numpy(node_in), torch.from_numpy(mask),
                  torch.bfloat16).float().numpy()
    for s, n in enumerate(real):
        scale = np.abs(want[s, :n] - node_in[s, :n, :2]).max()
        assert scale > 0
        assert np.abs(got[s, :n] - want[s, :n]).max() <= BF16_REL * scale, s


def test_shared_bucketed_batch_matches_jax():
    """Three frames [3, N_pad, C] on the 600-node mesh's one bucketed
    hierarchy (the union of three references to it, built by the
    simulator) against JAX's forward of the batch on its shared
    hierarchy."""
    jcfg, _, state, sim = model()
    _, _, _, jhs, node_in, _, mask, _ = batch()
    meshes, _, pairs = group(WINDOW)
    ht = to_device(pairs[1][1], "cpu")
    n = len(meshes[1][0])
    rng = np.random.default_rng(40)
    frames = np.stack([node_in[1]] * 3)
    frames[:, :n, :2] += 0.1 * rng.standard_normal((3, n, 2)).astype(
        np.float32)
    masks = np.stack([mask[1]] * 3)
    want = np.asarray(jax.jit(lambda a, b: simulator_forward(
        state.params, state.norm_in, state.norm_out, jhs[1], a, b, jcfg,
        None))(jnp.asarray(frames), jnp.asarray(masks)))
    ssa.segment_sum_accum_plain.calls = 0
    with torch.no_grad():
        got = sim(ht, torch.from_numpy(frames), torch.from_numpy(masks))
    assert ssa.segment_sum_accum_plain.calls == 4
    assert [k[1] for k, (g, _) in sim.unions.items() if g is ht] == [3]
    for s in range(3):
        np.testing.assert_allclose(got[s, :n].numpy(), want[s, :n],
                                   rtol=F32_TOL, atol=F32_TOL)
