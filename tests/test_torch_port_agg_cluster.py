"""Kernels 8 and 10 on the row-ordered gather's order of sums, on the CPU,
where the CUDA kernels cannot run (`csrc/segment_sum.cu`,
`csrc/agg_node.cu`, `csrc/row_gather.cuh`).

- (a) Kernel 8's order: each list of up to GATHER_PIECE = 32 slots summed
  in list order; a longer one cut into pieces of 32, piece j summed from
  zero into share j mod 8 (the warp of the list's block that walks it),
  each share's pieces added in turn, the shares added in share order. A
  sum driven by the layout's tables alone (`row_ptr`, `row_slots`,
  `row_send`, `row_long`) in that order, in both forms, against the plain
  version and JAX's `segment_sum_raw` / `segment_sum_send_pallas`
  (interpret mode), exactly: the rows are drawn on
  test_torch_port_row_gather.py's `grid_normal` grid, where every f32 sum
  is exact in any order, so a row listed twice, missed or added at the
  wrong output shows. Some lists are long, and `row_long` (of `row_ptr`)
  lists the sender form's long rows too: the sender lists are the receiver
  lists' reverse edges, one for one.
- (b) Kernel 10's split of a tile: on the one-block tile (64 or 16 rows,
  8 warps) warp w sums rows w, w + 8, ...; on the cluster (16 rows, CTA q
  of CLUSTER summing rows [4q, 4q + 4)) each of a CTA's 4 warps one row;
  each warp a row at a time, a long one in its eight shares in turn.
  Every row is summed by exactly one warp of one CTA, and every position
  of a long list once, in its share, at every level and on every tile
  the kernel takes (`agg_node.TILES`); the rule (`tile_design`) picks one
  of them.
- (c) A model of kernel 10 in that order: the aggregate summed as (a) sums
  it, then kernel 3's cluster order of the node phase
  (test_torch_port_node_fwd_split.py's `emulate`), against JAX's
  `fused_aggregate_node_phase` (interpret mode) at
  test_torch_port_pallas.py's tolerances (f32 1e-4, bf16 2e-2 of the
  largest |value|), in f32 and bf16, on N(0, 1) rows.

Layouts: a 2,000-node `make_sphere_mesh` at depth 4 (levels 3-4 hold rows
of 24-36 slots on average, up to 76; 96 of level 4's 128 rows are long)
and test_torch_port_pallas.py's 600-node sphere at depth 3; at most
levels and operators the last block's pad slots make row n_pad − 1 long.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (the worker's share of the cores)

from test_torch_port_node_fwd_split import emulate
from test_torch_port_row_gather import grid_normal

from bsms_gnn_tpu.data.synthetic import make_sphere_mesh as jax_sphere
from bsms_gnn_tpu.graph.hierarchy import build_hierarchy as jax_build
from bsms_gnn_tpu.graph.mesh import to_flat_edge as jax_flat_edge
from bsms_gnn_tpu.ops.dense import MLPParams
from bsms_gnn_tpu.ops.pallas.agg_node import (
    fused_aggregate_node_phase as jax_agg_node,
)
from bsms_gnn_tpu.ops.pallas.segment_sum import (
    segment_sum_raw as jax_segment_sum,
)
from bsms_gnn_tpu.ops.pallas.segment_sum import segment_sum_send_pallas
from bsms_gnn_tpu_torch.data.synthetic import make_sphere_mesh
from bsms_gnn_tpu_torch.graph.hierarchy import (
    GATHER_PIECE,
    build_hierarchy,
    long_rows,
    to_device,
)
from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
from bsms_gnn_tpu_torch.ops.kernels import agg_node
from bsms_gnn_tpu_torch.ops.kernels import node_mlp as node_mlp_k
from bsms_gnn_tpu_torch.ops.kernels.segment_sum import segment_sum_plain

C = 128
SHARES = 8  # warps of the gather's long-list block (`row_gather.cuh`)
CTA_WARPS = 4  # warps of a cluster's CTA (`node_cluster_fwd.cuh`'s NT3)
BLOCK_WARPS = 8  # warps of a one-block tile's block (`common.cuh`'s THREADS)
KERNEL_TOL = {"f32": 1e-4, "bf16": 2e-2}  # test_torch_port_pallas.py's
SPHERES = {"sphere 2k": (2000, 4), "sphere 600": (600, 3)}
# (sphere, layout): levels by index, T<i> <down|up> a transition's operator
# (its row tables; the 16k surface runs kernel 8 on T0-T2's).
LAYOUTS = [("sphere 2k", "L0"), ("sphere 2k", "L3"), ("sphere 2k", "L4"),
           ("sphere 2k", "T1 down"), ("sphere 600", "L0"),
           ("sphere 600", "T0 up")]
# Kernel 8's forms on each layout (the sender form on levels only), in f32;
# bf16 rows (which widen exactly) on the 2k sphere's level 4 and the 600
# sphere's T0 up.
FORMS = [(s, w, f, "f32") for s, w in LAYOUTS for f in ("recv", "send")
         if f == "recv" or w.startswith("L")]
FORMS += [("sphere 2k", "L4", "recv", "bf16"), ("sphere 2k", "L4", "send",
                                                "bf16"),
          ("sphere 600", "T0 up", "recv", "bf16")]


@pytest.fixture(scope="module")
def spheres():
    """name → (JAX hierarchy, port hierarchy on the CPU), both built from
    the same mesh (the default unwindowed layout, edge_block 128)."""
    out = {}
    for name, (n_nodes, depth) in SPHERES.items():
        pos, cells, _ = make_sphere_mesh(n_nodes, np.random.default_rng(0))
        np.testing.assert_array_equal(
            jax_sphere(n_nodes, np.random.default_rng(0))[1], cells)
        n, pos64 = len(pos), pos.astype(np.float64)
        hj = jax_build(jax_flat_edge(cells, "tri"), depth, n, pos64)
        ht = to_device(build_hierarchy(to_flat_edge(cells, "tri"), depth, n,
                                       pos64), "cpu")
        out[name] = hj, ht
    return out


def layout(spheres, sphere, where):
    """(JAX layout, port layout)."""
    hj, ht = spheres[sphere]
    if where.startswith("L"):
        return hj.levels[int(where[1:])], ht.levels[int(where[1:])]
    t, which = where.split()
    i = int(t[1:])
    return (getattr(hj.transitions[i], f"{which}_op"),
            getattr(ht.transitions[i], f"{which}_op"))


def gather_order_sum(ptr, slots, feat):
    """f32 [n, C]: list r (positions ptr[r] .. ptr[r+1], feat rows
    slots[i]) summed in kernel 8's order, every add an f32 add of the same
    operands as on the card: a short list from zero in list order; a long
    one's pieces each from zero in list order, share v the sum of its
    pieces v, v + 8, ... in turn (from zero), the list the sum of shares 0
    .. 7 in turn (from share 0)."""
    ptr = np.asarray(ptr, np.int64)
    v = feat.float()[torch.as_tensor(np.asarray(slots), dtype=torch.long)]
    n, length = len(ptr) - 1, np.diff(ptr)
    out = torch.zeros(n, feat.shape[-1])
    short = np.flatnonzero(length <= GATHER_PIECE)
    for i in range(GATHER_PIECE):
        rows = short[length[short] > i]
        out[rows] += v[ptr[rows] + i]
    long = np.flatnonzero(length > GATHER_PIECE)
    starts = [np.arange(ptr[r], ptr[r + 1], GATHER_PIECE) for r in long]
    if not long.size:
        return out
    p_row = np.repeat(np.arange(len(long)), [len(s) for s in starts])
    p_start = np.concatenate(starts)
    p_end = np.minimum(p_start + GATHER_PIECE, ptr[long + 1][p_row])
    p_index = np.concatenate([np.arange(len(s)) for s in starts])
    piece = torch.zeros(len(p_start), feat.shape[-1])
    for i in range(GATHER_PIECE):
        on = np.flatnonzero(p_start + i < p_end)
        piece[on] += v[p_start[on] + i]
    share = torch.zeros(len(long), SHARES, feat.shape[-1])
    for turn in range(p_index.max() // SHARES + 1):
        on = np.flatnonzero(p_index // SHARES == turn)
        share[p_row[on], p_index[on] % SHARES] += piece[on]
    total = share[:, 0].clone()
    for s in range(1, SHARES):
        total += share[:, s]
    out[long] = total
    return out


def tables(level, send):
    return (level.row_ptr.numpy(),
            (level.row_send if send else level.row_slots).numpy())


# -- (a) ---------------------------------------------------------------------


@pytest.mark.parametrize("sphere,where", LAYOUTS)
def test_long_lists_and_the_sender_form(spheres, sphere, where):
    """`row_long` lists exactly the rows of more than 32 slots; a level's
    sender lists (`row_send`, over the same `row_ptr`) hold, row by row,
    slots whose sender is that row: the reverse edges of its receiver
    slots, one for one, so their long rows are `row_long` too."""
    _, lt = layout(spheres, sphere, where)
    ptr = lt.row_ptr.numpy()
    np.testing.assert_array_equal(lt.row_long.numpy(), long_rows(ptr))
    np.testing.assert_array_equal(
        lt.row_long.numpy(), np.flatnonzero(np.diff(ptr) > GATHER_PIECE))
    rows = np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))
    np.testing.assert_array_equal(lt.receivers.numpy()[lt.row_slots.numpy()],
                                  rows)
    if where.startswith("L"):
        send = lt.row_send.numpy()
        assert send.shape == lt.row_slots.shape
        np.testing.assert_array_equal(lt.senders.numpy()[send], rows)
        assert len(np.unique(send)) == len(send)


def test_some_lists_are_long(spheres):
    """The layouts reach the pieces: most of the 2k sphere's level-4 rows,
    and in every layout at least the pad row n_pad − 1."""
    _, ht = spheres["sphere 2k"]
    l4 = ht.levels[4]
    assert l4.row_long.numel() > l4.n_pad_nodes // 2
    assert ht.levels[3].row_long.numel() > 0
    for sphere, where in LAYOUTS:
        lt = layout(spheres, sphere, where)[1]
        assert lt.row_long.numel() > 0, (sphere, where)


@pytest.mark.parametrize("sphere,where,form,dt", FORMS)
def test_gather_order_sum_exact(spheres, sphere, where, form, dt):
    lj, lt = layout(spheres, sphere, where)
    seed = 17 + LAYOUTS.index((sphere, where)) + 100 * (form == "send")
    feat = grid_normal(np.random.default_rng(seed), (lt.n_pad_edges, C))
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    ft = torch.from_numpy(feat).to(tdt)
    got = gather_order_sum(*tables(lt, form == "send"), ft)
    plain = segment_sum_plain(lt, ft, send=form == "send")
    fj = jnp.asarray(feat).astype(jdt)
    want = (segment_sum_send_pallas(lj, fj) if form == "send"
            else jax_segment_sum(lj, fj))
    assert want is not None
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gather_order_is_not_list_order(spheres):
    """On N(0, 1) rows the long lists' sums move off a sequential sum in
    list order (the order kernel 8 had), and the short lists' do not."""
    _, lt = layout(spheres, "sphere 2k", "L4")
    ptr, slots = tables(lt, False)
    feat = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (lt.n_pad_edges, C)).astype(np.float32))
    got = gather_order_sum(ptr, slots, feat)
    seq = torch.zeros_like(got)
    v, length = feat[torch.from_numpy(slots).long()], np.diff(ptr)
    for i in range(length.max()):
        rows = np.flatnonzero(length > i)
        seq[rows] += v[ptr[rows] + i]
    long = lt.row_long.long()
    short = np.setdiff1d(np.arange(len(length)), lt.row_long.numpy())
    torch.testing.assert_close(got[short], seq[short], rtol=0, atol=0)
    assert not torch.equal(got[long], seq[long])
    torch.testing.assert_close(got, seq, rtol=1e-5, atol=1e-5)


# -- (b) ---------------------------------------------------------------------


def tile_split(ptr, tile, c=C):
    """Kernel 10's walk of a level on one of its tiles at latent width c
    as (row, cta, warp, share, [start, end)) work items: each tile's rows
    cut into its CTAs' runs (a block of 8 warps per tile, or cluster_of(c)
    CTAs of 4 warps: 4 at 128, 8 at 256), warp w of a CTA summing rows w,
    w + warps, ... of its run, one at a time (each 128-column block of the
    row in turn); a short row whole (share 0), a long row as its eight
    shares in turn, share v walking pieces v, v + 8, ... of GATHER_PIECE
    positions."""
    _, rows = agg_node.TILES[tile]
    ctas, warps = ((node_mlp_k.cluster_of(c), CTA_WARPS)
                   if tile.startswith("cluster") else (1, BLOCK_WARPS))
    run = rows // ctas
    items = []
    for t in range((len(ptr) - 1) // rows):
        for q in range(ctas):
            for i in range(run):
                r, w = t * rows + q * run + i, i % warps
                a, b = ptr[r], ptr[r + 1]
                if b - a <= GATHER_PIECE:
                    items.append((r, t * ctas + q, w, 0, a, b))
                    continue
                for v in range(SHARES):
                    for p in range(a + v * GATHER_PIECE, b,
                                   SHARES * GATHER_PIECE):
                        items.append((r, t * ctas + q, w, v, p,
                                      min(p + GATHER_PIECE, b)))
    return items


def check_tile_split(ht, tile, c):
    """`test_tile_split_covers_every_row_once` at latent width c."""
    _, rows = agg_node.TILES[tile]
    ctas = node_mlp_k.cluster_of(c) if tile.startswith("cluster") else 1
    assert rows % ctas == 0
    n_long = 0
    for lt in ht.levels:
        ptr = lt.row_ptr.numpy()
        n = len(ptr) - 1
        assert n % rows == 0
        items = tile_split(ptr, tile, c)
        owner = {}
        covered = np.zeros(ptr[-1], int)
        for r, cta, w, v, a, b in items:
            assert owner.setdefault(r, (cta, w)) == (cta, w)
            assert cta == r // rows * ctas + r % rows // (rows // ctas)
            covered[a:b] += 1
        assert sorted(owner) == list(range(n))
        assert (covered == 1).all()
        for r in lt.row_long.numpy():
            mine = [(v, a, b) for rr, _, _, v, a, b in items if rr == r]
            # The shares in turn, each its pieces in turn: the gather's
            # pieces in share-major order, each of at most 32 positions.
            assert [v for v, _, _ in mine] == sorted(v for v, _, _ in mine)
            assert sorted(a for _, a, _ in mine) == list(
                range(ptr[r], ptr[r + 1], GATHER_PIECE))
            assert all((a - ptr[r]) // GATHER_PIECE % SHARES == v
                       and b - a <= GATHER_PIECE for v, a, b in mine)
        n_long += lt.row_long.numel()
    assert n_long > 0


@pytest.mark.parametrize("tile", list(agg_node.TILES))
@pytest.mark.parametrize("sphere", list(SPHERES))
def test_tile_split_covers_every_row_once(spheres, sphere, tile):
    """Every row summed by one warp of one CTA (an empty row to zero), a
    cluster's CTA q taking rows [q·R/4, (q+1)·R/4) of its R-row tile, and
    every position of a long list once, in its share, in the gather's
    order."""
    check_tile_split(spheres[sphere][1], tile, C)


@pytest.mark.parametrize("tile", list(agg_node.TILES))
@pytest.mark.parametrize("sphere", list(SPHERES))
def test_tile_split_covers_every_row_once_at_256(spheres, sphere, tile):
    """The same at latent 256 (`agg_node.agg_plan`'s other width): the
    cluster is 8 CTAs a 16-row tile, CTA q summing rows [2q, 2q + 2); the
    one-block tiles split their rows as at 128 (a warp walks a row's list
    once per 128-column block, in the same order)."""
    check_tile_split(spheres[sphere][1], tile, 256)


# -- (c) ---------------------------------------------------------------------


def node_mlp(seed, n_layers=3):
    """A node MLP (first layer [2C, C], n_layers tail layers) at 0.08:
    (numpy weights, biases)."""
    rng = np.random.default_rng(seed)
    ws = [(0.08 * rng.standard_normal((2 * C, C))).astype(np.float32)]
    ws += [(0.08 * rng.standard_normal((C, C))).astype(np.float32)
           for _ in range(n_layers)]
    bs = [(0.08 * rng.standard_normal(C)).astype(np.float32)
          for _ in range(n_layers + 1)]
    return ws, bs


@pytest.mark.parametrize("mode", ["f32", "bf16", "bf16 on f32 x"])
@pytest.mark.parametrize("sphere,where", [("sphere 2k", "L3"),
                                          ("sphere 2k", "L4"),
                                          ("sphere 600", "L0")])
def test_kernel10_model_matches_jax(spheres, sphere, where, mode):
    """The aggregate in kernel 8's order (bf16 edge rows in bf16 compute),
    then kernel 3's cluster order of the node phase, against JAX's kernel;
    the same aggregate through the plain node phase as the port's plain
    version of kernel 10 computes it, within f32 reordering."""
    lj, lt = layout(spheres, sphere, where)
    bf16 = mode != "f32"
    rng = np.random.default_rng(31 + LAYOUTS.index((sphere, where)))
    x = rng.standard_normal((lt.n_pad_nodes, C)).astype(np.float32)
    feat = (0.5 * rng.standard_normal((lt.n_pad_edges, C))).astype(np.float32)
    ws, bs = node_mlp(7)
    x_dt = (torch.bfloat16, jnp.bfloat16) if mode == "bf16" else (
        torch.float32, jnp.float32)
    f_dt = (torch.bfloat16, jnp.bfloat16) if bf16 else (torch.float32,
                                                        jnp.float32)
    ft, xt = torch.from_numpy(feat).to(f_dt[0]), torch.from_numpy(x).to(x_dt[0])
    aggr = gather_order_sum(*tables(lt, False), ft)
    tws, tbs = [torch.from_numpy(w) for w in ws], [torch.from_numpy(b)
                                                   for b in bs]
    got = emulate(xt, aggr, tws, tbs, bf16)
    cd_j = jnp.bfloat16 if bf16 else None
    want = np.asarray(jax_agg_node(
        lj, jnp.asarray(feat).astype(f_dt[1]), jnp.asarray(x).astype(x_dt[1]),
        MLPParams(weights=tuple(jnp.asarray(w) for w in ws),
                  biases=tuple(jnp.asarray(b) for b in bs)), cd_j)
        .astype(jnp.float32))
    tol = KERNEL_TOL["bf16" if bf16 else "f32"] * np.abs(want).max()
    err = np.abs(got.float().numpy() - want).max()
    assert err <= tol, f"{mode}: {err:.3e} > {tol:.3e} vs JAX"
    mlp = types.SimpleNamespace(weights=tws, biases=tbs,
                                layer_normalized=True)
    plain = agg_node.fused_aggregate_node_phase_plain(
        lt, ft, xt, mlp, torch.bfloat16 if bf16 else None)
    assert plain.dtype == got.dtype
    d = (got.float() - plain.float()).abs().max().item()
    assert d <= tol, f"{mode}: {d:.3e} > {tol:.3e} vs the plain version"


@pytest.mark.parametrize("sms", [132, 114, 32])
def test_tile_design_picks_a_kernel_tile(sms):
    """Every tile the rule picks is one the kernel takes and divides the
    rows of every level (a multiple of node_mlp.ROWS); the cluster exactly
    where its 16-row tiles give at most two CTAs per SM, the one-block
    64-row tile where its tiles cover at least three quarters of the SMs.
    On an H100 (132 SMs) the 16k surface's levels 0-7 (16,128 rows down to
    128) take the 64-row block at levels 0-1, the 16-row block at 2-3 and
    the cluster at 4-7."""
    for n in range(64, 40_000, 64):
        tile = agg_node.tile_design(n, sms)
        _, rows = agg_node.TILES[tile]
        assert n % rows == 0
        assert (tile == "cluster 16") == (n // 16 * agg_node.CLUSTER
                                          <= 2 * sms)
        if tile != "cluster 16":
            assert (tile == "block 64") == (4 * (n // 64) >= 3 * sms)
    surface = [16128, 8064, 4096, 2048, 1024, 512, 256, 128]
    if sms == 132:
        assert [agg_node.tile_design(n, sms) for n in surface] == (
            ["block 64"] * 2 + ["block 16"] * 2 + ["cluster 16"] * 4)

