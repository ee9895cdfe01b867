"""The GMP block (counterpart of `bsms_gnn_tpu/ops/message.py::gmp_apply`:
its `fused` branches, v3 and v4 on windowed levels, v2 and v1 elsewhere,
with `_cresid_edge_phase` and `_node_phase`, and its generic `pallas`
path).

Edge feature [fibers, x_i, x_j] → edge MLP → sum to receiver → node
MLP([x, aggr]) + residual, with both first layers split by input block
(concat(a, b) @ W ≡ a @ Wa + b @ Wb): x_i/x_j are transformed per node
before any gather. The fibers are the static mesh fiber [Δpos, ‖Δpos‖]
precomputed on the level, preceded, with world edges, by the dynamic
world-space fiber [Δworld, ‖Δworld‖] from the world positions.

Four methods, as in the JAX package:
- `"ell"` (JAX's default) and `"segment"` (its parity oracle): the generic
  path (`message.py:391-448`) on the scatter forms of those names
  (`ops/scatter.py`): both gathers, the dynamic fibers [Δworld, ‖Δworld‖]
  before the static one, the edge MLP's tail, the receiver aggregate,
  then the node phase as plain matmuls (`_node_phase`'s XLA branch,
  `message.py:508-514`). JAX keeps both on XLA with no Pallas kernel, and
  these routes launch none of the port's kernels, on any device and at
  any leading dims.
- `"fused"`, routed as `gmp_apply` routes it; the node phase is one kernel
  (kernel 3) on every route. `"fusedK"` (2 ≤ K ≤ 8) is `"fused"` with
  K chunks per step on the windowed levels without world streams: kernel
  14 on a level of at least 6 chunks per 128-node block, kernel 4 on the
  others, v2 (kernel 12) on a skip-empty one that passes the gate
  (`fused_gmp_k.fused_edge_phase_win_k`, JAX's `fused_edge_phase_win_k`).
  World-edge GMPs ignore K, as in JAX.
  - Windowed level, no world stream (v3) or one world-space stream of
    width at most 4 (v4; kernel 13's `MAX_WD`): the static fiber term and
    the first bias ride the kernel's [8, E] fiber stream (wf8) and
    in-window edges run the fused edge kernel, kernel 4 or kernel 13
    (Δworld and ‖Δworld‖ computed in the kernel from the detached
    positions). Out-of-window edges run the
    edge MLP on the compact residual rows and accumulate onto the aggregate
    (kernel 2); on bucketed hierarchies, which carry no compact tables, v3
    and v4 run them on the residual sub-level instead: its gathers (with
    v4 the world-space term from the gathered positions), the edge MLP,
    then kernel 9 onto the aggregate.
  - Unwindowed level, no world stream (v2): zi = the sender gather of x@W_i
    plus the fiber term and the first bias, then kernel 12, which gathers
    x@W_j by receiver itself.
  - Any other level with world streams (an unwindowed level, two or more
    streams, or one wider than 4; v1): the pre-activation as the `pallas`
    method builds it, then kernel 11. JAX's v4 takes one stream up to the
    latent width (`message.py:317-322`); v1 computes the same function on
    the real rows, over every edge of the level (row n_pad − 1 sums the
    pad slots' messages, which v4 masks), so a windowed stream of 4 < wd
    ≤ C runs v1 here, on every device.
- `"pallas"` (any block-aligned level): the gathers (backward: kernel 8),
  the fiber and the edge MLP as plain matmuls, as the JAX package leaves
  them to XLA, then the aggregation and node phase in one kernel (kernel
  10).

On the kernel methods the gathers are `ops/scatter.py`'s `pallas` form,
whose backwards sum by kernel 8. JAX's `fused` method gathers through
`_gather_edges` instead, whose backward is an ELL sum (`scatter.py:
66-81`); the two compute the same function on every row that carries
gradient.

The batch axis (a shared mesh, x [B, N_pad, C]), each batch one launch
of each kernel, as JAX's `gmp_apply` runs vmapped kernels
(`message.py:251-448`, `fused_gmp.py:870-876`, `:1179`, `:1255`,
`:1545-1550`, `agg_node.py:225`): the windowed `fused` routes, v3
(kernels 4, 2, 3 and, backward, 5, 7, 6), v4 with one world stream
(kernel 13 and its backward in place of 4 and 5, pos [B, N_pad, wd]) and
`"fusedK"` on a gated level (kernel 14 and its backward), the compact
residual gathered on dim -2 (with v4 its world term too, from each
sample's positions); the unwindowed `fused` routes, v2 (the sender gather,
kernel 12, kernel 3; backward kernel 12's, kernel 8, kernel 6) and v1
(the gathers, kernel 11, kernel 3); and the `pallas` method (the gathers,
kernel 10; backward kernels 8 and 6). The static fiber term is broadcast
over the batch; with world edges the direction is gather_send(pos) −
gather_recv(pos) per sample. What raises NotImplementedError("batch
axis") on a batch: the residual sub-level (kernel 9), so also v2 on a
skip-empty gated level (its gathers' backward is kernel 9), and the
explicit conv on a level with a residual sub-level (`_level_conv`'s
kernel 9): the routes of bucketed hierarchies, which a batch reaches as
the union of its samples' hierarchies ([B·N_pad, C], `graph.hierarchy.
union`, built by `models/simulator.py`), each call one launch over every
sample's rows. The explicit conv takes a batch on a level with a compact
residual or none (kernel 1's level form and kernel 2 batched, or kernel
8's batched launch unwindowed: a shard's ghost conv on a batch of
frames).

The halo methods (`"halo:<group>:<local>"`, one rank's shard of a
partition plan, `parallel/`; `message.py:101-250`, `:521-527`,
`:706-732`): on a windowed ghost layout the `fused` local method runs v3
or v4 on the rank's extended rows (`parallel/halo.py::ext_assemble`: one
exchange of [x·W_i | x·W_j], with world edges [x·W_i | x·W_j | world_pos]),
the compact residual's phase there, then kernel 3 on the owned rows;
every other halo GMP (a plain halo layout, an unwindowed ghost one, another
local method) takes the generic route on the halo primitives
(`ops/scatter.py`), its node phase kernel 3 on the kernel local methods.
The convs on a ghost layout are `_GhostConv`'s pair: one exchange onto the
extended rows, the layout's own conv (kernel 1's level form and kernel 2,
kernel 8 unwindowed; narrow rows and the kernel-free local methods the
gather and `index_add`), the owned rows kept; on a plain halo layout the
generic form on the halo primitives. `cal_ew` refuses a ghost layout.
Every halo route takes a batch of frames ([B, N_loc, C]).

The edge-sharded methods (`"eshard:<group>:<local>"`, one rank's range of
edge slots of every level, `parallel/edge_shard.py`; JAX's GSPMD edge
sharding, `parallel/edge_shard.py` there): the node rows are replicated;
the GMP's edge part (`GMP.edge_aggregate`: the generic route on `ell` /
`segment`, v3 or v4 on `fused`) sums the rank's slots, `EdgeSum` sums the
ranks' parts and the node phase runs replicated; the convs likewise
(`_eshard_conv`). A runtime `ew`, `cal_ew`, and the routes whose sender
sums read reverse slots (v2, v1, `pallas`) raise.

`edge_conv_down` / `edge_conv_up`: the explicit transition conv
(`message.py:699-740`). On the `fused` and `pallas` methods, rows that
pass JAX's `_conv_fast_ok` (a width that is a multiple of 128, one frame
or a batch) take the kernel route, each direction the other's adjoint:
with the level's own weights, windowed levels run kernel 1's level form,
then the residual sub-level's messages accumulate through kernel 9, and
unwindowed levels gather and scale the rows and sum them with kernel 8;
with a runtime `ew`, the gather and kernel 8 on any level. The kernel
route takes a batch but where kernel 9 runs ("batch axis"). Every other
call (the `ell` and `segment` methods, narrow rows such as a world-position
stream, on any method) takes JAX's generic form: gather_send · ew, then
aggregate_recv (down), or gather_recv · ew, then aggregate_send (up), on
the scatter form of the method (`ell` for `fused` and `pallas`, as JAX's
pallas aggregate falls back to its ELL form on such rows).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from bsms_gnn_tpu_torch.config import split_interleave
from bsms_gnn_tpu_torch.ops.dense import MLP, dense, mlp_apply_tail
from bsms_gnn_tpu_torch.ops.kernels.agg_node import fused_aggregate_node_phase
from bsms_gnn_tpu_torch.ops.kernels.compact_resid import (
    compact_accum,
    compact_accum_raw,
    compact_gather,
)
from bsms_gnn_tpu_torch.ops.kernels.fused_gmp import fused_edge_phase_win
from bsms_gnn_tpu_torch.ops.kernels.fused_gmp_dyn import (
    MAX_WD,
    fused_edge_phase_win_dyn,
)
from bsms_gnn_tpu_torch.ops.kernels.fused_gmp_k import fused_edge_phase_win_k
from bsms_gnn_tpu_torch.ops.kernels.fused_gmp_stream import (
    fused_edge_mlp_aggregate,
    fused_edge_phase,
)
from bsms_gnn_tpu_torch.ops.kernels.node_mlp import fused_node_phase
from bsms_gnn_tpu_torch.ops.kernels.segment_sum import segment_sum_raw
from bsms_gnn_tpu_torch.ops.kernels.segment_sum_accum import (
    segment_sum_accum,
    segment_sum_accum_raw,
)
from bsms_gnn_tpu_torch.ops.kernels.windowed import windowed_conv
from bsms_gnn_tpu_torch.ops.scatter import (
    KERNEL_LOCAL,
    aggregate_recv,
    aggregate_send,
    eshard_parts,
    gather_recv,
    gather_send,
    halo_parts,
)

METHODS = ("fused", "pallas", "ell", "segment")
# The methods that run no kernel (JAX keeps them on XLA).
PLAIN_METHODS = ("ell", "segment")


class GMP(nn.Module):
    """`fiber_dims` lists the positional streams feeding the edge MLP, the
    static mesh stream last: each of width d contributes [Δp, ‖Δp‖] (d + 1
    inputs). The default (pos_dim,) is the static stream alone;
    (world_dim, pos_dim) adds the world-space stream."""

    def __init__(self, latent_dim: int, hidden_layer: int, pos_dim: int,
                 generator: Optional[torch.Generator] = None,
                 fiber_dims: Optional[Sequence[int]] = None):
        super().__init__()
        self.fiber_dims = (pos_dim,) if fiber_dims is None else tuple(fiber_dims)
        edge_in = 2 * latent_dim + sum(d + 1 for d in self.fiber_dims)
        self.mlp_edge = MLP(edge_in, latent_dim, latent_dim, hidden_layer,
                            True, generator)
        self.mlp_node = MLP(2 * latent_dim, latent_dim, latent_dim,
                            hidden_layer, True, generator)

    @property
    def dyn_dims(self):
        """Widths of the dynamic (world-space) streams."""
        return self.fiber_dims[:-1]

    def forward(self, level, x, compute_dtype=None, pos=None,
                method: str = "fused"):
        """One GMP step. x: [N_pad, C], or a batch [B, N_pad, C] (see
        above); pos: [..., N_pad, Σ dyn_dims] world positions (x's leading
        dims) when the GMP has world edges."""
        halo, eshard = halo_parts(method), eshard_parts(method)
        method, k = split_interleave(method)
        if halo is None and eshard is None and method not in METHODS:
            raise NotImplementedError(f"aggregation method {method!r}")
        if self.dyn_dims and (pos is None
                              or pos.shape[-1] != sum(self.dyn_dims)):
            raise ValueError(f"world edges need pos of width "
                             f"{sum(self.dyn_dims)}")
        if halo is not None:
            return self._halo(level, x, pos, compute_dtype, method, *halo)
        if eshard is not None:
            return self._eshard(level, x, pos, compute_dtype, *eshard)
        if method in PLAIN_METHODS:
            return self._generic(level, x, pos, compute_dtype, method)
        if method == "pallas":
            return self._pallas(level, x, pos, compute_dtype)
        dyn = self.dyn_dims
        if level.window > 0 and (not dyn or (len(dyn) == 1
                                             and dyn[0] <= MAX_WD)):
            return self._windowed(level, x, pos, compute_dtype, k)
        if not dyn:
            return self._streamed(level, x, compute_dtype)
        # v1 (`message.py:391-430`): the generic pre-activation, kernel 11.
        aggr = fused_edge_mlp_aggregate(
            level, self._edge_pre(level, x, pos, compute_dtype), *self._tail())
        return fused_node_phase(x, aggr, self.mlp_node, compute_dtype)

    def _tail(self):
        """The edge MLP's layers after the first: (weights, biases), as
        lists (a ParameterList slice would build a module)."""
        return (list(self.mlp_edge.weights)[1:],
                list(self.mlp_edge.biases)[1:])

    def _streamed(self, level, x, compute_dtype, xwi=None, xj=None):
        """`gmp_apply`'s v2 (`message.py:303-315`): zi = xwi = x@W_i
        gathered by sender + fiber·W_f + b0, then kernel 12 (xwi and xj =
        x@W_j as the windowed branch computed them, if it did)."""
        c = x.shape[-1]
        sfw = level.fiber.shape[-1]
        w1 = self.mlp_edge.weights[0]
        wf, wi, wj = w1[:sfw], w1[sfw:sfw + c], w1[sfw + c:]
        if xj is None:
            xj = dense(x, wj, 0.0, compute_dtype)
            xwi = dense(x, wi, 0.0, compute_dtype)
        zi = gather_send(level, xwi) + dense(
            level.fiber.to(x.dtype), wf, self.mlp_edge.biases[0],
            compute_dtype)
        aggr = fused_edge_phase(level, zi, xj, *self._tail())
        return fused_node_phase(x, aggr, self.mlp_node, compute_dtype)

    def _halo(self, level, x, pos, compute_dtype, method, group, local):
        """A halo method on this rank's part of `level` (`gmp_apply`'s halo
        branches, `message.py:101-250`): on a windowed ghost layout with
        the `fused` local method and no world stream or one of width at
        most MAX_WD, the windowed route on the extended tables (one
        exchange of the node-side rows); otherwise the generic path on
        the halo primitives (`ops/scatter.py`), the node phase kernel 3 on
        the kernel local methods, plain on the others."""
        dyn = self.dyn_dims
        if (local == "fused" and level.local is not None
                and level.local.window > 0
                and (not dyn or (len(dyn) == 1 and dyn[0] <= MAX_WD))):
            return self._windowed(level.local, x, pos, compute_dtype,
                                  halo=(level, group))
        pre = self._edge_pre(level, x, pos, compute_dtype, method)
        edge = mlp_apply_tail(self.mlp_edge, pre, compute_dtype)
        aggr = aggregate_recv(level, edge, method)
        if local in KERNEL_LOCAL:
            return fused_node_phase(x, aggr, self.mlp_node, compute_dtype)
        return node_phase(self.mlp_node, x, aggr, compute_dtype)

    def _eshard(self, level, x, pos, compute_dtype, group, local):
        """An edge-sharded method on this rank's slots of `level`
        (`parallel/edge_shard.py`): x enters the edge part through
        `EdgeEnter` (its cotangent summed over the group), the rank's
        partial aggregate leaves through `EdgeSum` (the group's sum), and
        the node phase runs replicated: kernel 3 on `fused`, plain on the
        others."""
        from bsms_gnn_tpu_torch.parallel.edge_shard import edge_part

        aggr = edge_part(lambda x_: self.edge_aggregate(
            level, x_, pos, compute_dtype, local), x, group)
        if local in KERNEL_LOCAL:
            return fused_node_phase(x, aggr, self.mlp_node, compute_dtype)
        return node_phase(self.mlp_node, x, aggr, compute_dtype)

    def edge_aggregate(self, level, x, pos, compute_dtype, local):
        """The receiver sums of the edge MLP's outputs over `level`'s slots
        alone (a rank's part on an edge shard), before any node phase: the
        generic route on `ell` / `segment`, the windowed routes (v3, v4)
        on `fused`. The unwindowed `fused` routes (v2, v1) raise: their
        sender gathers' backwards read each slot's reverse slot, which an
        edge shard may hold on another rank."""
        if local in PLAIN_METHODS:
            pre = self._edge_pre(level, x, pos, compute_dtype, local)
            edge = mlp_apply_tail(self.mlp_edge, pre, compute_dtype)
            return aggregate_recv(level, edge, local)
        dyn = self.dyn_dims
        if local == "fused" and level.window > 0 and (
                not dyn or (len(dyn) == 1 and dyn[0] <= MAX_WD)):
            return self._windowed(level, x, pos, compute_dtype, node=False)
        raise NotImplementedError(
            f"the edge-sharded {local!r} method runs the windowed fused "
            f"routes (v3, v4); this level (window {level.window}, world "
            f"streams {dyn}) takes v2 or v1")

    def _windowed(self, level, x, pos, compute_dtype, k=1, halo=None,
                  node=True):
        """`gmp_apply`'s windowed branches: v3 (`message.py:251-315`), with
        K > 1 v5 or v3 (kernel 14 or 4) by the density gate and v2 on a
        skip-empty gated level, and, with one world-space stream of width
        wd, v4 (`message.py:317-389`), whose first edge layer's rows are
        [Δworld (wd), ‖Δworld‖, static (sfw), x_i (C), x_j (C)].

        `halo` = (the rank's HaloLevel, group): `level` is its ghost
        layout; xwi and xj (with world edges also the positions) cross the
        group in one exchange onto the extended rows, the edge phase runs
        there and the node phase on the owned rows (`message.py:101-250`).
        `node=False` returns the f32 aggregate before the node phase."""
        c = x.shape[-1]
        wd = self.dyn_dims[0] if self.dyn_dims else 0
        sfw = level.fiber.shape[-1]
        pd1 = sfw + (wd + 1 if wd else 0)
        w1 = self.mlp_edge.weights[0]
        b1 = self.mlp_edge.biases[0]
        wf, wi, wj = w1[:pd1], w1[pd1:pd1 + c], w1[pd1 + c:]
        wf_sta = wf[pd1 - sfw:]
        xj = dense(x, wj, 0.0, compute_dtype)
        xwi = dense(x, wi, 0.0, compute_dtype)
        # wf8 rows [0, sfw) = static fiber rows, row sfw = first bias (the
        # fiber stream's constant-1 row), the rest zero.
        wf8 = torch.cat([wf_sta, b1[None], wf.new_zeros(7 - sfw, c)])
        tail = self._tail()
        wpos = wf_dyn = None
        if wd:
            # The positions carry no gradient (JAX's stop_gradient).
            wpos, wf_dyn = pos.detach().to(xwi.dtype), wf[:wd + 1]
        if halo is not None:
            from bsms_gnn_tpu_torch.parallel.halo import ext_assemble

            parts = [xwi, xj] + ([wpos] if wd else [])
            ext = ext_assemble(halo[0], torch.cat(parts, dim=-1), halo[1])
            xwi, xj = ext[..., :c].contiguous(), ext[..., c:2 * c].contiguous()
            if wd:
                wpos = ext[..., 2 * c:].contiguous()
        if wd:
            aggr = fused_edge_phase_win_dyn(level, xwi, xj, wpos, wf8,
                                            wf[:wd], wf[wd], *tail)
        elif k > 1:
            aggr = fused_edge_phase_win_k(level, xwi, xj, wf8, *tail, k)
            if aggr is None:
                return self._streamed(level, x, compute_dtype, xwi, xj)
        else:
            aggr = fused_edge_phase_win(level, xwi, xj, wf8, *tail)
        if level.cresid is not None:
            aggr = _cresid_edge_phase(level.cresid, self, xwi, xj, wf_sta,
                                      aggr, compute_dtype, wpos, wf_dyn)
        elif level.resid is not None:
            aggr = _resid_edge_phase(level.resid, self, xwi, xj, wf_sta, aggr,
                                     compute_dtype, x.dtype, wpos, wf_dyn)
        if halo is not None:
            aggr = aggr[..., :halo[0].n_pad_nodes, :]
        if not node:
            return aggr
        return fused_node_phase(x, aggr, self.mlp_node, compute_dtype)

    def _generic(self, level, x, pos, compute_dtype, method):
        """`gmp_apply`'s generic path on the `ell` / `segment` scatter
        forms: the pre-activation, the edge MLP's tail, the receiver
        aggregate, the plain node phase."""
        return node_phase(self.mlp_node, x, self.edge_aggregate(
            level, x, pos, compute_dtype, method), compute_dtype)

    def _pallas(self, level, x, pos, compute_dtype):
        """`gmp_apply`'s generic path (`message.py:391-448`) on the pallas
        method: the edge MLP's tail as plain matmuls, then kernel 10."""
        pre = self._edge_pre(level, x, pos, compute_dtype)
        edge = mlp_apply_tail(self.mlp_edge, pre, compute_dtype)
        return fused_aggregate_node_phase(level, edge, x, self.mlp_node,
                                          compute_dtype)

    def _edge_pre(self, level, x, pos, compute_dtype, form="pallas"):
        """The generic path's first-layer pre-activation (`message.py:
        391-419`): fiber·W_f + b0 + x_i·W_i + x_j·W_j per slot, the fiber
        the world-space streams' [Δworld, ‖Δworld‖] then the static one;
        the gathers on the scatter form `form`."""
        c = x.shape[-1]
        sfw = level.fiber.shape[-1]
        pd1 = sfw + sum(d + 1 for d in self.dyn_dims)
        w1 = self.mlp_edge.weights[0]
        wf, wi, wj = w1[:pd1], w1[pd1:pd1 + c], w1[pd1 + c:]
        z_i = gather_send(level, dense(x, wi, 0.0, compute_dtype), form)
        z_j = gather_recv(level, dense(x, wj, 0.0, compute_dtype), form)
        static = level.fiber.to(z_i.dtype)
        if self.dyn_dims:
            direction = (gather_send(level, pos, form)
                         - gather_recv(level, pos, form))
            parts = []
            for blk in direction.split(list(self.dyn_dims), dim=-1):
                parts += [blk, torch.linalg.vector_norm(blk, dim=-1,
                                                        keepdim=True)]
            # As jnp.concatenate promotes: the static fiber rounded to the
            # activations' dtype, then widened with the dynamic parts (and
            # broadcast over a batch's leading dims).
            dt = torch.promote_types(direction.dtype, static.dtype)
            static = static.to(dt).expand(*direction.shape[:-1], -1)
            fiber = torch.cat([p.to(dt) for p in parts] + [static], dim=-1)
        else:
            fiber = static
        return (dense(fiber, wf, self.mlp_edge.biases[0], compute_dtype)
                + z_i + z_j)


def node_phase(mlp, x, aggr, compute_dtype):
    """`_node_phase`'s plain branch (`message.py:508-514`): the node MLP
    over [x, aggr] with its first layer split by input block, plus the
    residual."""
    c = x.shape[-1]
    wn = mlp.weights[0]
    pre = (dense(x, wn[:c], mlp.biases[0], compute_dtype)
           + dense(aggr, wn[c:], 0.0, compute_dtype))
    return mlp_apply_tail(mlp, pre, compute_dtype) + x


def _cresid_edge_phase(cr, gmp: GMP, xwi, xj, wf_sta, aggr, compute_dtype,
                       wpos=None, wf_dyn=None):
    """Residual edge phase on the compact tables: gathers and the edge MLP
    over the ~R real out-of-window rows (on xwi's leading dims, the fiber
    term broadcast over them), then the block-visit accumulate onto `aggr`
    (in place). `wpos` / `wf_dyn` ([wd + 1, C], the Δworld and
    ‖Δworld‖ rows) add the world-space fiber term, computed in the
    activations' dtype as the JAX package computes it."""
    pre_r = (
        compact_gather(cr, xwi, "send")
        + compact_gather(cr, xj, "recv")
        + dense(cr.fiber.to(xwi.dtype), wf_sta, gmp.mlp_edge.biases[0],
                compute_dtype)
    )
    if wpos is not None:
        dvec = compact_gather(cr, wpos, "send") - compact_gather(cr, wpos,
                                                                 "recv")
        fib_dyn = torch.cat(
            [dvec, torch.linalg.vector_norm(dvec, dim=-1, keepdim=True)],
            dim=-1)
        pre_r = pre_r + dense(fib_dyn, wf_dyn, 0.0, compute_dtype)
    e_r = mlp_apply_tail(gmp.mlp_edge, pre_r, compute_dtype)
    return compact_accum(cr, e_r, aggr)


def _resid_edge_phase(r, gmp: GMP, xwi, xj, wf, aggr, compute_dtype, dtype,
                      wpos=None, wf_dyn=None):
    """The residual edge phase on the mini layout, where the level has no
    compact tables (bucketed builds): v3's (`message.py:283-302`) and, with
    world edges, v4's (`message.py:357-387`). The gathers over the residual
    sub-level's slots (their backwards run kernel 9: the layout is
    skip-empty); with `wpos` / `wf_dyn` ([wd + 1, C], the Δworld and
    ‖Δworld‖ rows) the world-space term [Δ, ‖Δ‖]·wf_dyn, Δ = the sender's
    world position less the receiver's in the activations' dtype (the
    positions carry no gradient); the static fiber term in the GMP input's
    `dtype` with the first bias; the edge MLP's tail, then kernel 9
    accumulates onto `aggr`. The terms add in the JAX package's order."""
    pre_r = gather_send(r, xwi) + gather_recv(r, xj)
    if wpos is not None:
        dvec = gather_send(r, wpos) - gather_recv(r, wpos)
        fib_dyn = torch.cat(
            [dvec, torch.linalg.vector_norm(dvec, dim=-1, keepdim=True)],
            dim=-1)
        pre_r = pre_r + dense(fib_dyn, wf_dyn, 0.0, compute_dtype)
    pre_r = pre_r + dense(r.fiber.to(dtype), wf, gmp.mlp_edge.biases[0],
                          compute_dtype)
    e_r = mlp_apply_tail(gmp.mlp_edge, pre_r, compute_dtype)
    return segment_sum_accum(r, e_r, aggr)


def cal_ew(level, w, method: str = "ell"):
    """The transition weights from node weights (`message.py:517-533`, the
    reference's no-grad `cal_ew`): w [..., N_pad, 1] → (ec [..., E_pad],
    aggr_w [..., N_pad, 1]), both detached. The rows are one wide, so the
    kernel methods take the `ell` form, as JAX's pallas aggregate does on
    them."""
    form = _form(method)
    if halo_parts(method) is not None and level.local is not None:
        raise NotImplementedError(
            "cal_ew on a ghost halo layout: its transition weights are "
            "built offline (level.local.ew)")
    w = w.detach()
    normed_w = w[..., 0] / level.deg
    w_send = gather_send(level, normed_w[..., None], form)[..., 0]
    aggr_w = aggregate_recv(level, w_send[..., None], form)[..., 0] + 1e-12
    ec = w_send / gather_recv(level, aggr_w[..., None], form)[..., 0]
    return ec.detach(), aggr_w[..., None].detach()


def _form(method: str) -> str:
    """The scatter form of the explicit conv's generic route: the method's
    own on `ell` / `segment` and the halo methods, `ell` on the kernel
    methods; an unknown method raises."""
    if halo_parts(method) is not None:
        return method
    method, _ = split_interleave(method)
    if method not in METHODS:
        raise NotImplementedError(f"aggregation method {method!r}")
    return method if method in PLAIN_METHODS else "ell"


def _conv_fast_ok(level, x, method: str) -> bool:
    """JAX's `_conv_fast_ok` on the kernel methods: rows of a width that is
    a multiple of 128 on a 128-aligned layout."""
    return (split_interleave(method)[0] in ("pallas", "fused")
            and x.dim() in (2, 3) and x.shape[-1] % 128 == 0
            and level.n_pad_nodes % 128 == 0
            and level.n_pad_edges % 128 == 0)


def _gathered_conv(level, x, ew):
    """`message.py::_gathered_conv`: the sender rows scaled by the
    slot-aligned weights, summed at the receivers (kernel 8; a batch [B,
    N_pad, C] in its one batched launch)."""
    msg = x.index_select(-2, level.senders) * ew.to(x.dtype)[:, None]
    return segment_sum_raw(level, msg).to(x.dtype)


def _level_conv(level, x, up: bool):
    """`_lvl_down_raw` / `_lvl_up_raw` (`message.py:556-619`): the receiver
    sums of ew · x[sender] with the level's `ew` (down) or `ew_rev` (up, the
    sender sums through the reverse edges). A windowed level runs kernel
    1's level form over its in-window slots, then its out-of-window
    messages accumulate: through kernel 2 on its compact residual where it
    has one (a shard's ghost layout), else through kernel 9 on its
    residual sub-level (`r.ew` / `r.ew_rev`). A batch [B, N_pad, C] takes
    kernel 1's and kernel 2's batched launches; kernel 9 takes one frame
    and raises "batch axis" on it."""
    ew = level.ew_rev if up else level.ew
    if level.window <= 0:
        return _gathered_conv(level, x, ew)
    out = windowed_conv(level, x, ew)
    cr, r = level.cresid, level.resid
    if cr is not None:
        # The compact residual where the level has one (a shard's ghost
        # layout; `_windowed_conv`, `message.py:594-604`).
        ew_r = (cr.ew_rev if up else cr.ew).to(x.dtype)
        msg = x.index_select(-2, cr.senders) * ew_r[:, None]
        out = compact_accum_raw(cr, msg, out)
    elif r is not None:
        ew_r = (r.ew_rev if up else r.ew).to(x.dtype)
        msg = x.index_select(-2, r.senders) * ew_r[:, None]
        out = segment_sum_accum_raw(r, msg, out)
    return out.to(x.dtype)


class _LevelConv(torch.autograd.Function):
    """The down / up conv pair (`_make_lvl_conv_pair`, `message.py:
    662-692`): each direction's backward is the other direction on the
    cotangent. The weights are graph constants and get no gradient."""

    @staticmethod
    def forward(ctx, level, up, x):
        ctx.level, ctx.up, ctx.dtype = level, up, x.dtype
        return _level_conv(level, x, up)

    @staticmethod
    def backward(ctx, g):
        return None, None, _level_conv(ctx.level, g, not ctx.up).to(ctx.dtype)


class _Conv(torch.autograd.Function):
    """The pair with a runtime `ew` (`_make_conv_pair`, `message.py:
    622-659`): down sums ew · x[sender] at the receivers, up the same with
    ew[reverse_perm] (the sender sums through the reverse edges), each the
    other's backward; `ew` gets no gradient."""

    @staticmethod
    def forward(ctx, level, up, x, ew):
        ctx.level, ctx.up, ctx.ew, ctx.dtype = level, up, ew, x.dtype
        return _gathered_conv(level, x, ew[level.reverse_perm] if up else ew)

    @staticmethod
    def backward(ctx, g):
        lvl, ew = ctx.level, ctx.ew
        out = _gathered_conv(lvl, g, ew if ctx.up else ew[lvl.reverse_perm])
        return None, None, out.to(ctx.dtype), None


def _ghost_conv(level, x, group, kernels: bool, up: bool):
    """`_conv_ghost_raw` (`halo.py:244-291`): the rank's rows assembled on
    the ghost layout's extended rows (one exchange), the layout's own
    conv, the owned rows kept. With `kernels` (a kernel local method and
    rows of a multiple of 128) `_level_conv` (kernel 1's level form and
    kernel 2, or kernel 8 unwindowed), else the gather and `index_add`."""
    from bsms_gnn_tpu_torch.parallel.halo import ext_assemble

    lg = level.local
    ext = ext_assemble(level, x, group)
    if kernels and x.shape[-1] % 128 == 0:
        out = _level_conv(lg, ext, up)
    else:
        ew = (lg.ew_rev if up else lg.ew).to(x.dtype)
        out = aggregate_recv(
            lg, ext.index_select(-2, lg.senders) * ew[..., None], "segment")
    return out[..., :level.n_pad_nodes, :].to(x.dtype)


class _GhostConv(torch.autograd.Function):
    """The ghost down / up conv pair (`conv_down_ghost` / `conv_up_ghost`,
    `halo.py:294-330`): the global up conv is the down conv's adjoint, so
    each direction's backward is the other direction on the cotangent."""

    @staticmethod
    def forward(ctx, level, group, kernels, up, x):
        ctx.level, ctx.group, ctx.kernels, ctx.up, ctx.dtype = (
            level, group, kernels, up, x.dtype)
        return _ghost_conv(level, x, group, kernels, up)

    @staticmethod
    def backward(ctx, g):
        out = _ghost_conv(ctx.level, g, ctx.group, ctx.kernels, not ctx.up)
        return None, None, None, None, out.to(ctx.dtype)


def _halo_conv(level, x, ew, method, up: bool):
    """The conv on a halo method: the ghost pair on a ghost layout (whose
    weights are built offline), else None (the generic route)."""
    halo = halo_parts(method)
    if halo is None or level.local is None:
        return None
    if ew is not None:
        raise ValueError("a ghost halo layout's transition weights are "
                         "built offline: ew must be None")
    group, local = halo
    return _GhostConv.apply(level, group, local in KERNEL_LOCAL, up, x)


def _eshard_conv(level, x, ew, method, up: bool):
    """The conv on an edge-sharded method: the rank's slots' partial sum on
    its local method between `EdgeEnter` and `EdgeSum` (a linear map whose
    adjoint the pair sums over the group too), else None. A runtime `ew`
    raises: its reverse slots (the up conv's) may live on other ranks."""
    es = eshard_parts(method)
    if es is None:
        return None
    from bsms_gnn_tpu_torch.parallel.edge_shard import edge_part

    if ew is not None:
        raise NotImplementedError("an edge shard's transition weights are "
                                  "the level's own: ew must be None")
    group, local = es
    conv = edge_conv_up if up else edge_conv_down
    return edge_part(lambda x_: conv(level, x_, None, local), x, group)


def edge_conv_down(level, x, ew=None, method: str = "fused"):
    """The aggregating conv: Σ_{e: recv(e)=n} ew_e · x[send_e], [..., N_pad,
    C] → [..., N_pad, C] in x's dtype, with the level's own weights
    (`ew=None`) or a runtime slot-aligned `ew` [E_pad]."""
    out = _eshard_conv(level, x, ew, method, up=False)
    if out is not None:
        return out
    out = _halo_conv(level, x, ew, method, up=False)
    if out is not None:
        return out
    if _conv_fast_ok(level, x, method):
        if ew is None:
            return _LevelConv.apply(level, False, x)
        return _Conv.apply(level, False, x, ew.detach())
    form = _form(method)
    ew = level.ew.to(x.dtype) if ew is None else ew.detach()
    return aggregate_recv(level, gather_send(level, x, form) * ew[..., None],
                          form)


def edge_conv_up(level, x, ew=None, method: str = "fused"):
    """The returning conv (the reference's aggragating=False): Σ_{e:
    send(e)=n} ew_e · x[recv_e]."""
    out = _eshard_conv(level, x, ew, method, up=True)
    if out is not None:
        return out
    out = _halo_conv(level, x, ew, method, up=True)
    if out is not None:
        return out
    if _conv_fast_ok(level, x, method):
        if ew is None:
            return _LevelConv.apply(level, True, x)
        return _Conv.apply(level, True, x, ew.detach())
    form = _form(method)
    ew = level.ew.to(x.dtype) if ew is None else ew.detach()
    return aggregate_send(level, gather_recv(level, x, form) * ew[..., None],
                          form)
