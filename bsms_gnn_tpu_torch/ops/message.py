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
explicit conv (`_gathered_conv`, `_level_conv`): the routes of bucketed
hierarchies, which a batch reaches as the union of its samples'
hierarchies ([B·N_pad, C], `graph.hierarchy.union`, built by
`models/simulator.py`), each call one launch over every sample's rows.

`edge_conv_down` / `edge_conv_up`: the explicit transition conv
(`message.py:699-740`). On the `fused` and `pallas` methods, rows that
pass JAX's `_conv_fast_ok` (a width that is a multiple of 128, one frame
or a batch) take the kernel route, each direction the other's adjoint:
with the level's own weights, windowed levels run kernel 1's level form,
then the residual sub-level's messages accumulate through kernel 9, and
unwindowed levels gather and scale the rows and sum them with kernel 8;
with a runtime `ew`, the gather and kernel 8 on any level. The kernel
route takes one frame (a batch raises "batch axis"). Every other call
(the `ell` and `segment` methods, narrow rows such as a world-position
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
    aggregate_recv,
    aggregate_send,
    gather_recv,
    gather_send,
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
        method, k = split_interleave(method)
        if method not in METHODS:
            raise NotImplementedError(f"aggregation method {method!r}")
        if self.dyn_dims and (pos is None
                              or pos.shape[-1] != sum(self.dyn_dims)):
            raise ValueError(f"world edges need pos of width "
                             f"{sum(self.dyn_dims)}")
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

    def _windowed(self, level, x, pos, compute_dtype, k=1):
        """`gmp_apply`'s windowed branches: v3 (`message.py:251-315`), with
        K > 1 v5 or v3 (kernel 14 or 4) by the density gate and v2 on a
        skip-empty gated level, and, with one world-space stream of width
        wd, v4 (`message.py:317-389`), whose first edge layer's rows are
        [Δworld (wd), ‖Δworld‖, static (sfw), x_i (C), x_j (C)]."""
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
        return fused_node_phase(x, aggr, self.mlp_node, compute_dtype)

    def _generic(self, level, x, pos, compute_dtype, method):
        """`gmp_apply`'s generic path on the `ell` / `segment` scatter
        forms: the pre-activation, the edge MLP's tail, the receiver
        aggregate, the plain node phase."""
        pre = self._edge_pre(level, x, pos, compute_dtype, method)
        edge = mlp_apply_tail(self.mlp_edge, pre, compute_dtype)
        return node_phase(self.mlp_node, x,
                          aggregate_recv(level, edge, method), compute_dtype)

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
    w = w.detach()
    normed_w = w[..., 0] / level.deg
    w_send = gather_send(level, normed_w[..., None], form)[..., 0]
    aggr_w = aggregate_recv(level, w_send[..., None], form)[..., 0] + 1e-12
    ec = w_send / gather_recv(level, aggr_w[..., None], form)[..., 0]
    return ec.detach(), aggr_w[..., None].detach()


def _form(method: str) -> str:
    """The scatter form of the explicit conv's generic route: the method's
    own on `ell` / `segment`, `ell` on the kernel methods; an unknown
    method raises."""
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
    slot-aligned weights, summed at the receivers (kernel 8)."""
    if x.dim() != 2:
        raise NotImplementedError("batch axis")
    msg = x.index_select(0, level.senders) * ew.to(x.dtype)[:, None]
    return segment_sum_raw(level, msg).to(x.dtype)


def _level_conv(level, x, up: bool):
    """`_lvl_down_raw` / `_lvl_up_raw` (`message.py:556-619`): the receiver
    sums of ew · x[sender] with the level's `ew` (down) or `ew_rev` (up, the
    sender sums through the reverse edges). A windowed level runs kernel
    1's level form over its in-window slots, then its residual sub-level's
    messages (`r.ew` / `r.ew_rev`) accumulate through kernel 9."""
    if x.dim() != 2:
        raise NotImplementedError("batch axis")
    ew = level.ew_rev if up else level.ew
    if level.window <= 0:
        return _gathered_conv(level, x, ew)
    out = windowed_conv(level, x, ew)
    r = level.resid
    if r is not None:
        ew_r = (r.ew_rev if up else r.ew).to(x.dtype)
        msg = x.index_select(0, r.senders) * ew_r[:, None]
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


def edge_conv_down(level, x, ew=None, method: str = "fused"):
    """The aggregating conv: Σ_{e: recv(e)=n} ew_e · x[send_e], [..., N_pad,
    C] → [..., N_pad, C] in x's dtype, with the level's own weights
    (`ew=None`) or a runtime slot-aligned `ew` [E_pad]."""
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
    if _conv_fast_ok(level, x, method):
        if ew is None:
            return _LevelConv.apply(level, True, x)
        return _Conv.apply(level, True, x, ew.detach())
    form = _form(method)
    ew = level.ew.to(x.dtype) if ew is None else ew.detach()
    return aggregate_send(level, gather_recv(level, x, form) * ew[..., None],
                          form)
