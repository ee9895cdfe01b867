#!/usr/bin/env python3
"""Drive the PyTorch port's serving path and train step on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero without the result line):
1. card and build: the card's name and power limit, torch and CUDA
   versions, TF32 off, and the twenty CUDA kernels built from `csrc/`;
2. the 5,233-node graded airfoil (Morton-ordered, depth 7, edge_block 512,
   window 256, the `fused` method) built and moved to the card, its
   per-level layout printed;
3. each forward kernel of that path against its plain PyTorch version on
   the card at the path's shapes (level 0, T0 down / up; kernels 4 and 3
   at every level, twice for bit-identical outputs; kernel 2 also on a
   residual with a receiver of more than 32 rows, level 0's plus a star of
   edges), f32 and bf16; a miss of kernel 3's, 4's, 5's, 6's or 13's
   backward's check prints the smallest |ReLU input| feeding the rows that
   miss;
4. serving: `Simulator` (latent 128, hidden 3, seeded weights, normalizers
   filled from seeded frames) forward through the kernels against the same
   forward through the plain versions, f32 and bf16; the kernel launch
   counts of one forward; a finite 20-step `rollout_trajectory`;
5. serving times with CUDA events: ms per forward and per rollout step, and
   each forward kernel's time beside its plain version, one PyTorch library
   call where one computes the same function, and the card's bound;
6. each backward kernel against its plain version on the card at level 0
   (kernels 5 and 6 at every level, twice for bit-identical outputs;
   kernel 7 also at the level with the longest sender lists, the
   airfoil's level 5), f32 and bf16, every output judged on its own, with
   a bf16 control;
7. the train step: loss and every parameter's gradient through the kernels
   against the same step through the plain versions, f32 and bf16; the
   kernel launch counts of one step; a short `Trainer` run (a two-step
   normalizer-warmup gate, then updates) with finite losses that moves
   every parameter;
8. train-step times: ms per step (median of repeats, CUDA events), device
   busy time, idle share and kernel count of one profiled step (which
   must launch no `block_sum_kernel`), peak memory (and above what the
   step starts with), and each backward kernel's time beside its plain
   version, its library call and its bound;
9. the 16,000-node inflating surface of bench.py (a closed sphere mesh,
   depth 7, the default unwindowed hierarchy, the `pallas` method, world
   edges, the inflating-font model at latent 128, hidden 3): kernels 8
   (both forms at every level, and on T0-T2's operators) and 10 (at every
   level) against their plain versions, twice for bit-identical outputs
   (f32, bf16, with a bf16 control for kernel 10), and kernel 10 against
   kernel 3 on kernel 8's aggregate, bit for bit, at every level in f32,
   bf16 and bf16 on f32 x; then phases 4, 5, 7 and 8 on it (its path has
   no backward kernel of its own to time; kernels 8 and 10 are timed at
   every shape instead), the `Trainer` run on a frame pair of
   `generate_inflating_trajectory`;
10. the flag (flag_simple at full width and depth: a Morton-ordered
   1,568-node cloth strip, depth 5, edge_block 512, window 256, the `fused`
   method with world edges, latent 128, hidden 3): kernel 13 (forward and
   backward, each at every level, twice for bit-identical outputs) and the
   other kernels of its path against their plain versions at its shapes
   (f32, bf16, bf16 controls), then phases 4, 5, 7 and 8 on it (kernel 13
   and its backward timed at every level), the `Trainer` run (noise γ 0.1)
   on the contact recipe's frame pair; kernel 11 (forward and backward) at
   its level 0 too (edge_block 512), against its plain version (the
   forward twice for bit-identical outputs), and a GMP with a 6-wide world
   stream there (wider than kernel 13 takes: kernel 11's route), forward
   and backward against the plain route;
11. the 5k airfoil on the `fused` method of method_sweep.py's fused-v2 row
   (not reordered, the default unwindowed hierarchy, edge_block 128):
   kernel 12 (forward and backward, each at every level, twice for
   bit-identical outputs) against its plain version, then phases 4, 5, 7
   and 8 on it (kernel 12 and its backward timed at every level);
12. the 16k surface of phase 9 on the `fused` method (method_sweep.py's
   fused-v2 row with world edges): kernel 11 (forward at every level,
   backward at levels 0 and 7, twice for bit-identical outputs) against its
   plain version, then phases 4, 5, 7 and 8 on it (kernel 11 timed at every
   level, its backward at both) and the `Trainer` run on the trajectory's
   frames;
13. cylinder_flow at full width and depth on variable meshes: three
   Morton-ordered Delaunay meshes (1,600, 1,885 and 2,000 nodes), one size
   group (window 256, edge_block 512), each padded to the group's buckets,
   so the hierarchies have no TransOp and no compact residual; the 1,885-
   node mesh served: kernel 1's level form (the explicit conv, down and
   up) and kernel 9 (both forms, on acc and in the store form, at every
   residual sub-level and on a forced empty one, twice for bit-identical
   outputs, the store form bit for bit the call on zeros) against their
   plain versions, then phases 4, 5, 7 and 8 on it (both kernels timed,
   kernel 9 at every shape), the `Trainer` run stepping across the three
   meshes on frames of the analytic flow;
14. the 5k airfoil of phase 2 on `aggregation="fused4"` (the K-way
   interleaved method): kernel 14, forward and backward, at every level
   that passes the density gate (3, 4 and 5, twice for bit-identical
   outputs) and kernels 4 and 5 at level 3, against their plain versions
   (f32, bf16, bf16 controls), then phases 4, 5, 7 and 8 on it (kernel 14
   timed at every gated level, beside kernels 4 and 5 at level 3); its
   forward and train step also against the `fused` airfoil's with the same
   weights;
15. the v6 prototype's benchmark (`benchmarks/v6_prototype.py`): level 0
   of a Morton-ordered `make_delaunay_mesh` of V6_NODES nodes (window 512,
   edge_block 512), its sub-window tables and their coverage, kernel 15 and
   kernel 1's level form, on the same level and weights, each against its
   plain version (f32, bf16, bf16 control) and timed beside its plain
   version, `torch.sparse.mm` and its bound; one counted launch of kernel
   15;
16. the batch axis on the 5k airfoil of phase 2 (airfoil_batch: batches
   of distinct seeded frames over its one hierarchy): kernels 1-7 at
   BATCH_CHECK samples at every shape phases 3 and 6 check them at (the
   batched kernel against its plain version, twice for bit-identical
   outputs, bf16 controls; sample s of every per-row output bit for bit
   the call on sample s alone; the weight gradients against the sum of
   the samples' calls); kernel 6 the same at BATCH_TRAIN samples on level
   0, more tiles than the cap on its partials, so that its clusters walk
   ranges of tiles; the forward at BATCH_SERVE and the train step at
   BATCH_TRAIN against the plain path with the B = 1 launch counts; a
   `Trainer` run at BATCH_TRAIN; forward and step times at B = 1,
   BATCH_SERVE and BATCH_TRAIN, busy per sample;
17. the batch axis on the flag of phase 10 (flag_batch: batches of the
   contact recipe's frames, each from its own seed): kernel 13, forward
   and backward, at BATCH_CHECK samples at every level phase 10 checks it
   at, with phase 16's checks (dwf8, dwf_dyn, dwf_nrm, dW and db against
   the sum of the samples' calls); the forward at BATCH_SERVE with the B =
   1 launch and narrow-route counts, the train step at BATCH_TRAIN with
   the B = 1 counts, a `Trainer` run there; phase 16's times;
18. the batch axis on the `fused4` airfoil of phase 14 (fused4_batch):
   kernel 14, forward and backward, at BATCH_CHECK samples at levels 3-5,
   then phase 17's serving, train step, `Trainer` run and times;
19. the batch axis on the pallas surface of phase 9 (surface_batch: frames
   of its trajectory's frame pair, each with its own seeded noise on the
   world positions): kernel 8 (both forms at every level, and on T0-T2's
   operators) and kernel 10 (every level, and bf16 on f32 x) at
   BATCH_CHECK samples with phase 16's checks, and kernel 10 bit for bit
   kernel 3 on kernel 8's aggregate at every level at BATCH_CHECK samples
   (f32, bf16, bf16 on f32 x; the tile `agg_node.tile_design` picks on the
   batch's rows printed at BATCH_CHECK, BATCH_SERVE and
   BATCH_TRAIN_SURFACE); the forward at BATCH_SERVE with the B = 1 launch
   and narrow-route counts, the train step and a `Trainer` run at
   BATCH_TRAIN_SURFACE with the B = 1 counts; phase 16's times at B = 1,
   BATCH_SERVE and BATCH_TRAIN_SURFACE; then the train step at BATCH_TRAIN
   under remat (every GMP checkpointed, REMAT_MIN_NODES_SURFACE): its
   gradients against the plain path's under remat, the remat counts
   (EXPECTED_SURFACE_REMAT_TRAIN_LAUNCHES: kernel 10 replayed in each
   GMP's backward), a `Trainer` run, and its wall and busy ms, idle share,
   CUDA kernels and own peak MiB beside the card's memory;
20. the batch axis on the unwindowed airfoil of phase 11 (plain_batch):
   kernel 12 (forward and backward, every level) and kernel 8 (level 0 in
   both forms, T0-T1's operators) at BATCH_CHECK samples, then phase 17's
   serving, train step at BATCH_TRAIN, `Trainer` run and times;
21. the batch axis on the fused surface of phase 12 (surface_fused_batch,
   phase 19's frames): kernel 11 (forward at every level, backward at
   levels 0 and 7) at BATCH_CHECK samples, then phase 17's serving, train
   step at BATCH_TRAIN, `Trainer` run and times;
22. variable-mesh batches on the cylinder of phase 13 (cylinder_batch):
   sample s on mesh s mod 3 with its own seeded frame pair, each batch on
   the union of its samples' hierarchies (`stack_hierarchies`, its host
   time printed): kernels 1 (level form), 3-7 and 9 at BATCH_CHECK
   samples on the union of the three meshes, at every shape phase 13
   checks them at, with phase 16's checks (sample s bit for bit the call
   on mesh s alone); the forward at BATCH_SERVE against the plain path
   with the B = 1 counts and, sample by sample, against its B = 1 forward
   on its own mesh; the train step at BATCH_TRAIN against the plain path
   with the B = 1 counts, a `Trainer` run there; BATCH_CHECK frames on the served mesh's one hierarchy
   against the plain path; a `Trainer` with gradient_accumulation_steps =
   2 whose parameters move on every second update step only; phase 16's
   times;
23. the `ell` method, the JAX default, on the JAX CLI's layouts
   (unwindowed, edge_block 128, not reordered; ELL_PATHS): airfoil_ell
   (the 5k airfoil, depth 7), flag_ell (flag_simple, depth 5, its 3-wide
   world stream through the explicit conv + pool), cylinder_ell (the
   three cylinder meshes, bucketed, each batch on their union) and
   inflating_ell (inflating_font, depth 4, world edges, on three ~16k-node
   sphere meshes of one size group, bucketed): each case's model against
   twins of the same weights on `segment` (and, on the airfoil,
   `pallas`), f32 and bf16, on the real rows: the B = 1 forward and the
   forward at BATCH_SERVE (FORWARD_TOL), the train step at B = 1 and at
   the largest batch up to BATCH_TRAIN that fits (ELL_TRAIN_MEM_SHARE:
   48, inflating fewer) (the case's TRAIN_TOL; in bf16 at least twice the
   segment twin's own noise); no port kernel launches on the `ell` and
   `segment` routes (every counter 0); a `Trainer` there with its ms,
   busy ms, idle share and own peak, the airfoil's beside the windowed
   `fused` airfoil_batch's of the same run;
24. the CLIs (cli): `load_config` (the port's YAML reader) with
   `datasets=synthetic_airfoil` set to the main path's layout and method
   (the 5k airfoil of phase 2, depth 7, window 256, edge_block 512,
   `fused`), batch BATCH_TRAIN, a warmup gate of CLI_GATE steps and
   CLI_STEPS + 1 steps; two train trajectories of BATCH_TRAIN + 2 frames
   and a test trajectory of ROLLOUT_STEPS + 1 on phase 2's mesh (the
   analytic flow, seeded) through `TrajectoryReader.from_fields` (their
   layout against phase 2's) and `TrajectorySampler.from_readers`; then
   `run_train` (through `device_prefetch`): finite losses, the gate steps
   leave the parameters as they are and every parameter with a gradient
   moves after them, one step's launch counts EXPECTED_TRAIN_LAUNCHES, a
   checkpoint at CLI_SAVE; a second `run_train` restored from that
   checkpoint on the same batches ends at the same step with the
   parameters, normalizers and AdamW moments bit for bit the first's;
   `run_rollout` from the last checkpoint: finite RMSE summaries and
   predictions bit for bit `rollout_trajectory` on the restored model;
   the CLI's ms per step and one profiled step's busy ms, idle share and
   CUDA kernels beside airfoil_batch's `Trainer` step;
25. deforming_plate (`deforming_plate_config()`: latent 128, hidden 3,
   depth 5, pos_dim 3, world edges, the `fused` method) on three tetra
   blocks of one size group (TETRA_MESHES, window 256, edge_block 512,
   Morton order), each a squeeze trajectory (`generate_tetra_trajectory`)
   read by `TrajectoryReader.from_fields` with their bucket plan; the
   native SpGEMM's availability printed and required; each level's layout
   with its residual slots and in-window share; kernels 13 (forward and
   backward, a static fiber 4 wide), 3 and 6 at every level, 7 at level 0,
   the level of the longest sender lists and every level with a residual
   sub-level, 1's level form at levels 0 and 4, and 9 at every residual
   sub-level and a forced empty one, against their plain versions (f32,
   bf16, controls); then at BATCH_CHECK samples on the union of the
   blocks, at the levels with a residual sub-level, with phase 22's checks;
   the forward and a 20-step rollout with EXPECTED_TETRA_LAUNCHES; kernels
   13 and 9 timed; the forward at BATCH_SERVE on the union (each sample
   against its own B = 1 forward); the train step at B = 1 (with
   EXPECTED_TETRA_TRAIN_LAUNCHES and a `Trainer` over the three blocks)
   and at the largest batch up to BATCH_TRAIN whose step, at the B = 1
   step's largest own peak times B, stays within ELL_TRAIN_MEM_SHARE of
   the card, with a `Trainer` there and its ms, busy ms, idle share and
   own peak;
26. the 5k airfoil of phase 2 built with `window="auto"` (airfoil_auto):
   the native SpGEMM required, the chosen widths printed (at least one not
   WINDOW); kernels 4, 3, 5 and 6 at every level, 1 (rect form) and 2 on
   every operator and level whose width is not WINDOW beside phase 3's
   shapes, and 7 at every such level, against their plain versions; the
   forward and rollout with EXPECTED_AUTO_LAUNCHES, the train step at B = 1
   with EXPECTED_AUTO_TRAIN_LAUNCHES and at BATCH_TRAIN, and a `Trainer`
   at BATCH_TRAIN with its ms and busy ms beside airfoil_batch's;
27. the halo path (airfoil_halo): the 5k airfoil of phase 2 partitioned
   into HALO_RANKS = 2 shards (`parallel.partition.build_partition`, the
   ghost layout at window 256 and edge_block 512, levels 0-2 partitioned,
   3-7 replicated by HALO_REPLICATE_FLOOR), its layout printed; two ranks
   spawned on this card over gloo (`halo_rank`; the parent built every
   kernel first, and a rank that would compile one fails): the f32
   forward and a HALO_ROLLOUT-step rollout, unpartitioned, against the
   one-device model at HALO_TOL; the gate and HALO_UPDATES updates of a
   `HaloTrainer`, each rank fed its part of a shared noise draw, against
   a one-device `Trainer` (the losses at TRAIN_TOL, each update's
   gradients at TRAIN_TOL against a one-device `Trainer` loaded with rank
   0's state before that update, the parameters' updates in
   `_param_close`'s measure), both ranks ending bit for bit
   equal; each rank's launch counts of one forward and one train step
   (the same on both; kernels 1's level form and 2-7 launched), its
   collectives and their time, its step wall time (two ranks sharing one
   card over gloo, not a multi-card figure); kernels 1 (level form), 2,
   3, 4 and 5-7 on shard 0's extended tables (levels 0 and 3) against
   their plain versions; then the data-parallel step on the same ranks
   (HALO_RANKS × DP_BATCH frames against the one-process step on all:
   the loss, the gradients at TRAIN_TOL, equal replicas) and one NCCL
   rank in a group of one, its data-parallel step bit for bit the
   one-process step; the batch axis: one forward and one train step of
   HALO_BATCH = 4 frames on the ranks' shards against the one-device
   forward and step (HALO_TOL, the loss and gradients at TRAIN_TOL, equal
   replicas), their walls, and kernel 1's level form at BATCH_CHECK
   frames on shard 0's ghost tables, each sample bit for bit its own call;
28. the edge-sharded step (airfoil_eshard): the 5k airfoil of phase 2
   edge-sharded over ESHARD_RANKS = 2 ranks (`parallel.edge_shard`: every
   node row on both, each rank a range of every level's and operator's
   slots), the ranges, live slots and compact rows printed, and per rank
   and level the tiles kernels 4 and 5 walk, which must add to one
   device's; two ranks spawned on this card over gloo (`eshard_rank`):
   the forward (both ranks bit for bit the same prediction) against the
   one-device forward at HALO_TOL; the gate and ESHARD_UPDATES updates of
   `edge_shard_train_step` against a one-device `Trainer` (losses and
   each update's gradients at TRAIN_TOL, the updates in `_param_close`'s
   measure, equal replicas); each rank's launches (kernels 1's rect form
   and 2-7 on both), collectives and walls (two ranks sharing one card,
   not a multi-card figure); kernels 1-7 on rank 0's ranges of levels 0
   and 3 against their plain versions; one NCCL rank in a group of one
   (an edge shard of every slot) against the one-device trainer;
29. the wide airfoil (airfoil_wide): phase 2's case with its model from
   the port's `load_config` on the synthetic-airfoil group with the
   overrides WIDE_OVERRIDES (latent 256, hidden 4: four tail layers),
   nothing else changed (required); kernels 1 (rect form, every windowed
   operator) and 2 (every level and operator with a compact residual, and
   the star) and 3-7 at every level, against their plain versions at C =
   256 (f32, bf16, the bf16 controls missing; kernels 3-6's f32 inputs
   cleared of ReLU inputs near their kinks, `clear_kinks`); the forward at
   FORWARD_TOL with phase 2's launch counts, a 20-step rollout, kernels
   1-7 timed; the f32 and bf16 train step against the deterministic plain
   step with phase 2's train-step counts, at WIDE_TRAIN_TOL and, in f32,
   WIDE_TRAIN_MEDIAN (the plain path's own f32 spread there is past
   TRAIN_TOL), and the f32 step with kernel 5 in its bf16 mode failing
   that gate (`launches_airfoil_wide` in the kernels line); kernels 1-7 at BATCH_CHECK samples at every shape
   above, each sample bit for bit its B = 1 call; the train step at B = 1
   and BATCH_TRAIN timed (ms, busy, idle share, CUDA kernels, own peak).
   Every unbucketed path with a backward tile walk (phases 6, 10, 11, 12
   and 14) also holds that walk and kernel 6 at DEEP_TAIL tail layers at
   C = 128 on level 0 (`check_deep_tails`).

Prints a JSON line of end-to-end times, one `{"kernels": [...]}` line, then
as its last line
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Exits non-zero where `torch.cuda.is_available()` is false.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

N_NODES, DEPTH, EDGE_BLOCK, WINDOW = 5233, 7, 512, 256
SURFACE_NODES, SURFACE_DEPTH = 16000, 7
FLAG_NODES, FLAG_NY, FLAG_DEPTH = 1579, 32, 5
# (nodes, seed) of the cylinder path's meshes; the second is served.
CYLINDER_MESHES, CYLINDER_DEPTH = ((1600, 1), (1885, 0), (2000, 2)), 5
# (nodes, seed) of deforming_plate's tetra blocks (`make_tetra_mesh`), one
# size group, the second served: from about 5,000 nodes only the bottom
# level of a depth-5 hierarchy is a single node. Each trajectory holds
# TETRA_FRAMES frames of the squeeze (`generate_tetra_trajectory`).
TETRA_MESHES, TETRA_DEPTH = ((6_000, 1), (6_500, 0), (7_000, 2)), 5
TETRA_FRAMES = 18
ROLLOUT_STEPS = 20
# The v6 benchmark's mesh (the prototype's 1M-node level 0) and layout.
V6_NODES, V6_WINDOW = 1_000_000, 512
# Published H100 SXM peaks (NVIDIA data sheet) at the 700 W limit.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
# Kernel vs plain on the card, as fractions of the RMS of the plain
# version's output: (largest error, RMS error). In f32 both sides sum in
# true f32, in other orders. In bf16 the selection kernels (windowed,
# compact) add bf16 rows times bf16 weights, products exact in f32, so they
# agree as in f32. The MLP kernels (edge, node) round the same operands to
# bf16 on both sides, and an f32 sum in another order puts a rare
# intermediate on the other side of a bf16 rounding step (2^-8 relative):
# the largest error is about one such step (one step of the node phase's
# bf16 output, 1.1e-2 of its RMS), the RMS error stays small. Each limit
# sits at least 3x above the error measured on an H100 (PERF.md); in bf16 a
# control kernel that skips the rounding (`control_args`) must miss it, and
# misses it by at least 5x in one of the two measures there.
TOL = {
    ("fused_edge_phase_win", torch.float32): (2e-5, 1e-6),
    ("fused_node_phase", torch.float32): (2e-5, 1e-6),
    ("windowed_rect_conv", torch.float32): (2e-5, 1e-6),
    ("compact_accum", torch.float32): (2e-5, 1e-6),
    ("fused_edge_phase_win", torch.bfloat16): (5e-3, 2e-5),
    ("fused_node_phase", torch.bfloat16): (5e-2, 5e-4),
    ("windowed_rect_conv", torch.bfloat16): (2e-5, 1e-6),
    ("compact_accum", torch.bfloat16): (2e-5, 1e-6),
    # Kernel 8 sums rows in the row gather's order (a list of more than 32
    # rows in pieces), the plain version with atomics in another: f32 sums
    # in another order, of up to ~180 rows (the pad row n_pad - 1, the deep
    # levels' rows; bf16 rows add exactly in f32). Kernel 10 rounds as
    # kernel 3 does; its largest bf16 error is one bf16 step of an output
    # between 4 and 8 (2^-5, 2.2e-2 of the RMS), and its control misses by
    # the RMS error.
    ("segment_sum", torch.float32): (2e-5, 1e-6),
    ("segment_sum", torch.bfloat16): (2e-5, 1e-6),
    ("fused_aggregate_node_phase", torch.float32): (2e-5, 1e-6),
    ("fused_aggregate_node_phase", torch.bfloat16): (7e-2, 5e-4),
    # Kernel 13 rounds as kernel 4 does, plus the bf16 Δ operand of the
    # wf_dyn dot.
    ("fused_edge_phase_win_dyn", torch.float32): (2e-5, 1e-6),
    ("fused_edge_phase_win_dyn", torch.bfloat16): (5e-3, 2e-5),
    # Kernels 12 and 11 run kernel 4's tail and scatter on a streamed first
    # layer, but without a window mask: row n_pad - 1 sums every pad slot
    # of the last output block (hundreds of rows where the chunk is 512
    # slots), in slot order in the kernel and in `index_add_`'s order in
    # the plain version, so the largest f32 error, on that row, reads up
    # to 5e-5 of the RMS on an H100. In bf16 the many slots of the 16k
    # surface put a flip of a bf16-rounded LN output (one step of an
    # output between 2 and 8) on a few rows: the largest error is a few
    # such steps, the RMS error stays kernel 4's.
    ("fused_edge_phase", torch.float32): (2e-4, 1e-6),
    ("fused_edge_phase", torch.bfloat16): (2e-2, 2e-5),
    ("fused_edge_mlp_aggregate", torch.float32): (2e-4, 1e-6),
    ("fused_edge_mlp_aggregate", torch.bfloat16): (2e-2, 2e-5),
    # Kernel 1's level form: the rect form's function and limits.
    ("windowed_conv", torch.float32): (2e-5, 1e-6),
    ("windowed_conv", torch.bfloat16): (2e-5, 1e-6),
    # Kernel 9 sums in the row gather's order, then adds acc, the plain
    # version onto acc with atomics: row n_pad - 1 sums every pad slot of
    # the last block, the residual layout's tail chunks included (hundreds
    # of rows), where f32 sum order shows, as for kernels 11 and 12; bf16
    # rows add exactly in f32. Its control keeps acc in bf16 (a kernel that
    # accumulated in the feature dtype).
    ("segment_sum_accum", torch.float32): (2e-4, 1e-6),
    ("segment_sum_accum", torch.bfloat16): (2e-4, 1e-6),
    # Kernel 14: kernel 4's function, so kernel 4's limits. Kernel 15: kernel
    # 1's scheme (products of bf16 values, exact in f32), so kernel 1's.
    ("fused_edge_phase_win_k", torch.float32): (2e-5, 1e-6),
    ("fused_edge_phase_win_k", torch.bfloat16): (5e-3, 2e-5),
    ("subwin_conv", torch.float32): (2e-5, 1e-6),
    ("subwin_conv", torch.bfloat16): (2e-5, 1e-6),
}
# The whole forward, relative to the predicted delta's scale: in f32 the
# prediction (state + delta, |state| up to ~5) itself rounds at ~5e-7. In
# bf16 a rounding flip early in the forward spreads through the 15 GMPs, so
# kernels and plain versions differ about as much as bf16 and f32 do: this
# check catches gross faults only; the per-kernel checks and their
# controls hold the bf16 rounding.
FORWARD_TOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
EXPECTED_LAUNCHES = {"fused_edge_phase_win": 15, "fused_node_phase": 15,
                     "windowed_rect_conv": 14, "compact_accum": 16}
# Launches of one train step (forward and backward) of the 5k model: the
# forward's, plus kernel 1 in the 14 transitions' adjoints, kernel 2 in the
# 16 compact gathers' backwards and the 8 residual operators' adjoints, and
# kernels 5, 6 and 7 once in each of the 15 GMPs' backwards.
EXPECTED_TRAIN_LAUNCHES = {
    "fused_edge_phase_win": 15, "fused_node_phase": 15,
    "fused_edge_phase_win_bwd": 15, "fused_node_phase_bwd": 15,
    "windowed_rect_conv": 28, "compact_accum": 40, "windowed_send_sum": 15}
# The 16k surface on the pallas method, per forward: kernel 10 in each of
# the 15 GMPs; kernel 8 in the sparse transitions T0-T2, each way (T3-T6
# are dense matrices); the 3-wide world positions ride T0-T2 down through
# kernel 8's plain version (`narrow_calls`), not a launch. No windowed
# kernel runs.
EXPECTED_SURFACE_LAUNCHES = {
    "fused_aggregate_node_phase": 15, "segment_sum": 6,
    "fused_node_phase": 0, "fused_edge_phase_win": 0,
    "windowed_rect_conv": 0, "compact_accum": 0}
EXPECTED_SURFACE_NARROW = 3
# Per train step: the forward's; then in each of the 15 GMPs' backwards
# kernel 8 three times (the aggregate again in kernel 10's backward, the
# sender gather's and the receiver gather's backwards) and kernel 6 once
# (in kernel 10's backward); and kernel 8 in the adjoints of the 6 sparse
# transition applications: 6 + 15 * 3 + 6 = 57. The world positions carry
# no gradient.
EXPECTED_SURFACE_TRAIN_LAUNCHES = {
    "fused_aggregate_node_phase": 15, "segment_sum": 57,
    "fused_node_phase_bwd": 15, "fused_node_phase": 0,
    "fused_edge_phase_win": 0, "fused_edge_phase_win_bwd": 0,
    "windowed_rect_conv": 0, "compact_accum": 0, "windowed_send_sum": 0}
# The flag on the fused method with world edges, per forward: kernel 13 (not
# kernel 4) and kernel 3 in each of the 11 GMPs; kernel 1 in the 10
# transitions of h; kernel 2 in the 6 GMPs of levels 0-2 (compact residual
# rows) and the 5 residual operators (T0, T1 both ways, T2 down); the 3-wide
# world positions ride T0-T4 down by the narrow plain route
# (`transition.narrow_apply`), not a launch.
EXPECTED_FLAG_LAUNCHES = {
    "fused_edge_phase_win_dyn": 11, "fused_edge_phase_win": 0,
    "fused_node_phase": 11, "windowed_rect_conv": 10, "compact_accum": 11,
    "segment_sum": 0, "fused_aggregate_node_phase": 0}
EXPECTED_FLAG_NARROW = (0, 5)
# Per train step: the forward's; kernel 13's backward, kernel 7 (on dpre)
# and kernel 6 once in each of the 11 GMPs' backwards; kernel 1 in the 10
# transitions' adjoints; kernel 2 in the 12 compact gathers' backwards (the
# sender and receiver rows of the 6 GMPs with residual rows; the positions'
# gathers carry no gradient) and the 5 residual operators' adjoints: 11 +
# 12 + 5 = 28. No kernel 5, 8 or 10.
EXPECTED_FLAG_TRAIN_LAUNCHES = {
    "fused_edge_phase_win_dyn": 11, "fused_edge_phase_win_dyn_bwd": 11,
    "fused_node_phase": 11, "fused_node_phase_bwd": 11,
    "windowed_rect_conv": 20, "compact_accum": 28, "windowed_send_sum": 11,
    "fused_edge_phase_win": 0, "fused_edge_phase_win_bwd": 0,
    "segment_sum": 0, "fused_aggregate_node_phase": 0}
# The 5k airfoil on the fused method, unwindowed (method_sweep.py's
# fused-v2), per forward: kernel 12 and kernel 3 in each of the 15 GMPs;
# kernel 8 in the sparse transitions T0 and T1, each way (T2-T6 are dense
# matrices). Per train step: the forward's; then in each of the 15 GMPs'
# backwards kernel 12's backward, kernel 6 and kernel 8 once (the sender
# gather's backward: kernel 12 gathers the receiver rows itself), and kernel
# 8 in the 4 sparse transitions' adjoints: 4 + 15 + 4 = 23.
EXPECTED_PLAIN_LAUNCHES = {
    "fused_edge_phase": 15, "fused_node_phase": 15, "segment_sum": 4,
    "fused_edge_mlp_aggregate": 0, "fused_edge_phase_win": 0,
    "windowed_rect_conv": 0, "compact_accum": 0,
    "fused_aggregate_node_phase": 0}
EXPECTED_PLAIN_TRAIN_LAUNCHES = {
    "fused_edge_phase": 15, "fused_edge_phase_bwd": 15,
    "fused_node_phase": 15, "fused_node_phase_bwd": 15, "segment_sum": 23,
    "fused_edge_mlp_aggregate": 0, "fused_edge_mlp_aggregate_bwd": 0,
    "fused_edge_phase_win": 0, "fused_edge_phase_win_bwd": 0,
    "windowed_rect_conv": 0, "compact_accum": 0, "windowed_send_sum": 0,
    "fused_aggregate_node_phase": 0}
# The 16k surface on the fused method (world edges, unwindowed: v1), per
# forward: kernel 11 and kernel 3 in each of the 15 GMPs, kernel 8 in T0-T2
# each way, the world positions down T0-T2 by kernel 8's plain version.
# Per train step: the forward's; then in each GMP's backward kernel 11's
# backward, kernel 6, and kernel 8 twice (the sender and the receiver
# gathers' backwards); kernel 8 in the 6 sparse transitions' adjoints: 6 +
# 30 + 6 = 42 (the pallas path's 57 less the 15 aggregates kernel 10's
# backward sums again).
EXPECTED_SURFACE_FUSED_LAUNCHES = {
    "fused_edge_mlp_aggregate": 15, "fused_node_phase": 15, "segment_sum": 6,
    "fused_edge_phase": 0, "fused_aggregate_node_phase": 0,
    "fused_edge_phase_win": 0, "windowed_rect_conv": 0, "compact_accum": 0}
EXPECTED_SURFACE_FUSED_TRAIN_LAUNCHES = {
    "fused_edge_mlp_aggregate": 15, "fused_edge_mlp_aggregate_bwd": 15,
    "fused_node_phase": 15, "fused_node_phase_bwd": 15, "segment_sum": 42,
    "fused_edge_phase": 0, "fused_edge_phase_bwd": 0,
    "fused_aggregate_node_phase": 0, "fused_edge_phase_win": 0,
    "fused_edge_phase_win_bwd": 0, "windowed_rect_conv": 0,
    "compact_accum": 0, "windowed_send_sum": 0}
# cylinder_flow on bucketed windowed hierarchies (depth 5, levels 0-2 with a
# residual sub-level, none from level 3 on), per forward: kernels 4 and 3
# in each of the 11 GMPs; kernel 1's level form in the 10 explicit convs
# (5 down, 5 up); kernel 9 four times per level with a residual: the down
# and up GMPs' residual edge phases and the down and up convs' residual
# messages. No TransOp, so no rect form; no compact residual, so no
# kernel 2. Per train step: the forward's; kernels 5, 6 and 7 once in each
# GMP's backward; kernel 1 in the 10 convs' adjoints; kernel 9 in the 6
# adjoint convs of levels 0-2 and in the backwards of the two residual
# gathers of each of their 6 GMPs: 12 + 6 + 12 = 30.
EXPECTED_CYLINDER_LAUNCHES = {
    "fused_edge_phase_win": 11, "fused_node_phase": 11, "windowed_conv": 10,
    "segment_sum_accum": 12, "windowed_rect_conv": 0, "compact_accum": 0,
    "segment_sum": 0}
EXPECTED_CYLINDER_TRAIN_LAUNCHES = {
    "fused_edge_phase_win": 11, "fused_edge_phase_win_bwd": 11,
    "fused_node_phase": 11, "fused_node_phase_bwd": 11,
    "windowed_send_sum": 11, "windowed_conv": 20, "segment_sum_accum": 30,
    "windowed_rect_conv": 0, "compact_accum": 0, "segment_sum": 0}
# deforming_plate on bucketed windowed hierarchies with world edges (depth
# 5; levels 0-2 of the group carry a residual sub-level, levels 3-5 none),
# per forward: kernel 13 (not kernel 4) and kernel 3 in each of the 11
# GMPs; kernel 1's level form in the 10 explicit convs of the latent rows;
# kernel 9 four times per level with a residual sub-level (the down and up
# GMPs' residual edge phases, v4's branch, and the down and up convs'
# residual messages): 12. The 3-wide world positions take the convs'
# generic `ell` form (narrow rows), no launch. Per train step: the
# forward's; kernel 13's backward, kernel 7 (on dpre) and kernel 6 once in
# each GMP's backward; kernel 1 in the 10 convs' adjoints; kernel 9 in the
# 6 adjoint convs of levels 0-2 and in the backwards of the two residual
# gathers of x (sender and receiver) of each of their 6 GMPs (the
# positions' gathers carry no gradient): 12 + 6 + 12 = 30. The cylinder's
# counts with kernel 13 for kernel 4.
EXPECTED_TETRA_LAUNCHES = {
    "fused_edge_phase_win_dyn": 11, "fused_edge_phase_win": 0,
    "fused_node_phase": 11, "windowed_conv": 10, "segment_sum_accum": 12,
    "windowed_rect_conv": 0, "compact_accum": 0, "segment_sum": 0}
EXPECTED_TETRA_TRAIN_LAUNCHES = {
    "fused_edge_phase_win_dyn": 11, "fused_edge_phase_win_dyn_bwd": 11,
    "fused_node_phase": 11, "fused_node_phase_bwd": 11,
    "windowed_send_sum": 11, "windowed_conv": 20, "segment_sum_accum": 30,
    "fused_edge_phase_win": 0, "fused_edge_phase_win_bwd": 0,
    "windowed_rect_conv": 0, "compact_accum": 0, "segment_sum": 0}
# The 5k airfoil with window="auto" (widths 256, 128, 128, 256, 128, 128,
# 128, 128 by level, nodes padded to 512 rows): the main path's kernels and
# counts of kernels 4, 3 and 1, but compact residuals at levels 0-5 (12
# GMPs) and on 10 transition operators (T0-T2 and T4 both ways, T3 and T5
# down), so kernel 2 runs 22 times per forward; per train step also in the
# 24 compact gathers' backwards and the 10 operators' adjoints: 56.
EXPECTED_AUTO_LAUNCHES = dict(EXPECTED_LAUNCHES, compact_accum=22)
EXPECTED_AUTO_TRAIN_LAUNCHES = dict(EXPECTED_TRAIN_LAUNCHES, compact_accum=56)
# The pallas surface's train step under remat with every GMP checkpointed
# (REMAT_MIN_NODES_SURFACE): the step's counts plus kernel 10 once more in
# each of the 15 GMPs' backwards, which replay their forward before they
# run theirs (kernel 8 runs in no forward of a GMP: its gathers select).
EXPECTED_SURFACE_REMAT_TRAIN_LAUNCHES = dict(
    EXPECTED_SURFACE_TRAIN_LAUNCHES, fused_aggregate_node_phase=30)
# The 5k airfoil on "fused4", per forward: levels 3, 4 and 5 hold 6.8, 10.0
# and 12.0 edge chunks per 128-node block, at least the gate's 6, so kernel
# 14 runs in their 6 GMPs (down and up) and kernel 4 in the other 9;
# otherwise the airfoil's counts (the same TransOps and compact residuals).
# Per train step: the forward's; kernel 14's backward in those 6 GMPs'
# backwards and kernel 5 in the other 9; kernels 6 and 7 in all 15; kernels
# 1 and 2 as the airfoil's.
EXPECTED_FUSED4_LAUNCHES = {
    "fused_edge_phase_win_k": 6, "fused_edge_phase_win": 9,
    "fused_node_phase": 15, "windowed_rect_conv": 14, "compact_accum": 16}
EXPECTED_FUSED4_TRAIN_LAUNCHES = {
    "fused_edge_phase_win_k": 6, "fused_edge_phase_win_k_bwd": 6,
    "fused_edge_phase_win": 9, "fused_edge_phase_win_bwd": 9,
    "fused_node_phase": 15, "fused_node_phase_bwd": 15,
    "windowed_rect_conv": 28, "compact_accum": 40, "windowed_send_sum": 15}
BWD_OUTPUTS = {
    "fused_edge_phase_win_bwd": ("dpre", "dxj", "dwf8", "dW", "db"),
    "fused_edge_phase_win_dyn_bwd": ("dpre", "dxj", "dwf8", "dwf_dyn",
                                     "dwf_nrm", "dW", "db"),
    "fused_node_phase_bwd": ("dx", "daggr", "dWa", "dWb", "db0", "dW", "db"),
    "windowed_send_sum": ("out",),
    "fused_edge_phase_bwd": ("dzi", "dxj", "dW", "db"),
    "fused_edge_mlp_aggregate_bwd": ("dpre", "dW", "db"),
    "fused_edge_phase_win_k_bwd": ("dpre", "dxj", "dwf8", "dW", "db"),
}
# Backward kernel vs plain on the card, every output judged on its own, as
# fractions of the RMS of the plain output: (largest error, RMS error).
# f32: both sides compute in true f32 and sum in other orders. bf16: both
# sides round the same operands; an f32 sum in another order flips a rare
# bf16 rounding (2^-8 relative of one element), and a flip that lands on a
# ReLU input near zero (many more in bf16, whose hidden activations are
# rounded) switches that unit off in one row, which moves the row's
# cotangent by a share of its scale and the weight gradients by a share of
# one row in ~5k. The node phase sees more of these than the edge phase
# (its cotangent is not rounded at the top, so the chain carries more of
# each flip). Each limit sits at least 3x above the error measured on an
# H100 (PERF.md); in bf16 a control that skips the rounding (the f32 kernel
# on the upcast inputs) must miss the limit in every output of kernels 5
# and 6. Kernel 7 rounds nothing in bf16 (bf16 rows add exactly in f32).
BWD_TOL = {
    ("fused_edge_phase_win_bwd", torch.float32): (2e-5, 2e-6),
    ("fused_node_phase_bwd", torch.float32): (2e-5, 2e-6),
    ("windowed_send_sum", torch.float32): (2e-5, 2e-6),
    ("fused_edge_phase_win_bwd", torch.bfloat16): (1e-1, 5e-4),
    ("fused_node_phase_bwd", torch.bfloat16): (1.0, 7e-3),
    ("windowed_send_sum", torch.bfloat16): (2e-5, 1e-6),
    # Kernel 13's backward: kernel 5's limits.
    ("fused_edge_phase_win_dyn_bwd", torch.float32): (2e-5, 2e-6),
    ("fused_edge_phase_win_dyn_bwd", torch.bfloat16): (1e-1, 5e-4),
    # Kernels 12 and 11's backwards: kernel 5's limits, but in f32 dxj's
    # row n_pad - 1 sums the last block's pad slots (the forward's reason).
    ("fused_edge_phase_bwd", torch.float32): (2e-4, 2e-6),
    ("fused_edge_phase_bwd", torch.bfloat16): (1e-1, 5e-4),
    ("fused_edge_mlp_aggregate_bwd", torch.float32): (2e-4, 2e-6),
    ("fused_edge_mlp_aggregate_bwd", torch.bfloat16): (1e-1, 5e-4),
    # Kernel 14's backward: kernel 5's function and limits.
    ("fused_edge_phase_win_k_bwd", torch.float32): (2e-5, 2e-6),
    ("fused_edge_phase_win_k_bwd", torch.bfloat16): (1e-1, 5e-4),
}
BWD_CONTROLS = ("fused_edge_phase_win_bwd", "fused_node_phase_bwd",
                "fused_edge_phase_win_dyn_bwd", "fused_edge_phase_bwd",
                "fused_edge_mlp_aggregate_bwd", "fused_edge_phase_win_k_bwd")
# The train step through the kernels against the plain path: the loss
# (relative), and each parameter's gradient as (largest error, RMS error)
# relative to its RMS. The plain step is the one under deterministic
# algorithms (`deterministic`): as the package runs it, its `index_add_`
# sums with atomics, in another order each run, and on the auto airfoil
# (phase 26) two such runs read 1.37e-3 RMS apart, past the f32 limit.
# f32: sums in other orders through 15 GMPs' backwards, and a ReLU input
# within rounding of zero can flip one slot's path: on an H100 the largest
# error read 3.5e-3 and 6.2e-3, the worst RMS error 8.3e-5 and 2.0e-4 in
# two runs of the same code. bf16: rounding
# flips spread through the whole step, so the gradients differ by a few
# percent in RMS (median 3.8e-2, worst 8.1e-2, one element 2.2x its
# tensor's RMS), about as far as the f32 and bf16 plain paths differ: this
# catches gross faults only (an unrelated gradient is off by ~1.4 in RMS);
# the per-kernel checks and their controls hold the rounding. Each step
# also runs the plain path with atomics and prints how far it lands from
# the deterministic one.
# The cylinder's f32 step (train_spread.py, 24 runs of the plain path on an
# H100) lands in one of four states (the likely cause, a ReLU input within
# rounding of zero, in PERF.md): the kernels read 4.2e-7 to 9.1e-4 RMS and
# at most 2.2e-2 from them, while kernel 9's sender form swapped for its
# receiver form reads 2.3e-2 RMS and 0.26 at most.
TRAIN_TOL = {torch.float32: (1e-5, 5e-2, 1e-3),
             torch.bfloat16: (1e-4, 10.0, 0.3)}
# The unreordered 5k airfoil's f32 step (airfoil_plain) is ill-conditioned
# at its frame: near-ties fall on one side or the other of the f32 sums, so
# its gradients land in one of a few states about 1e-3 of their RMS apart
# in RMS (median; up to 2.9e-3) and up to 1.1e-1 at most. The plain path
# lands in another state from run to run, and the deterministic kernels
# as far from it (H100, PERF.md). f32 limits of three times that spread;
# the loss agrees to 1e-7.
PLAIN_TRAIN_TOL = {torch.float32: (1e-5, 0.35, 1e-2),
                   torch.bfloat16: TRAIN_TOL[torch.bfloat16]}
# The wide airfoil's f32 step (phase 29, latent 256, four tail layers) is
# as ill-conditioned at its frame (`train_spread.py --case wide`, H100):
# over 12 draws in two runs the plain path with atomics read up to 1.57e-3
# of the RMS (worst gradient), 7.6e-2 at most and 7.0e-4 in median from
# the deterministic step, and the deterministic step on the frame one ulp up
# 1.54e-3, 7.3e-2 and 3.4e-4; the kernels read 1.29e-3, 4.7e-2 and
# 2.1e-4, within that spread. f32 limits of about twice the largest sound
# reading, and the median over the gradients of each one's RMS error over
# its RMS (`train_median`), which the few gradients a flipped ReLU moves
# do not carry. A fault dense in kernel 5's outputs passes none of them:
# its bf16 mode in the f32 step (`kernel5_fault("bf16")`, the phase's
# control) reads 1.75e-1, 7.9 and 6.8e-3. Kernel 5's dpre alone rounded to
# bf16 moves the kernels' own step by 1.19e-3, 2.4e-2 and 7.9e-5, inside
# the spread: a fault that small is held by the per-kernel check (kernel
# 5's bf16 control), not by the step.
WIDE_TRAIN_TOL = {torch.float32: (1e-5, 0.15, 3e-3),
                  torch.bfloat16: TRAIN_TOL[torch.bfloat16]}
WIDE_TRAIN_MEDIAN = {torch.float32: 1.5e-3}
TRAIN_GATE, TRAIN_UPDATES = 2, 4
# The batch axis on a shared hierarchy (the airfoil_batch, flag_batch and
# fused4_batch paths, BATCH_PATHS): the kernels checked at BATCH_CHECK
# samples; serving at BATCH_SERVE (the README's batched-serving row);
# training at BATCH_TRAIN (`bsms_gnn_tpu/configs/default.yaml`'s `batch`).
# Every batch is B distinct seeded frames over the one hierarchy.
BATCH_CHECK, BATCH_SERVE, BATCH_TRAIN = 3, 16, 48
# The timed repeats of each path's train steps and batched forwards,
# whose median is printed: three keep the whole script within its time
# limit; two of the train steps at a batch (each hundreds of ms, and the
# 16k surface's under remat, f32 only, 1.5 s), which paid for phase 29.
TIMED_REPEATS = 3
BATCH_TIMED_REPEATS = 2
# The CLI phase (run_cli_case): the warmup gate's steps, the run's steps
# (it takes CLI_STEPS + 1), the checkpoint interval (the resumed run
# starts there), the step whose launches are counted and the one
# profiled, and the longest wait for a batch in seconds.
CLI_GATE, CLI_STEPS, CLI_SAVE = 2, 8, 4
CLI_COUNT_STEP, CLI_PROFILE_STEP, CLI_BATCH_TIMEOUT = 5, 7, 300
# The `ell` paths (ELL_PATHS) run on the layouts the JAX CLI builds: window
# 0, edge_block 128, no Morton reorder (its ingest reorders only when the
# window is set). inflating_font's meshes: three Fibonacci spheres of one
# size group around the ~16k nodes of the paper's InflatingFont timing
# (BASELINE.md), (nodes, seed), the second served.
ELL_EDGE_BLOCK = 128
INFLATING_MESHES = ((15_500, 1), (16_000, 0), (16_500, 2))
# An `ell` path trains at BATCH_TRAIN, or at the largest batch whose step
# the B = 1 step's peak (the larger of ell's and segment's, f32 and bf16)
# times B keeps within this share of the card's memory.
ELL_TRAIN_MEM_SHARE = 0.7
# The pallas surface (surface_batch) trains at 16, not 48: its B = 1 step
# holds 2,633 / 3,106 MiB at its peak (f32 / bf16, PERF.md §5), and the
# batched peak is about that times B: ~126 / 149 GB at 48, more than the
# card's 80 GB; ~42 / 50 GB at 16. (The fused surface, 669 / 533 MiB,
# trains at 48: ~32 / 26 GB.)
BATCH_TRAIN_SURFACE = 16
# ... and at BATCH_TRAIN under remat (`ModelConfig.remat`): every GMP
# checkpointed. The sphere's deep levels keep many edges (level 6: 256 rows
# but 23,680 slots, level 0 97,920), so its GMPs' edge activations, most
# of the step's memory, do not halve with the rows; a threshold on the rows
# (`remat_min_nodes`) would keep most of them.
REMAT_MIN_NODES_SURFACE = 0
# The arguments of each kernel of the batched path that carry the batch
# (the rest are the layout, the weights and the compute dtype), and the
# outputs of its backward that are per row (the others are weight
# gradients, summed over the batch).
BATCHED_ARGS = {"windowed_rect_conv": (1,), "compact_accum": (1, 2),
                "windowed_conv": (1,), "segment_sum_accum": (1, 2),
                "fused_edge_phase_win": (1, 2), "fused_node_phase": (0, 1),
                "fused_edge_phase_win_bwd": (1, 2, 6),
                "fused_node_phase_bwd": (0, 1, 3), "windowed_send_sum": (1,),
                "fused_edge_phase_win_dyn": (1, 2, 3),
                "fused_edge_phase_win_dyn_bwd": (1, 2, 3, 9),
                "fused_edge_phase_win_k": (1, 2),
                "fused_edge_phase_win_k_bwd": (1, 2, 6),
                "segment_sum": (1,), "fused_aggregate_node_phase": (1, 2),
                "fused_edge_phase": (1, 2), "fused_edge_phase_bwd": (1, 2, 5),
                "fused_edge_mlp_aggregate": (1,),
                "fused_edge_mlp_aggregate_bwd": (1, 4)}
ROW_OUTPUTS = {"fused_edge_phase_win_bwd": ("dpre", "dxj"),
               "fused_node_phase_bwd": ("dx", "daggr"),
               "windowed_send_sum": ("out",),
               "fused_edge_phase_win_dyn_bwd": ("dpre", "dxj"),
               "fused_edge_phase_win_k_bwd": ("dpre", "dxj"),
               "fused_edge_phase_bwd": ("dzi", "dxj"),
               "fused_edge_mlp_aggregate_bwd": ("dpre",)}
# Kernel 2's input with a long list: level 0's residual plus a star of this
# many edges onto one receiver (`star_resid`), whose list of about 50 rows
# then takes the gather's long path in two pieces. Its f32 sum, in another
# order than `index_add_`'s atomics, differs most: with 100 edges it read
# 8.2e-6 of the RMS on an H100, too close to TOL's 2e-5; about half as many
# rows keep it near a third of it.
STAR_EDGES = 40
# A world stream wider than kernel 13 takes (`fused_gmp_dyn.MAX_WD`, 4): the
# fused method routes such a GMP to v1 (kernel 11) on a windowed level.
WIDE_WD = 6
# That GMP against its plain route, as fractions of the RMS of the plain
# output or gradient: (largest error, RMS error). The output as kernel 11's
# (its row n_pad - 1 sums the last block's pad slots, in another order in
# the plain version); each gradient as the f32 train step's (TRAIN_TOL: a
# ReLU input within rounding of zero can flip one slot's unit).
WIDE_TOL = {"output": (2e-4, 2e-6), "grad": (5e-2, 1e-3)}
# The kernels whose every listed shape is timed, not only the first (the
# pallas path times all of its own): the row-ordered gathers of kernels 2,
# 7 and 9, whose long lists or forms only their later shapes reach, and the
# kernels that walk a level's tiles or fill the card at every level, whose
# later shapes are the levels of fewer tiles.
EVERY_SHAPE_TIMED = ("compact_accum", "windowed_send_sum",
                     "segment_sum_accum", "fused_edge_phase_win",
                     "fused_edge_phase_win_bwd",
                     "fused_edge_mlp_aggregate_bwd", "fused_node_phase",
                     "fused_node_phase_bwd", "fused_edge_phase_win_dyn_bwd",
                     "fused_edge_phase_bwd", "fused_edge_phase_win_k",
                     "fused_edge_phase_win_dyn", "fused_edge_phase_win_k_bwd",
                     "fused_edge_phase", "fused_edge_mlp_aggregate")
# The kernels on a tile walk (`csrc/edge_fwd_tiles.cuh`,
# `csrc/edge_bwd_tiles.cuh`): two calls on the same inputs must agree bit
# for bit (the walk's grid and its order of sums depend only on the card
# and the layout), and their later shapes are levels of fewer live tiles:
# kernels 4 and 5 at every level of the airfoil below 0 (6 holds 2 live
# slots, 7 none), kernel 11 at every level of the fused surface below 0
# (its backward at level 7), kernel 13 (forward and backward) at every
# level of the flag below 0, kernel 12 (forward and backward) at every
# level of the unwindowed airfoil below 0, kernel 14 (forward and
# backward) at the `fused4` airfoil's gated levels after its first (4 and
# 5). The bf16
# controls run at every shape, and are skipped only for an output that the
# plain version leaves all zero. Kernels 3 and 6 (`csrc/node_mlp.cu`,
# `csrc/node_mlp_bwd.cu`, a cluster of CTAs per 64-row tile) are checked
# the same way at every level, every row of their outputs filled
# (`NODE_CLUSTERS`).
TILE_WALKS = ("fused_edge_phase_win", "fused_edge_phase_win_bwd",
              "fused_edge_mlp_aggregate_bwd", "fused_edge_phase_win_dyn_bwd",
              "fused_edge_phase_bwd", "fused_edge_phase_win_k",
              "fused_edge_phase_win_dyn", "fused_edge_phase_win_k_bwd",
              "fused_edge_phase", "fused_edge_mlp_aggregate")
NODE_CLUSTERS = ("fused_node_phase", "fused_node_phase_bwd")
# Kernels 8, 9 and 10 sum in the row-ordered gather's order
# (`csrc/row_gather.cuh`), fixed by the layout's tables: checked twice for
# bit-identical outputs at every level of the pallas surface (and kernel 8
# on T0-T2's operators), kernel 10 also against kernel 3 on kernel 8's
# aggregate (`check_agg_identity`); kernel 9 at every residual sub-level of
# the cylinder and on the forced empty one, its store form also bit for bit
# against the call on zeros.
ROW_ORDERED = ("segment_sum", "fused_aggregate_node_phase",
               "segment_sum_accum")
WALK_LEVELS = {"fused_edge_phase_win": (1, 2, 3, 4, 5, 6, 7),
               "fused_edge_phase_win_bwd": (1, 2, 3, 4, 5, 6, 7),
               "fused_edge_mlp_aggregate_bwd": (7,),
               "fused_edge_phase_win_dyn": (1, 2, 3, 4, 5),
               "fused_edge_phase_win_dyn_bwd": (1, 2, 3, 4, 5),
               "fused_edge_phase_bwd": (1, 2, 3, 4, 5, 6, 7),
               "fused_edge_phase": (1, 2, 3, 4, 5, 6, 7),
               "fused_edge_mlp_aggregate": (1, 2, 3, 4, 5, 6, 7),
               "fused_node_phase": (1, 2, 3, 4, 5, 6, 7),
               "fused_node_phase_bwd": (1, 2, 3, 4, 5, 6, 7)}
# The seed of the generator that draws level l's inputs of each kernel
# checked at every level (WALK_SEED[name] + l), apart from the generator of
# level 0, so that adding a level moves no other kernel's inputs.
WALK_SEED = {"fused_edge_phase_win": 200, "fused_edge_phase_win_bwd": 100,
             "fused_edge_mlp_aggregate_bwd": 100, "fused_node_phase_bwd": 300,
             "fused_edge_phase_win_dyn_bwd": 400, "fused_node_phase": 500,
             "fused_edge_phase_bwd": 600, "fused_edge_phase_win_k": 700,
             "fused_edge_phase_win_dyn": 800,
             "fused_edge_phase_win_k_bwd": 900, "fused_edge_phase": 1000,
             "fused_edge_mlp_aggregate": 1100, "segment_sum": 1200,
             "fused_aggregate_node_phase": 1300}
# The seed of the generator that draws kernel 9's inputs at residual
# sub-level l > 0 (ACCUM_SEED + l), kernel 7's at a case's extra level l
# (SEND_SEED + l), and kernels 1's and 2's at the auto widths (AUTO_SEED).
ACCUM_SEED = 1500
SEND_SEED = 1600
AUTO_SEED = 1700
# The wide airfoil (phase 29): the model of the synthetic-airfoil group
# through the port's `load_config` with these overrides, as a user would
# ask for it: phase 2's model with latent 256 and four tail layers. Its
# kernels 1 and 2 off phase 3's shapes are drawn from WIDE_SEED.
WIDE_OVERRIDES = ("datasets=synthetic_airfoil", "model.aggregation=fused",
                  "model.latent_dim=256", "model.hidden_layer=4")
WIDE_SEED = 1800
# The tail layers of `check_deep_tails` at C = 128 (past the three of every
# shipped model group) and the seed of its weights.
DEEP_TAIL = 4
DEEP_SEED = 1900
# The kernels whose card check, on a miss, prints the smallest |ReLU
# input| over the rows that miss (`relu_margin`): a draw can put a ReLU
# input within rounding of zero, where the kernel and the plain version,
# summing in other orders, take the ReLU on different sides.
RELU_DIAGNOSED = ("fused_edge_phase_win", "fused_edge_phase_win_bwd",
                  "fused_edge_phase_win_dyn", "fused_edge_phase_win_dyn_bwd",
                  "fused_edge_phase_win_k", "fused_edge_phase_win_k_bwd",
                  "fused_node_phase", "fused_node_phase_bwd")
# The plate's dense levels: a check of kernel 13 there computes up to 72M
# ReLU inputs (190k slots, 128 units, 3 layers), so almost any draw puts one
# within f32 rounding of its kink, where the kernel and the plain version,
# summing in other orders, can take it on different sides (on an H100 a
# unit at |z| = 7.5e-9 at level 2 moved one dpre row by 0.89 of the RMS,
# its receiver's dxj row and dwf8 by 7.6e-4 of theirs). On a `dense` case
# kernel 13's inputs are therefore drawn again where they feed such a unit
# (`clear_kinks`): every xwi row that sends to a covered slot with a ReLU
# input within KINK_MARGIN of its layer's RMS from zero is drawn anew,
# until none is left; the kernel is then held at the full limits.
KINK_MARGIN, KINK_ROUNDS, KINK_SEED = 1e-6, 20, 1800
# The wide airfoil (phase 29) and the deep-tail checks hold kernels 3-6 at
# four tail layers, at C = 256 on 2.5× the ReLU inputs a unit of width
# brings: on an H100 a kernel 6 check at the wide airfoil's level 0 missed
# on one row fed by a unit at |z| = 7.0e-9. Their f32 inputs are cleared
# the same way (`kink_free` on a case with `clear_kinks`; kernels 3 and 6
# draw the node rows anew, kernels 4 and 5 the sender rows), as are the
# drawn samples of their batched checks.
# bf16 moves ReLU inputs further: a hidden activation that the two sides'
# f32 sums put on either side of a bf16 rounding step moves every unit it
# feeds by that step times a weight, ~1e-4, too often for any draw to
# avoid (on an H100 one dpre row of level 2 read 0.11 of the RMS, the limit
# 0.1, fed by a unit at z = 1.2e-4). On a `dense` case each row of kernel
# 13's backward's dpre that misses must be the plain version's row with
# the ReLU decision of one of its units taken on the other side, within
# the limits (`verify_flips`): a unit whose |z| is within one rounding
# step of the dtype (2^-8 in bf16) of its own input scale, the sum of the
# magnitudes of the terms that make z (`input_scales`); at most
# FLIP_ROWS_MAX rows so, and the other rows pass both limits.
FLIP_ROWS_MAX = 4
# On a `dense` case (the plate) kernel 9's feature rows are zero on the
# residual sub-levels' pad slots (the forced empty one keeps its draws).
# Every pad slot adds onto row n_pad - 1, which no real node reads: the
# plate's pad rows sum 2,300-8,800 slots a sample, against the cylinder's
# hundreds for which TOL was set, and there the f32 order alone (the plain
# version's atomics) read up to 2.13e-4 of the RMS against TOL's 2e-4 on
# an H100 (the union's level 0; B = 1 up to 1.14e-4). The real rows, lists
# of over 32 slots at levels 1 and 2 among them, keep their draws and TOL.
# The rows of each backward output that `relu_margin` maps to the input
# rows feeding them (an output not named: every input row).
ROW_KIND = {"dpre": "inputs", "dx": "inputs", "daggr": "inputs",
            "dxj": "receivers"}
_CSRC = "bsms_gnn_tpu_torch/ops/kernels/csrc/"
_PALLAS = "bsms_gnn_tpu/ops/pallas/"
# name → (source, the TPU kernel it replaces, the CUDA kernels one call
# launches). The tile walks (kernels 4, 5 and 11-14, 12's, 13's and 14's
# backwards) add the receiver gather (the aggregate, dxj); kernels 5, 6 and
# 11-14's backwards the pass that sums the weight-gradient partials.
# Kernels 1, 2, 7 and 15 are one launch each (the row-ordered gather).
KERNEL_META = {
    "fused_edge_phase_win": (
        _CSRC + "fused_gmp.cu", _PALLAS + "fused_gmp.py:568",
        ("fused_edge_phase_win_kernel", "recv_gather_kernel")),
    "fused_node_phase": (
        _CSRC + "node_mlp.cu", _PALLAS + "node_mlp.py:107",
        ("fused_node_phase_kernel",)),
    "windowed_rect_conv": (
        _CSRC + "windowed.cu", _PALLAS + "windowed.py:111",
        ("windowed_gather_kernel",)),
    "compact_accum": (
        _CSRC + "compact_resid.cu", _PALLAS + "compact_resid.py:73",
        ("compact_gather_kernel",)),
    "fused_edge_phase_win_bwd": (
        _CSRC + "fused_gmp_bwd.cu", _PALLAS + "fused_gmp.py:607",
        ("fused_edge_phase_win_bwd_kernel", "recv_gather_kernel",
         "grad_sum_kernel")),
    "fused_node_phase_bwd": (
        _CSRC + "node_mlp_bwd.cu", _PALLAS + "node_mlp.py:125",
        ("fused_node_phase_bwd_kernel", "grad_sum_kernel")),
    "windowed_send_sum": (
        _CSRC + "windowed_send.cu", _PALLAS + "windowed.py:205",
        ("send_gather_kernel",)),
    "segment_sum": (
        _CSRC + "segment_sum.cu", _PALLAS + "segment_sum.py:84",
        ("segment_sum_kernel",)),
    # Kernel 10 launches one of its two designs' kernels
    # (`fused_aggregate_node_phase_block_kernel` or `_cluster_kernel`).
    "fused_aggregate_node_phase": (
        _CSRC + "agg_node.cu", _PALLAS + "agg_node.py:74",
        ("fused_aggregate_node_phase_",)),
    "fused_edge_phase_win_dyn": (
        _CSRC + "fused_gmp_dyn.cu", _PALLAS + "fused_gmp.py:664",
        ("fused_edge_phase_win_dyn_kernel", "recv_gather_kernel")),
    "fused_edge_phase_win_dyn_bwd": (
        _CSRC + "fused_gmp_dyn_bwd.cu", _PALLAS + "fused_gmp.py:706",
        ("fused_edge_phase_win_dyn_bwd_kernel", "recv_gather_kernel",
         "grad_sum_kernel")),
    "fused_edge_phase": (
        _CSRC + "fused_gmp_stream.cu", _PALLAS + "fused_gmp.py:376",
        ("fused_edge_phase_kernel", "recv_gather_kernel")),
    "fused_edge_phase_bwd": (
        _CSRC + "fused_gmp_stream_bwd.cu", _PALLAS + "fused_gmp.py:407",
        ("fused_edge_phase_bwd_kernel", "recv_gather_kernel",
         "grad_sum_kernel")),
    "fused_edge_mlp_aggregate": (
        _CSRC + "fused_gmp_stream.cu", _PALLAS + "fused_gmp.py:230",
        ("fused_edge_mlp_aggregate_kernel", "recv_gather_kernel")),
    "fused_edge_mlp_aggregate_bwd": (
        _CSRC + "fused_gmp_stream_bwd.cu", _PALLAS + "fused_gmp.py:260",
        ("fused_edge_mlp_aggregate_bwd_kernel", "grad_sum_kernel")),
    # Kernel 1's level form (`windowed_conv_raw`, the same `_get_call`).
    "windowed_conv": (
        _CSRC + "windowed.cu", _PALLAS + "windowed.py:328",
        ("windowed_gather_kernel",)),
    "segment_sum_accum": (
        _CSRC + "segment_sum_accum.cu", _PALLAS + "segment_sum.py:176",
        ("segment_sum_accum_kernel",)),
    "fused_edge_phase_win_k": (
        _CSRC + "fused_gmp_k.cu", _PALLAS + "fused_gmp.py:1369",
        ("fused_edge_phase_win_k_kernel", "recv_gather_kernel")),
    "fused_edge_phase_win_k_bwd": (
        _CSRC + "fused_gmp_k_bwd.cu", _PALLAS + "fused_gmp.py:1639",
        ("fused_edge_phase_win_k_bwd_kernel", "recv_gather_kernel",
         "grad_sum_kernel")),
    "subwin_conv": (
        _CSRC + "subwin_conv.cu", "benchmarks/v6_prototype.py:150",
        ("subwin_gather_kernel",)),
}


class SmokeFailure(Exception):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


@functools.lru_cache(maxsize=None)
def kernel_modules():
    """name → (the wrapper that counts its kernel's launches, the plain
    version): the four forward kernels and the three backward kernels of
    the fused path, then the two of the pallas path, then kernel 13's
    forward and backward (world edges on the fused path), then kernels 12
    and 11, forward and backward (the fused path on unwindowed levels),
    then kernel 1's level form and kernel 9 (bucketed hierarchies), then
    kernel 14, forward and backward (`"fused4"`), and kernel 15 (the v6
    benchmark)."""
    from bsms_gnn_tpu_torch.ops.kernels import (
        agg_node,
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
    return {
        "fused_edge_phase_win": (fused_gmp.fused_edge_phase_win_fwd,
                                 fused_gmp.fused_edge_phase_win_plain),
        "fused_node_phase": (node_mlp.fused_node_phase_fwd,
                             node_mlp.fused_node_phase_plain),
        "windowed_rect_conv": (windowed.windowed_rect_conv,
                               windowed.windowed_rect_conv_plain),
        "compact_accum": (compact_resid.compact_accum_raw,
                          compact_resid.compact_accum_plain),
        "fused_edge_phase_win_bwd": (fused_gmp.fused_edge_phase_win_bwd,
                                     fused_gmp.fused_edge_phase_win_bwd_plain),
        "fused_node_phase_bwd": (node_mlp.fused_node_phase_bwd,
                                 node_mlp.fused_node_phase_bwd_plain),
        "windowed_send_sum": (windowed.windowed_send_sum,
                              windowed.windowed_send_sum_plain),
        "segment_sum": (segment_sum.segment_sum_raw,
                        segment_sum.segment_sum_plain),
        "fused_aggregate_node_phase": (
            agg_node.fused_aggregate_node_phase_fwd,
            agg_node.fused_aggregate_node_phase_plain),
        "fused_edge_phase_win_dyn": (
            fused_gmp_dyn.fused_edge_phase_win_dyn_fwd,
            fused_gmp_dyn.fused_edge_phase_win_dyn_plain),
        "fused_edge_phase_win_dyn_bwd": (
            fused_gmp_dyn.fused_edge_phase_win_dyn_bwd,
            fused_gmp_dyn.fused_edge_phase_win_dyn_bwd_plain),
        "fused_edge_phase": (fused_gmp_stream.fused_edge_phase_fwd,
                             fused_gmp_stream.fused_edge_phase_plain),
        "fused_edge_phase_bwd": (fused_gmp_stream.fused_edge_phase_bwd,
                                 fused_gmp_stream.fused_edge_phase_bwd_plain),
        "fused_edge_mlp_aggregate": (
            fused_gmp_stream.fused_edge_mlp_aggregate_fwd,
            fused_gmp_stream.fused_edge_mlp_aggregate_plain),
        "fused_edge_mlp_aggregate_bwd": (
            fused_gmp_stream.fused_edge_mlp_aggregate_bwd,
            fused_gmp_stream.fused_edge_mlp_aggregate_bwd_plain),
        "windowed_conv": (windowed.windowed_conv, windowed.windowed_conv_plain),
        "segment_sum_accum": (segment_sum_accum.segment_sum_accum_raw,
                              segment_sum_accum.segment_sum_accum_plain),
        "fused_edge_phase_win_k": (fused_gmp_k.fused_edge_phase_win_k_fwd,
                                   fused_gmp_k.fused_edge_phase_win_k_plain),
        "fused_edge_phase_win_k_bwd": (
            fused_gmp_k.fused_edge_phase_win_k_bwd,
            fused_gmp_k.fused_edge_phase_win_k_bwd_plain),
        "subwin_conv": (subwin_conv.subwin_conv, subwin_conv.subwin_conv_plain),
    }


def reset_counts():
    from bsms_gnn_tpu_torch.ops import transition

    for fn, _ in kernel_modules().values():
        fn.launches = 0
    kernel_modules()["segment_sum"][0].narrow_calls = 0
    transition.narrow_apply.calls = 0


def narrow_calls():
    """The plain calls for narrow widths, counted apart from launches:
    (kernel 8's on unwindowed operators, the windowed operators'
    `narrow_apply`)."""
    from bsms_gnn_tpu_torch.ops import transition

    return (kernel_modules()["segment_sum"][0].narrow_calls,
            transition.narrow_apply.calls)


def read_counts(names):
    return {k: kernel_modules()[k][0].launches for k in names}


@contextlib.contextmanager
def plain_path():
    """Route the model's kernel calls, forward and backward, to the plain
    versions on the same device, for the whole-model comparisons (the
    package itself takes the plain versions only for CPU tensors)."""
    from bsms_gnn_tpu_torch.ops import message, scatter, transition
    from bsms_gnn_tpu_torch.ops.kernels import (
        agg_node,
        compact_resid,
        fused_gmp,
        fused_gmp_dyn,
        fused_gmp_k,
        fused_gmp_stream,
        node_mlp,
        segment_sum_accum,
    )

    mods = kernel_modules()
    targets = [(agg_node, "fused_aggregate_node_phase_fwd",
                "fused_aggregate_node_phase"),
               (agg_node, "segment_sum_raw", "segment_sum"),
               (agg_node, "fused_node_phase_bwd", "fused_node_phase_bwd"),
               (scatter, "segment_sum_raw", "segment_sum"),
               (transition, "segment_sum_raw", "segment_sum"),
               (fused_gmp, "fused_edge_phase_win_fwd", "fused_edge_phase_win"),
               (fused_gmp, "fused_edge_phase_win_bwd",
                "fused_edge_phase_win_bwd"),
               (fused_gmp, "windowed_send_sum", "windowed_send_sum"),
               (fused_gmp_k, "fused_edge_phase_win_k_fwd",
                "fused_edge_phase_win_k"),
               (fused_gmp_k, "fused_edge_phase_win_k_bwd",
                "fused_edge_phase_win_k_bwd"),
               (fused_gmp_dyn, "fused_edge_phase_win_dyn_fwd",
                "fused_edge_phase_win_dyn"),
               (fused_gmp_dyn, "fused_edge_phase_win_dyn_bwd",
                "fused_edge_phase_win_dyn_bwd"),
               (fused_gmp_dyn, "windowed_send_sum", "windowed_send_sum"),
               (fused_gmp_stream, "fused_edge_phase_fwd", "fused_edge_phase"),
               (fused_gmp_stream, "fused_edge_phase_bwd",
                "fused_edge_phase_bwd"),
               (fused_gmp_stream, "fused_edge_mlp_aggregate_fwd",
                "fused_edge_mlp_aggregate"),
               (fused_gmp_stream, "fused_edge_mlp_aggregate_bwd",
                "fused_edge_mlp_aggregate_bwd"),
               (node_mlp, "fused_node_phase_fwd", "fused_node_phase"),
               (node_mlp, "fused_node_phase_bwd", "fused_node_phase_bwd"),
               (compact_resid, "compact_accum_raw", "compact_accum"),
               (transition, "compact_accum_raw", "compact_accum"),
               (transition, "windowed_rect_conv", "windowed_rect_conv"),
               (message, "windowed_conv", "windowed_conv"),
               (message, "compact_accum_raw", "compact_accum"),
               (message, "segment_sum_raw", "segment_sum"),
               (message, "segment_sum_accum_raw", "segment_sum_accum"),
               (scatter, "segment_sum_accum_raw", "segment_sum_accum"),
               (segment_sum_accum, "segment_sum_accum_raw",
                "segment_sum_accum")]
    saved = [(m, attr, getattr(m, attr)) for m, attr, _ in targets]
    try:
        for m, attr, name in targets:
            setattr(m, attr, mods[name][1])
        yield
    finally:
        for m, attr, f in saved:
            setattr(m, attr, f)


@contextlib.contextmanager
def deterministic(seen=None):
    """PyTorch's deterministic algorithms: `index_add_` on a CUDA tensor
    sums each row's slots in a fixed order (sorted by row, stably) instead
    of with atomics, so a plain step gives the same gradients on every run.
    An op with no deterministic form warns and runs as it would; each
    warning's text is added to `seen` where it is given."""
    import warnings

    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
        if seen is not None:
            seen.update(str(w.message).splitlines()[0] for w in caught)
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def fill_normalizers(sim, node_in, mask, rng):
    """Normalizer statistics from a few seeded synthetic frames around the
    input, so std is not the 1e-8 floor."""
    from bsms_gnn_tpu_torch.models.normalizer import normalizer_accumulate
    from bsms_gnn_tpu_torch.models.simulator import split_node_input

    out_dim = sim.cfg.out_dim
    latent, _, _ = split_node_input(node_in, sim.cfg.pos_dim)
    for _ in range(4):
        noise = torch.from_numpy(
            rng.normal(0.0, 0.3, (node_in.shape[0], out_dim)).astype(np.float32)
        ).to(node_in.device)
        frame = latent + torch.cat([noise, torch.zeros_like(mask)], dim=-1)
        sim.norm_in = normalizer_accumulate(sim.norm_in, frame, mask)
        sim.norm_out = normalizer_accumulate(sim.norm_out, 0.1 * noise, mask)


def build_case(device, plain=False, aggregation="fused", auto=False,
               wide=False):
    """The bench configuration: mesh, hierarchy on `device`, model with
    seeded weights and filled normalizers, one input frame and mask. With
    `plain`, method_sweep.py's fused-v2 airfoil instead: the mesh as built
    (not reordered) and the default unwindowed hierarchy (edge_block 128),
    so the fused method runs kernel 12. `aggregation="fused4"`: the same
    windowed case on the K-way interleaved method (kernel 14), with a twin
    model on `fused` that holds the same weights and normalizers. With
    `auto`, the hierarchy comes from `load_or_build_hierarchy(window=
    "auto")` (in a temporary directory): each level's width as the JAX
    package's tuner picks it, the nodes padded to 512 rows. With `wide`,
    the model comes from `load_config(WIDE_OVERRIDES)` (latent 256, four
    tail layers), which must be phase 2's model in every other field."""
    import tempfile
    from dataclasses import replace

    from bsms_gnn_tpu_torch.config import Config, ModelConfig
    from bsms_gnn_tpu_torch.data.synthetic import make_graded_airfoil_mesh
    from bsms_gnn_tpu_torch.graph.hierarchy import (
        build_hierarchy,
        load_or_build_hierarchy,
        to_device,
    )
    from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
    from bsms_gnn_tpu_torch.graph.order import reorder_mesh
    from bsms_gnn_tpu_torch.models.simulator import Simulator

    rng = np.random.default_rng(0)
    pos, cells, node_type = make_graded_airfoil_mesh(N_NODES, rng)
    layout = {}
    if not plain:
        pos, cells, (node_type,), _ = reorder_mesh(pos, cells, (node_type,))
        layout = dict(edge_block=EDGE_BLOCK, window=WINDOW)
    edges = to_flat_edge(cells, "tri")
    t0 = time.perf_counter()
    if auto:
        with tempfile.TemporaryDirectory() as tmp:
            h = load_or_build_hierarchy(
                tmp, "airfoil", edges, DEPTH, pos.shape[0],
                pos.astype(np.float64), edge_block=EDGE_BLOCK, window="auto")
    else:
        h = build_hierarchy(edges, DEPTH, pos.shape[0],
                            pos.astype(np.float64), **layout)
    build_s = time.perf_counter() - t0
    hd = to_device(h, device)

    def config(**kw):
        if wide:
            from bsms_gnn_tpu_torch.config import load_config

            return Config(model=replace(
                load_config(list(WIDE_OVERRIDES)).model, **kw))
        return Config(model=ModelConfig(latent_dim=128, hidden_layer=3,
                                        unet_depth=DEPTH,
                                        aggregation=aggregation, **kw))

    cfg = config().model
    if wide:
        base = ModelConfig(latent_dim=128, hidden_layer=3, unet_depth=DEPTH,
                           aggregation=aggregation)
        require(replace(cfg, latent_dim=128, hidden_layer=3) == base,
                f"load_config{WIDE_OVERRIDES} is not phase 2's model but "
                f"for its width and depth: {cfg}")
        print(f"[airfoil wide] load_config{WIDE_OVERRIDES}: {cfg}")
    sim = Simulator(cfg, torch.Generator().manual_seed(0), device=device)
    n, n_pad = pos.shape[0], h.levels[0].n_pad_nodes
    node_in = np.zeros((n_pad, cfg.out_dim + cfg.pos_dim + 1), np.float32)
    node_in[:n, :3] = rng.standard_normal((n, 3))
    node_in[:n, 3:5] = pos
    node_in[:n, 5] = node_type[:, 0]
    mask = np.zeros((n_pad, 1), np.float32)
    mask[:n, 0] = node_type[:, 0] == 0
    node_in = torch.from_numpy(node_in).to(device)
    mask = torch.from_numpy(mask).to(device)
    fill_normalizers(sim, node_in, mask, rng)
    if plain:
        return dict(label="airfoil 5k plain", h=h, hd=hd, cfg=cfg, sim=sim,
                    config=config, node_in=node_in, mask=mask, n=n,
                    build_s=build_s, expected=EXPECTED_PLAIN_LAUNCHES,
                    expected_train=EXPECTED_PLAIN_TRAIN_LAUNCHES,
                    narrow=(0, 0), train_tol=PLAIN_TRAIN_TOL,
                    timed=("fused_edge_phase", "fused_edge_phase_bwd"))
    if auto:
        widths = [g.window for g in h.levels]
        print(f"[airfoil auto] window='auto' widths by level: {widths} "
              f"(phase 2: {[WINDOW] * (DEPTH + 1)}); N_pad "
              f"{[g.n_pad_nodes for g in h.levels]}")
        require(any(w != WINDOW for w in widths),
                "auto chose WINDOW at every level")
        return dict(label="airfoil 5k auto", h=h, hd=hd, cfg=cfg, sim=sim,
                    config=config, node_in=node_in, mask=mask, n=n,
                    build_s=build_s, expected=EXPECTED_AUTO_LAUNCHES,
                    expected_train=EXPECTED_AUTO_TRAIN_LAUNCHES, narrow=(0, 0),
                    auto=True, send_levels=[l for l, w in enumerate(widths)
                                            if w != WINDOW])
    if wide:
        return dict(label="airfoil 5k wide", h=h, hd=hd, cfg=cfg, sim=sim,
                    config=config, node_in=node_in, mask=mask, n=n,
                    build_s=build_s, expected=EXPECTED_LAUNCHES,
                    expected_train=EXPECTED_TRAIN_LAUNCHES, narrow=(0, 0),
                    every_op=True, send_levels=range(1, DEPTH + 1),
                    clear_kinks=True, train_tol=WIDE_TRAIN_TOL,
                    train_median=WIDE_TRAIN_MEDIAN)
    if aggregation == "fused4":
        twin = Simulator(replace(cfg, aggregation="fused"), device=device)
        twin.load_state_dict(sim.state_dict())
        twin.norm_in, twin.norm_out = sim.norm_in, sim.norm_out
        return dict(label="airfoil 5k fused4", h=h, hd=hd, cfg=cfg, sim=sim,
                    config=config, node_in=node_in, mask=mask, n=n,
                    build_s=build_s, expected=EXPECTED_FUSED4_LAUNCHES,
                    expected_train=EXPECTED_FUSED4_TRAIN_LAUNCHES,
                    narrow=(0, 0), twin=twin)
    return dict(label="airfoil 5k", h=h, hd=hd, cfg=cfg, sim=sim,
                config=config, node_in=node_in, mask=mask, n=n,
                build_s=build_s, expected=EXPECTED_LAUNCHES,
                expected_train=EXPECTED_TRAIN_LAUNCHES, narrow=(0, 0))


def build_surface_case(device, aggregation="pallas"):
    """bench.py's second point, `_build("surface", 16000, 7)`, from the
    port's own copies: `make_sphere_mesh(16000, default_rng(0))`, the
    default unwindowed hierarchy of depth 7, the inflating-font model on
    the pallas method (or on `aggregation`: "fused" is method_sweep.py's
    fused-v2 row, kernel 11); world positions 1.05 · the mesh positions,
    the mask the normal nodes. Weights from
    `torch.Generator().manual_seed(0)`. The train frames are frames 0 and 1
    of `generate_inflating_trajectory` on the same mesh."""
    from bsms_gnn_tpu_torch.config import inflating_font_config
    from bsms_gnn_tpu_torch.data.synthetic import (
        NT_NORMAL,
        generate_inflating_trajectory,
        make_sphere_mesh,
    )
    from bsms_gnn_tpu_torch.graph.hierarchy import build_hierarchy, to_device
    from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
    from bsms_gnn_tpu_torch.models.simulator import Simulator

    rng = np.random.default_rng(0)
    pos, cells, node_type = make_sphere_mesh(SURFACE_NODES, rng)
    edges = to_flat_edge(cells, "tri")
    t0 = time.perf_counter()
    h = build_hierarchy(edges, SURFACE_DEPTH, pos.shape[0],
                        pos.astype(np.float64))
    build_s = time.perf_counter() - t0
    hd = to_device(h, device)

    def config(**kw):
        return inflating_font_config(unet_depth=SURFACE_DEPTH,
                                     aggregation=aggregation, **kw)

    cfg = config().model
    sim = Simulator(cfg, torch.Generator().manual_seed(0), device=device)
    n, n_pad = pos.shape[0], h.levels[0].n_pad_nodes

    def frame(world):
        node_in = np.zeros((n_pad, 7), np.float32)
        node_in[:n, :3] = world
        node_in[:n, 3:6] = pos
        node_in[:n, 6] = node_type[:, 0]
        return torch.from_numpy(node_in).to(device)

    mask = np.zeros((n_pad, 1), np.float32)
    mask[:n, 0] = node_type[:, 0] == NT_NORMAL
    mask = torch.from_numpy(mask).to(device)
    node_in = frame(1.05 * pos)
    fill_normalizers(sim, node_in, mask, rng)

    traj = generate_inflating_trajectory(SURFACE_NODES, 2,
                                         np.random.default_rng(0))
    require(np.array_equal(traj["mesh_pos"][0], pos),
            "the trajectory's mesh is not the case's")
    target = torch.zeros(n_pad, 3, device=device)
    target[:n] = torch.from_numpy(traj["world_pos"][1]).to(device)
    case = dict(label="surface 16k", h=h, hd=hd, cfg=cfg, sim=sim,
                config=config, node_in=node_in, mask=mask, n=n,
                build_s=build_s, expected=EXPECTED_SURFACE_LAUNCHES,
                expected_train=EXPECTED_SURFACE_TRAIN_LAUNCHES,
                narrow=(EXPECTED_SURFACE_NARROW, 0),
                train_frames=(frame(traj["world_pos"][0]), target))
    if aggregation == "fused":
        case.update(label="surface 16k fused",
                    expected=EXPECTED_SURFACE_FUSED_LAUNCHES,
                    expected_train=EXPECTED_SURFACE_FUSED_TRAIN_LAUNCHES,
                    timed=("fused_edge_mlp_aggregate",
                           "fused_edge_mlp_aggregate_bwd"))
    return case


def build_flag_case(device, aggregation="fused"):
    """flag_simple at full width and depth, from the port's own copies: the
    cloth strip `make_grid_strip_mesh(1579, ny=32)` (1,568 nodes, the size
    of MeshGraphNets' FlagSimple meshes), Morton-reordered, the windowed
    hierarchy (depth 5, edge_block 512, window 256), `flag_simple_config()`
    (the fused method, world edges); on the `ell` method the JAX CLI's
    layout instead (not reordered, unwindowed, edge_block 128). The contact
    recipe gives the frames: world x, y = the mesh position, z = 0.05·N(0,
    1) from a seed; the target adds 0.1·sin(x) to z. The mask is the normal
    nodes; weights from `torch.Generator().manual_seed(0)`."""
    from bsms_gnn_tpu_torch.config import flag_simple_config
    from bsms_gnn_tpu_torch.data.synthetic import (
        NT_NORMAL,
        make_grid_strip_mesh,
    )
    from bsms_gnn_tpu_torch.graph.hierarchy import build_hierarchy, to_device
    from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
    from bsms_gnn_tpu_torch.graph.order import reorder_mesh
    from bsms_gnn_tpu_torch.models.simulator import Simulator

    rng = np.random.default_rng(0)
    pos, cells, node_type = make_grid_strip_mesh(FLAG_NODES, ny=FLAG_NY)
    layout = dict(edge_block=ELL_EDGE_BLOCK)
    if aggregation != "ell":
        pos, cells, (node_type,), _ = reorder_mesh(pos, cells, (node_type,))
        layout = dict(edge_block=EDGE_BLOCK, window=WINDOW)
    edges = to_flat_edge(cells, "tri")
    t0 = time.perf_counter()
    h = build_hierarchy(edges, FLAG_DEPTH, pos.shape[0],
                        pos.astype(np.float64), **layout)
    build_s = time.perf_counter() - t0
    hd = to_device(h, device)

    config = functools.partial(flag_simple_config, aggregation=aggregation)
    cfg = config().model
    sim = Simulator(cfg, torch.Generator().manual_seed(0), device=device)
    n, n_pad = pos.shape[0], h.levels[0].n_pad_nodes
    world = np.zeros((n_pad, 3), np.float32)
    world[:n, :2] = pos
    world[:n, 2] = 0.05 * rng.standard_normal(n)
    target = world.copy()
    target[:n, 2] += 0.1 * np.sin(pos[:, 0])
    node_in = np.zeros((n_pad, 6), np.float32)
    node_in[:, :3] = world
    node_in[:n, 3:5] = pos
    node_in[:n, 5] = node_type[:, 0]
    node_in = torch.from_numpy(node_in).to(device)
    mask = np.zeros((n_pad, 1), np.float32)
    mask[:n, 0] = node_type[:, 0] == NT_NORMAL
    mask = torch.from_numpy(mask).to(device)
    fill_normalizers(sim, node_in, mask, rng)
    return dict(label="flag 1.6k", h=h, hd=hd, cfg=cfg, sim=sim,
                config=config, node_in=node_in, mask=mask, n=n,
                build_s=build_s,
                expected=EXPECTED_FLAG_LAUNCHES,
                expected_train=EXPECTED_FLAG_TRAIN_LAUNCHES,
                narrow=EXPECTED_FLAG_NARROW,
                train_frames=(node_in, torch.from_numpy(target).to(device)),
                timed=("fused_edge_phase_win_dyn",
                       "fused_edge_phase_win_dyn_bwd"))


def build_cylinder_case(device, aggregation="fused"):
    """cylinder_flow on variable meshes, from the port's own copies: three
    meshes `make_delaunay_mesh(n, default_rng(s))` (CYLINDER_MESHES; about
    cylinder_flow's 1,885 nodes), Morton-reordered, planned into one size
    group (window 256, edge_block 512, pad_multiple 128) and each padded
    to the group's buckets; `cylinder_flow_config()` (latent 128, hidden 3,
    depth 5, out 2, the fused method). Each mesh's frames are frames 0 and
    1 of `generate_trajectory` on it (the analytic flow, seeded); the mask
    is the cylinder mask. The second mesh is served; the `Trainer` steps
    cycle over all three. Weights from `torch.Generator().manual_seed(0)`.
    On the `ell` method the layouts are the JAX CLI's instead (not
    reordered, unwindowed, edge_block 128), with no forced empty residual
    (an unwindowed level has none)."""
    from bsms_gnn_tpu_torch.config import DatasetConfig, cylinder_flow_config
    from bsms_gnn_tpu_torch.data.synthetic import (
        cylinder_mask,
        generate_trajectory,
        make_delaunay_mesh,
    )
    from bsms_gnn_tpu_torch.graph.bistride import build_bistride_levels
    from bsms_gnn_tpu_torch.graph.buckets import plan_buckets
    from bsms_gnn_tpu_torch.graph.hierarchy import pad_levels, to_device
    from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
    from bsms_gnn_tpu_torch.graph.order import reorder_mesh
    from bsms_gnn_tpu_torch.models.simulator import Simulator

    ell = aggregation == "ell"
    data = DatasetConfig(consist_mesh=False, pad_multiple=128,
                         edge_block=ELL_EDGE_BLOCK if ell else EDGE_BLOCK,
                         size_buckets=1, window=0 if ell else WINDOW)
    t0 = time.perf_counter()
    meshes, levels = [], []
    for n, seed in CYLINDER_MESHES:
        pos, cells, node_type = make_delaunay_mesh(
            n, np.random.default_rng(seed))
        if not ell:
            pos, cells, (node_type,), _ = reorder_mesh(pos, cells,
                                                       (node_type,))
        meshes.append((pos, cells, node_type))
        levels.append(build_bistride_levels(
            to_flat_edge(cells, "tri"), CYLINDER_DEPTH, len(pos),
            pos.astype(np.float64)))
    plan = plan_buckets(levels, data)
    hs = [pad_levels(lv, data.pad_multiple, pos=m[0].astype(np.float64),
                     edge_block=data.edge_block, window=data.window,
                     **plan.for_mesh(i))
          for i, (lv, m) in enumerate(zip(levels, meshes))]
    build_s = time.perf_counter() - t0
    print(f"[cylinder] bucket plan: {plan.groups}")

    config = functools.partial(cylinder_flow_config, aggregation=aggregation)
    cfg = config().model
    sim = Simulator(cfg, torch.Generator().manual_seed(0), device=device)
    frames = []
    for i, ((pos, cells, node_type), h) in enumerate(zip(meshes, hs)):
        fields = generate_trajectory((pos, cells, node_type), 2,
                                     np.random.default_rng(i))
        n, n_pad = len(pos), h.levels[0].n_pad_nodes
        node_in = np.zeros((n_pad, 5), np.float32)
        node_in[:n, :2] = fields["velocity"][0]
        node_in[:n, 2:4] = pos
        node_in[:n, 4] = node_type[:, 0]
        target = np.zeros((n_pad, 2), np.float32)
        target[:n] = fields["velocity"][1]
        mask = np.zeros((n_pad, 1), np.float32)
        mask[:n] = cylinder_mask(node_type)
        hd = to_device(h, device)
        mask = torch.from_numpy(mask).to(device) * hd.levels[0].node_mask
        frames.append((hd, torch.from_numpy(node_in).to(device),
                       torch.from_numpy(target).to(device), mask))
    hd, node_in, target, mask = frames[1]
    fill_normalizers(sim, node_in, mask, np.random.default_rng(0))
    case = dict(label="cylinder 1.9k", h=hs[1], hd=hd, cfg=cfg, sim=sim,
                config=config, node_in=node_in, mask=mask,
                n=len(meshes[1][0]), build_s=build_s, meshes=meshes,
                expected=EXPECTED_CYLINDER_LAUNCHES,
                expected_train=EXPECTED_CYLINDER_TRAIN_LAUNCHES,
                narrow=(0, 0), train_frames=(node_in, target),
                trainer_frames=frames,
                timed=("windowed_conv", "segment_sum_accum"))
    if not ell:
        case["forced_empty"] = forced_empty_resid(levels[1], meshes[1][0],
                                                  plan, data, device)
    return case


def forced_empty_resid(levels, pos, plan, data, device):
    """The served mesh padded as a group whose bucket gives level 3 a
    residual though the mesh has none there (`force_resid`): level 3's
    all-pad residual sub-level (one 128-slot chunk, owned by the last
    block), on `device`."""
    from bsms_gnn_tpu_torch.graph.hierarchy import pad_levels, to_device

    kw = plan.for_mesh(1)
    if kw["resid_buckets"][3] != (0, 0):
        raise SmokeFailure("level 3 of the group already has a residual")
    kw["resid_buckets"] = list(kw["resid_buckets"])
    kw["resid_buckets"][3] = (128, 1)
    h = pad_levels(levels, data.pad_multiple, pos=pos.astype(np.float64),
                   edge_block=data.edge_block, window=data.window, **kw)
    r = h.levels[3].resid
    require(r is not None and r.n_edges == 0 and r.n_pad_edges == 128,
            "the forced residual is not an empty 128-slot layout")
    return to_device(h, device).levels[3].resid


# Each described case's level layout, (n_nodes, n_pad, E_pad) per level,
# by label: the CLI phase holds its reader's hierarchy against phase 2's.
LAYOUTS = {}


def layout_of(h):
    return [(g.n_nodes, g.n_pad_nodes, g.n_pad_edges) for g in h.levels]


def describe(case):
    h = case["h"]
    LAYOUTS[case["label"]] = layout_of(h)
    print(f"[{case['label']}] mesh: {case['n']} nodes, hierarchy built in "
          f"{case['build_s']:.2f} s (host)")
    print("level  n_nodes  n_pad  E_pad      E  window  cresid_rows  "
          "slots/128-row block  resid E / E_pad  in-window share of E")
    for l, g in enumerate(h.levels):
        cr = "-" if g.cresid is None else g.cresid.n_real
        r = "-" if g.resid is None else (f"{g.resid.n_edges} / "
                                         f"{g.resid.n_pad_edges}")
        out = (g.cresid.n_real if g.cresid is not None else
               g.resid.n_edges if g.resid is not None else 0)
        share = 1 - out / g.n_edges if g.window and g.n_edges else None
        print(f"{l:5d} {g.n_nodes:8d} {g.n_pad_nodes:6d} {g.n_pad_edges:6d} "
              f"{g.n_edges:6d} {g.window:7d}  {str(cr):>11}  "
              f"{g.n_pad_edges / (g.n_pad_nodes // 128):19.0f}  {r:>15}  "
              + ("-" if share is None else f"{share:.4f}"))
    hd = case["hd"]
    ops = [(f"T{l} {w}", getattr(t, f"{w}_op")) for l, t in
           enumerate(hd.transitions) for w in ("down", "up")]
    gathers = [(f"L{l}", g) for l, g in enumerate(hd.levels)] + ops
    lines = [f"{k} {row_list_summary(t.win_row_ptr)}" for k, t in gathers
             if t is not None and t.win_row_ptr is not None]
    if lines:
        print("kernel 1's live slots per row: " + "; ".join(lines))
    lines = [f"{k} {row_list_summary(t.send_row_ptr)}" for k, t in gathers
             if getattr(t, "send_row_ptr", None) is not None]
    if lines:
        print("kernel 7's slots per sender row: " + "; ".join(lines))
    lines = [f"{k} {t.cresid.n_real} rows on {t.cresid.cr_rows.numel()} "
             f"receivers, {row_list_summary(t.cresid.cr_row_ptr)}"
             for k, t in gathers if t is not None and t.cresid is not None]
    if lines:
        print("kernel 2's compact rows per receiver: " + "; ".join(lines))
    depth = h.depth
    gmps = 2 * depth + 1
    expect = dict.fromkeys(case["expected"], 0)
    if h.transitions[0].down_op is None:
        # Bucketed: the explicit conv (kernel 1's level form) both ways at
        # every transition, kernel 9 in both GMPs and both convs of each
        # level with a residual sub-level (the bottom level: its GMP).
        resid = [g.resid is not None for g in h.levels]
        fe = case["forced_empty"]
        print("kernel 9's lists per residual sub-level: " + "; ".join(
            f"L{l} {row_list_summary(g.resid.row_ptr)}"
            for l, g in enumerate(hd.levels) if g.resid is not None)
            + f"; forced empty {row_list_summary(fe.row_ptr)}")
        edge = ("fused_edge_phase_win_dyn" if case["cfg"].world_edges
                else "fused_edge_phase_win")
        expect.update({edge: gmps, "fused_node_phase": gmps,
                       "windowed_conv": 2 * depth,
                       "segment_sum_accum": 4 * sum(resid[:depth])
                       + resid[depth]})
        print(f"launches per forward from the layout: {expect}")
        require(expect == case["expected"],
                f"layout gives {expect}, expected {case['expected']}")
        return
    print("trans  down_E_pad  down_cresid  up_E_pad  up_cresid  dense  window")

    def rows(op):
        return "-" if op.cresid is None else str(op.cresid.n_real)

    for l, t in enumerate(h.transitions):
        print(f"{l:5d} {t.down_op.n_pad_edges:11d} {rows(t.down_op):>12} "
              f"{t.up_op.n_pad_edges:9d} {rows(t.up_op):>10}"
              f"  {str(t.down_op.dense is not None):>5}  {t.down_op.window}")
    sparse = sum(t.down_op.dense is None for t in h.transitions)
    if case["cfg"].aggregation == "pallas":
        expect.update({"fused_aggregate_node_phase": gmps,
                       "segment_sum": 2 * sparse})
    elif unwindowed(case):
        edge = ("fused_edge_mlp_aggregate" if case["cfg"].world_edges
                else "fused_edge_phase")
        expect.update({edge: gmps, "fused_node_phase": gmps,
                       "segment_sum": 2 * sparse})
    else:
        cr_gmp = sum(2 * (g.cresid is not None) for g in h.levels[:depth])
        cr_gmp += h.levels[depth].cresid is not None
        cr_ops = sum((t.down_op.cresid is not None)
                     + (t.up_op.cresid is not None) for t in h.transitions)
        edge = ("fused_edge_phase_win_dyn" if case["cfg"].world_edges
                else "fused_edge_phase_win")
        expect.update({edge: gmps, "fused_node_phase": gmps,
                       "windowed_rect_conv": 2 * depth,
                       "compact_accum": cr_gmp + cr_ops})
        if interleave(case) > 1:
            # The density gate: kernel 14 on the levels that pass it (both
            # GMPs of a level above the bottom), kernel 4 on the rest.
            gated = gated_levels(case)
            k14 = sum(2 - (l == depth) for l in gated)
            print(f"levels that pass the density gate: {gated} (chunks per "
                  f"128-node block: " + ", ".join(
                      f"{g.n_pad_edges // g.edge_block / (g.n_pad_nodes // 128):.1f}"
                      for g in h.levels) + ")")
            expect.update({"fused_edge_phase_win_k": k14,
                           "fused_edge_phase_win": gmps - k14})
    print(f"launches per forward from the layout: {expect}")
    require(expect == case["expected"],
            f"layout gives {expect}, expected {case['expected']}")


def interleave(case):
    """The case's K (1 unless the method is "fusedK")."""
    from bsms_gnn_tpu_torch.config import split_interleave

    return split_interleave(case["cfg"].aggregation)[1]


def gated_levels(case):
    """The levels on which a "fusedK" GMP runs kernel 14."""
    from bsms_gnn_tpu_torch.ops.kernels.fused_gmp_k import passes_gate

    return [l for l, g in enumerate(case["h"].levels) if passes_gate(g)]


def unwindowed(case):
    """Whether a fused case runs on an unwindowed hierarchy (kernels 11 and
    12)."""
    return all(g.window == 0 for g in case["h"].levels)


def port_kernels(counts):
    """The CUDA kernels that the wrappers' launches `counts` ran: each
    launch times the kernels one call of its wrapper runs."""
    return sum(n * len(KERNEL_META[k][2]) for k, n in counts.items())


def compare(got, want):
    """(largest error, RMS error, RMS of want), all absolute."""
    got, want = got.float(), want.float()
    diff = got - want
    return (diff.abs().max().item(), diff.square().mean().sqrt().item(),
            want.square().mean().sqrt().item())


def worst_row(got, want):
    """The row (of the first axis) that holds the largest error."""
    diff = (got.float() - want.float()).abs()
    return int(diff.reshape(diff.shape[0], -1).amax(-1).argmax())


def kernel_inputs(case, dtype, device):
    """Each kernel's arguments at the case's path's shapes, from a seed."""
    hd, sim = case["hd"], case["sim"]
    g = torch.Generator(device="cpu").manual_seed(7)

    def rand(*shape, dt=torch.float32, s=1.0, gen=g):
        return (s * torch.randn(*shape, generator=gen)).to(dt).to(device)

    lvl, t0 = hd.levels[0], hd.transitions[0]
    gmp = sim.process.down_gmps[0]
    c, n0 = case["cfg"].latent_dim, lvl.n_pad_nodes
    cd = dtype if dtype == torch.bfloat16 else None
    if case["cfg"].aggregation == "pallas":
        # Kernel 8 at level 0 (kernel 10's backward, the gathers'
        # backwards) in both forms and at T0 down (the forward), drawn from
        # g; then at every other level in both forms and on T0-T2's other
        # operators, each from a generator of its own. Kernel 10 at every
        # level (level 0 from g) and, in bf16, on f32 x at level 0 (bf16
        # compute on f32 x: the level-0 GMP under io_dtype=float32).
        e0 = lvl.n_pad_edges

        def own(name, i):
            return functools.partial(rand, gen=torch.Generator(
                device="cpu").manual_seed(WALK_SEED[name] + i))

        def agg(level, mlp, x_dt, r=rand):
            return (level, r(level.n_pad_edges, c, dt=dtype),
                    r(level.n_pad_nodes, c, dt=x_dt), mlp, cd)

        sums = [("level 0", (lvl, rand(e0, c, dt=dtype))),
                ("level 0 send", (lvl, rand(e0, c, dt=dtype), True)),
                ("T0 down", (t0.down_op,
                             rand(t0.down_op.n_pad_edges, c, dt=dtype)))]
        for l, d in enumerate(hd.levels[1:], 1):
            r = own("segment_sum", l)
            sums += [(f"level {l}", (d, r(d.n_pad_edges, c, dt=dtype))),
                     (f"level {l} send",
                      (d, r(d.n_pad_edges, c, dt=dtype), True))]
        for i, (where, op) in enumerate(sparse_ops(hd)):
            if where != "T0 down":
                sums.append((where, (op, own("segment_sum", 20 + i)(
                    op.n_pad_edges, c, dt=dtype))))
        aggs = [("level 0", agg(lvl, gmp.mlp_node, dtype))]
        if cd is not None:
            aggs.append(("f32 x", agg(lvl, gmp.mlp_node, torch.float32)))
        aggs += [(f"level {l}", agg(d, level_gmp(sim, hd, l).mlp_node, dtype,
                                    own("fused_aggregate_node_phase", l)))
                 for l, d in enumerate(hd.levels[1:], 1)]
        return {"segment_sum": sums, "fused_aggregate_node_phase": aggs}
    if interleave(case) > 1:
        # Kernel 14 at every level that passes the density gate (the first
        # drawn from g, each later one from a generator of its own) and,
        # beside it, kernel 4 at the first.
        k = interleave(case)
        where, args = gated_edge_args(case, rand, dtype)
        later = [gated_edge_args(case, functools.partial(
            rand, gen=torch.Generator(device="cpu").manual_seed(
                WALK_SEED["fused_edge_phase_win_k"] + l)), dtype, l)
            for l in gated_levels(case)[1:]]
        return {"fused_edge_phase_win_k": [
                    (w, (*a, k)) for w, a in [(where, args), *later]],
                "fused_edge_phase_win": [(where, args)]}
    mlp_e = (list(gmp.mlp_edge.weights)[1:], list(gmp.mlp_edge.biases)[1:])
    e0 = lvl.n_pad_edges
    if unwindowed(case):
        # Kernel 11 (world edges) or 12 at every level (level 0's draw
        # first, from g).
        if case["cfg"].world_edges:
            return {"fused_edge_mlp_aggregate": level_shapes(
                hd, "fused_edge_mlp_aggregate", rand, g, lambda l, d, r: (
                    d, r(d.n_pad_edges, c, dt=dtype),
                    *level_tail(sim, hd, l)))}
        return {"fused_edge_phase": level_shapes(
            hd, "fused_edge_phase", rand, g, lambda l, d, r: (
                d, r(d.n_pad_edges, c, dt=dtype),
                r(d.n_pad_nodes, c, dt=dtype), *level_tail(sim, hd, l)))}
    if case["cfg"].world_edges:
        # Kernel 13 at every level (level 0's draw first, from g): level 0
        # on the case's own world positions, the later levels on
        # unit-normal ones; kernel 11 at level 0 too, on a windowed level
        # (edge_block 512), which no model path reaches.
        def dyn_args(l, d, r):
            n = d.n_pad_nodes
            pos = (case["node_in"][:, :3].to(dtype) if l == 0
                   else r(n, 3, dt=dtype))
            args = (d, r(n, c, dt=dtype), r(n, c, dt=dtype), pos,
                    *first_layer(level_gmp(sim, hd, l)),
                    *level_tail(sim, hd, l))
            return kink_free(case, "fused_edge_phase_win_dyn", args, l)

        edge = {"fused_edge_phase_win_dyn": level_shapes(
            hd, "fused_edge_phase_win_dyn", rand, g, dyn_args),
            "fused_edge_mlp_aggregate": [
                ("level 0", (lvl, rand(e0, c, dt=dtype), *mlp_e))]}
    else:
        # Kernel 4 at every level (level 0's draw first, from g).
        edge = {"fused_edge_phase_win": level_shapes(
            hd, "fused_edge_phase_win", rand, g, lambda l, d, r: kink_free(
                case, "fused_edge_phase_win", (
                    d, r(d.n_pad_nodes, c, dt=dtype),
                    r(d.n_pad_nodes, c, dt=dtype),
                    first_layer(level_gmp(sim, hd, l))[0],
                    *level_tail(sim, hd, l)), l))}
    # Kernel 3 at every level (level 0's draw first, from g), then, in
    # bf16, bf16 compute on f32 x: the level-0 GMP under io_dtype=float32.
    node = {"fused_node_phase": level_shapes(
        hd, "fused_node_phase", rand, g, lambda l, d, r: kink_free(
            case, "fused_node_phase", (
                r(d.n_pad_nodes, c, dt=dtype), r(d.n_pad_nodes, c, s=3.0),
                level_gmp(sim, hd, l).mlp_node, cd), l))}
    if cd is not None:
        node["fused_node_phase"].insert(1, ("f32 x", (
            rand(n0, c), rand(n0, c, s=3.0), gmp.mlp_node, cd)))
    if t0.down_op is None:
        # Bucketed: kernel 1's level form at level 0 (down: ew, up: ew_rev)
        # and at level 4 (window 128); kernel 9 on level 0's residual
        # sub-level in both forms and on the forced empty one (drawn from
        # g), then in the store form (no acc) there and in both forms, on
        # acc and in the store form, at every later residual sub-level
        # (each from a generator of its own).
        l4, r, fe = hd.levels[4], lvl.resid, case["forced_empty"]
        accum = [
            ("level 0", (r, rand(r.n_pad_edges, c, dt=dtype), rand(n0, c))),
            ("level 0 send", (r, rand(r.n_pad_edges, c, dt=dtype),
                              rand(n0, c), True)),
            ("forced empty", (fe, rand(fe.n_pad_edges, c, dt=dtype),
                              rand(fe.n_pad_nodes, c)))]
        accum += [(f"{w} store", (a[0], a[1], None, *a[3:]))
                  for w, a in accum]
        for l, d in enumerate(hd.levels):
            if l == 0 or d.resid is None:
                continue
            rl = functools.partial(rand, gen=torch.Generator(
                device="cpu").manual_seed(ACCUM_SEED + l))
            for send in ((), (True,)):
                w = f"level {l}{' send' if send else ''}"
                feat = rl(d.resid.n_pad_edges, c, dt=dtype)
                accum += [(w, (d.resid, feat, rl(d.n_pad_nodes, c), *send)),
                          (f"{w} store", (d.resid, feat, None, *send))]
        if case.get("dense"):
            accum = [(w, (a[0], pad_zeroed(a[0], a[1]), *a[2:]))
                     if a[0] is not fe else (w, a) for w, a in accum]
        return {
            **edge, **node,
            "windowed_conv": [
                ("level 0 down", (lvl, rand(n0, c, dt=dtype), lvl.ew)),
                ("level 0 up", (lvl, rand(n0, c, dt=dtype), lvl.ew_rev)),
                ("level 4 down", (l4, rand(l4.n_pad_nodes, c, dt=dtype),
                                  l4.ew))],
            "segment_sum_accum": accum,
        }
    star = star_resid(case, device)
    rect, compact = [], []
    if case.get("auto") or case.get("every_op"):
        # window="auto": kernels 1 and 2 also on every operator and level
        # whose width is not WINDOW, from a generator of their own; the
        # wide airfoil: on every other windowed operator and level with a
        # compact residual.
        every = case.get("every_op", False)
        ra = functools.partial(rand, gen=torch.Generator(
            device="cpu").manual_seed(WIDE_SEED if every else AUTO_SEED))

        def cr_args(where, cr):
            return (where, (cr, ra(cr.n_rows, c, dt=dtype),
                            ra(cr.n_pad_nodes, c)))

        for l, t in enumerate(hd.transitions):
            for w in ("down", "up"):
                op, where = getattr(t, f"{w}_op"), f"T{l} {w}"
                if op.window <= 0 or (not every and op.window == WINDOW):
                    continue
                if not every or l > 0:
                    rect.append((where, (op, ra(op.n_in_pad, c, dt=dtype))))
                if op.cresid is not None and (not every
                                              or where != "T0 down"):
                    compact.append(cr_args(where, op.cresid))
        compact += [cr_args(f"level {l}", d.cresid)
                    for l, d in enumerate(hd.levels)
                    if d.cresid is not None
                    and (l > 0 if every else d.window != WINDOW)]
    return {
        **edge, **node,
        "windowed_rect_conv": [
            ("T0 down", (t0.down_op, rand(t0.down_op.n_in_pad, c, dt=dtype))),
            ("T0 up", (t0.up_op, rand(t0.up_op.n_in_pad, c, dt=dtype))),
            *rect],
        "compact_accum": [
            ("level 0", (lvl.cresid, rand(lvl.cresid.n_rows, c, dt=dtype),
                         rand(n0, c))),
            ("T0 down", (t0.down_op.cresid,
                         rand(t0.down_op.cresid.n_rows, c, dt=dtype),
                         rand(t0.down_op.cresid.n_pad_nodes, c))),
            ("star", (star, rand(star.n_rows, c, dt=dtype), rand(n0, c))),
            *compact],
    }


def star_resid(case, device):
    """Kernel 2's input with a long list: a compact residual built by the
    port's `_compact_resid` from level 0's residual edges plus STAR_EDGES
    edges onto the receiver that already has the most rows, from distinct
    real senders (no residual of the main paths has a receiver of more
    than 32 rows), on `device`; made once per case."""
    from bsms_gnn_tpu_torch.graph.hierarchy import _compact_resid, _to_device

    if "star" not in case:
        lvl = case["h"].levels[0]
        cr, n = lvl.cresid, lvl.cresid.n_real
        s = cr.senders[:n].astype(np.int64)
        r = cr.receivers[:n].astype(np.int64)
        hub = int(np.bincount(r).argmax())
        star = np.setdiff1d(np.arange(0, lvl.n_nodes, 7), [hub])[:STAR_EDGES]
        s = np.concatenate([s, star])
        r = np.concatenate([r, np.full(len(star), hub)])
        ew = np.ones(len(s))
        case["star"] = _to_device(_compact_resid(
            s, r, ew, ew, lvl.n_pad_nodes, None, symmetric=False), device)
    return case["star"]


def gated_edge_args(case, rand, dtype, l=None):
    """(where, kernel 4's arguments) at level l (by default the first on
    which a "fusedK" GMP runs kernel 14), with that level's down GMP's
    weights."""
    l = gated_levels(case)[0] if l is None else l
    lvl, gmp = case["hd"].levels[l], case["sim"].process.down_gmps[l]
    n = lvl.n_pad_nodes
    return f"level {l}", (lvl, rand(n, 128, dt=dtype), rand(n, 128, dt=dtype),
                          first_layer(gmp)[0],
                          list(gmp.mlp_edge.weights)[1:],
                          list(gmp.mlp_edge.biases)[1:])


def first_layer(gmp):
    """The fused kernels' first-layer operands from a GMP's edge MLP: wf8
    (the static fiber rows, sfw = pos_dim + 1 of them, then the bias); with
    world edges also wf_dyn and wf_nrm (rows [Δworld, ‖Δworld‖, static,
    x_i, x_j])."""
    w1, b1 = gmp.mlp_edge.weights[0], gmp.mlp_edge.biases[0]
    wd = sum(gmp.dyn_dims)
    wd1 = wd + 1 if wd else 0
    sfw = gmp.fiber_dims[-1] + 1
    sta = w1[wd1:wd1 + sfw]
    wf8 = torch.cat([sta, b1[None], w1.new_zeros(7 - sfw, w1.shape[1])])
    return (wf8, w1[:wd], w1[wd]) if wd else (wf8,)


def control_args(name, args):
    """The bf16 case's arguments for a kernel that skips the bf16
    rounding: the same values upcast to f32, f32 compute. Its output must
    miss the bf16 tolerance against the bf16 plain version, which shows
    the tolerance would catch a kernel that rounded nowhere. None for the
    compact accumulate and the segment sum, whose bf16 modes round nothing
    (bf16 values add exactly into f32 sums). Kernel 9 rounds nothing
    either: its control is a kernel that held the accumulator in bf16
    (acc rounded to bf16 first), which must miss; its store form, with no
    acc, has none."""
    if name in ("compact_accum", "segment_sum"):
        return None
    if name == "segment_sum_accum":
        level, feat, acc, *send = args
        if acc is None:
            return None
        return (level, feat, acc.to(torch.bfloat16).float(), *send)
    up = [a.float() if isinstance(a, torch.Tensor)
          and a.dtype == torch.bfloat16 else a for a in args]
    if name in ("fused_node_phase", "fused_aggregate_node_phase"):
        up[-1] = None
    return tuple(up)


def run(name, fn, args):
    if name == "compact_accum":  # adds onto acc in place
        cr, vals, acc = args
        return fn(cr, vals, acc.clone())
    return fn(*args)


def check_kernels(case, device):
    """Every kernel against its plain version on the same inputs, and in
    bf16 a control that must miss the tolerance. Returns {(name, dtype):
    max_abs_err} at the first shape listed."""
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, shapes in kernel_inputs(case, dtype, device).items():
            if name in case.get("skip", ()):
                continue
            for where, args in shapes:
                sparse = name in TILE_WALKS and where != shapes[0][0]
                err = check_kernel(name, where, args, dtype, sparse)
                errs.setdefault((name, dtype), err)
    return errs


def check_agg_identity(case, n=1):
    """Kernel 10 against kernel 3 on kernel 8's aggregate, at every level
    of the pallas surface, in f32, in bf16 and in bf16 compute on f32 x:
    bit for bit, on the tile `agg_node.tile_design` picks at each level
    (for the batch's n·N_pad rows, where n > 1: a batch of n samples, each
    drawn from its own generator). Both sum the aggregate in the
    row-ordered gather's order, both round it to bf16 where bf16 compute
    takes it as a dot operand, and both of kernel 10's node phases (the
    one-block tile, kernel 3's cluster) do kernel 3's arithmetic (one FMA
    chain per output over k in order, the same LayerNorm), so any
    difference is a fault. None of these launches is counted on the main
    path."""
    from bsms_gnn_tpu_torch.ops.kernels import agg_node

    fns = kernel_modules()
    agg, node, seg = (fns[k][0] for k in ("fused_aggregate_node_phase",
                                          "fused_node_phase", "segment_sum"))
    hd, sim = case["hd"], case["sim"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bf = torch.bfloat16
    modes = (("f32", torch.float32, torch.float32, None),
             ("bf16", bf, bf, bf), ("bf16 on f32 x", torch.float32, bf, bf))
    for l, lvl in enumerate(hd.levels):
        feats, xs = [], []
        for s in range(n):
            g = torch.Generator(device="cpu").manual_seed(1400 + l + 100 * s)
            feats.append(torch.randn(lvl.n_pad_edges, 128, generator=g))
            xs.append(torch.randn(lvl.n_pad_nodes, 128, generator=g))
        feat, x = (torch.stack(t) if n > 1 else t[0] for t in (feats, xs))
        mlp = level_gmp(sim, hd, l).mlp_node
        same = []
        for mode, x_dt, f_dt, cd in modes:
            f, xx = feat.to(f_dt).cuda(), x.to(x_dt).cuda()
            got = agg(lvl, f, xx, mlp, cd)
            want = node(xx, seg(lvl, f), mlp, cd)
            same.append(torch.equal(got, want))
            require(same[-1], f"kernel 10 at level {l} B={n} ({mode}) "
                              f"differs from kernel 3 on kernel 8's "
                              f"aggregate")
        design = agg_node.tile_design(n * lvl.n_pad_nodes, sms)
        print(f"[{case['label']}] kernel 10 = kernel 3 on kernel 8's "
              f"aggregate at level {l}"
              + (f" at B={n}" if n > 1 else "") + f" ({design}), bit for "
              f"bit in " + ", ".join(m for (m, *_), ok in zip(modes, same)
                                     if ok))


def check_kernel(name, where, args, dtype, sparse=False):
    """One kernel against its plain version on `args`, and in bf16 its
    control, which must miss the tolerance. A tile walk or a node cluster
    runs twice and must agree with itself bit for bit; where `sparse` (a
    walk's later levels) the measures are taken over the rows the plain
    output fills, every other row exactly zero (`filled_compare`). Returns
    the max_abs_err."""
    fn, plain = kernel_modules()[name]
    tol_max, tol_rms = TOL[(name, dtype)]
    got, want = run(name, fn, args), run(name, plain, args)
    if name in TILE_WALKS or name in NODE_CLUSTERS or name in ROW_ORDERED:
        same = torch.equal(got, run(name, fn, args))
        line = (walk_line(name, where, dtype, args) if name in TILE_WALKS
                else node_walk_line(name, where, dtype, args)
                if name in NODE_CLUSTERS
                else row_walk_line(name, where, dtype, args))
        print(line + "; two calls " + ("bit-identical" if same else "DIFFER"))
        require(same, f"{name} {where} {dtype}: two calls on the same "
                      f"inputs differ")
    if name == "segment_sum_accum" and args[2] is None:
        check_store_form(where, dtype, args, got)
    err, err_rms, rms, zero_ok, live = filled_compare(got, want, sparse)
    ok = (err <= tol_max * rms and err_rms <= tol_rms * rms and zero_ok
          and bool(torch.isfinite(got).all()))
    print(f"kernel {name:26s} {where:12s} {str(dtype)[6:]:9s} "
          f"max_abs_err {err:.3e} ({frac(err, rms):.2e} of rms "
          f"{rms:.3e}{' over the filled rows' if sparse else ''}, tol "
          f"{tol_max:.0e}, row {worst_row(got, want)})  rms_err "
          f"{frac(err_rms, rms):.2e} of rms (tol {tol_rms:.0e})  "
          f"{'ok' if ok else 'FAIL'}")
    if not ok and name in RELU_DIAGNOSED:
        print(relu_margin(name, args, got, want, tol_max * rms,
                          "inputs" if name in NODE_CLUSTERS else "receivers"))
    require(ok, f"{name} {where} {dtype} disagrees with plain")
    ctrl = control_args(name, args) if dtype == torch.bfloat16 else None
    if ctrl is None:
        return err
    if not live:
        print("  no control: the plain output is all zero")
        return err
    if exact_weights(name, args):
        print("  no control: every weight is exact in bf16")
        return err
    c_err, c_rms, _, c_zero, _ = filled_compare(run(name, fn, ctrl), want,
                                                sparse)
    missed = c_err > tol_max * rms or c_rms > tol_rms * rms or not c_zero
    print(f"  control (f32 kernel, no bf16 rounding): max "
          f"{frac(c_err, rms):.2e}, rms {frac(c_rms, rms):.2e} of rms: "
          f"{'misses the tolerance, ok' if missed else 'PASSES'}")
    require(missed, f"{name} {where}: the bf16 tolerance does "
                    f"not tell an unrounded kernel apart")
    return err


def exact_weights(name, args):
    """Whether a windowed conv's weights are all exact in bf16: its control
    skips the rounding of ew, which then changes nothing (the auto
    airfoil's T6, the wide airfoil's T6: 2 nodes)."""
    if name not in ("windowed_rect_conv", "windowed_conv"):
        return False
    ew = args[0].ew if name == "windowed_rect_conv" else args[2]
    return torch.equal(ew.to(torch.bfloat16).float(), ew.float())


def check_store_form(where, dtype, args, got):
    """Kernel 9's store form (`got`, no acc) bit for bit against the call
    on zeros: the gather's sum from +0 plus +0 is the sum itself, and such
    a sum is never -0, so the two share every bit."""
    fn = kernel_modules()["segment_sum_accum"][0]
    level, feat, _, *send = args
    zeros = fn(level, feat, torch.zeros_like(got), *send)
    same = torch.equal(got.view(torch.int32), zeros.view(torch.int32))
    print(f"  store form {where} {str(dtype)[6:]}: "
          + ("bit for bit the call on zeros" if same
             else "DIFFERS from the call on zeros"))
    require(same, f"segment_sum_accum {where} {dtype}: the store form "
                  f"differs from the call on zeros")


def relu_inputs(name, args):
    """(every ReLU input of the function on `args` in the plain version's
    arithmetic, f32 [rows, C] per layer; the input rows that count; each
    input row's receiver or None): kernels 4, 5, 13 and 14 (forward and
    backward), per slot (the first layer's pre-activation, then each hidden
    tail layer's; the in-window slots count); kernels 3 and 6, per node
    row."""
    from bsms_gnn_tpu_torch.ops.kernels import fused_gmp as fg
    from bsms_gnn_tpu_torch.ops.kernels import fused_gmp_dyn as fgd
    from bsms_gnn_tpu_torch.ops.kernels import node_mlp

    if name in NODE_CLUSTERS:
        x, aggr, mlp, cd = args[:3] + args[-1:]
        bf16 = cd == torch.bfloat16
        pre = node_mlp._node_pre(x, aggr, mlp, bf16)[0]
        ws, bs = node_mlp._tail(mlp)
        counted, recv = torch.ones(pre.shape[0], dtype=torch.bool,
                                   device=pre.device), None
    elif name in ("fused_edge_phase_win_dyn", "fused_edge_phase_win_dyn_bwd"):
        level, xwi, xj, pos, wf8, wfd, wfn, ws, bs = args[:9]
        bf16 = xwi.dtype == torch.bfloat16
        pre, counted, recv, _, _ = fgd._edge_pre_dyn(level, xwi, xj, pos, wf8,
                                                     wfd, wfn, bf16)
        ws, bs = [w.float() for w in ws], [b.float() for b in bs]
    else:
        level, xwi, xj, wf8, ws, bs = args[:6]
        bf16 = xwi.dtype == torch.bfloat16
        pre, counted, recv = fg._edge_pre(level, xwi, xj, wf8, bf16)
        ws, bs = [w.float() for w in ws], [b.float() for b in bs]
    ins, h = [pre], torch.relu(pre)
    for w, b in zip(ws[:-1], bs[:-1]):
        z = fg.dot(h, w, bf16) + b
        ins.append(z)
        h = torch.relu(z)
    return ins, counted, recv


def relu_margin(name, args, got, want, limit, rows_are="receivers"):
    """A line naming the smallest |ReLU input| over the input rows that feed
    the output rows that miss (an error above `limit`; failing that, the
    rows off by more than a hundredth of it), and where it lies: a draw
    that puts a ReLU input within rounding of zero can flip that unit
    between the kernel and the plain version, whose sums run in other
    orders. `rows_are`: "inputs" (dpre per slot, kernel 3's output and
    kernel 6's dx and daggr per node), "receivers" (kernel 4's aggregate,
    kernels 5's and 13's dxj) or "all" (a weight gradient: every input
    row)."""
    diff = (got.float() - want.float()).abs()
    by_row = diff.reshape(diff.shape[0], -1).amax(-1)
    bad = by_row > limit
    if not bool(bad.any()):
        bad = by_row > limit / 100
    ins, rows, recv = relu_inputs(name, args)
    if rows_are == "inputs":
        rows = rows & bad
    elif rows_are == "receivers" and recv is not None:
        rows = rows & bad[recv]
    best = (float("inf"), -1, -1)
    idx = rows.nonzero()[:, 0]
    for l, z in enumerate(ins):
        if len(idx):
            m = z[idx].abs()
            i = int(m.argmin())
            if float(m.reshape(-1)[i]) < best[0]:
                best = (float(m.reshape(-1)[i]), int(idx[i // z.shape[1]]), l)
    return (f"  ReLU check: {int(bad.sum())} output rows miss; the smallest "
            f"|ReLU input| over the {len(idx)} input rows that feed them is "
            f"{best[0]:.3e} (input row {best[1]}, layer {best[2]}; 0: the "
            f"first layer's pre-activation)")


def pad_zeroed(layout, feat):
    """feat with the rows of the layout's pad slots zero (on a `dense`
    case)."""
    return feat * layout.edge_mask.to(feat.dtype)[:, None]


# The kernels whose arguments `clear_kinks` can clear.
KINK_CLEARED = ("fused_edge_phase_win", "fused_edge_phase_win_bwd",
                "fused_edge_phase_win_k_bwd", "fused_edge_phase_win_dyn",
                "fused_edge_phase_win_dyn_bwd", "fused_node_phase",
                "fused_node_phase_bwd")


def kink_free(case, name, args, l):
    """Kernel 13's arguments at level l of the case, cleared of ReLU inputs
    near their kinks on a `dense` case, and kernels 3-6's on a case with
    `clear_kinks` in f32 (`clear_kinks`, from a generator seeded with
    KINK_SEED + l), else as they are."""
    dyn = name.startswith("fused_edge_phase_win_dyn")
    if not ((case.get("dense") and dyn)
            or (case.get("clear_kinks") and not dyn
                and kink_dtype(name, args) == torch.float32)):
        return args
    return clear_kinks(name, args,
                       torch.Generator().manual_seed(KINK_SEED + l))


def kink_dtype(name, args):
    """The compute dtype of a kernel 3-6 or 13 check's arguments."""
    if name in NODE_CLUSTERS:
        return args[-1] or torch.float32
    return args[1].dtype


def clear_kinks(name, args, gen):
    """Kernel 13's, 14's backward's, 4's or 5's `args` with
    every row of xwi (args 1, [rows, C], or a batch) that sends to a
    covered slot with a ReLU input within KINK_MARGIN of its layer's RMS
    from zero (`relu_inputs`, the plain version's arithmetic), or kernel
    3's or 6's with every such row of x (args 0), drawn anew from `gen` at
    its RMS, until no such slot or row is left; a batch of edge inputs
    sample by sample."""
    node = name in NODE_CLUSTERS
    at = 0 if node else 1
    if not node and args[1].dim() == 3:
        rows = [clear_kinks(name, tuple(a[s] if torch.is_tensor(a)
                                        and a.dim() == 3 else a
                                        for a in args), gen)[1]
                for s in range(args[1].shape[0])]
        return (args[0], torch.stack(rows), *args[2:])
    args = list(args)
    x = args[at]
    scale = x.float().square().mean().sqrt().item()
    for _ in range(KINK_ROUNDS):
        ins, counted, _ = relu_inputs(name, tuple(args))
        near = torch.zeros_like(counted)
        for z in ins:
            rms = z[counted].square().mean().sqrt()
            near |= (z.abs() < KINK_MARGIN * rms).any(-1)
        near &= counted
        if not bool(near.any()):
            return tuple(args)
        rows = (near.nonzero()[:, 0] if node
                else args[0].senders[near].long().unique())
        x = x.clone()
        flat = x.view(-1, x.shape[-1])
        flat[rows] = (scale * torch.randn(len(rows), x.shape[-1],
                                          generator=gen)).to(x)
        args[at] = x
    raise SmokeFailure(f"{name}: ReLU inputs near their kinks remain after "
                       f"{KINK_ROUNDS} draws")


def input_scales(args, ins, rows):
    """Kernel 13's backward's ReLU inputs' own scales at the slots `rows`
    (`ins` from `relu_inputs` on `args`): for each layer [len(rows), 128]
    the sum of the magnitudes of the terms that make each unit's input, in
    the plain version's arithmetic (the first layer's gathered rows,
    fiber, world and norm terms; a later layer's Σ_k |h_k W_ku| + |b_u|)."""
    from bsms_gnn_tpu_torch.ops.kernels import fused_gmp as fg
    from bsms_gnn_tpu_torch.ops.kernels import fused_gmp_dyn as fgd

    level, xwi, xj, pos, wf8, wfd, wfn, ws, bs = args[:9]
    bf16 = xwi.dtype == torch.bfloat16
    send, covered = fg.sender_rows(level)
    send, covered = send[rows], covered[rows]
    recv = level.receivers.long()[rows]
    _, _, _, delta, nrm = fgd._edge_pre_dyn(level, xwi, xj, pos, wf8, wfd,
                                            wfn, bf16)
    first = (fg.dot(level.fiber_t.t()[rows].abs(), wf8.float().abs(), bf16)
             + torch.where(covered[:, None],
                           xwi.float().abs().index_select(0, send), 0.0)
             + xj.float().abs().index_select(0, recv)
             + fg.dot(delta[rows].abs(), wfd.float().abs(), bf16)
             + nrm[rows][:, None] * wfn.float().abs())
    return [first] + [
        fg.dot(torch.relu(z[rows]), w.float().abs(), bf16) + b.float().abs()
        for z, w, b in zip(ins[:-1], ws[:-1], bs[:-1])]


def verify_flips(args, got, want, limits, sparse):
    """(ok, line) of kernel 13's backward's dpre `got` against the plain
    `want` on `args`, where at most FLIP_ROWS_MAX rows miss: each row that
    misses must equal, within the limits, the plain version's row
    recomputed with the ReLU decision of one of the row's units taken on
    the other side, a unit whose |z| (`relu_inputs`, the plain version's
    arithmetic) is within one rounding step of the dtype of its own input
    scale (`input_scales`), tried nearest first; the rows so verified are
    left out, the rest held at both `limits`."""
    from bsms_gnn_tpu_torch.ops.kernels import fused_gmp as fg

    tol_max, tol_rms = limits
    rms = filled_compare(got, want, sparse)[2]
    by_row = (got.float() - want.float()).abs().amax(-1)
    miss = (by_row > tol_max * rms).nonzero()[:, 0]
    if len(miss) > FLIP_ROWS_MAX:
        return False, f"  flips: {len(miss)} rows miss, over {FLIP_ROWS_MAX}"
    level, xwi, xj, pos, wf8, wfd, wfn, ws, bs, g = args
    bf16 = xwi.dtype == torch.bfloat16
    step = 2.0 ** -8 if bf16 else 2.0 ** -24
    ins, counted, recv = relu_inputs("fused_edge_phase_win_dyn_bwd", args)
    scales = input_scales(args, ins, miss)
    ws = [w.float() for w in ws]
    bs = [b.float() for b in bs]
    found = []
    for k, e in enumerate(miss.tolist()):
        pre = ins[0][e:e + 1]
        normed, inv, hs = fg.mlp_tail_fwd_save(pre, ws, bs, bf16)
        ge = g.float()[recv[e]][None] * counted[e]
        if bf16:
            ge = fg.round_bf16(ge)
        near = sorted(
            (float(z[e, u].abs() / (step * s[k, u])), l, u,
             float(z[e, u].abs()))
            for l, (z, s) in enumerate(zip(ins, scales))
            for u in (z[e].abs() <= step * s[k]).nonzero()[:, 0].tolist())
        hit = None
        for ratio, l, u, z in near:
            masks = [pre.clone()] + [h.clone() for h in hs[1:]]
            masks[l][0, u] = 0.0 if masks[l][0, u] > 0 else 1.0
            row = fg.mlp_tail_bwd(masks[0], [hs[0], *masks[1:]], normed,
                                  inv, ge, ws, bf16)[0].to(got.dtype)
            if ((got[e].float() - row[0].float()).abs().max()
                    <= tol_max * rms):
                hit = (l, u, z, ratio)
                break
        found.append((e, len(near), hit))
    keep = torch.ones(got.shape[0], dtype=torch.bool, device=got.device)
    keep[miss] = False
    err, err_rms, rms_k, zero_ok, _ = filled_compare(got[keep], want[keep],
                                                     sparse)
    verified = sum(hit is not None for _, _, hit in found)
    ok = (verified == len(miss) and err <= tol_max * rms_k
          and err_rms <= tol_rms * rms_k and zero_ok)
    rows = "; ".join(
        f"row {e} ({n} units within the step): "
        + (f"layer {hit[0]} unit {hit[1]} |z| {hit[2]:.2e}, "
           f"{hit[3]:.2e} of the step" if hit else "NONE")
        for e, n, hit in found)
    return ok, (f"  flips: {verified} of {len(miss)} rows that miss "
                f"verified, each the plain row with the named unit on its "
                f"other side ({rows}); the other rows max "
                f"{frac(err, rms_k):.2e}, rms {frac(err_rms, rms_k):.2e}: "
                f"{'verified' if ok else 'FAIL'}")


def check_slice(case, device):
    """The forward through the kernels against the forward through the
    plain versions; the launch counts of one forward; a finite rollout."""
    from bsms_gnn_tpu_torch.training.rollout import rollout_trajectory

    sim, hd, node_in, mask = (case[k] for k in ("sim", "hd", "node_in",
                                                 "mask"))
    expected, label = case["expected"], case["label"]
    counts, outs = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        cd = dtype if dtype == torch.bfloat16 else None
        reset_counts()
        got = outs[dtype] = sim(hd, node_in, mask, cd)
        counts[dtype] = read_counts(expected)
        narrow = narrow_calls()
        with plain_path():
            want = sim(hd, node_in, mask, cd)
        delta = (want - node_in[:, :want.shape[-1]]).abs().max().item()
        err = (got - want).abs().max().item()
        tol = FORWARD_TOL[dtype] * max(delta, 1e-3)
        ok = err <= tol and bool(torch.isfinite(got).all())
        print(f"[{label}] forward {str(dtype)[6:]:9s} shape "
              f"{tuple(got.shape)} max_abs_err vs plain {err:.3e} (delta "
              f"scale {delta:.3e}, tol {tol:.3e}) {'ok' if ok else 'FAIL'}")
        print(f"[{label}] launches in one {str(dtype)[6:]} forward: "
              f"{counts[dtype]}; narrow plain calls (kernel 8's, windowed "
              f"transitions') {narrow}")
        require(ok, f"{label} {dtype} forward disagrees with the plain path")
        if device.type == "cuda":
            require(counts[dtype] == expected and narrow == case["narrow"],
                    f"launch counts {counts[dtype]} != {expected} or narrow "
                    f"calls {narrow} != {case['narrow']}")
    # The f32 forward against the bf16 plain forward, beside the bf16
    # check: how far the bf16 rounding moves the forward (printed only; see
    # FORWARD_TOL).
    diff = outs[torch.float32] - want
    print(f"  f32 forward against the bf16 plain forward: max_abs_err "
          f"{diff.abs().max().item():.3e}, rms_err "
          f"{diff.square().mean().sqrt().item():.3e}; bf16 kernels against "
          f"plain: rms_err "
          f"{(got - want).square().mean().sqrt().item():.3e}")
    reset_counts()
    preds = rollout_trajectory(sim, hd, node_in, mask, ROLLOUT_STEPS)
    roll = read_counts(expected)
    finite = bool(torch.isfinite(preds).all())
    print(f"[{label}] rollout {ROLLOUT_STEPS} steps f32: shape "
          f"{tuple(preds.shape)}, finite {finite}, max |pred| "
          f"{preds.abs().max().item():.3e}, launches {roll}")
    require(finite, "rollout produced non-finite values")
    if device.type == "cuda":
        require(roll == {k: v * ROLLOUT_STEPS for k, v in expected.items()},
                f"rollout launch counts {roll}")
    return counts[torch.float32]


def event_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(fn, kernel_names, reps=20):
    """Device ms per call of the CUDA kernels one call of `fn` launches
    once each, each matched by a name in `kernel_names`, from a
    torch.profiler trace of `reps` calls: {name: ms per launch}, or None
    when the trace shows no device time for one of them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = dict.fromkeys(kernel_names, 0.0)
    count = dict.fromkeys(kernel_names, 0)
    for evt in prof.key_averages():
        for name in kernel_names:
            if name in evt.key:
                total[name] += (getattr(evt, "device_time_total", None)
                                or getattr(evt, "cuda_time_total", 0.0))
                count[name] += evt.count
    if any(not count[k] or not total[k] for k in kernel_names):
        return None
    if any(count[k] != reps for k in kernel_names):
        print(f"  note: the trace holds {count} launches of {reps} calls")
    return {k: total[k] / count[k] / 1e3 for k in kernel_names}


def _device_ms(evt):
    return (getattr(evt, "self_device_time_total", None)
            or getattr(evt, "self_cuda_time_total", 0.0)) / 1e3


def work(name, args, dtype):
    """(bytes, operations) the function needs on these inputs: each input
    read once, each output written once; operations of the entries this
    run's layout holds."""
    from bsms_gnn_tpu_torch.ops.kernels.fused_gmp_stream import in_block

    elt = 2 if dtype == torch.bfloat16 else 4
    c = latent_width(args)
    if name in ("fused_edge_phase_win_k", "fused_edge_phase_win_k_bwd"):
        # Kernel 14 does kernel 4's (5's) work; its last argument is K.
        name = {"fused_edge_phase_win_k": "fused_edge_phase_win",
                "fused_edge_phase_win_k_bwd": "fused_edge_phase_win_bwd"}[name]
        args = args[:-1]
    if name == "subwin_conv":
        # x in; ew, send_sub and receivers per slot and the sub-chunk
        # tables in; the f32 output written; a multiply-add per covered
        # slot and column.
        lvl, x, ew, sub_base, send_sub = args[:5]
        live = int((send_sub < 256).sum().item())
        e = lvl.n_pad_edges
        return (x.shape[0] * c * elt + 3 * e * 4 + sub_base.numel() * 4
                + lvl.n_pad_nodes * c * 4), 2 * c * live
    if name in ("fused_edge_phase_win", "fused_edge_phase_win_dyn"):
        lvl, weights = args[0], args[-2]
        live = int((lvl.send_win < lvl.window).sum().item())
        e, n = lvl.n_pad_edges, lvl.n_pad_nodes
        ops = live * (2 * 8 * c + 2 * len(weights) * c * c + 10 * c)
        by = (2 * n * c * elt + 8 * e * 4 + 3 * e * 4 + n * c * 4
              + len(weights) * (c * c + c) * 4 + 8 * c * 4)
        if name == "fused_edge_phase_win_dyn":
            # Kernel 13 adds the world term per in-window slot (Δ, its
            # norm, the wf_dyn dot and the wf_nrm product) and reads the
            # positions and the two weight blocks once.
            wd = args[3].shape[-1]
            ops += live * 2 * (wd + 1) * c
            by += n * wd * elt + (wd + 1) * c * 4
    elif name in ("fused_edge_phase", "fused_edge_mlp_aggregate"):
        # The slots the one-hot counts (receiver in the chunk's block):
        # their streamed rows in, the tail MLP and LN (and kernel 12's
        # receiver add), the add into the output; the receivers, xj
        # (kernel 12), the weights in, the f32 output written.
        lvl, weights = args[0], args[-2]
        live = int(in_block(lvl)[1].sum().item())
        e, n = lvl.n_pad_edges, lvl.n_pad_nodes
        v2 = name == "fused_edge_phase"
        ops = live * (2 * len(weights) * c * c + (11 if v2 else 10) * c)
        by = (live * c * elt + (n * c * elt if v2 else 0) + e * 4
              + n * c * 4 + len(weights) * (c * c + c) * 4)
    elif name in ("fused_edge_phase_bwd", "fused_edge_mlp_aggregate_bwd"):
        # The counted slots' forward again (as kernels 12 / 11 count it),
        # the LN backward, dW and the next cotangent per tail layer (and
        # kernel 12's dxj add). In: the streamed rows, xj (kernel 12), the
        # receivers, g, the weights; out: dzi / dpre for every slot, dxj
        # (kernel 12) and the weight gradients.
        lvl, weights = args[0], args[-3]
        live = int(in_block(lvl)[1].sum().item())
        e, n, layers = lvl.n_pad_edges, lvl.n_pad_nodes, len(weights)
        v2 = name == "fused_edge_phase_bwd"
        ops = live * (6 * layers * c * c + (22 if v2 else 20) * c)
        grads = layers * (c * c + c) * 4
        by = (live * c * elt + e * 4 + n * c * 4 + grads + e * c * elt
              + grads + (n * c * elt + n * c * 4 if v2 else 0))
    elif name == "fused_node_phase":
        x, _, mlp, _ = args
        n, layers = x.shape[0], len(mlp.weights) - 1
        ops = n * (2 * 2 * c * c + 2 * layers * c * c + 12 * c)
        by = (n * c * elt + n * c * 4 + n * c * elt
              + (2 * c * c + layers * c * c + (layers + 1) * c) * 4)
    elif name in ("windowed_rect_conv", "windowed_conv"):
        # x in; ew, send_win, receivers and the chunk tables per slot; the
        # f32 output written; a multiply-add per in-window slot and column.
        op, x = args[:2]
        live = int((op.send_win < op.window).sum().item())
        e = op.n_pad_edges
        ops = 2 * c * live
        by = x.shape[0] * c * elt + 4 * e * 4 + op.n_pad_nodes * c * 4
    elif name == "compact_accum":
        # The real rows' values and receivers in, and the accumulator rows
        # they reach read and written back: the rest of acc is untouched.
        cr, vals, _ = args
        n = cr.n_real
        reached = len(torch.unique(cr.receivers[:n]))
        ops = n * c
        by = n * c * elt + n * 4 + 2 * reached * c * 4
    elif name in ("fused_edge_phase_win_bwd", "fused_edge_phase_win_dyn_bwd"):
        # The in-window slots' forward again (as kernel 4 counts it), then
        # the LN backward, dW and the next cotangent per tail layer, dwf8
        # and the dxj add. In: xwi, xj, the fiber stream, send_win,
        # receivers and win_base, g, the weights; out: dpre, dxj and the
        # weight gradients.
        lvl, weights = args[0], args[-3]
        live = int((lvl.send_win < lvl.window).sum().item())
        e, n, layers = lvl.n_pad_edges, lvl.n_pad_nodes, len(weights)
        ops = live * (2 * 2 * 8 * c + 6 * layers * c * c + 21 * c)
        grads = (layers * (c * c + c) + 8 * c) * 4
        by = (2 * n * c * elt + 8 * e * 4 + 3 * e * 4 + n * c * 4 + grads
              + e * c * elt + n * c * 4 + grads)
        if name == "fused_edge_phase_win_dyn_bwd":
            # The world term of the recompute (as kernel 13 counts it),
            # then dwf_dyn and dwf_nrm; the positions read, the two weight
            # blocks read and their gradients written.
            wd = args[3].shape[-1]
            ops += live * (2 * (wd + 1) * c + 2 * (wd + 1) * c)
            by += n * wd * elt + 2 * (wd + 1) * c * 4
    elif name == "fused_node_phase_bwd":
        # Every row's forward again (as kernel 3 counts it), the LN
        # backward, dW and the next cotangent per tail layer, then dx,
        # daggr, dWa, dWb and db0. In: x, aggr, g, the weights; out: dx,
        # daggr and the weight gradients.
        x, _, mlp, _, _ = args
        n, layers = x.shape[0], len(mlp.weights) - 1
        ops = n * (3 * 2 * 2 * c * c + 6 * layers * c * c + 25 * c)
        grads = (2 * c * c + layers * c * c + (layers + 1) * c) * 4
        by = n * c * elt + 2 * n * c * 4 + grads + n * c * elt + n * c * 4 + grads
    elif name in ("segment_sum", "segment_sum_accum"):
        # The slots the row table keeps: their rows and slot indices in,
        # the row pointers in, the f32 output written (kernel 9 on acc: acc
        # read too; its store form reads none); one add per slot and column.
        lvl, feat = args[:2]
        kept, n = lvl.row_slots.numel(), lvl.n_pad_nodes
        ops = kept * c
        by = kept * c * elt + 4 * kept + 4 * (n + 1) + n * c * 4
        if name == "segment_sum_accum" and args[2] is not None:
            by += n * c * 4
    elif name == "fused_aggregate_node_phase":
        # Kernel 8's reads, then kernel 3's function with the aggregate
        # kept on chip: x and the weights in, the output (in the compute
        # dtype) written.
        lvl, feat, x, mlp, _ = args
        kept, n = lvl.row_slots.numel(), x.shape[0]
        layers = len(mlp.weights) - 1
        ops = kept * c + n * (2 * 2 * c * c + 2 * layers * c * c + 12 * c)
        by = (kept * c * elt + 4 * kept + 4 * (n + 1) + n * c * x.element_size()
              + n * c * elt
              + (2 * c * c + layers * c * c + (layers + 1) * c) * 4)
    else:
        # The in-window slots' rows in, send_win in, the output written.
        lvl, vals = args
        live = int((lvl.send_win < lvl.window).sum().item())
        ops = live * c
        by = live * c * elt + lvl.n_pad_edges * 4 + lvl.n_pad_nodes * c * 4
    return by, ops


def window_matrix(op, ew, n_in):
    """Kernel 1's function as a CSR matrix [n_pad_nodes, n_in]: the
    in-window slots' weights at (receiver, sender row)."""
    live = op.send_win < op.window
    base = op.win_base.long().repeat_interleave(op.edge_block)
    cols = (base * (op.window // 2) + op.send_win.long())[live]
    rows = op.receivers.long()[live]
    m = torch.sparse_coo_tensor(torch.stack([rows, cols]), ew.float()[live],
                                (op.n_pad_nodes, n_in))
    return m.coalesce().to_sparse_csr()


def library_call(name, args):
    """One PyTorch call computing the same function, or None."""
    if name in ("windowed_rect_conv", "windowed_conv"):
        op, x = args[:2]
        ew = op.ew if name == "windowed_rect_conv" else args[2]
        m = window_matrix(op, ew, x.shape[0])
        xf = x.float()
        return lambda: torch.sparse.mm(m, xf)
    if name == "subwin_conv":
        from bsms_gnn_tpu_torch.ops.kernels.subwin_conv import covered_rows

        lvl, x, ew = args[:3]
        rows, cols, keep = covered_rows(lvl, *args[3:5])
        m = torch.sparse_coo_tensor(torch.stack([rows, cols]), ew.float()[keep],
                                    (lvl.n_pad_nodes, x.shape[0]))
        m = m.coalesce().to_sparse_csr()
        xf = x.float()
        return lambda: torch.sparse.mm(m, xf)
    if name == "compact_accum":
        cr, vals, acc = args
        idx = cr.receivers[:cr.n_real].long()
        v = vals[:cr.n_real].float()
        a = acc.clone()
        return lambda: a.index_add_(0, idx, v)
    if name == "segment_sum":
        lvl, feat = args[:2]
        slots = lvl.row_send if args[2:] and args[2] else lvl.row_slots
        rows = lvl.receivers.index_select(0, lvl.row_slots).long()
        v = feat.index_select(0, slots).float()
        a = torch.zeros(lvl.n_pad_nodes, feat.shape[-1], device=feat.device)
        return lambda: a.index_add_(0, rows, v)
    if name == "segment_sum_accum":
        lvl, feat, acc = args[:3]
        slots = lvl.row_send if args[3:] and args[3] else lvl.row_slots
        rows = lvl.receivers.index_select(0, lvl.row_slots).long()
        v = feat.index_select(0, slots).float()
        if acc is None:  # the store form: onto zeros
            acc = torch.zeros(lvl.n_pad_nodes, feat.shape[-1],
                              device=feat.device)
        return lambda: acc.float().index_add(0, rows, v)
    if name == "windowed_send_sum":
        lvl, vals = args
        live = lvl.send_win < lvl.window
        base = lvl.win_base.long().repeat_interleave(lvl.edge_block)
        idx = (base * (lvl.window // 2) + lvl.send_win.long())[live]
        v = vals[live].float()
        a = torch.zeros(lvl.n_pad_nodes, vals.shape[-1], device=vals.device)
        return lambda: a.index_add_(0, idx, v)
    return None


def measure(case):
    """Serving times of the case: ms per forward (f32, bf16) through the
    kernels and through the plain versions, one profiled forward each, ms
    per rollout step; then each forward kernel of the case's path, timed
    at its first listed shape (the others printed)."""
    sim, hd, node_in, mask = (case[k] for k in ("sim", "hd", "node_in",
                                                 "mask"))
    from bsms_gnn_tpu_torch.training.rollout import rollout_trajectory

    label = case["label"]
    t, busy = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        cd = dtype if dtype == torch.bfloat16 else None
        # The eager forward waits on the host, whose speed varies: five
        # repeats of ten forwards, and their median.
        runs = [event_ms(lambda: sim(hd, node_in, mask, cd), reps=10)
                for _ in range(5)]
        t[dtype] = float(np.median(runs))
        with plain_path():
            tp = event_ms(lambda: sim(hd, node_in, mask, cd), reps=10)
        print(f"[{label}] forward {str(dtype)[6:]}: {t[dtype]:.4f} ms through "
              f"the kernels (median of {[round(r, 4) for r in runs]}, each "
              f"the mean of 10 forwards by CUDA events), {tp:.4f} ms through "
              f"the plain versions")
    peak = {}
    for dtype in (torch.float32, torch.bfloat16):
        cd = dtype if dtype == torch.bfloat16 else None
        prof = profile_call(lambda: sim(hd, node_in, mask, cd))
        print_profile(f"[{label}] forward {str(dtype)[6:]}", *prof)
        busy[dtype] = prof[1]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2**20
        sim(hd, node_in, mask, cd)
        torch.cuda.synchronize()
        peak[dtype] = torch.cuda.max_memory_allocated() / 2**20 - held
        print(f"[{label}] forward {str(dtype)[6:]}: peak memory "
              f"{peak[dtype]:.1f} MiB above the {held:.1f} held before it "
              f"({held_line()})")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rollout_trajectory(sim, hd, node_in, mask, ROLLOUT_STEPS)
    torch.cuda.synchronize()
    step = (time.perf_counter() - t0) * 1e3 / ROLLOUT_STEPS
    roll = profile_call(lambda: rollout_trajectory(sim, hd, node_in, mask, 2))
    print(f"[{label}] rollout f32: {step:.4f} ms per step (host clock over "
          f"{ROLLOUT_STEPS} steps); device busy {roll[1] / 2:.4f} ms per step "
          f"(profile of a 2-step rollout), idle share {1 - roll[1] / 2 / step:.3f}")

    rows = {}
    timed = case.get("timed")
    for dtype in (torch.float32, torch.bfloat16):
        for name, shapes in kernel_inputs(case, dtype, node_in.device).items():
            if timed is not None and name not in timed:
                continue
            rows[(name, dtype)] = time_kernel(name, *shapes[0], dtype)
            if (case["cfg"].aggregation == "pallas"
                    or name in EVERY_SHAPE_TIMED):
                for where, args in shapes[1:]:
                    time_kernel(name, where, args, dtype)
    return rows, {"forward_ms_f32": t[torch.float32],
                  "forward_ms_bf16": t[torch.bfloat16],
                  "forward_busy_ms_f32": busy[torch.float32],
                  "forward_busy_ms_bf16": busy[torch.bfloat16],
                  "forward_peak_above_mib_f32": peak[torch.float32],
                  "forward_peak_above_mib_bf16": peak[torch.bfloat16],
                  "rollout_step_ms_f32": step,
                  "rollout_step_busy_ms_f32": roll[1] / 2}


def time_kernel(name, where, args, dtype):
    """One kernel at the main path's shapes: its device time (the sum of
    the CUDA kernels one call launches, from the profiler), its time with
    the wrapper (CUDA events), the plain version's, the library call's
    (f32 only) and the card's bound for the work."""
    fn, plain = kernel_modules()[name]
    parts = kernel_device_ms(lambda: fn(*args), KERNEL_META[name][2])
    ms = None if parts is None else sum(parts.values())
    ev = event_ms(lambda: fn(*args), reps=50)
    pms = event_ms(lambda: plain(*args), reps=20)
    lib = library_call(name, args) if dtype == torch.float32 else None
    lms = event_ms(lib, reps=50) if lib is not None else None
    by, ops = work(name, args, dtype)
    bound_b = by / PEAK_BYTES_S * 1e3
    bound_o = ops / PEAK_FLOPS_S[dtype] * 1e3
    by_what = "bytes" if bound_b >= bound_o else "operations"
    print(f"time {name:26s} {where:12s} {str(dtype)[6:]:9s} "
          f"kernel {ms if ms is not None else float('nan'):.5f} ms "
          f"(profiler) {ev:.5f} ms (events, with the wrapper)  "
          f"plain {pms:.5f} ms  library "
          f"{'null' if lms is None else f'{lms:.5f} ms'}  bound "
          f"{max(bound_b, bound_o):.5f} ms by {by_what} ({by} B, {ops} op)")
    if parts is not None and len(parts) > 1:
        print("  kernel time by launch: " + ", ".join(
            f"{k} {v:.5f} ms" for k, v in parts.items()))
    return dict(ms=ms if ms is not None else ev, plain_ms=pms,
                bound_ms=max(bound_b, bound_o), bound_by=by_what,
                library_ms=lms, event_ms=ev)


def bwd_kernel_inputs(case, dtype, device):
    """Each backward kernel's arguments at level 0 of the main path, from
    a seed: the forward kernels' inputs plus the output's cotangent."""
    hd, sim = case["hd"], case["sim"]
    g = torch.Generator(device="cpu").manual_seed(8)

    def rand(*shape, dt=torch.float32, s=1.0, gen=g):
        return (s * torch.randn(*shape, generator=gen)).to(dt).to(device)

    def walk_shapes(name, args):
        return level_shapes(hd, name, rand, g, args)

    lvl = hd.levels[0]
    gmp = sim.process.down_gmps[0]
    c, n0, e0 = case["cfg"].latent_dim, lvl.n_pad_nodes, lvl.n_pad_edges
    mlp_e = (list(gmp.mlp_edge.weights)[1:], list(gmp.mlp_edge.biases)[1:])
    cd = dtype if dtype == torch.bfloat16 else None

    def tail(l):
        return level_tail(sim, hd, l)

    if interleave(case) > 1:
        # Kernel 14's backward at every level that passes the density gate
        # (the first drawn from g, each later one from a generator of its
        # own) and, beside it, kernel 5 at the first.
        def gated(rnd, l=None):
            where, args = gated_edge_args(case, rnd, dtype, l)
            return where, (*args, rnd(args[0].n_pad_nodes, c))

        first = gated(rand)
        later = [gated(functools.partial(
            rand, gen=torch.Generator(device="cpu").manual_seed(
                WALK_SEED["fused_edge_phase_win_k_bwd"] + l)), l)
            for l in gated_levels(case)[1:]]
        return {"fused_edge_phase_win_k_bwd": [
                    (w, (*a, interleave(case))) for w, a in [first, *later]],
                "fused_edge_phase_win_bwd": [first]}
    if unwindowed(case):
        if case["cfg"].world_edges:
            return {"fused_edge_mlp_aggregate_bwd": walk_shapes(
                "fused_edge_mlp_aggregate_bwd", lambda l, d, r: (
                    d, r(d.n_pad_edges, c, dt=dtype), *tail(l),
                    r(d.n_pad_nodes, c)))}
        # Kernel 12's backward at every level (level 0's draw first, from
        # g).
        return {"fused_edge_phase_bwd": walk_shapes(
            "fused_edge_phase_bwd", lambda l, d, r: (
                d, r(d.n_pad_edges, c, dt=dtype),
                r(d.n_pad_nodes, c, dt=dtype), *tail(l),
                r(d.n_pad_nodes, c)))}
    if case["cfg"].world_edges:
        # Kernel 13's backward at every level: level 0 on the case's own
        # world positions, the later levels on unit-normal ones.
        def dyn_args(l, d, r):
            n = d.n_pad_nodes
            pos = (case["node_in"][:, :3].to(dtype) if l == 0
                   else r(n, 3, dt=dtype))
            args = (d, r(n, c, dt=dtype), r(n, c, dt=dtype), pos,
                    *first_layer(level_gmp(sim, hd, l)), *tail(l), r(n, c))
            return kink_free(case, "fused_edge_phase_win_dyn_bwd", args, l)

        edge = {"fused_edge_phase_win_dyn_bwd": walk_shapes(
            "fused_edge_phase_win_dyn_bwd", dyn_args),
            "fused_edge_mlp_aggregate_bwd": [
                ("level 0", (lvl, rand(e0, c, dt=dtype), *mlp_e,
                             rand(n0, c)))]}
    else:
        edge = {"fused_edge_phase_win_bwd": walk_shapes(
            "fused_edge_phase_win_bwd", lambda l, d, r: kink_free(
                case, "fused_edge_phase_win_bwd", (
                    d, r(d.n_pad_nodes, c, dt=dtype),
                    r(d.n_pad_nodes, c, dt=dtype),
                    first_layer(level_gmp(sim, hd, l))[0], *tail(l),
                    r(d.n_pad_nodes, c)), l))}
    node = walk_shapes("fused_node_phase_bwd", lambda l, d, r: kink_free(
        case, "fused_node_phase_bwd", (
            r(d.n_pad_nodes, c, dt=dtype), r(d.n_pad_nodes, c, s=3.0),
            level_gmp(sim, hd, l).mlp_node, r(d.n_pad_nodes, c), cd), l))
    node[1:1] = ([("f32 x", (rand(n0, c), rand(n0, c, s=3.0), gmp.mlp_node,
                             rand(n0, c), cd))] if cd is not None else [])
    # Kernel 7 at level 0 and at the level of the longest sender lists; then
    # at the case's `send_levels` (each from a generator of its own).
    send = [("level 0", (lvl, rand(e0, c, dt=dtype)))]
    deep = longest_send_level(hd)
    if deep:
        d = hd.levels[deep]
        send.append((f"level {deep}", (d, rand(d.n_pad_edges, c, dt=dtype))))
    for l in case.get("send_levels", ()):
        if l not in (0, deep):
            d = hd.levels[l]
            send.append((f"level {l}", (d, rand(
                d.n_pad_edges, c, dt=dtype, gen=torch.Generator(
                    device="cpu").manual_seed(SEND_SEED + l)))))
    return {**edge, "fused_node_phase_bwd": node, "windowed_send_sum": send}


def level_gmp(sim, hd, l):
    """The GMP that runs on level l going down (the bottom one at the last
    level)."""
    return (sim.process.down_gmps[l] if l < hd.depth
            else sim.process.bottom_gmp)


def level_tail(sim, hd, l):
    """(weights, biases) of the tail of level l's edge MLP."""
    m = level_gmp(sim, hd, l).mlp_edge
    return list(m.weights)[1:], list(m.biases)[1:]


def sparse_ops(hd):
    """(name, operator) of the transitions' operators that run kernel 8
    (unwindowed, no dense form), T0 down first."""
    return [(f"T{l} {w}", op) for l, t in enumerate(hd.transitions)
            for w, op in (("down", t.down_op), ("up", t.up_op))
            if op is not None and op.window <= 0 and op.dense is None]


def level_shapes(hd, name, rand, g, args):
    """(where, arguments) of a kernel checked at every level: level 0 drawn
    from g, each later level of WALK_LEVELS[name] from a generator of its
    own (seed WALK_SEED[name] + level), so that adding a level moves no
    other kernel's inputs. args(l, level, rand) makes the arguments."""
    return [(f"level {l}", args(l, d, functools.partial(
                rand, gen=g if l == 0 else torch.Generator(
                    device="cpu").manual_seed(WALK_SEED[name] + l))))
            for l, d in walk_levels(hd, name)]


def walk_levels(hd, name):
    """(level index, level) of a tile-walk kernel's shapes: level 0, then
    those of WALK_LEVELS[name] that the hierarchy has (the cylinder, at
    depth 5, stops at level 5)."""
    return [(l, hd.levels[l]) for l in (0, *WALK_LEVELS[name])
            if l < len(hd.levels)]


def latent_width(args):
    """The latent width of a kernel's arguments: the last dim of the
    first row tensor whose width is a multiple of 128."""
    return next(a.shape[-1] for a in args if torch.is_tensor(a)
                and a.dim() >= 2 and a.shape[-1] % 128 == 0)


def tail_weights(args):
    """The tail weights of an edge kernel's arguments (the first list)."""
    return next(a for a in args if isinstance(a, list))


def walk_line(name, where, dtype, args):
    """The tile walk's launch shape for one call of a kernel on a tile walk
    (TILE_WALKS): its tiles, the rows of a tile, the blocks per SM the
    kernel reaches and the grid."""
    from bsms_gnn_tpu_torch.ops.kernels import fused_gmp

    fn = f"{name}_{'bf16' if dtype == torch.bfloat16 else 'f32'}"
    c, layers = latent_width(args), len(tail_weights(args))
    keys = [k for k in fused_gmp._walks
            if k[0] == fn and k[1] == c and k[2] == layers]
    require(bool(keys), f"{name}: no tile walk shape was read")
    front = "dyn" if "_dyn" in name else "win" if "_win" in name else "stream"
    rows = fused_gmp.walk_plan(c, layers, front, dtype,
                               backward=name.endswith("_bwd"))[1]
    fill = fused_gmp._walks[keys[0]]
    tiles = args[0].n_pad_edges // rows
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return (f"walk {name} {where} {str(dtype)[6:]}: {tiles} tiles of {rows} "
            f"rows, {fill // sms} blocks per SM reached, grid "
            f"{len(fused_gmp.tile_ranges(tiles, fill)) - 1}")


def node_walk_line(name, where, dtype, args):
    """Kernel 3's or 6's launch shape for one call: its tiles, the CTAs of
    a tile's cluster, the grid, and the SMs it can fill against the one
    block per tile it replaces; for kernel 3 also the CTAs per SM and the
    clusters the card holds at once (`node_mlp.occupancy`), for kernel 6
    its weight-gradient partials, one cluster each (at most
    `node_mlp.p_max`)."""
    from bsms_gnn_tpu_torch.ops.kernels import node_mlp

    x, cd = args[0], args[-1]
    c = x.shape[-1]
    tiles = x.numel() // (c * node_mlp.ROWS)
    clusters = tiles
    if name == "fused_node_phase_bwd":
        cap = node_mlp.p_max(x.dtype, cd, len(args[2].weights) - 1, x.device,
                             c)
        clusters = min(tiles, cap)
    cl = node_mlp.cluster_of(c)
    ctas = clusters * cl
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    line = (f"walk {name} {where} {str(dtype)[6:]}: {tiles} tiles of "
            f"{node_mlp.ROWS} rows, clusters of {cl} CTAs, grid "
            f"{ctas} CTAs; SMs it can fill {min(ctas, sms)} of {sms} (one "
            f"block per tile: {min(tiles, sms)})")
    if name == "fused_node_phase":
        per_sm, at_once = node_mlp.occupancy(x.dtype, cd, c)
        line += (f"; {per_sm} CTAs per SM, {at_once} clusters at once "
                 f"({'one wave' if tiles <= at_once else 'more than one wave'})")
    else:
        line += f"; {clusters} weight-gradient partials (the cap {cap})"
    return line


def row_walk_line(name, where, dtype, args):
    """Kernel 8's, 9's or 10's launch shape for one call: kernel 8's and
    9's lists (the longest, the rows cut into pieces) and grid; kernel 10's
    tile (`agg_node.tile_design`) and grid."""
    from bsms_gnn_tpu_torch.ops.kernels import agg_node

    lvl = args[0]
    line = (f"walk {name} {where} {str(dtype)[6:]}: lists "
            f"{row_list_summary(lvl.row_ptr)}")
    if name in ("segment_sum", "segment_sum_accum"):
        n, n_long = lvl.n_pad_nodes, lvl.row_long.numel()
        return line + f", grid {-(-n // 32) + n_long} blocks of 8 warps"
    n = args[2].shape[0]
    tile = agg_node.tile_design(n, torch.cuda.get_device_properties(
        args[2].device).multi_processor_count)
    rows = agg_node.TILES[tile][1]
    grid = (f"{n // rows * agg_node.CLUSTER} CTAs in clusters of "
            f"{agg_node.CLUSTER}" if tile.startswith("cluster")
            else f"{n // rows} blocks")
    return line + f"; {tile}: {n // rows} tiles of {rows} rows, grid {grid}"


def frac(a, b):
    """a / b, where an all-zero reference (b = 0) allows no error."""
    return a / b if b else (0.0 if a == 0 else float("inf"))


def filled_compare(got, want, sparse):
    """(largest error, RMS error, RMS of want, whether got is exactly zero
    on every row that want leaves zero, whether want fills any row). Where
    `sparse`, the errors and the RMS are taken over the rows that want
    fills and the other rows are checked; elsewhere over every row."""
    filled = (want.reshape(want.shape[0], -1) != 0).any(-1)
    live = bool(filled.any())
    if not sparse:
        return (*compare(got, want), True, live)
    if not live:
        return 0.0, 0.0, 0.0, bool((got == 0).all()), False
    return (*compare(got[filled], want[filled]),
            bool((got[~filled] == 0).all()), True)


def longest_send_level(hd):
    """The windowed level with the longest of kernel 7's sender lists: its
    rows of more than 32 slots take the gather's long path."""
    def longest(l):
        return int(torch.diff(hd.levels[l].send_row_ptr).max())

    return max((l for l, g in enumerate(hd.levels) if g.window > 0),
               key=longest)


def check_bwd_kernels(case, device, inputs=None):
    """Every backward kernel against its plain version on the same inputs,
    each output on its own, and in bf16 a control (the f32 kernel on the
    upcast inputs) that must miss the tolerance in every output the plain
    version does not leave all zero. `inputs(dtype)` gives the kernels'
    arguments (default: `bwd_kernel_inputs` of the case). Returns
    {(name, dtype): largest max_abs_err over the outputs} at the first
    shape listed."""
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        by_name = (bwd_kernel_inputs(case, dtype, device) if inputs is None
                   else inputs(dtype))
        for name, shapes in by_name.items():
            if name in case.get("skip", ()):
                continue
            fn, plain = kernel_modules()[name]
            for where, args in shapes:
                got, want = fn(*args), plain(*args)
                if name == "windowed_send_sum":
                    got, want = (got,), (want,)
                if name in TILE_WALKS or name in NODE_CLUSTERS:
                    again = fn(*args)
                    same = all(torch.equal(a, b) for a, b in zip(got, again))
                    line = (walk_line(name, where, dtype, args)
                            if name in TILE_WALKS
                            else node_walk_line(name, where, dtype, args))
                    print(line + "; two calls "
                          + ("bit-identical" if same else "DIFFER"))
                    require(same, f"{name} {where} {dtype}: two calls on the "
                                  f"same inputs differ")
                ctrl = None
                if name in BWD_CONTROLS and dtype == torch.bfloat16:
                    up = [a.float() if isinstance(a, torch.Tensor)
                          and a.dtype == torch.bfloat16 else a for a in args]
                    if name == "fused_node_phase_bwd":
                        up[4] = None
                    ctrl = fn(*up)
                worst = 0.0
                # A tile walk's later shapes are levels of few or no live
                # slots, where most rows of dpre and dxj are zero by
                # construction: the measures there are taken over the rows
                # the plain output fills, and every other row must be
                # exactly zero (over all rows the RMS would shrink by
                # sqrt(rows / filled), 16x for dpre at airfoil level 6).
                sparse = name in TILE_WALKS and where != shapes[0][0]
                for i, out in enumerate(BWD_OUTPUTS[name]):
                    tol_max, tol_rms = BWD_TOL[(name, dtype)]
                    err, err_rms, rms, zero_ok, live = filled_compare(
                        got[i], want[i], sparse)
                    rows = int(((got[i].float() - want[i].float()).abs()
                                .amax(-1) > 1e-2 * rms).sum())
                    ok = (err <= tol_max * rms and err_rms <= tol_rms * rms
                          and zero_ok
                          and bool(torch.isfinite(got[i]).all())
                          and got[i].dtype == want[i].dtype)
                    line = (f"kernel {name:24s} {where:8s} {out:5s} "
                            f"{str(dtype)[6:]:9s} max_abs_err {err:.3e} "
                            f"({frac(err, rms):.2e} of rms {rms:.3e}"
                            f"{' over the filled rows' if sparse else ''}, tol "
                            f"{tol_max:.0e}, row {worst_row(got[i], want[i])})"
                            f"  rms_err {frac(err_rms, rms):.2e} "
                            f"(tol {tol_rms:.0e}), {rows} rows off by more "
                            f"than 1e-2 of rms  {'ok' if ok else 'FAIL'}")
                    if ctrl is not None and not live:
                        line += "; no control: the plain output is all zero"
                    elif ctrl is not None:
                        c_err, c_rms, _, c_zero, _ = filled_compare(
                            ctrl[i], want[i], sparse)
                        missed = (c_err > tol_max * rms
                                  or c_rms > tol_rms * rms or not c_zero)
                        line += (f"; control max {frac(c_err, rms):.2e}, rms "
                                 f"{frac(c_rms, rms):.2e}: "
                                 f"{'misses, ok' if missed else 'PASSES'}")
                    print(line)
                    if not ok and name in RELU_DIAGNOSED:
                        print(relu_margin(name, args, got[i], want[i],
                                          tol_max * rms, ROW_KIND.get(
                                              out, "all")))
                        if (case.get("dense") and out == "dpre" and name
                                == "fused_edge_phase_win_dyn_bwd"):
                            ok, note = verify_flips(
                                args, got[i], want[i], (tol_max, tol_rms),
                                sparse)
                            print(note)
                    if ctrl is not None and live:
                        require(missed, f"{name} {where} {out}: the bf16 "
                                        f"tolerance does not tell an "
                                        f"unrounded kernel apart")
                    require(ok, f"{name} {where} {out} {dtype} disagrees "
                                f"with plain")
                    worst = max(worst, err)
                errs.setdefault((name, dtype), worst)
    return errs


def check_wide_stream(case):
    """A GMP with a WIDE_WD-wide world stream (fiber_dims (WIDE_WD,
    pos_dim), the case's latent and hidden widths, seeded weights) on the
    case's windowed level 0: wider than kernel 13 takes, so the fused
    method routes it to v1. Forward and backward through the kernels
    against the plain route (output, x gradient, every parameter
    gradient, WIDE_TOL); kernel 11 must run forward and backward once and
    kernel 13 not at all."""
    from bsms_gnn_tpu_torch.ops.message import GMP

    lvl, cfg, label = case["hd"].levels[0], case["cfg"], case["label"]
    device = lvl.send_win.device
    gmp = GMP(cfg.latent_dim, cfg.hidden_layer, cfg.pos_dim,
              torch.Generator().manual_seed(3),
              fiber_dims=(WIDE_WD, cfg.pos_dim)).to(device)
    g = torch.Generator().manual_seed(12)
    n, m = lvl.n_pad_nodes, lvl.n_nodes
    x0 = torch.randn(n, cfg.latent_dim, generator=g).to(device)
    pos = torch.zeros(n, WIDE_WD)
    pos[:m] = torch.randn(m, WIDE_WD, generator=g)
    pos = pos.to(device)
    cot = torch.randn(n, cfg.latent_dim, generator=g).to(device)

    def run():
        gmp.zero_grad(set_to_none=True)
        x = x0.clone().requires_grad_()
        out = gmp(lvl, x, None, pos, "fused")
        (out * cot).sum().backward()
        return out.detach(), {"x": x.grad, **{
            k: p.grad for k, p in gmp.named_parameters()}}

    names = ("fused_edge_mlp_aggregate", "fused_edge_mlp_aggregate_bwd",
             "fused_edge_phase_win_dyn", "fused_edge_phase_win_dyn_bwd")
    reset_counts()
    got, grads = run()
    counts = read_counts(names)
    with plain_path():
        want, grads_p = run()
    err, err_rms, rms = compare(got, want)
    tol_max, tol_rms = WIDE_TOL["output"]
    ok = err <= tol_max * rms and err_rms <= tol_rms * rms
    rel, _ = grad_errors(grads, grads_p)
    worst_max, worst_rms = max(rel), max(rel, key=lambda r: r[1])
    g_max, g_rms = WIDE_TOL["grad"]
    ok_g = worst_max[0] <= g_max and worst_rms[1] <= g_rms
    print(f"[{label}] GMP with a {WIDE_WD}-wide world stream at level 0: "
          f"output max_abs_err {err / rms:.2e} of rms (tol {tol_max:.0e}), "
          f"rms_err {err_rms / rms:.2e} (tol {tol_rms:.0e}); {len(rel)} "
          f"gradients, worst max err {worst_max[0]:.2e} of rms "
          f"({worst_max[2]}, tol {g_max:.0e}), worst rms err "
          f"{worst_rms[1]:.2e} ({worst_rms[2]}, tol {g_rms:.0e}); launches "
          f"{counts}  {'ok' if ok and ok_g else 'FAIL'}")
    require(ok and ok_g, f"{label}: the wide-stream GMP disagrees with the "
                         f"plain route")
    if device.type == "cuda":
        require(counts == dict(zip(names, (1, 1, 0, 0))),
                f"{label}: the wide-stream GMP did not run kernel 11 alone")


def train_target(case):
    """A seeded next-step target near the input fields; masked nodes keep
    theirs."""
    node_in, mask = case["node_in"], case["mask"]
    c = case["cfg"].out_dim
    g = torch.Generator(device="cpu").manual_seed(11)
    step = 0.1 * torch.randn(node_in.shape[0], c, generator=g)
    return node_in[:, :c] + step.to(node_in.device) * mask


def step_grads(sim, hd, node_in, tar, mask, cd):
    """The loss and every parameter's gradient of one train step."""
    from bsms_gnn_tpu_torch.training.trainer import masked_rmse

    sim.zero_grad(set_to_none=True)
    loss = masked_rmse(sim(hd, node_in, mask, cd), tar, mask)
    loss.backward()
    grads = {k: p.grad.detach().clone() for k, p in sim.named_parameters()}
    sim.zero_grad(set_to_none=True)
    return loss.item(), grads


def kernel5_fault(kind):
    """(module, attribute, stand-in) of a faulty kernel 5 for the wide
    phase's controls; the stand-in counts its launches on itself. `dpre`:
    its dpre rounded to bf16 (the bf16 mode's rounding, where the f32 step
    keeps dpre exact) before kernel 7 sums it for the sender side; `bf16`:
    the whole backward in its bf16 mode (every dot operand rounded to
    bf16) on the f32 step's inputs, as a wrapper that picked the wrong
    entry would run it."""
    from bsms_gnn_tpu_torch.ops.kernels import fused_gmp

    bwd = fused_gmp.fused_edge_phase_win_bwd

    def fault(level, xwi, xj, wf8, weights, biases, g):
        if kind == "dpre":
            dpre, dxj, *rest = bwd(level, xwi, xj, wf8, weights, biases, g)
            return (dpre.to(torch.bfloat16).to(dpre.dtype), dxj, *rest)
        dpre, *rest = bwd(level, xwi.to(torch.bfloat16),
                          xj.to(torch.bfloat16), wf8, weights, biases, g)
        return (dpre.to(xwi.dtype), *rest)

    fault.launches = 0
    return fused_gmp, "fused_edge_phase_win_bwd", fault


def grad_errors(grads, want):
    """(largest error / RMS, RMS error / RMS, name) of each gradient with a
    nonzero reference, and the names of those that are exactly zero on
    both sides; requires every gradient finite, and zero where the
    reference is (the bottom level of 1 node has no edge)."""
    rel, zero = [], []
    for k, w in want.items():
        err, err_rms, rms = compare(grads[k], w)
        require(bool(torch.isfinite(grads[k]).all()),
                f"{k}: gradient not finite")
        if rms == 0:
            require(err == 0, f"{k}: nonzero gradient, the reference has none")
            zero.append(k)
            continue
        rel.append((err / rms, err_rms / rms, k))
    return rel, zero


def make_trainer(case, device, cd):
    """A `Trainer` of the case's model (with the case's noise) with a
    two-step warmup gate and a learning rate that is not 0 from its second
    update on."""
    from bsms_gnn_tpu_torch.config import OptConfig
    from bsms_gnn_tpu_torch.training.trainer import Trainer

    cfg = case["config"](accumulation_steps=TRAIN_GATE)
    opt = OptConfig(peak_lr=1e-4, warmup_steps=2, decay_steps=1000)
    return Trainer(cfg, opt, generator=torch.Generator().manual_seed(1),
                   device=device, compute_dtype=cd)


@contextlib.contextmanager
def own_peak():
    """Yields a one-element list that holds, after the block, the MiB the
    block allocated on the card at its peak above what it started with (0
    without a card)."""
    out = [0.0]
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
    yield out
    if cuda:
        torch.cuda.synchronize()
        out[0] = (torch.cuda.max_memory_allocated() - held) / 2**20


def train_verdict(case, dtype, loss, grads, grads_q=None, what=""):
    """Whether a train step's loss and gradients hold against the case's
    deterministic plain step (`case["plain_step"]`, as `check_train` took
    it) within the case's limits (`train_tol`: the loss's relative error,
    the worst largest and the worst RMS error of a gradient over its RMS;
    with `train_median`, also the median over the gradients of the RMS
    error over RMS); prints the reading, with the plain path with atomics
    (grads_q) against the same reference where given."""
    loss_p, grads_p = case["plain_step"][dtype]
    tol_loss, tol_max, tol_rms = case.get("train_tol", TRAIN_TOL)[dtype]
    tol_median = case.get("train_median", {}).get(dtype, float("inf"))
    rel, zero = grad_errors(grads, grads_p)
    worst_max, worst_rms = max(rel), max(rel, key=lambda r: r[1])
    median = float(np.median([r[1] for r in rel]))
    loss_err = abs(loss - loss_p) / abs(loss_p)
    ok = (loss_err <= tol_loss and worst_max[0] <= tol_max
          and worst_rms[1] <= tol_rms and median <= tol_median)
    atomics = ""
    if grads_q is not None:
        self_rel, _ = grad_errors(grads_q, grads_p)
        atomics = (f"; the plain path with atomics against it: worst max "
                   f"{max(self_rel)[0]:.2e}, worst rms "
                   f"{max(r[1] for r in self_rel):.2e}, median rms "
                   f"{float(np.median([r[1] for r in self_rel])):.2e}")
    print(f"[{case['label']}] train step{what} {str(dtype)[6:]:9s} loss "
          f"{loss:.6e} (plain {loss_p:.6e}, rel err {loss_err:.2e}, tol "
          f"{tol_loss:.0e}); {len(rel)} gradients, worst max err "
          f"{worst_max[0]:.2e} of rms ({worst_max[2]}, tol {tol_max:.1e}), "
          f"worst rms err {worst_rms[1]:.2e} of rms ({worst_rms[2]}, tol "
          f"{tol_rms:.1e}), median rms err {median:.2e}"
          + ("" if tol_median == float("inf") else f" (tol {tol_median:.1e})")
          + f"; {len(zero)} exactly zero on both paths{atomics}  "
          f"{'ok' if ok else 'FAIL'}")
    return ok


def check_train(case, device):
    """The train step through the kernels against the same step through
    the plain versions; the launch counts of one step; a short `Trainer`
    run. Returns the f32 step's launch counts."""
    sim, hd, mask = (case[k] for k in ("sim", "hd", "mask"))
    node_in, tar = case["train"]
    expected, label = case["expected_train"], case["label"]
    counts, plain_grads = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        cd = dtype if dtype == torch.bfloat16 else None
        reset_counts()
        with own_peak() as peak:
            loss, grads = step_grads(sim, hd, node_in, tar, mask, cd)
        counts[dtype] = read_counts(expected)
        # The reference: the plain step under deterministic algorithms,
        # twice (it must repeat bit for bit); beside it, the plain step as
        # the package runs it (`index_add_` with atomics).
        warned = set()
        with plain_path():
            with deterministic(warned):
                loss_p, grads_p = step_grads(sim, hd, node_in, tar, mask, cd)
                loss_r, grads_r = step_grads(sim, hd, node_in, tar, mask, cd)
            with own_peak() as peak_p:
                _, grads_q = step_grads(sim, hd, node_in, tar, mask, cd)
        require(loss_r == loss_p
                and all(torch.equal(grads_r[k], g) for k, g in grads_p.items()),
                f"{label} {dtype}: the deterministic plain step did not "
                f"repeat (ops that warned: {sorted(warned)})")
        if device.type == "cuda":
            print(f"[{label}] train step {str(dtype)[6:]}: own peak "
                  f"{peak[0]:.1f} MiB through the kernels, {peak_p[0]:.1f} "
                  f"MiB through the plain versions")
        # The largest own peak of the step's runs (a caller sizes its train
        # batch by it).
        case["train_peak"] = max(case.get("train_peak", 0.0), peak[0],
                                 peak_p[0])
        plain_grads[dtype] = grads_p
        case.setdefault("plain_step", {})[dtype] = (loss_p, grads_p)
        # The plain path with atomics against the reference: its
        # `index_add_` sums run in another order each time (printed).
        ok = train_verdict(case, dtype, loss, grads, grads_q)
        print(f"[{label}] launches in one {str(dtype)[6:]} train step: "
              f"{counts[dtype]}; CUDA kernels of the port: "
              f"{port_kernels(counts[dtype])} (each launch times the CUDA "
              f"kernels one call runs, KERNEL_META)")
        require(ok, f"{label} {dtype} train step disagrees with the plain "
                    f"path")
        if device.type == "cuda":
            require(counts[dtype] == expected,
                    f"train launch counts {counts[dtype]} != {expected}")

    f32_vs_bf16 = [compare(plain_grads[torch.bfloat16][k], g)
                   for k, g in plain_grads[torch.float32].items()]
    print(f"  the f32 against the bf16 plain step: median rms err "
          f"{float(np.median([e[1] / e[2] for e in f32_vs_bf16 if e[2]])):.2e}"
          f" of rms")

    if "train_frames" in case:  # the trainer on the trajectory's frames
        node_in, tar = case["train_frames"]
    # (hierarchy, input, target, mask) of each step, in turn: the case's
    # frame, or each mesh's (variable meshes).
    steps = case.get("trainer_frames") or [(hd, node_in, tar, mask)]
    tr = make_trainer(case, device, None)
    before = [p.detach().clone() for p in tr.sim.parameters()]
    losses = [float(tr.iter(*steps[i % len(steps)]))
              for i in range(TRAIN_GATE + TRAIN_UPDATES)]
    rates = [tr.schedule(k) for k in range(TRAIN_UPDATES)]
    # Every parameter with a gradient moves; the rest (the bottom GMP's edge
    # MLP, whose level has no edge) move only by weight decay.
    stuck = [k for (k, p), b in zip(tr.sim.named_parameters(), before)
             if not bool((p.detach() != b).any()) and bool(p.grad.any())]
    accs = float(tr.sim.norm_in.num_accumulations)
    print(f"[{label}] trainer f32: {TRAIN_GATE} gate steps then {TRAIN_UPDATES} "
          f"updates at rates {rates}, cycling over {len(steps)} "
          f"hierarchies: losses {losses}; normalizer "
          f"accumulations {accs:g}; parameters with a gradient that did not "
          f"move: {stuck}")
    require(all(np.isfinite(losses)), "trainer loss not finite")
    require(accs == TRAIN_GATE, "the warmup gate did not fill the normalizer")
    require(tr.updates == TRAIN_UPDATES and not stuck,
            "the updates did not move every parameter with a gradient")
    return counts[torch.float32]


def check_twin(case):
    """A "fusedK" case's forward (f32, bf16) and f32 train step against
    its `fused` twin's, which holds the same weights and normalizers: the
    two methods compute one function (FORWARD_TOL, TRAIN_TOL)."""
    sim, twin, hd, mask = (case[k] for k in ("sim", "twin", "hd", "mask"))
    node_in, label = case["node_in"], case["label"]
    for dtype in (torch.float32, torch.bfloat16):
        cd = dtype if dtype == torch.bfloat16 else None
        with torch.no_grad():
            got, want = sim(hd, node_in, mask, cd), twin(hd, node_in, mask, cd)
        delta = (want - node_in[:, :want.shape[-1]]).abs().max().item()
        err = (got - want).abs().max().item()
        tol = FORWARD_TOL[dtype] * max(delta, 1e-3)
        print(f"[{label}] forward {str(dtype)[6:]:9s} against the fused "
              f"twin: max_abs_err {err:.3e} (delta scale {delta:.3e}, tol "
              f"{tol:.3e}) {'ok' if err <= tol else 'FAIL'}")
        require(err <= tol, f"{label} {dtype} forward disagrees with the "
                            f"fused method")
    train_in, tar = case["train"]
    loss, grads = step_grads(sim, hd, train_in, tar, mask, None)
    loss_t, grads_t = step_grads(twin, hd, train_in, tar, mask, None)
    tol_loss, tol_max, tol_rms = TRAIN_TOL[torch.float32]
    rel, zero = grad_errors(grads, grads_t)
    worst_max, worst_rms = max(rel), max(rel, key=lambda r: r[1])
    loss_err = abs(loss - loss_t) / abs(loss_t)
    ok = (loss_err <= tol_loss and worst_max[0] <= tol_max
          and worst_rms[1] <= tol_rms)
    print(f"[{label}] train step float32 against the fused twin: loss rel "
          f"err {loss_err:.2e}; worst max err {worst_max[0]:.2e} of rms "
          f"({worst_max[2]}), worst rms err {worst_rms[1]:.2e} of rms "
          f"({worst_rms[2]}); {len(zero)} exactly zero on both  "
          f"{'ok' if ok else 'FAIL'}")
    require(ok, f"{label} f32 train step disagrees with the fused method")


def v6_bench(device):
    """The v6 prototype's benchmark (`benchmarks/v6_prototype.py:main`):
    level 0 of a Morton-ordered `make_delaunay_mesh(V6_NODES)` (window
    512, edge_block 512), built alone (no coarser level); its sub-window
    tables and their coverage; kernel 15 and kernel 1's level form on the
    same level and weights, each against its plain version (f32, bf16 and
    the bf16 control) and timed; one launch of kernel 15 counted. Returns
    ({(name, dtype): max_abs_err}, {(name, dtype): time row}, launches,
    end-to-end figures)."""
    from bsms_gnn_tpu_torch.data.synthetic import make_delaunay_mesh
    from bsms_gnn_tpu_torch.graph.bistride import build_bistride_levels
    from bsms_gnn_tpu_torch.graph.hierarchy import pad_levels, to_device
    from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
    from bsms_gnn_tpu_torch.graph.order import reorder_mesh
    from bsms_gnn_tpu_torch.ops.kernels.subwin_conv import (
        build_sub_tables,
        sub_row_tables,
    )

    t0 = time.perf_counter()
    pos, cells, _ = make_delaunay_mesh(V6_NODES, np.random.default_rng(0))
    pos, cells, _, _ = reorder_mesh(pos, cells)
    pos = pos.astype(np.float64)
    levels = build_bistride_levels(to_flat_edge(cells, "tri"), 0, len(pos),
                                   pos)
    h = pad_levels(levels, 128, pos=pos, edge_block=EDGE_BLOCK,
                   window=V6_WINDOW)
    build_s = time.perf_counter() - t0
    lvl = h.levels[0]
    t0 = time.perf_counter()
    sub_base, send_sub, covered = build_sub_tables(lvl)
    sub_rows = sub_row_tables(lvl, send_sub)
    tables_s = time.perf_counter() - t0
    real = np.asarray(lvl.edge_mask) > 0
    in_win = real & (np.asarray(lvl.send_win) < lvl.window)
    coverage = float(covered.sum() / in_win.sum())
    print(f"[v6] level 0 of a {len(pos)}-node Delaunay mesh (Morton order, "
          f"window {lvl.window}, edge_block {lvl.edge_block}): N_pad "
          f"{lvl.n_pad_nodes}, E_pad {lvl.n_pad_edges}, E {lvl.n_edges}; "
          f"built in {build_s:.2f} s, sub-window tables and row lists in "
          f"{tables_s:.2f} s (host)")
    print(f"[v6] covered: v6 {100 * coverage:.1f}% of the in-window set "
          f"({100 * covered.sum() / real.sum():.1f}% of real edges); the "
          f"window covers {100 * in_win.sum() / real.sum():.1f}% of real "
          f"edges")
    t0 = time.perf_counter()
    hd = to_device(h, device)
    lv = hd.levels[0]
    print(f"[v6] to_device {time.perf_counter() - t0:.2f} s (host); live "
          f"slots per row: kernel 1 {row_list_summary(lv.win_row_ptr)}, "
          f"kernel 15 {row_list_summary(sub_rows[0])}")
    sb = torch.from_numpy(sub_base).to(device)
    ss = torch.from_numpy(send_sub).to(device)
    rows15 = tuple(torch.from_numpy(a).to(device) for a in sub_rows)
    g = torch.Generator().manual_seed(5)
    ew = torch.randn(lv.n_pad_edges, generator=g).to(device)
    errs, rows = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(lv.n_pad_nodes, 128, generator=g).to(dtype).to(device)
        for name, args in (("subwin_conv", (lv, x, ew, sb, ss, rows15)),
                           ("windowed_conv", (lv, x, ew))):
            errs[(name, dtype)] = check_kernel(name, "v6 level 0", args,
                                               dtype)
            rows[(name, dtype)] = time_kernel(name, "v6 level 0", args,
                                              dtype)
        k15, k1 = rows[("subwin_conv", dtype)], rows[("windowed_conv", dtype)]
        print(f"[v6] {str(dtype)[6:]}: kernel 15 (sub-window) "
              f"{k15['ms']:.5f} ms, kernel 1's level form (window "
              f"{lv.window}) {k1['ms']:.5f} ms: {k1['ms'] / k15['ms']:.2f}x")
    fn = kernel_modules()["subwin_conv"][0]
    fn.launches = 0
    fn(lv, x, ew, sb, ss, rows15)
    launches = fn.launches
    print(f"[v6] launches of kernel 15 in the phase's run: {launches}")
    require(launches == 1, "kernel 15 did not launch once")
    f32 = torch.float32
    e2e = {"v6_coverage": coverage, "v6_build_s": build_s}
    for name, key in (("subwin_conv", "subwin"),
                      ("windowed_conv", "windowed_conv")):
        r = rows[(name, f32)]
        e2e.update({f"v6_{key}_ms_f32": r["ms"],
                    f"v6_{key}_ms_bf16": rows[(name, torch.bfloat16)]["ms"],
                    f"v6_{key}_plain_ms_f32": r["plain_ms"],
                    f"v6_{key}_bound_ms_f32": r["bound_ms"],
                    f"v6_{key}_library_ms_f32": r["library_ms"]})
    return errs, rows, launches, e2e


def row_list_summary(row_ptr):
    """'max M, R rows over 32': the longest row list of a gather layout
    and how many rows split into pieces."""
    n = torch.diff(row_ptr.cpu().long()) if isinstance(
        row_ptr, torch.Tensor) else np.diff(row_ptr)
    return f"max {int(n.max())}, {int((n > 32).sum())} rows over 32"


def profile_call(fn, tries=5):
    """One call of `fn` under torch.profiler: wall ms (host clock, ends in
    a synchronize), device-busy ms (sum of the CUDA kernels' times; one
    stream, so they do not overlap), kernel launches, the kernels that took
    the most device time, and each CUDA kernel's launches and device ms by
    name. The profiler now and then drops kernels from a trace, which reads
    low: a trace that holds fewer of the port's CUDA kernels than the call's
    wrapper launches ran (`port_kernels`) is taken again, up to `tries`
    times, as level_times.py does; the fullest trace is kept."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = {k for _, _, ks in KERNEL_META.values() for k in ks}
    fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(tries):
        reset_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        want = port_kernels(read_counts(KERNEL_META))
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and _device_ms(e) > 0
                   and not getattr(e, "is_user_annotation", False)]
        got = sum(e.count for e in kernels
                  if any(n in e.key for n in names))
        if best is None or got > best[0]:
            best = got, wall, kernels
        if got >= want:
            break
        print(f"  (a profile held {got} of the port's CUDA kernels, not the "
              f"{want} its launches ran: taken again)")
    else:
        print(f"  note: no profile of {tries} held all {want} port kernels; "
              f"the fullest held {best[0]}")
    _, wall, kernels = best
    busy = sum(_device_ms(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    top = sorted(kernels, key=_device_ms, reverse=True)[:8]
    return wall, busy, launches, [(e.key[:60], e.count, _device_ms(e))
                                  for e in top], [(e.key, e.count,
                                                   _device_ms(e))
                                                  for e in kernels]


def print_profile(what, wall, busy, launches, top, _by_name=None):
    print(f"profile {what}: wall {wall:.3f} ms (host clock, under the "
          f"profiler), device busy {busy:.3f} ms, idle share "
          f"{1 - busy / wall:.3f}, {launches} CUDA kernels")
    for key, count, ms in top:
        print(f"  {ms:9.4f} ms  {count:4d}x  {key}")


def measure_train(case, device):
    """Train-step times, profile and peak memory, f32 and bf16; then each
    backward kernel's time (the fused path's: the pallas path adds none)."""
    hd, mask, label = case["hd"], case["mask"], case["label"]
    node_in, tar = case["train"]
    e2e = {}
    for dtype in (torch.float32, torch.bfloat16):
        cd = dtype if dtype == torch.bfloat16 else None
        name = str(dtype)[6:]
        tr = make_trainer(case, device, cd)

        def step():
            tr.iter(hd, node_in, tar, mask)

        for _ in range(TRAIN_GATE + 1):
            step()
        runs = [event_ms(step, reps=5, warmup=1)
                for _ in range(TIMED_REPEATS)]
        ms = e2e[f"train_step_ms_{'f32' if cd is None else 'bf16'}"] = float(
            np.median(runs))
        with plain_path():
            pms = event_ms(step, reps=5, warmup=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2**20
        step()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**20
        print(f"[{label}] train step {name}: {ms:.4f} ms through the kernels (median "
              f"of {[round(r, 4) for r in runs]}, each the mean of 5 steps by "
              f"CUDA events), {pms:.4f} ms through the plain versions; peak "
              f"memory of a step {peak:.1f} MiB, {peak - held:.1f} above the "
              f"{held:.1f} held before it ({held_line()})")
        prof = profile_call(step)
        print_profile(f"[{label}] train step {name}", *prof)
        print_port_kernels(prof[4])
        check_block_sums(case, prof[4])
        print(f"  idle share against the timed step: {1 - prof[1] / ms:.3f} "
              f"(1 - device busy / ms per step)")
        key = "f32" if cd is None else "bf16"
        e2e[f"train_step_peak_mib_{key}"] = peak
        e2e[f"train_step_peak_above_mib_{key}"] = peak - held
        e2e[f"train_step_busy_ms_{key}"] = prof[1]
    rows = {}
    if case["cfg"].aggregation == "pallas":
        return rows, e2e
    timed = case.get("timed")
    for dtype in (torch.float32, torch.bfloat16):
        for name, shapes in bwd_kernel_inputs(case, dtype, device).items():
            if timed is None or name in timed:
                rows[(name, dtype)] = time_kernel(name, *shapes[0], dtype)
                if name in EVERY_SHAPE_TIMED:
                    for where, args in shapes[1:]:
                        time_kernel(name, where, args, dtype)
    return rows, e2e


def print_port_kernels(by_name):
    """The step's launches and device ms of each CUDA kernel the port's
    wrappers launch (KERNEL_META), by name: the step sums a ranking of the
    kernels reads."""
    names = sorted({k for _, _, ks in KERNEL_META.values() for k in ks})
    found = [(n, sum(c for key, c, _ in by_name if n in key),
              sum(ms for key, _, ms in by_name if n in key)) for n in names]
    print("  port kernels in the step (launches, device ms): " + ", ".join(
        f"{n} {c} {ms:.4f}" for n, c, ms in found if c))


def check_block_sums(case, by_name):
    """No profiled train step launches a `block_sum_kernel`: every kernel
    runs on a tile walk or a gather, and none sums chunk parts (the chunk
    walks of kernels 11's and 12's forwards, the last that did, are gone).
    The profiler may drop a launch, never add one."""
    got = sum(n for key, n, _ in by_name if "block_sum_kernel" in key)
    print(f"  block_sum_kernel launches in the step: {got} (none expected)")
    require(got == 0, f"{case['label']}: {got} block sums in a train step")


def batch_args(name, args, n, seed):
    """A kernel's arguments with a batch of n samples (BATCHED_ARGS):
    sample 0 the arguments as given, the others drawn from a generator
    seeded with `seed`, each at its input's RMS and in its dtype. The node
    phase (kernels 3 and 6, NODE_CLUSTERS) is row-wise: its other samples
    are sample 0's rows in seeded orders, so every tile holds other rows
    while no ReLU input lies nearer its kink than sample 0's. Fresh draws
    put one within f32 rounding of its kink at the airfoil's level 0, where
    the kernel and the plain version, summing in other orders, take it on
    different sides (dx 2.0e-2 of its RMS apart, the kernel bit for bit its
    own call on that sample; PERF.md §6)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    out = list(args)
    if name in NODE_CLUSTERS:
        rows = args[BATCHED_ARGS[name][0]].shape[0]
        perms = [torch.randperm(rows, generator=g) for _ in range(n - 1)]
        for i in BATCHED_ARGS[name]:
            a = args[i]
            out[i] = torch.stack([a, *(a[p.to(a.device)] for p in perms)])
        return tuple(out)
    for i in BATCHED_ARGS[name]:
        a = args[i]
        if a is None:  # kernel 9's store form: no acc
            continue
        rms = a.float().square().mean().sqrt().item() or 1.0
        more = [(rms * torch.randn(*a.shape, generator=g)).to(a.dtype)
                .to(a.device) for _ in range(n - 1)]
        out[i] = torch.stack([a, *more])
    return tuple(out)


def sample_args(name, bargs, s, meshes=None):
    """Sample s of a batch's arguments; with `meshes` (each sample's
    layout, `union_args`) on sample s's own layout."""
    out = [a[s] if i in BATCHED_ARGS[name] and a is not None else a
           for i, a in enumerate(bargs)]
    if meshes is not None and meshes[s] is not None:
        out = on_layout(name, out, meshes[s])
    return tuple(out)


def on_layout(name, args, layout):
    """The arguments with the layout (argument 0) replaced by `layout`,
    and kernel 1's level form's weights by that layout's own (ew or
    ew_rev, as the arguments had them)."""
    out = list(args)
    if name == "windowed_conv":
        out[2] = layout.ew if args[2] is args[0].ew else layout.ew_rev
    out[0] = layout
    return out


def union_args(name, bargs, meshes):
    """A batch's arguments (`batch_args`) as one call on the union of the
    samples' layouts (`graph.hierarchy.union_layout` of `meshes`, each
    sample's; None entries for kernels that take no layout): every batched
    argument's [n, rows, C] viewed as [n·rows, C], as the model's union
    runs a variable-mesh batch."""
    from bsms_gnn_tpu_torch.graph.hierarchy import union_layout

    out = [a.reshape(-1, a.shape[-1])
           if i in BATCHED_ARGS[name] and a is not None else a
           for i, a in enumerate(bargs)]
    if meshes[0] is not None:
        out = on_layout(name, out, union_layout(list(meshes)))
    return tuple(out)


def batch_work(name, bargs, dtype):
    """(bytes, operations) of a batched call: `work` of one sample times
    the batch."""
    by, ops = work(name, sample_args(name, bargs, 0), dtype)
    n = bargs[BATCHED_ARGS[name][0]].shape[0]
    return by * n, ops * n


def batch_library_call(name, bargs):
    """One PyTorch call computing a batched gather (kernels 1, 2, 7 and 8)
    on the same inputs, or None: `index_add_` on dim -2 (kernels 2, 7 and
    8), `torch.sparse.mm` of the operator on x viewed as [N, B·C] (kernel
    1, either form)."""
    if name in ("windowed_rect_conv", "windowed_conv"):
        op, x = bargs[:2]
        n, rows, c = x.shape
        m = window_matrix(op, op.ew if name == "windowed_rect_conv"
                          else bargs[2], rows)
        xf = x.float().permute(1, 0, 2).reshape(rows, n * c).contiguous()
        return lambda: torch.sparse.mm(m, xf)
    if name == "compact_accum":
        cr, vals, acc = bargs
        idx = cr.receivers[:cr.n_real].long()
        v = vals[:, :cr.n_real].float()
        a = acc.clone()
        return lambda: a.index_add_(-2, idx, v)
    if name == "windowed_send_sum":
        lvl, vals = bargs
        live = lvl.send_win < lvl.window
        base = lvl.win_base.long().repeat_interleave(lvl.edge_block)
        idx = (base * (lvl.window // 2) + lvl.send_win.long())[live]
        v = vals[:, live].float()
        a = torch.zeros(vals.shape[0], lvl.n_pad_nodes, vals.shape[-1],
                        device=vals.device)
        return lambda: a.index_add_(-2, idx, v)
    if name == "segment_sum":
        lvl, feat = bargs[:2]
        slots = lvl.row_send if bargs[2:] and bargs[2] else lvl.row_slots
        rows = lvl.receivers.index_select(0, lvl.row_slots).long()
        v = feat.index_select(-2, slots).float()
        a = torch.zeros(feat.shape[0], lvl.n_pad_nodes, feat.shape[-1],
                        device=feat.device)
        return lambda: a.index_add_(-2, rows, v)
    return None


def segment_sum_shapes(case, dtype, device):
    """Kernel 8's shapes on a fused path that runs it (the unwindowed
    airfoil: the sender gathers' backwards and the sparse transitions):
    level 0 in both forms and each sparse operator, drawn from a generator
    seeded with 9."""
    hd = case["hd"]
    g = torch.Generator(device="cpu").manual_seed(9)

    def feat(layout):
        return torch.randn(layout.n_pad_edges, 128, generator=g).to(
            dtype).to(device)

    lvl = hd.levels[0]
    return ([("level 0", (lvl, feat(lvl))),
             ("level 0 send", (lvl, feat(lvl), True))]
            + [(where, (op, feat(op))) for where, op in sparse_ops(hd)])


def batch_inputs(case, dtype, device, names=None):
    """(name, [(where, arguments)]) of each kernel of the batched path at
    the case's path's shapes (`kernel_inputs`, `bwd_kernel_inputs`): the
    forward kernels, then the backward kernels (those of `names` only,
    where given); kernel 8 at `segment_sum_shapes` where `names` asks for
    it on a path that lists no shape of it."""
    fwd = kernel_inputs(case, dtype, device)
    if names is not None and "segment_sum" in names and (
            "segment_sum" not in fwd):
        fwd["segment_sum"] = segment_sum_shapes(case, dtype, device)
    bwd = ({} if names is not None and not any(n in BWD_OUTPUTS
                                               for n in names)
           else bwd_kernel_inputs(case, dtype, device))
    return [(k, v) for k, v in (*fwd.items(), *bwd.items())
            if k in BATCHED_ARGS and (names is None or k in names)]


def check_batched(name, where, args, dtype, sparse, seed, n=BATCH_CHECK,
                  meshes=None, dense=False, clear=False):
    """One kernel of the batched path on a batch of n samples (sample 0
    the B = 1 check's inputs): twice for bit-identical outputs;
    each output against the plain version on the batch (TOL / BWD_TOL, the
    rows of every sample together), in bf16 with its control, which must
    miss; every per-row output of sample s bit for bit the call on sample s
    alone; the weight gradients against the sum of the samples' calls
    (BWD_TOL). With `meshes` (sample s's layout, or None for every sample
    of a kernel that takes none) the batch runs as one call on the union
    of the samples' layouts (`union_args`) and sample s alone on its own.
    With `dense` (a union), kernel 13's drawn samples are cleared of ReLU
    inputs near their kinks on the union (`clear_kinks`) and its
    backward's dpre rows that miss are verified as flips (`verify_flips`),
    and kernel 9's drawn samples are zero on their pad slots
    (`pad_zeroed`, each on its own layout), as the B = 1 check's are. With
    `clear` (the wide airfoil), kernels 4's and 5's drawn f32 samples are
    cleared of ReLU inputs near their kinks the same way.
    Returns the largest max_abs_err against the plain version."""
    fn, plain = kernel_modules()[name]
    bargs = batch_args(name, args, n, seed)
    if (dense and name == "segment_sum_accum" and meshes is not None
            and meshes[0].n_edges > 0):
        bargs = list(bargs)
        bargs[1] = torch.stack([pad_zeroed(m, f)
                                for m, f in zip(meshes, bargs[1])])
        bargs = tuple(bargs)
    cargs = bargs if meshes is None else union_args(name, bargs, meshes)
    if (dense and name.startswith("fused_edge_phase_win_dyn")) or (
            clear and dtype == torch.float32
            and name in ("fused_edge_phase_win", "fused_edge_phase_win_bwd")):
        cargs = clear_kinks(name, cargs, torch.Generator().manual_seed(seed))
        bargs = list(bargs)
        bargs[1] = cargs[1].reshape(n, -1, cargs[1].shape[-1])
        bargs = tuple(bargs)
    bwd = name in BWD_OUTPUTS
    outs = BWD_OUTPUTS[name] if bwd else ("out",)
    tol_max, tol_rms = (BWD_TOL if bwd else TOL)[(name, dtype)]

    def call(f, a):
        r = run(name, f, a)
        return r if isinstance(r, tuple) else (r,)

    def rows(t):
        return t.reshape(-1, t.shape[-1])

    def samples(t):  # [n, rows, C], on the batch axis or the union's rows
        return t.reshape(n, -1, t.shape[-1])

    got, want = call(fn, cargs), call(plain, cargs)
    same = all(torch.equal(a, b) for a, b in zip(got, call(fn, cargs)))
    require(same, f"batched {name} {where} {dtype}: two calls differ")
    ctrl = None
    if dtype == torch.bfloat16 and (not bwd or name in BWD_CONTROLS) and (
            not exact_weights(name, cargs)):
        up = list(control_args(name, cargs) or ()) if not bwd else [
            a.float() if isinstance(a, torch.Tensor)
            and a.dtype == torch.bfloat16 else a for a in cargs]
        if bwd and name == "fused_node_phase_bwd":
            up[4] = None
        ctrl = call(fn, tuple(up)) if up else None
    ones = [call(fn, sample_args(name, bargs, s, meshes)) for s in range(n)]
    worst, notes = 0.0, []
    for i, out in enumerate(outs):
        err, err_rms, rms, zero_ok, live = filled_compare(
            rows(got[i]), rows(want[i]), sparse)
        ok = (err <= tol_max * rms and err_rms <= tol_rms * rms and zero_ok
              and bool(torch.isfinite(got[i]).all()))
        worst = max(worst, err)
        note = (f"{out} vs plain max {frac(err, rms):.2e} rms "
                f"{frac(err_rms, rms):.2e} of rms")
        if ctrl is not None and live:
            c_err, c_rms, _, c_zero, _ = filled_compare(
                rows(ctrl[i]), rows(want[i]), sparse)
            missed = (c_err > tol_max * rms or c_rms > tol_rms * rms
                      or not c_zero)
            note += f", control {'misses' if missed else 'PASSES'}"
            require(missed, f"batched {name} {where} {out}: the bf16 "
                            f"tolerance does not tell an unrounded kernel "
                            f"apart")
        if not bwd or out in ROW_OUTPUTS[name]:
            each = all(torch.equal(samples(got[i])[s], ones[s][i])
                       for s in range(n))
            note += (", each sample bit for bit its own call" if each
                     else ", a sample DIFFERS from its own call")
            ok = ok and each
        else:
            s_err, s_rms, s_ref = compare(
                got[i], sum(o[i] for o in ones))
            summed = (s_err <= tol_max * s_ref and s_rms <= tol_rms * s_ref)
            note += (f", vs the sum of the samples' calls max "
                     f"{frac(s_err, s_ref):.2e} rms {frac(s_rms, s_ref):.2e}")
            ok = ok and summed
        if (not ok and dense and out == "dpre"
                and name == "fused_edge_phase_win_dyn_bwd"):
            verified, line = verify_flips(cargs, rows(got[i]), rows(want[i]),
                                          (tol_max, tol_rms), sparse)
            print(line)
            ok = verified and each
        notes.append(note + ("" if ok else " FAIL"))
        if not ok and name in RELU_DIAGNOSED and (
                not bwd or out in ROW_OUTPUTS[name]):
            kind = (ROW_KIND.get(out, "all") if bwd else "inputs"
                    if name in NODE_CLUSTERS else "receivers")
            for s in range(n):
                print(f"  sample {s}: " + relu_margin(
                    name, sample_args(name, bargs, s, meshes),
                    samples(got[i])[s], samples(want[i])[s], tol_max * rms,
                    kind).strip())
        require(ok, f"batched {name} {where} {out} {dtype}: {notes[-1]}")
    print(f"{'union' if meshes else 'batch'} B={n} kernel {name} {where} "
          f"{str(dtype)[6:]}: two calls bit-identical; " + "; ".join(notes))
    return worst


def check_partial_ranges(case, dtype, device):
    """Kernel 6 on level 0 at BATCH_TRAIN samples (`check_batched`), where
    its tiles outnumber the cap on its weight-gradient partials, so that
    each cluster walks a range of tiles, storing the first tile's partial
    and adding the rest's; the B = BATCH_CHECK checks keep one tile a
    partial."""
    from bsms_gnn_tpu_torch.ops.kernels import node_mlp

    name = "fused_node_phase_bwd"
    args = dict(bwd_kernel_inputs(case, dtype, device)[name])["level 0"]
    x, cd = args[0], args[-1]
    tiles = BATCH_TRAIN * x.shape[0] // node_mlp.ROWS
    cap = node_mlp.p_max(x.dtype, cd, len(args[2].weights) - 1, x.device)
    require(tiles > cap, f"kernel 6 at B={BATCH_TRAIN}: {tiles} tiles, "
                         f"within the cap {cap} on its partials")
    print(node_walk_line(name, f"level 0 B={BATCH_TRAIN}", dtype,
                         (x.expand(BATCH_TRAIN, -1, -1), *args[1:])))
    check_batched(name, "level 0", args, dtype, False, 1690, BATCH_TRAIN)


def batch_frames(case, n, seed):
    """n distinct frames over the case's one hierarchy and targets near
    them, with the case's mask: ([n, N_pad, ...] input, target, mask). By
    default seeded output fields on the real rows (the case's positions
    and node types), targets a seeded step away; a case may draw its own
    (`frames`: the flag's contact recipe)."""
    if "frames" in case:
        return case["frames"](case, n, seed)
    node_in, mask = case["node_in"], case["mask"]
    c = case["cfg"].out_dim
    g = torch.Generator(device="cpu").manual_seed(seed)
    real = case["hd"].levels[0].node_mask
    fields = torch.randn(n, node_in.shape[0], c, generator=g).to(
        node_in.device) * real
    frames = node_in.expand(n, -1, -1).clone()
    frames[..., :c] = fields
    masks = mask.expand(n, -1, -1).contiguous()
    step = 0.1 * torch.randn(n, node_in.shape[0], c, generator=g)
    return frames, frames[..., :c] + step.to(node_in.device) * masks, masks


def surface_frames(case, n, seed):
    """n frames around the surface's trajectory frame pair
    (`build_surface_case`'s train frames): sample s's world positions are
    frame 0's plus 0.02·N(0, 1) on the real rows, from a generator seeded
    with `seed`, and its target frame 1's plus the same offset; the case's
    mask."""
    node_in, tar = case["train_frames"]
    real = case["n"]
    g = torch.Generator(device="cpu").manual_seed(seed)
    shift = torch.zeros(n, node_in.shape[0], 3)
    shift[:, :real] = 0.02 * torch.randn(n, real, 3, generator=g)
    shift = shift.to(node_in.device)
    frames = node_in.expand(n, -1, -1).clone()
    frames[..., :3] += shift
    return frames, tar + shift, case["mask"].expand(n, -1, -1).contiguous()


def flag_frames(case, n, seed):
    """n frames of the contact recipe on the flag's strip: sample s's world
    x, y the mesh position, z = 0.05·N(0, 1) from a generator seeded with
    `seed`; its target adds 0.1·sin(x) to z (`build_flag_case`'s frame, in
    bulk)."""
    node_in, mask, real = case["node_in"], case["mask"], case["n"]
    g = torch.Generator(device="cpu").manual_seed(seed)
    frames = node_in.expand(n, -1, -1).clone()
    frames[:, :real, 2] = 0.05 * torch.randn(n, real, generator=g).to(
        node_in.device)
    tar = frames[..., :3].clone()
    tar[:, :real, 2] += 0.1 * torch.sin(node_in[:real, 0])
    return frames, tar, mask.expand(n, -1, -1).contiguous()


def cylinder_frames(case, n, seed):
    """n samples of the cylinder batch: sample s on mesh s mod 3, its input
    frame 0 and its target frame 1 of `generate_trajectory` on that mesh
    drawn with `default_rng(1000 · seed + s)`, its mask the cylinder mask:
    ([n, N_pad, 5], [n, N_pad, 2], [n, N_pad, 1])."""
    from bsms_gnn_tpu_torch.data.synthetic import (
        cylinder_mask,
        generate_trajectory,
    )

    meshes = case["meshes"]
    n_pad = case["hd"].levels[0].n_pad_nodes
    node_in = np.zeros((n, n_pad, 5), np.float32)
    tar = np.zeros((n, n_pad, 2), np.float32)
    mask = np.zeros((n, n_pad, 1), np.float32)
    for s in range(n):
        pos, cells, node_type = meshes[s % len(meshes)]
        fields = generate_trajectory((pos, cells, node_type), 2,
                                     np.random.default_rng(1000 * seed + s))
        k = len(pos)
        node_in[s, :k, :2] = fields["velocity"][0]
        node_in[s, :k, 2:4] = pos
        node_in[s, :k, 4] = node_type[:, 0]
        tar[s, :k] = fields["velocity"][1]
        mask[s, :k] = cylinder_mask(node_type)
    device = case["node_in"].device
    return tuple(torch.from_numpy(a).to(device) for a in (node_in, tar, mask))


def cylinder_batch_case(device):
    """The cylinder case (`build_cylinder_case`) batched across its three
    meshes, as a variable-mesh dataset batches: sample s on mesh s mod 3
    with its own frame pair (`cylinder_frames`), each batch on the union of
    its samples' device hierarchies (`union_case`)."""
    case = build_cylinder_case(device)
    return union_case(dict(case, frames=cylinder_frames), "cylinder batch")


def union_case(case, label):
    """A variable-mesh case batched across its meshes (sample s on the
    hierarchy of its `trainer_frames` entry s mod len): `union` gives the
    union of n samples' device hierarchies (`stacked_unions`),
    `sample_layouts` a kernel check's layout on each sample's own mesh,
    `own` sample s's hierarchy."""
    hds = [f[0] for f in case["trainer_frames"]]
    union = stacked_unions(hds, label)

    def sample_layouts(name, args, n=BATCH_CHECK):
        lay = args[0]
        if not hasattr(lay, "n_pad_edges"):  # the node phase takes none
            return [None] * n
        for l, lv in enumerate(case["hd"].levels):
            for own, get in ((lv, lambda h: h.levels[l]),
                             (lv.resid, lambda h: h.levels[l].resid)):
                if lay is own:
                    return [get(hds[s % len(hds)]) for s in range(n)]
        return [lay] * n  # the forced empty residual: mesh 1's

    return dict(case, union=union, sample_layouts=sample_layouts,
                own=lambda s: hds[s % len(hds)])


def stacked_unions(hds, label):
    """n → the union of n samples' device hierarchies, sample s on
    hds[s mod len(hds)] (`data.pipeline.stack_hierarchies`), built once
    per batch size, its host time printed: JAX stacks in its pipeline's
    worker threads, outside the step."""
    from bsms_gnn_tpu_torch.data.pipeline import stack_hierarchies

    unions = {}

    def union(n):
        if n not in unions:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            unions[n] = stack_hierarchies([hds[s % len(hds)]
                                           for s in range(n)])
            torch.cuda.synchronize()
            print(f"[{label}] stack_hierarchies of B={n}: "
                  f"{(time.perf_counter() - t0) * 1e3:.2f} ms (host, once "
                  f"per batch size)")
        return unions[n]

    return union


def check_union_samples(case, node_in, mask, got, delta, dtype):
    """Each sample s of a union's forward `got` against its frame's forward
    on its own mesh's hierarchy alone (`case["own"](s)`), the function a
    stacked batch computes (JAX vmaps the B = 1 forward over the stack). A
    wrong union table (pool_ids, unpool_inv, an offset) moves a sample by
    the order of its delta here, while the comparison with the plain path
    shares the table on both sides (FORWARD_TOL)."""
    sim, label = case["sim"], case["label"]
    cd = dtype if dtype == torch.bfloat16 else None
    errs = [(got[s] - sim(case["own"](s), node_in[s], mask[s], cd)).abs()
            .max().item() for s in range(got.shape[0])]
    tol = FORWARD_TOL[dtype] * max(delta, 1e-3)
    ok = max(errs) <= tol
    print(f"[{label}] forward B={got.shape[0]} {str(dtype)[6:]}: each sample "
          f"against its B = 1 forward on its own mesh: max_abs_err "
          f"{max(errs):.3e} (tol {tol:.3e}), {errs.count(0.0)} of "
          f"{len(errs)} samples bit for bit  {'ok' if ok else 'FAIL'}")
    require(ok, f"{label} union forward disagrees with the samples' own "
                f"forwards ({max(errs):.3e})")


def check_shared_union(case):
    """BATCH_CHECK frames [B, N_pad, ...] on the served mesh's one bucketed
    hierarchy (the simulator runs them on the union of B references to it,
    `Simulator.batch_union`, kept by the simulator) against the plain
    path, f32 and bf16 (FORWARD_TOL), with the B = 1 launch counts."""
    sim, hd, label = case["sim"], case["hd"], case["label"]
    real = hd.levels[0].node_mask
    g = torch.Generator(device="cpu").manual_seed(25)
    node_in = case["node_in"].expand(BATCH_CHECK, -1, -1).clone()
    node_in[..., :2] += 0.1 * torch.randn(*node_in.shape[:-1], 2,
                                          generator=g).to(real.device) * real
    mask = case["mask"].expand(BATCH_CHECK, -1, -1).contiguous()
    for dtype in (torch.float32, torch.bfloat16):
        cd = dtype if dtype == torch.bfloat16 else None
        reset_counts()
        got = sim(hd, node_in, mask, cd)
        counts = read_counts(case["expected"])
        with plain_path():
            want = sim(hd, node_in, mask, cd)
        delta = (want - node_in[..., :2]).abs().max().item()
        err = (got - want).abs().max().item()
        tol = FORWARD_TOL[dtype] * max(delta, 1e-3)
        ok = err <= tol and bool(torch.isfinite(got).all())
        print(f"[{label}] B={BATCH_CHECK} frames on the one hierarchy of the "
              f"served mesh {str(dtype)[6:]}: max_abs_err vs plain "
              f"{err:.3e} (tol {tol:.3e}); launches {counts}  "
              f"{'ok' if ok else 'FAIL'}")
        require(ok and (counts == case["expected"]
                        or got.device.type != "cuda"),
                f"{label} shared-hierarchy batch: error {err:.3e}, launches "
                f"{counts}")
    require([k[1] for k, (h, _) in sim.unions.items() if h is hd]
            == [BATCH_CHECK], "the union was not kept")


def check_accumulation(case, device):
    """A `Trainer` with gradient_accumulation_steps = 2 (optax.MultiSteps)
    on the cylinder batch at BATCH_SERVE: after the gate, six train steps,
    every second of which applies clip + AdamW to the mean of two steps'
    gradients. The parameters stay bit for bit as they were after the other
    steps, and move after the second and third updates (the first runs at
    schedule(0) = 0)."""
    from bsms_gnn_tpu_torch.config import OptConfig
    from bsms_gnn_tpu_torch.training.trainer import Trainer

    cfg = case["config"](accumulation_steps=TRAIN_GATE)
    opt = OptConfig(peak_lr=1e-4, warmup_steps=2, decay_steps=1000,
                    gradient_accumulation_steps=2)
    tr = Trainer(cfg, opt, generator=torch.Generator().manual_seed(1),
                 device=device)
    hd = case["union"](BATCH_SERVE)
    node_in, tar, mask = batch_frames(case, BATCH_SERVE, 23)
    for _ in range(TRAIN_GATE):
        tr.iter(hd, node_in, tar, mask)
    moved, losses = [], []
    for _ in range(6):
        before = [p.detach().clone() for p in tr.sim.parameters()]
        losses.append(float(tr.iter(hd, node_in, tar, mask)))
        moved.append(any(not torch.equal(p.detach(), b)
                         for p, b in zip(tr.sim.parameters(), before)))
    print(f"[{case['label']}] trainer with gradient_accumulation_steps=2 at "
          f"B={BATCH_SERVE}: losses {losses}; parameters moved after train "
          f"steps {[i + 1 for i, m in enumerate(moved) if m]} of 6; "
          f"{tr.updates} updates")
    require(all(np.isfinite(losses)) and tr.updates == 3
            and moved == [False, False, False, True, False, True],
            "gradient accumulation: the parameters moved off the update "
            "steps, or not on them")


def check_remat(case, device):
    """The pallas surface's train step at BATCH_TRAIN under remat (every
    GMP checkpointed: REMAT_MIN_NODES_SURFACE): its gradients against the
    plain path's under remat (TRAIN_TOL), its launch counts
    (EXPECTED_SURFACE_REMAT_TRAIN_LAUNCHES) and the `Trainer` run
    (`check_train`); then, in f32, the step's wall ms (median of
    BATCH_TIMED_REPEATS repeats of two steps), busy ms (a sample), idle
    share, CUDA kernels and own peak MiB, beside the card's memory (its
    bf16 figures are PR 21's, PERF.md). Returns the end-to-end keys
    (prefix `remat_b48_`)."""
    sim, label = case["sim"], case["label"] + " remat"
    cfg0 = sim.cfg
    sim.cfg = dataclasses.replace(cfg0, remat=True,
                                  remat_min_nodes=REMAT_MIN_NODES_SURFACE)

    def config(**kw):
        return case["config"](remat=True,
                              remat_min_nodes=REMAT_MIN_NODES_SURFACE, **kw)

    hd, n = case["hd"], BATCH_TRAIN
    node_in, tar, mask = batch_frames(case, n, 24)
    rcase = dict(case, label=label, config=config, train=(node_in, tar),
                 mask=mask, train_frames=(node_in, tar), trainer_frames=None,
                 expected_train=EXPECTED_SURFACE_REMAT_TRAIN_LAUNCHES)
    card_mib = torch.cuda.get_device_properties(0).total_memory / 2**20
    e2e = {}
    try:
        check_train(rcase, device)
        for dtype in (torch.float32,):
            cd = dtype if dtype == torch.bfloat16 else None
            key = "f32" if cd is None else "bf16"
            tr = make_trainer(rcase, device, cd)

            def step():
                tr.iter(hd, node_in, tar, mask)

            for _ in range(TRAIN_GATE + 1):
                step()
            runs = [event_ms(step, reps=2, warmup=0)
                    for _ in range(BATCH_TIMED_REPEATS)]
            ms = float(np.median(runs))
            with own_peak() as peak:
                step()
            peak = peak[0]
            prof = profile_call(step)
            print_profile(f"[{label}] train step B={n} {key}", *prof)
            print_port_kernels(prof[4])
            print(f"[{label}] train step B={n} {key}: {ms:.4f} ms (median "
                  f"of {[round(r, 4) for r in runs]}), busy {prof[1]:.4f} ms "
                  f"({prof[1] / n:.4f} per sample), idle share "
                  f"{1 - prof[1] / ms:.3f}, {prof[2]} CUDA kernels, own peak "
                  f"{peak:.1f} MiB of the card's {card_mib:.0f}")
            e2e.update({f"remat_b{n}_train_step_ms_{key}": ms,
                        f"remat_b{n}_train_step_busy_ms_{key}": prof[1],
                        f"remat_b{n}_train_step_kernels_{key}": prof[2],
                        f"remat_b{n}_train_step_peak_above_mib_{key}": peak})
            del tr
    finally:
        sim.cfg = cfg0
    return e2e


# The batched paths: (the function that builds the case, its label, the
# kernels checked at BATCH_CHECK samples (None: every kernel of
# BATCHED_ARGS the path runs), the seed of the first shape's other samples
# (each later shape k adds 50·k)). A case's `train_batch` replaces
# BATCH_TRAIN, its `frames` `batch_frames`' draw, its `union` (a function
# of the batch size) the one hierarchy (a variable-mesh batch: the union
# of the samples' hierarchies, with `sample_layouts` for the kernel
# checks), and `remat` adds the train step at BATCH_TRAIN under remat.
BATCH_PATHS = {
    "airfoil_batch": (lambda d: build_case(d), "airfoil 5k batch", None,
                      1700),
    "flag_batch": (lambda d: dict(build_flag_case(d), frames=flag_frames),
                   "flag 1.6k batch", ("fused_edge_phase_win_dyn",
                                       "fused_edge_phase_win_dyn_bwd"), 2400),
    "fused4_batch": (lambda d: build_case(d, aggregation="fused4"),
                     "airfoil 5k fused4 batch",
                     ("fused_edge_phase_win_k", "fused_edge_phase_win_k_bwd"),
                     2800),
    "surface_batch": (lambda d: dict(build_surface_case(d),
                                     frames=surface_frames,
                                     train_batch=BATCH_TRAIN_SURFACE,
                                     remat=True),
                      "surface 16k batch",
                      ("segment_sum", "fused_aggregate_node_phase"), 3200),
    "plain_batch": (lambda d: build_case(d, plain=True),
                    "airfoil 5k plain batch",
                    ("fused_edge_phase", "fused_edge_phase_bwd",
                     "segment_sum"), 4600),
    "surface_fused_batch": (lambda d: dict(
        build_surface_case(d, aggregation="fused"), frames=surface_frames),
        "surface 16k fused batch",
        ("fused_edge_mlp_aggregate", "fused_edge_mlp_aggregate_bwd"), 5400),
    "cylinder_batch": (cylinder_batch_case, "cylinder 1.9k batch", None,
                       6000),
}


def run_batch_case(device, path):
    """A batched path (BATCH_PATHS): its case with batches of distinct
    frames over its one hierarchy. Its kernels at BATCH_CHECK samples at
    every shape its B = 1 path checks them at (`check_batched`), f32 and
    bf16 (on the airfoil also kernel 6 at BATCH_TRAIN on level 0; on the
    pallas surface kernel 10 against kernel 3 on kernel 8's aggregate);
    serving at BATCH_SERVE (the forward against the plain path, the case's
    B = 1 launch and narrow-route counts); the train step at the case's
    train batch (its gradients against the plain path, the case's B = 1
    train-step counts) and a `Trainer` run there; then the times. Returns
    (kernel errors, {}, forward launch counts, train-step launch counts,
    end-to-end times) as `run_case` does."""
    build, label, names, seed = BATCH_PATHS[path]
    case = build(device)
    case["label"] = label
    train_b = case.get("train_batch", BATCH_TRAIN)
    batch_hd = case.get("union") or (lambda n: case["hd"])
    errs = {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            for name, shapes in batch_inputs(case, dtype, device, names):
                for k, (where, args) in enumerate(shapes):
                    sparse = name in TILE_WALKS and k > 0
                    meshes = (case["sample_layouts"](name, args)
                              if "union" in case else None)
                    err = check_batched(name, where, args, dtype, sparse,
                                        seed + 50 * k, meshes=meshes)
                    errs.setdefault((name, dtype), err)
            if path == "airfoil_batch":
                check_partial_ranges(case, dtype, device)
        if case["cfg"].aggregation == "pallas":
            check_agg_identity(case, BATCH_CHECK)
            print_agg_designs(case, (BATCH_SERVE, train_b))
        serve = check_served_batch(case, device)
        if "union" in case:
            check_shared_union(case)
    node_in, tar, mask = batch_frames(case, train_b, 22)
    # check_train on the batch: the step's gradients against the plain
    # path (TRAIN_TOL), the launch counts of one step (the case's
    # expected_train), and the `Trainer` run on the batch (the gate, then
    # updates that move every parameter).
    train = check_train(dict(case, hd=batch_hd(train_b), train=(node_in, tar),
                             mask=mask, train_frames=(node_in, tar),
                             trainer_frames=None), device)
    del node_in, tar, mask
    if "union" in case:
        check_accumulation(case, device)
    e2e = measure_batch(case, device)
    if "remat" in case:
        e2e.update(check_remat(case, device))
    del case
    torch.cuda.empty_cache()
    return errs, {}, serve, train, e2e


def check_served_batch(case, device, n=BATCH_SERVE):
    """The forward at n frames (`batch_frames`, seed 21; a variable-mesh
    case's on the union of its samples' hierarchies) against the plain
    path (FORWARD_TOL), f32 and bf16, with the case's B = 1 launch and
    narrow-route counts; on a union also each sample against its own B = 1
    forward (`check_union_samples`). Returns the f32 forward's counts."""
    sim, label = case["sim"], case["label"]
    expected, narrow = case["expected"], case["narrow"]
    node_in, _, mask = batch_frames(case, n, 21)
    hd = (case.get("union") or (lambda b: case["hd"]))(n)
    serve = {}
    for dtype in (torch.float32, torch.bfloat16):
        cd = dtype if dtype == torch.bfloat16 else None
        reset_counts()
        got = sim(hd, node_in, mask, cd)
        counts, narrowed = read_counts(expected), narrow_calls()
        with plain_path():
            want = sim(hd, node_in, mask, cd)
        delta = (want - node_in[..., :want.shape[-1]]).abs().max().item()
        err = (got - want).abs().max().item()
        tol = FORWARD_TOL[dtype] * max(delta, 1e-3)
        ok = err <= tol and bool(torch.isfinite(got).all())
        print(f"[{label}] forward B={n} {str(dtype)[6:]:9s} "
              f"shape {tuple(got.shape)} max_abs_err vs plain {err:.3e} "
              f"(delta scale {delta:.3e}, tol {tol:.3e}); launches "
              f"{counts} (B = 1: {expected}); narrow-route calls "
              f"{narrowed} (B = 1: {narrow})  {'ok' if ok else 'FAIL'}")
        require(ok, f"{label} B={n} {dtype} forward disagrees with the "
                    f"plain path")
        if "own" in case:
            check_union_samples(case, node_in, mask, got, delta, dtype)
        if device.type == "cuda":
            require(counts == expected and narrowed == narrow,
                    f"{label} B={n} forward launch counts {counts}, "
                    f"narrow-route calls {narrowed}")
        serve = serve or counts
    return serve


def print_agg_designs(case, batches):
    """The tile `agg_node.tile_design` picks for kernel 10 at each level of
    the pallas surface at B = 1 and at each batch of `batches` (it decides
    on the launch's B·N_pad rows)."""
    from bsms_gnn_tpu_torch.ops.kernels import agg_node

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n in sorted({1, *batches}):
        print(f"[{case['label']}] kernel 10's tile at B={n}: " + ", ".join(
            f"L{l} {agg_node.tile_design(n * lvl.n_pad_nodes, sms)}"
            for l, lvl in enumerate(case["hd"].levels)))


def measure_batch(case, device):
    """Forward wall (median of TIMED_REPEATS repeats of ten calls, CUDA
    events; of three above BATCH_SERVE, where a call takes tens of ms or
    more) and busy ms at B = 1, BATCH_SERVE and the case's train batch
    (BATCH_TRAIN unless it names one); the train step at B = 1 and the
    train batch: wall (median of TIMED_REPEATS repeats of five steps at B
    = 1, of two at the batch, where a step takes hundreds of ms), busy,
    idle share, CUDA kernels and own peak MiB; busy ms per sample. f32
    and bf16."""
    sim, label = case["sim"], case["label"]
    train_b = case.get("train_batch", BATCH_TRAIN)
    batch_hd = case.get("union") or (lambda n: case["hd"])
    e2e = {}
    for dtype in (torch.float32, torch.bfloat16):
        cd = dtype if dtype == torch.bfloat16 else None
        key = str(dtype)[6:].replace("float32", "f32").replace(
            "bfloat16", "bf16")
        for n in sorted({1, BATCH_SERVE, train_b}):
            hd = case["hd"] if n == 1 else batch_hd(n)
            node_in, _, mask = (batch_frames(case, n, 21) if n > 1 else
                                (case["node_in"], None, case["mask"]))
            reps, warm = (10, 3) if n <= BATCH_SERVE else (3, 1)
            with torch.no_grad():
                runs = [event_ms(lambda: sim(hd, node_in, mask, cd),
                                 reps=reps, warmup=warm)
                        for _ in range(TIMED_REPEATS)]
                prof = profile_call(lambda: sim(hd, node_in, mask, cd))
            wall, busy = float(np.median(runs)), prof[1]
            e2e[f"forward_ms_b{n}_{key}"] = wall
            e2e[f"forward_busy_ms_b{n}_{key}"] = busy
            print(f"[{label}] forward B={n} {key}: {wall:.4f} ms (median of "
                  f"{[round(r, 4) for r in runs]}), busy {busy:.4f} ms "
                  f"({busy / n:.4f} per sample), idle share "
                  f"{1 - busy / wall:.3f}, {prof[2]} CUDA kernels")
        for n in (1, train_b):
            hd = case["hd"] if n == 1 else batch_hd(n)
            if n == 1:
                node_in, tar = case.get("train_frames") or (
                    case["node_in"], train_target(case))
                mask = case["mask"]
            else:
                node_in, tar, mask = batch_frames(case, n, 22)
            tr = make_trainer(case, device, cd)

            def step():
                tr.iter(hd, node_in, tar, mask)

            for _ in range(TRAIN_GATE + 1):
                step()
            runs = [event_ms(step, reps=5 if n == 1 else 2, warmup=1)
                    for _ in range(TIMED_REPEATS if n == 1
                                   else BATCH_TIMED_REPEATS)]
            ms = float(np.median(runs))
            with own_peak() as peak:
                step()
            peak = peak[0]
            prof = profile_call(step)
            print_profile(f"[{label}] train step B={n} {key}", *prof)
            if n > 1:
                print_port_kernels(prof[4])
            print(f"[{label}] train step B={n} {key}: {ms:.4f} ms (median of "
                  f"{[round(r, 4) for r in runs]}), busy {prof[1]:.4f} ms "
                  f"({prof[1] / n:.4f} per sample), idle share "
                  f"{1 - prof[1] / ms:.3f}, {prof[2]} CUDA kernels, own peak "
                  f"{peak:.1f} MiB")
            e2e.update({f"train_step_ms_b{n}_{key}": ms,
                        f"train_step_busy_ms_b{n}_{key}": prof[1],
                        f"train_step_kernels_b{n}_{key}": prof[2],
                        f"train_step_peak_above_mib_b{n}_{key}": peak})
            del tr
    return e2e


# -- the `ell` method (JAX's default aggregation) -----------------------------


def build_inflating_ell_case(device):
    """inflating_font at full width and depth (`inflating_font_config`:
    depth 4, pos_dim 3, world edges, latent 128, hidden 3) on the `ell`
    method over variable meshes: the surfaces of
    `generate_inflating_trajectory(n, 2, default_rng(seed))`
    (INFLATING_MESHES), planned into one size group (unwindowed,
    edge_block 128) and each padded to the group's buckets. A sample's
    input is its mesh's world positions of frame 0, its target frame 1;
    the mask is the normal nodes. Weights from
    `torch.Generator().manual_seed(0)`."""
    from bsms_gnn_tpu_torch.config import DatasetConfig, inflating_font_config
    from bsms_gnn_tpu_torch.data.synthetic import (
        NT_NORMAL,
        generate_inflating_trajectory,
    )
    from bsms_gnn_tpu_torch.graph.bistride import build_bistride_levels
    from bsms_gnn_tpu_torch.graph.buckets import plan_buckets
    from bsms_gnn_tpu_torch.graph.hierarchy import pad_levels, to_device
    from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
    from bsms_gnn_tpu_torch.models.simulator import Simulator

    data = DatasetConfig(consist_mesh=False, pad_multiple=128,
                         edge_block=ELL_EDGE_BLOCK, size_buckets=1, window=0)
    config = functools.partial(inflating_font_config, aggregation="ell")
    cfg = config().model
    t0 = time.perf_counter()
    trajs, levels = [], []
    for n, seed in INFLATING_MESHES:
        traj = generate_inflating_trajectory(n, 2, np.random.default_rng(seed))
        pos = traj["mesh_pos"][0].astype(np.float64)
        trajs.append(traj)
        levels.append(build_bistride_levels(
            to_flat_edge(traj["cells"][0], "tri"), cfg.unet_depth, len(pos),
            pos))
    plan = plan_buckets(levels, data)
    hs = [pad_levels(lv, data.pad_multiple,
                     pos=t["mesh_pos"][0].astype(np.float64),
                     edge_block=data.edge_block, window=0,
                     **plan.for_mesh(i))
          for i, (lv, t) in enumerate(zip(levels, trajs))]
    build_s = time.perf_counter() - t0
    print(f"[inflating ell] bucket plan: {plan.groups}")
    hds = [to_device(h, device) for h in hs]
    sim = Simulator(cfg, torch.Generator().manual_seed(0), device=device)
    samples = []
    for traj, h, hd in zip(trajs, hs, hds):
        n, n_pad = traj["mesh_pos"].shape[1], h.levels[0].n_pad_nodes
        node_in = np.zeros((n_pad, 7), np.float32)
        node_in[:n, :3] = traj["world_pos"][0]
        node_in[:n, 3:6] = traj["mesh_pos"][0]
        node_in[:n, 6] = traj["node_type"][0, :, 0]
        target = np.zeros((n_pad, 3), np.float32)
        target[:n] = traj["world_pos"][1]
        mask = np.zeros((n_pad, 1), np.float32)
        mask[:n, 0] = traj["node_type"][0, :, 0] == NT_NORMAL
        samples.append(tuple(torch.from_numpy(a).to(device)
                             for a in (node_in, target, mask))
                       + (hd.levels[0].node_mask,))
    node_in, target, mask, _ = samples[1]
    fill_normalizers(sim, node_in, mask, np.random.default_rng(0))
    return dict(label="inflating 16k ell", h=hs[1], hd=hds[1], cfg=cfg,
                sim=sim, config=config, node_in=node_in, mask=mask,
                n=INFLATING_MESHES[1][0], build_s=build_s,
                train_frames=(node_in, target), samples=samples,
                frames=inflating_frames,
                union=stacked_unions(hds, "inflating ell"))


def inflating_frames(case, n, seed):
    """n samples of the inflating batch: sample s on mesh s mod 3, its world
    positions its mesh's frame 0 plus 0.02·N(0, 1) on the real rows (a
    generator seeded with `seed`), its target frame 1 plus the same
    offset, its mask its mesh's."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    ins, tars, masks = [], [], []
    for s in range(n):
        node_in, tar, mask, real = case["samples"][s % len(case["samples"])]
        shift = 0.02 * torch.randn(node_in.shape[0], 3, generator=g).to(
            node_in.device) * real
        ins.append(torch.cat([node_in[:, :3] + shift, node_in[:, 3:]], -1))
        tars.append(tar + shift)
        masks.append(mask)
    return torch.stack(ins), torch.stack(tars), torch.stack(masks)


def cylinder_ell_case(device):
    """The cylinder's three meshes on the `ell` method and the JAX CLI's
    layouts (`build_cylinder_case(aggregation="ell")`), batched as
    cylinder_batch batches them: sample s on mesh s mod 3
    (`cylinder_frames`), each batch on the union of its samples'
    hierarchies."""
    case = build_cylinder_case(device, aggregation="ell")
    hds = [f[0] for f in case["trainer_frames"]]
    return dict(case, label="cylinder 1.9k ell", frames=cylinder_frames,
                union=stacked_unions(hds, "cylinder ell"))


# path → (the function that builds its case on the `ell` method, the
# methods of its twins: the same weights and normalizers on the same
# hierarchy, held against it).
ELL_PATHS = {
    "airfoil_ell": (lambda d: dict(build_case(d, plain=True,
                                              aggregation="ell"),
                                   label="airfoil 5k ell"),
                    ("segment", "pallas")),
    "flag_ell": (lambda d: dict(build_flag_case(d, aggregation="ell"),
                                label="flag 1.6k ell", frames=flag_frames),
                 ("segment",)),
    "cylinder_ell": (cylinder_ell_case, ("segment",)),
    "inflating_ell": (build_inflating_ell_case, ("segment",)),
}


def launched():
    """Every launch and narrow-route call the port's kernel wrappers
    counted since `reset_counts`."""
    return sum(read_counts(KERNEL_META).values()) + sum(narrow_calls())


def real_rows(hd, like):
    """Level 0's real-row mask, shaped to broadcast against `like` (a
    union's rows read as [B, N_pad, 1])."""
    real = hd.levels[0].node_mask
    if like.dim() == 3 and hd.samples > 1:
        real = real.reshape(hd.samples, -1, 1)
    return real


def twin_of(case, method):
    """The case's model on another method, with the same weights and
    normalizers."""
    from bsms_gnn_tpu_torch.models.simulator import Simulator

    sim = case["sim"]
    twin = Simulator(dataclasses.replace(sim.cfg, aggregation=method),
                     device=case["node_in"].device)
    twin.load_state_dict(sim.state_dict())
    twin.norm_in, twin.norm_out = sim.norm_in, sim.norm_out
    return twin


def check_ell_forward(case, twins, hd, node_in, mask):
    """The `ell` forward against each twin's (FORWARD_TOL, f32 and bf16) on
    the real rows: row n_pad − 1 of each sample sums the pad slots'
    messages under `segment` and `pallas`, and none under `ell`, by
    construction (its difference is printed). In bf16 the `segment` twin's
    `index_add` rounds every add to bf16, in another order each run, where
    `ell` sums in f32 and rounds once: its limit is the larger of
    FORWARD_TOL's and twice the twin's own noise (the larger of its
    distance from itself and from its f32 forward), as `check_ell_step`
    sets its limits. The launch gate: the `ell` and `segment` forwards
    launch no port kernel."""
    sim, label = case["sim"], case["label"]
    b = "1" if node_in.dim() == 2 else str(node_in.shape[0])
    c = case["cfg"].out_dim
    f32 = {}
    for dtype in (torch.float32, torch.bfloat16):
        cd = dtype if dtype == torch.bfloat16 else None
        reset_counts()
        got = sim(hd, node_in, mask, cd)
        require(launched() == 0, f"{label}: the ell forward launched "
                                 f"{read_counts(KERNEL_META)}")
        real = real_rows(hd, got)
        for method, twin in twins.items():
            reset_counts()
            want = twin(hd, node_in, mask, cd)
            if method == "segment":
                require(launched() == 0,
                        f"{label}: the segment forward launched "
                        f"{read_counts(KERNEL_META)}")
            delta = ((want - node_in[..., :c]) * real).abs().max().item()
            err = ((got - want) * real).abs().max().item()
            pad = ((got - want) * (1 - real)).abs().max().item()
            tol = FORWARD_TOL[dtype] * max(delta, 1e-3)
            noise = ""
            if dtype == torch.float32:
                f32[method] = want
            elif method == "segment":
                again = twin(hd, node_in, mask, cd)
                own = max(((want - again) * real).abs().max().item(),
                          ((want - f32[method]) * real).abs().max().item())
                tol = max(tol, 2 * own)
                noise = f", segment's own noise {own:.3e}"
                del again
            ok = err <= tol and bool(torch.isfinite(got).all())
            print(f"[{label}] forward B={b} {str(dtype)[6:]:9s} shape "
                  f"{tuple(got.shape)} against {method}: max_abs_err on the "
                  f"real rows {err:.3e} (delta scale {delta:.3e}, tol "
                  f"{tol:.3e}{noise}; the pad rows differ by {pad:.3e}); port "
                  f"kernel launches on ell and segment: 0  "
                  f"{'ok' if ok else 'FAIL'}")
            require(ok, f"{label} B={b} {dtype} forward disagrees with "
                        f"{method}")
        del got, want
    del f32


def check_ell_step(case, twin, hd, node_in, tar, mask):
    """The `ell` train step's loss and every gradient against the `segment`
    twin's (TRAIN_TOL, f32 and bf16), the twin also against itself (its
    `index_add` sums run in another order each time); neither launches a
    port kernel. The limits are the case's (`train_tol`: the unreordered
    airfoil's, PLAIN_TRAIN_TOL, whose f32 step lands in one of a few states
    from run to run of `segment` itself), else TRAIN_TOL. In bf16 the
    twin's `index_add` rounds every add to bf16, in another order each run,
    where `ell` sums K rows in f32 and rounds once: the bf16 twin carries
    its own noise, measured as the larger of its distance from itself and
    from its f32 step, and two such draws may lie twice that apart, so
    each bf16 limit is the larger of the case's and twice that noise
    (printed; the RMS limit stays far below the ~1.4 of RMS of a wrong
    gradient). Returns the largest own peak MiB of the steps."""
    sim, label = case["sim"], case["label"]
    b = 1 if node_in.dim() == 2 else node_in.shape[0]
    worst = 0.0
    f32 = None
    for dtype in (torch.float32, torch.bfloat16):
        cd = dtype if dtype == torch.bfloat16 else None
        reset_counts()
        with own_peak() as peak:
            loss, grads = step_grads(sim, hd, node_in, tar, mask, cd)
        with own_peak() as peak_s:
            loss_s, grads_s = step_grads(twin, hd, node_in, tar, mask, cd)
        loss_q, grads_q = step_grads(twin, hd, node_in, tar, mask, cd)
        require(launched() == 0, f"{label}: a train step launched "
                                 f"{read_counts(KERNEL_META)}")
        worst = max(worst, peak[0], peak_s[0])
        tol_loss, tol_max, tol_rms = case.get("train_tol", TRAIN_TOL)[dtype]
        own = ""
        self_rel, _ = grad_errors(grads_q, grads_s)
        if f32 is None:
            f32 = loss_s, grads_s
        else:
            own_rel, _ = grad_errors(grads_s, f32[1])
            noise = (max(abs(loss_s - f32[0]) / abs(f32[0]),
                         abs(loss_q - loss_s) / abs(loss_s)),
                     max(max(own_rel)[0], max(self_rel)[0]),
                     max(max(r[1] for r in own_rel),
                         max(r[1] for r in self_rel)))
            tol_loss, tol_max, tol_rms = (max(t, 2 * n) for t, n in zip(
                (tol_loss, tol_max, tol_rms), noise))
            own = (f"; segment's bf16 step against its f32 step: loss "
                   f"{abs(loss_s - f32[0]) / abs(f32[0]):.2e}, worst max "
                   f"{max(own_rel)[0]:.2e}, worst rms "
                   f"{max(r[1] for r in own_rel):.2e}")
        rel, zero = grad_errors(grads, grads_s)
        worst_max, worst_rms = max(rel), max(rel, key=lambda r: r[1])
        loss_err = abs(loss - loss_s) / abs(loss_s)
        ok = (loss_err <= tol_loss and worst_max[0] <= tol_max
              and worst_rms[1] <= tol_rms)
        print(f"[{label}] train step B={b} {str(dtype)[6:]:9s} loss "
              f"{loss:.6e} (segment {loss_s:.6e}, rel err {loss_err:.2e}, "
              f"tol {tol_loss:.0e}); {len(rel)} gradients, worst max err "
              f"{worst_max[0]:.2e} of rms ({worst_max[2]}, tol "
              f"{tol_max:.1e}), worst rms err {worst_rms[1]:.2e} of rms "
              f"({worst_rms[2]}, tol {tol_rms:.1e}), median rms err "
              f"{float(np.median([r[1] for r in rel])):.2e}; {len(zero)} "
              f"exactly zero on both; segment against itself: worst max "
              f"{max(self_rel)[0]:.2e}, worst rms "
              f"{max(r[1] for r in self_rel):.2e}{own}; own peak "
              f"{peak[0]:.1f} MiB (segment {peak_s[0]:.1f}); port kernel "
              f"launches 0  {'ok' if ok else 'FAIL'}")
        require(ok, f"{label} B={b} {dtype} train step disagrees with "
                    f"segment")
    return worst


def measure_batch_train(case, device, hd, frames, b, e2e,
                        dtypes=(torch.float32, torch.bfloat16)):
    """A `Trainer` of the case's model at batch b, in each of `dtypes`: the
    gate, then updates; ms per step (median of BATCH_TIMED_REPEATS repeats
    of two steps, CUDA events), busy ms, idle share and CUDA kernels of one
    profiled step,
    own peak MiB of one step; the losses finite and every parameter with a
    gradient moved. On an airfoil (the `ell` one, the auto-width one) the
    windowed `fused` airfoil_batch figures of this run stand beside them.
    Returns the end-to-end keys."""
    label = case["label"]
    out = {}
    for dtype in dtypes:
        cd = dtype if dtype == torch.bfloat16 else None
        key = "f32" if cd is None else "bf16"
        tr = make_trainer(case, device, cd)
        before = [p.detach().clone() for p in tr.sim.parameters()]

        def step():
            return tr.iter(hd, *frames)

        losses = [float(step()) for _ in range(TRAIN_GATE + 2)]
        runs = [event_ms(step, reps=2, warmup=0)
                for _ in range(BATCH_TIMED_REPEATS)]
        ms = float(np.median(runs))
        with own_peak() as peak:
            losses.append(float(step()))
        prof = profile_call(step)
        stuck = [k for (k, p), w in zip(tr.sim.named_parameters(), before)
                 if not bool((p.detach() != w).any()) and bool(p.grad.any())]
        require(all(np.isfinite(losses)) and not stuck,
                f"{label} trainer B={b}: losses {losses}, stuck {stuck}")
        busy = prof[1]
        print_profile(f"[{label}] train step B={b} {key}", *prof)
        line = (f"[{label}] train step B={b} {key}: {ms:.4f} ms (median of "
                f"{[round(r, 4) for r in runs]}), busy {busy:.4f} ms "
                f"({busy / b:.4f} per sample), idle share "
                f"{1 - busy / ms:.3f}, {prof[2]} CUDA kernels, own peak "
                f"{peak[0]:.1f} MiB; trainer losses {losses}")
        fused = f"airfoil_b48_train_step_ms_b{b}_{key}"
        if case["label"].startswith("airfoil") and fused in e2e:
            f_ms = e2e[fused]
            f_busy = e2e[f"airfoil_b48_train_step_busy_ms_b{b}_{key}"]
            f_peak = e2e[f"airfoil_b48_train_step_peak_above_mib_b{b}_{key}"]
            line += (f"; the windowed fused airfoil (airfoil_batch, this "
                     f"run): {f_ms:.4f} ms, busy {f_busy:.4f} ms, idle "
                     f"share {1 - f_busy / f_ms:.3f}, own peak "
                     f"{f_peak:.1f} MiB: {label} takes {ms / f_ms:.2f}x "
                     f"the time and {peak[0] / f_peak:.2f}x the memory")
        print(line)
        out.update({f"train_step_ms_b{b}_{key}": ms,
                    f"train_step_busy_ms_b{b}_{key}": busy,
                    f"train_step_kernels_b{b}_{key}": prof[2],
                    f"train_step_peak_above_mib_b{b}_{key}": peak[0]})
        del tr
    return out


def run_ell_case(device, path, e2e):
    """An `ell` path (ELL_PATHS): the B = 1 forward against its twins, the
    forward at BATCH_SERVE against the `segment` twin, the B = 1 train
    step against the `segment` step, then the train step at the largest
    batch up to BATCH_TRAIN that fits (ELL_TRAIN_MEM_SHARE) against it and
    the `Trainer` there with its times; no port kernel launches on the
    `ell` and `segment` routes. Returns (kernel errors, kernel rows,
    forward launches, train launches, end-to-end times) as `run_case`
    does: the first four empty."""
    build, methods = ELL_PATHS[path]
    case = build(device)
    label, sim = case["label"], case["sim"]
    twins = {m: twin_of(case, m) for m in methods}
    batch_hd = case.get("union") or (lambda n: case["hd"])
    hd0 = case["hd"]
    print(f"[{label}] mesh: {case['n']} nodes; level N_pad "
          f"{[lv.n_pad_nodes for lv in hd0.levels]}, E_pad "
          f"{[lv.n_pad_edges for lv in hd0.levels]}, ELL K (recv) "
          f"{[lv.recv_ell.shape[1] for lv in hd0.levels]}; built in "
          f"{case['build_s']:.2f} s")
    with torch.no_grad():
        check_ell_forward(case, twins, hd0, case["node_in"], case["mask"])
        node_in, _, mask = batch_frames(case, BATCH_SERVE, 21)
        check_ell_forward(case, {"segment": twins["segment"]},
                          batch_hd(BATCH_SERVE), node_in, mask)
        del node_in, mask
    node_in, tar = case.get("train_frames") or (case["node_in"],
                                                train_target(case))
    peak1 = check_ell_step(case, twins["segment"], hd0, node_in, tar,
                           case["mask"])
    total = torch.cuda.get_device_properties(0).total_memory / 2**20
    b = int(min(BATCH_TRAIN, ELL_TRAIN_MEM_SHARE * total // max(peak1, 1.0)))
    print(f"[{label}] train batch {b}: the B = 1 step's peak {peak1:.1f} MiB "
          f"times B within {ELL_TRAIN_MEM_SHARE} of the card's {total:.0f} "
          f"MiB" + ("" if b == BATCH_TRAIN else
                    f" (BATCH_TRAIN = {BATCH_TRAIN} would not fit)"))
    frames = batch_frames(case, b, 22)
    hd = batch_hd(b)
    check_ell_step(case, twins["segment"], hd, *frames)
    del twins
    out = measure_batch_train(case, device, hd, frames, b, e2e)
    del case, frames
    torch.cuda.empty_cache()
    return {}, {}, {}, {}, out


# -- the CLIs (phase 24) ----------------------------------------------------------


def cli_trajectories(cfg):
    """Phase 2's mesh (`make_graded_airfoil_mesh(N_NODES, default_rng(0))`)
    with the analytic flow (velocity and density, the synthetic airfoil's
    fields): two train trajectories of BATCH_TRAIN + 2 frames, one test
    trajectory of ROLLOUT_STEPS + 1, each its own seeded phase."""
    from bsms_gnn_tpu_torch.data.synthetic import (
        generate_trajectory,
        make_graded_airfoil_mesh,
    )

    mesh = make_graded_airfoil_mesh(N_NODES, np.random.default_rng(0))
    rng = np.random.default_rng(24)
    train = [generate_trajectory(mesh, BATCH_TRAIN + 2, rng, True)
             for _ in range(2)]
    test = generate_trajectory(mesh, ROLLOUT_STEPS + 1, rng, True)
    keep = set(cfg.datasets.field_names)
    return ([{k: v for k, v in f.items() if k in keep} for f in train],
            {k: v for k, v in test.items() if k in keep})


def cli_samplers(cfg, train_readers, test_reader, skip=0):
    """The train sampler (one worker: a fixed order of batches) with its
    first `skip` batches drawn, and the test sampler (BATCH_SERVE frames:
    the test trajectory is shorter than a train batch)."""
    from bsms_gnn_tpu_torch.data.pipeline import TrajectorySampler

    train = TrajectorySampler.from_readers(
        cfg.datasets, train_readers, cfg.batch, num_workers=1,
        base_seed=cfg.base_seed, timeout=CLI_BATCH_TIMEOUT)
    for _ in range(skip):
        next(train)
    test = TrajectorySampler.from_readers(
        cfg.datasets, [test_reader], BATCH_SERVE, num_workers=1,
        base_seed=cfg.base_seed, timeout=CLI_BATCH_TIMEOUT)
    return train, test


def trainer_state(trainer):
    """(parameters, normalizer arrays, AdamW moments) of a trainer, on the
    CPU, by name."""
    sd = trainer.state_dict()
    norms = {f"{n}.{k}": v for n in ("norm_in", "norm_out")
             for k, v in sd[n].items() if isinstance(v, torch.Tensor)}
    moments = {f"{n}.{k}": v for n, st in sd["adam"].items()
               for k, v in st.items()}
    return {k: v.cpu() for d in (sd["params"], norms, moments)
            for k, v in d.items()}


def run_cli_case(device, e2e):
    """Phase 24: the CLIs' `run_train` and `run_rollout` on the main path
    (module docstring). Returns (kernel errors, kernel rows, forward
    launches, train launches, end-to-end times) as `run_case` does: the
    first four empty (the CLI runs no kernel of its own)."""
    import importlib.util
    import tempfile

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bsms_gnn_tpu_torch.config import load_config
    from bsms_gnn_tpu_torch.data.trajectory import TrajectoryReader
    from bsms_gnn_tpu_torch.rollout import run_rollout
    from bsms_gnn_tpu_torch.train import run_train
    from bsms_gnn_tpu_torch.training.checkpoint import (
        latest_step,
        restore_checkpoint,
    )
    from bsms_gnn_tpu_torch.training.rollout import rollout_trajectory
    from bsms_gnn_tpu_torch.training.trainer import Trainer

    label = "cli"
    print(f"[{label}] importable here (information only): yaml "
          f"{importlib.util.find_spec('yaml') is not None}, h5py "
          f"{importlib.util.find_spec('h5py') is not None}")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        overrides = [
            "datasets=synthetic_airfoil", f"model.unet_depth={DEPTH}",
            f"datasets.unet_depth={DEPTH}", "model.aggregation=fused",
            f"datasets.window={WINDOW}", f"datasets.edge_block={EDGE_BLOCK}",
            f"batch={BATCH_TRAIN}", f"model.accumulation_steps={CLI_GATE}",
            "opt.warmup_steps=2", "opt.decay_steps=1000", "epochs=1",
            f"steps_per_epoch={CLI_STEPS}", f"save_freq={CLI_SAVE}",
            "loss_freq=1000", "time_freq=1000", "plot=false",
            "dataset_workers=1", f"dump_dir={tmp}", f"datasets.root={tmp}"]
        cfg = load_config(overrides)
        require(cfg.model.aggregation == "fused" and cfg.device == ""
                and cfg.datasets.window == WINDOW and cfg.batch == BATCH_TRAIN,
                f"load_config gave {cfg}")
        train_fields, test_fields = cli_trajectories(cfg)
        t0 = time.perf_counter()
        first = TrajectoryReader.from_fields(cfg.datasets, train_fields[0],
                                             tmp, "shared", device=device)
        readers = [first] + [
            TrajectoryReader.from_fields(cfg.datasets, f, tmp, "shared",
                                         device=device, shared=first)
            for f in train_fields[1:]]
        test_reader = TrajectoryReader.from_fields(
            cfg.datasets, test_fields, tmp, "shared", device=device,
            shared=first)
        cached = TrajectoryReader.from_fields(
            cfg.datasets, test_fields, tmp, "shared", device="cpu")
        got, want = layout_of(first.hierarchy), LAYOUTS.get("airfoil 5k")
        print(f"[{label}] readers in {time.perf_counter() - t0:.2f} s (the "
              f"hierarchy built, cached and shared; one reader from the "
              f"cache): (n_nodes, n_pad, E_pad) per level {got}; phase 2's "
              f"{want}; frames {[len(r) for r in readers]} train, "
              f"{len(test_reader)} test")
        require(got == want and layout_of(cached.hierarchy) == got,
                "the reader's hierarchy is not phase 2's")

        snaps, iters, counts, prof = {}, {}, {}, {}

        @contextlib.contextmanager
        def observe(step, trainer):
            if step in (0, CLI_GATE):
                snaps[step] = {k: p.detach().clone()
                               for k, p in trainer.sim.named_parameters()}
            torch.cuda.synchronize()
            t = time.perf_counter()
            if step == CLI_COUNT_STEP:
                reset_counts()
                yield
                counts.update(read_counts(EXPECTED_TRAIN_LAUNCHES))
            elif step == CLI_PROFILE_STEP:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as p:
                    t_in = time.perf_counter()
                    yield
                    torch.cuda.synchronize()
                    prof["wall"] = (time.perf_counter() - t_in) * 1e3
                kernels = [e for e in p.key_averages()
                           if e.device_type == DeviceType.CUDA
                           and _device_ms(e) > 0
                           and not getattr(e, "is_user_annotation", False)]
                prof.update(
                    busy=sum(_device_ms(e) for e in kernels),
                    launches=sum(e.count for e in kernels),
                    top=sorted(((e.key[:60], e.count, _device_ms(e))
                                for e in kernels), key=lambda r: -r[2])[:8],
                    by_name=[(e.key, e.count, _device_ms(e))
                             for e in kernels])
            else:
                yield
            torch.cuda.synchronize()
            iters[step] = (time.perf_counter() - t) * 1e3

        train_s, test_s = cli_samplers(cfg, readers, test_reader)
        t0 = time.perf_counter()
        run = run_train(cfg, train_s, test_s, step_context=observe)
        run_s = time.perf_counter() - t0
        tr, losses, ckpt_dir = run["trainer"], run["losses"], run["ckpt_dir"]
        print_profile(f"[{label}] CLI step {CLI_PROFILE_STEP} (B="
                      f"{BATCH_TRAIN} f32: its batch, the step)",
                      prof["wall"], prof["busy"], prof["launches"],
                      prof["top"])
        print_port_kernels(prof["by_name"])
        gate_kept = all(torch.equal(snaps[0][k], v)
                        for k, v in snaps[CLI_GATE].items())
        stuck = [k for k, p in tr.sim.named_parameters()
                 if torch.equal(p.detach(), snaps[CLI_GATE][k])
                 and bool(p.grad.any())]
        accs = float(tr.sim.norm_in.num_accumulations)
        saved = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir))
        print(f"[{label}] run_train: {len(losses)} steps in {run_s:.2f} s "
              f"(trainer step {tr.step}, {tr.updates} updates), losses "
              f"{[round(x, 6) for x in losses]}; the gate kept the "
              f"parameters: {gate_kept}; normalizer accumulations "
              f"{accs:g}; parameters with a gradient that did not move "
              f"after the gate: {stuck}; checkpoints {saved}")
        print(f"[{label}] launches in CLI step {CLI_COUNT_STEP}: {counts} "
              f"(expected {EXPECTED_TRAIN_LAUNCHES})")
        require(len(losses) == CLI_STEPS + 1 and all(np.isfinite(losses)),
                "CLI losses missing or not finite")
        require(gate_kept and accs == CLI_GATE and not stuck
                and tr.updates == CLI_STEPS + 1 - CLI_GATE,
                "the gate moved the parameters or an update did not")
        require(counts == EXPECTED_TRAIN_LAUNCHES,
                f"CLI step launches {counts} != {EXPECTED_TRAIN_LAUNCHES}")
        require(saved == [CLI_SAVE, 2 * CLI_SAVE, CLI_STEPS + 1],
                f"checkpoints {saved}")

        # Resumed from the checkpoint at CLI_SAVE, on the same batches.
        rcfg = load_config(overrides + [f"restore_dir={ckpt_dir}",
                                        f"restore_step={CLI_SAVE}",
                                        "project=cli_resume"])
        train_s, test_s = cli_samplers(rcfg, readers, test_reader,
                                       skip=CLI_SAVE)
        resumed = run_train(rcfg, train_s, test_s)
        a, b = trainer_state(tr), trainer_state(resumed["trainer"])
        differ = [k for k in a if not torch.equal(a[k], b[k])]
        print(f"[{label}] resumed at step {CLI_SAVE}: ends at step "
              f"{resumed['trainer'].step}, losses "
              f"{[round(x, 6) for x in resumed['losses']]} (the first run's "
              f"{[round(x, 6) for x in losses[CLI_SAVE:]]}); {len(a)} "
              f"parameter, normalizer and AdamW tensors, "
              f"{len(differ)} not bit for bit the uninterrupted run's: "
              f"{differ[:6]}")
        require(resumed["trainer"].step == tr.step and not differ
                and resumed["losses"] == losses[CLI_SAVE:],
                "the resumed run is not the uninterrupted one")

        # Rollout from the newest checkpoint.
        preds = []
        summary = run_rollout(
            load_config(overrides + [f"restore_dir={ckpt_dir}"]),
            readers=[test_reader],
            on_trajectory=lambda r, p: preds.append(p))
        ref = Trainer(cfg, device=device)
        restore_checkpoint(ckpt_dir, latest_step(ckpt_dir), ref)
        inp, _, mask = test_reader.full()
        direct = rollout_trajectory(
            ref.sim, test_reader.hd, torch.from_numpy(inp[0]).to(device),
            torch.from_numpy(mask[0]).to(device), inp.shape[0],
            ref.compute_dtype)
        finite = all(np.isfinite(v).all() for v in (
            summary["overall_mean"], summary["overall_std"],
            summary["per_channel_mean"], summary["per_time_mean"]))
        same = len(preds) == 1 and torch.equal(preds[0], direct)
        print(f"[{label}] run_rollout from step {latest_step(ckpt_dir)}: "
              f"{inp.shape[0]} steps, shape {tuple(direct.shape)}, overall "
              f"RMSE {summary['overall_mean']:.6f}, finite {finite}; "
              f"predictions bit for bit rollout_trajectory's: {same}")
        require(finite and same, "the rollout CLI disagrees or is not finite")

    timed = [iters[s] for s in range(CLI_GATE, CLI_STEPS + 1)
             if s not in (CLI_SAVE, 2 * CLI_SAVE, CLI_PROFILE_STEP)]
    ms = float(np.median(timed))
    base = {k: e2e.get(f"airfoil_b48_train_step_{k}_b48_f32")
            for k in ("ms", "busy_ms")}
    print(f"[{label}] CLI step B={BATCH_TRAIN} f32: {ms:.4f} ms (median of "
          f"the steps {[round(x, 4) for x in timed]}, each its batch, "
          f"logging and step, synchronized before and after; the steps "
          f"with a checkpoint: {[round(iters[s], 4) for s in (CLI_SAVE, 2 * CLI_SAVE)]}); "
          f"profiled step: busy {prof['busy']:.4f} ms, idle share "
          f"{1 - prof['busy'] / prof['wall']:.3f}, {prof['launches']} CUDA "
          f"kernels; airfoil_batch's Trainer step of this run: "
          f"{base['ms']} ms, busy {base['busy_ms']} ms")
    key = f"b{BATCH_TRAIN}_f32"
    out.update({f"step_ms_{key}": ms, f"step_busy_ms_{key}": prof["busy"],
                f"step_idle_share_{key}": 1 - prof["busy"] / prof["wall"],
                f"step_kernels_{key}": prof["launches"]})
    del tr, resumed, ref, readers, test_reader, first, cached, preds, direct
    torch.cuda.empty_cache()
    return {}, {}, {}, {}, out


# -- deforming_plate (phase 25) and window="auto" (phase 26) ----------------


def native_line(label):
    """Prints whether the bi-stride build squared its adjacency natively
    (`graph.native`, g++ at first use); fails where it did not."""
    from bsms_gnn_tpu_torch.graph import native

    ok = native.native_available()
    print(f"[{label}] native SpGEMM (graph.native, built with g++): "
          f"{ok}" + ("" if ok else f" ({native.error})"))
    require(ok, f"{label}: the native SpGEMM is not available")


def build_plate_case(device):
    """deforming_plate at full width and depth (`deforming_plate_config()`:
    latent 128, hidden 3, depth 5, pos_dim 3, world edges, the `fused`
    method) on three tetra blocks (TETRA_MESHES): each a trajectory of
    TETRA_FRAMES frames of `generate_tetra_trajectory(n, TETRA_FRAMES,
    default_rng(seed))`, read by `TrajectoryReader.from_fields` (Morton
    order, window 256, edge_block 512) with the bucket plan of their one
    size group (`graph.buckets.plan_buckets` of the Morton-ordered blocks'
    levels), its hierarchy on the card. The second block is served, its
    frames 0 and 1 the input and the target; the `Trainer` steps cycle
    over the three blocks. Weights from `torch.Generator().manual_seed(0)`.
    Kernel 11, which phase 10 checks on a windowed level though no model
    path runs it there, is not checked here."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from bsms_gnn_tpu_torch.config import deforming_plate_config
    from bsms_gnn_tpu_torch.data.synthetic import generate_tetra_trajectory
    from bsms_gnn_tpu_torch.data.trajectory import TrajectoryReader
    from bsms_gnn_tpu_torch.graph.buckets import plan_buckets
    from bsms_gnn_tpu_torch.graph.hierarchy import load_or_build_levels
    from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
    from bsms_gnn_tpu_torch.graph.order import reorder_mesh
    from bsms_gnn_tpu_torch.models.simulator import Simulator

    native_line("plate")
    cfg = deforming_plate_config()
    data = dataclasses.replace(cfg.datasets, pad_multiple=128,
                               edge_block=EDGE_BLOCK, window=WINDOW,
                               size_buckets=1, unet_depth=TETRA_DEPTH)
    def block(i):
        n, seed = TETRA_MESHES[i]
        f = generate_tetra_trajectory(n, TETRA_FRAMES,
                                      np.random.default_rng(seed))
        pos, cells, _, _ = reorder_mesh(f["mesh_pos"][0], f["cells"][0])
        # Cached under the reader's name for the Morton-ordered mesh, so
        # each reader loads these levels instead of building them.
        levels = load_or_build_levels(
            tmp, f"plate{i}_mrt", to_flat_edge(cells, "tetra"), TETRA_DEPTH,
            len(pos), pos.astype(np.float64))
        return f, levels, pos

    def reader(i):
        return TrajectoryReader.from_fields(data, trajs[i], tmp, f"plate{i}",
                                            device=device, **plan.for_mesh(i))

    t0 = time.perf_counter()
    # The blocks, then the readers, build in threads (numpy, SciPy, zlib
    # and the native SpGEMM release the GIL).
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(
            len(TETRA_MESHES)) as pool:
        trajs, levels, meshes = zip(*pool.map(block,
                                              range(len(TETRA_MESHES))))
        plan = plan_buckets(list(levels), data)
        require(len(plan.groups) == 1, f"the blocks plan {plan.groups}")
        print(f"[plate] bucket plan: {plan.groups}")
        readers = list(pool.map(reader, range(len(TETRA_MESHES))))
    build_s = time.perf_counter() - t0
    sim = Simulator(cfg.model, torch.Generator().manual_seed(0),
                    device=device)
    frames = [(r.hd, *(torch.from_numpy(a).to(device) for a in r.sample(0)))
              for r in readers]
    hd, node_in, target, mask = frames[1]
    fill_normalizers(sim, node_in, mask, np.random.default_rng(0))
    h = readers[1].hierarchy
    return dict(label="plate 6.5k", h=h, hd=hd, cfg=cfg.model, sim=sim,
                config=deforming_plate_config, node_in=node_in, mask=mask,
                n=readers[1].n_nodes, build_s=build_s, readers=readers,
                expected=EXPECTED_TETRA_LAUNCHES,
                expected_train=EXPECTED_TETRA_TRAIN_LAUNCHES, narrow=(0, 0),
                train_frames=(node_in, target), trainer_frames=frames,
                frames=plate_frames,
                forced_empty=forced_empty_resid(levels[1], meshes[1], plan,
                                                data, device),
                skip=("fused_edge_mlp_aggregate",
                      "fused_edge_mlp_aggregate_bwd"), dense=True,
                send_levels=[l for l, g in enumerate(h.levels)
                             if g.resid is not None])


def plate_frames(case, n, seed):
    """n samples of the plate batch: sample s on block s mod 3, its frame
    t = (s // 3 + seed) mod (TETRA_FRAMES - 1) of that block's trajectory
    and target frame t + 1, its mask the block's: ([n, N_pad, 7], [n,
    N_pad, 3], [n, N_pad, 1]) on the card."""
    readers = case["readers"]
    picks = [readers[s % 3].sample((s // 3 + seed) % (TETRA_FRAMES - 1))
             for s in range(n)]
    device = case["node_in"].device
    return tuple(torch.from_numpy(np.stack(a)).to(device)
                 for a in zip(*picks))


def resid_shape(case, where):
    """Whether a kernel check's shape lies on a level with a residual
    sub-level (or is the forced empty one)."""
    if where.startswith("forced empty"):
        return True
    parts = where.split()
    return (len(parts) > 1 and parts[0] == "level" and parts[1].isdigit()
            and case["h"].levels[int(parts[1])].resid is not None)


def time_plate_kernels(case):
    """Kernel 13 (forward, f32 and bf16) and its backward (f32) at level 0
    of the plate (a static fiber of 4), and kernel 9 (both forms, f32) at
    each residual sub-level, beside their plain versions, `index_add_`
    where it computes the same function, and the card's bound."""
    device = case["node_in"].device
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        fwd = kernel_inputs(case, dtype, device)
        rows[("fused_edge_phase_win_dyn", dtype)] = time_kernel(
            "fused_edge_phase_win_dyn", *fwd["fused_edge_phase_win_dyn"][0],
            dtype)
        if dtype == torch.float32:
            bwd = bwd_kernel_inputs(case, dtype, device)
            rows[("fused_edge_phase_win_dyn_bwd", dtype)] = time_kernel(
                "fused_edge_phase_win_dyn_bwd",
                *bwd["fused_edge_phase_win_dyn_bwd"][0], dtype)
            for where, args in fwd["segment_sum_accum"]:
                if where.startswith("level") and not where.endswith("store"):
                    time_kernel("segment_sum_accum", where, args, dtype)
    return rows


def run_plate_case(device, e2e):
    """Phase 25 (module docstring). Returns (kernel errors, kernel rows,
    forward launch counts, train-step launch counts, end-to-end times) as
    `run_case` does."""
    label = "plate 6.5k"
    with torch.no_grad():
        case = union_case(build_plate_case(device), "plate batch")
        describe(case)
        errs = check_kernels(case, device)
        serve = check_slice(case, device)
        errs.update(check_bwd_kernels(case, device))
        rows = time_plate_kernels(case)
        for dtype in (torch.float32, torch.bfloat16):
            for name, shapes in batch_inputs(case, dtype, device):
                if name in case["skip"]:
                    continue
                for k, (where, args) in enumerate(shapes):
                    if not resid_shape(case, where):
                        continue
                    sparse = name in TILE_WALKS and k > 0
                    check_batched(name, where, args, dtype, sparse,
                                  6500 + 50 * k,
                                  meshes=case["sample_layouts"](name, args),
                                  dense=True)
        check_served_batch(case, device)
    case["train"] = case["train_frames"]
    train = check_train(case, device)
    total = torch.cuda.get_device_properties(0).total_memory / 2**20
    peak1 = case["train_peak"]
    b = int(min(BATCH_TRAIN, ELL_TRAIN_MEM_SHARE * total // max(peak1, 1.0)))
    print(f"[{label}] train batch {b}: the B = 1 step's largest own peak "
          f"{peak1:.1f} MiB times B within {ELL_TRAIN_MEM_SHARE} of the "
          f"card's {total:.0f} MiB" + ("" if b == BATCH_TRAIN else
                                       f" (BATCH_TRAIN = {BATCH_TRAIN} "
                                       f"would not fit)"))
    require(b >= BATCH_CHECK, f"{label}: a train batch of {b}")
    frames = plate_frames(case, b, 22)
    hd = case["union"](b)
    check_train(dict(case, hd=hd, train=frames[:2], mask=frames[2],
                     train_frames=frames[:2], trainer_frames=None,
                     label=f"{label} B={b}"), device)
    # f32 only: the phase's time (a step at 47 takes ~0.9 s).
    out = measure_batch_train(case, device, hd, frames, b, e2e,
                              (torch.float32,))
    out["train_batch"] = b
    del case, frames, hd
    torch.cuda.empty_cache()
    return errs, rows, serve, train, out


def check_deep_tails(case, device):
    """The case's backward tile walks and kernel 6 at DEEP_TAIL tail
    layers: each at its first shape (level 0) with the tail swapped for
    the tail of a seeded DEEP_TAIL-layer node MLP (kernel 6: that MLP),
    f32 and bf16, in `check_bwd_kernels`' measures with its controls. At
    C = 128 these take the walk's `Deep` plan (kernels 5, 13, 14) or stay
    on `Base` (kernels 11 and 12's streamed front), and kernel 6 two more
    kept slices. Their f32 inputs are cleared of ReLU inputs near their
    kinks where `relu_inputs` reads them (KINK_CLEARED)."""
    from bsms_gnn_tpu_torch.ops.dense import MLP

    c = case["cfg"].latent_dim
    mlp = MLP(2 * c, c, c, DEEP_TAIL, True,
              torch.Generator().manual_seed(DEEP_SEED)).to(device)
    tail = [list(mlp.weights)[1:], list(mlp.biases)[1:]]

    def inputs(dtype):
        out = {}
        for name, shapes in bwd_kernel_inputs(case, dtype, device).items():
            where, args = shapes[0]
            args = list(args)
            if name in TILE_WALKS:
                at = [i for i, a in enumerate(args) if isinstance(a, list)]
                args[at[0]], args[at[1]] = tail
            elif name == "fused_node_phase_bwd":
                args[2] = mlp
            else:
                continue
            args = tuple(args)
            if dtype == torch.float32 and name in KINK_CLEARED:
                args = clear_kinks(name, args, torch.Generator().manual_seed(
                    DEEP_SEED))
            out[name] = [(f"{where} L={DEEP_TAIL}", args)]
        return out

    with torch.no_grad():
        check_bwd_kernels(case, device, inputs)


def run_wide_case(device, e2e):
    """Phase 29 (module docstring). Returns (kernel errors, kernel rows,
    forward launch counts, train-step launch counts, end-to-end times) as
    `run_case` does."""
    with torch.no_grad():
        case = build_case(device, wide=True)
        describe(case)
        errs = check_kernels(case, device)
        errs.update(check_bwd_kernels(case, device))
        serve = check_slice(case, device)
        rows, out = measure(case)
        for dtype in (torch.float32, torch.bfloat16):
            for name, shapes in batch_inputs(case, dtype, device):
                for k, (where, args) in enumerate(shapes):
                    check_batched(name, where, args, dtype,
                                  name in TILE_WALKS and k > 0,
                                  WIDE_SEED + 50 * k, clear=True)
    case["train"] = (case["node_in"], train_target(case))
    train = check_train(case, device)
    # The control: kernel 5 in its bf16 mode in the f32 step must fail the
    # step's gate.
    mod, attr, fault = kernel5_fault("bf16")
    saved = getattr(mod, attr)
    setattr(mod, attr, fault)
    try:
        loss_c, grads_c = step_grads(case["sim"], case["hd"], *case["train"],
                                     case["mask"], None)
    finally:
        setattr(mod, attr, saved)
    require(not train_verdict(case, torch.float32, loss_c, grads_c,
                              what=" (control: kernel 5 in bf16 mode)"),
            f"{case['label']}: the f32 step with kernel 5 in its bf16 mode "
            f"passed the step's gate")
    train_rows, train_out = measure_train(case, device)
    rows.update(train_rows)
    out.update(train_out)
    frames = batch_frames(case, BATCH_TRAIN, 22)
    out.update(measure_batch_train(case, device, case["hd"], frames,
                                   BATCH_TRAIN, e2e))
    del case, frames
    torch.cuda.empty_cache()
    return errs, rows, serve, train, out


def run_auto_case(device, e2e):
    """Phase 26 (module docstring). Returns (kernel errors, kernel rows,
    forward launch counts, train-step launch counts, end-to-end times) as
    `run_case` does."""
    native_line("airfoil auto")
    with torch.no_grad():
        case = build_case(device, auto=True)
        describe(case)
        errs = check_kernels(case, device)
        errs.update(check_bwd_kernels(case, device))
        serve = check_slice(case, device)
    case["train"] = (case["node_in"], train_target(case))
    train = check_train(case, device)
    frames = batch_frames(case, BATCH_TRAIN, 22)
    check_train(dict(case, train=frames[:2], mask=frames[2],
                     train_frames=frames[:2],
                     label=f"{case['label']} B={BATCH_TRAIN}"), device)
    out = measure_batch_train(case, device, case["hd"], frames, BATCH_TRAIN,
                              e2e)
    del case, frames
    torch.cuda.empty_cache()
    return errs, {}, serve, train, out


# -- airfoil_halo: the edge-partitioned halo path and data parallelism ------

# The halo path's plan of the 5k airfoil: two shards, the ghost layout at
# the main path's window and edge_block, levels of at most
# HALO_REPLICATE_FLOOR nodes (3-7: 616 nodes and fewer) replicated, 0-2
# (5,233 / 2,604 / 1,279 nodes) partitioned.
HALO_RANKS, HALO_REPLICATE_FLOOR = 2, 700
HALO_ROLLOUT, HALO_UPDATES = 5, 3
# The train steps and forwards each rank times after the checked ones.
HALO_TIMED = 5
# Against the port's one-device model: the CPU tests' tolerance
# (tests/test_torch_port_halo.py, test_halo.py's), relative to each
# value's scale and absolute.
HALO_TOL = dict(rtol=2e-3, atol=2e-4)
# The data-parallel step: DP_RANKS ranks of DP_BATCH frames each against
# the one-process step on all of them.
DP_BATCH = 4
HALO_TIMEOUT_S = 300
# The halo path's batch axis: one forward and one train step of HALO_BATCH
# frames (the data-parallel phase's first ones).
HALO_BATCH = 4
HALO_KERNELS = ("windowed_conv", "compact_accum", "fused_node_phase",
                "fused_edge_phase_win", "fused_edge_phase_win_bwd",
                "fused_node_phase_bwd", "windowed_send_sum")


def build_halo_case(device):
    """The 5k airfoil of phase 2 (its one-device hierarchy, model, frame
    and normalizers) and its HALO_RANKS-shard partition plan."""
    from bsms_gnn_tpu_torch.data.synthetic import make_graded_airfoil_mesh
    from bsms_gnn_tpu_torch.graph.bistride import build_bistride_levels
    from bsms_gnn_tpu_torch.graph.mesh import to_flat_edge
    from bsms_gnn_tpu_torch.graph.order import reorder_mesh
    from bsms_gnn_tpu_torch.parallel.partition import build_partition

    case = build_case(device)
    # build_case's mesh, drawn again from its seed.
    pos, cells, node_type = make_graded_airfoil_mesh(
        N_NODES, np.random.default_rng(0))
    pos, cells, _, _ = reorder_mesh(pos, cells, (node_type,))
    pos = pos.astype(np.float64)
    t0 = time.perf_counter()
    levels = build_bistride_levels(to_flat_edge(cells, "tri"), DEPTH,
                                   pos.shape[0], pos)
    plan = build_partition(levels, HALO_RANKS, case["h"].levels[0].n_pad_nodes,
                           pos, local_layouts=True, window=WINDOW,
                           edge_block=EDGE_BLOCK,
                           replicate_floor=HALO_REPLICATE_FLOOR)
    plan_s = time.perf_counter() - t0
    require([g.num_nodes for g in levels.graphs]
            == [g.n_nodes for g in case["h"].levels],
            "the plan's levels are not the one-device hierarchy's")
    print(f"[airfoil halo] {HALO_RANKS}-shard plan built in {plan_s:.2f} s "
          f"(host): level, nodes, replicated, local rows, extended rows, "
          f"halo width, window, slots per shard, compact rows")
    for l, lvl in enumerate(plan.hierarchy.levels):
        lg = lvl.local
        cr = "-" if lg.cresid is None else lg.cresid.n_real
        print(f"  {l:2d} {lvl.n_nodes:6d} {str(lvl.replicated):5s} "
              f"{lvl.n_pad_nodes:6d} {lg.n_pad_nodes:6d} {lvl.halo_width:5d} "
              f"{lg.window:4d} {lg.n_pad_edges:7d} {cr}")
    require([lvl.replicated for lvl in plan.hierarchy.levels]
            == [l >= 3 for l in range(DEPTH + 1)],
            "the plan does not partition levels 0-2 and replicate 3-7")
    case.update(plan=plan, plan_s=plan_s)
    return case


def _digest(sd) -> str:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(sd):
        h.update(k.encode())
        h.update(sd[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def halo_rank(rank, port, payload, queue):
    """One rank of the halo phase (a process of its own, on cuda:0 over
    gloo): the sharded forward, rollout and train steps, then the
    data-parallel step. Puts (rank, results) on `queue`, every array a
    numpy copy (a tensor would travel as a handle the exiting rank
    closes); a failure puts its traceback and exits non-zero."""
    import traceback

    try:
        queue.put((rank, _halo_rank(rank, port, payload)))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))
        raise


def _host_tree(x):
    """A nest of dicts with tensors as one of numpy copies (what a rank
    puts on the queue)."""
    if isinstance(x, dict):
        return {k: _host_tree(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    return x


def _torch_tree(x):
    """`_host_tree`'s inverse, on the CPU."""
    if isinstance(x, dict):
        return {k: _torch_tree(v) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x)
    return x


def _halo_rank(rank, port, p):
    import datetime

    from bsms_gnn_tpu_torch.graph.hierarchy import to_device
    from bsms_gnn_tpu_torch.models.simulator import Simulator
    from bsms_gnn_tpu_torch.ops.kernels import build
    from bsms_gnn_tpu_torch.parallel import halo
    from bsms_gnn_tpu_torch.parallel.data_parallel import data_parallel_step
    from bsms_gnn_tpu_torch.parallel.mesh import make_groups
    from bsms_gnn_tpu_torch.parallel.multihost import (
        init_distributed,
        shutdown,
    )
    from bsms_gnn_tpu_torch.parallel.partition import partition_nodes
    from bsms_gnn_tpu_torch.training.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stale = [n for n in build.SOURCES if build._stale(n)]
    require(not stale, f"rank {rank}: kernels {stale} would be compiled "
                       f"here (the parent builds them)")
    t0 = time.perf_counter()
    device = init_distributed(
        "gloo", rank, HALO_RANKS, init_method=f"tcp://localhost:{port}",
        device="cuda:0", timeout=datetime.timedelta(seconds=120))
    make_groups(1, HALO_RANKS)
    plan, names = p["plan"], list(kernel_modules())
    out = {"start_s": time.perf_counter() - t0}

    def part(a):
        return torch.from_numpy(np.ascontiguousarray(
            partition_nodes(plan, a)[rank])).to(device)

    sim = Simulator(p["cfg"], device=device)
    sim.load_state_dict(p["params"])
    sim.norm_in, sim.norm_out = (
        dataclasses.replace(st, **{f: getattr(st, f).to(device) for f in (
            "acc_weight", "num_accumulations", "e_x", "e_x2")})
        for st in p["norms"])
    ni, nm, nt = part(p["node_in"]), part(p["mask"]), part(p["tar"])
    t0 = time.perf_counter()
    hier = halo.rank_hierarchy(plan, "graph", device)
    out["hierarchy_s"] = time.perf_counter() - t0
    out["n_loc"] = hier.levels[0].n_pad_nodes

    # Serving: one forward counted, then the rollout.
    reset_counts()
    pred = halo.halo_forward(sim, hier, ni, nm, device=device)
    torch.cuda.synchronize()
    out["forward_counts"] = read_counts(names)
    out["pred"] = pred.cpu().numpy()
    out["rollout"] = halo.halo_rollout(sim, hier, ni, nm, HALO_ROLLOUT,
                                       device=device).cpu().numpy()

    # Training: the gate, then HALO_UPDATES updates, each rank its part of
    # the shared draw; the first update's launches and collectives
    # counted; rank 0 keeps its state before each update and the
    # gradients the update applied.
    tr = halo.HaloTrainer(p["train_cfg"], plan, opt=p["opt"],
                          generator=torch.Generator().manual_seed(1),
                          device=device)
    before = {k: v.detach().clone() for k, v in tr.sim.state_dict().items()}
    losses, grads, states = [], [], []
    for i, z in enumerate(p["noise"]):
        first = i == TRAIN_GATE
        if i >= TRAIN_GATE and rank == 0:
            st = tr.state_dict()
            del st["noise_generator"]
            states.append(_host_tree(st))
        if first:
            reset_counts()
            halo.reset_stats()
        losses.append(float(tr.iter(ni, nt, nm, part(z))))
        if first:
            torch.cuda.synchronize()
            out["train_counts"] = read_counts(names)
            out["train_collectives"] = dict(halo.STATS)
        if i >= TRAIN_GATE and rank == 0:
            grads.append({k: q.grad.detach().cpu().numpy()
                          for k, q in tr.sim.named_parameters()})
    after = tr.sim.state_dict()
    out.update(losses=losses, digest=_digest(after))
    if rank == 0:
        out.update(grads=grads, states=states, updates={
            k: (after[k] - before[k]).cpu().numpy() for k in after})
    # Times, after the checked steps (the first update's wall includes
    # the rank's warm-up): HALO_TIMED train steps and forwards, then one
    # step with a synchronize around each collective.
    walls, fwd = [], []
    for _ in range(HALO_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.iter(ni, nt, nm, part(p["noise"][-1]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        halo.halo_forward(sim, hier, ni, nm, device=device)
        torch.cuda.synchronize()
        fwd.append(time.perf_counter() - t0)
    halo.reset_stats(timed=True)
    tr.iter(ni, nt, nm, part(p["noise"][-1]))
    out.update(step_s=walls, forward_s=fwd, timed_stats=dict(halo.STATS))
    halo.reset_stats()

    # The batch axis: HALO_BATCH frames through one forward and one train
    # step (no gate) from the given weights, each rank its shard of every
    # frame; the forward's launches counted.
    bi, bt, bm, bz = (part(a) for a in p["batch"])
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    pred_b = halo.halo_forward(sim, hier, bi, bm, device=device)
    torch.cuda.synchronize()
    out.update(batch_forward_s=time.perf_counter() - t0,
               batch_forward_counts=read_counts(names),
               batch_pred=pred_b.cpu().numpy())
    tb = halo.HaloTrainer(p["dp_cfg"], plan, opt=p["opt"],
                          generator=torch.Generator().manual_seed(2),
                          device=device)
    tb.sim.load_state_dict(p["params"])
    tb.sim.norm_in, tb.sim.norm_out = sim.norm_in, sim.norm_out
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out["batch_loss"] = float(tb.iter(bi, bt, bm, bz))
    torch.cuda.synchronize()
    out.update(batch_step_s=time.perf_counter() - t0,
               batch_train_counts=read_counts(names),
               batch_digest=_digest(tb.sim.state_dict()))
    if rank == 0:
        out["batch_grads"] = {k: q.grad.detach().cpu().numpy()
                              for k, q in tb.sim.named_parameters()}
    del tb

    # The data-parallel step on the same ranks: each its DP_BATCH frames.
    make_groups(HALO_RANKS, 1)
    dp = Trainer(p["dp_cfg"], p["opt"], generator=torch.Generator().manual_seed(2),
                 device=device)
    dp.sim.load_state_dict(p["params"])
    dp.sim.norm_in, dp.sim.norm_out = sim.norm_in, sim.norm_out
    hd = to_device(p["h"], device)
    sl = slice(rank * DP_BATCH, (rank + 1) * DP_BATCH)
    fi, ft, fm, fz = (torch.from_numpy(a[sl]).to(device) for a in p["dp"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out["dp_loss"] = float(data_parallel_step(dp, hd, fi, ft, fm, fz,
                                              device=device))
    torch.cuda.synchronize()
    out["dp_step_s"] = time.perf_counter() - t0
    out["dp_digest"] = _digest(dp.sim.state_dict())
    if rank == 0:
        out["dp_grads"] = {k: q.grad.detach().cpu().numpy()
                           for k, q in dp.sim.named_parameters()}
    shutdown()
    return out


HALO_BWD = ("fused_edge_phase_win_bwd", "fused_node_phase_bwd",
            "windowed_send_sum")


def halo_kernel_args(hier, sim, dtype, device):
    """Each kernel of the halo path's arguments on one rank's extended
    tables: its ghost layouts of level 0 (partitioned) and level 3 (the
    first replicated), from a seed; kernels 3 and 6 on the owned rows.
    {name: [(where, args)]}, the forward kernels' and the backward
    kernels' (HALO_BWD)."""
    g = torch.Generator(device="cpu").manual_seed(2500)
    c = 128
    cd = dtype if dtype == torch.bfloat16 else None

    def rand(*shape, dt=torch.float32, s=1.0):
        return (s * torch.randn(*shape, generator=g)).to(dt).to(device)

    args = {k: [] for k in HALO_KERNELS}
    for l in (0, 3):
        lvl = hier.levels[l]
        lg, n_loc = lvl.local, lvl.n_pad_nodes
        n, e = lg.n_pad_nodes, lg.n_pad_edges
        gmp = sim.process.down_gmps[l]
        wf8 = first_layer(gmp)[0]
        tail = (list(gmp.mlp_edge.weights)[1:], list(gmp.mlp_edge.biases)[1:])
        w = f"L{l} ext"
        xwi, xj = rand(n, c, dt=dtype), rand(n, c, dt=dtype)
        args["fused_edge_phase_win"].append((w, (lg, xwi, xj, wf8, *tail)))
        args["fused_edge_phase_win_bwd"].append(
            (w, (lg, xwi, xj, wf8, *tail, rand(n, c))))
        args["fused_node_phase"].append((f"L{l} own", (
            rand(n_loc, c, dt=dtype), rand(n_loc, c, s=3.0), gmp.mlp_node,
            cd)))
        args["fused_node_phase_bwd"].append((f"L{l} own", (
            rand(n_loc, c, dt=dtype), rand(n_loc, c, s=3.0), gmp.mlp_node,
            rand(n_loc, c), cd)))
        args["windowed_conv"] += [
            (f"{w} down", (lg, rand(n, c, dt=dtype), lg.ew)),
            (f"{w} up", (lg, rand(n, c, dt=dtype), lg.ew_rev))]
        if lg.cresid is not None:
            args["compact_accum"].append((w, (
                lg.cresid, rand(lg.cresid.n_rows, c, dt=dtype), rand(n, c))))
        args["windowed_send_sum"].append((w, (lg, rand(e, c, dt=dtype))))
    return args


def time_batched_level_form(where, args, dtype):
    """Kernel 1's level form at B = HALO_BATCH (sample 0 `args`' x, the
    others seeded): the profiler's device ms of one call, the plain
    version's and `torch.sparse.mm`'s (f32) on x viewed as [N, B·C], the
    card's bound for the batch's work, and HALO_BATCH calls at B = 1."""
    name = "windowed_conv"
    fn, plain = kernel_modules()[name]
    bargs = batch_args(name, args, HALO_BATCH, 2810)
    parts = kernel_device_ms(lambda: fn(*bargs), KERNEL_META[name][2])
    ms = None if parts is None else sum(parts.values())
    ev = event_ms(lambda: fn(*bargs), reps=50)
    one = event_ms(lambda: [fn(*sample_args(name, bargs, s))
                            for s in range(HALO_BATCH)], reps=20)
    pms = event_ms(lambda: plain(*bargs), reps=20)
    lib = batch_library_call(name, bargs) if dtype == torch.float32 else None
    lms = event_ms(lib, reps=50) if lib is not None else None
    by, ops = batch_work(name, bargs, dtype)
    t_by, t_ops = by / PEAK_BYTES_S * 1e3, ops / PEAK_FLOPS_S[dtype] * 1e3
    by_what = "bytes" if t_by >= t_ops else "operations"
    print(f"time {name} {where} B={HALO_BATCH} {str(dtype)[6:]}: kernel "
          f"{float('nan') if ms is None else ms:.5f} ms (profiler), "
          f"{ev:.5f} ms (events, with the wrapper); {HALO_BATCH} calls at "
          f"B = 1 {one:.5f} ms (events); plain {pms:.5f} ms; library "
          f"{'null' if lms is None else f'{lms:.5f} ms'} (torch.sparse.mm "
          f"on x as [N, B·C]); bound {max(t_by, t_ops):.5f} ms by "
          f"{by_what} ({by} B, {ops} op)")


def check_halo_kernels(case, device, launched):
    """Every kernel the halo path launched against its plain version on
    shard 0's extended tables, f32 and bf16 (with bf16 controls). Returns
    {(name, dtype): max_abs_err} at its first shape."""
    from bsms_gnn_tpu_torch.graph.hierarchy import to_device
    from bsms_gnn_tpu_torch.parallel.partition import shard_hierarchy

    hier = to_device(shard_hierarchy(case["plan"], 0), device)
    require(all(launched.get(k) for k in HALO_KERNELS),
            f"the halo path did not launch every kernel of {HALO_KERNELS}")
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, shapes in halo_kernel_args(hier, case["sim"], dtype,
                                             device).items():
            if name in HALO_BWD:
                continue
            for i, (where, args) in enumerate(shapes):
                sparse = name in TILE_WALKS and i > 0
                err = check_kernel(name, where, args, dtype, sparse)
                errs.setdefault((name, dtype), err)

        # Kernel 1's level form on a batch of BATCH_CHECK frames (the
        # ghost conv of the halo path's batch axis): each sample bit for
        # bit its own call; then timed at HALO_BATCH.
        for where, args in halo_kernel_args(hier, case["sim"], dtype,
                                            device)["windowed_conv"][:2]:
            check_batched("windowed_conv", where, args, dtype, False, 2800)
            time_batched_level_form(where, args, dtype)

    def bwd(dtype):
        args = halo_kernel_args(hier, case["sim"], dtype, device)
        return {k: v for k, v in args.items() if k in HALO_BWD}

    errs.update(check_bwd_kernels(case, device, bwd))
    return errs


def _halo_close(got, want, what, tol=HALO_TOL, label="airfoil halo"):
    """got against want (numpy, the real rows), in HALO_TOL's measures."""
    err = np.abs(got - want)
    bound = tol["atol"] + tol["rtol"] * np.abs(want)
    worst = float((err / bound).max())
    print(f"[{label}] {what}: max abs err {err.max():.3e}, worst "
          f"err / (atol + rtol·|want|) {worst:.3f} (rtol {tol['rtol']:.0e}, "
          f"atol {tol['atol']:.0e})  {'ok' if worst <= 1 else 'FAIL'}")
    require(worst <= 1, f"{label} {what} disagrees with one device")


def _param_close(upd, want, rates, updates=HALO_UPDATES,
                 label="airfoil halo"):
    """The parameters' updates (after − before, numpy) against the
    one-device run's (`tests/test_torch_port_train.py`'s measure: Adam
    moves a weight by about the rate whatever its gradient's scale, so a
    near-zero gradient whose sign the order of f32 sums decides moves it
    by up to twice the rate either way): each tensor's RMS error within
    1e-2 of its update's RMS, at most one weight in a thousand off by more
    than a quarter of the summed rates, none by more than twice them."""
    worst, flips, far = (0.0, ""), [], []
    for k, w in want.items():
        w = w.detach().cpu().numpy().astype(np.float64)
        d = np.abs(upd[k] - w)
        rms = np.sqrt(np.mean(w ** 2))
        if rms == 0:
            require(d.max() == 0, f"{k}: moved, the reference did not")
            continue
        worst = max(worst, (float(np.sqrt(np.mean(d ** 2)) / rms), k))
        flips.append(float((d > 0.25 * rates).mean()))
        far.append(float(d.max()) / rates)
    ok = worst[0] <= 1e-2 and max(flips) <= 1e-3 and max(far) <= 2
    print(f"[{label}] parameters after {updates} updates "
          f"(after − before): worst rms err {worst[0]:.2e} of the update's "
          f"rms ({worst[1]}, tol 1e-2), largest share of weights off by "
          f"> rates/4 {max(flips):.2e} (tol 1e-3), largest err "
          f"{max(far):.2e} of the summed rates {rates:.1e} (tol 2)  "
          f"{'ok' if ok else 'FAIL'}")
    require(ok, f"{label} parameters disagree with one device")


def _train_close(grads, want, what, label="airfoil halo"):
    """Gradient dicts against the one-device step's, in TRAIN_TOL's f32
    measures (each tensor's max and RMS error over its RMS)."""
    _, tol_max, tol_rms = TRAIN_TOL[torch.float32]
    rel, zero = grad_errors({k: torch.from_numpy(v).float()
                             for k, v in grads.items()},
                            {k: v.float().cpu() for k, v in want.items()})
    worst_max, worst_rms = max(rel), max(rel, key=lambda r: r[1])
    ok = worst_max[0] <= tol_max and worst_rms[1] <= tol_rms
    print(f"[{label}] {what}: {len(rel)} tensors, worst max err "
          f"{worst_max[0]:.2e} of rms ({worst_max[2]}, tol {tol_max:.0e}), "
          f"worst rms err {worst_rms[1]:.2e} of rms ({worst_rms[2]}, tol "
          f"{tol_rms:.0e}); {len(zero)} exactly zero on both  "
          f"{'ok' if ok else 'FAIL'}")
    require(ok, f"{label} {what} disagrees with one device")


def run_halo_case(device, e2e):
    """The airfoil_halo phase: HALO_RANKS ranks on this card over gloo
    (`halo_rank`) against the one-device model, then one NCCL rank of a
    group of one. Returns (kernel errors, {}, forward launch counts, train
    launch counts, end-to-end times) as `run_case` does."""
    import socket

    import torch.multiprocessing as mp

    from bsms_gnn_tpu_torch.config import OptConfig
    from bsms_gnn_tpu_torch.models.simulator import Simulator
    from bsms_gnn_tpu_torch.parallel import data_parallel_step, make_groups
    from bsms_gnn_tpu_torch.parallel.multihost import (
        init_distributed,
        shutdown,
    )
    from bsms_gnn_tpu_torch.parallel.partition import unpartition_nodes
    from bsms_gnn_tpu_torch.training.rollout import rollout_trajectory
    from bsms_gnn_tpu_torch.training.trainer import Trainer

    t_phase = time.perf_counter()
    case = build_halo_case(device)
    sim, hd, node_in, mask, n = (case[k] for k in ("sim", "hd", "node_in",
                                                   "mask", "n"))
    plan = case["plan"]
    tar = train_target(case)
    train_cfg = case["config"](accumulation_steps=TRAIN_GATE)
    opt = OptConfig(peak_lr=1e-4, warmup_steps=2, decay_steps=1000)
    g = torch.Generator(device="cpu").manual_seed(2600)
    noise = [torch.randn(tar.shape, generator=g)
             for _ in range(TRAIN_GATE + HALO_UPDATES)]
    dp_in, dp_tar, dp_mask = batch_frames(case, HALO_RANKS * DP_BATCH, 2700)
    dp_noise = torch.randn(dp_tar.shape, generator=g)
    dp_cfg = case["config"](accumulation_steps=0)

    def host(t):
        return t.detach().cpu().numpy()

    payload = dict(
        plan=plan, cfg=case["cfg"], train_cfg=train_cfg, dp_cfg=dp_cfg,
        opt=opt, params={k: v.cpu() for k, v in sim.state_dict().items()},
        norms=[dataclasses.replace(st, **{f: getattr(st, f).cpu() for f in (
            "acc_weight", "num_accumulations", "e_x", "e_x2")})
            for st in (sim.norm_in, sim.norm_out)],
        node_in=host(node_in), mask=host(mask), tar=host(tar),
        noise=[z.numpy() for z in noise], h=case["h"],
        dp=[host(dp_in), host(dp_tar), host(dp_mask), dp_noise.numpy()],
        batch=[host(t[:HALO_BATCH]) for t in (dp_in, dp_tar, dp_mask,
                                              dp_noise)])
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=halo_rank, args=(r, port, payload, queue))
             for r in range(HALO_RANKS)]
    for pr in procs:
        pr.start()

    # The one-device references while the ranks start.
    with torch.no_grad():
        pred_ref = sim(hd, node_in, mask)
        roll_ref = rollout_trajectory(sim, hd, node_in, mask, HALO_ROLLOUT)
    ref = Trainer(train_cfg, opt, generator=torch.Generator().manual_seed(1),
                  device=device)
    before = {k: v.detach().clone() for k, v in ref.sim.state_dict().items()}
    ref_losses = [float(ref.iter(hd, node_in, tar, mask, z.to(device)))
                  for z in noise]
    after = ref.sim.state_dict()
    ref_updates = {k: (after[k] - before[k]).float() for k in after}
    dp_ref = Trainer(dp_cfg, opt, generator=torch.Generator().manual_seed(2),
                     device=device)
    dp_ref.sim.load_state_dict(sim.state_dict())
    dp_ref.sim.norm_in, dp_ref.sim.norm_out = sim.norm_in, sim.norm_out
    dp_args = (dp_in, dp_tar, dp_mask, dp_noise.to(device))
    # The batch axis's references: the one-device forward and step on the
    # first HALO_BATCH frames, from the given weights.
    b_args = tuple(t[:HALO_BATCH].to(device) for t in dp_args)
    with torch.no_grad():
        b_pred_ref = sim(hd, b_args[0], b_args[2])
    b_ref = Trainer(dp_cfg, opt, generator=torch.Generator().manual_seed(2),
                    device=device)
    b_ref.sim.load_state_dict(sim.state_dict())
    b_ref.sim.norm_in, b_ref.sim.norm_out = sim.norm_in, sim.norm_out
    b_loss_ref = float(b_ref.iter(hd, *b_args))
    b_grads_ref = {k: q.grad.detach().clone()
                   for k, q in b_ref.sim.named_parameters()}
    del b_ref
    dp_loss_ref = float(dp_ref.iter(hd, *dp_args))
    dp_grads_ref = {k: q.grad.detach().clone()
                    for k, q in dp_ref.sim.named_parameters()}

    results = {}
    try:
        while len(results) < HALO_RANKS:
            r, res = queue.get(timeout=HALO_TIMEOUT_S)
            require("error" not in res, f"halo rank {r} failed:\n"
                                        f"{res.get('error')}")
            results[r] = res
    finally:
        for pr in procs:
            pr.join(timeout=60)
            if pr.is_alive():
                pr.terminate()
                pr.join()
    require(all(pr.exitcode == 0 for pr in procs),
            f"halo ranks exited with {[pr.exitcode for pr in procs]}")
    ranks_s = time.perf_counter() - t0
    r0, r1 = results[0], results[1]
    print(f"[airfoil halo] {HALO_RANKS} ranks on one card over gloo: "
          f"started in {[round(r['start_s'], 2) for r in (r0, r1)]} s, "
          f"local hierarchies in "
          f"{[round(r['hierarchy_s'], 2) for r in (r0, r1)]} s, "
          f"{ranks_s:.1f} s in all (spawn included)")

    # Serving.
    def whole(key):
        return unpartition_nodes(plan, np.stack([r0[key], r1[key]]))

    _halo_close(whole("pred")[:n], host(pred_ref)[:n],
                "f32 forward against the one-device forward")
    _halo_close(whole("rollout")[:, :n],
                host(roll_ref)[:, :n],
                f"{HALO_ROLLOUT}-step rollout against the one-device rollout")

    # Training.
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"],
                                                      ref_losses))
    print(f"[airfoil halo] train losses {r0['losses']} (one device "
          f"{ref_losses}), worst rel err {loss_err:.2e} (tol "
          f"{TRAIN_TOL[torch.float32][0]:.0e})")
    require(r0["losses"] == r1["losses"], "the ranks report other losses")
    require(loss_err <= TRAIN_TOL[torch.float32][0],
            "airfoil halo train loss disagrees with one device")
    # Each update's summed, clipped gradients in TRAIN_TOL's measures
    # against a one-device `Trainer` loaded with rank 0's state before that
    # update (its parameters, normalizers and AdamW moments) and fed the
    # same draw: the updates move the two runs' weights apart by a share of
    # the rate, so each update is held at the weights it was taken at.
    anchor = Trainer(train_cfg, opt, generator=torch.Generator().manual_seed(1),
                     device=device)
    for i, (gh, st) in enumerate(zip(r0["grads"], r0["states"])):
        anchor.load_state_dict(_torch_tree(st))
        anchor.iter(hd, node_in, tar, mask, noise[TRAIN_GATE + i].to(device))
        _train_close(gh, {k: q.grad for k, q in
                          anchor.sim.named_parameters()},
                     f"update {i}: the summed, clipped gradients (one "
                     f"device at rank 0's state before it)")
    _param_close(r0["updates"], ref_updates,
                 sum(ref.schedule(k) for k in range(HALO_UPDATES)))
    require(r0["digest"] == r1["digest"],
            "the ranks' parameters differ after the train steps")

    # Launch counts: the same on both ranks, kernels 1-7 launched.
    for key in ("forward_counts", "train_counts"):
        require(r0[key] == r1[key], f"the ranks' {key} differ")
    fwd = {k: v for k, v in r0["forward_counts"].items() if v}
    train = {k: v for k, v in r0["train_counts"].items() if v}
    print(f"[airfoil halo] launches per rank in one forward: {fwd}; in one "
          f"train step: {train}; CUDA kernels of the port per step: "
          f"{port_kernels(train)}; collectives per train step "
          f"{ {k: r0['train_collectives'][k] for k in ('exchanges', 'reductions')} }")
    missing = [k for k in HALO_KERNELS if not train.get(k)]
    require(not missing, f"the halo train step launched no {missing}")

    # Times: 2 ranks sharing one card, not a multi-card figure.
    card = card_line()
    for r, res in sorted(results.items()):
        st = res["timed_stats"]
        print(f"[airfoil halo] rank {r} (2 ranks sharing one H100 over gloo, "
              f"{card}): train step wall "
              f"{1e3 * np.median(res['step_s']):.2f} ms (median of "
              f"{[round(1e3 * x, 2) for x in res['step_s']]}), forward "
              f"{1e3 * np.median(res['forward_s']):.2f} ms (median of "
              f"{HALO_TIMED}); in a step with a synchronize around each "
              f"collective, its {st['exchanges']} exchanges and "
              f"{st['reductions']} reductions took "
              f"{1e3 * st['seconds']:.2f} ms")

    # The batch axis: HALO_BATCH frames on each rank's shard.
    b_pred = unpartition_nodes(plan, np.stack([r0["batch_pred"],
                                               r1["batch_pred"]]))
    _halo_close(b_pred[:, :n], host(b_pred_ref)[:, :n],
                f"f32 forward at B={HALO_BATCH} against the one-device "
                f"forward")
    b_err = abs(r0["batch_loss"] - b_loss_ref) / abs(b_loss_ref)
    print(f"[airfoil halo] train step at B={HALO_BATCH}: loss "
          f"{r0['batch_loss']:.6e} (one device {b_loss_ref:.6e}, rel err "
          f"{b_err:.2e}, tol {TRAIN_TOL[torch.float32][0]:.0e}); launches "
          f"per rank in the forward "
          f"{ {k: v for k, v in r0['batch_forward_counts'].items() if v} }, "
          f"in the step "
          f"{ {k: v for k, v in r0['batch_train_counts'].items() if v} }")
    require(r0["batch_loss"] == r1["batch_loss"],
            "the ranks report other batched losses")
    require(b_err <= TRAIN_TOL[torch.float32][0],
            f"airfoil halo train loss at B={HALO_BATCH} disagrees with one "
            f"device")
    _train_close(r0["batch_grads"], b_grads_ref,
                 f"the summed, clipped gradients at B={HALO_BATCH}")
    require(r0["batch_digest"] == r1["batch_digest"],
            f"the ranks' parameters differ after the B={HALO_BATCH} step")
    require(r0["batch_train_counts"].get("windowed_conv", 0) > 0,
            f"the B={HALO_BATCH} halo step launched no kernel 1 level form")
    for r, res in sorted(results.items()):
        print(f"[airfoil halo] rank {r} at B={HALO_BATCH} (2 ranks sharing "
              f"one H100 over gloo, {card}): forward "
              f"{1e3 * res['batch_forward_s']:.2f} ms, train step "
              f"{1e3 * res['batch_step_s']:.2f} ms (one call each, the "
              f"first at B={HALO_BATCH})")

    # Every launched kernel on shard 0's extended tables.
    errs = check_halo_kernels(case, device, train)

    # The data-parallel step: 2 ranks × DP_BATCH against one process.
    dp_err = abs(r0["dp_loss"] - dp_loss_ref) / abs(dp_loss_ref)
    print(f"[airfoil halo] data-parallel step, {HALO_RANKS} ranks x "
          f"{DP_BATCH} frames: loss {r0['dp_loss']:.6e} (one process, "
          f"{HALO_RANKS * DP_BATCH} frames: {dp_loss_ref:.6e}, rel err "
          f"{dp_err:.2e}); step wall "
          f"{[round(1e3 * r['dp_step_s'], 2) for r in (r0, r1)]} ms "
          f"(2 ranks sharing one H100 over gloo, {card})")
    require(dp_err <= TRAIN_TOL[torch.float32][0],
            "the data-parallel loss disagrees with one process")
    require(r0["dp_digest"] == r1["dp_digest"],
            "the data-parallel ranks' parameters differ")
    _train_close(r0["dp_grads"], dp_grads_ref,
                 "data-parallel summed, clipped gradients")

    # One NCCL rank, a group of one: the one-process step bit for bit.
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    init_distributed("nccl", 0, 1, init_method=f"tcp://localhost:{port}",
                     device=device)
    try:
        make_groups(1, 1)
        one = Trainer(dp_cfg, opt, generator=torch.Generator().manual_seed(2),
                      device=device)
        one.sim.load_state_dict(sim.state_dict())
        one.sim.norm_in, one.sim.norm_out = sim.norm_in, sim.norm_out
        loss = float(data_parallel_step(one, hd, *dp_args, device=device))
    finally:
        shutdown()
    same = (loss == dp_loss_ref
            and _digest(one.sim.state_dict()) == _digest(
                dp_ref.sim.state_dict()))
    print(f"[airfoil halo] one NCCL rank, world size 1: the data-parallel "
          f"step's loss and parameters "
          f"{'bit for bit' if same else 'DIFFER from'} the one-process "
          f"step's")
    require(same, "the NCCL rank of one differs from the one-process step")
    phase_s = time.perf_counter() - t_phase
    print(f"[airfoil halo] phase took {phase_s:.1f} s")
    times = {f"{k}_rank{r}": 1e3 * v for r, res in sorted(results.items())
             for k, v in (("step_ms", float(np.median(res["step_s"]))),
                          ("forward_ms", float(np.median(res["forward_s"]))),
                          ("exchange_ms", res["timed_stats"]["seconds"]),
                          ("dp_step_ms", res["dp_step_s"]),
                          ("b4_forward_ms", res["batch_forward_s"]),
                          ("b4_step_ms", res["batch_step_s"]))}
    times["phase_s"] = phase_s
    del case
    torch.cuda.empty_cache()
    return errs, {}, r0["forward_counts"], r0["train_counts"], times


# -- airfoil_eshard: the edge-sharded step ------------------------------------

# Two ranks, each every node row and its range of every level's and
# operator's edge slots of the 5k airfoil of phase 2 (JAX's GSPMD edge
# sharding, written out: `parallel/edge_shard.py`).
ESHARD_RANKS, ESHARD_UPDATES = 2, 2
# The gate's steps of the phase's trainer (one, then the updates).
ESHARD_GATE = 1
ESHARD_KERNELS = ("fused_edge_phase_win", "fused_edge_phase_win_bwd",
                  "fused_node_phase", "fused_node_phase_bwd",
                  "windowed_rect_conv", "compact_accum", "windowed_send_sum")
ESHARD_BWD = ("fused_edge_phase_win_bwd", "fused_node_phase_bwd",
              "windowed_send_sum")
ESHARD_LEVELS = (0, 3)


def eshard_rank(rank, port, payload, queue):
    """One rank of the eshard phase (a process of its own, on cuda:0 over
    gloo), as `halo_rank`."""
    import traceback

    try:
        queue.put((rank, _eshard_rank(rank, port, payload)))
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))
        raise


def _eshard_rank(rank, port, p):
    import datetime

    from bsms_gnn_tpu_torch.models.simulator import Simulator
    from bsms_gnn_tpu_torch.ops.kernels import build
    from bsms_gnn_tpu_torch.parallel import halo
    from bsms_gnn_tpu_torch.parallel.edge_shard import (
        edge_shard_forward,
        edge_shard_hierarchy,
        edge_shard_train_step,
    )
    from bsms_gnn_tpu_torch.parallel.mesh import make_groups
    from bsms_gnn_tpu_torch.parallel.multihost import (
        init_distributed,
        shutdown,
    )
    from bsms_gnn_tpu_torch.training.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stale = [n for n in build.SOURCES if build._stale(n)]
    require(not stale, f"rank {rank}: kernels {stale} would be compiled "
                       f"here (the parent builds them)")
    t0 = time.perf_counter()
    device = init_distributed(
        "gloo", rank, ESHARD_RANKS, init_method=f"tcp://localhost:{port}",
        device="cuda:0", timeout=datetime.timedelta(seconds=120))
    make_groups(1, ESHARD_RANKS)
    names = list(kernel_modules())
    out = {"start_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    hier = edge_shard_hierarchy(p["h"], "graph", device)
    out["hierarchy_s"] = time.perf_counter() - t0
    out["slots"] = [lv.n_pad_edges for lv in hier.levels]

    def dev(a):
        return torch.from_numpy(a).to(device)

    ni, nm, nt = dev(p["node_in"]), dev(p["mask"]), dev(p["tar"])
    sim = Simulator(p["cfg"], device=device)
    sim.load_state_dict(p["params"])
    sim.norm_in, sim.norm_out = (
        dataclasses.replace(st, **{f: getattr(st, f).to(device) for f in (
            "acc_weight", "num_accumulations", "e_x", "e_x2")})
        for st in p["norms"])

    # Serving: one forward, its launches and collectives counted.
    reset_counts()
    halo.reset_stats()
    pred = edge_shard_forward(sim, hier, ni, nm, device=device)
    torch.cuda.synchronize()
    out.update(forward_counts=read_counts(names), pred=pred.cpu().numpy(),
               forward_collectives=halo.STATS["reductions"])

    # Training: the gate, then ESHARD_UPDATES updates on the shared draw;
    # the first update's launches and collectives counted; rank 0 keeps
    # its state before each update and the gradients the update applied.
    tr = Trainer(p["train_cfg"], p["opt"],
                 generator=torch.Generator().manual_seed(1), device=device)
    before = {k: v.detach().clone() for k, v in tr.sim.state_dict().items()}
    losses, grads, states = [], [], []
    for i, z in enumerate(p["noise"]):
        first = i == ESHARD_GATE
        if i >= ESHARD_GATE and rank == 0:
            st = tr.state_dict()
            del st["noise_generator"]
            states.append(_host_tree(st))
        if first:
            reset_counts()
            halo.reset_stats()
        losses.append(float(edge_shard_train_step(tr, hier, ni, nt, nm,
                                                  dev(z), device=device)))
        if first:
            torch.cuda.synchronize()
            out["train_counts"] = read_counts(names)
            out["train_collectives"] = halo.STATS["reductions"]
        if i >= ESHARD_GATE and rank == 0:
            grads.append({k: q.grad.detach().cpu().numpy()
                          for k, q in tr.sim.named_parameters()})
    after = tr.sim.state_dict()
    out.update(losses=losses, digest=_digest(after),
               pred_digest=_digest({"pred": pred}))
    if rank == 0:
        out.update(grads=grads, states=states, updates={
            k: (after[k] - before[k]).cpu().numpy() for k in after})
    # Times after the checked steps: TIMED_REPEATS train steps and
    # forwards, then one step with a synchronize around each collective.
    walls, fwd = [], []
    for _ in range(TIMED_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        edge_shard_train_step(tr, hier, ni, nt, nm, dev(p["noise"][-1]),
                              device=device)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        edge_shard_forward(sim, hier, ni, nm, device=device)
        torch.cuda.synchronize()
        fwd.append(time.perf_counter() - t0)
    halo.reset_stats(timed=True)
    edge_shard_train_step(tr, hier, ni, nt, nm, dev(p["noise"][-1]),
                          device=device)
    out.update(step_s=walls, forward_s=fwd, timed_stats=dict(halo.STATS))
    halo.reset_stats()
    shutdown()
    return out


def eshard_kernel_args(hier, sim, dtype, device):
    """Each kernel of the eshard path's arguments on one rank's tables:
    its ranges of levels ESHARD_LEVELS and of their transitions' down
    operators (kernel 1's rect form; kernel 2 on the level's part of the
    compact residual, else the operator's), from a seed. {name: [(where,
    args)]}."""
    g = torch.Generator(device="cpu").manual_seed(2900)
    c = 128
    cd = dtype if dtype == torch.bfloat16 else None

    def rand(*shape, dt=torch.float32, s=1.0):
        return (s * torch.randn(*shape, generator=g)).to(dt).to(device)

    args = {k: [] for k in ESHARD_KERNELS}
    for l in ESHARD_LEVELS:
        lvl, op = hier.levels[l], hier.transitions[l].down_op
        n, e = lvl.n_pad_nodes, lvl.n_pad_edges
        gmp = sim.process.down_gmps[l]
        wf8 = first_layer(gmp)[0]
        tail = (list(gmp.mlp_edge.weights)[1:], list(gmp.mlp_edge.biases)[1:])
        w = f"L{l} range"
        xwi, xj = rand(n, c, dt=dtype), rand(n, c, dt=dtype)
        args["fused_edge_phase_win"].append((w, (lvl, xwi, xj, wf8, *tail)))
        args["fused_edge_phase_win_bwd"].append(
            (w, (lvl, xwi, xj, wf8, *tail, rand(n, c))))
        args["fused_node_phase"].append((f"L{l}", (
            rand(n, c, dt=dtype), rand(n, c, s=3.0), gmp.mlp_node, cd)))
        args["fused_node_phase_bwd"].append((f"L{l}", (
            rand(n, c, dt=dtype), rand(n, c, s=3.0), gmp.mlp_node,
            rand(n, c), cd)))
        args["windowed_rect_conv"].append(
            (f"T{l} down range", (op, rand(op.n_in_pad, c, dt=dtype))))
        cr, where = ((lvl.cresid, w) if lvl.cresid is not None
                     else (op.cresid, f"T{l} down range"))
        if cr is not None:
            args["compact_accum"].append((where, (
                cr, rand(cr.n_rows, c, dt=dtype), rand(cr.n_pad_nodes, c))))
        args["windowed_send_sum"].append((w, (lvl, rand(e, c, dt=dtype))))
    return args


def check_eshard_kernels(case, hier, device, launched):
    """Every kernel the eshard path launched against its plain version on
    rank 0's tables, f32 and bf16 (with bf16 controls). Returns {(name,
    dtype): max_abs_err} at its first shape."""
    require(all(launched.get(k) for k in ESHARD_KERNELS),
            f"the eshard path did not launch every kernel of "
            f"{ESHARD_KERNELS}")
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, shapes in eshard_kernel_args(hier, case["sim"], dtype,
                                               device).items():
            if name in ESHARD_BWD:
                continue
            for i, (where, args) in enumerate(shapes):
                sparse = name in TILE_WALKS and i > 0
                err = check_kernel(name, where, args, dtype, sparse)
                errs.setdefault((name, dtype), err)

    def bwd(dtype):
        args = eshard_kernel_args(hier, case["sim"], dtype, device)
        return {k: v for k, v in args.items() if k in ESHARD_BWD}

    errs.update(check_bwd_kernels(case, device, bwd))
    return errs


def run_eshard_case(device, e2e):
    """The airfoil_eshard phase: ESHARD_RANKS ranks on this card over gloo
    (`eshard_rank`) against the one-device model, then one NCCL rank in a
    group of one. Returns (kernel errors, {}, forward launch counts, train
    launch counts, end-to-end times) as `run_case` does."""
    import socket

    import torch.multiprocessing as mp

    from bsms_gnn_tpu_torch.config import OptConfig
    from bsms_gnn_tpu_torch.graph.hierarchy import to_device
    from bsms_gnn_tpu_torch.parallel import make_groups
    from bsms_gnn_tpu_torch.parallel.edge_shard import (
        PIECE,
        edge_partition,
        edge_shard,
        edge_shard_hierarchy,
        edge_shard_train_step,
        live_slots,
    )
    from bsms_gnn_tpu_torch.parallel.multihost import (
        init_distributed,
        shutdown,
    )
    from bsms_gnn_tpu_torch.ops.kernels.fused_gmp import TILE_ROWS
    from bsms_gnn_tpu_torch.training.trainer import Trainer

    t_phase = time.perf_counter()
    label = "airfoil eshard"
    case = build_case(device)
    h, sim, hd = case["h"], case["sim"], case["hd"]
    node_in, mask, n = case["node_in"], case["mask"], case["n"]
    t0 = time.perf_counter()
    plan = edge_partition(h, ESHARD_RANKS)
    parts = [edge_shard(h, plan, r) for r in range(ESHARD_RANKS)]
    plan_s = time.perf_counter() - t0
    print(f"[{label}] {ESHARD_RANKS}-rank edge plan and shards built in "
          f"{plan_s:.2f} s (host): level, slots by rank [range], live "
          f"slots by rank, tiles of kernels 4 and 5 by rank and their sum, "
          f"one device's tiles, compact rows by rank (one device's)")
    tiles = []
    for l, lv in enumerate(h.levels):
        live = live_slots(lv)
        rt = [p.levels[l].n_pad_edges // TILE_ROWS for p in parts]
        one = lv.n_pad_edges // TILE_ROWS
        tiles.append((rt, one))
        cr = [0 if p.levels[l].cresid is None else p.levels[l].cresid.n_real
              for p in parts]
        print(f"  {l:2d} {[b - a for a, b in plan.levels[l]]} "
              f"{list(plan.levels[l])} "
              f"{[int(live[a:b].sum()) for a, b in plan.levels[l]]} tiles "
              f"{rt} = {sum(rt)} (one device {one}) compact {cr} "
              f"({0 if lv.cresid is None else lv.cresid.n_real})")
        require(sum(rt) == one, f"level {l}: the ranks walk {sum(rt)} tiles, "
                                f"one device {one}")
    for l, t in enumerate(h.transitions):
        for kind in ("down", "up"):
            op = getattr(t, f"{kind}_op")
            rows = [getattr(p.transitions[l], f"{kind}_op").cresid
                    for p in parts]
            print(f"  T{l} {kind}: slots "
                  f"{[b - a for a, b in getattr(plan, kind)[l]]} of "
                  f"{op.n_pad_edges}, compact rows "
                  f"{[0 if c is None else c.n_real for c in rows]} of "
                  f"{0 if op.cresid is None else op.cresid.n_real}")
    tar = train_target(case)
    train_cfg = case["config"](accumulation_steps=ESHARD_GATE)
    opt = OptConfig(peak_lr=1e-4, warmup_steps=2, decay_steps=1000)
    g = torch.Generator(device="cpu").manual_seed(3000)
    noise = [torch.randn(tar.shape, generator=g)
             for _ in range(ESHARD_GATE + ESHARD_UPDATES)]

    def host(t):
        return t.detach().cpu().numpy()

    payload = dict(
        h=h, cfg=case["cfg"], train_cfg=train_cfg, opt=opt,
        params={k: v.cpu() for k, v in sim.state_dict().items()},
        norms=[dataclasses.replace(st, **{f: getattr(st, f).cpu() for f in (
            "acc_weight", "num_accumulations", "e_x", "e_x2")})
            for st in (sim.norm_in, sim.norm_out)],
        node_in=host(node_in), mask=host(mask), tar=host(tar),
        noise=[z.numpy() for z in noise])
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=eshard_rank, args=(r, port, payload, queue))
             for r in range(ESHARD_RANKS)]
    for pr in procs:
        pr.start()

    # The one-device references while the ranks start.
    with torch.no_grad():
        pred_ref = sim(hd, node_in, mask)
    ref = Trainer(train_cfg, opt, generator=torch.Generator().manual_seed(1),
                  device=device)
    before = {k: v.detach().clone() for k, v in ref.sim.state_dict().items()}
    ref_losses = [float(ref.iter(hd, node_in, tar, mask, z.to(device)))
                  for z in noise]
    after = ref.sim.state_dict()
    ref_updates = {k: (after[k] - before[k]).float() for k in after}

    results = {}
    try:
        while len(results) < ESHARD_RANKS:
            r, res = queue.get(timeout=HALO_TIMEOUT_S)
            require("error" not in res, f"eshard rank {r} failed:\n"
                                        f"{res.get('error')}")
            results[r] = res
    finally:
        for pr in procs:
            pr.join(timeout=60)
            if pr.is_alive():
                pr.terminate()
                pr.join()
    require(all(pr.exitcode == 0 for pr in procs),
            f"eshard ranks exited with {[pr.exitcode for pr in procs]}")
    ranks_s = time.perf_counter() - t0
    r0, r1 = results[0], results[1]
    print(f"[{label}] {ESHARD_RANKS} ranks on one card over gloo: started "
          f"in {[round(r['start_s'], 2) for r in (r0, r1)]} s, edge shards "
          f"on the card in {[round(r['hierarchy_s'], 2) for r in (r0, r1)]}"
          f" s, {ranks_s:.1f} s in all (spawn included)")
    require([sum(x) for x in zip(r0["slots"], r1["slots"])]
            == [lv.n_pad_edges for lv in h.levels],
            "the ranks' slots do not add up to the level's")

    # Serving: every rank holds the whole prediction.
    require(r0["pred_digest"] == r1["pred_digest"],
            "the ranks' predictions differ")
    _halo_close(r0["pred"][:n], host(pred_ref)[:n],
                "f32 forward against the one-device forward", label=label)

    # Training.
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"],
                                                      ref_losses))
    print(f"[{label}] train losses {r0['losses']} (one device "
          f"{ref_losses}), worst rel err {loss_err:.2e} (tol "
          f"{TRAIN_TOL[torch.float32][0]:.0e})")
    require(r0["losses"] == r1["losses"], "the ranks report other losses")
    require(loss_err <= TRAIN_TOL[torch.float32][0],
            "airfoil eshard train loss disagrees with one device")
    anchor = Trainer(train_cfg, opt, generator=torch.Generator().manual_seed(1),
                     device=device)
    rates = sum(ref.schedule(k) for k in range(ESHARD_UPDATES))

    def held(grads, states, updates, who):
        """Each update's gradients against the one-device step's at the
        state before it (the anchor), and the updates against the
        one-device trainer's."""
        for i, (gh, st) in enumerate(zip(grads, states)):
            anchor.load_state_dict(_torch_tree(st))
            anchor.iter(hd, node_in, tar, mask,
                        noise[ESHARD_GATE + i].to(device))
            _train_close(gh, {k: q.grad for k, q in
                              anchor.sim.named_parameters()},
                         f"update {i}: {who}'s summed, clipped gradients "
                         f"(one device at its state before it)", label=label)
        _param_close(updates, ref_updates, rates, ESHARD_UPDATES, label)

    held(r0["grads"], r0["states"], r0["updates"], "gloo rank 0")
    require(r0["digest"] == r1["digest"],
            "the ranks' parameters differ after the train steps")

    # Launch counts, each rank's: every kernel of the path on each.
    card = card_line()
    for r, res in sorted(results.items()):
        fwd = {k: v for k, v in res["forward_counts"].items() if v}
        train = {k: v for k, v in res["train_counts"].items() if v}
        print(f"[{label}] rank {r}: launches in one forward {fwd}; in one "
              f"train step {train}; CUDA kernels of the port per step "
              f"{port_kernels(train)}; collectives: forward "
              f"{res['forward_collectives']}, train step "
              f"{res['train_collectives']}")
        missing = [k for k in ESHARD_KERNELS if not train.get(k)]
        require(not missing, f"eshard rank {r}'s train step launched no "
                             f"{missing}")
    for l, (rt, one) in enumerate(tiles):
        print(f"[{label}] level {l}: kernels 4 and 5 walked {rt[0]} tiles "
              f"on rank 0 and {rt[1]} on rank 1 per launch, {sum(rt)} in "
              f"all; one device {one}")

    # Times: 2 ranks sharing one card, not a multi-card figure.
    for r, res in sorted(results.items()):
        st = res["timed_stats"]
        print(f"[{label}] rank {r} (2 ranks sharing one H100 over gloo, "
              f"{card}): train step wall "
              f"{1e3 * np.median(res['step_s']):.2f} ms (median of "
              f"{[round(1e3 * x, 2) for x in res['step_s']]}), forward "
              f"{1e3 * np.median(res['forward_s']):.2f} ms (median of "
              f"{TIMED_REPEATS}); in a step with a synchronize around each "
              f"collective, its {st['reductions']} reductions took "
              f"{1e3 * st['seconds']:.2f} ms")

    # Every launched kernel on rank 0's tables.
    errs = check_eshard_kernels(case, to_device(parts[0], device), device,
                                r0["train_counts"])

    # One NCCL rank, a group of one: its edge shard is every slot.
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    init_distributed("nccl", 0, 1, init_method=f"tcp://localhost:{port}",
                     device=device)
    try:
        make_groups(1, 1)
        one = Trainer(train_cfg, opt,
                      generator=torch.Generator().manual_seed(1),
                      device=device)
        hier1 = edge_shard_hierarchy(h, "graph", device)
        before1 = {k: v.detach().clone()
                   for k, v in one.sim.state_dict().items()}
        losses1, grads1, states1 = [], [], []
        for i, z in enumerate(noise):
            if i >= ESHARD_GATE:
                st = one.state_dict()
                del st["noise_generator"]
                states1.append(_host_tree(st))
            losses1.append(float(edge_shard_train_step(
                one, hier1, node_in, tar, mask, z.to(device),
                device=device)))
            if i >= ESHARD_GATE:
                grads1.append({k: host(q.grad)
                               for k, q in one.sim.named_parameters()})
    finally:
        shutdown()
    after1 = one.sim.state_dict()
    err1 = max(abs(a - b) / abs(b) for a, b in zip(losses1, ref_losses))
    same = losses1 == ref_losses and _digest(after1) == \
        _digest(ref.sim.state_dict())
    print(f"[{label}] one NCCL rank, world size 1: the gate and "
          f"{ESHARD_UPDATES} updates on one rank's edge shard of every "
          f"slot (its layouts cut in {PIECE}-slot chunks, so its sums "
          f"run in another order): losses {losses1}, "
          f"worst rel err {err1:.2e} against the one-device trainer's; "
          f"parameters {'bit for bit' if same else 'not bit for bit'} "
          f"the one-device trainer's")
    require(err1 <= TRAIN_TOL[torch.float32][0],
            "the NCCL rank of one disagrees with the one-device trainer")
    # The first update runs at rate schedule(0) = 0, so every loss above is
    # taken before the weights move: the gradients and the updates are
    # what hold the NCCL step's reductions, clip and update.
    held(grads1, states1, {k: host(after1[k] - before1[k]) for k in after1},
         "the NCCL rank")
    phase_s = time.perf_counter() - t_phase
    print(f"[{label}] phase took {phase_s:.1f} s")
    times = {f"{k}_rank{r}": 1e3 * v for r, res in sorted(results.items())
             for k, v in (("step_ms", float(np.median(res["step_s"]))),
                          ("forward_ms", float(np.median(res["forward_s"]))),
                          ("reduce_ms", res["timed_stats"]["seconds"]))}
    times["phase_s"] = phase_s
    del case
    torch.cuda.empty_cache()
    return errs, {}, r0["forward_counts"], r0["train_counts"], times


def held_line() -> str:
    """What the kernels' weight-stack cache (`build.stacked`) holds on the
    card: it outlives the phase that filled it, so a later peak counts it."""
    from bsms_gnn_tpu_torch.ops.kernels import build

    outs = [v[2] for v in build._stacks.values() if v[2].is_cuda]
    mib = sum(t.numel() * t.element_size() for t in outs) / 2**20
    return f"the weight-stack cache {len(outs)} entries, {mib:.1f} MiB"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def run_case(build, device):
    """Every phase of one case: its kernels against their plain versions,
    serving (forward, launch counts, rollout, times), the backward kernels
    of a fused case against theirs, the train step, the `Trainer` run and
    the train-step times. Returns (kernel errors, kernel time rows, forward
    launch counts, train-step launch counts, end-to-end times)."""
    with torch.no_grad():  # serving, then the backward kernels alone
        case = build(device)
        describe(case)
        errs = check_kernels(case, device)
        if case["cfg"].aggregation == "pallas":
            check_agg_identity(case)
        serve = check_slice(case, device)
        rows, e2e = measure(case)
        if case["cfg"].aggregation != "pallas":
            errs.update(check_bwd_kernels(case, device))
            if "forced_empty" not in case:
                check_deep_tails(case, device)
    if case["cfg"].world_edges and not unwindowed(case):
        check_wide_stream(case)
    case["train"] = case.get("train_frames") or (case["node_in"],
                                                  train_target(case))
    train = check_train(case, device)
    if "twin" in case:
        check_twin(case)
    train_rows, train_e2e = measure_train(case, device)
    rows.update(train_rows)
    e2e.update(train_e2e)
    del case
    torch.cuda.empty_cache()
    return errs, rows, serve, train, e2e


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from bsms_gnn_tpu_torch.ops.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable: {e}", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # (path, the function that builds its case (None: a batched path of
    # BATCH_PATHS, an `ell` path of ELL_PATHS, the CLI phase or phases 25
    # and 26), the prefix of its end-to-end keys)
    paths = (("airfoil", build_case, ""),
             ("surface", build_surface_case, "surface_"),
             ("flag", build_flag_case, "flag_"),
             ("airfoil_plain", functools.partial(build_case, plain=True),
              "airfoil_plain_"),
             ("surface_fused",
              functools.partial(build_surface_case, aggregation="fused"),
              "surface_fused_"),
             ("cylinder", build_cylinder_case, "cylinder_"),
             ("airfoil_fused4",
              functools.partial(build_case, aggregation="fused4"),
              "airfoil_fused4_"),
             ("airfoil_batch", None, "airfoil_b48_"),
             ("flag_batch", None, "flag_b48_"),
             ("fused4_batch", None, "airfoil_fused4_b48_"),
             ("surface_batch", None, "surface_batch_"),
             ("plain_batch", None, "airfoil_plain_b48_"),
             ("surface_fused_batch", None, "surface_fused_b48_"),
             ("cylinder_batch", None, "cylinder_b48_"),
             ("airfoil_ell", None, "airfoil_ell_"),
             ("flag_ell", None, "flag_ell_"),
             ("cylinder_ell", None, "cylinder_ell_"),
             ("inflating_ell", None, "inflating_ell_"),
             ("cli", None, "cli_"),
             ("deforming_plate", None, "plate_"),
             ("airfoil_auto", None, "airfoil_auto_"),
             ("airfoil_halo", None, "airfoil_halo_"),
             ("airfoil_eshard", None, "airfoil_eshard_"),
             ("airfoil_wide", None, "airfoil_wide_"))
    errs, rows, serve, train, e2e = {}, {}, {}, {}, {}
    try:
        print(f"card: {card_line()}")
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"python {sys.version.split()[0]}; TF32 off for matmul "
              f"({torch.backends.cuda.matmul.allow_tf32}) and cuDNN "
              f"({torch.backends.cudnn.allow_tf32})")
        secs = build.build_all()
        print(f"kernels built in {secs:.1f} s (all nvcc in parallel)")
        for name in build.SOURCES:
            for line in build.build_log(name).splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")
        for phase, build_fn, prefix in paths:
            if build_fn is not None:
                got = run_case(build_fn, device)
            elif phase in ELL_PATHS:
                got = run_ell_case(device, phase, e2e)
            elif phase == "cli":
                got = run_cli_case(device, e2e)
            elif phase == "deforming_plate":
                got = run_plate_case(device, e2e)
            elif phase == "airfoil_auto":
                got = run_auto_case(device, e2e)
            elif phase == "airfoil_halo":
                got = run_halo_case(device, e2e)
            elif phase == "airfoil_eshard":
                got = run_eshard_case(device, e2e)
            elif phase == "airfoil_wide":
                got = run_wide_case(device, e2e)
            else:
                got = run_batch_case(device, phase)
            errs[phase], rows[phase], serve[phase], train[phase], t = got
            e2e.update({prefix + k: v for k, v in t.items()})
            print(f"{phase} phases done at "
                  f"{time.perf_counter() - t_start:.1f} s")
        with torch.no_grad():
            v6_errs, v6_rows, v6_launches, v6_e2e = v6_bench(device)
        e2e.update(v6_e2e)
        print(f"v6 phase done at {time.perf_counter() - t_start:.1f} s")
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    # Kernel 15 runs on no model path: its numbers are the v6 phase's.
    errs["v6_bench"], rows["v6_bench"] = v6_errs, v6_rows
    train["v6_bench"] = serve["v6_bench"] = {"subwin_conv": v6_launches}
    kernels = []
    for name, (src, replaces, _) in KERNEL_META.items():
        # A kernel's numbers come from the first path that launches it:
        # launches per train step (per forward beside), its errors and
        # times; the counts of later paths that run it too ride beside.
        runs = [p for p in train if train[p].get(name, 0) > 0]
        if not runs:
            print(f"chip_smoke FAILED: no path launched {name}",
                  file=sys.stderr)
            return 1
        err, row = errs[runs[0]], rows[runs[0]]
        r32, r16 = row[(name, torch.float32)], row[(name, torch.bfloat16)]
        entry = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": train[runs[0]][name],
            "max_abs_err": err[(name, torch.float32)],
            "ms": r32["ms"], "plain_ms": r32["plain_ms"],
            "bound_ms": r32["bound_ms"], "bound_by": r32["bound_by"],
            "library_ms": r32["library_ms"],
            "path": runs[0],
            "bf16": {"max_abs_err": err[(name, torch.bfloat16)],
                     "ms": r16["ms"], "plain_ms": r16["plain_ms"],
                     "bound_ms": r16["bound_ms"],
                     "bound_by": r16["bound_by"]},
        }
        if name in serve[runs[0]]:
            entry["launches_forward"] = serve[runs[0]][name]
        for p in runs[1:]:
            entry[f"launches_{p}"] = train[p][name]
        kernels.append(entry)
    print(json.dumps(e2e))
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
