#!/usr/bin/env python3
"""Drive repro_torch's snapshot read path, its write side and its model
paths once on one CUDA card.

    python3 chip_smoke.py                 # the deployment below, one card

``scripts/chip_multicard.py`` runs its paths that spread over the cards
(5s, 6m and the mesh phase) alone, on every visible card.

Deployment: the paper's own settings, |P|=64 and B=512 (configs/rapidstore,
paper section 6.5), ``high_threshold`` at its default, on a directed
Graph500 R-MAT graph (a=0.57, b=0.19, c=0.19) of scale 22 and edge factor
16: 4,194,304 vertices and about 67M edges, made from ``--seed`` (the
draws on the card, ``rmat_edges_torch``).  Triangle
counting runs on an undirected simple store of scale 18, durability on a
directed tiered store of scale 18.

Phases, each printing one JSON line (a failing phase raises, and the
script exits non-zero without the last line):

0. card      nvidia-smi name and power limit, torch and CUDA versions;
             fails unless the capability is (9, 0)
1. build     nvcc builds every csrc/*.cu for sm_90a
2. kernels   each CUDA kernel against its plain version at the main path's
             shapes, with its time, the plain version's, a library call's
             and the least time the card needs for the same bytes;
             leaf_search searches the candidate tiles in place (index and
             live length), beside torch.searchsorted on a gathered copy and
             the gather's own time; leaf_scan_reduce reads each tile's
             live length, beside the same kernel over the full width B,
             the library call on masked weights and on the live ids alone,
             and three cuts of its work (lengths 0, live ids 0, short and
             long tiles apart);
             leaf_spmm reads each tile's live length,
             on the 16,384-tile prefix and over all tiles (beside the same
             kernel over the full width, and the library call over all
             tiles, with ``gathered_bound_ms``: every live id's H row from
             HBM); intersect_count names the pairs' tiles in place, beside
             the kernel on gathered copies and the gather's own time
3. main      store + pinned view R0, the view-level entry points on R0,
             20 write transactions, spliced view R1, the entry points on
             R1, a warm repeat with zero uploads; checks against point
             reads and the port's own CPU route; edge_search_view on the
             warm R1 step by step
4. isolation the pinned R0 answers bitwise as before the writes
5. readers   two reader threads repeat queries on their own pinned views
             while the main thread commits
5s. shard_plane  on the main store: PageRank (10 iterations), BFS, SSSP,
             WCC and SpMM (d = 128) on a pinned view through the
             single-device route; a 4-shard plane (modulo, directed) over
             the visible cards (all four on one card when there is one):
             its cold sharded COO and tile builds, each shard's live
             edges, tiles, caps, uploads and bytes; the five queries
             through it on the same snapshot (BFS, SSSP, WCC bitwise,
             PageRank within 1e-5 and rtol 1e-3, atol 1e-9 — a plane that
             drops its lightest shard's partials must fail that — SpMM
             1e-4; warm medians of 3 beside the single route's;
             ``leaf_spmm`` once per shard, and each shard's launch at the
             plane's shapes held against the plain version, every tile,
             1e-4); 20
             transactions on shard 1's subgraphs (the other shards upload
             nothing and keep their bundles by identity); a migration of
             the 4 heaviest subgraphs to the least-loaded shard with a
             reader pinned before the flip (its bundles untouched,
             BFS/SSSP/WCC bitwise) and a view after it; the modulo and
             degree-balanced loads; device bytes before the attach, at the
             peak and after the detach, and each card's peak.  With
             several cards, the plane again with its four shards on one
             card, against the single route as above, timed, with its own
             peak.  After phase 6 its store takes a ``symmetric=True``
             plane: pull PageRank against the single route as above
5a. write_side  on the main store: a write pipeline (4 shards, batches up
             to 1024), 4 writer threads each submitting 50 transactions with
             ``apply_async`` while two reader threads repeat edge search and
             scan-reduce on their pinned views; a compactor fold while one
             reader stays pinned (its answers must not change); 20 more
             pipelined writes; the entry points on a fresh view R2 (checks
             and the CPU route as in phase 3, uploads bounded by the
             snapshots without device tiles), then a warm repeat with zero
             uploads; commits/s, group sizes, fold seconds and report, R2's
             cold view with the assembler counters, ``memory_breakdown()``
5g. gnn_train  on the main store (no write pipeline attached): gin-tu at
             its published config trains for 20 steps at ``GNN_SHAPES``'
             minibatch_lg (1,024 seeds, fanouts 15, 10, d_feat 602), as
             ``examples/train_gnn_dynamic.py`` does: a writer thread
             streams edge updates through ``insert_edges``/
             ``delete_edges`` while each step samples from a pinned view
             (20 sampled edges of step 0 checked against ``view.scan``),
             gathers the [4,194,304, 602] f32 features held on the card
             and takes a train step; the loss finite and falling (the
             last 5 steps' mean below the first 5's).  After the loop:
             one step each of gcn-cora, gatedgcn and pna at their
             published configs on step 0's batch; step 0's loss and every
             gradient leaf of all four (gatedgcn cut to 4 layers,
             ``GNN_CHECK_LAYERS``) against the CPU route, which runs
             on a host thread beside the checkpoint of (params, AdamW
             state), restored bitwise, and ``check_invariants`` (float64:
             loss rtol 1e-4, each leaf within ``GNN_F64_GRAD_TOL`` of its
             largest magnitude, reversed edges and the card's f32 outside
             it; gin-tu in f32 too: each leaf within 2e-3, or ten times
             the CPU route's own f32 error where larger, reversed edges
             outside it); the loop's own step-0 loss against the CPU's;
             AdamW on the card against the CPU on the same gradients
             (1e-6); the split of a step (sampling, gather, step),
             steps/s over the timed steps (all but the profiled one),
             commits, one profiled step's device busy time, peak bytes;
             then one more step counted by ``roofline.cost`` (its aten
             ops' FLOPs and bytes): the ``gnn_train_roofline`` line, a
             ``RooflineReport`` with its useful share of
             ``gnn_model_flops``
5b. durability  a directed R-MAT store of scale 18 with the paper's skew
             tiers (64, 512): WAL with fsync and the compactor's checkpoint
             under one temporary directory, 200 pipelined writes, a fold
             with a checkpoint, 20 more writes; then ``RapidStore.recover``
             on the card (R) and on the CPU (C).  R's edge set equals the
             live view's; R's and C's leaf streams are bitwise equal; edge
             search, BFS, SSSP, WCC and triangles on R equal the live
             view's on the card bitwise, SpMM and PageRank within
             tolerance; the other entry points on R on the card equal C's
             CPU route (integers bitwise, scan-reduce and PageRank 1e-5,
             SpMM 1e-4), and R's triangle count equals a host count of the
             same sum by another algorithm (the CPU route's plain
             intersect of every tile pair's [Ba, Bb] ids is too slow at
             this scale)
6. triangles triangle_count_view on the card, cold then warm, ==
             triangle_count_fast on host (in a child process beside phases
             7-13, joined after them); then, uncounted, the warm call's
             split: host enumeration of the tile pairs, index uploads, the
             kernel's summed device time, the rest
6m. multiprocess  on phase 6's store: the shard plane over processes
             (``repro_torch.launch.plane``, one store a rank, each run's
             ranks child processes within ``MP_TIMEOUT``): (a) ``nccl``,
             one rank a visible card; (b) ``gloo``, ``MP_RANKS`` = 4 ranks
             on cards rank % n_cards (sharing ``cuda:0`` with one card);
             each rank builds the seeded store and a
             4-shard plane over the ranks (shard k on rank k % world),
             runs PageRank (pull and push), BFS, SSSP, WCC and SpMM (d =
             128), commits 20 transactions on shard 1 and runs them again,
             migrates subgraphs between the ranks' shards, commits 20 on
             the moved subgraphs and runs them a third time; this process
             runs the same through a one-process plane on the store
             first (shard k on card k % n_cards; with several cards, then
             on a fresh store with every shard on ``cuda:0``, every answer
             bitwise the first's), then the nccl run, then the gloo run,
             one after another; all in deterministic mode: every rank's
             BFS, SSSP,
             WCC, SpMM and pull PageRank bitwise this process's, push
             PageRank within 1e-5 and rtol 1e-3, atol 1e-9, its placement
             after the moves this process's; each rank's backend, world,
             seconds of each step and ``leaf_spmm`` launches (above 0)
6b. baselines  the paper's comparison stores (``core/baselines``: CSR,
             the per-edge versioned store, VEC; host numpy) built from the
             view's edges after 6m: 8,192 searches (half present) and
             1,024 scans on each equal to the device ``edge_search_view``
             and the view's CSR; 20 transactions on the store and the
             per-edge store, a view pinned after each commit: its device
             searches and its scans equal the per-edge store's at the
             matching timestamp; host build seconds and ``memory_bytes``
             beside the view's device bytes
7. model kernels  flash_decode and embedding_bag against their plain
             versions at the model paths' shapes, timed as in phase 2;
             flash_decode's tensor-core route at the decode_32k path, at
             seeded lengths, with softcap 50 and at dh 144 (Gemma-2-27B's
             grouping), and the CUDA-core route (f32 K/V) at seeded
             lengths; phase 13's heads over 32,768 rows: the CUDA-core
             route at Gemma-2-27B's f32 heads (G 2, dh 144, with and
             without softcap 50) and Qwen3-32B's (G 8, dh 80) at seeded
             lengths, the tensor-core route at their bf16 decode paths
8. lm_serve  Qwen2.5-14B at full width: (a) ``repro_torch.launch.serve``'s
             ``main`` with its defaults (f32, batch 4, prompt 32 fed token
             by token, 32 decode tokens, max_seq 128), then one step of the
             kernel route against a plain route at rtol=atol=3e-4;
             (b) decode_32k in bf16: a cache of 32,768 positions filled to
             position 32,759 from the seed, then one checked step: each of
             its 48 flash_decode launches against the plain version on the
             same inputs at rtol=2e-4, atol=2e-5, and its logits against
             the plain route's within 10% of their largest magnitude (48
             bf16 layers amplify single rounding flips); two controls of
             that limit on the same step: one bf16 ulp on one element of
             layer 0's attention output must stay inside it, heads grouped
             h % KV (a planted fault) must fall outside; then 8 greedy
             tokens, timed, with 48 flash_decode launches per step, and one
             more under the profiler for the device's idle share
8c.          granite-moe-3b-a800m at full width: the serve launcher's
             defaults (f32, batch 4, prompt 32, 32 decode tokens, 32
             flash_decode launches a step), one more step with each launch
             held against the plain version and the logits against the
             plain route's (3e-4), then ``make_prefill_step`` on the prompt
             against decode's logits after its last token (3e-4)
9. recsys_serve  BST at its published config, the 4,194,304 x 32 item
             table on the card: forward at serve_p99 (512) and serve_bulk
             (262,144), user_tower + retrieval_scores at retrieval_cand
             (1,000,000 candidates), each against the plain route
10. lm_prefill  prefill_32k on granite in bf16 (32,768 tokens, batch 1,
             attn_chunk 1,024): seconds, tokens/s, peak bytes; logits
             finite, the last position's within 0.1 of their largest
             magnitude of ``forward``'s with attn_chunk 2,048
11. lm_train granite at full width, f32 weights and compute: 10 steps of
             ``make_lm_train_step`` (warmup 10, total 20) on train_4k
             (batch 2, ``SyntheticTokens``), the last under the profiler
             (device activity only); step 0's loss within 0.5 of ln V, step
             9's below it, grad norms and every leaf finite; median step
             seconds, tokens/s, model FLOPs (``train_flops``) over 67
             TFLOP/s, busy and idle share, peak bytes.  Then the model cut
             to 2 layers, step 0 on 1,024 tokens, card against CPU in
             float64 (the CPU route on a host thread beside the steps):
             loss within ``LM_F64_LOSS_RTOL``, every leaf within
             ``LM_F64_GRAD_TOL`` of its largest magnitude, the card's f32
             outside.  Then ``launch/train.py --smoke`` for 6 steps with a
             checkpoint every 3 and ``--resume`` to 8: the checkpoint
             bitwise, the resumed run at step 6, its first loss the loss of
             the saved parameters (1e-6).  One more train_4k step counted by
             ``roofline.cost``: the ``lm_train_roofline`` line, its useful
             share of ``lm_model_flops``
12. recsys_train  BST at train_batch (65,536 rows, ``RecsysBatches``), 10
             steps of ``make_bst_train_step``, one embedding_bag launch a
             step; step 0's gradients on 512 rows, card against CPU in
             float64 (the item table f32, the kernel's type: its leaf
             within ``BST_TABLE_GRAD_TOL``, the rest within
             ``BST_F64_GRAD_TOL``, the card's f32 outside); the backward's
             ``index_add_`` into the [4,194,304, 32] gradient timed alone
12m. mesh_models  the model side of the device mesh, ``MESH_SHARDS`` = 4
             shards on card k % n_cards (all four on one card), each
             part counted on its own: (a) ``mesh_bst``: BST's
             4,194,304 x 32 table placed by rows on a (model=4) mesh,
             serve_p99 and serve_bulk through ``make_sharded_lookup``
             (rows bitwise the single lookup's, logits within 1e-5, one
             embedding_bag launch a shard, only the ids copied between
             cards), one train_batch step through
             it against the single-device step (f32 rounding), one
             shard's embedding_bag launch at serve_bulk's per-shard shape
             timed with its bound; (b) ``mesh_granite``: granite at full
             width on (data=2, model=2), decode through the SP attention
             and the weight-stationary MoE, experts and cache placed a
             block a shard: f32 parity on a 4,096 cache
             over 4 steps (``MESH_LOGITS_TOL``), one f32 forward of 2,048
             tokens through ``make_sharded_moe_ffn`` against the
             per-data-shard dispatch on one device, then decode_32k's
             shape in bf16 timed on both routes (tokens/s); (c)
             ``mesh_gnn``, right after 5g on the main store: gin-tu
             minibatch_lg steps through ``make_shardmap_gather``/
             ``make_shardmap_scatter`` over 4 shards on
             ``MESH_GNN_BATCHES`` batches, bitwise against a plain
             control that rounds as the shards do, the loss within
             ``MESH_GNN_LOSS_RTOL`` of the single step's with bf16
             gathers (reversed edges must fail); (d) ``mesh_reduce``:
             4 data shards' BST gradients on
             a quarter of train_batch each, int8 ``compress_grads`` and
             ``psum_compressed``, within 2 x scale of the plain mean;
             (e) ``mesh_elastic``: BST placed on (4,) with ``item_emb`` as
             ``P("data", None)``, saved, restored and placed on (2,),
             bitwise.  Parts (a)-(c) each count one more sharded step
             (BST's train_batch step, granite's decode_32k step, gin-tu's
             minibatch_lg step) under a ``roofline.comm.CommCounter``: a
             ``mesh_comm`` line of per-device collective bytes by op, and
             the bytes ``collectives.shard`` copied between cards.  With
             several cards, parts (a)-(c) also time their sharded form
             with every shard on ``cuda:0``
13. lm_wide  after every other phase, with the card holding under 1 GB:
             Gemma-2-27B (46 layers, local window 4,096, softcaps 50/30) and
             Qwen3-32B (64 layers, qk-norm) at full width, weights from the
             seed in bf16 (55.1 and 59.4 GB, made a block of layers at a
             time: the making's peak at most the tree plus one f32 block),
             each freed before the next: (a) Gemma-2 at decode_32k's shape,
             batch 1 (a bf16 cache of 32,768 rows filled to 32,760): one
             step through the serve route with each flash_decode launch
             (the 23 global layers, softcap 50) held against its plain
             version and the logits against the plain route's within 10%
             of their largest magnitude (the 23 local layers take
             ``decode_attention_ref`` on both), then 8 greedy steps timed,
             23 launches a step, and one under the profiler; (b) its
             prefill_32k (batch 1, attn_chunk 1,024): seconds, tokens/s,
             peak, the last position's logits within 0.1 of their largest
             magnitude of the same last-only step's at attn_chunk 2,048;
             (c) Qwen3 as (a) at batch 2, 64 launches a step (dh 80, G 8);
             (d) both through the serve launcher's f32 route (the
             CUDA-core kernel) at its defaults, cut to 24 and 32 layers:
             tokens/s, one launch a layer a step, then the same loop from a
             fresh cache with every launch held against its plain version
5s, 6m and 12m, with several cards: a ``cards`` line after each path:
             its launches, ``max_memory_allocated`` and the bytes
             ``collectives.shard`` copied, per card; a path with a kernel
             fails unless it launched on every card
14. the ``total`` line (the script's seconds), the ``kernels`` line, the
    card's name and power limit, then the ``ok`` line.

The launch counters are set to 0 just before each of phases 3-6, 5s, 5a,
5g, 5b, 6m, 6b, 8-13 and each mesh part, and read just after it (5g, 10, 11 and
the mesh parts b, c and e launch no hand kernel: segment ops, flash
attention, MoE and the collectives are torch ops); every kernel a phase
calls must have launched in it.  The ``kernels`` line's ``launches`` is the count on each
kernel's own path (phase 3 for the graph kernels, 8 for flash_decode, 9 for
embedding_bag), and ``launches_by_path`` holds every phase's.  The
comparisons of phases 2 and 7 do not count.  The scale cuts:
decode_32k's global batch is 4, not 128, so that its cache and weights
fit on one card; the durability store is of scale 18, not 22, because
recovery rebuilds the store with ``from_edges`` (246.7 s at scale 22 on
the host), twice here; its SpMM width is 16 and its intersect pairs
1,024, because its CPU route materializes [tiles, B, d] and
[pairs, Ba, Bb].

The GNN phase's cut: the graph is the scale-22 R-MAT store, not
minibatch_lg's Reddit graph (232,965 x 114.6M); 20 steps, not the
example's 300.  The LM cuts: prefill_32k's batch 32 -> 1 and train_4k's
256 -> 2, to fit one card; phase 13's decode_32k batch 128 -> 1 (Gemma-2)
and 2 (Qwen3), and its f32 route's depth 46 -> 24 and 64 -> 32 layers;
the training launcher runs at ``--smoke`` (a full-width checkpoint of
f32 weights and bf16 moments is 26.4 GB of disk a save).

Peaks and model FLOPs come from ``repro_torch.roofline.model`` (the
H100 SXM data sheet's 3.35 TB/s and 67 TFLOP/s f32).  Phase 6m's cut:
scale 18, not 22, so that five stores (four ranks and the nccl rank)
build and fit beside the script's own; with one card, four ranks share
it.

``bound_ms`` counts the bytes the function needs on this run's data, not
the whole tiles: a tile's live ids are a sorted prefix followed by
SENTINEL padding (checked), so a read of a live prefix, given its
length, moves the 32-byte sectors that hold it and that length, the
binary searches over the tiles' live prefixes read
each distinct 32-byte sector their probes touch once (queries share
tiles), a gather reads each distinct x or H row it touches once, and
the intersections read each distinct tile's live prefix once.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import threading
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent

SCALE = 22  # R-MAT scale of the main store (below 21 the writes cannot splice)
TC_SCALE = 18  # R-MAT scale of the undirected triangle-count store
D_FEATURES = 128  # SpMM width: a common GNN hidden width
N_WRITES, N_INS, N_DELS = 20, 256, 64
PLANE_SHARDS, PLANE_MOVES = 4, 4  # shard plane: 4 shards (on one card there); moves
WS_WRITERS, WS_TXNS, WS_MORE = 4, 50, 20  # write_side: 4 writers x 50 txns, 20 after the fold
DUR_SCALE = 18  # durability: recovery rebuilds with from_edges (246.7 s at 22)
DUR_TIERS = (64, 512)  # the paper's skew tiers (section 6.2)
DUR_WRITES, DUR_MORE = 200, 20  # pipelined writes before and after the checkpoint
DUR_PAIRS = 1024  # intersect pairs: the CPU route holds [pairs, 512, 512] compares
DUR_D = 16  # SpMM width: the CPU route materializes [tiles, B, d]
JOIN_S = 900  # every thread's join limit
N_QUERIES = 4096  # present and as many absent edge-search pairs
N_PAIRS = 8192  # intersect tile pairs (one sum_intersect batch)
SPMM_PLAIN_ROWS = 16384  # tiles per plain-SpMM call: it materializes [N, B, d]
SECTOR = 32  # bytes: a DRAM sector
SHORT_TILE = 32  # live ids: the scan's short tiles (one int4 a lane of its 8)
LM_ARCH = "qwen2.5-14b"
MODEL_SMOKE = False  # True takes the archs' SMOKE configs (CPU rehearsal)
DECODE_SEQ = 32768  # decode_32k's cache length
DECODE_BATCH = 4  # decode_32k's global batch is 128: cut to fit one card
DECODE_STEPS = 8  # greedy tokens after the cache is filled to DECODE_SEQ - 8
SERVE_BATCHES = (512, 262144)  # serve_p99, serve_bulk
N_CANDIDATES = 1_000_000  # retrieval_cand
GRANITE = "granite-moe-3b-a800m"  # the LM whose training fits one card
# phase 13: the two LMs that fit one card only in bf16 (55.1 and 59.4 GB of
# weights); decode_32k's batch 128 cut to what fits beside the weights, the
# serve launcher's f32 route at the depth whose weights fit (about 60 and
# 64 GB; all 46 and 64 layers would take 110 and 119 GB)
WIDE_ARCHS = ("gemma2-27b", "qwen3-32b")
WIDE_DECODE_BATCH = {"gemma2-27b": 1, "qwen3-32b": 2}
WIDE_F32_LAYERS = {"gemma2-27b": 24, "qwen3-32b": 32}
# the f32 route at decode_32k's cache length, batch 1, on the cut model's
# weights: Qwen3-32B's f32 cache is 5.37 GB beside 61.0 GB of weights
# (Gemma-2-27B's, 14.5 GB beside 59.8 GB, would not fit)
WIDE_F32_LONG = {"qwen3-32b": 1}
SERVE_BATCH, SERVE_PROMPT, SERVE_DECODE, SERVE_MAX_SEQ = 4, 32, 32, 128  # launch/serve.py's
PREFILL_SEQ, PREFILL_BATCH = 32768, 1  # LM_SHAPES' prefill_32k; its batch 32 cut to 1
PREFILL_CHUNK, PREFILL_CHECK_CHUNK = 1024, 2048  # attn_chunk; the chunk-invariance check's
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 4096, 2, 10  # LM_SHAPES' train_4k; batch 256 cut to 2
TRAIN_CHECK_LAYERS, TRAIN_CHECK_SEQ = 2, 1024  # card vs CPU in float64: layers, tokens
# float64 gradient leaves of the cut granite, card against CPU, of their
# largest magnitude (every term float64 on both sides); the card's f32
# route is the control that must fall outside
LM_F64_GRAD_TOL, LM_F64_LOSS_RTOL = 1e-9, 1e-12
BST_TRAIN_BATCH, BST_TRAIN_STEPS = 65536, 10  # RECSYS_SHAPES' train_batch
BST_CHECK_BATCH = 512  # rows of step 0's card vs CPU gradients
# BST float64 gradients, card against CPU: the item table stays f32 (the
# kernel's type), so its gradient adds f32 rows (atomics on the card)
BST_F64_GRAD_TOL, BST_TABLE_GRAD_TOL, BST_F64_LOSS_RTOL = 1e-9, 1e-5, 1e-12
GNN_ARCH, GNN_OTHER = "gin-tu", ("gcn-cora", "gatedgcn", "pna")
GNN_SEEDS, GNN_FANOUTS, GNN_D_FEAT = 1024, (15, 10), 602  # GNN_SHAPES' minibatch_lg
GNN_STEPS, GNN_LR = 20, 3e-3  # the example's lr; 20 steps, not its 300
GNN_LOSS_RTOL, GNN_ADAMW_TOL = 1e-4, 1e-6
# layers of a GNN in the card-vs-CPU gradient check where fewer than its
# published config's: gatedgcn's 16 layers cost the CPU route 26-29 s in
# float64, on the phase's critical path, so its check runs 4 (its one train
# step stays at 16); the script must finish in 1,100 s with the LM phases
GNN_CHECK_LAYERS = {"gatedgcn": 4}
# float64 gradient leaves, card against CPU, of their largest magnitude, by
# model kind.  GIN and GatedGCN compute every term in float64 (the H100 and
# its host agree to 2.7e-15 at most).  GCN's rsqrt and PNA's log1p of the
# degrees stay f32, as in the reference, and the card's f32 libm differs
# from the host's by an ulp or two there (3.5e-8 and 1.9e-8 measured); the
# card's f32 gradients sit 5.1e-7 (GCN) and more (the rest) from float64,
# which each run checks these limits reject
GNN_F64_GRAD_TOL = {"gin": 1e-9, "gatedgcn": 1e-9, "gcn": 1.5e-7, "pna": 1.5e-7}
# f32 gradient leaves, of their largest magnitude: layer 0's w0 sums
# 169,984 rows with cancellation, so both routes' f32 sit up to ~5e-4 from
# float64 (``card_f32_vs_f64`` and ``cpu_f32_vs_f64`` in the phase's line)
GNN_F32_GRAD_TOL = 2e-3
# the mesh phase: the model side of the device mesh, MESH_SHARDS shards on
# card k % n_cards (all four on one card with one card)
MESH_SHARDS = 4
MESH_CHECK_CACHE, MESH_CHECK_STEPS = 4096, 4  # granite's f32 parity: cache, steps
MESH_FORWARD_SEQ = 2048  # the sharded-MoE forward's tokens
# f32 logits, sharded against single route (rtol = atol): the launcher
# check's limit; the two sum the same terms in other orders
MESH_LOGITS_TOL = 3e-4
# the GNN step through the bf16-wire gather/scatter (mesh part (c)), on
# MESH_GNN_BATCHES sampled batches in deterministic mode, against a plain
# control that rounds as the sharded route does: each of MESH_SHARDS equal
# edge chunks summed in f32 and rounded to bf16, the chunks' sums added in
# f32 in chunk order and rounded once (the reference's reduce-scatter).
# Same roundings in the same order: loss and every f32 first moment
# bitwise.  Against the single route with bf16 gathers (which rounds each
# message once instead) only the loss is held, within MESH_GNN_LOSS_RTOL:
# its leaves sat 0.03-0.08 of their largest magnitude from the sharded
# route's on six batches on the H100, up to 4.7 times the single route's
# own f32-vs-bf16 gap (PERF.md section 6), so no limit of the form
# "factor x gap" holds them; they are reported.  Reversed edges must put
# some leaf of the sharded step outside MESH_GNN_GRAD_TOL of the control.
MESH_GNN_BATCHES = 4
# phase 6m, the plane over processes: ranks of the gloo run (sharing the
# card), shards, transactions on shard 1, and the time limit of each run
MP_RANKS, MP_SHARDS, MP_TXNS, MP_TIMEOUT = 4, 4, 20, 600
# phase 6b, the comparison stores: present (and as many absent) searches,
# scans, transactions
BASE_QUERIES, BASE_SCANS, BASE_TXNS = 4096, 1024, 20
MESH_GNN_LOSS_RTOL, MESH_GNN_GRAD_TOL = 1e-3, 2.0 ** -6

KERNELS = {
    "leaf_search": ("src/repro_torch/csrc/leaf_search.cu",
                    "src/repro/kernels/leaf_search/kernel.py:40"),
    "leaf_scan_reduce": ("src/repro_torch/csrc/leaf_scan_reduce.cu",
                         "src/repro/kernels/spmm/kernel.py:47"),
    "leaf_spmm": ("src/repro_torch/csrc/leaf_spmm.cu",
                  "src/repro/kernels/spmm/kernel.py:102"),
    "intersect_count": ("src/repro_torch/csrc/intersect_count.cu",
                        "src/repro/kernels/intersect/kernel.py:55"),
    "embedding_bag": ("src/repro_torch/csrc/embedding_bag.cu",
                      "src/repro/kernels/embedding_bag/kernel.py:48"),
    "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode/kernel.py:95"),
}
# the path whose launches the ``kernels`` line reports for each kernel
KERNEL_PATH = {"leaf_search": "main", "leaf_scan_reduce": "main", "leaf_spmm": "main",
               "intersect_count": "main", "embedding_bag": "recsys_serve",
               "flash_decode": "lm_serve"}


START = time.monotonic()


def emit(phase: str, **fields) -> None:
    """One JSON line; ``elapsed_s`` is the script's wall time so far (the
    whole run has a time limit, so each phase's share is on record)."""
    print(json.dumps({"phase": phase, **fields, "elapsed_s": time.monotonic() - START},
                     default=float), flush=True)


def sync(device) -> None:
    """Drain every visible card (not only ``device``): a phase over several
    cards ends when all of them have."""
    if device.type == "cuda":
        from repro_torch.kernels.runtime import drain

        drain()


def wall(fn, device):
    """(result, seconds) of ``fn()`` with the device drained at both ends."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def device_seconds(fn, device):
    """(result, seconds) of ``fn()`` on the device: CUDA events around it
    on the card (the host clock on the CPU), the device drained first."""
    import torch

    sync(device)
    if device.type != "cuda":
        return wall(fn, device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / 1e3


def time_ms(fn, device, reps: int, graph: bool = False) -> float:
    """Mean device time of one ``fn()`` over ``reps`` warm calls (CUDA
    events on the card, the host clock on the CPU).  With ``graph`` the
    ``reps`` calls are captured once in a CUDA graph and the replay is
    timed, so a call that is shorter than its own Python launch path is
    timed on the device, not at the host's launch rate.  The events are
    recorded on ``device``'s stream: pass the card whose work is timed."""
    import torch

    fn()
    sync(device)
    if device.type == "cuda":
        with torch.cuda.device(device):
            return _time_card_ms(fn, device, reps, graph)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def _time_card_ms(fn, device, reps: int, graph: bool) -> float:
    """``time_ms`` on the card, with ``device`` current."""
    import torch

    if graph:
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):  # warm-up before capture, as torch asks
            fn()
        torch.cuda.current_stream(device).wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        sync(device)
        call, per_call, calls = g.replay, reps, 5
    else:
        call, per_call, calls = fn, 1, reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * per_call)


def bound(nbytes: float, ops: float) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the CUDA-core rate (``repro_torch.roofline.model``'s
    H100 peaks)."""
    from repro_torch.roofline.model import bound_s

    t, by = bound_s(nbytes, ops)
    return t * 1e3, by


def hbm_ms(nbytes: float) -> float:
    """Milliseconds the H100's HBM takes to move ``nbytes``."""
    return bound(nbytes, 0)[0]


def f32_peak_share(flops: float, seconds: float) -> float:
    """``flops`` in ``seconds`` as a share of the f32 CUDA-core peak."""
    from repro_torch.roofline.model import CUDA_CORE_F32_FLOPS

    return flops / seconds / CUDA_CORE_F32_FLOPS


def emit_roofline(phase: str, cost, count_s: float, arch: str, shape: str, dtype: str,
                  model_flops: float, **measured) -> None:
    """One line: the roofline of a step counted by ``roofline.cost`` (its
    aten ops' FLOPs and bytes on one card), its useful-FLOP share against
    the model's FLOPs, the hand kernels it launched (whose work the counts
    leave out), and the phase's own measured step times beside it."""
    report = cost.report(arch, shape, dtype, model_flops_total=model_flops)
    emit(phase, **report.to_dict(), aten_ops=cost.ops, kernels_launched=cost.kernel_launches,
         count_s=count_s, **measured)


def emit_comm(model: str, step: str, mesh, fn) -> dict:
    """``fn()`` (one more sharded step) under a ``CommCounter``: one line
    with its collectives' per-device bytes by the ring model, by op."""
    from repro_torch.roofline.comm import CommCounter

    with CommCounter() as counter:
        fn()
    stats = counter.stats()
    emit("mesh_comm", model=model, step=step, mesh=dict(mesh.shape), **stats)
    return stats


def live_lengths(rows):
    """Live ids per tile; raises unless every tile's live ids form a sorted
    prefix followed by SENTINEL padding (what the bounds below assume)."""
    from repro_torch.core.leaf_pool import SENTINEL

    mask = rows != SENTINEL
    if rows.shape[1] > 1 and bool(((rows[:, 1:] < rows[:, :-1]) |
                                   (mask[:, 1:] & ~mask[:, :-1])).any()):
        raise AssertionError("a tile is not a sorted live prefix + SENTINEL padding")
    return mask.sum(dim=1)


def live_bytes(lengths) -> int:
    """Bytes a read of each row's first ``lengths`` ids must move: the
    32-byte sectors that hold them (rows start on a sector boundary, as
    tiles of B = 512 do), none for an empty row."""
    import torch

    sectors = torch.div(lengths.long() * 4 + SECTOR - 1, SECTOR, rounding_mode="floor")
    return int(sectors.sum()) * SECTOR


def search_sectors(width: int) -> int:
    """32-byte sectors one binary search over a sorted row of ``width``
    int32 reads: one per probe until the interval fits in one sector."""
    return 1 + math.ceil(math.log2(max(1, math.ceil(width / (SECTOR // 4)))))


def search_sector_ids(rows, targets, index, length, want_pos):
    """(distinct sector ids, probes): the kernel's binary search replayed
    over each query's live prefix, every probe's 32-byte sector of ``rows``
    kept once; raises unless it lands on ``want_pos``."""
    import torch

    B = rows.shape[1]
    lo = torch.zeros_like(targets)
    hi = length[index].clamp(0, B)
    base = index * B
    ids, probes = [], 0
    while True:
        active = lo < hi
        if not bool(active.any()):
            break
        mid = (lo + hi) >> 1
        at = base[active] + mid[active]
        probes += int(at.numel())
        ids.append(at // (SECTOR // 4))
        below = torch.zeros_like(active)
        below[active] = rows.reshape(-1)[at] < targets[active]
        lo = torch.where(active & below, mid + 1, lo)
        hi = torch.where(active & ~below, mid, hi)
    if not torch.equal(lo, want_pos.to(lo.dtype)):
        raise AssertionError("the replayed search disagrees with leaf_search_ref")
    return torch.unique(torch.cat(ids)) if ids else base[:0], probes


def max_abs_err(got, want) -> float:
    import torch

    if got.numel() == 0:
        return 0.0
    return float((got.to(torch.float64) - want.to(torch.float64)).abs().max())


# ---------------------------------------------------------------------------
# Phase 0 / 1: card and build
# ---------------------------------------------------------------------------
def phase_card(device) -> str:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    from repro_torch.kernels.runtime import is_hopper

    cap = torch.cuda.get_device_capability(device)
    emit("card", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         capability=list(cap), name=torch.cuda.get_device_name(device),
         cards=torch.cuda.device_count())
    if not is_hopper():
        raise RuntimeError(f"need a Hopper card (capability 9.0), got {cap}")
    return smi


def phase_build() -> None:
    from repro_torch.kernels import runtime

    t0 = time.perf_counter()
    libs = runtime.build_all()
    emit("build", seconds=time.perf_counter() - t0, libraries=sorted(libs))


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------
def build_store(scale: int, seed: int, device, undirected: bool = False, leaf_tiers=None):
    """``(store, info)``: the seeded R-MAT store of ``launch.plane.rmat_store``
    (the one every rank of phase ``multiprocess`` builds)."""
    from repro_torch.launch.plane import rmat_store

    return rmat_store(scale, seed, device, undirected=undirected, leaf_tiers=leaf_tiers)


def make_operands(view, seed: int, device, with_h: bool = True, n_pairs: int = N_PAIRS,
                  d: int = D_FEATURES):
    """Query operands for one view, made from ``seed`` (numpy on the host,
    torch on the device for the large float inputs)."""
    import numpy as np
    import torch

    from repro_torch.core import view_assembler

    rng = np.random.default_rng(seed)
    n = view.n_vertices
    src, dst = view.to_coo()
    pick = rng.choice(len(src), N_QUERIES, replace=False)
    present = np.stack([src[pick], dst[pick].astype(np.int64)], 1)
    cand = np.stack([np.tile(present[:, 0], 2), rng.integers(0, n, 2 * N_QUERIES)], 1)
    absent = np.array([(u, v) for u, v in cand if not view.search(int(u), int(v))],
                      np.int64).reshape(-1, 2)[:N_QUERIES]
    if len(absent) < N_QUERIES:
        raise RuntimeError(f"only {len(absent)} absent query pairs found")
    queries = np.concatenate([present, absent])
    # intersect pairs: the first leaf of each endpoint of sampled edges
    bsrc, order = view_assembler.block_src_index(view)
    s_sorted = bsrc[order]
    e = rng.choice(len(src), 2 * n_pairs, replace=False)
    u, v = src[e].astype(np.int64), dst[e].astype(np.int64)
    lo_u, lo_v = np.searchsorted(s_sorted, u), np.searchsorted(s_sorted, v)
    has_v = (lo_v < len(s_sorted)) & (s_sorted[np.minimum(lo_v, len(s_sorted) - 1)] == v)
    ia, ib = order[lo_u[has_v]][:n_pairs], order[lo_v[has_v]][:n_pairs]
    g = torch.Generator(device=device).manual_seed(seed)
    return {
        "queries": queries,
        "n_present": len(present),
        "ia": ia,
        "ib": ib,
        "x": torch.randn(n, generator=g, device=device),
        "w": torch.rand(len(src), generator=g, device=device) + 0.1,
        "H": torch.randn((n, d), generator=g, device=device) if with_h else None,
    }


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def phase_kernels(view, ops, device) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.core import view_assembler
    from repro_torch.core.leaf_pool import SENTINEL
    from repro_torch.kernels.intersect import intersect_count
    from repro_torch.kernels.intersect.ref import intersect_count_ref
    from repro_torch.kernels.leaf_search import leaf_search
    from repro_torch.kernels.leaf_search.ref import leaf_search_ref
    from repro_torch.kernels.spmm import leaf_scan_reduce, leaf_spmm
    from repro_torch.kernels.spmm.ref import leaf_scan_reduce_ref, leaf_spmm_ref

    rows = view.to_leaf_blocks_device().rows
    N, B = rows.shape
    lengths = live_lengths(rows)
    out = {}

    def record(name, shape, err, ms, plain_ms, library_ms, nbytes, nops, **extra):
        b_ms, b_by = bound(nbytes, nops)
        out[name] = dict(name=name, shape=list(shape), max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                         bound_by=b_by, bound_bytes=nbytes, **extra)
        emit("kernel", **out[name])

    # -- leaf_search at edge_search_view's shape: the queries' candidate
    # tiles, named by index into the resident tiles and searched over their
    # live prefix in place (no gathered copy)
    from repro_torch.kernels.leaf_search import ops as search_ops

    offsets, order = view_assembler.block_src_offsets(view)
    us, vs = ops["queries"][:, 0], ops["queries"][:, 1]
    qidx, flat = search_ops.flatten_candidates(
        order, *search_ops.candidate_ranges(offsets, us))
    index = torch.from_numpy(flat.astype(np.int32)).to(device)
    length = view.to_leaf_blocks_device().length
    tgt = torch.from_numpy(vs[qidx].astype(np.int32)).to(device)
    if not torch.equal(length, lengths.to(torch.int32)):
        raise AssertionError("the tiles' length column disagrees with their live prefix")
    f, p = leaf_search(rows, tgt, index, length)
    fr, pr = leaf_search_ref(rows, tgt, index, length)
    if not (torch.equal(f, fr) and torch.equal(p, pr)):
        raise AssertionError("leaf_search disagrees with its plain version")
    err = max(max_abs_err(p, pr), max_abs_err(f, fr))
    Q = tgt.shape[0]
    li = index.long()
    srows = rows[li]  # the gathered copy the first port searched
    tgt2 = tgt[:, None].contiguous()
    gather_ms = time_ms(lambda: rows[li], device, 20, graph=True)
    searchsorted_ms = time_ms(lambda: torch.searchsorted(srows, tgt2), device, 50, graph=True)
    # the bytes the search needs: each distinct sector its probes touch, once
    # (pairs share tiles), plus target, index, pos and found per pair and the
    # length of each distinct tile
    sector_ids, probes = search_sector_ids(rows, tgt, li, length, pr)
    sectors = int(sector_ids.numel())
    n_tiles = int(torch.unique(li).numel())
    seven_bound, _ = bound(Q * (search_sectors(B) * SECTOR + 4 * 4 + 1), 0)
    record("leaf_search", (Q, B), err,
           time_ms(lambda: leaf_search(rows, tgt, index, length), device, 50, graph=True),
           # the plain version checks the index range on the host, so no graph
           time_ms(lambda: leaf_search_ref(rows, tgt, index, length), device, 10),
           searchsorted_ms, sectors * SECTOR + Q * (4 * 3 + 1) + n_tiles * 4, probes,
           gather_ms=gather_ms, library_with_gather_ms=gather_ms + searchsorted_ms,
           distinct_sectors=sectors, probes=probes, distinct_tiles=n_tiles,
           bound_7_sectors_ms=seven_bound,
           mean_live=float(lengths[li].double().mean()), n_tiles=N)
    del srows, tgt, tgt2, f, p, fr, pr, index, li, sector_ids

    # -- leaf_scan_reduce over the whole view (leaf_scan_reduce_view's shape):
    # each tile read over its live prefix (the tiles' length column), timed
    # as a graph replay beside the same kernel over the full width B
    # (no_length_ms), both held against the plain version on every tile;
    # the library call on masked weights over all B slots (library_ms) and
    # on the compacted live ids alone (library_live_ms, ids and offsets
    # built outside the timed call).  Three cuts of the kernel's work show
    # where its time goes: every length 0 (the length loads and y alone),
    # every live id replaced by 0 (the same id traffic, every gather on one
    # line of x), and the tiles of at most SHORT_TILE live ids and the rest,
    # each gathered into tiles of their own.
    from repro_torch.kernels.spmm import route as spmm_route

    x = ops["x"]
    live = int(lengths.sum())
    rows_bytes = live_bytes(lengths)
    touched = int(torch.unique(rows[rows != SENTINEL]).numel())
    err = 0.0
    for ln in (None, length):  # yr, with length, stays for the library's check
        yr = leaf_scan_reduce_ref(rows, x, ln)
        y = leaf_scan_reduce(rows, x, ln)
        torch.testing.assert_close(y, yr, rtol=1e-5, atol=1e-5)
        err = max(err, max_abs_err(y, yr))
    zero_len = torch.zeros_like(length)
    cuts = {"length_0_ms": time_ms(lambda: leaf_scan_reduce(rows, x, zero_len), device, 20,
                                   graph=True)}
    zero_ids = torch.where(rows != SENTINEL, 0, rows)
    cuts["ids_0_ms"] = time_ms(lambda: leaf_scan_reduce(zero_ids, x, length), device, 20,
                               graph=True)
    del zero_len, zero_ids
    short = lengths <= SHORT_TILE
    for name, sel in (("short", short), ("long", ~short)):
        part_rows, part_len = rows[sel].contiguous(), length[sel].contiguous()
        cuts[f"{name}_ms"] = time_ms(lambda: leaf_scan_reduce(part_rows, x, part_len), device,
                                     20, graph=True)
        cuts[f"{name}_tiles"], cuts[f"{name}_live"] = int(sel.sum()), int(lengths[sel].sum())
        del part_rows, part_len
    mask = rows != SENTINEL
    idx = torch.where(mask, rows, 0).long()
    psw = mask.to(torch.float32)
    live_ids = rows[mask].long()  # tile by tile: each live prefix in order
    del mask
    starts = torch.cumsum(lengths, 0) - lengths
    x2 = x[:, None].contiguous()
    # the library call sums each bag in its own order: held within the drift
    # of two f32 summation orders, 2 m u sum|x| (u = 2^-24), plus 1e-5
    drift = (1e-5 + 1e-5 * yr.abs() + 2 * lengths * 2.0 ** -24
             * leaf_scan_reduce_ref(rows, x.abs(), length))
    if not bool(((F.embedding_bag(live_ids, x2, starts, mode="sum")[:, 0] - yr).abs()
                 <= drift).all()):
        raise AssertionError("F.embedding_bag over the live ids is not the scan's function")
    del y, yr, drift
    record("leaf_scan_reduce", (N, B), err,
           time_ms(lambda: leaf_scan_reduce(rows, x, length), device, 20, graph=True),
           time_ms(lambda: leaf_scan_reduce_ref(rows, x, length), device, 2),
           time_ms(lambda: F.embedding_bag(idx, x2, mode="sum", per_sample_weights=psw),
                   device, 5),
           rows_bytes + touched * 4 + N * 4 + N * 4, live,
           kernel_route=spmm_route(B, rows.data_ptr()),
           no_length_ms=time_ms(lambda: leaf_scan_reduce(rows, x), device, 10, graph=True),
           library_live_ms=time_ms(lambda: F.embedding_bag(live_ids, x2, starts, mode="sum"),
                                   device, 20),
           # every live id's 32-byte sector of x from HBM (no L2 reuse)
           gathered_bound_ms=hbm_ms(live * SECTOR),
           live_entries=live, tile_bytes=N * B * 4, live_prefix_bytes=rows_bytes,
           distinct_x=touched, short_max_live=SHORT_TILE, **cuts)
    del live_ids, starts

    # -- leaf_spmm over each tile's live prefix (the tiles' length column):
    # timed against the plain version and the library call on a prefix of
    # tiles (the plain version materializes [N, B, d]); the all-tile launch
    # of the main path is timed (main_ms), beside the same kernel over the
    # full width B (main_no_length_ms), and held against the plain version
    # chunk by chunk, every tile included.
    H = ops["H"]
    d = H.shape[1]
    n_p = min(N, SPMM_PLAIN_ROWS)
    prow, plen = rows[:n_p], length[:n_p]
    plive = int(lengths[:n_p].sum())
    ptouched = int(torch.unique(prow[prow != SENTINEL]).numel())
    pidx, ppsw = idx[:n_p], psw[:n_p]
    main_ms = time_ms(lambda: leaf_spmm(rows, H, length), device, 5)
    main_no_length_ms = time_ms(lambda: leaf_spmm(rows, H), device, 3)
    ym = leaf_spmm(rows, H, length)
    err, main_library_ms, n_chunks = 0.0, 0.0, 0
    for c0 in range(0, N, SPMM_PLAIN_ROWS):
        c1 = min(N, c0 + SPMM_PLAIN_ROWS)
        ymr = leaf_spmm_ref(rows[c0:c1], H, length[c0:c1])
        torch.testing.assert_close(ym[c0:c1], ymr, rtol=1e-4, atol=1e-4)
        err = max(err, max_abs_err(ym[c0:c1], ymr))
        del ymr
        # the library call over all tiles: the same chunks, summed
        cidx, cpsw = idx[c0:c1], psw[c0:c1]
        main_library_ms += time_ms(lambda: F.embedding_bag(cidx, H, mode="sum",
                                                           per_sample_weights=cpsw), device, 2)
        n_chunks += 1
    del ym
    main_bound, _ = bound(rows_bytes + touched * d * 4 + N * 4 + N * d * 4, live * d)
    record("leaf_spmm", (n_p, B, d), err,
           time_ms(lambda: leaf_spmm(prow, H, plen), device, 20),
           time_ms(lambda: leaf_spmm_ref(prow, H, plen), device, 2),
           time_ms(lambda: F.embedding_bag(pidx, H, mode="sum", per_sample_weights=ppsw),
                   device, 5),
           live_bytes(lengths[:n_p]) + ptouched * d * 4 + n_p * 4 + n_p * d * 4,
           plive * d, kernel_route=spmm_route(d, H.data_ptr()),
           checked_tiles=N, gathered_bytes=plive * d * 4, distinct_h_rows=ptouched,
           main_shape=[N, B, d], main_ms=main_ms, main_no_length_ms=main_no_length_ms,
           main_bound_ms=main_bound, gathered_bound_ms=hbm_ms(live * d * 4),
           main_distinct_h_rows=touched, main_gathered_bytes=live * d * 4,
           main_library_ms=main_library_ms, main_library_chunks=n_chunks)
    del idx, psw, pidx, ppsw, prow

    # -- intersect_count at sum_intersect_tiles_view's batch shape: the pairs'
    # tiles named by index into the resident tiles and read over their live
    # prefix in place (no gathered copy); beside it the same kernel on
    # gathered full-width copies (the first port's form) and the gather's
    # own time
    ia = torch.from_numpy(ops["ia"].astype(np.int32)).to(device)
    ib = torch.from_numpy(ops["ib"].astype(np.int32)).to(device)
    Qi = ia.shape[0]
    c = intersect_count(rows, rows, ia, ib, length, length)
    cr = intersect_count_ref(rows, rows, ia, ib, length, length)
    if not torch.equal(c, cr):
        raise AssertionError("intersect_count disagrees with its plain version")
    lia, lib = ia.long(), ib.long()
    a, b = rows[lia], rows[lib]  # the gathered copies the first port read
    if not torch.equal(intersect_count(a, b), c):
        raise AssertionError("intersect_count on gathered copies disagrees")
    gather_ms = time_ms(lambda: (rows[lia], rows[lib]), device, 20, graph=True)
    gathered_ms = time_ms(lambda: intersect_count(a, b), device, 50, graph=True)
    del a, b
    la, lb = lengths[lia], lengths[lib]
    tiles = torch.unique(torch.cat([lia, lib]))
    # each distinct tile's live-prefix sectors and length once, the two
    # indices and the count per pair; per pair: each pair's two prefixes
    per_pair, _ = bound(live_bytes(la) + live_bytes(lb) + Qi * 4 * 5, 0)
    # a merge of the two sorted live prefixes: one compare per element
    record("intersect_count", (Qi, B), max_abs_err(c, cr),
           time_ms(lambda: intersect_count(rows, rows, ia, ib, length, length), device, 50,
                   graph=True),
           # the plain version checks the index range on the host, so no graph
           time_ms(lambda: intersect_count_ref(rows, rows, ia, ib, length, length), device, 3),
           None,
           live_bytes(lengths[tiles]) + int(tiles.numel()) * 4 + Qi * 4 * 3,
           int((la + lb).sum()),
           bound_per_pair_ms=per_pair, distinct_tiles=int(tiles.numel()),
           gathered_ms=gathered_ms, gather_ms=gather_ms,
           gathered_with_gather_ms=gathered_ms + gather_ms,
           mean_live_a=float(la.double().mean()), mean_live_b=float(lb.double().mean()),
           total_count=int(c.sum()))
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------
ENTRY_POINTS = (
    "edge_search_view", "intersect_tiles_view", "sum_intersect_tiles_view",
    "leaf_scan_reduce_view", "leaf_spmm_view", "spmm_view", "pagerank_view",
    "bfs_view", "sssp_view", "wcc_view",
)


def run_entry_points(view, ops, device, names=ENTRY_POINTS) -> tuple:
    """The view-level entry points ``names`` on ``view``: (results,
    seconds each)."""
    from repro_torch.core import analytics as A
    from repro_torch.kernels.intersect import intersect_tiles_view, sum_intersect_tiles_view
    from repro_torch.kernels.leaf_search import edge_search_view
    from repro_torch.kernels.spmm import leaf_scan_reduce_view, leaf_spmm_view, spmm_view

    q = ops["queries"]
    calls = {
        "edge_search_view": lambda: edge_search_view(view, q[:, 0], q[:, 1]),
        "intersect_tiles_view": lambda: intersect_tiles_view(view, ops["ia"], ops["ib"]),
        "sum_intersect_tiles_view": lambda: sum_intersect_tiles_view(
            view, ops["ia"], ops["ib"]),
        "leaf_scan_reduce_view": lambda: leaf_scan_reduce_view(view, ops["x"]),
        "leaf_spmm_view": lambda: leaf_spmm_view(view, ops["H"]),
        "spmm_view": lambda: spmm_view(view, ops["H"]),
        "pagerank_view": lambda: A.pagerank_view(view),
        "bfs_view": lambda: A.bfs_view(view, 0),
        "sssp_view": lambda: A.sssp_view(view, ops["w"], 0),
        "wcc_view": lambda: A.wcc_view(view),
    }
    res, secs = {}, {}
    for name in names:
        res[name], secs[name] = wall(calls[name], device)
    secs["bfs_iterations"] = A.bfs_coo.iterations
    secs["sssp_iterations"] = A.sssp_coo.iterations
    secs["wcc_iterations"] = A.wcc_coo.iterations
    return res, secs


def edge_search_breakdown(view, ops, device, reps: int = 5) -> dict:
    """edge_search_view on a warm view, step by step (host clock, device
    drained after each step; the median of ``reps``), and the whole call;
    the steps' answer must equal the call's bitwise."""
    import numpy as np

    from repro_torch.core import view_assembler
    from repro_torch.kernels.leaf_search import edge_search_view
    from repro_torch.kernels.leaf_search import ops as search_ops

    us, vs = ops["queries"][:, 0], ops["queries"][:, 1]
    steps = {k: [] for k in ("block_src_offsets", "candidate_ranges", "flatten",
                             "search_tiles", "copy_back", "steps_total", "edge_search_view")}
    for _ in range(reps):
        (offsets, order), t0 = wall(lambda: view_assembler.block_src_offsets(view), device)
        (lo, hi), t1 = wall(lambda: search_ops.candidate_ranges(offsets, us), device)
        (qidx, flat), t2 = wall(lambda: search_ops.flatten_candidates(order, lo, hi), device)
        hits, t3 = wall(lambda: search_ops.search_tiles(view, vs, qidx, flat, len(us)), device)
        got, t4 = wall(lambda: hits.cpu().numpy(), device)
        want, t5 = wall(lambda: edge_search_view(view, us, vs), device)
        if not np.array_equal(got, want):
            raise AssertionError("edge_search_view's steps disagree with the call")
        for k_, t in zip(steps, (t0, t1, t2, t3, t4, t0 + t1 + t2 + t3 + t4, t5)):
            steps[k_].append(t * 1e3)
    return {k_: float(np.median(v)) for k_, v in steps.items()} | {
        "pairs": int(len(flat)), "queries": int(len(us)), "reps": reps}


def check_results(view, ops, res) -> dict:
    """Shapes, finiteness, and the cross-checks that hold on any view."""
    import numpy as np
    import torch

    n = view.n_vertices
    n_blocks = view.to_leaf_blocks_device().n_blocks
    q = ops["queries"]
    want = np.array([view.search(int(u), int(v)) for u, v in q])
    if not np.array_equal(res["edge_search_view"], want):
        raise AssertionError("edge_search_view disagrees with view.search")
    if not res["edge_search_view"][: ops["n_present"]].all():
        raise AssertionError("a present edge was not found")
    if int(res["intersect_tiles_view"].sum()) != res["sum_intersect_tiles_view"]:
        raise AssertionError("sum_intersect_tiles_view != intersect_tiles_view sum")
    d = ops["H"].shape[1]
    shapes = {
        "leaf_scan_reduce_view": (n_blocks,), "leaf_spmm_view": (n_blocks, d),
        "spmm_view": (n, d), "pagerank_view": (n,), "bfs_view": (n,),
        "sssp_view": (n,), "wcc_view": (n,),
    }
    for name, shape in shapes.items():
        t = res[name]
        if tuple(t.shape) != shape:
            raise AssertionError(f"{name}: shape {tuple(t.shape)} != {shape}")
        if t.is_floating_point() and name != "sssp_view" and not torch.isfinite(t).all():
            raise AssertionError(f"{name}: non-finite values")
    pr = res["pagerank_view"]
    return {"edge_search_hits": int(res["edge_search_view"].sum()),
            "pagerank_sum": float(pr.double().sum()),
            "bfs_reached": int((res["bfs_view"] >= 0).sum()),
            "sssp_reached": int(torch.isfinite(res["sssp_view"]).sum()),
            "wcc_components": int(torch.unique(res["wcc_view"]).numel())}


def check_cpu_route(view, ops, res) -> dict:
    """BFS, SSSP and WCC bitwise, PageRank within tolerance, against the
    port's own functions on CPU copies of the same view's COO."""
    import torch

    from repro_torch.core import analytics as A

    src, dst = (t.cpu() for t in view.to_coo_device())
    n = view.n_vertices
    t0 = time.perf_counter()
    want = {
        "bfs_view": A.bfs_coo(src, dst, n, 0),
        "sssp_view": A.sssp_coo(src, dst, ops["w"].cpu(), n, 0),
        "wcc_view": A.wcc_coo(src, dst, n),
    }
    for name, w in want.items():
        if not torch.equal(res[name].cpu(), w):
            raise AssertionError(f"{name} differs from the CPU route")
    pr_cpu = A.pagerank_coo(src, dst, n)
    pr = res["pagerank_view"].cpu()
    # f32 sums in another order (atomics on the card): relative tolerance
    torch.testing.assert_close(pr, pr_cpu, rtol=1e-3, atol=1e-9)
    rel = float(((pr.double() - pr_cpu.double()).abs() / pr_cpu.double().abs()).max())
    return {"cpu_route_s": time.perf_counter() - t0, "pagerank_max_rel_err": rel}


def random_writes(view, rng, n_txn: int):
    """``n_txn`` (ins, dels) batches: uniform random inserts and deletes of
    existing edges of ``view``."""
    import numpy as np

    src, dst = view.to_coo()
    n = view.n_vertices
    batches = []
    pick = rng.choice(len(src), n_txn * N_DELS, replace=False)
    for t in range(n_txn):
        ins = rng.integers(0, n, size=(N_INS, 2))
        ins = ins[ins[:, 0] != ins[:, 1]]
        sel = pick[t * N_DELS:(t + 1) * N_DELS]
        dels = np.stack([src[sel], dst[sel].astype(np.int64)], 1)
        batches.append((ins, dels))
    return batches


def snapshot_results(res) -> dict:
    return {k: (v.clone() if hasattr(v, "clone") else v.copy())
            for k, v in res.items()
            if k in ("edge_search_view", "leaf_scan_reduce_view", "leaf_spmm_view")}


def pin_view(store, build_info, seed, device) -> tuple:
    """Pin R0, time its cold device views, and make its operands."""
    from repro_torch.core import device_cache

    r0 = store.begin_read()
    _, cold_blocks = wall(r0.view.to_leaf_blocks_device, device)
    _, cold_coo = wall(r0.view.to_coo_device, device)
    uploads_cold = device_cache.stats.snapshot()
    ops0 = make_operands(r0.view, seed, device)
    info = dict(build_info, cold_blocks_s=cold_blocks, cold_coo_s=cold_coo,
                n_subgraphs=store.n_subgraphs,
                n_leaves=r0.view.to_leaf_blocks_device().n_blocks,
                n_edges=int(r0.view.to_coo_device()[0].shape[0]),
                cold_uploads=uploads_cold[2], cold_bytes_uploaded=uploads_cold[3])
    return r0, ops0, info


def phase_main(store, r0, ops0, info, seed, device) -> dict:
    """Phase 3; returns R0's first answers for the isolation check."""
    import numpy as np

    from repro_torch.core import device_cache, view_assembler

    res0, secs0 = run_entry_points(r0.view, ops0, device)
    chk0 = check_results(r0.view, ops0, res0)
    chk0.update(check_cpu_route(r0.view, ops0, res0))
    first = snapshot_results(res0)
    del res0
    # a retired predecessor at R0's timestamp: R1 splices against it
    rp = store.begin_read()
    rp.view.to_leaf_blocks_device()
    rp.view.to_coo_device()
    store.end_read(rp)
    del rp
    rng = np.random.default_rng(seed + 1)
    batches = random_writes(r0.view, rng, N_WRITES)
    t0 = time.perf_counter()
    for ins, dels in batches:
        store.apply(ins, dels)
    write_s = time.perf_counter() - t0
    r1 = store.begin_read()
    splices0 = view_assembler.stats.splices
    _, splice_blocks = wall(r1.view.to_leaf_blocks_device, device)
    _, splice_coo = wall(r1.view.to_coo_device, device)
    splices = view_assembler.stats.splices - splices0
    if splices <= 0:
        raise AssertionError("R1 did not take the splice path")
    ops1 = make_operands(r1.view, seed + 2, device)
    res1, secs1 = run_entry_points(r1.view, ops1, device)
    chk1 = check_results(r1.view, ops1, res1)
    del res1
    up0 = device_cache.stats.uploads
    _, secs_warm = run_entry_points(r1.view, ops1, device)
    warm_uploads = device_cache.stats.uploads - up0
    if warm_uploads:
        raise AssertionError(f"warm repeat uploaded {warm_uploads} arrays")
    breakdown = edge_search_breakdown(r1.view, ops1, device)
    emit("edge_search_breakdown", view="R1 warm", ms=breakdown)
    store.end_read(r1)
    emit("main", **info, write_txns=N_WRITES, write_s=write_s,
         splice_blocks_s=splice_blocks, splice_coo_s=splice_coo,
         splices=splices, r0_query_s=secs0, r0_checks=chk0,
         r1_query_s=secs1, r1_checks=chk1, warm_query_s=secs_warm,
         warm_uploads=warm_uploads)
    return first


def phase_isolation(r0, ops0, first, device) -> None:
    import numpy as np
    import torch

    from repro_torch.kernels.leaf_search import edge_search_view
    from repro_torch.kernels.spmm import leaf_scan_reduce_view, leaf_spmm_view

    res, secs = {}, {}

    q = ops0["queries"]
    res["edge_search_view"], secs["edge_search_view"] = wall(
        lambda: edge_search_view(r0.view, q[:, 0], q[:, 1]), device)
    res["leaf_scan_reduce_view"], secs["leaf_scan_reduce_view"] = wall(
        lambda: leaf_scan_reduce_view(r0.view, ops0["x"]), device)
    res["leaf_spmm_view"], secs["leaf_spmm_view"] = wall(
        lambda: leaf_spmm_view(r0.view, ops0["H"]), device)
    for k, v in first.items():
        same = np.array_equal(res[k], v) if isinstance(v, np.ndarray) else torch.equal(res[k], v)
        if not same:
            raise AssertionError(f"pinned R0 answers {k} differently after writes")
    emit("isolation", bitwise_equal=sorted(first), seconds=secs)


def phase_readers(store, seed, device, repeats: int = 4, commits: int = 10) -> None:
    import numpy as np
    import torch

    from repro_torch.kernels.leaf_search import edge_search_view
    from repro_torch.kernels.spmm import leaf_scan_reduce_view

    errors, stats = [], {}
    go = threading.Event()

    def reader(k):
        try:
            h = store.begin_read()
            try:
                ops = make_operands(h.view, seed + 10 + k, device, with_h=False)
                q = ops["queries"]
                go.set()
                base = (edge_search_view(h.view, q[:, 0], q[:, 1]),
                        leaf_scan_reduce_view(h.view, ops["x"]).clone())
                for _ in range(repeats):
                    e = edge_search_view(h.view, q[:, 0], q[:, 1])
                    s = leaf_scan_reduce_view(h.view, ops["x"])
                    if not (np.array_equal(e, base[0]) and torch.equal(s, base[1])):
                        raise AssertionError(f"reader {k}: answers changed")
                stats[k] = {"ts": h.ts, "repeats": repeats}
            finally:
                store.end_read(h)
        except BaseException as exc:  # re-raised on the main thread
            errors.append(exc)
            go.set()

    threads = [threading.Thread(target=reader, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    go.wait(timeout=600)
    rng = np.random.default_rng(seed + 3)
    with store.read_view() as v:
        batches = random_writes(v, rng, commits)
    t0 = time.perf_counter()
    for ins, dels in batches:
        store.apply(ins, dels)
    commit_s = time.perf_counter() - t0
    for t in threads:
        t.join(timeout=900)
        if t.is_alive():
            raise AssertionError("a reader thread did not finish")
    if errors:
        raise errors[0]
    emit("readers", readers=stats, commits=commits, commit_s=commit_s)


# ---------------------------------------------------------------------------
# Phase 5s: the shard plane
# ---------------------------------------------------------------------------
PLANE_QUERIES = ("pagerank_view", "bfs_view", "sssp_view", "wcc_view", "spmm_view")
PLANE_TOLERANCE = {"pagerank_view": 1e-5, "spmm_view": 1e-4}  # atomics on the card
# PageRank values average 1/n (2.4e-7 at scale 22), far below 1e-5: also
# held at the CPU route's relative limit (phase 3), scaled to the values
PR_RTOL, PR_ATOL = 1e-3, 1e-9


@contextmanager
def single_route():
    """The ``*_view`` entry points on the single-device route while inside
    (``REPRO_DISABLE_SHARD_PLANE``, the plane's own switch)."""
    import os

    os.environ["REPRO_DISABLE_SHARD_PLANE"] = "1"
    try:
        yield
    finally:
        del os.environ["REPRO_DISABLE_SHARD_PLANE"]


def plane_queries(view, w, h, device, reps: int = 1) -> tuple:
    """PageRank (10 iterations), BFS(0), SSSP(w, 0), WCC and SpMM on
    ``view`` through its store's current route: (answers, median warm
    seconds of ``reps`` calls after the first, or the first call's seconds
    when ``reps`` is 1)."""
    import numpy as np

    from repro_torch.core import analytics as A
    from repro_torch.kernels.spmm import spmm_view

    calls = {"pagerank_view": lambda: A.pagerank_view(view),
             "bfs_view": lambda: A.bfs_view(view, 0),
             "sssp_view": lambda: A.sssp_view(view, w, 0),
             "wcc_view": lambda: A.wcc_view(view),
             "spmm_view": lambda: spmm_view(view, h)}
    res, secs = {}, {}
    for name, fn in calls.items():
        res[name], t = wall(fn, device)
        if reps > 1:
            t = float(np.median([wall(fn, device)[1] for _ in range(reps)]))
        secs[name] = t
    return res, secs


def hold_pagerank(got, want, what: str) -> dict:
    """PageRank within 1e-5 and within rtol ``PR_RTOL``, atol ``PR_ATOL``:
    the largest absolute and relative differences."""
    import torch

    for tol in ({"rtol": 1e-5, "atol": 1e-5}, {"rtol": PR_RTOL, "atol": PR_ATOL}):
        torch.testing.assert_close(got, want, **tol,
                                   msg=lambda m: f"{what}: pagerank_view: {m}")
    diff = (got.double() - want.double()).abs()
    return {"max_abs_err": float(diff.max()),
            "max_rel_err": float((diff / want.double().abs()).max())}


def hold_plane(want: dict, got: dict, what: str) -> dict:
    """BFS, SSSP and WCC bitwise, PageRank as ``hold_pagerank`` and SpMM
    within 1e-4 (rtol = atol); returns the largest absolute difference of
    the two float answers (and PageRank's largest relative one)."""
    import torch

    errs = {}
    for name in PLANE_QUERIES:
        w, g = want[name], got[name]
        if name == "pagerank_view":
            pr = hold_pagerank(g, w, what)
            errs[name], errs["pagerank_rel"] = pr["max_abs_err"], pr["max_rel_err"]
            continue
        tol = PLANE_TOLERANCE.get(name)
        if tol is None:
            if not torch.equal(w, g):
                raise AssertionError(f"{what}: {name} differs bitwise")
            continue
        torch.testing.assert_close(g, w, rtol=tol, atol=tol,
                                   msg=lambda m, n=name: f"{what}: {n}: {m}")
        errs[name] = float((g.double() - w.double()).abs().max()) if w.numel() else 0.0
    return errs


def dropped_partial_rejected(plane, view, want, what: str) -> int:
    """The PageRank check against a plane whose merges drop the lightest
    shard's partials (its degrees and rank contributions): raises unless
    ``hold_pagerank`` rejects the answer; returns the shard dropped."""
    import numpy as np

    from repro_torch.core import analytics as A
    from repro_torch.core import distributed

    loads = [s.n_live for s in plane.sharded_coo(view).shards]
    k = int(np.argmin(loads))
    merge = distributed.merge
    distributed.merge = lambda parts, op, ranks: merge(
        [p for i, p in enumerate(parts) if i != k], op, ranks)
    try:
        bad = A.pagerank_view(view)
    finally:
        distributed.merge = merge
    try:
        hold_pagerank(bad, want, what)
    except AssertionError:
        return k
    raise AssertionError(f"{what}: the PageRank check passes a plane that lost shard {k}")


def hold_shard_spmm(plane, view, h) -> list:
    """``leaf_spmm`` on each shard's live tiles (the plane's own shapes and
    length columns) against its plain version, every tile, in
    ``SPMM_PLAIN_ROWS`` chunks at 1e-4 as in phase 2; per shard, the tiles
    and the largest absolute difference.  These comparison launches are
    taken off the launch count again."""
    import torch

    from repro_torch.kernels.spmm import leaf_spmm
    from repro_torch.kernels.spmm.ref import leaf_spmm_ref

    out = []
    for k, shard in enumerate(plane.sharded_blocks(view).shards):
        _, rows, length = shard.live()
        hk = h.to(shard.device)
        y = leaf_spmm(rows, hk, length)
        err = 0.0
        for c0 in range(0, shard.n_live, SPMM_PLAIN_ROWS):
            c1 = min(shard.n_live, c0 + SPMM_PLAIN_ROWS)
            yr = leaf_spmm_ref(rows[c0:c1], hk, length[c0:c1])
            torch.testing.assert_close(y[c0:c1], yr, rtol=1e-4, atol=1e-4,
                                       msg=lambda m, k=k: f"leaf_spmm on shard {k}: {m}")
            err = max(err, max_abs_err(y[c0:c1], yr))
            del yr
        del y
        out.append({"shard": k, "device": str(shard.device), "tiles": shard.n_live,
                    "width": int(rows.shape[1]), "max_abs_err": err})
    return out


def spmm_overlap(plane, view, h, device) -> dict:
    """One warm plane SpMM under the profiler (device activity only): each
    ``leaf_spmm`` launch's card and its interval on the device clock (ms
    from the first launch's start), how many pairs of launches on two
    cards overlap, their summed time and the span from the first start to
    the last end; ``None`` where the trace holds no such kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.spmm import spmm_view

    spmm_view(view, h)
    sync(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        spmm_view(view, h)
        sync(device)
    runs = sorted((e.time_range.start, e.time_range.end, e.device_index) for e in prof.events()
                  if e.device_type == DeviceType.CUDA and "leaf_spmm" in e.name)
    if not runs:
        return None
    t0 = runs[0][0]
    pairs = sum(1 for i, a in enumerate(runs) for b in runs[i + 1:]
                if a[2] != b[2] and b[0] < a[1])
    return {"launches": [{"card": c, "start_ms": (a - t0) / 1e3, "end_ms": (b - t0) / 1e3}
                         for a, b, c in runs],
            "overlapping_pairs": pairs, "kernel_ms_sum": sum(b - a for a, b, _ in runs) / 1e3,
            "span_ms": (max(b for _, b, _ in runs) - t0) / 1e3}


def shard_layout(plane, view) -> list:
    """Per shard: device, live edges, live tiles, the shared caps, uploads
    and bytes uploaded so far."""
    coo, blocks = plane.sharded_coo(view), plane.sharded_blocks(view)
    return [{"device": str(plane.devices[k]), "live_edges": coo.shards[k].n_live,
             "live_tiles": blocks.shards[k].n_live, "coo_cap": coo.cap,
             "tile_cap": blocks.cap, "uploads": plane.stats.uploads[k],
             "bytes_uploaded": plane.stats.bytes_uploaded[k]}
            for k in range(plane.n_shards)]


def phase_shard_plane(store, seed, device) -> int:
    """Phase 5s on the main store: the five collectives through a
    ``PLANE_SHARDS``-shard plane (modulo, directed) against the
    single-device route on the same view, a write on one shard, a
    migration under a pinned reader, the placements' loads, and the
    device bytes before, at the peak and after the detach.  Returns the
    allocator's peak before the phase (the phase resets it)."""
    import numpy as np
    import torch

    from repro_torch.core.shard_plane import degree_balanced_placement, modulo_placement
    from repro_torch.kernels.spmm import leaf_spmm
    from repro_torch.launch.plane import shard_writes

    cuda = device.type == "cuda"
    prior_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    mem_before = torch.cuda.memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    g = torch.Generator(device=device).manual_seed(seed + 30)
    n = store.n_vertices
    h = torch.randn((n, D_FEATURES), generator=g, device=device)

    # 1. the single-device route on a pinned view, before the attach
    r1 = store.begin_read()
    w = torch.rand(r1.view.n_edges, generator=g, device=device) + 0.1
    single, single_s = plane_queries(r1.view, w, h, device, reps=3)

    # 2. the plane, and the same timestamp through it
    plane = store.attach_shard_plane(n_devices=PLANE_SHARDS, symmetric=False)
    r2 = store.begin_read()
    if r2.ts != r1.ts or r2.view._plane is not plane:
        raise AssertionError("the view after the attach is not the same snapshot")
    _, coo_s = wall(lambda: plane.sharded_coo(r2.view), device)
    _, tiles_s = wall(lambda: plane.sharded_blocks(r2.view), device)
    layout = shard_layout(plane, r2.view)
    emit("shard_plane_attach", shards=PLANE_SHARDS, policy="modulo", symmetric=False,
         cold_coo_s=coo_s, cold_tiles_s=tiles_s, layout=layout)

    # 3. the same five queries through the plane on the same view
    n0 = leaf_spmm.launches
    sharded, sharded_s = plane_queries(r2.view, w, h, device, reps=3)
    spmm_launches = (leaf_spmm.launches - n0) / (1 + 3)  # the first call + 3 timed
    if "leaf_spmm" in PATH_KERNELS["shard_plane"] and spmm_launches < PLANE_SHARDS:
        raise AssertionError(f"leaf_spmm launched {spmm_launches} times per sharded SpMM")
    errs = hold_plane(single, sharded, "plane vs single route")
    dropped = dropped_partial_rejected(plane, r2.view, single["pagerank_view"],
                                       "a plane without a shard's partials")
    with uncounted():
        spmm_shards = hold_shard_spmm(plane, r2.view, h)
        # with several cards: do the shards' kernels run at once?
        overlap = spmm_overlap(plane, r2.view, h, device) if cuda and n_cards() > 1 else None
    # 4. 20 transactions on shard 1's subgraphs: the other shards upload
    # nothing and keep their bundles (R2 retires last, so it is the splice
    # source of the next view)
    placement = plane.placement_for(store.n_subgraphs)
    batches = shard_writes(r2.view, placement, 1, np.random.default_rng(seed + 31), N_WRITES,
                           N_INS, N_DELS)
    store.end_read(r1)
    pred_coo = r2.view.assembly.sharded.coo
    store.end_read(r2)
    del single, sharded, r1, r2  # ended views' bundles are garbage
    for ins, dels in batches:
        store.apply(ins, dels)
    u0, b0 = list(plane.stats.uploads), list(plane.stats.bytes_uploaded)
    r3 = store.begin_read()
    w3 = torch.rand(r3.view.n_edges, generator=g, device=device) + 0.1
    got3, write_s = plane_queries(r3.view, w3, h, device)
    up = [a - b for a, b in zip(plane.stats.uploads, u0)]
    succ = r3.view.assembly.sharded.coo
    if any(up[k] for k in range(PLANE_SHARDS) if k != 1) or up[1] <= 0:
        raise AssertionError(f"a write on shard 1 uploaded {up} segments per shard")
    reused = [k for k in range(PLANE_SHARDS) if succ.shards[k] is pred_coo.shards[k]]
    if reused != [k for k in range(PLANE_SHARDS) if k != 1]:
        raise AssertionError(f"clean COO shards reused by identity: {reused}")
    with single_route():
        want3, _ = plane_queries(r3.view, w3, h, device)
    errs3 = hold_plane(want3, got3, "after the shard-1 write")
    store.end_read(r3)
    del got3, want3, pred_coo, succ, r3
    emit("shard_plane_write", txns=N_WRITES, shard=1, uploads_delta=up,
         bytes_delta=[a - b for a, b in zip(plane.stats.bytes_uploaded, b0)],
         clean_shards_reused=reused, splices=plane.stats.splices,
         query_s=write_s, max_abs_err=errs3)

    # 5. a migration of the 4 heaviest subgraphs onto the least-loaded
    # shard while a reader stays pinned before the flip
    rb = store.attach_rebalancer()
    sig = rb.shard_signals()
    dst = min(sig, key=lambda k: sig[k]["load"])
    heads = np.array([c.head.n_edges for c in store.chains])
    cur = plane.placement_for(store.n_subgraphs)
    heavy = [int(s) for s in np.argsort(-heads, kind="stable") if int(cur[s]) != dst]
    moves = {sid: dst for sid in heavy[:PLANE_MOVES]}
    r4 = store.begin_read()
    w4 = torch.rand(r4.view.n_edges, generator=g, device=device) + 0.1
    pinned, _ = plane_queries(r4.view, w4, h, device)
    bundles = (r4.view.assembly.sharded.coo, r4.view.assembly.sharded.blocks)
    staged0 = store.stats.get("reshard_bytes_staged", 0)
    epoch, move_s = wall(lambda: rb.execute(rb.plan_moves(moves)), device)
    if epoch is None:
        raise AssertionError("the migration aborted")
    again, _ = plane_queries(r4.view, w4, h, device)
    if (r4.view.assembly.sharded.coo, r4.view.assembly.sharded.blocks) != bundles:
        raise AssertionError("the pinned view's bundles changed under the migration")
    pinned_errs = hold_plane(pinned, again, "pinned reader across the migration")
    pinned_bitwise = [k for k in PLANE_QUERIES if torch.equal(pinned[k], again[k])]
    store.end_read(r4)
    del pinned, again, bundles, r4
    r5 = store.begin_read()
    now = plane.placement_at(r5.ts, store.n_subgraphs)
    if r5.ts < epoch or any(int(now[s]) != d for s, d in moves.items()):
        raise AssertionError("the view after the flip does not resolve the new placement")
    got5, after_s = plane_queries(r5.view, w4, h, device)
    with single_route():
        want5, _ = plane_queries(r5.view, w4, h, device)
    errs5 = hold_plane(want5, got5, "after the migration")
    store.end_read(r5)
    del got5, want5, r5
    store.detach_rebalancer()
    emit("shard_plane_migration", moves={str(k): v for k, v in moves.items()},
         epoch=epoch, send_to_free_s=move_s,
         bytes_staged=store.stats["reshard_bytes_staged"] - staged0,
         pinned_bitwise=pinned_bitwise, pinned_max_abs_err=pinned_errs,
         after_query_s=after_s, max_abs_err=errs5,
         migration_rebuilds=plane.stats.migration_rebuilds,
         loads_after=[plane.shard_load(k) for k in range(PLANE_SHARDS)])

    # 6. the placements' loads at the current heads
    loads = {}
    for name, policy in (("modulo", modulo_placement),
                         ("degree_balanced", degree_balanced_placement)):
        ld = np.bincount(policy(heads, PLANE_SHARDS), weights=heads, minlength=PLANE_SHARDS)
        loads[name] = {"loads": [int(x) for x in ld], "max_over_min": float(ld.max() / ld.min())}

    # 8. detach
    stats = {k: v for k, v in vars(plane.stats).items()}
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    card_peaks = [torch.cuda.max_memory_allocated(k) for k in range(n_cards())] if cuda else []
    devices = [str(d) for d in plane.devices]
    store.detach_shard_plane()
    del plane
    free_device(device)
    mem_after = torch.cuda.memory_allocated(device) if cuda else 0
    emit("shard_plane", shards=PLANE_SHARDS, devices=devices, single_route_s=single_s,
         plane_s=sharded_s, max_abs_err=errs, leaf_spmm_per_sharded_spmm=spmm_launches,
         leaf_spmm_vs_plain=spmm_shards, pagerank_check_rejects_dropped_shard=dropped,
         placement_loads=loads, stats=stats, card_peaks=card_peaks, spmm_overlap=overlap,
         device_bytes={"before_attach": mem_before, "peak": peak, "after_detach": mem_after})
    if cuda and n_cards() > 1:
        shard_plane_one_card(store, w4, h, device)
    del h, w, w3, w4
    free_device(device)
    return prior_peak


def shard_plane_one_card(store, w, h, device) -> None:
    """With several cards, phase 5s's plane again with its
    ``PLANE_SHARDS`` shards all on ``device``: the five queries through it
    (warm medians of 3) against the single route on the same view, held as
    the four-card plane is; the peak on ``device`` in this part alone."""
    import torch

    torch.cuda.reset_peak_memory_stats(device)
    plane = store.attach_shard_plane(devices=[device] * PLANE_SHARDS, symmetric=False)
    r = store.begin_read()
    _, tiles_s = wall(lambda: (plane.sharded_coo(r.view), plane.sharded_blocks(r.view)),
                      device)
    got, plane_s = plane_queries(r.view, w, h, device, reps=3)
    with single_route():
        want, single_s = plane_queries(r.view, w, h, device, reps=3)
    errs = hold_plane(want, got, "four shards on one card vs single route")
    store.end_read(r)
    del got, want, r
    peak = torch.cuda.max_memory_allocated(device)
    store.detach_shard_plane()
    del plane
    emit("shard_plane_one_card", shards=PLANE_SHARDS, device=str(device), cold_s=tiles_s,
         plane_s=plane_s, single_route_s=single_s, max_abs_err=errs, peak=peak)


def phase_shard_symmetric(store, device) -> None:
    """Phase 6's undirected store under a ``symmetric=True`` plane: pull
    PageRank against the single-device route on the same view."""
    import numpy as np
    import torch

    from repro_torch.core import analytics as A

    def warm(fn):
        """(first answer, median seconds of 3 warm calls)."""
        out = fn()
        return out, float(np.median([wall(fn, device)[1] for _ in range(3)]))

    with store.read_view() as v:
        want, single_s = warm(lambda: A.pagerank_view(v))
    plane = store.attach_shard_plane(n_devices=PLANE_SHARDS, symmetric=True)
    with store.read_view() as v:
        _, cold_s = wall(lambda: plane.sharded_coo(v), device)
        got, plane_s = warm(lambda: A.pagerank_view(v))
        err = hold_pagerank(got, want, "symmetric plane vs single route")
        dropped = dropped_partial_rejected(plane, v, want, "a symmetric plane without a shard")
    store.detach_shard_plane()
    emit("shard_plane_symmetric", shards=PLANE_SHARDS, cold_coo_s=cold_s,
         pagerank_single_s=single_s, pagerank_plane_s=plane_s,
         pagerank_max_abs_err=err["max_abs_err"], pagerank_max_rel_err=err["max_rel_err"],
         pagerank_check_rejects_dropped_shard=dropped, bitwise=bool(torch.equal(got, want)))


def phase_write_side(store, seed, device) -> None:
    """Phase 5a on the main store: pipelined writers with two pinned
    readers, a fold while one reader stays pinned, more writes, and the
    entry points on a fresh view R2."""
    import numpy as np
    import torch

    from repro_torch.core import device_cache, view_assembler
    from repro_torch.kernels.leaf_search import edge_search_view
    from repro_torch.kernels.spmm import leaf_scan_reduce_view

    errors, readers = [], {}
    ready = [threading.Event(), threading.Event()]
    stop = [threading.Event(), threading.Event()]

    def reader(k):
        """Repeat two queries on a pinned view until told to stop, then
        once more; every answer must equal the first bit for bit."""
        try:
            h = store.begin_read()
            try:
                ops = make_operands(h.view, seed + 20 + k, device, with_h=False)
                q = ops["queries"]

                def ask():
                    out = (edge_search_view(h.view, q[:, 0], q[:, 1]),
                           leaf_scan_reduce_view(h.view, ops["x"]))
                    sync(device)
                    return out

                base = ask()
                ready[k].set()
                repeats = 0
                while True:
                    last = stop[k].is_set()
                    e, s = ask()
                    if not (np.array_equal(e, base[0]) and torch.equal(s, base[1])):
                        raise AssertionError(f"reader {k}: answers changed")
                    repeats += 1
                    if last:
                        break
                readers[k] = {"ts": h.ts, "repeats": repeats}
            finally:
                store.end_read(h)
        except BaseException as exc:  # re-raised on the main thread
            errors.append(exc)
            ready[k].set()

    def join(threads):
        for t in threads:
            t.join(timeout=JOIN_S)
            if t.is_alive():
                raise AssertionError(f"{t.name} did not finish")
        if errors:
            raise errors[0]

    def writer(k):
        try:
            for t in [store.apply_async(i, d) for i, d in first[k::WS_WRITERS]]:
                t.wait()
        except BaseException as exc:
            errors.append(exc)

    rthreads = [threading.Thread(target=reader, args=(k,), name=f"reader {k}", daemon=True)
                for k in range(2)]
    wthreads = [threading.Thread(target=writer, args=(k,), name=f"writer {k}", daemon=True)
                for k in range(WS_WRITERS)]
    try:
        for t in rthreads:
            t.start()
        for e in ready:
            if not e.wait(timeout=JOIN_S):
                raise AssertionError("a reader did not start")
        if errors:
            raise errors[0]
        wp = store.attach_write_pipeline()  # 4 shards, batches up to 1024
        rng = np.random.default_rng(seed + 4)
        with store.read_view() as v:
            batches = random_writes(v, rng, WS_WRITERS * WS_TXNS + WS_MORE)
        first, more = batches[:WS_WRITERS * WS_TXNS], batches[WS_WRITERS * WS_TXNS:]
        t0 = time.perf_counter()
        for t in wthreads:
            t.start()
        join(wthreads)
        store.flush()
        commit_s = time.perf_counter() - t0
        pipe = {f: getattr(wp.stats, f) for f in (
            "writes", "batches", "fences", "noop_batches", "publish_runs", "max_batch",
            "max_publish_run")}
        stop[0].set()
        join(rthreads[:1])
        comp = store.attach_compactor()
        live0 = store.pool.n_live_rows()
        report, fold_s = wall(comp.compact_once, device)  # reader 1 stays pinned
        stop[1].set()
        join(rthreads[1:])
    finally:  # a failed phase leaves no reader looping
        for e in stop:
            e.set()

    t0 = time.perf_counter()
    for t in [store.apply_async(i, d) for i, d in more]:
        t.wait()
    store.flush()
    more_s = time.perf_counter() - t0

    fields = ("splices", "full_concats", "base_splices", "reuses", "snapshot_touches",
              "fallback_no_pred", "fallback_lineage", "fallback_dirty_frac")
    va0 = {f: getattr(view_assembler.stats, f) for f in fields}
    up0 = device_cache.stats.snapshot()
    r2 = store.begin_read()
    cold_tiles = sum(s._dev_blocks_cache is None for s in r2.view.snaps)
    cold_coo = sum(s._dev_coo_cache is None for s in r2.view.snaps)
    _, blocks_s = wall(r2.view.to_leaf_blocks_device, device)
    _, coo_s = wall(r2.view.to_coo_device, device)
    up1 = device_cache.stats.snapshot()
    uploads = up1[2] - up0[2]
    # O(dirty): a snapshot uploads its 3 stream arrays and 2 COO arrays once
    if uploads > 3 * cold_tiles + 2 * cold_coo:
        raise AssertionError(f"R2 uploaded {uploads} arrays for {cold_tiles} snapshots "
                             f"without tiles and {cold_coo} without COO")
    assembler = {f: getattr(view_assembler.stats, f) - va0[f] for f in fields}
    ops2 = make_operands(r2.view, seed + 25, device)
    res2, secs2 = run_entry_points(r2.view, ops2, device)
    chk2 = check_results(r2.view, ops2, res2)
    chk2.update(check_cpu_route(r2.view, ops2, res2))
    del res2
    up = device_cache.stats.uploads
    _, secs_warm = run_entry_points(r2.view, ops2, device)
    warm_uploads = device_cache.stats.uploads - up
    if warm_uploads:
        raise AssertionError(f"R2's warm repeat uploaded {warm_uploads} arrays")
    store.end_read(r2)

    mem = store.memory_breakdown()
    if mem["pipeline"] != wp.queued_bytes() or mem["pipeline"]:
        raise AssertionError(f"flushed pipeline still holds {mem['pipeline']} bytes")
    if sum(mem.values()) != store.memory_bytes():
        raise AssertionError("memory_breakdown does not add up to memory_bytes")
    base = store._base_assembly
    store.detach_write_pipeline()
    store.detach_compactor()
    emit("write_side", writers=WS_WRITERS, txns=len(first), txns_after_fold=len(more),
         commit_s=commit_s, commits_per_s=len(first) / commit_s, pipeline=pipe,
         mean_group=pipe["writes"] / max(1, pipe["batches"]), readers=readers,
         fold_s=fold_s, report={k: v for k, v in vars(report).items() if k != "repacked"},
         repacked=len(report.repacked), live_rows_before_fold=live0,
         tier_migrations=store.stats.get("tier_migrations", 0),
         more_s=more_s, r2_cold_blocks_s=blocks_s, r2_cold_coo_s=coo_s,
         r2_uploads=uploads, r2_bytes_uploaded=up1[3] - up0[3],
         r2_snapshots_without_tiles=cold_tiles, r2_snapshots_without_coo=cold_coo,
         r2_assembler=assembler, r2_query_s=secs2, r2_checks=chk2,
         warm_query_s=secs_warm, warm_uploads=warm_uploads, memory_breakdown=mem,
         base_bundle_bytes={"host": base.host_bytes(), "device": base.device_bytes()})


# ---------------------------------------------------------------------------
# Phase 5g: GNN training on the live store
# ---------------------------------------------------------------------------
def gnn_config(arch: str):
    from repro_torch.configs import registry

    return (registry.get_smoke_config if MODEL_SMOKE else registry.get_config)(arch)


def leaf_errors(got, want) -> list:
    """Per leaf (``tree_leaves`` order): largest |got - want| over the
    leaf's largest |want|, in float64 on ``got``'s device."""
    from repro_torch.optim.tree import tree_leaves

    out = []
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        g, w = g.detach().double(), w.detach().to(g.device).double()
        out.append(float((g - w).abs().max() / max(float(w.abs().max()), 1e-30)))
    return out


def gnn_grads(cfg, params, batch, n_nodes: int, dev, dtype, reverse: bool = False):
    """((loss, grads), seconds) of the GNN loss at ``params`` on ``batch``,
    both copied to ``dev`` in ``dtype``; ``reverse`` swaps ``src`` and
    ``dst``, the planted fault."""
    from repro_torch.optim.tree import tree_map
    from repro_torch.train.step import gnn_value_and_grad

    p = tree_map(lambda t: t.to(dev, dtype), params)
    b = {k: t.to(dev, dtype) if t.is_floating_point() else t.to(dev) for k, t in batch.items()}
    src, dst = (b["dst"], b["src"]) if reverse else (b["src"], b["dst"])
    return wall(lambda: gnn_value_and_grad(
        cfg, p, b["feats"], src, dst, b["emask"], b["labels"], b["lmask"], n_nodes), dev)


def gnn_card_routes(cfg, params, batch, n_nodes: int, device, f32_fault: bool) -> dict:
    """The card's (loss, grads) at ``params`` on ``batch`` in float64 and
    f32, and with the edges reversed in float64 (and f32 with
    ``f32_fault``), keyed by route, with their seconds."""
    import torch

    out, secs = {}, {}
    for name, dtype, reverse in (("f64", torch.float64, False), ("f64_reversed", torch.float64, True),
                                 ("f32", torch.float32, False), ("f32_reversed", torch.float32, True)):
        if name != "f32_reversed" or f32_fault:
            out[name], secs[name] = gnn_grads(cfg, params, batch, n_nodes, device, dtype, reverse)
    return dict(routes=out, seconds=secs)


def gnn_cpu_routes(cfg, params, batch, n_nodes: int, f32: bool) -> dict:
    """The port's CPU route on host copies: float64, and f32 with ``f32``."""
    import torch

    cpu = torch.device("cpu")
    out, secs = {}, {}
    for name, dtype in (("f64", torch.float64), ("f32", torch.float32))[:2 if f32 else 1]:
        out[name], secs[name] = gnn_grads(cfg, params, batch, n_nodes, cpu, dtype)
    return dict(routes=out, seconds=secs)


def hold_grads(cfg, what: str, got, want, limits, controls: dict,
               loss_rtol: float = GNN_LOSS_RTOL) -> dict:
    """``got`` (loss, grads) against ``want``: the loss within
    ``loss_rtol``, every gradient leaf within its limit of its largest
    magnitude.  Each of ``controls`` (name -> (loss, grads)) must put some
    leaf outside its limit.  Returns the figures."""
    from repro_torch.optim.tree import tree_leaves

    loss_err = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
    if not math.isfinite(float(got[0])) or loss_err > loss_rtol:
        raise AssertionError(f"{cfg.name} {what}: card loss {float(got[0])} "
                             f"vs CPU {float(want[0])}")
    errs = leaf_errors(got[1], want[1])
    if not len(errs) == len(limits) == len(tree_leaves(want[1])):
        raise AssertionError(f"{cfg.name} {what}: gradient trees differ in their leaves")
    over = [(i, e, lim) for i, (e, lim) in enumerate(zip(errs, limits)) if not e <= lim]
    if over:
        raise AssertionError(f"{cfg.name} {what}: gradient leaves outside their limits: {over}")
    out = dict(loss_rel_err=loss_err, max_leaf_err=max(errs), max_leaf_limit=max(limits))
    for name, bad in controls.items():
        bad_errs = leaf_errors(bad[1], want[1])
        if all(e <= lim for e, lim in zip(bad_errs, limits)):
            raise AssertionError(f"{cfg.name} {what}: the control {name} passes the check")
        out[f"{name}_max_leaf_err"] = max(bad_errs)
    return out


def hold_gnn_step(cfg, card: dict, cpu: dict) -> dict:
    """Step 0's card routes against the CPU's.  Float64: each leaf within
    ``GNN_F64_GRAD_TOL[kind]``; reversed edges and the card's f32 are the
    controls.  f32, where the CPU route ran it: each leaf within
    ``GNN_F32_GRAD_TOL`` or ten times the CPU route's own f32 error
    (against its float64) where that is larger, as f32 GNNs can be
    ill-conditioned; reversed edges the control."""
    from repro_torch.optim.tree import tree_leaves

    c, h = card["routes"], cpu["routes"]
    n_leaves = len(tree_leaves(h["f64"][1]))
    out = dict(loss=float(c["f32"][0]), leaves=n_leaves,
               f64=hold_grads(cfg, "f64", c["f64"], h["f64"], [GNN_F64_GRAD_TOL[cfg.kind]] * n_leaves,
                            {"reversed_edges": c["f64_reversed"], "card_f32": c["f32"]}),
               card_f32_vs_f64_max_leaf_err=max(leaf_errors(c["f32"][1], c["f64"][1])),
               card_s=card["seconds"], cpu_s=cpu["seconds"])
    if "f32" in h:
        cpu_errs = leaf_errors(h["f32"][1], h["f64"][1])
        limits = [max(GNN_F32_GRAD_TOL, 10 * e) for e in cpu_errs]
        out["f32"] = hold_grads(cfg, "f32", c["f32"], h["f32"], limits,
                              {"reversed_edges": c["f32_reversed"]})
        out["f32"].update(cpu_f32_vs_f64_max_leaf_err=max(cpu_errs),
                          leaf_limits_above_tol=sum(lim > GNN_F32_GRAD_TOL for lim in limits))
    return out


def hold_adamw(params, opt, grads, device) -> float:
    """AdamW on the card and on the CPU from the same parameters, state and
    gradients: every new parameter and moment within ``GNN_ADAMW_TOL``.
    Returns the largest difference."""
    import torch

    from repro_torch.optim import adamw
    from repro_torch.optim.tree import tree_leaves, tree_map

    cpu = lambda t: t.detach().cpu()
    on_card = adamw.update(tree_map(lambda g: g.to(device), grads), opt, params,
                           GNN_LR, weight_decay=0.0)
    on_cpu = adamw.update(grads, adamw.AdamWState(cpu(opt.step), tree_map(cpu, opt.mu),
                                                  tree_map(cpu, opt.nu)),
                          tree_map(cpu, params), GNN_LR, weight_decay=0.0)
    worst = 0.0
    for tree_card, tree_cpu in zip((on_card[0], on_card[1].mu, on_card[1].nu),
                                   (on_cpu[0], on_cpu[1].mu, on_cpu[1].nu)):
        for a, b in zip(tree_leaves(tree_card), tree_leaves(tree_cpu)):
            worst = max(worst, max_abs_err(a.cpu(), b))
    if worst > GNN_ADAMW_TOL or int(on_card[1].step) != int(on_cpu[1].step):
        raise AssertionError(f"AdamW on the card and the CPU differ by {worst}")
    return worst


def check_sampled_edges(view, sub, rng, k: int = 20) -> int:
    """``k`` sampled edges, each a real edge of ``view``: the message
    v -> u of a block edge (src, dst) runs along the stored edge u -> v."""
    import numpy as np

    src, dst = sub.merged_edges()
    for e in rng.choice(len(src), size=min(k, len(src)), replace=False):
        u, v = int(sub.nodes[dst[e]]), int(sub.nodes[src[e]])
        if v not in set(view.scan(u).tolist()):
            raise AssertionError(f"sampled edge {u} -> {v} is not in the pinned view")
    return min(k, len(src))


def in_background(fn, name: str):
    """Start ``fn()`` on a thread; returns a ``join()`` that gives
    ``(result, seconds)`` or raises what ``fn`` raised."""
    box = {}

    def body():
        t0 = time.perf_counter()
        try:
            box["out"] = fn()
        except BaseException as exc:  # re-raised by join()
            box["exc"] = exc
        box["s"] = time.perf_counter() - t0

    t = threading.Thread(target=body, name=name, daemon=True)
    t.start()

    def join():
        t.join(timeout=JOIN_S)
        if t.is_alive():
            raise AssertionError(f"{name} did not finish in {JOIN_S} s")
        if "exc" in box:
            raise box["exc"]
        return box["out"], box["s"]

    return join


def phase_gnn_train(store, seed, device) -> int:
    """Phase 5g on the main store: gin-tu trains for ``GNN_STEPS`` steps on
    minibatches sampled from pinned views while a writer thread commits,
    with the features on the card.  Then step 0 and one step each of the
    other three GNNs on step 0's batch against the CPU route, which runs on
    a host thread while the card side checks the checkpoint and the store.
    Returns the allocator's peak before the phase (the phase resets it)."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.data.pipeline import GraphUpdateStream
    from repro_torch.graph.sampler import NeighborSampler, pad_subgraph
    from repro_torch.models import gnn as G
    from repro_torch.optim import adamw
    from repro_torch.optim.tree import tree_leaves, tree_map
    from repro_torch.roofline.cost import count_step
    from repro_torch.roofline.model import gnn_model_flops
    from repro_torch.train.step import make_gnn_train_step

    if store.write_pipeline is not None:
        raise AssertionError("a write pipeline is still attached")
    cell = next(c for c in GNN_SHAPES if c.name == "minibatch_lg").params
    n_seeds, fanouts, d_feat = GNN_SEEDS, GNN_FANOUTS, GNN_D_FEAT
    max_n = n_seeds * (1 + fanouts[0] + fanouts[0] * fanouts[1])
    max_e = n_seeds * (fanouts[0] + fanouts[0] * fanouts[1])
    n = store.n_vertices
    prior_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    gen = torch.Generator(device=device).manual_seed(seed + 30)

    def tables():  # features on the card; labels a linear threshold of them
        feat = torch.randn((n, d_feat), generator=gen, device=device)
        return feat, (feat @ torch.randn(d_feat, generator=gen, device=device) > 0).int()

    (feat_table, label_table), table_s = wall(tables, device)
    cfg = gnn_config(GNN_ARCH)
    params = G.init_gnn(cfg, gen, d_feat, device=device)
    opt = adamw.init(params)
    params0, opt0 = params, opt  # the update makes new tensors: these stay step 0's
    step_fn = make_gnn_train_step(cfg, n_nodes=max_n, lr=GNN_LR)
    rng = np.random.default_rng(seed + 31)

    stop, write_errors, writes = threading.Event(), [], [0]

    def writer():
        stream = GraphUpdateStream(n, batch=128, seed=42)
        try:
            while not stop.is_set():
                u = stream[writes[0]]
                store.insert_edges(u["insert"])
                store.delete_edges(u["delete"])
                writes[0] += 1
                time.sleep(0.002)
        except Exception as exc:  # re-raised on the main thread
            write_errors.append(exc)

    # the timed steps: every step but the profiled one, without step 0's
    # sampled-edge check (the CPU route runs after the loop)
    profiled, check_s, profiled_iter_s = GNN_STEPS // 2, 0.0, 0.0
    commits0 = store.stats["commits"]
    w = threading.Thread(target=writer, name="gnn writer", daemon=True)
    losses, parts, sizes, checks = [], {"sample": [], "gather": [], "step": []}, [], {}
    t_loop = time.perf_counter()
    w.start()
    try:
        for it in range(GNN_STEPS):
            t0 = time.perf_counter()
            with store.read_view() as view:
                sampler = NeighborSampler(view.scan, fanouts=list(fanouts), seed=seed * 1000 + it)
                sub = sampler.sample(rng.choice(n, n_seeds, replace=False).astype(np.int64))
                nodes, src, dst, nmask, emask = pad_subgraph(sub, max_n, max_e)
                if it == 0:
                    tc = time.perf_counter()
                    checks["sampled_edges_checked"] = check_sampled_edges(view, sub, rng)
                    check_s = time.perf_counter() - tc
            sample_s = time.perf_counter() - t0 - (check_s if it == 0 else 0.0)
            sizes.append((sub.n_nodes, len(sub.merged_edges()[0])))

            def gather():
                idx = torch.from_numpy(nodes).to(device)
                return {"feats": feat_table[idx] * torch.from_numpy(nmask).to(device)[:, None],
                        "labels": label_table[idx], "src": torch.from_numpy(src).to(device),
                        "dst": torch.from_numpy(dst).to(device),
                        "emask": torch.from_numpy(emask).to(device),
                        "lmask": (torch.arange(max_n, device=device) < sub.n_seeds).float()}

            batch, gather_s = wall(gather, device)
            if it == 0:
                first = batch
            run = lambda: step_fn(params, opt, batch["feats"], batch["src"], batch["dst"],
                                  batch["emask"], batch["labels"], batch["lmask"])
            if it == profiled:
                out = []
                busy_ms, prof_ms, _ = profiled_step(lambda: out.append(run()), device,
                                                    host_ops=False)
                params, opt, metrics = out[0]
                profiled_iter_s = time.perf_counter() - t0  # the profiler's set-up included
            else:
                (params, opt, metrics), step_s = wall(run, device)
                for part, secs in zip(parts, (sample_s, gather_s, step_s)):
                    parts[part].append(secs)
            losses.append(float(metrics["loss"]))
    finally:
        stop.set()
        w.join(timeout=JOIN_S)
    loop_s = time.perf_counter() - t_loop
    if w.is_alive():
        raise AssertionError("the GNN writer did not stop")
    if write_errors:
        raise write_errors[0]
    commits = store.stats["commits"] - commits0
    timed_s = sum(sum(v) for v in parts.values())
    _, quiet_s = wall(run, device)  # the last step again, no writer holding the GIL
    step_cost, count_s = wall(lambda: count_step(run)[1], device)  # once more, counted
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite GNN loss: {losses}")
    k = min(5, GNN_STEPS // 2)
    if not np.mean(losses[-k:]) < np.mean(losses[:k]):
        raise AssertionError(f"gin-tu did not learn: {losses}")

    # step 0 of gin-tu and one step each of the other three on step 0's
    # batch: the card side now, the CPU route on host copies in the background
    models = {GNN_ARCH: (cfg, params0)}
    others = {}
    for arch in GNN_OTHER:
        ocfg = gnn_config(arch)
        oparams = G.init_gnn(ocfg, gen, d_feat, device=device)
        models[arch] = (ocfg, oparams)
        if arch in GNN_CHECK_LAYERS:  # the checked model cut in depth; the step below is whole
            # drawn from a generator of its own, so the models after it keep
            # the parameters their limits were measured on
            ccfg = dataclasses.replace(ocfg, n_layers=GNN_CHECK_LAYERS[arch])
            cgen = torch.Generator(device=device).manual_seed(seed + 13)
            models[arch] = (ccfg, G.init_gnn(ccfg, cgen, d_feat, device=device))
        ostep = make_gnn_train_step(ocfg, n_nodes=max_n, lr=GNN_LR)
        (_, _, om), ostep_s = wall(lambda: ostep(
            oparams, adamw.init(oparams), first["feats"], first["src"], first["dst"],
            first["emask"], first["labels"], first["lmask"]), device)
        if not math.isfinite(float(om["loss"])):
            raise AssertionError(f"{arch}: non-finite loss")
        others[arch] = dict(step_s=ostep_s, flops=gnn_model_flops(ocfg, max_n, max_e, d_feat))
    card = {arch: gnn_card_routes(c, p, first, max_n, device, f32_fault=arch == GNN_ARCH)
            for arch, (c, p) in models.items()}
    def host(t):
        return t.detach().cpu()

    first_cpu = {k: host(t) for k, t in first.items()}
    cpu_params = {arch: (c, tree_map(host, p)) for arch, (c, p) in models.items()}
    join_cpu = in_background(lambda: {
        arch: gnn_cpu_routes(c, p, first_cpu, max_n, f32=arch == GNN_ARCH)
        for arch, (c, p) in cpu_params.items()}, "gnn CPU route")
    t_beside = time.perf_counter()

    with tempfile.TemporaryDirectory() as tmp:
        saver = ckpt.AsyncCheckpointer(tmp)
        _, save_s = wall(lambda: (saver.save(GNN_STEPS - 1, (params, opt)), saver.wait()),
                         device)
        (p_back, o_back), meta = ckpt.restore(tmp, (params, opt))
    same = [torch.equal(a, b) for a, b in zip(
        tree_leaves(p_back) + tree_leaves(o_back.mu) + tree_leaves(o_back.nu) + [o_back.step],
        tree_leaves(params) + tree_leaves(opt.mu) + tree_leaves(opt.nu) + [opt.step])]
    if not all(same) or meta["step"] != GNN_STEPS - 1:
        raise AssertionError("the (params, AdamWState) checkpoint did not restore bitwise")
    _, invariants_s = wall(store.check_invariants, device)
    beside_s = time.perf_counter() - t_beside
    cpu, cpu_route_s = join_cpu()

    checks[GNN_ARCH] = hold_gnn_step(cfg, card[GNN_ARCH], cpu[GNN_ARCH])
    cpu_loss0 = float(cpu[GNN_ARCH]["routes"]["f32"][0])
    checks["loop_step0_loss_rel_err"] = abs(losses[0] - cpu_loss0) / abs(cpu_loss0)
    if not checks["loop_step0_loss_rel_err"] <= GNN_LOSS_RTOL:
        raise AssertionError(f"the loop's step 0 loss {losses[0]} vs CPU {cpu_loss0}")
    checks["adamw_max_abs_err"] = hold_adamw(params0, opt0, cpu[GNN_ARCH]["routes"]["f32"][1],
                                             device)
    for arch in GNN_OTHER:
        others[arch].update(hold_gnn_step(models[arch][0], card[arch], cpu[arch]))

    med = {p: float(np.median(v)) for p, v in parts.items()}
    flops = gnn_model_flops(cfg, max_n, max_e, d_feat)
    emit_roofline("gnn_train_roofline", step_cost, count_s, GNN_ARCH, "minibatch_lg",
                  "float32", flops, measured_step_s=med["step"],
                  measured_step_without_writer_s=quiet_s)
    nodes_e = np.array(sizes)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    del feat_table, label_table, first, batch, models, card
    free_device(device)
    emit("gnn_train", arch=GNN_ARCH, cell="minibatch_lg", graph_vertices=n,
         published_graph=[cell["n_nodes"], cell["n_edges"]], seeds=n_seeds,
         fanouts=fanouts, d_feat=d_feat, max_nodes=max_n, max_edges=max_e, steps=GNN_STEPS,
         lr=GNN_LR, losses=losses, table_s=table_s, median_s=med,
         step_without_writer_s=quiet_s, timed_steps=len(parts["step"]), timed_s=timed_s,
         steps_per_s=len(parts["step"]) / timed_s,
         seeds_per_s=len(parts["step"]) * n_seeds / timed_s, loop_s=loop_s,
         profiled_iter_s=profiled_iter_s, sampled_edges_check_s=check_s,
         sampled_nodes=[int(nodes_e[:, 0].min()), float(nodes_e[:, 0].mean()),
                        int(nodes_e[:, 0].max())],
         sampled_edges=[int(nodes_e[:, 1].min()), float(nodes_e[:, 1].mean()),
                        int(nodes_e[:, 1].max())],
         commits=commits, commits_per_s=commits / loop_s, writer_batches=writes[0],
         profiled_step_ms=prof_ms, device_busy_ms=busy_ms,
         device_idle_share=None if busy_ms is None else 1 - busy_ms / prof_ms,
         step_flops=flops, step_tflops_per_s=flops / med["step"] / 1e12,
         f32_peak_share=f32_peak_share(flops, med["step"]),
         f32_peak_share_without_writer=f32_peak_share(flops, quiet_s),
         checks=checks, checkpoint_save_s=save_s, check_invariants_s=invariants_s,
         cpu_route_s=cpu_route_s, beside_cpu_route_s=beside_s,
         other_models=others, peak_allocated_bytes=peak)
    return prior_peak


def phase_durability(seed, device) -> None:
    """Phase 5b: WAL, checkpoint and recovery of a tiered store on the
    card; the recovered view held against the live one and, entry point
    by entry point, against the same layout on the CPU route."""
    import os
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core import RapidStore
    from repro_torch.core.analytics import triangle_count_view
    from repro_torch.core.wal import WriteAheadLog

    cpu = torch.device("cpu")
    store, info = build_store(DUR_SCALE, seed, device, leaf_tiers=DUR_TIERS)
    rng = np.random.default_rng(seed + 30)
    with store.read_view() as v:
        batches = random_writes(v, rng, DUR_WRITES + DUR_MORE)
    ckpt_s = []
    checkpoint = store.checkpoint

    def timed_checkpoint(directory):
        t0 = time.perf_counter()
        ts = checkpoint(directory)
        ckpt_s.append(time.perf_counter() - t0)
        return ts

    store.checkpoint = timed_checkpoint  # the compactor's checkpoint cycle calls it
    with tempfile.TemporaryDirectory(prefix="chip_smoke_durability_") as root:
        wal_path = os.path.join(root, "wal.log")
        store.attach_wal(wal_path)  # fsync on every commit
        comp = store.attach_compactor(checkpoint_dir=os.path.join(root, "checkpoints"))
        store.attach_write_pipeline()
        t0 = time.perf_counter()
        for t in [store.apply_async(i, d) for i, d in batches[:DUR_WRITES]]:
            t.wait()
        write_s = time.perf_counter() - t0
        report, fold_s = wall(lambda: comp.compact_once(checkpoint=True), device)
        t0 = time.perf_counter()
        for t in [store.apply_async(i, d) for i, d in batches[DUR_WRITES:]]:
            t.wait()
        store.flush()
        more_s = time.perf_counter() - t0
        wal_bytes = store.wal.size_bytes()
        store.detach_write_pipeline()
        store.detach_compactor()
        store.detach_wal()
        _, records, clean = WriteAheadLog.replay(wal_path)
        live = store.begin_read()
        rec, rec_s = wall(lambda: RapidStore.recover(root, attach=False, device=device),
                          device)
        twin, twin_s = wall(lambda: RapidStore.recover(root, attach=False, device="cpu"),
                            device)
    if rec.device.type != device.type or not clean:
        raise AssertionError("recovery left the device or found a torn log")
    rh, th = rec.begin_read(), twin.begin_read()
    L, R, C = live.view, rh.view, th.view
    _, blocks_s = wall(R.to_leaf_blocks_device, device)
    _, coo_s = wall(R.to_coo_device, device)
    tiers = sorted(R.to_leaf_blocks_device().groups)
    if tiers != list(DUR_TIERS):
        raise AssertionError(f"the recovered store's device tiles hold tiers {tiers}")
    for a, b in zip(L.to_coo(), R.to_coo()):
        if not np.array_equal(a, b):
            raise AssertionError("the recovered edge set differs from the live one")
    for a, b in zip(stream_arrays(R), stream_arrays(C)):
        if not np.array_equal(a, b):
            raise AssertionError("two recoveries differ in their leaf streams")

    # answers that do not depend on the layout: the live view on the card
    # (the tile-indexed ones are not: L's tile indices do not name R's tiles)
    layout_free = ("edge_search_view", "spmm_view", "pagerank_view", "bfs_view",
                   "sssp_view", "wcc_view")
    ops = make_operands(L, seed + 31, device, n_pairs=DUR_PAIRS, d=DUR_D)
    res_l, _ = run_entry_points(L, ops, device, layout_free)
    res_r, _ = run_entry_points(R, ops, device, layout_free)
    tri_l, tri_l_s = wall(lambda: triangle_count_view(L), device)
    tri_r, tri_r_s = wall(lambda: triangle_count_view(R), device)
    if tri_l != tri_r:
        raise AssertionError(f"triangle_count_view: recovered {tri_r} != live {tri_l}")
    live_err = hold(res_l, res_r, layout_free)
    del res_l, res_r

    # every entry point on R on the card against the same layout on the CPU
    ops = make_operands(R, seed + 32, device, n_pairs=DUR_PAIRS, d=DUR_D)
    res_r, secs_r = run_entry_points(R, ops, device)
    chk = check_results(R, ops, res_r)
    ops_c = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in ops.items()}
    res_c, secs_c = run_entry_points(C, ops_c, cpu)
    cpu_err = hold(res_c, res_r, ENTRY_POINTS)
    # the triangle count's plain route intersects every tile pair's
    # [Ba, Bb] ids on the host, too slow here: a host count of the same sum
    tri_host, tri_host_s = wall(lambda: full_neighbour_triangles(C.to_csr()), device)
    if tri_host != tri_r:
        raise AssertionError(f"triangle_count_view {tri_r} != host count {tri_host}")
    for h, s in ((live, store), (rh, rec), (th, twin)):
        s.end_read(h)
    emit("durability", scale=DUR_SCALE, leaf_tiers=list(DUR_TIERS), **info,
         writes=DUR_WRITES, writes_after_checkpoint=DUR_MORE, write_s=write_s,
         more_s=more_s, fold_and_checkpoint_s=fold_s, checkpoint_s=ckpt_s,
         report={k: v for k, v in vars(report).items() if k != "repacked"},
         repacked=len(report.repacked), wal_bytes=wal_bytes, wal_records=len(records),
         wal_replayed=rec.stats["wal_replayed"],
         tier_migrations=store.stats.get("tier_migrations", 0),
         tier_migrations_held=store.stats.get("tier_migrations_held", 0),
         recover_s=rec_s, recover_cpu_s=twin_s, r_cold_blocks_s=blocks_s, r_cold_coo_s=coo_s,
         tiers=tiers, triangles=tri_r,
         triangle_s={"live": tri_l_s, "recovered": tri_r_s, "host": tri_host_s},
         r_checks=chk, live_vs_recovered=live_err, card_vs_cpu=cpu_err,
         r_query_s=secs_r, cpu_query_s=secs_c)


def full_neighbour_triangles(csr, chunk: int = 1 << 22) -> int:
    """``triangle_count_view``'s function on the host, by another
    algorithm: the sum over edges (u, v), u < v, of |N(u) & N(v)| over the
    full out-neighbour lists, divided by 3.  Each edge's shorter list is
    probed in the sorted edge keys u * n + w (``torch.searchsorted`` on
    the CPU), ``chunk`` probes at a time."""
    import numpy as np
    import torch

    off = np.asarray(csr.offsets, np.int64)
    idx = np.asarray(csr.indices, np.int64)
    n = len(off) - 1
    deg = np.diff(off)
    src = np.repeat(np.arange(n, dtype=np.int64), deg)
    keys = torch.from_numpy(src * n + idx)  # sorted: rows in order, each sorted
    fwd = idx > src
    a, b = src[fwd], idx[fwd]
    swap = deg[b] < deg[a]
    a, b = np.where(swap, b, a), np.where(swap, a, b)
    da = deg[a]
    ends = np.cumsum(da)
    total, lo = 0, 0
    while lo < len(a):
        start = int(ends[lo - 1]) if lo else 0
        hi = max(lo + 1, int(np.searchsorted(ends, start + chunk, "right")))
        ca, cb, cd = a[lo:hi], b[lo:hi], da[lo:hi]
        rank = np.arange(int(cd.sum()), dtype=np.int64) - np.repeat(np.cumsum(cd) - cd, cd)
        q = torch.from_numpy(np.repeat(cb, cd) * n + idx[np.repeat(off[ca], cd) + rank])
        pos = torch.searchsorted(keys, q).clamp_(max=len(keys) - 1)
        total += int((keys[pos] == q).sum())
        lo = hi
    return total // 3


def stream_arrays(view):
    s = view.to_leaf_stream()
    return (s.data, s.leaf_offsets, s.leaf_lens, s.leaf_keys, s.leaf_tiers)


# integers bitwise; float sums within the North star's tolerances (rtol = atol)
TOLERANCE = {"leaf_scan_reduce_view": 1e-5, "pagerank_view": 1e-5,
             "leaf_spmm_view": 1e-4, "spmm_view": 1e-4}


def hold(want: dict, got: dict, names) -> dict:
    """``got`` against ``want`` per entry point: bitwise for integers and
    SSSP, within ``TOLERANCE`` for float sums; returns the largest
    absolute difference of each float entry point."""
    import numpy as np
    import torch

    errs = {}
    for name in names:
        w, g = want[name], got[name]
        if isinstance(w, torch.Tensor):
            w, g = w.cpu(), g.cpu()
        else:
            w, g = torch.as_tensor(np.asarray(w)), torch.as_tensor(np.asarray(g))
        tol = TOLERANCE.get(name)
        if tol is None:
            if not torch.equal(w, g):
                raise AssertionError(f"{name} differs bitwise")
            continue
        torch.testing.assert_close(g, w, rtol=tol, atol=tol, msg=lambda m, n=name: f"{n}: {m}")
        errs[name] = float((g.double() - w.double()).abs().max()) if w.numel() else 0.0
    return errs


class HostTriangles:
    """``triangle_count_fast`` on a CSR's arrays in a child process, so that
    the host count (about a minute at scale 18) runs beside the phases
    after it.  ``result()`` waits for the child and returns (count,
    seconds); ``close()`` kills a child still running and removes its
    files."""

    CODE = ("import json, sys, time, types; import numpy as np; "
            "sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.core.analytics import triangle_count_fast; "
            "csr = types.SimpleNamespace(offsets=np.load(sys.argv[2]), "
            "indices=np.load(sys.argv[3])); t0 = time.perf_counter(); "
            "n = triangle_count_fast(csr); "
            "print(json.dumps([int(n), time.perf_counter() - t0]))")

    def __init__(self, csr):
        import tempfile

        import numpy as np

        self._dir = tempfile.TemporaryDirectory()
        paths = [str(Path(self._dir.name) / f) for f in ("offsets.npy", "indices.npy")]
        np.save(paths[0], np.asarray(csr.offsets))
        np.save(paths[1], np.asarray(csr.indices))
        self._proc = subprocess.Popen(
            [sys.executable, "-c", self.CODE, str(ROOT / "src"), *paths],
            stdout=subprocess.PIPE, text=True)

    def result(self) -> tuple:
        out, _ = self._proc.communicate(timeout=JOIN_S)
        if self._proc.returncode:
            raise RuntimeError(f"the host triangle count exited {self._proc.returncode}")
        count, secs = json.loads(out)
        return count, secs

    def close(self) -> None:
        if self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait()
        self._dir.cleanup()


def phase_triangles(scale: int, seed: int, device):
    """Phase 6's counted part: triangle_count_view on a cold view, then on
    the warm view; returns the store, what was measured, and the host
    count started in a child process (``hold_host_triangles`` joins it)."""
    from repro_torch.core.analytics import triangle_count_view
    from repro_torch.kernels.intersect import intersect_count

    store, info = build_store(scale, seed, device, undirected=True)
    with store.read_view() as view:
        n0 = intersect_count.launches
        tc, dev_s = wall(lambda: triangle_count_view(view), device)
        launches = intersect_count.launches - n0
        tc_warm, warm_s = wall(lambda: triangle_count_view(view), device)
        host = HostTriangles(view.to_csr())
        n_leaves = view.to_leaf_blocks_device().n_blocks
    if tc != tc_warm:
        host.close()
        raise AssertionError(f"triangle_count_view: cold {tc} != warm {tc_warm}")
    return store, dict(scale=scale, **info, n_leaves=n_leaves, triangles=tc,
                       device_s=dev_s, device_warm_s=warm_s,
                       launches_per_call=launches), host


# ---------------------------------------------------------------------------
# Phase 6m: the shard plane over processes; phase 6b: the comparison stores
# ---------------------------------------------------------------------------
def rank_cmd(init: str, backend: str, seed: int, device, out: str) -> list:
    """One rank of ``repro_torch.launch.plane`` on phase 6's store."""
    return [sys.executable, "-m", "repro_torch.launch.plane", "--scale", str(TC_SCALE),
            "--seed", str(seed), "--shards", str(MP_SHARDS), "--txns", str(MP_TXNS),
            "--d", str(D_FEATURES), "--device", device.type, "--backend", backend,
            "--deterministic", "--init", init, "--out", out]


def hold_ranks(backend: str, got: dict, want: dict) -> dict:
    """One rank's saved answers against this process's: the ``BITWISE``
    answers by digest, push-PageRank by ``hold_pagerank``."""
    from repro_torch.launch.plane import BITWISE, STEPS

    errs = {}
    for step in STEPS:
        for key in BITWISE:
            if got[f"{step}_digest"][key] != want[f"{step}_digest"][key]:
                raise AssertionError(f"multiprocess {backend}: {step} {key} differs bitwise "
                                     "from the one-process plane")
        errs[step] = hold_pagerank(got[f"{step}_pagerank_push"],
                                   want[f"{step}_pagerank_push"],
                                   f"multiprocess {backend} {step} push")
    return errs


def phase_multiprocess(store, seed, device) -> dict:
    """Phase 6m on phase 6's store (undirected R-MAT of ``TC_SCALE``): the
    shard plane over processes, one store a rank (``launch.plane``, all
    ranks of a run within ``MP_TIMEOUT``).  First this process runs the
    sequence on ``store`` through a one-process plane (shard k on card
    k % n_cards); with several cards, again on a fresh store of the same
    seed with every shard on ``cuda:0``, every answer (push-PageRank too)
    bitwise the first run's; then (a) ``nccl``, one rank a visible card;
    then (b) ``gloo``, ``MP_RANKS`` ranks on cards ``rank % n_cards`` (all
    on ``cuda:0`` with one card): one after another, so that no run's
    seconds share a card or the host with another's.  Every rank builds
    the seeded store, attaches a ``MP_SHARDS``-shard plane over the ranks
    (shard k on rank k % world) and runs PageRank (pull and push), BFS,
    SSSP, WCC and SpMM
    (d = ``D_FEATURES``), commits ``MP_TXNS`` transactions on shard 1 and
    runs them again, migrates subgraphs between the ranks' shards
    (``cross_moves``), commits ``MP_TXNS`` on the moved subgraphs and runs
    them a third time.  All in deterministic mode (``index_add_`` in a
    fixed order): every rank's BFS, SSSP, WCC, SpMM and pull-PageRank
    bitwise this process's, push-PageRank within ``hold_pagerank``'s
    limits, each rank's placement after the moves this process's, its
    migrated view rebuilt across the epoch, its ``leaf_spmm`` launches
    above 0."""
    import os
    import tempfile

    import torch

    from repro_torch.launch.mesh import Mesh, make_shard_mesh
    from repro_torch.launch.plane import (BITWISE, STEPS, drive, rmat_store, spawn_ranks,
                                          summary)

    path = [str(ROOT / "src")] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                                  if p]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(path))
    runs = [("one process", store, make_shard_mesh(MP_SHARDS, device=device))]
    if device.type == "cuda" and n_cards() > 1:
        runs.append(("one process, one card", rmat_store(TC_SCALE, seed, device)[0],
                     Mesh([device] * MP_SHARDS, (MP_SHARDS,), ("shard",))))
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for name, st, mesh in runs:
            got, got_s = wall(lambda: drive(st, mesh, seed, MP_TXNS, D_FEATURES), device)
            line = summary(got)
            emit("multiprocess", backend=name, world=1, seconds=got_s,
                 devices=[str(d) for d in mesh.flat_devices],
                 **{k: v for k, v in line.items() if k.endswith("_s") or k.startswith("uploads")},
                 moves=len(got["moves"]), migration_rebuilds=got["migration_rebuilds"],
                 leaf_spmm_launches=got["leaf_spmm_launches"])
            if name == "one process":
                one, want = got, line
            elif any(line[f"{step}_digest"] != want[f"{step}_digest"] for step in STEPS):
                raise AssertionError("multiprocess: the plane over the cards and the plane on "
                                     "one card differ")
    finally:
        torch.use_deterministic_algorithms(was)
    del runs
    # nccl needs the card (a CPU rehearsal runs the gloo ranks alone)
    worlds = {"nccl": torch.cuda.device_count()} if device.type == "cuda" else {}
    worlds["gloo"] = MP_RANKS
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        for backend, world in worlds.items():
            outs, secs = wall(lambda: spawn_ranks(
                rank_cmd(f"file://{tmp}/{backend}.init", backend, seed, device,
                         f"{tmp}/{backend}"), world, MP_TIMEOUT, env=env), device)
            ranks = [json.loads(o.strip().splitlines()[-1]) for o in outs]
            errs = []
            for r, line in enumerate(ranks):
                if (line["rank"], line["backend"], line["world"]) != (r, backend, world):
                    raise AssertionError(f"multiprocess {backend}: rank {r} printed {line}")
                if device.type == "cuda" and not line["leaf_spmm_launches"] > 0:
                    raise AssertionError(f"multiprocess {backend}: rank {r} launched no "
                                         "leaf_spmm")
                got = torch.load(f"{tmp}/{backend}/rank{r}.pt")
                if got["placement_migrated"] != one["placement_migrated"] or \
                        got["migration_rebuilds"] != one["migration_rebuilds"]:
                    raise AssertionError(f"multiprocess {backend}: rank {r}'s migration "
                                         "differs from the one-process plane's")
                errs.append(hold_ranks(backend, got, want))
            report[backend] = dict(world=world, seconds=secs,
                                   leaf_spmm_launches=[x["leaf_spmm_launches"] for x in ranks],
                                   pagerank_push_errs=errs)
            emit("multiprocess", backend=backend, world=world, seconds=secs,
                 bitwise=list(BITWISE), pagerank_push_errs=errs, ranks=ranks)
    return report


def phase_baselines(store, seed, device) -> dict:
    """Phase 6b on phase 6's store (after 6m's writes): the paper's
    comparison stores (``repro_torch.core.baselines``, host numpy) built
    from the view's edges: ``CSRGraph``, ``PerEdgeVersionedAdjacency`` and
    ``VecStore``.  ``BASE_QUERIES`` present and as many absent edge
    searches and ``BASE_SCANS`` scans on each, equal to the store's device
    ``edge_search_view`` and to the view's CSR; then ``BASE_TXNS``
    transactions on the store and on ``PerEdgeVersionedAdjacency``, a view
    pinned at each commit: at the end every pinned view's searches (on the
    card) and scans equal the per-edge store's at the matching timestamp.
    Build seconds and ``memory_bytes()`` are host figures, printed beside
    the view's device bytes."""
    import numpy as np

    from repro_torch.configs import CONFIG
    from repro_torch.core.baselines import CSRGraph, PerEdgeVersionedAdjacency, VecStore
    from repro_torch.kernels.leaf_search import edge_search_view

    rng = np.random.default_rng(seed + 70)
    with store.read_view() as view:
        n = view.n_vertices
        src, dst = view.to_coo()
        edges = np.stack([src, dst.astype(np.int64)], 1)
        csr = view.to_csr()
        host = {}
        for name, build in (("csr", lambda: CSRGraph.from_edges(n, edges)),
                            ("per_edge", lambda: PerEdgeVersionedAdjacency.from_edges(n, edges)),
                            ("vec", lambda: VecStore.from_edges(n, edges,
                                                                CONFIG.partition_size))):
            t0 = time.perf_counter()
            host[name] = (build(), time.perf_counter() - t0)
        pick = rng.choice(len(src), BASE_QUERIES, replace=False)
        us = np.concatenate([src[pick], rng.integers(0, n, BASE_QUERIES)]).astype(np.int64)
        vs = np.concatenate([dst[pick], rng.integers(0, n, BASE_QUERIES)]).astype(np.int64)
        found, search_s = wall(lambda: edge_search_view(view, us, vs), device)
        seg = [csr.indices[csr.offsets[u]:csr.offsets[u + 1]] for u in us]
        want = np.array([bool(np.isin(v, s)) for v, s in zip(vs, seg)])
        if not np.array_equal(found, want):
            raise AssertionError("baselines: edge_search_view disagrees with the view's CSR")
        scan_us = rng.choice(n, BASE_SCANS, replace=False)
        report = {"searches": len(us), "present": int(found.sum()), "scans": BASE_SCANS,
                  "device_search_s": search_s, "stores": {}}
        blocks, coo = view.to_leaf_blocks_device(), view.to_coo_device()
        device_bytes = sum(int(t.nbytes) for t in (blocks.src, blocks.rows, blocks.length)) \
            + sum(int(t.nbytes) for t in coo)
        for name, (b, build_s) in host.items():
            t0 = time.perf_counter()
            got = (b.search_many(us, vs) if name == "csr"
                   else np.array([b.search(int(u), int(v)) for u, v in zip(us, vs)]))
            searches_s = time.perf_counter() - t0
            if not np.array_equal(got, found):
                raise AssertionError(f"baselines: {name} searches differ from the store's")
            t0 = time.perf_counter()
            scans = [b.neighbors(u) if name == "csr" else b.scan(int(u)) for u in scan_us]
            scans_s = time.perf_counter() - t0
            for u, got_s in zip(scan_us, scans):
                if not np.array_equal(got_s, csr.indices[csr.offsets[u]:csr.offsets[u + 1]]):
                    raise AssertionError(f"baselines: {name} scan of {u} differs from the CSR")
            memory = (b.offsets.nbytes + b.indices.nbytes if name == "csr"  # no memory_bytes
                      else b.memory_bytes())
            report["stores"][name] = dict(host_build_s=build_s, host_memory_bytes=int(memory),
                                          host_searches_s=searches_s, host_scans_s=scans_s)
        report["view_device_bytes"] = device_bytes
        report["store_memory_bytes"] = store.memory_bytes()
        txns = random_writes(view, rng, BASE_TXNS)

    per_edge = host["per_edge"][0]
    pinned = []
    try:
        for ins, dels in txns:
            dset = set(map(tuple, dels.tolist()))
            ins = np.array([e for e in ins.tolist() if tuple(e) not in dset], np.int64)
            ts = store.apply(ins, dels)
            per_edge.insert_edges(ins)
            t_pe = per_edge.delete_edges(dels)
            pinned.append((store.begin_read(), ts, t_pe, ins, dels))
        checked = 0
        for handle, ts, t_pe, ins, dels in pinned:
            view = handle.view
            if view.ts != ts:
                raise AssertionError(f"baselines: the view pinned after commit {ts} "
                                     f"is at {view.ts}")
            q = np.concatenate([ins, dels])
            got = edge_search_view(view, q[:, 0], q[:, 1])
            want = np.array([per_edge.search(int(u), int(v), t_pe) for u, v in q])
            if not np.array_equal(got, want):
                raise AssertionError(f"baselines: searches at ts {ts} differ from the "
                                     f"per-edge store's at {t_pe}")
            for u in np.unique(q[:, 0])[:64]:
                if not np.array_equal(view.scan(int(u)), per_edge.scan(int(u), t_pe)):
                    raise AssertionError(f"baselines: scan of {u} at ts {ts} differs")
            checked += len(q)
    finally:
        for handle, *_ in pinned:
            store.end_read(handle)
    report.update(txns=len(txns), timestamps=[(ts, t_pe) for _, ts, t_pe, _, _ in pinned],
                  txn_searches_checked=checked)
    emit("baselines", **report)
    return report


def hold_host_triangles(host: HostTriangles, info: dict) -> None:
    """Phase 6's host check, joined after the model phases:
    ``triangle_count_fast`` on the same view's CSR equals the card's count."""
    want, host_s = host.result()
    if want != info["triangles"]:
        raise AssertionError(f"triangle_count_view {info['triangles']} != "
                             f"triangle_count_fast {want}")
    emit("triangles_host", scale=info["scale"], triangles=want, host_fast_s=host_s)


def triangle_split(store, info: dict, device) -> None:
    """Phase 6's split, after the counted calls: triangle_count_view's steps
    on the warm view, each timed on its own (host clock, device drained):
    the host enumeration of the tile pairs, the uploads of their indices in
    the call's batches, and the kernel's summed device time (CUDA events
    around the loop of launches on the uploaded indices, no host work
    between them), each step through the same functions
    ``sum_intersect_tiles_view`` runs (``ops._pair_index``,
    ``ops._count_pairs``, batches of ``ops.SUM_BATCH``).  ``rest`` is what
    the warm call took beyond the three, ``cold_extra`` what the first call
    took beyond the warm one (the view's tile upload and host CSR).  Prints
    the ``triangles`` line."""
    import torch

    from repro_torch.core.analytics import triangle_tile_pairs
    from repro_torch.kernels.intersect import ops as intersect_ops

    batch = intersect_ops.SUM_BATCH
    with store.read_view() as view:
        (ia, ib), enum_s = wall(lambda: triangle_tile_pairs(view), device)
        dev = view.to_leaf_blocks_device()
        if getattr(dev, "groups", None) is not None:
            raise AssertionError("the triangle store is tiered: the split assumes one tier")
        idx, upload_s = wall(lambda: [intersect_ops._pair_index(ia[lo:lo + batch],
                                                                ib[lo:lo + batch], device)
                                      for lo in range(0, len(ia), batch)], device)
        intersect_ops._count_pairs(dev, idx[0])  # warm
        counts, kernel_s = device_seconds(
            lambda: [intersect_ops._count_pairs(dev, i) for i in idx], device)
        total = int(sum(c.sum(dtype=torch.int64) for c in counts))
        if total != 3 * info["triangles"]:
            raise AssertionError(f"the split's pair count, {total}, "
                                 f"!= 3 x {info['triangles']}")
    pairs = len(ia)
    warm = info["device_warm_s"]
    emit("triangles", **info, pairs=pairs, pairs_per_launch=batch,
         launches_split=len(idx),
         split_s={"host_enumeration": enum_s, "index_uploads": upload_s,
                  "kernel_device": kernel_s,
                  "rest": warm - enum_s - upload_s - kernel_s,
                  "cold_extra": info["device_s"] - warm},
         kernel_ms_per_launch=kernel_s * 1e3 / len(idx))


# ---------------------------------------------------------------------------
# Phases 7-9: the model paths
# ---------------------------------------------------------------------------
def model_configs():
    from repro_torch.configs import registry

    get = registry.get_smoke_config if MODEL_SMOKE else registry.get_config
    return get(LM_ARCH), get("bst")


def recsys_train_ids(cfg, i: int, seed: int):
    """Batch ``i`` of ``RecsysBatches`` at ``BST_TRAIN_BATCH``: history and
    target ids as the forward looks them up, [B * (seq_len + 1)] int32."""
    import numpy as np

    from repro_torch.data.pipeline import RecsysBatches

    b = RecsysBatches(cfg.n_items, BST_TRAIN_BATCH, cfg.seq_len, cfg.n_other_feats, seed=seed)[i]
    return np.concatenate([b["hist"], b["target"][:, None]], axis=1).reshape(-1)


def free_device(device) -> None:
    import gc

    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def plain_lookup(table, ids):
    """The BST lookup through embedding_bag's plain version (bags of one)."""
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

    return embedding_bag_ref(table, ids.reshape(-1, 1)).reshape(*ids.shape, table.shape[1])


def phase_model_kernels(seed: int, device) -> dict:
    """flash_decode and embedding_bag against their plain versions at the
    model paths' shapes (phase 7)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref

    lm, rec = model_configs()
    out = {}
    g = torch.Generator(device=device).manual_seed(seed + 20)
    rng = np.random.default_rng(seed + 20)

    def record(name, shape, err, ms, plain_ms, library_ms, nbytes, nops, **extra):
        b_ms, b_by = bound(nbytes, nops)
        rec_ = dict(name=name, shape=list(shape), max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    library_ms=library_ms, bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes,
                    **extra)
        emit("kernel", **rec_)
        return rec_

    # -- flash_decode: q [B, KV, G, dh] f32 against the cache.  Each case is
    # checked against the plain version and timed beside SDPA (GQA, a length
    # mask) on the same inputs; the kernels line takes the decode_32k path.
    from repro_torch.kernels.flash_decode import ops as decode_ops

    def sdpa_fn(q, k, v, kv_len):
        """SDPA over [B, H, 1, dh] x [B, KV, S, dh] in K/V's type."""
        b_, s_, kv_, dh_ = k.shape
        qh = q.reshape(b_, -1, 1, dh_).to(k.dtype)
        kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        mask = (torch.arange(s_, device=device)[None, :] < kv_len[:, None])[:, None, None, :]
        return lambda: F.scaled_dot_product_attention(qh, kt, vt, attn_mask=mask,
                                                      enable_gqa=True)

    def decode_case(q, k, v, kv_len, softcap=None, plain_reps=5):
        got = flash_decode(q, k, v, kv_len, softcap=softcap)
        want = flash_decode_ref(q, k, v, kv_len, softcap=softcap)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)
        b_, s_, kv_, dh_ = k.shape
        live = int(kv_len.clamp(0, s_).sum())
        esz = k.element_size()
        res = dict(shape=[b_, s_, kv_, q.shape[2], dh_], dtype=str(k.dtype).split(".")[-1],
                   route=decode_ops.route(k.dtype, dh_), softcap=softcap,
                   kv_len=kv_len.tolist(), live_positions=live,
                   max_abs_err=max_abs_err(got, want),
                   ms=time_ms(lambda: flash_decode(q, k, v, kv_len, softcap=softcap),
                              device, 50, graph=True),
                   plain_ms=time_ms(lambda: flash_decode_ref(q, k, v, kv_len, softcap=softcap),
                                    device, plain_reps),
                   library_ms=None if softcap else time_ms(sdpa_fn(q, k, v, kv_len), device,
                                                           20))
        b_ms, b_by = bound(live * kv_ * dh_ * esz * 2 + q.numel() * 4 * 2 + b_ * 4,
                           live * kv_ * q.shape[2] * dh_ * 4)
        res.update(bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / res["ms"])
        emit("flash_decode_case", **res)
        return res

    kv, dh = lm.n_kv_heads, lm.d_head
    grp = lm.n_heads // kv
    b, s = DECODE_BATCH, DECODE_SEQ
    q = torch.randn((b, kv, grp, dh), generator=g, device=device)
    k = torch.randn((b, s, kv, dh), generator=g, device=device, dtype=torch.bfloat16)
    v = torch.randn((b, s, kv, dh), generator=g, device=device, dtype=torch.bfloat16)
    kv_len = torch.from_numpy(rng.integers(1, s + 1, b).astype(np.int32)).to(device)
    cases = {}
    # the decode_32k path's own launches: every row live up to the last step
    path_len = torch.full((b,), s - DECODE_STEPS + 1, dtype=torch.int32, device=device)
    cases["path"] = decode_case(q, k, v, path_len)
    cases["seeded"] = decode_case(q, k, v, kv_len)
    # softcap 50 (Gemma-2's) on the same grouping, small
    slen = torch.tensor([1000, 377], dtype=torch.int32, device=device)
    cases["softcap"] = decode_case(q[:2], k[:2, :1000].contiguous(), v[:2, :1000].contiguous(),
                                   slen, softcap=50.0)
    # the CUDA-core route: the same seeded inputs with f32 K/V
    kf, vf = k.float(), v.float()
    del k, v
    free_device(device)
    cases["f32_seeded"] = decode_case(q, kf, vf, kv_len)
    del kf, vf
    free_device(device)
    # dh 144, small: Gemma-2-27B's grouping (32 heads over 16 KV heads) and cap
    q2 = torch.randn((2, 16, 2, 144), generator=g, device=device)
    k2 = torch.randn((2, 4096, 16, 144), generator=g, device=device, dtype=torch.bfloat16)
    v2 = torch.randn((2, 4096, 16, 144), generator=g, device=device, dtype=torch.bfloat16)
    len2 = torch.tensor([4096, 2900], dtype=torch.int32, device=device)
    cases["dh144"] = decode_case(q2, k2, v2, len2)
    cases["dh144_softcap"] = decode_case(q2, k2, v2, len2, softcap=50.0)
    del q2, k2, v2
    # granite's serve path (lm_serve c): f32 K/V, dh 64, 3 query heads a KV
    # head, the launcher's cache of 128 rows at the last step's length
    gr = lm_config(GRANITE)
    gk = torch.randn((SERVE_BATCH, SERVE_MAX_SEQ, gr.n_kv_heads, gr.d_head), generator=g,
                     device=device)
    gv = torch.randn(gk.shape, generator=g, device=device)
    gq = torch.randn((SERVE_BATCH, gr.n_kv_heads, gr.n_heads // gr.n_kv_heads, gr.d_head),
                     generator=g, device=device)
    glen = torch.full((SERVE_BATCH,), SERVE_PROMPT + SERVE_DECODE, dtype=torch.int32,
                      device=device)
    cases["granite_serve"] = decode_case(gq, gk, gv, glen)
    del gq, gk, gv
    # phase 13's heads at full width over DECODE_SEQ rows: the serve
    # launcher's f32 route ("simt": rows of 36 and 20 words) at seeded
    # lengths, and the bf16 decode path ("mma") with every row live to its
    # last step; Gemma-2-27B's G 2, dh 144 with and without its softcap 50
    # (the library call has none), Qwen3-32B's G 8, dh 80
    from repro_torch.configs import registry

    for name, arch, b_, dtype, caps in (
            ("f32_dh144", "gemma2-27b", 2, torch.float32, (None, 50.0)),
            ("f32_dh80", "qwen3-32b", 2, torch.float32, (None,)),
            ("gemma2_decode", "gemma2-27b", WIDE_DECODE_BATCH["gemma2-27b"], torch.bfloat16,
             (50.0, None)),
            ("qwen3_decode", "qwen3-32b", WIDE_DECODE_BATCH["qwen3-32b"], torch.bfloat16,
             (None,))):
        wc = registry.get_config(arch)
        shape = (b_, s, wc.n_kv_heads, wc.d_head)
        wq = torch.randn((b_, wc.n_kv_heads, wc.n_heads // wc.n_kv_heads, wc.d_head),
                         generator=g, device=device)
        wk = torch.randn(shape, generator=g, device=device, dtype=dtype)
        wv = torch.randn(shape, generator=g, device=device, dtype=dtype)
        if dtype == torch.float32:
            wlen = torch.from_numpy(rng.integers(1, s + 1, b_).astype(np.int32)).to(device)
        else:
            wlen = torch.full((b_,), s - DECODE_STEPS + 1, dtype=torch.int32, device=device)
        for cap in caps:
            cases[name + ("_softcap" if cap else "")] = decode_case(wq, wk, wv, wlen, softcap=cap)
        del wq, wk, wv
        free_device(device)
    p_ = cases["path"]
    out["flash_decode"] = dict(
        name="flash_decode", max_abs_err=max(c["max_abs_err"] for c in cases.values()),
        ms=p_["ms"], plain_ms=p_["plain_ms"], library_ms=p_["library_ms"],
        bound_ms=p_["bound_ms"], bound_by=p_["bound_by"], shape=p_["shape"],
        chunk_rows=decode_ops.MMA_CHUNK_ROWS, cases=cases)
    emit("kernel", **{k_: v_ for k_, v_ in out["flash_decode"].items() if k_ != "cases"})
    del q
    free_device(device)

    # -- embedding_bag at BST's three lookups, plus a weighted, padded case
    n_items, d = rec.n_items, rec.embed_dim
    table = (torch.randn((n_items, d), generator=g, device=device) * 0.02).contiguous()
    bulk = SERVE_BATCHES[-1]
    cases = {
        "forward": (rng.integers(0, n_items, (bulk * (rec.seq_len + 1), 1)), None, "sum"),
        "user_tower": (rng.integers(0, n_items, (1, rec.seq_len)), None, "mean"),
        "retrieval": (rng.integers(0, n_items, (N_CANDIDATES, 1)), None, "sum"),
        # recsys_train's forward: one RecsysBatches batch's history and targets
        "train": (recsys_train_ids(rec, 0, seed)[:, None], None, "sum"),
        "weighted_padded": (rng.integers(0, n_items, (SERVE_BATCHES[0], rec.seq_len)),
                            rng.random((SERVE_BATCHES[0], rec.seq_len)).astype(np.float32),
                            "mean"),
    }
    pad = rng.random(cases["weighted_padded"][0].shape) < 0.3
    cases["weighted_padded"][0][pad] = -1
    shapes = {}
    for name, (ids_np, w_np, mode) in cases.items():
        ids = torch.from_numpy(ids_np.astype(np.int32)).to(device)
        w = None if w_np is None else torch.from_numpy(w_np).to(device)
        got = embedding_bag(table, ids, w, mode)
        want = embedding_bag_ref(table, ids, w, mode)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        n, kk = ids.shape
        ids_l = torch.where(ids >= 0, ids, 0).long()
        if w is None:
            lib = lambda: F.embedding_bag(ids_l, table, mode=mode)  # noqa: E731
        else:  # F.embedding_bag takes per-sample weights in sum mode only
            lib = None
        distinct = int(torch.unique(ids[ids >= 0]).numel())
        shapes[name] = dict(
            shape=[n, kk, d], mode=mode, weighted=w is not None, max_abs_err=max_abs_err(got, want),
            ms=time_ms(lambda: embedding_bag(table, ids, w, mode), device, 20, graph=True),
            plain_ms=time_ms(lambda: embedding_bag_ref(table, ids, w, mode), device, 5),
            library_ms=time_ms(lib, device, 20) if lib else None,
            bound=bound(distinct * d * 4 + ids.numel() * 4 * (1 if w is None else 2)
                        + n * d * 4, ids.numel() * d * 2),
            distinct_rows=distinct)
        emit("embedding_bag_shape", name=name, **shapes[name])
        del ids, w, ids_l, got, want
    r = shapes["retrieval"]
    out["embedding_bag"] = dict(
        name="embedding_bag", shape=r["shape"], max_abs_err=max(x["max_abs_err"]
                                                               for x in shapes.values()),
        ms=r["ms"], plain_ms=r["plain_ms"], library_ms=r["library_ms"],
        bound_ms=r["bound"][0], bound_by=r["bound"][1], shapes=shapes)
    del table
    free_device(device)
    return out


def check_logits(got, want, rtol: float, atol: float, what: str) -> float:
    """Raise unless |got - want| <= atol + rtol |want| everywhere; the max abs error."""
    import torch

    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: shape {tuple(got.shape)} or non-finite logits")
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol, msg=lambda m: f"{what}: {m}")
    return max_abs_err(got, want)


def profiled_step(fn, device, host_ops: bool = True, match=None) -> tuple:
    """``fn()`` once under the profiler: (the union of the device's activity
    intervals in ms, or None where the trace holds no device event; the
    step's wall time in ms, device drained; the ms of the device events
    whose name holds ``match``, None without ``match`` or without such an
    event).  Without ``host_ops`` the trace holds the device's activity
    alone (a step of tens of thousands of operators then costs the
    profiler less)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] if host_ops or device.type != "cuda" else []
    acts += [ProfilerActivity.CUDA] if device.type == "cuda" else []
    with profile(activities=acts) as prof:
        _, sec = wall(fn, device)
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    named = [e.time_range.end - e.time_range.start for e in events
             if match is not None and match in e.name]
    match_ms = sum(named) / 1e3 if named else None
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    if not spans:
        return None, sec * 1e3, match_ms
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo = busy + hi - lo, a
        hi = max(hi, b)
    return (busy + hi - lo) / 1e3, sec * 1e3, match_ms


def checked_attn_fn(plain_attn, errs: list):
    """The kernel route's ``attn_fn``, each launch held against its plain
    version on the same inputs (f32 accumulation on both sides) at rtol
    2e-4, atol 2e-5; each launch's largest error goes into ``errs``."""
    import torch

    from repro_torch.serve.decode import flash_attn_fn

    def attn(q, k_cache, v_cache, pos, window, cap):
        got = flash_attn_fn(q, k_cache, v_cache, pos, window, cap)
        want = plain_attn(q, k_cache, v_cache, pos, window, cap)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)
        errs.append(max_abs_err(got, want))
        return got

    return attn


def phase_lm_serve(seed: int, device) -> dict:
    """Phase 8: (a) the serve launcher's main at full width in f32, then one
    step of both routes; (b) decode_32k in bf16."""
    import numpy as np
    import torch

    from repro_torch.kernels.flash_decode import route
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import transformer as T
    from repro_torch.serve.decode import flash_attn_fn, make_decode_step, make_flash_attn_fn

    plain_attn = make_flash_attn_fn(flash_decode_ref)
    report = {}

    # (a) the launcher, as a user runs it
    argv = ["--arch", LM_ARCH, "--device", device.type, "--seed", str(seed)]
    t0 = time.perf_counter()
    res = serve_main(argv + (["--smoke"] if MODEL_SMOKE else []))
    main_s = time.perf_counter() - t0
    cfg, params, cache = res["cfg"], res["params"], res["cache"]
    toks = res["tokens"]
    if toks.shape != (4, 33) or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab:
        raise AssertionError(f"serve main: tokens {tuple(toks.shape)} out of shape or range")
    step_k = make_decode_step(cfg, torch.float32, attn_fn=flash_attn_fn)
    step_p = make_decode_step(cfg, torch.float32, attn_fn=plain_attn)
    last, pos = toks[:, -1:], res["pos"]
    lp, tp, _ = step_p(params, cache, last, pos)  # each route writes pos itself
    lk, tk, _ = step_k(params, cache, last, pos)
    sync(device)
    report["main"] = dict(config=cfg.name, seconds=main_s, tok_per_s=res["tok_per_s"],
                          decode_s=res["seconds"], tokens=list(toks.shape),
                          check_pos=pos, tokens_equal=bool(torch.equal(tk, tp)),
                          max_abs_err=check_logits(lk, lp, 3e-4, 3e-4, "serve main f32"),
                          logit_absmax=float(lp.abs().max()))
    emit("lm_serve_main", **report["main"])
    del res, params, cache, lk, lp
    free_device(device)

    # (b) decode_32k in bf16: weights and cache in the compute type
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    lm, _ = model_configs()
    gen = torch.Generator(device=device).manual_seed(seed + 30)
    t0 = time.perf_counter()
    params = T.init_params(lm, gen, dtype=torch.bfloat16, device=device)
    cache = T.init_cache(lm, DECODE_BATCH, DECODE_SEQ, dtype=torch.bfloat16, device=device)
    first = DECODE_SEQ - DECODE_STEPS  # positions [0, first) filled from the seed
    for name in ("k", "v"):
        for i in range(lm.n_layers):
            cache[name][i, :, :first].normal_(generator=gen)
    sync(device)
    setup_s = time.perf_counter() - t0
    launch_errs = []
    checked_attn = checked_attn_fn(plain_attn, launch_errs)
    step_k = make_decode_step(lm, torch.bfloat16, attn_fn=flash_attn_fn)
    tok = torch.from_numpy(np.random.default_rng(seed + 30).integers(
        0, lm.vocab, (DECODE_BATCH, 1), dtype=np.int32)).to(device)
    # one checked step at the first position, both routes from the same cache
    # (each writes that position itself); the timed steps then redo it
    lp, tp, _ = make_decode_step(lm, torch.bfloat16, attn_fn=plain_attn)(
        params, cache, tok, first)
    lc, tc, _ = make_decode_step(lm, torch.bfloat16, attn_fn=checked_attn)(
        params, cache, tok, first)
    limit = 0.1 * float(lp.abs().max())
    err = check_logits(lc, lp, 0.0, limit, "decode_32k bf16")
    # two controls of that limit, same step: the plain route with one bf16
    # ulp added to one element of layer 0's attention output (rounding
    # noise) must stay inside it, and the kernel route with query head h
    # grouped under KV head h % KV instead of h // G (a planted fault) must
    # fall outside it
    def nudged_attn(q, k_cache, v_cache, pos, window, cap):
        out = plain_attn(q, k_cache, v_cache, pos, window, cap).to(torch.bfloat16)
        if not nudged:
            out.view(torch.int16).view(-1)[0] += 1
            nudged.append(True)
        return out

    def regrouped_attn(q, k_cache, v_cache, pos, window, cap):
        b, _, h, dh = q.shape
        kv = k_cache.shape[2]
        qr = q.reshape(b, 1, h // kv, kv, dh).transpose(2, 3).reshape(b, 1, h, dh)
        out = flash_attn_fn(qr, k_cache, v_cache, pos, window, cap)
        return out.reshape(b, 1, kv, h // kv, dh).transpose(2, 3).reshape(b, 1, h, dh)

    nudged = []
    ln, _, _ = make_decode_step(lm, torch.bfloat16, attn_fn=nudged_attn)(
        params, cache, tok, first)
    lf, _, _ = make_decode_step(lm, torch.bfloat16, attn_fn=regrouped_attn)(
        params, cache, tok, first)
    noise_err, fault_err = max_abs_err(ln, lp), max_abs_err(lf, lp)
    del ln, lf
    if not noise_err <= limit < fault_err:
        raise AssertionError(f"decode_32k: the logits limit {limit} does not separate "
                             f"one-ulp noise ({noise_err}) from a planted fault ({fault_err})")
    step_s, per_step, _, tok = decode_steps(step_k, params, cache, tok, first, DECODE_STEPS,
                                            device)
    if "flash_decode" in PATH_KERNELS["lm_serve"] and any(n != lm.n_layers for n in per_step):
        raise AssertionError(f"decode_32k: flash_decode launches per step {per_step}, "
                             f"want {lm.n_layers}")
    # the last position once more, under the profiler: the device's busy
    # time, against that step's wall time and the unprofiled steps' median
    busy_ms, prof_ms, _ = profiled_step(
        lambda: step_k(params, cache, tok, DECODE_SEQ - 1), device)
    median_ms = float(np.median(step_s)) * 1e3
    report["decode_32k"] = dict(
        config=lm.name, batch=DECODE_BATCH, cache_len=DECODE_SEQ, first_pos=first,
        steps=DECODE_STEPS, setup_s=setup_s, step_s=step_s,
        tok_per_s=DECODE_BATCH * DECODE_STEPS / sum(step_s),
        launches_per_step=per_step, route=route(torch.bfloat16, lm.d_head),
        max_abs_err=err, tokens_equal=bool(torch.equal(tc, tp)),
        one_ulp_control_max_abs_err=noise_err, regrouped_fault_max_abs_err=fault_err,
        logit_absmax=float(lp.abs().max()), checked_launches=len(launch_errs),
        launch_max_abs_err=max(launch_errs), logits_limit=limit,
        profiled_step_ms=prof_ms, device_busy_ms=busy_ms, median_step_ms=median_ms,
        idle_share_profiled=None if busy_ms is None else 1.0 - busy_ms / prof_ms,
        idle_share_median=None if busy_ms is None else 1.0 - busy_ms / median_ms,
        param_bytes=tree_bytes(params),
        cache_bytes=2 * cache["k"].numel() * cache["k"].element_size(),
        peak_allocated_bytes=(torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None))
    emit("lm_serve_decode_32k", **report["decode_32k"])
    del params, cache
    free_device(device)
    report["granite"] = serve_granite(seed, device, plain_attn)
    return report


def serve_granite(seed: int, device, plain_attn) -> dict:
    """Phase 8 (c): granite at full width through the serve launcher's
    defaults (f32), one more step with each ``flash_decode`` launch held
    against the plain version and the logits against the plain route's, and
    ``make_prefill_step`` on the same prompt against the logits that decode
    gave after the prompt's last token (rtol = atol = 3e-4, the limit of the
    reference's decode-vs-forward test)."""
    import torch

    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.serve.decode import make_decode_step, make_prefill_step

    argv = ["--arch", GRANITE, "--device", device.type, "--seed", str(seed)]
    n0 = flash_decode.launches
    res, main_s = wall(lambda: serve_main(argv + (["--smoke"] if MODEL_SMOKE else [])), device)
    main_launches = flash_decode.launches - n0
    cfg, params, cache = res["cfg"], res["params"], res["cache"]
    want_launches = (SERVE_PROMPT + SERVE_DECODE) * cfg.n_layers
    if "flash_decode" in PATH_KERNELS["lm_serve"] and main_launches != want_launches:
        raise AssertionError(f"granite serve: {main_launches} flash_decode launches, "
                             f"want {want_launches}")
    errs = []
    last, pos = res["tokens"][:, -1:], res["pos"]
    lp, tp, _ = make_decode_step(cfg, torch.float32, attn_fn=plain_attn)(params, cache, last, pos)
    lc, tc, _ = make_decode_step(cfg, torch.float32, attn_fn=checked_attn_fn(plain_attn, errs))(
        params, cache, last, pos)
    err = check_logits(lc, lp, 3e-4, 3e-4, "granite serve f32")
    if len(errs) != cfg.n_layers:
        raise AssertionError(f"granite serve: {len(errs)} checked launches, want {cfg.n_layers}")
    prefill = make_prefill_step(cfg, torch.float32)
    pre, pre_s = wall(lambda: prefill(params, res["prompt"]), device)
    pre_err = check_logits(pre, res["prompt_logits"], 3e-4, 3e-4, "granite prefill vs decode")
    report = dict(config=cfg.name, seconds=main_s, tok_per_s=res["tok_per_s"],
                  decode_s=res["seconds"], main_launches=main_launches,
                  checked_launches=len(errs), launch_max_abs_err=max(errs),
                  max_abs_err=err, tokens_equal=bool(torch.equal(tc, tp)),
                  prefill_s=pre_s, prefill_max_abs_err=pre_err,
                  logit_absmax=float(lp.abs().max()), param_bytes=tree_bytes(params))
    emit("lm_serve_granite", **report)
    del res, params, cache
    free_device(device)
    return report


def phase_recsys_serve(seed: int, device) -> dict:
    """Phase 9: BST serving at its published shapes, the table on the card."""
    import numpy as np
    import torch

    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.models import bst as B

    _, cfg = model_configs()
    gen = torch.Generator(device=device).manual_seed(seed + 40)
    rng = np.random.default_rng(seed + 40)
    params = B.init_params(cfg, gen, device=device)
    report = {"table_bytes": params["item_emb"].numel() * 4}

    def ids(shape):
        return torch.from_numpy(rng.integers(0, cfg.n_items, shape).astype(np.int32)).to(device)

    for name, batch in zip(("serve_p99", "serve_bulk"), SERVE_BATCHES):
        hist, target = ids((batch, cfg.seq_len)), ids((batch,))
        feats = torch.randn((batch, cfg.n_other_feats), generator=gen, device=device)
        got = B.forward(cfg, params, hist, target, feats)
        want = B.forward(cfg, params, hist, target, feats, lookup_fn=plain_lookup)
        err = check_logits(got, want, 1e-5, 1e-5, f"bst forward {name}")
        ms = time_ms(lambda: B.forward(cfg, params, hist, target, feats), device, 10)
        report[name] = dict(batch=batch, ms=ms, rows_per_s=batch / ms * 1e3, max_abs_err=err)
        emit("recsys_serve", cell=name, **report[name])
        del hist, target, feats, got, want

    hist = ids((1, cfg.seq_len))
    feats = torch.randn((1, cfg.n_other_feats), generator=gen, device=device)
    cand = ids((N_CANDIDATES,))

    def retrieve(lookup_fn=None):
        u = B.user_tower(cfg, params, hist, feats)
        return u, B.retrieval_scores(cfg, params, u, cand, lookup_fn=lookup_fn)

    user, scores = retrieve()
    # the tower's plain version is the same mean bag (f32) cast to bf16: at
    # most one bf16 rounding step apart
    user_want = embedding_bag_ref(params["item_emb"], hist, mode="mean").to(user.dtype)
    torch.testing.assert_close(user.float(), user_want.float(), rtol=2.0 ** -8, atol=1e-7)
    _, scores_want = retrieve(plain_lookup)
    err = check_logits(scores, scores_want, 1e-5, 1e-5, "bst retrieval_scores")
    ms = time_ms(retrieve, device, 10)
    report["retrieval_cand"] = dict(candidates=N_CANDIDATES, ms=ms,
                                    rows_per_s=N_CANDIDATES / ms * 1e3, max_abs_err=err,
                                    user_max_abs_err=max_abs_err(user, user_want))
    emit("recsys_serve", cell="retrieval_cand", **report["retrieval_cand"])
    del params, hist, cand, scores, scores_want
    free_device(device)
    return report


def peak_bytes(device):
    import torch

    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


def reset_peak(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def phase_lm_prefill(seed: int, device) -> dict:
    """Phase 10: prefill_32k on granite at full width in bf16, batch 1,
    attn_chunk 1,024: seconds, tokens/s, peak bytes; the last position's
    logits finite and within 0.1 of their largest magnitude of ``forward``'s
    on the same tokens and weights with attn_chunk 2,048."""
    import numpy as np
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.serve.decode import make_prefill_step

    cfg = lm_config(GRANITE)
    free_device(device)
    reset_peak(device)
    gen = torch.Generator(device=device).manual_seed(seed + 50)
    params = T.init_params(cfg, gen, dtype=torch.bfloat16, device=device)
    toks = torch.from_numpy(np.random.default_rng(seed + 50).integers(
        0, cfg.vocab, (PREFILL_BATCH, PREFILL_SEQ), dtype=np.int32)).to(device)
    step = make_prefill_step(cfg, torch.bfloat16, attn_chunk=PREFILL_CHUNK)
    last, sec = wall(lambda: step(params, toks), device)
    peak = peak_bytes(device)

    def check():
        with torch.no_grad():
            full = T.forward(cfg, params, toks, torch.bfloat16, remat=False,
                             attn_chunk=PREFILL_CHECK_CHUNK)
            return bool(torch.isfinite(full).all()), full[:, -1].clone()

    (finite, want), check_s = wall(check, device)
    if not finite or not bool(torch.isfinite(last).all()):
        raise AssertionError("prefill_32k: non-finite logits")
    limit = 0.1 * float(want.float().abs().max())
    err = check_logits(last.float(), want.float(), 0.0, limit, "prefill_32k chunk 1024 vs 2048")
    report = dict(config=cfg.name, batch=PREFILL_BATCH, seq=PREFILL_SEQ, attn_chunk=PREFILL_CHUNK,
                  seconds=sec, tokens_per_s=PREFILL_BATCH * PREFILL_SEQ / sec,
                  check_chunk=PREFILL_CHECK_CHUNK, check_s=check_s, max_abs_err=err,
                  logits_limit=limit, peak_allocated_bytes=peak)
    emit("lm_prefill", **report)
    del params, toks, last, want
    free_device(device)
    return report


def train_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one train step: ``lm_model_flops`` (6 x active
    parameters x tokens), plus causal attention's 2 B S^2 H dh a layer
    forward (QK^T and PV over half the square) times 3 for the backward;
    the recompute of remat is not counted."""
    from repro_torch.roofline.model import lm_model_flops

    attn = 6.0 * batch * seq * seq * cfg.n_heads * cfg.d_head * cfg.n_layers
    return lm_model_flops(cfg, batch, seq, train=True) + attn


def lm_check_grads(cfg, params, batch, dev, dtype):
    """((loss, grads), seconds) of the LM loss at host ``params`` copied to
    ``dev`` in ``dtype`` on ``batch`` (tokens, targets)."""
    import torch

    from repro_torch.optim.tree import tree_map
    from repro_torch.train.step import lm_value_and_grad

    p = tree_map(lambda t: t.to(dev, dtype), params)
    toks, tgts = (torch.from_numpy(batch[k]).to(dev) for k in ("tokens", "targets"))
    return wall(lambda: lm_value_and_grad(cfg, p, toks, tgts, compute_dtype=dtype), dev)


def phase_lm_train(seed: int, device) -> dict:
    """Phase 11: granite at full width trains ``TRAIN_STEPS`` steps of
    train_4k (batch 2) in f32 through ``make_lm_train_step``; the same
    model cut to 2 layers, card against CPU in float64; the launcher at
    ``--smoke`` with a save and a resume."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.optim.tree import tree_leaves
    from repro_torch.roofline.cost import count_step
    from repro_torch.roofline.model import lm_model_flops
    from repro_torch.train.step import make_lm_train_step

    cfg = lm_config(GRANITE)
    cpu = torch.device("cpu")
    # the float64 check's CPU route runs on a host thread beside the steps
    small = dataclasses.replace(cfg, n_layers=TRAIN_CHECK_LAYERS)
    small_params = T.init_params(small, torch.Generator().manual_seed(seed + 60), device=cpu)
    small_batch = SyntheticTokens(cfg.vocab, 1, TRAIN_CHECK_SEQ, seed=seed + 60)[0]
    cpu_join = in_background(
        lambda: lm_check_grads(small, small_params, small_batch, cpu, torch.float64),
        "lm_train_cpu_f64")

    free_device(device)
    reset_peak(device)
    params = T.init_params(cfg, torch.Generator(device=device).manual_seed(seed + 61),
                           device=device)
    opt = adamw.init(params)
    step = make_lm_train_step(cfg, compute_dtype=torch.float32, warmup=10, total=20)
    data = SyntheticTokens(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=seed + 61)
    losses, gnorms, step_s, box = [], [], [], {}
    busy_ms = prof_ms = None
    for i in range(TRAIN_STEPS):
        toks, tgts = (torch.from_numpy(data[i][k]).to(device) for k in ("tokens", "targets"))

        def run():
            box["out"] = step(params, opt, toks, tgts)

        if i == TRAIN_STEPS - 1:  # the last step under the profiler
            busy_ms, prof_ms, _ = profiled_step(run, device, host_ops=False)
        else:
            step_s.append(wall(run, device)[1])
        _, opt, metrics = box.pop("out")
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
    peak = peak_bytes(device)
    finite = all(bool(torch.isfinite(t).all()) for tree in (params, opt.mu, opt.nu)
                 for t in tree_leaves(tree))
    ln_v = math.log(cfg.vocab)
    if not (abs(losses[0] - ln_v) <= 0.5 and losses[-1] < losses[0]
            and all(map(math.isfinite, gnorms)) and finite):
        raise AssertionError(f"lm_train: losses {losses} (ln V {ln_v}), grad norms {gnorms}, "
                             f"every leaf finite: {finite}")
    median_s = float(np.median(step_s))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    report = dict(
        config=cfg.name, batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS, losses=losses,
        grad_norms=gnorms, step_s=step_s, median_step_s=median_s,
        tokens_per_s=tokens / median_s, model_flops=flops,
        flops_formula="6 * n_active_params * tokens + 6 * B * S^2 * H * dh * L",
        f32_peak_share=f32_peak_share(flops, median_s),
        profiled_step_ms=prof_ms, device_busy_ms=busy_ms,
        busy_share_profiled=None if busy_ms is None else busy_ms / prof_ms,
        idle_share_profiled=None if busy_ms is None else 1.0 - busy_ms / prof_ms,
        param_bytes=sum(t.numel() * t.element_size() for t in tree_leaves(params)),
        peak_allocated_bytes=peak)
    emit("lm_train", **report)
    # one more step, counted: its aten ops' FLOPs and bytes (remat included)
    toks, tgts = (torch.from_numpy(data[0][k]).to(device) for k in ("tokens", "targets"))
    step_cost, count_s = wall(lambda: count_step(step, params, opt, toks, tgts)[1], device)
    emit_roofline("lm_train_roofline", step_cost, count_s, cfg.name, "train_4k", "float32",
                  lm_model_flops(cfg, TRAIN_BATCH, TRAIN_SEQ, train=True),
                  measured_step_s=median_s)
    del params, opt, box
    free_device(device)

    # step 0 of the cut model, card against CPU, float64; the card's f32 the control
    card64 = lm_check_grads(small, small_params, small_batch, device, torch.float64)
    card32 = lm_check_grads(small, small_params, small_batch, device, torch.float32)
    cpu64 = cpu_join()[0]
    n_leaves = len(tree_leaves(cpu64[0][1]))
    check = hold_grads(small, "float64", card64[0], cpu64[0], [LM_F64_GRAD_TOL] * n_leaves,
                       {"card_f32": card32[0]}, loss_rtol=LM_F64_LOSS_RTOL)
    check.update(layers=TRAIN_CHECK_LAYERS, tokens=TRAIN_CHECK_SEQ, leaves=n_leaves,
                 card_f64_s=card64[1], card_f32_s=card32[1], cpu_f64_s=cpu64[1])
    emit("lm_train_f64_check", **check)
    report["f64_check"] = check
    del card64, card32, cpu64
    free_device(device)

    # the launcher at --smoke: 6 steps with a checkpoint every 3, then a resume to 8
    with tempfile.TemporaryDirectory() as ckpt_dir:
        argv = ["--arch", GRANITE, "--smoke", "--device", device.type, "--ckpt-every", "3",
                "--ckpt-dir", ckpt_dir, "--seed", str(seed)]
        first, first_s = wall(lambda: train_main(argv + ["--steps", "6"]), device)
        (p, o), meta = ckpt.restore(first["ckpt_dir"], (first["params"], first["opt"]))
        saved = (tree_leaves(p) + tree_leaves(o.mu) + tree_leaves(o.nu) + [o.step])
        held = (tree_leaves(first["params"]) + tree_leaves(first["opt"].mu)
                + tree_leaves(first["opt"].nu) + [first["opt"].step])
        bitwise = meta["step"] == 5 and all(torch.equal(a, b.to(a.device))
                                            for a, b in zip(saved, held))
        s_cfg = first["cfg"]
        b6 = SyntheticTokens(s_cfg.vocab, 8, 128, seed=seed)[6]
        with torch.no_grad():
            want = float(T.lm_loss(T.forward(s_cfg, first["params"],
                                             torch.from_numpy(b6["tokens"]).to(device),
                                             torch.float32),
                                   torch.from_numpy(b6["targets"]).to(device)))
        second, second_s = wall(lambda: train_main(argv + ["--steps", "8", "--resume"]), device)
    resumed_err = abs(second["losses"][0] - want) / abs(want)
    if not (bitwise and second["start"] == 6 and len(second["losses"]) == 2
            and resumed_err <= 1e-6 and all(map(math.isfinite, first["losses"]))):
        raise AssertionError(f"train launcher: checkpoint bitwise {bitwise}, resumed at "
                             f"{second['start']}, first resumed loss {second['losses']} vs {want}")
    report["launcher"] = dict(config=s_cfg.name, first_s=first_s, second_s=second_s,
                              losses=first["losses"] + second["losses"], resumed_at=second["start"],
                              restored_bitwise=bitwise, resumed_loss_rel_err=resumed_err)
    emit("lm_train_launcher", **report["launcher"])
    return report


def phase_recsys_train(seed: int, device) -> dict:
    """Phase 12: BST at its published config trains ``BST_TRAIN_STEPS``
    steps of train_batch (65,536 rows, ``RecsysBatches`` from the seed), the
    [4,194,304, 32] table on the card; step 0's gradients on 512 rows, card
    against CPU in float64; the backward's ``index_add_`` timed alone."""
    import numpy as np
    import torch

    from repro_torch.data.pipeline import RecsysBatches
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.models import bst as B
    from repro_torch.optim import adamw
    from repro_torch.optim.tree import tree_leaves, tree_map
    from repro_torch.train.step import bst_value_and_grad, make_bst_train_step

    _, cfg = model_configs()
    cpu = torch.device("cpu")
    free_device(device)
    reset_peak(device)
    params = B.init_params(cfg, torch.Generator(device=device).manual_seed(seed + 70),
                           device=device)
    first = tree_map(lambda t: t.to(cpu, copy=True), params)  # step 0's parameters
    opt = adamw.init(params)
    step = make_bst_train_step(cfg)  # the reference's lr 1e-3 and bf16 compute
    data, gen_s = wall(lambda: [RecsysBatches(cfg.n_items, BST_TRAIN_BATCH, cfg.seq_len,
                                              cfg.n_other_feats, seed=seed)[i]
                                for i in range(BST_TRAIN_STEPS)], cpu)
    keys = ("hist", "target", "other", "label")
    losses, step_s, per_step = [], [], []
    for batch in data:
        x = [torch.from_numpy(batch[k]).to(device) for k in keys]
        n0 = embedding_bag.launches
        (params, opt, m), sec = wall(lambda: step(params, opt, *x), device)
        per_step.append(embedding_bag.launches - n0)
        losses.append(float(m["loss"]))
        step_s.append(sec)
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"recsys_train: losses {losses}")
    if "embedding_bag" in PATH_KERNELS["recsys_train"] and min(per_step) < 1:
        raise AssertionError(f"recsys_train: embedding_bag launches per step {per_step}")
    peak = peak_bytes(device)
    del params, opt
    free_device(device)

    # the backward's scatter alone, at the training batch's ids
    ids = torch.from_numpy(recsys_train_ids(cfg, 0, seed)).to(device).long()
    rows = torch.randn((ids.numel(), cfg.embed_dim), device=device)
    table_bytes = cfg.n_items * cfg.embed_dim * 4
    scatter_ms = time_ms(lambda: torch.zeros((cfg.n_items, cfg.embed_dim), device=device)
                         .index_add_(0, ids, rows), device, 10)
    scatter_bound = bound(table_bytes + rows.numel() * 4 + ids.numel() * 8, rows.numel())
    del ids, rows

    # step 0's gradients on BST_CHECK_BATCH rows: card vs CPU, float64 (the table f32)
    small = {k: v[:BST_CHECK_BATCH] for k, v in data[0].items()}

    def grads_on(dev, dtype):
        p = {k: (t.to(dev) if k == "item_emb" else tree_map(lambda u: u.to(dev, dtype), t))
             for k, t in first.items()}
        x = [torch.from_numpy(small[k]).to(dev) for k in keys]
        x[2:] = [t.to(dtype) for t in x[2:]]
        return wall(lambda: bst_value_and_grad(cfg, p, *x, compute_dtype=dtype), dev)

    card64, card32, cpu64 = (grads_on(device, torch.float64), grads_on(device, torch.float32),
                             grads_on(cpu, torch.float64))
    names = [n for n in sorted(first) for _ in tree_leaves(first[n])]
    limits = [BST_TABLE_GRAD_TOL if n == "item_emb" else BST_F64_GRAD_TOL for n in names]
    check = hold_grads(cfg, "float64", card64[0], cpu64[0], limits, {"card_f32": card32[0]},
                       loss_rtol=BST_F64_LOSS_RTOL)
    errs = leaf_errors(card64[0][1], cpu64[0][1])
    check.update(rows=BST_CHECK_BATCH, table_leaf_err=errs[names.index("item_emb")],
                 other_leaves_max_err=max(e for e, n in zip(errs, names) if n != "item_emb"),
                 card_f64_s=card64[1], cpu_f64_s=cpu64[1])
    median_s = float(np.median(step_s))
    report = dict(config=cfg.name, batch=BST_TRAIN_BATCH, steps=BST_TRAIN_STEPS, losses=losses,
                  step_s=step_s, median_step_s=median_s, rows_per_s=BST_TRAIN_BATCH / median_s,
                  batch_gen_s=gen_s, embedding_bag_launches_per_step=per_step,
                  index_add_ms=scatter_ms, index_add_bound_ms=scatter_bound[0],
                  index_add_bound_by=scatter_bound[1], peak_allocated_bytes=peak,
                  f64_check=check)
    emit("recsys_train", **report)
    del card64, card32, cpu64, first
    free_device(device)
    return report


# ---------------------------------------------------------------------------
# Phase mesh_models: the model side of the mesh, four shards on one card
# ---------------------------------------------------------------------------
def bst_batch_on(cfg, batch: int, rng, gen, device):
    """Seeded BST inputs of ``batch`` rows on ``device``: (hist, target, feats)."""
    import numpy as np
    import torch

    def ids(shape):
        return torch.from_numpy(rng.integers(0, cfg.n_items, shape).astype(np.int32)).to(device)

    return (ids((batch, cfg.seq_len)), ids((batch,)),
            torch.randn((batch, cfg.n_other_feats), generator=gen, device=device))


def one_card_mesh(mesh, device):
    """``mesh``'s shape and axes with every shard on ``device``: the same
    form on one card, beside the one spread over the cards."""
    from repro_torch.launch.mesh import Mesh

    return Mesh([device] * mesh.size, tuple(mesh.shape.values()), mesh.axis_names)


def shard_copy_bytes(fn) -> tuple:
    """``(fn(), bytes collectives.shard copied between devices in it)``."""
    from repro_torch.roofline.comm import COPY, CommCounter

    with CommCounter() as c:
        out = fn()
    return out, c.stats()["bytes_by_op"].get(COPY, 0.0)


def phase_mesh_bst(seed: int, device) -> dict:
    """Mesh part (a): BST's item table split by rows over ``MESH_SHARDS``
    shards (``make_sharded_lookup``, axis ``model``; shard k on card
    k % n_cards): serve_p99 and serve_bulk through the table placed once
    (``place_table``), the looked-up rows bitwise the single-device
    lookup's, only the ids copied between cards, and the logits within
    1e-5 of its forward; with several cards, the same placed form with
    every shard on ``device`` timed beside it; one train step at
    train_batch through the lookup (its table cut per call) against the
    single-device step (every new parameter within f32 rounding); one
    shard's ``embedding_bag`` launch at the bulk forward's per-shard
    shape, on that shard's card, timed."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.data.pipeline import RecsysBatches
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import bst as B
    from repro_torch.optim import adamw
    from repro_torch.optim.tree import tree_leaves
    from repro_torch.train.step import make_bst_train_step

    _, cfg = model_configs()
    mesh = make_mesh((MESH_SHARDS,), ("model",), device=device)
    lookup = B.make_sharded_lookup(mesh, "model")
    gen = torch.Generator(device=device).manual_seed(seed + 80)
    rng = np.random.default_rng(seed + 80)
    params = B.init_params(cfg, gen, device=device)
    table = params["item_emb"]
    placed = {**params, "item_emb": B.place_table(table, mesh)}
    cards = len(set(mesh.flat_devices))
    one_card = None
    if cards > 1:
        mesh1 = one_card_mesh(mesh, device)
        one_card = (B.make_sharded_lookup(mesh1, "model"),
                    {**params, "item_emb": B.place_table(table, mesh1)})
    report = dict(mesh=dict(mesh.shape), shard_devices=[str(d) for d in mesh.flat_devices],
                  rows_per_shard=cfg.n_items // MESH_SHARDS)
    for name, batch in zip(("serve_p99", "serve_bulk"), SERVE_BATCHES):
        hist, target, feats = bst_batch_on(cfg, batch, rng, gen, device)
        seq = torch.cat([hist, target[:, None]], dim=1)
        n0 = embedding_bag.launches
        rows, copied = shard_copy_bytes(lambda: lookup(placed["item_emb"], seq))
        launches = embedding_bag.launches - n0
        if not torch.equal(rows, B.embedding_lookup(table, seq)):
            raise AssertionError(f"mesh bst {name}: sharded lookup not bitwise the single one")
        if "embedding_bag" in PATH_KERNELS["mesh_bst"] and launches != MESH_SHARDS:
            raise AssertionError(f"mesh bst {name}: {launches} embedding_bag launches, "
                                 f"want one a shard ({MESH_SHARDS})")
        if copied != (cards - 1) * seq.nbytes:  # the ids, once to each other card
            raise AssertionError(f"mesh bst {name}: the placed lookup copied {copied} bytes "
                                 f"between cards, its ids are {seq.nbytes}")
        got = B.forward(cfg, placed, hist, target, feats, lookup_fn=lookup)
        want = B.forward(cfg, params, hist, target, feats)
        err = check_logits(got, want, 1e-5, 1e-5, f"mesh bst forward {name}")
        ms = time_ms(lambda: B.forward(cfg, placed, hist, target, feats, lookup_fn=lookup),
                     device, 10)
        single_ms = time_ms(lambda: B.forward(cfg, params, hist, target, feats), device, 10)
        report[name] = dict(batch=batch, ms=ms, single_ms=single_ms,
                            rows_per_s=batch / ms * 1e3, single_rows_per_s=batch / single_ms * 1e3,
                            lookup_bitwise=True, logits_bitwise=bool(torch.equal(got, want)),
                            max_abs_err=err, embedding_bag_launches_per_lookup=launches,
                            lookup_shard_copy_bytes=copied)
        if one_card is not None:
            lookup1, placed1 = one_card
            report[name]["one_card_ms"] = time_ms(lambda: B.forward(
                cfg, placed1, hist, target, feats, lookup_fn=lookup1), device, 10)
        emit("mesh_bst", cell=name, **report[name])
        if name == "serve_bulk":  # one shard's launch at this lookup's per-shard shape
            tab1 = placed["item_emb"].parts[1]
            local = seq.reshape(-1, 1).to(tab1.device) - tab1.shape[0]
            ids1 = torch.where((local >= 0) & (local < tab1.shape[0]), local, 0).contiguous()
            on1 = tab1.device
            with uncounted():
                got1 = embedding_bag(tab1, ids1)
                want1 = embedding_bag_ref(tab1, ids1)
                torch.testing.assert_close(got1, want1, rtol=1e-5, atol=1e-5)
                ids1_l = ids1.long()
                distinct = int(torch.unique(ids1).numel())
                nbytes = (distinct * cfg.embed_dim * 4 + ids1.numel() * 4
                          + ids1.numel() * cfg.embed_dim * 4)
                b_ms, b_by = bound(nbytes, ids1.numel() * cfg.embed_dim)
                report["embedding_bag_shard"] = dict(
                    name="embedding_bag", shape=[ids1.shape[0], 1, cfg.embed_dim],
                    table_rows=tab1.shape[0], distinct_rows=distinct, device=str(on1),
                    max_abs_err=max_abs_err(got1, want1),
                    ms=time_ms(lambda: embedding_bag(tab1, ids1), on1, 20, graph=True),
                    plain_ms=time_ms(lambda: embedding_bag_ref(tab1, ids1), on1, 5),
                    library_ms=time_ms(lambda: F.embedding_bag(ids1_l, tab1, mode="sum"), on1,
                                       20),
                    bound_ms=b_ms, bound_by=b_by, bound_bytes=nbytes)
            emit("kernel", cell="mesh_bst_shard", **report["embedding_bag_shard"])
            del tab1, local, ids1, ids1_l, got1, want1
        del hist, target, feats, seq, rows, got, want

    # one train step through the sharded lookup against the single-device step
    data = RecsysBatches(cfg.n_items, BST_TRAIN_BATCH, cfg.seq_len, cfg.n_other_feats,
                         seed=seed)[0]
    x = [torch.from_numpy(data[k]).to(device) for k in ("hist", "target", "other", "label")]
    opt = adamw.init(params)
    routes = {}
    for name, fn in (("sharded", make_bst_train_step(cfg, lookup_fn=lookup)),
                     ("single", make_bst_train_step(cfg))):
        fn(params, opt, *x)  # warm: the timed call is the second
        routes[name] = wall(lambda: fn(params, opt, *x), device)
    ((p_sh, _, m_sh), sh_s), ((p_1, _, m_1), single_s) = routes["sharded"], routes["single"]
    worst = 0.0
    for a, b in zip(tree_leaves(p_sh), tree_leaves(p_1)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)  # f32 rounding of the sums
        worst = max(worst, max_abs_err(a, b))
    loss_err = abs(float(m_sh["loss"]) - float(m_1["loss"])) / abs(float(m_1["loss"]))
    if loss_err > 1e-6:
        raise AssertionError(f"mesh bst train: loss {float(m_sh['loss'])} vs {float(m_1['loss'])}")
    report["train"] = dict(batch=BST_TRAIN_BATCH, step_s=sh_s, single_step_s=single_s,
                           loss=float(m_sh["loss"]), loss_rel_err=loss_err,
                           params_max_abs_err=worst)
    emit("mesh_bst", cell="train_batch", **report["train"])
    del p_sh, p_1
    report["comm"] = emit_comm("bst", "train_batch", mesh, lambda: make_bst_train_step(
        cfg, lookup_fn=lookup)(params, opt, *x))
    del params, table, placed, one_card, opt, x
    free_device(device)
    return report


def phase_mesh_granite(seed: int, device) -> dict:
    """Mesh part (b): granite-moe-3b-a800m at full width on a (data=2,
    model=2) mesh (shard k on card k % n_cards), decode through
    ``make_sp_attn_fn(mesh, ("model",), "data")`` and
    ``make_weight_stationary_moe_ffn(cfg, mesh, "data", "model")`` with the
    expert weights placed once (``place_experts``) and the cache placed a
    slice a shard (``place_sp_cache``).  Parity: f32 weights, a cache of
    ``MESH_CHECK_CACHE`` positions, ``MESH_CHECK_STEPS`` steps against the
    single-device f32 route (plain attention, ``moe_ffn``) fed the same
    tokens, logits within ``MESH_LOGITS_TOL``; one f32 forward of
    ``MESH_FORWARD_SEQ`` tokens through ``make_sharded_moe_ffn`` (its
    experts placed) against the single-device forward with the same
    per-data-shard dispatch (``_moe_capacity`` on each half of the tokens,
    as the reference's own test holds it).  Timed: bf16, ``DECODE_BATCH``
    x ``DECODE_SEQ``, ``DECODE_STEPS`` steps of the sharded route, of the
    same placed route with every shard on ``device`` (with several cards)
    and of the single-device route (the ``flash_decode`` kernel,
    decode_32k's route), each on its own copy of one cache.  A placed step
    copies between cards less than one block of its cache or experts
    holds: no weight or cache block moves."""
    import numpy as np
    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as TM
    from repro_torch.models import transformer as T
    from repro_torch.optim.tree import tree_map
    from repro_torch.serve.decode import (flash_attn_fn, make_decode_step, make_sp_attn_fn,
                                          place_sp_cache)

    cfg = lm_config(GRANITE)
    mesh = make_mesh((2, 2), ("data", "model"), device=device)
    sp_attn = make_sp_attn_fn(mesh, ("model",), "data")
    ws_moe = TM.make_weight_stationary_moe_ffn(cfg, mesh, "data", "model")
    ws_specs = TM.weight_stationary_specs("data", "model")
    gen = torch.Generator(device=device).manual_seed(seed + 90)
    rng = np.random.default_rng(seed + 90)
    reset_peak(device)
    params, init_s = wall(lambda: T.init_params(cfg, gen, dtype=torch.float32, device=device),
                          device)
    report = dict(config=cfg.name, mesh=dict(mesh.shape), init_s=init_s)

    def filled_cache(length: int, first: int, dtype):
        cache = T.init_cache(cfg, DECODE_BATCH, length, dtype=dtype, device=device)
        for name in ("k", "v"):
            for i in range(cfg.n_layers):
                cache[name][i, :, :first].normal_(generator=gen)
        return cache

    def tokens(shape):
        return torch.from_numpy(rng.integers(0, cfg.vocab, shape, dtype=np.int32)).to(device)

    # parity in f32: one cache, whole for the single route and placed for
    # the sharded one, each route writing its own
    first = MESH_CHECK_CACHE - MESH_CHECK_STEPS
    cache_1 = filled_cache(MESH_CHECK_CACHE, first, torch.float32)
    cache_sh = place_sp_cache(cache_1, mesh, ("model",), "data")
    params_sh = TM.place_experts(params, mesh, ws_specs)
    step_sh = make_decode_step(cfg, torch.float32, attn_fn=sp_attn, moe_fn=ws_moe)
    step_1 = make_decode_step(cfg, torch.float32)
    tok, errs, same_tokens, absmax = tokens((DECODE_BATCH, 1)), [], [], 0.0
    for i in range(MESH_CHECK_STEPS):
        l1, t1, _ = step_1(params, cache_1, tok, first + i)
        lsh, tsh, _ = step_sh(params_sh, cache_sh, tok, first + i)
        errs.append(check_logits(lsh, l1, MESH_LOGITS_TOL, MESH_LOGITS_TOL,
                                 f"mesh granite decode step {i}"))
        same_tokens.append(bool(torch.equal(tsh, t1)))
        absmax = max(absmax, float(l1.abs().max()))
        tok = t1[:, None]  # both routes fed the single route's tokens
    report["decode_check"] = dict(cache_len=MESH_CHECK_CACHE, batch=DECODE_BATCH,
                                  steps=MESH_CHECK_STEPS, max_abs_err=max(errs),
                                  step_max_abs_err=errs, tokens_equal=same_tokens,
                                  logit_absmax=absmax, tolerance=MESH_LOGITS_TOL)
    emit("mesh_granite", part="decode_check", **report["decode_check"])
    del cache_sh, cache_1, params_sh, l1, lsh
    free_device(device)

    # one f32 forward through the sharded MoE, its experts placed
    moe_sh = TM.make_sharded_moe_ffn(cfg, mesh, "data", "model")
    params_sh = TM.place_experts(params, mesh, TM.sharded_specs("model"))
    halves = lambda lw, x: torch.cat([TM._moe_capacity(cfg, lw, h) for h in x.chunk(2)])  # noqa: E731
    prompt = tokens((1, MESH_FORWARD_SEQ))
    with torch.no_grad():
        f_sh, f_sh_s = wall(lambda: T.forward(cfg, params_sh, prompt,
                                              compute_dtype=torch.float32, remat=False,
                                              moe_fn=moe_sh), device)
        f_1, f_1_s = wall(lambda: T.forward(cfg, params, prompt, compute_dtype=torch.float32,
                                            remat=False, moe_fn=halves), device)
    report["forward"] = dict(tokens=MESH_FORWARD_SEQ, seconds=f_sh_s, single_seconds=f_1_s,
                             max_abs_err=check_logits(f_sh, f_1, MESH_LOGITS_TOL, MESH_LOGITS_TOL,
                                                      "mesh granite sharded-MoE forward"),
                             logit_absmax=float(f_1.abs().max()), tolerance=MESH_LOGITS_TOL)
    emit("mesh_granite", part="forward", **report["forward"])
    del f_sh, f_1, params_sh
    params = tree_map(lambda t: t.to(torch.bfloat16), params)
    free_device(device)

    # timed in bf16: the sharded route (placed), the same on one card (with
    # several cards), then the single route, each on its copy of one cache
    first = DECODE_SEQ - DECODE_STEPS
    cache = filled_cache(DECODE_SEQ, first, torch.bfloat16)
    start = tokens((DECODE_BATCH, 1))
    meshes = [("sharded", mesh)]
    if len(set(mesh.flat_devices)) > 1:
        meshes.append(("one_card", one_card_mesh(mesh, device)))
    routes = []
    for route, m in meshes:
        routes.append((route, make_decode_step(
            cfg, torch.bfloat16, attn_fn=make_sp_attn_fn(m, ("model",), "data"),
            moe_fn=TM.make_weight_stationary_moe_ffn(cfg, m, "data", "model")),
            TM.place_experts(params, m, ws_specs), place_sp_cache(cache, m, ("model",), "data")))
    routes.append(("single", make_decode_step(cfg, torch.bfloat16, attn_fn=flash_attn_fn),
                   params, cache))
    sharded_step, params_sh, cache_sh = routes[0][1:]
    timed = {}
    for route, step, weights, kv in routes:
        tok, secs = start, []
        for i in range(DECODE_STEPS):
            (logits, nxt, _), sec = wall(lambda: step(weights, kv, tok, first + i), device)
            if not torch.isfinite(logits).all():
                raise AssertionError(f"mesh granite {route}: non-finite logits")
            secs.append(sec)
            tok = nxt[:, None]
        timed[route] = dict(step_s=secs, tok_per_s=DECODE_BATCH * DECODE_STEPS / sum(secs),
                            median_step_ms=float(np.median(secs)) * 1e3)
    # one more placed step: what it copies between cards a layer, against
    # the smallest block a layer of its cache and expert weights holds (a
    # block moved on every call would copy at least that much a layer)
    _, copied = shard_copy_bytes(lambda: sharded_step(params_sh, cache_sh, start, first))
    blocks = [p.nbytes // cfg.n_layers for leaf in (*cache_sh.values(),
                                                     *(params_sh["layers"][k] for k in ws_specs))
              for p in leaf.parts]
    if copied / cfg.n_layers >= min(blocks):
        raise AssertionError(f"mesh granite: a placed decode step copied {copied} bytes "
                             f"between cards, a layer's smallest block is {min(blocks)}")
    report["decode_timed"] = dict(batch=DECODE_BATCH, cache_len=DECODE_SEQ, steps=DECODE_STEPS,
                                  **timed, placed_step_shard_copy_bytes=copied,
                                  smallest_block_bytes_a_layer=min(blocks),
                                  peak_allocated_bytes=peak_bytes(device))
    emit("mesh_granite", part="decode_timed", **report["decode_timed"])
    report["comm"] = emit_comm(cfg.name, "decode_32k", mesh,
                               lambda: sharded_step(params_sh, cache_sh, start, first))
    del params, cache, routes, params_sh, cache_sh
    free_device(device)
    return report


def phase_mesh_gnn(store, seed, device) -> dict:
    """Mesh part (c), on the main store: gin-tu at its published config,
    ``MESH_GNN_BATCHES`` minibatch_lg steps each on a batch sampled from a
    pinned view (its padded edge list shuffled), the gather and scatter
    split over ``MESH_SHARDS`` node and edge shards (``make_shardmap_gather``/``make_shardmap_scatter``, bf16
    on the wire), from one set of parameters with f32 AdamW moments.  In
    deterministic mode (``index_add_`` in a fixed order) each step's loss
    and first moments equal bitwise those of the plain control that makes
    the sharded route's roundings (``MESH_GNN_BATCHES``' comment); its loss
    is within ``MESH_GNN_LOSS_RTOL`` of the single step with bf16 gathers,
    whose leaf errors, and the single route's own gap between an f32 and a
    bf16 wire, are reported.  The first batch's sharded step with its edges
    reversed must put some leaf outside ``MESH_GNN_GRAD_TOL`` of the
    control.  Step times are of a second, warm call, outside
    deterministic mode."""
    import warnings

    import numpy as np
    import torch

    from repro_torch.graph.sampler import NeighborSampler, pad_subgraph
    from repro_torch.graph.segment_ops import segment_sum
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import gnn as G
    from repro_torch.optim import adamw
    from repro_torch.optim.tree import tree_leaves
    from repro_torch.train.step import make_gnn_train_step

    cfg = gnn_config(GNN_ARCH)
    n_seeds, fanouts, d_feat = GNN_SEEDS, GNN_FANOUTS, GNN_D_FEAT
    max_n = n_seeds * (1 + fanouts[0] + fanouts[0] * fanouts[1])
    max_e = n_seeds * (fanouts[0] + fanouts[0] * fanouts[1])
    mesh = make_mesh((MESH_SHARDS,), ("data",), device=device)
    n = store.n_vertices

    def rounded_sum(x, idx, n_rows: int):
        """The sum of ``x``'s rows onto rows ``idx``, rounded as the
        sharded route rounds (``MESH_GNN_BATCHES``' comment)."""
        acc = None
        for xs, ids in zip(x.chunk(MESH_SHARDS), idx.chunk(MESH_SHARDS)):
            part = segment_sum(xs.float(), ids, n_rows).to(torch.bfloat16).float()
            acc = part if acc is None else acc + part
        return acc.to(torch.bfloat16).to(x.dtype)

    class Gather(torch.autograd.Function):  # the control's h[idx], bf16 on the wire
        @staticmethod
        def forward(ctx, h, idx):
            ctx.save_for_backward(idx)
            ctx.n_rows = h.shape[0]
            return h.to(torch.bfloat16).index_select(0, idx.long()).to(h.dtype)

        @staticmethod
        def backward(ctx, g):
            (idx,) = ctx.saved_tensors
            return rounded_sum(g, idx, ctx.n_rows), None

    class Scatter(torch.autograd.Function):  # the control's segment sum onto max_n rows
        @staticmethod
        def forward(ctx, msgs, dst):
            ctx.save_for_backward(dst)
            return rounded_sum(msgs, dst, max_n)

        @staticmethod
        def backward(ctx, g):
            (dst,) = ctx.saved_tensors
            return g.to(torch.bfloat16).index_select(0, dst.long()).to(g.dtype), None

    def step_fn(**kw):
        return make_gnn_train_step(cfg, n_nodes=max_n, lr=GNN_LR, **kw)

    steps = {"sharded": step_fn(gather_fn=G.make_shardmap_gather(mesh, "data", "data"),
                                scatter_fn=G.make_shardmap_scatter(mesh, "data", "data", max_n)),
             "control": step_fn(gather_fn=Gather.apply, scatter_fn=Scatter.apply),
             "single": step_fn(comm_dtype=torch.bfloat16),
             "f32_wire": step_fn()}
    if len(set(mesh.flat_devices)) > 1:  # the sharded step with every shard on one card
        mesh1 = one_card_mesh(mesh, device)
        steps["one_card"] = step_fn(gather_fn=G.make_shardmap_gather(mesh1, "data", "data"),
                                    scatter_fn=G.make_shardmap_scatter(mesh1, "data", "data",
                                                                       max_n))
    params = G.init_gnn(cfg, torch.Generator(device=device).manual_seed(seed + 100), d_feat,
                        device=device)

    def sample(b: int):
        """Batch ``b``: [feats, src, dst, emask, labels, lmask] and its size."""
        gen = torch.Generator(device=device).manual_seed(seed + 101 + b)
        rng = np.random.default_rng(seed + 101 + b)
        with store.read_view() as view:
            sub = NeighborSampler(view.scan, fanouts=list(fanouts), seed=seed + 101 + b).sample(
                rng.choice(n, n_seeds, replace=False).astype(np.int64))
            nodes, src, dst, nmask, emask = pad_subgraph(sub, max_n, max_e)
        # the sampled edges fill the front of the padded list: shuffled, so
        # that every edge shard holds real edges and the partials meet
        perm = rng.permutation(max_e)
        src, dst, emask = src[perm], dst[perm], emask[perm]
        feats = torch.randn((max_n, d_feat), generator=gen, device=device)
        feats = feats * torch.from_numpy(nmask).to(device)[:, None]
        labels = (feats @ torch.randn(d_feat, generator=gen, device=device) > 0).int()
        batch = [feats, torch.from_numpy(src).to(device), torch.from_numpy(dst).to(device),
                 torch.from_numpy(emask).to(device), labels,
                 (torch.arange(max_n, device=device) < sub.n_seeds).float()]
        return batch, dict(sampled_nodes=sub.n_nodes, sampled_edges=len(sub.merged_edges()[0]))

    def run(name: str, batch, reverse: bool = False):
        b = list(batch)
        if reverse:
            b[1], b[2] = b[2], b[1]
        _, opt, met = steps[name](params, adamw.init(params, moment_dtype=torch.float32), *b)
        return float(met["loss"]), opt.mu

    t0 = time.perf_counter()
    first, first_size = sample(0)
    sample_s = time.perf_counter() - t0
    secs = {}
    for name in ("sharded", "single", "one_card"):
        if name in steps:
            run(name, first)
            _, secs[name] = wall(lambda: run(name, first), device)
    comm = emit_comm(GNN_ARCH, "minibatch_lg", mesh, lambda: run("sharded", first))
    batches, fault_err = [], None
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            # cuBLAS on one stream gives equal products for equal operands
            warnings.filterwarnings("ignore", message=".*CuBLAS")
            for b in range(MESH_GNN_BATCHES):
                batch, size = (first, first_size) if b == 0 else sample(b)
                sharded, control, single = (run(k, batch)
                                            for k in ("sharded", "control", "single"))
                same = sharded[0] == control[0] and all(
                    torch.equal(x, y) for x, y in zip(tree_leaves(sharded[1]),
                                                      tree_leaves(control[1])))
                if not same:
                    raise AssertionError(
                        f"mesh gnn batch {b}: the sharded step differs from the control: loss "
                        f"{sharded[0]} vs {control[0]}, leaves "
                        f"{leaf_errors(sharded[1], control[1])}")
                loss_err = abs(sharded[0] - single[0]) / abs(single[0])
                if not math.isfinite(sharded[0]) or loss_err > MESH_GNN_LOSS_RTOL:
                    raise AssertionError(f"mesh gnn batch {b}: loss {sharded[0]} vs single "
                                         f"{single[0]}")
                errs = leaf_errors(sharded[1], single[1])
                row = dict(size, loss=sharded[0], single_loss=single[0], loss_rel_err=loss_err,
                           bitwise_control=True, max_leaf_err_vs_single=max(errs),
                           worst_leaf=int(np.argmax(errs)))
                if b == 0:
                    gaps = leaf_errors(run("f32_wire", batch)[1], single[1])
                    row.update(leaf_errs_vs_single=errs, single_f32_wire_gaps=gaps)
                    fault_errs = leaf_errors(run("sharded", batch, reverse=True)[1], control[1])
                    if all(e <= MESH_GNN_GRAD_TOL for e in fault_errs):
                        raise AssertionError("mesh gnn: reversed edges pass the gradient check")
                    fault_err = max(fault_errs)
                batches.append(row)
    finally:
        torch.use_deterministic_algorithms(was)
    report = dict(arch=GNN_ARCH, cell="minibatch_lg", mesh=dict(mesh.shape), max_nodes=max_n,
                  max_edges=max_e, sample_s=sample_s, batches=batches,
                  loss_rtol=MESH_GNN_LOSS_RTOL, tolerance=MESH_GNN_GRAD_TOL,
                  reversed_max_leaf_err=fault_err, step_s=secs["sharded"],
                  single_step_s=secs["single"], one_card_step_s=secs.get("one_card"),
                  shard_devices=[str(d) for d in mesh.flat_devices], comm=comm)
    emit("mesh_gnn", **report)
    del first, params, steps
    free_device(device)
    return report


def phase_mesh_reduce(seed: int, device) -> dict:
    """Mesh part (d): ``MESH_SHARDS`` data shards each take BST gradients
    on a quarter of train_batch, compress them to int8 with error feedback
    (``compress_grads``) and reduce them over the ``data`` axis
    (``psum_compressed``); each leaf of the result within the reference's
    2 x scale (scale = the largest |gradient| of the leaf over the shards,
    over 127) of the plain f32 mean of the four gradients."""
    import torch

    from repro_torch.data.pipeline import RecsysBatches
    from repro_torch.launch.collectives import P, shard
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import bst as B
    from repro_torch.optim.compression import (
        compress_grads,
        init_error_feedback,
        psum_compressed,
    )
    from repro_torch.optim.tree import tree_leaves, tree_map
    from repro_torch.train.step import bst_value_and_grad

    _, cfg = model_configs()
    mesh = make_mesh((MESH_SHARDS,), ("data",), device=device)
    params = B.init_params(cfg, torch.Generator(device=device).manual_seed(seed + 110),
                           device=device)
    data = RecsysBatches(cfg.n_items, BST_TRAIN_BATCH, cfg.seq_len, cfg.n_other_feats,
                         seed=seed + 1)[0]
    keys = ("hist", "target", "other", "label")
    parts = {k: shard(torch.from_numpy(data[k]).to(device), mesh, P("data")) for k in keys}
    # data parallel: each shard's card holds a replica of the parameters
    replicas = {d: tree_map(lambda t, d=d: t.to(d), params) for d in set(mesh.flat_devices)}
    t0 = time.perf_counter()
    grads, qs, ss = [], [], []
    for k in range(mesh.size):
        _, g = bst_value_and_grad(cfg, replicas[mesh.flat_devices[k]],
                                  *[parts[key][k] for key in keys])
        (q, s), _ = compress_grads(g, init_error_feedback(g))
        grads.append(g)
        qs.append(q)
        ss.append(s)
    means = psum_compressed(qs, ss, mesh, "data")
    sync(device)
    reduce_s = time.perf_counter() - t0
    worst, payload, full = 0.0, 0, 0
    for i, mean in enumerate(tree_leaves(means[0])):
        shard_grads = [tree_leaves(g)[i].to(mean.device) for g in grads]
        plain = sum(shard_grads[1:], shard_grads[0]) / mesh.size
        scale = max(float(g.abs().max()) for g in shard_grads) / 127
        err = float((mean - plain).abs().max())
        if not (err < 2 * scale or err == 0.0) or not bool(torch.isfinite(mean).all()):
            raise AssertionError(f"mesh reduce leaf {i}: {err} not within 2 x scale {scale}")
        if any(not torch.equal(m_k.to(mean.device), mean)
               for m_k in (tree_leaves(m)[i] for m in means)):
            raise AssertionError(f"mesh reduce leaf {i}: the shards' means differ")
        worst = max(worst, err / (2 * scale) if scale else 0.0)
        payload += tree_leaves(qs[0])[i].numel()
        full += mean.numel() * 4
    report = dict(shards=mesh.size, shard_devices=[str(d) for d in mesh.flat_devices],
                  rows_per_shard=BST_TRAIN_BATCH // mesh.size,
                  leaves=len(tree_leaves(means[0])), max_err_over_2scale=worst,
                  int8_payload_bytes=payload, f32_payload_bytes=full, seconds=reduce_s)
    emit("mesh_reduce", **report)
    del params, replicas, grads, qs, ss, means, parts
    free_device(device)
    return report


def phase_mesh_elastic(seed: int, device) -> dict:
    """Mesh part (e): BST's parameters placed on a (4,) mesh by
    ``checkpoint.elastic.reshard`` (``item_emb`` as ``P("data", None)``,
    the rest replicated), saved as a checkpoint of full arrays, restored
    and placed on a (2,) mesh: every leaf round-trips bitwise."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.checkpoint.elastic import reshard
    from repro_torch.launch.collectives import P, unshard
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import bst as B
    from repro_torch.optim.tree import tree_leaves, tree_map

    _, cfg = model_configs()
    params = B.init_params(cfg, torch.Generator(device=device).manual_seed(seed + 120),
                           device=device)
    host = tree_map(lambda t: t.cpu().numpy(), params)
    specs = tree_map(lambda _: None, params)  # replicated: one copy a device
    specs["item_emb"] = P("data", None)

    def full(placed, mesh):
        return tree_map(lambda parts, spec: unshard(parts, mesh, spec or P()).cpu().numpy(),
                        placed, specs)

    mesh4, mesh2 = (make_mesh((s,), ("data",), device=device) for s in (4, 2))
    t0 = time.perf_counter()
    placed4 = reshard(host, specs, mesh4)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt.save(tmp, 0, full(placed4, mesh4))
        restored, _ = ckpt.restore(tmp, host)
    placed2 = reshard(restored, specs, mesh2)
    back = full(placed2, mesh2)
    seconds = time.perf_counter() - t0
    same = [np.array_equal(a.view(np.uint8), b.view(np.uint8))
            for a, b in zip(tree_leaves(back), tree_leaves(host))]
    rows4 = [tuple(t.shape) for t in placed4["item_emb"]]
    rows2 = [tuple(t.shape) for t in placed2["item_emb"]]
    if not all(same) or rows4 != [(cfg.n_items // 4, cfg.embed_dim)] * 4 \
            or rows2 != [(cfg.n_items // 2, cfg.embed_dim)] * 2:
        raise AssertionError("mesh elastic: the (4,) -> checkpoint -> (2,) round trip "
                             "is not bitwise or misplaced")
    report = dict(leaves=len(same), bitwise=True, item_emb_blocks_4=rows4,
                  item_emb_blocks_2=rows2, seconds=seconds,
                  bytes=int(sum(a.nbytes for a in tree_leaves(host))))
    emit("mesh_elastic", **report)
    del params, host, placed4, placed2, restored, back
    free_device(device)
    return report


# ---------------------------------------------------------------------------
# Phase 13: the two LMs that fit one card only in bf16, at full width
# ---------------------------------------------------------------------------
def lm_config(arch: str):
    from repro_torch.configs import registry

    return (registry.get_smoke_config if MODEL_SMOKE else registry.get_config)(arch)


def tree_bytes(params) -> int:
    from repro_torch.optim.tree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(params))


def n_global(cfg, cache_len: int) -> int:
    """Layers whose window covers a cache of ``cache_len`` rows: the ones the
    serve route sends to ``flash_decode``."""
    from repro_torch.models import transformer as T

    return sum(T.layer_window(cfg, loc, cache_len) >= cache_len for loc in T.layer_is_local(cfg))


def decode_steps(step, params, cache, tok, first: int, n: int, device) -> tuple:
    """``n`` greedy steps from position ``first``, each timed with the
    device drained: (seconds a step, flash_decode launches a step, the
    last logits, the next token [B, 1])."""
    from repro_torch.kernels.flash_decode import flash_decode

    step_s, per_step = [], []
    for i in range(n):
        n0 = flash_decode.launches
        (logits, nxt, _), sec = wall(lambda: step(params, cache, tok, first + i), device)
        step_s.append(sec)
        per_step.append(flash_decode.launches - n0)
        tok = nxt[:, None]
    return step_s, per_step, logits, tok


def wide_params(cfg, seed: int, device) -> tuple:
    """bf16 weights of ``cfg`` from the seed, made block by block of the
    leading axis (``models.common.DRAW_BLOCK``): (params, a report with the
    making's seconds and peak, which must stay within the tree, as the
    allocator holds it, plus its largest f32 block)."""
    import torch

    from repro_torch.models import common as C
    from repro_torch.models import transformer as T

    reset_peak(device)
    held = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
    gen = torch.Generator(device=device).manual_seed(seed)
    params, sec = wall(lambda: T.init_params(cfg, gen, dtype=torch.bfloat16, device=device),
                       device)
    nbytes = tree_bytes(params)
    shapes = T.lm_shapes(cfg)
    shapes = [sh for k, sh in shapes.items() if k != "layers"] + list(shapes["layers"].values())

    def block_bytes(shape):  # the f32 transient of one draw of a 2-D or wider leaf
        row = math.prod(shape[1:])
        return 4 * row * min(shape[0], max(1, C.DRAW_BLOCK // row))

    block = max(block_bytes(sh) for sh in shapes if len(sh) >= 2)
    report = dict(seconds=sec, param_bytes=nbytes, f32_block_bytes=block)
    if device.type == "cuda":
        # the tree as the allocator holds it (its blocks' rounding included)
        tree = torch.cuda.memory_allocated(device) - held
        report.update(tree_allocated_bytes=tree, init_peak_bytes=peak_bytes(device) - held)
        if report["init_peak_bytes"] > tree + block:
            raise AssertionError(f"{cfg.name}: making the bf16 weights peaked at "
                                 f"{report['init_peak_bytes']} bytes, above the tree ({tree}) "
                                 f"plus one f32 block ({block})")
    return params, report


def wide_decode(cfg, params, batch: int, seed: int, device, dtype=None,
                reduced: tuple = ()) -> dict:
    """decode_32k's shape in ``dtype`` (bf16 by default; f32 is the serve
    launcher's route) at ``batch``: the cache filled from the seed to
    DECODE_SEQ - DECODE_STEPS, one step through both routes (every
    ``flash_decode`` launch held against its plain version, the local
    layers through ``decode_attention_ref`` on both; logits finite and, in
    bf16, within 0.1 of their largest magnitude, in f32 within 3e-4), then
    DECODE_STEPS greedy steps through ``serve_attn_fn`` timed, one launch a
    global layer a step, and one more under the profiler (the device's
    busy time, ``flash_decode``'s device ms).  ``reduced`` adds the cuts
    of ``cfg`` to the report's."""
    import numpy as np
    import torch

    from repro_torch.kernels.flash_decode import route
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    from repro_torch.models import transformer as T
    from repro_torch.serve.decode import (make_decode_step, make_flash_attn_fn,
                                          make_serve_attn_fn, serve_attn_fn)

    dtype = dtype or torch.bfloat16
    bf16 = dtype == torch.bfloat16
    what = f"{cfg.name} decode {'bf16' if bf16 else 'f32'} at {DECODE_SEQ} rows"
    reset_peak(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    cache = T.init_cache(cfg, batch, DECODE_SEQ, dtype=dtype, device=device)
    first = DECODE_SEQ - DECODE_STEPS
    (_, setup_s) = wall(lambda: [cache[n][i, :, :first].normal_(generator=gen)
                                 for n in ("k", "v") for i in range(cfg.n_layers)], device)
    plain_flash = make_flash_attn_fn(flash_decode_ref)
    errs = []
    tok = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch, 1), dtype=np.int32)).to(device)
    lp, tp, _ = make_decode_step(cfg, dtype, attn_fn=make_serve_attn_fn(plain_flash))(
        params, cache, tok, first)
    lc, tc, _ = make_decode_step(cfg, dtype, attn_fn=make_serve_attn_fn(
        checked_attn_fn(plain_flash, errs)))(params, cache, tok, first)
    rtol, limit = (0.0, 0.1 * float(lp.abs().max())) if bf16 else (3e-4, 3e-4)
    err = check_logits(lc, lp, rtol, limit, what)
    globals_ = n_global(cfg, DECODE_SEQ)
    if len(errs) != globals_:
        raise AssertionError(f"{what}: {len(errs)} checked launches, want {globals_}")
    step = make_decode_step(cfg, dtype, attn_fn=serve_attn_fn)
    step_s, per_step, logits, tok = decode_steps(step, params, cache, tok, first, DECODE_STEPS,
                                                 device)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{what}: non-finite logits")
    if "flash_decode" in PATH_KERNELS["lm_wide"] and any(n != globals_ for n in per_step):
        raise AssertionError(f"{what}: flash_decode launches per step {per_step}, "
                             f"want {globals_}")
    busy_ms, prof_ms, kernel_ms = profiled_step(
        lambda: step(params, cache, tok, DECODE_SEQ - 1), device, match="flash_decode")
    median_ms = float(np.median(step_s)) * 1e3
    report = dict(
        config=cfg.name, layers=cfg.n_layers, batch=batch,
        reduced=[*reduced, f"decode_32k batch 128 -> {batch}"], cache_len=DECODE_SEQ,
        first_pos=first, steps=DECODE_STEPS, setup_s=setup_s, step_s=step_s,
        median_step_ms=median_ms, tok_per_s=batch * DECODE_STEPS / sum(step_s),
        launches_per_step=per_step, global_layers=globals_, route=route(dtype, cfg.d_head),
        checked_launches=len(errs), launch_max_abs_err=max(errs), max_abs_err=err,
        logits_rtol=rtol, logits_limit=limit, logit_absmax=float(lp.abs().max()),
        tokens_equal=bool(torch.equal(tc, tp)), profiled_step_ms=prof_ms,
        device_busy_ms=busy_ms,
        device_busy_share=None if busy_ms is None else busy_ms / median_ms,
        idle_share_median=None if busy_ms is None else 1.0 - busy_ms / median_ms,
        flash_decode_device_ms=kernel_ms,
        cache_bytes=2 * cache["k"].numel() * cache["k"].element_size(),
        peak_allocated_bytes=peak_bytes(device))
    emit("lm_wide_decode" if bf16 else "lm_wide_f32_long", **report)
    del cache
    free_device(device)
    return report


def wide_prefill(cfg, params, seed: int, device) -> dict:
    """prefill_32k in bf16 at batch PREFILL_BATCH, attn_chunk PREFILL_CHUNK:
    seconds, tokens/s, peak; the last position's logits finite and within
    0.1 of their largest magnitude of the same step's with attn_chunk
    PREFILL_CHECK_CHUNK on the same tokens (the last-only step on both
    sides: full logits would not fit)."""
    import numpy as np
    import torch

    from repro_torch.serve.decode import make_prefill_step

    reset_peak(device)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (PREFILL_BATCH, PREFILL_SEQ), dtype=np.int32)).to(device)
    step = make_prefill_step(cfg, torch.bfloat16, attn_chunk=PREFILL_CHUNK)
    last, sec = wall(lambda: step(params, toks), device)
    peak = peak_bytes(device)
    want, check_s = wall(lambda: make_prefill_step(
        cfg, torch.bfloat16, attn_chunk=PREFILL_CHECK_CHUNK)(params, toks), device)
    if not (bool(torch.isfinite(last).all()) and bool(torch.isfinite(want).all())):
        raise AssertionError(f"{cfg.name} prefill: non-finite logits")
    limit = 0.1 * float(want.float().abs().max())
    err = check_logits(last.float(), want.float(), 0.0, limit,
                       f"{cfg.name} prefill chunk {PREFILL_CHUNK} vs {PREFILL_CHECK_CHUNK}")
    report = dict(config=cfg.name, batch=PREFILL_BATCH, seq=PREFILL_SEQ,
                  reduced=[f"prefill_32k batch 32 -> {PREFILL_BATCH}"],
                  attn_chunk=PREFILL_CHUNK, seconds=sec,
                  tokens_per_s=PREFILL_BATCH * PREFILL_SEQ / sec, peak_allocated_bytes=peak,
                  check_chunk=PREFILL_CHECK_CHUNK, check_s=check_s,
                  max_abs_err=err, logits_limit=limit)
    emit("lm_wide_prefill", **report)
    return report


def wide_serve_f32(arch: str, seed: int, device) -> dict:
    """The serve launcher's f32 route (``make_decode_step(cfg, f32,
    serve_attn_fn)``) at its defaults (batch 4, 32 prompt tokens fed one by
    one, 32 decode tokens, max_seq 128), at full width and
    WIDE_F32_LAYERS[arch] layers: the loop timed as the launcher times it,
    one launch a layer a step (the window covers the 128-row cache); then
    the same loop from a fresh cache with every launch held against its
    plain version, and its logits against the timed loop's (3e-4)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.kernels.flash_decode import flash_decode, route
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    from repro_torch.models import transformer as T
    from repro_torch.serve.decode import (make_decode_step, make_flash_attn_fn,
                                          make_serve_attn_fn, serve_attn_fn)

    full = lm_config(arch)
    cfg = dataclasses.replace(full, n_layers=min(WIDE_F32_LAYERS[arch], full.n_layers))
    reset_peak(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = T.init_params(cfg, gen, dtype=torch.float32, device=device)
    prompt = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT), dtype=np.int32)).to(device)

    def serve(attn_fn):
        step = make_decode_step(cfg, torch.float32, attn_fn=attn_fn)
        cache = T.init_cache(cfg, SERVE_BATCH, SERVE_MAX_SEQ, dtype=torch.float32, device=device)
        for t in range(SERVE_PROMPT):
            _, nxt, cache = step(params, cache, prompt[:, t:t + 1], t)
        step_s, _, logits, tok = decode_steps(step, params, cache, nxt[:, None], SERVE_PROMPT,
                                              SERVE_DECODE, device)
        return logits, sum(step_s)

    n0 = flash_decode.launches
    logits, sec = serve(serve_attn_fn)
    launches = flash_decode.launches - n0
    want = (SERVE_PROMPT + SERVE_DECODE) * n_global(cfg, SERVE_MAX_SEQ)
    if "flash_decode" in PATH_KERNELS["lm_wide"] and launches != want:
        raise AssertionError(f"{arch} f32 serve: {launches} flash_decode launches, want {want}")
    errs = []
    checked, _ = serve(make_serve_attn_fn(checked_attn_fn(make_flash_attn_fn(flash_decode_ref),
                                                          errs)))
    if len(errs) != want:
        raise AssertionError(f"{arch} f32 serve: {len(errs)} checked launches, want {want}")
    err = check_logits(logits, checked, 3e-4, 3e-4, f"{arch} f32 serve, checked run")
    report = dict(config=cfg.name, layers=cfg.n_layers, full_layers=full.n_layers,
                  reduced=[f"layers {full.n_layers} -> {cfg.n_layers}"], batch=SERVE_BATCH, prompt=SERVE_PROMPT, decode_tokens=SERVE_DECODE,
                  max_seq=SERVE_MAX_SEQ, route=route(torch.float32, cfg.d_head),
                  decode_s=sec, tok_per_s=SERVE_BATCH * SERVE_DECODE / sec,
                  launches=launches, checked_launches=len(errs),
                  launch_max_abs_err=max(errs), max_abs_err=err,
                  param_bytes=tree_bytes(params), peak_allocated_bytes=peak_bytes(device))
    emit("lm_wide_f32", **report)
    if arch in WIDE_F32_LONG:
        report["long"] = wide_decode(cfg, params, WIDE_F32_LONG[arch], seed, device,
                                     dtype=torch.float32,
                                     reduced=[f"layers {full.n_layers} -> {cfg.n_layers}"])
    del params
    free_device(device)
    return report


def phase_lm_wide(seed: int, device) -> dict:
    """Phase 13: Gemma-2-27B and Qwen3-32B at full width on one card, after
    every other phase (the card must hold under 1 GB at its start): (a)
    Gemma-2's 46 layers in bf16 at decode_32k's shape (batch 1); (b) its
    prefill_32k on the same weights; (c) Qwen3's 64 layers in bf16 at
    decode_32k's shape (batch 2); (d) both through the serve launcher's f32
    route at cut depth.  Each model's weights are freed before the next
    are made."""
    import torch

    free_device(device)
    held = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
    if held >= 1 << 30:
        raise AssertionError(f"lm_wide: the card holds {held} bytes at the start")
    report = {}
    for i, arch in enumerate(WIDE_ARCHS):
        cfg = lm_config(arch)
        params, made = wide_params(cfg, seed + 60 + i, device)
        emit("lm_wide_params", config=cfg.name, **made)
        report[arch] = dict(params=made, decode=wide_decode(
            cfg, params, WIDE_DECODE_BATCH[arch], seed + 62 + i, device))
        if arch == "gemma2-27b":
            report[arch]["prefill"] = wide_prefill(cfg, params, seed + 64, device)
        del params
        free_device(device)
    for i, arch in enumerate(WIDE_ARCHS):
        report[arch]["f32"] = wide_serve_f32(arch, seed + 66 + i, device)
    if device.type == "cuda":  # each part reset the peak: the phase's is theirs
        report["peak_allocated_bytes"] = max(
            part.get("peak_allocated_bytes") or part.get("init_peak_bytes") or 0
            for model in report.values() for part in model.values())
    return report


def run_models(seed: int, device, launches: dict) -> dict:
    """Phases 7-13 and the mesh phase's parts (a), (b), (d), (e), phase 13
    last; returns the model kernels' records."""
    import torch

    free_device(device)
    if device.type == "cuda":
        emit("model_start", allocated_bytes=torch.cuda.memory_allocated(device))
        torch.cuda.reset_peak_memory_stats(device)
    kernels = phase_model_kernels(seed, device)
    counted("lm_serve", launches, phase_lm_serve, seed, device)
    counted("recsys_serve", launches, phase_recsys_serve, seed, device)
    peaks = [peak_bytes(device)]  # the later phases reset the peak when they start
    for path, phase in (("lm_prefill", phase_lm_prefill), ("lm_train", phase_lm_train),
                        ("recsys_train", phase_recsys_train), ("mesh_bst", phase_mesh_bst),
                        ("mesh_granite", phase_mesh_granite), ("mesh_reduce", phase_mesh_reduce),
                        ("mesh_elastic", phase_mesh_elastic), ("lm_wide", phase_lm_wide)):
        report = counted(path, launches, phase, seed, device)
        # a phase of several parts resets the peak per part and reports its own
        peaks.append(max(peak_bytes(device) or 0, report.get("peak_allocated_bytes") or 0))
    if device.type == "cuda":
        emit("memory", phases="7-13", peak_allocated_bytes=max(peaks))
    return kernels


# ---------------------------------------------------------------------------
# the kernels each counted phase calls: each must launch in its phase
PATH_KERNELS = {
    "main": ("leaf_search", "leaf_scan_reduce", "leaf_spmm", "intersect_count"),
    "isolation": ("leaf_search", "leaf_scan_reduce", "leaf_spmm"),
    "readers": ("leaf_search", "leaf_scan_reduce"),
    "shard_plane": ("leaf_spmm",),
    "write_side": ("leaf_search", "leaf_scan_reduce"),
    "gnn_train": (),  # segment ops are torch ops: no hand kernel on this path
    "durability": ("leaf_search", "leaf_scan_reduce", "leaf_spmm", "intersect_count"),
    "triangles": ("intersect_count",),
    # this process's one-process plane (each rank counts its own launches)
    "multiprocess": ("leaf_spmm",),
    "baselines": ("leaf_search",),
    "lm_serve": ("flash_decode",),
    "lm_prefill": (),  # flash attention and MoE are torch ops: no hand kernel
    "lm_train": (),
    "recsys_serve": ("embedding_bag",),
    "recsys_train": ("embedding_bag",),
    # the mesh phase: the sharded lookup takes one embedding_bag launch a
    # shard; SP attention, the sharded MoE, the GNN gather/scatter and the
    # reshard are torch ops (mesh_granite's flash_decode launches are its
    # single-device comparison route's)
    "mesh_bst": ("embedding_bag",),
    "mesh_granite": (),
    "mesh_gnn": (),
    "mesh_reduce": ("embedding_bag",),
    "mesh_elastic": (),
    # Gemma-2-27B and Qwen3-32B: the global layers' decode attention
    "lm_wide": ("flash_decode",),
}


# the paths that spread over the visible cards: with more than one card
# each prints a ``cards`` line and must launch its kernels on every card
MULTI_CARD_PATHS = ("shard_plane", "multiprocess", "mesh_bst", "mesh_granite", "mesh_gnn",
                    "mesh_reduce", "mesh_elastic")


def n_cards() -> int:
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 1


@contextmanager
def uncounted():
    """Launches inside (a kernel held against its plain version, or timed
    alone) are taken off every count again, per wrapper and per card."""
    from repro_torch.kernels.runtime import card_launches, launch_counters, reset_launches

    wrappers = {name: w.launches for name, w in launch_counters().items()}
    cards = card_launches()
    try:
        yield
    finally:
        reset_launches(wrappers, cards)


def counted(path: str, launches: dict, fn, *args):
    """``fn(*args)`` with every launch counter set to 0 just before and read
    just after into ``launches[path]``; raises if a kernel of the path
    never launched.  A path of ``MULTI_CARD_PATHS`` on several cards
    prints a ``cards`` line: each card's launches (``runtime``'s per-card
    count), its ``max_memory_allocated`` (cards other than 0 reset at the
    start; card 0's since the phase's own reset) and the bytes
    ``collectives.shard`` copied between devices in the phase; it raises
    if a kernel of the path never launched on some card."""
    import torch

    from repro_torch.kernels.runtime import card_launches, launch_counters, reset_launches
    from repro_torch.roofline.comm import COPY, CommCounter

    cards = n_cards() if path in MULTI_CARD_PATHS else 1
    for k in range(1, cards):
        torch.cuda.reset_peak_memory_stats(k)
    wrappers = launch_counters()
    reset_launches()
    with CommCounter() as comm:
        result = fn(*args)
    launches[path] = {name: w.launches for name, w in wrappers.items()}
    missing = [n for n in PATH_KERNELS[path] if launches[path][n] <= 0]
    if missing:
        raise AssertionError(f"{path}: kernels never launched: {missing}")
    if cards > 1:
        per_card = card_launches()
        counts = [per_card.get(k, 0) for k in range(cards)]
        emit("cards", path=path, launches=counts,
             max_memory_allocated=[torch.cuda.max_memory_allocated(k) for k in range(cards)],
             shard_copy_bytes=comm.stats()["bytes_by_op"].get(COPY, 0.0),
             shard_copies=comm.stats()["counts"].get(COPY, 0))
        if PATH_KERNELS[path] and min(counts) <= 0:
            raise AssertionError(f"{path}: no launch on some card: {counts}")
    return result


def run(seed: int, device) -> dict:
    """Phases 1-13 on ``device``; returns the per-kernel records."""
    import torch

    if device.type == "cuda":
        phase_build()
    store, build_info = build_store(SCALE, seed, device)
    r0, ops0, info = pin_view(store, build_info, seed, device)
    kernels = phase_kernels(r0.view, ops0, device)
    launches = {}
    first = counted("main", launches, phase_main, store, r0, ops0, info, seed, device)
    counted("isolation", launches, phase_isolation, r0, ops0, first, device)
    store.end_read(r0)
    counted("readers", launches, phase_readers, store, seed, device)
    prior_peak = counted("shard_plane", launches, phase_shard_plane, store, seed, device)
    counted("write_side", launches, phase_write_side, store, seed, device)
    prior_peak = max(prior_peak, counted("gnn_train", launches, phase_gnn_train, store,
                                         seed, device))
    counted("mesh_gnn", launches, phase_mesh_gnn, store, seed, device)  # the mesh phase's (c)
    del store, r0, ops0, first
    counted("durability", launches, phase_durability, seed, device)
    tc_store, tc_info, tc_host = counted("triangles", launches, phase_triangles, TC_SCALE,
                                         seed, device)
    try:
        triangle_split(tc_store, tc_info, device)
        phase_shard_symmetric(tc_store, device)
        counted("multiprocess", launches, phase_multiprocess, tc_store, seed, device)
        counted("baselines", launches, phase_baselines, tc_store, seed, device)
        del tc_store
        if device.type == "cuda":
            emit("memory", phases="1-6", peak_allocated_bytes=max(
                prior_peak, torch.cuda.max_memory_allocated(device)))
        kernels.update(run_models(seed, device, launches))
        hold_host_triangles(tc_host, tc_info)
    finally:
        tc_host.close()
    for name, rec in kernels.items():
        source, replaces = KERNELS[name]
        rec.update(route="cuda", source=source, replaces=replaces,
                   launches=launches[KERNEL_PATH[name]][name],
                   launches_by_path={p: c[name] for p, c in launches.items()})
    return kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the data and operands")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: cannot import repro_torch next to this script: {exc}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = phase_card(device)
    emit("config", scale=SCALE, tc_scale=TC_SCALE, seed=args.seed,
         partition_size=64, B=512, edge_factor=16, spmm_d=D_FEATURES, lm=LM_ARCH,
         decode_batch=DECODE_BATCH, decode_seq=DECODE_SEQ, serve_batches=SERVE_BATCHES,
         n_candidates=N_CANDIDATES, gnn=GNN_ARCH, gnn_seeds=GNN_SEEDS,
         gnn_fanouts=GNN_FANOUTS, gnn_d_feat=GNN_D_FEAT, gnn_steps=GNN_STEPS)
    kernels = run(args.seed, device)
    emit("total", seconds=time.monotonic() - START)
    order = list(KERNELS)
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "launches_by_path"]
    print(json.dumps({"kernels": [{k: kernels[n][k] for k in keys} for n in order]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
