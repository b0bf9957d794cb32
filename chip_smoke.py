#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card: builds the Hopper kernels from this checkout, checks each against
its plain PyTorch version, and drives the main paths — one mixed batch
at a time through ``CoreMaintainer.apply_batch`` on the unified engine,
unweighted and weighted, on the host engine, and on the sharded engine
(replicated and range-sharded vertex state) over a world of one NCCL
rank — at full width, serves the GNN stack (PNA, GIN, DimeNet,
NequIP) at ``full()`` width on the GNN cells, serves the LM stack
(qwen2-7b, qwen3-8b and yi-34b with every prefill attention on the
attention kernel, and deepseek-v2-lite-16b) at ``full()`` width and
depth, trains on the card (qwen2-7b at full width, the dynamic-graph
GNN trainer whose maintainer launches the core-maintenance kernels
between steps, and ``launch/steps.py``'s train cells), runs the sharded
paths (``parallel/sharding.py``'s placements, the LM and GNN pins, the
pod dry-run) over a world of one NCCL rank, and audits the main path's
batch program on both kernel backends (``repro_torch.analysis``).

    python3 chip_smoke.py            # needs one CUDA card and nvcc

Phases:
  1. build the kernels, printing each one's registers and spills from
     ``ptxas -v``; print the card's name and power limit;
  2. small-scale correctness: replay ``mixed_stream`` and
     ``churn_stream`` on an n ~ 2,000 graph with ``kernel_backend="cuda"``,
     cores checked against the BZ oracle after every batch, and cores,
     labels and all 12 batch statistics equal to a
     ``kernel_backend="torch"`` replay on the card; then the same
     replays on weighted maintainers with random weights 1-5 on every
     insert list, cores checked against the weighted peeling oracle,
     and cores, labels, the weight column and the statistics equal
     between the two backends. The unweighted replays also run on an
     ``engine="host"`` maintainer with ``batch`` free slots (so it
     compacts): cores against BZ, labels equal to the unified replay's,
     no coremaint kernel launched (label placement runs
     ``kernels/order.py`` on every engine on the card);
  3. each kernel against its plain version on the main path's state
     (the RMAT graph of phase 4: window of ~2^24 slots, n = 2^21), with
     0 mismatches required, timed with CUDA events beside its byte bound
     (``din`` and ``same_in`` under a 50% random mask); ``coo_stat[wsum]``
     on the weighted maintainer's state of phase 5;
     ``fused_removal_round`` and ``coo_stat[wsum]`` also on a shuffled
     copy of their window (one seeded random slot order, no runs of one
     src), held to their plain versions and to the sorted window's
     result;
  4. the main path on ``rmat(21, 16_000_000)``: a 100,000-edge removal
     burst, its re-insertion, then mixed batches of 100,000 edits; per
     batch the wall time, round counts and kernel launches; at the end
     the cores against a fresh peel and the k-order certificate. The
     masks of the burst pair's ``din`` and ``same_in`` calls are recorded
     (``coremaint.record_masks``, device copies, no sync); after the
     batches each mask's popcount and share of touched live slots are
     printed, and ``din`` and ``same_in`` are held to their plain
     versions and timed on phase 3's window under the median-touch and
     the max-touch mask (``path_mask_*`` keys of their rows). Then the
     applications on the final state: ``kcore_edge_mask(m, kmax)`` and
     ``densest_region_vertices`` against their numpy definitions;
 4b. phase 4's batches on ``from_graph(init="jax-peel", engine="host")``
     of the same graph (the seed two-call path: host dedup against the
     ``edge_slot`` dict, plain PyTorch fixpoints on the card): after each
     batch the cores, labels, ``n_inserted`` and ``n_removed`` equal
     phase 4's, and no launch counter of kernels a-h moved; per batch the wall
     time split into host dedup, device fixpoints, renumber gate and
     compaction, with the rounds; once the time to build the
     ``edge_slot`` dict; at the end the cores against a fresh peel and
     the k-order certificate;
  5. the weighted main path on the same graph with weights 1-5:
     ``from_graph(weighted=True, weights=...)``, the same burst removed
     and re-inserted with its own weights, then phase 4's mixed batches
     with random weights; per batch the wall time, round counts and
     ``coo_stat[wsum]`` launches (one per bisection step); at the end
     the cores against a fresh weighted ``from_graph``, the live weight
     column against a host mirror, and the labels canonical;
  6. the kernels of ``kernels/ops.py`` against their plain versions at
     the shapes phase 7 gives them, timed with CUDA events beside their
     bounds, on the ELL matrix of ``erdos_renyi(2**21, 16_000_000)``:
     ``ell_stat``, bit for bit, on its core numbers (the four ops on
     int32 cores, ``sum`` and ``max`` on float32 cores plus seeded
     noise, ``count_ge`` and ``sum`` on int64 cores), and
     ``ell_aggregate`` (sum and max, float32 and bfloat16) with
     ``[n, 100]`` features, with ``embedding_bag`` timed beside
     ``ell_aggregate`` and the float32 ``ell_stat`` rows, and each row's
     ``gather_bound_ms`` beside its byte bound (the 32-byte sectors its
     live gathers touch, plus ``nbrs`` and the output, over 3.35 TB/s);
     ``fm_interaction`` on DeepFM's
     ``[262144, 39, 10]`` serving embeddings; ``flash_attention`` at
     qwen2-7b's heads (28 query, 4 kv, D = 128) on a 1 x 4,096 cut of
     ``prefill_32k``, causal bfloat16 (the wgmma + TMA kernel) and full
     float32 (the register-tiled FFMA kernel), with
     ``scaled_dot_product_attention`` timed beside it, each row with its
     TFLOP/s, share of the bound and registers and spills (each library
     call held once to the plain version too);
  7. the slice's path, launch counts from 0: (a) DeepFM ``full()``
     serving with ``use_pallas_fm=True`` at ``serve_p99``, ``serve_bulk``
     and ``retrieval_cand``, logits against the plain branch, and the FM
     kernel on ``serve_p99``'s ``[512, 39, 10]`` embeddings as a kernels
     row of its own (``fm_interaction[f32] serve_p99``); (b) the
     kernel API on the ER graph's core-maintenance state, ``ell_stat``'s
     ``count_ge`` / ``count_gt`` equal bit for bit to ``coo_stat``'s
     ``mcd`` / ``hi`` over the maintainer's slot window (``count_ge`` on
     int64 cores too), ``mcd >= core``, phase 6's other ``ell_stat``
     instances and ``ell_aggregate`` (float32 and bfloat16) checked as in
     phase 6;
     (c) ``flash_attention`` once in each of phase 6's cases. Each row of
     the kernels line is one kernel instance (an op, a dtype, a mask),
     and its launches are that instance's;
  8. (run after phase 5) ``engine="sharded"`` on a world of one NCCL rank
     on ``cuda:0`` (``launch.mesh.make_edge_mesh``), ``kernel_backend=
     "cuda"``, from a device copy of the state phase 4 started from
     (no second peel), through phase 4's burst pair and mixed batches:
     after every batch the cores, labels, ``n_inserted``, ``n_removed``,
     the rounds and ``high_water`` equal phase 4's, and the slot table
     equals the unified engine's (one shard: ascending slot ids); per
     batch the wall time beside phase 4's, the launches of each kernel
     instance (under a mesh axis kernel a's ``mcd_hi_dout`` and
     ``hi_dout`` run where the fused b and c run on one device; b and c
     must stay at 0) and the all-reduce / all-gather counts and bytes
     from ``vertex_layout.record_traffic``; at the end the cores against
     a fresh peel and the k-order certificate. Then the same for phase
     5's weighted batches from a copy of phase 5's starting state (the
     ``wsum`` launches). Then both again with ``vertex_sharding=
     "range"`` (owned slices, a halo working set a batch, the ring
     placement; at one rank the halo is every referenced vertex), each
     batch's wall also beside the replicated pass's, the collectives
     with their reduce-scatter and ``ppermute`` counts, and each pass's
     ``max_memory_allocated`` (peak statistics reset at its start).
     NCCL's communicator is built by the maintainer's set-up
     collective. Then three more passes, each beside the range pass of
     its phase: (i) phase 4's batches on ``vertex_sharding="halo"`` over
     the 2-axis ``(1, 1)`` mesh (``make_edge_vertex_mesh``: the
     ``psum_edge`` all-reduce over a one-rank edge group, the table
     group) with ``frontier_exchange="sparse"`` and the planned cap;
     (ii) phase 5's weighted batches on the same mesh, dense (the
     weighted fixpoints never refresh sparsely); (iii) phase 4's batches
     on ``"range"`` with the sparse exchange at a pinned cap, a power of
     two between the smallest and the largest per-batch
     ``max_frontier`` of the range pass, which must overflow in some
     batch and not on every refresh of some batch. Each prints per batch
     ``n_overflow``, ``max_frontier`` and the ``psum_edge`` /
     ``gather_frontier`` counts and bytes. The kernels line's coremaint
     rows gain ``sharded_launches``, ``range_launches`` and
     ``halo_launches`` (passes i / ii), and the ``mcd_hi_dout`` /
     ``hi_dout`` rows' ``launches`` are phase 8's.

  9. (run after phase 4, before 4b) the GNN stack at ``full()`` width,
     TF32 off, on ``GNN_SHAPES``' cells, each forward the median of 5
     CUDA-event walls after a warm-up with ``max_memory_allocated``
     reset first: PNA on ``load_cora_like()`` (``full_graph_sm``) and
     on ``ogb_products`` at full size (2,449,408 nodes, 61,859,328
     edges, ``launch/steps.py``'s draws, features drawn on the card;
     its peak checked at most 2.25 ``[E, 75]`` tensors over the
     inputs); GIN on a ``NeighborSampler(g, (15, 10))`` block of phase
     4's graph around 1,024 seeds drawn with ``core_sampling_weights``
     of phase 4's final maintainer (validity checked against ``g``),
     features of width 602; DimeNet (float32 and bfloat16) and NequIP
     energy and forces on ``random_molecule_batch(128, 30, 64)`` with
     ``build_triplets``' 16,384 triplets. Each output against the same
     module moved to the CPU at the tier-1 tests' tolerances
     (``ogb_products``: two card forwards); NequIP under a seeded
     rotation (``phase_gnn``'s docstring). One line a model and cell:
     wall, peak memory, nodes, edges, triplets.
 10. (run after phase 2, on a card nothing else holds) the LM stack at
     ``full()`` width and depth, TF32 off, random weights drawn on the
     card from seeded generators, walls as CUDA events (the median of 5
     after a warm-up, ``max_memory_allocated`` reset first), each model
     started on a freed card, under 1 GB allocated (``phase_lm``'s
     docstring): qwen2-7b in bfloat16 on the kernel path
     (``kernel_backend="cuda"``: ``flash_attention`` once a layer a
     prefill) against the plain path and float32 at 1 x 4,096, with a
     teacher-forced decode; ``prefill_32k`` cut to batch 1 (against the
     reference's streaming path on 4 layers); ``decode_32k`` cut to
     batch 16 and ``long_500k`` at batch 1, 64 greedy steps each; a
     2-layer cut against the CPU; deepseek-v2-lite-16b (MLA + MoE, the
     plain path) at 1 x 4,096 with 16 decode steps, and its 2-layer cut
     against the CPU in float32; qwen3-8b (``qk_norm``) as qwen2-7b at
     1 x 4,096 and its 2-layer cut; yi-34b, all 60 layers on one card,
     1 x 4,096 on both paths, 16 decode steps, its peak beside the
     card's memory, and its 2-layer cut.
     One line a part: wall, peak memory, tokens, launches. The
     ``flash_attention`` rows gain ``lm_launches`` (phase 10's), and a
     row times the kernel at 1 x 32,768 on layer 0's q, k, v.

 11. (run after phase 9, before 4b) training on the card, TF32 off
     (``phase_train``): (a) qwen2-7b at ``full()`` width cut to 4 of 28
     layers (2,022,229,504 parameters; 28 would hold ~91 GB of weights,
     gradients and moments), bfloat16, ``run_training`` for 5 steps of
     ``synthetic_lm_batches`` at 2 x 4,096 with ``micro_batches=2``:
     each step's wall (CUDA events) and tokens/s, loss, grad norm and
     lr, ``max_memory_allocated``; every metric finite, the grad norm
     above 0, every parameter tensor moved but the norm scales (at 1.0
     a bf16 ulp swallows their update: no master copy, as in the
     reference), ``flash_attention``'s launches unchanged (training
     runs the plain attention); (c) that state saved once and restored
     once into fresh tensors, timed, bit for bit; at ``smoke()`` width
     under ``torch.use_deterministic_algorithms`` (a child process) a
     run interrupted by a SIGTERM it sends itself inside the loop and
     resumed from its checkpoint equals an uninterrupted run bit for
     bit; ``python -m repro_torch.launch.train --smoke --steps 20
     --ckpt-dir DIR`` twice, the second resuming; (b) one training step
     at full width, 1 layer, float32, on the card and on the CPU from
     the same weights (``phase_train_cpu``'s tolerances); (d)
     ``examples/train_gnn_torch.py``'s trainer at n = 100,000, m = 4n,
     60 bursts of 1,000 edges: the coremaint launch counts from 0
     before it and read after it (a, b and c each launched), the final
     cores against a fresh peel and the certificate, the loss improved;
     (e) ``build_cell`` train cells at ``full()``, one step each (DeepFM
     ``train_batch``, PNA ``full_graph_sm``, GIN ``minibatch_lg``,
     DimeNet and NequIP ``molecule``, PNA ``ogb_products`` cut to 1/8 of
     its nodes and edges) with wall, peak memory and finiteness, and
     the coremaint ``remove_100k`` / ``insert_100k`` cells (n =
     4,847,571, 140,000,256 slots) with the cores after the step equal
     to a fresh peel. The rows of kernels a, b and c in the kernels line
     gain ``train_launches`` (phase 11d's).
 12. (run after phase 8, in its world of one NCCL rank) the sharded
     paths (``phase_sharded_models``): (a) qwen2-7b ``full()`` prefill
     at 1 x 4,096 with its parameters placed by ``shard_params`` over a
     ``(1, 1)`` mesh and ``launch/steps.py``'s pinned config, on kernel h
     through ``local_map`` (28 launches a prefill), logits and caches
     against the unsharded prefill of the same weights, both timed; (b)
     ``build_cell``'s pinned PNA ``full_graph_sm`` and DimeNet
     ``molecule`` (bf16) steps on placed inputs against their unpinned
     steps, and the qwen2-7b ``train_4k`` cell under ``multi_pod`` on a
     ``(1, 1, 1)`` mesh cut to 2 layers at 2 x 4,096 against its step on
     plain tensors; (c) ``python -m repro_torch.launch.dryrun
     --both-meshes`` over six cells as a child process started first:
     each cell's ``model_flops`` share of its matmul FLOPs x devices
     held within 25% of the CPU's, its collective bytes by kind,
     argument bytes and dominant roofline term printed. The attention
     rows of the kernels line gain ``sharded_launches`` (12a's).
 13. (run after phase 4, before phase 9) the auditor on the card at full
     size (``phase_audit``): two maintainers from phase 4's starting
     state, ``kernel_backend="cuda"`` and ``"torch"``, each apply phase
     4's first mixed batch (launch counts from 0) under
     ``analysis.walker.RoundRecorder``, ``torch.profiler`` and the
     sync-debug mode (warn), the peak memory reset first: the cores and
     labels are equal; each removal and promotion round (the ops between
     two of its loop-condition syncs, a ``record_function`` range each)
     of ``"cuda"`` launches strictly fewer CUDA kernels
     (``walker.profile_round_kernels``, as the card audit counts them)
     than the same round of ``"torch"`` (each ratio printed) over equal
     c10d schedules (none on one device); the recorded syncs are the
     sync-debug warnings, each named in ``hostlint.SYNC_SITES``, each
     loop condition exactly once an iteration of its loop (rounds, waves
     and eviction rounds as ``walker.LoopCounter`` counts them), the
     lane uploads six, and every other sync as often as the unified
     manifest's card section (``"1x1@cuda"``) counts it; the torch run's
     peak stays within 1.5x the manifest's peak formula at this size
     (the recorder cannot see CUB's sort workspace); the narrowing check
     on fresh copies finds no value outside its type; and ``python -m
     repro_torch.analysis.audit --engine unified,cuda,sharded --device
     cuda`` (``sharded``: the ``cuda`` config's torch twin), a child
     started first, passes against the committed manifests with every
     check run. The rows of kernels a, b and c gain
     ``audit_launches``.

 14. (run after phase 3) label placement's level kernels
     (``kernels/order.py`` ``place_levels``, ``csrc/order.cu``) at the
     sizes of the benchmark's cells: n = 2,097,152 over 771 levels
     (power-law, as ``rmat-s21``) and n = 4,847,571 over 13 levels (as
     ``er-livej``), unique gap-spaced labels, 1% and 30% of the vertices
     moving: the labels equal ``core/order.py``'s plain path
     (``place_levels_plain``) bit for bit at the head and the tail, no
     vertex on the spill path; the kernels and the plain level
     reductions timed with CUDA events from the same ranks, beside the
     byte bound (core, moving, label and the output once, the movers'
     ranks) and the sort that ``place_block`` runs before them. Its row
     of the kernels line counts phase 4's launches.

The sizes are fixed below; ``scripts/profile_burst.py`` profiles a burst
at the same size (``--engine host``: on the host engine).

Prints one ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` name and
power limit, and as the last line ``{"ok": true, "device": {...}}``.
Exits non-zero (printing no result) without a CUDA device, outside a
checkout of the repository, or when any phase fails.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# int32 ALU: 64 INT32 lanes an SM x 132 SMs x 1.98 GHz boost clock (the
# 67 TFLOP/s fp32 peak is 128 lanes counting an FMA as two operations)
INT32_OPS_PER_S = 64 * 132 * 1.98e9

# the main path: the paper's mid-size real-graph scale and its
# 100,000-edge burst protocol (benchmarks/workloads.py)
SCALE = 21                # log2 vertices of the RMAT graph
EDGES = 16_000_000        # RMAT edges drawn, before build_csr's dedup
BURST = 100_000           # edges removed, then re-inserted, in one batch
MIXED_BATCHES = 4         # mixed_stream batches after the burst pair
MIXED_SIZE = 100_000      # edits per mixed batch
MAX_WEIGHT = 5            # weights drawn uniformly from 1..MAX_WEIGHT
SMALL_N = 2048            # phase 2's graphs
SMALL_BATCHES = 6
SMALL_BATCH = 200
ITERS = 20                # timed launches per kernel in phase 3
PALLAS = "src/repro/kernels/coremaint.py"
REPLACES = {"coo_stat": f"{PALLAS}:262",
            "fused_removal_round": f"{PALLAS}:350",
            "fused_promotion_stats": f"{PALLAS}:449",
            "coo_stat[wsum]": f"{PALLAS}:241",
            "ell_stat": "src/repro/kernels/segment_ell.py:120",
            "ell_aggregate": "src/repro/kernels/segment_ell.py:212",
            "fm_interaction": "src/repro/kernels/fm_interaction.py:35",
            "flash_attention": "src/repro/kernels/flash_attention.py:85"}
# phases 6-7: the paper's ER family at the main path's scale (ER, not RMAT:
# RMAT hubs make the [n, max_deg] ELL matrix unbounded), the ogb_products
# GNN cell's feature width, DeepFM full() at the recsys cells, and
# qwen2-7b's attention heads on a 1 x 4,096 cut of prefill_32k (32 x 32,768)
ER_N = 2**21
ER_M = 16_000_000
D_FEAT = 100              # GNN_SHAPES ogb_products d_feat
FM_BATCH = 262_144        # RECSYS_SHAPES serve_bulk
ATTN = dict(b=1, h=28, hkv=4, s=4096, d=128)  # configs/qwen2_7b.py heads
SERVE_CALLS = 5           # timed serving calls a cell, after a warm-up
GNN_SEEDS = 1024          # GNN_SHAPES minibatch_lg batch_nodes (phase 9)
FP32_PEAK = 67e12         # float32 FLOP/s outside the tensor cores
BF16_PEAK = 989e12        # bfloat16 tensor-core FLOP/s, dense
NO_LIBRARY = {
    "ell_stat": "no single PyTorch call: count_ge / count_gt compare each "
                "neighbour with the row's own value, and embedding_bag, "
                "which gathers and reduces ELL rows, takes no integer "
                "table (int32 and int64 core numbers here)",
    "fm_interaction": "no single PyTorch call computes the FM "
                      "second-order term",
}
# phase 10: qwen2-7b's prefill_32k cut to 1 x 4,096 (then teacher-forced
# decode steps), the reference's streaming chunk for the full cells
# (launch/steps.py) on the first layers, decode_32k's 128 rows cut to 16
LM_PREFILL = 4096
LM_TF_STEPS = 8
LM_CHUNK = 2048
LM_CHUNK_LAYERS = 4
LM_DECODE_BATCH = 16
LM_DECODE_STEPS = 64
LM_CPU_LAYERS = 2         # the card-vs-CPU cut
LM_CPU_PROMPT = 256
LM_MOE_STEPS = 16
LM_YI_STEPS = 16          # yi-34b's greedy decode steps
LM_F32_CHUNK = 1024       # the float32 yardstick's attention chunk (yi-34b)
# full() parameters, norm scales and biases included (bf16 bytes: twice
# these; no float32 router)
LM_FULL_PARAMS = {"qwen2-7b": 7_615_616_512, "qwen3-8b": 8_190_735_360,
                  "yi-34b": 34_388_917_248}
# phase 11: qwen2-7b full() width cut to 4 layers for training (PERF.md
# §4: ~24 GB of bf16 weights and gradients and float32 moments), the
# card-vs-CPU step at 1 layer, the dynamic-graph GNN trainer's scale,
# the train cells at full(), PNA ogb_products cut to 1/8 for training
TRAIN_LAYERS = 4
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_MB = 2, 4096, 5, 2
TRAIN_CPU_BATCH, TRAIN_CPU_SEQ = 2, 128
GNN_TRAIN = dict(n=100_000, steps=60, burst=1000)
TRAIN_CELLS = (("deepfm", "train_batch"), ("pna", "full_graph_sm"),
               ("gin-tu", "minibatch_lg"), ("dimenet", "molecule"),
               ("nequip", "molecule"))
OGB_TRAIN_CUT = 8
# phase 12: the sharded paths over a world of one NCCL rank, qwen2-7b's
# train_4k under multi_pod cut to 2 layers at 2 x 4,096 (full width),
# the dry-run child's cells and, for each and each mesh, the share of its
# per-device matmul FLOPs x devices that model_flops explains, as the CPU
# measured it (torch 2.13; PERF.md), held within +-25% (pna:
# model_flops has no closed form, so the ratio is 0 and dot_flops > 0)
P12_TRAIN_LAYERS, P12_TRAIN_BATCH = 2, 2
P12_CELLS = ("qwen2-7b:train_4k", "qwen2-7b:prefill_32k",
             "qwen2-7b:decode_32k", "deepseek-v2-lite-16b:decode_32k",
             "pna:full_graph_sm", "deepfm:retrieval_cand")
P12_RATIO = {
    ("qwen2-7b", "train_4k"): (0.2339, 0.2339),
    ("qwen2-7b", "prefill_32k"): (0.06137, 0.06137),
    ("qwen2-7b", "decode_32k"): (0.5463, 0.5463),
    ("deepseek-v2-lite-16b", "decode_32k"): (0.02936, 0.01488),
    ("pna", "full_graph_sm"): (0.0, 0.0),
    ("deepfm", "retrieval_cand"): (0.9996, 0.9996),
}  # (16x16, 2x16x16)
P12_DRYRUN_TIMEOUT = 600
BF16_STILL = ("final_norm", "layers.ln_attn", "layers.ln_ffn")
P13_PEAK_MARGIN = 1.5     # phase 13: the torch run's peak over the formula
P13_AUDIT_TIMEOUT = 300   # phase 13's audit child (--device cuda)
# phase 13: core/api.py's apply_batch uploads the unweighted maintainer's
# six padded lane arrays (iu, iv, iok, ru, rv, rok), one sync each
P13_LANE_UPLOADS = 6
# phase 6's ell_stat rows: (op, values), values from stat_values
STAT_ROWS = (("count_ge", "i32"), ("count_gt", "i32"), ("sum", "i32"),
             ("max", "i32"), ("sum", "f32"), ("max", "f32"),
             ("count_ge", "i64"), ("sum", "i64"))
# phase 14: (cell, n, kmax) of the benchmark's cells, the movers' shares
ORDER_CELLS = (("rmat-s21", 2_097_152, 770), ("er-livej", 4_847_571, 12))
ORDER_MOVING = (0.01, 0.3)
MAIN_PATH_KERNELS = ("coo_stat[din]", "coo_stat[same_in]",
                     "fused_removal_round", "fused_promotion_stats")
WEIGHTED_PATH_KERNELS = ("coo_stat[wsum]",)
# phase 8: under a mesh axis the fused decisions (b, c) wait for the
# completed statistics, so kernel a's unit statistics run in their place
SHARDED_PATH_KERNELS = ("coo_stat[mcd_hi_dout]", "coo_stat[hi_dout]",
                        "coo_stat[din]", "coo_stat[same_in]")


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*a) -> None:
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def time_ms(fn, iters: int, device) -> float:
    """Mean time of ``fn`` after one warm-up call: CUDA events on the
    card, the host clock on the CPU."""
    import torch
    fn()
    sync(device)
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def apply_delta(live: set, ins, rm) -> None:
    """Host mirror of ``apply_batch`` on a live edge set: removals first,
    then the insertions that are not self-loops."""
    for a, b in np.asarray(rm).reshape(-1, 2).tolist():
        live.discard((min(a, b), max(a, b)))
    for a, b in np.asarray(ins).reshape(-1, 2).tolist():
        if a != b:
            live.add((min(a, b), max(a, b)))


# ---------------------------------------------------------------------------
def phase_small(device, n: int, m: int, n_batches: int, batch: int,
                backend: str, yardstick: str) -> None:
    """Replay both streams with ``backend`` and ``yardstick`` side by
    side, and on an ``engine="host"`` maintainer whose table holds
    ``batch`` free slots (so it compacts and grows); BZ oracle after
    every batch, and the host engine's labels equal to the unified
    replay's."""
    from repro_torch.core.api import CoreMaintainer
    from repro_torch.kernels import coremaint as K
    from repro_torch.core.oracle import bz_core_decomposition
    from repro_torch.graph.generators import erdos_renyi, rmat
    from repro_torch.graph.stream import churn_stream, mixed_stream

    graphs = {"er": erdos_renyi(n, m, seed=7),
              "rmat": rmat(int(np.log2(n)), m, seed=7)}
    for gname, g in graphs.items():
        for sname, stream in (
            ("mixed", mixed_stream(g, n_batches, batch, seed=11)),
            ("churn", churn_stream(g, n_batches, batch, seed=12)),
        ):
            a = CoreMaintainer.from_graph(g, device=device,
                                          kernel_backend=backend)
            b = CoreMaintainer.from_graph(g, device=device,
                                          kernel_backend=yardstick)
            c = CoreMaintainer.from_graph(g, device=device, engine="host",
                                          capacity=g.m + batch)
            host = HostSplit(c)
            live = {tuple(e) for e in g.edge_array().tolist()}
            t0 = time.perf_counter()
            t_host = 0.0
            for ev in stream:
                sa = a.apply_batch(insert_edges=ev.edges,
                                   remove_edges=ev.removals)
                sb = b.apply_batch(insert_edges=ev.edges,
                                   remove_edges=ev.removals)
                before = dict(K.LAUNCHES)
                t1 = time.perf_counter()
                sc = c.apply_batch(insert_edges=ev.edges,
                                   remove_edges=ev.removals)
                t_host += time.perf_counter() - t1
                check(K.LAUNCHES == before,
                      f"phase 2 {gname}/{sname} t={ev.t}: the host engine "
                      f"launched a kernel")
                apply_delta(live, ev.edges, ev.removals)
                adj = [set() for _ in range(g.n)]
                for u, v in live:
                    adj[u].add(v)
                    adj[v].add(u)
                want, _ = bz_core_decomposition(g.n, adj)
                check(np.array_equal(a.cores(), want),
                      f"phase 2 {gname}/{sname} t={ev.t}: cores != BZ")
                check(np.array_equal(a.cores(), b.cores())
                      and np.array_equal(a.labels(), b.labels()),
                      f"phase 2 {gname}/{sname} t={ev.t}: {backend} != "
                      f"{yardstick} (cores/labels)")
                for f in sa._fields:
                    check(int(getattr(sa, f)) == int(getattr(sb, f)),
                          f"phase 2 {gname}/{sname} t={ev.t}: stats.{f}")
                check(a.live_edges == len(live),
                      f"phase 2 {gname}/{sname}: live edge count")
                check(np.array_equal(c.cores(), want)
                      and np.array_equal(c.labels(), a.labels()),
                      f"phase 2 {gname}/{sname} t={ev.t}: host engine != "
                      f"BZ / unified labels")
                for f in ("n_inserted", "n_removed"):
                    check(int(getattr(sc, f)) == int(getattr(sa, f)),
                          f"phase 2 {gname}/{sname} t={ev.t}: host stats.{f}")
                check(c.live_edges == len(c.edge_slot) == len(live),
                      f"phase 2 {gname}/{sname}: host live edge count")
            host.restore()
            log(f"phase 2 {gname}/{sname}: n={g.n} m={g.m} "
                f"{n_batches} batches of {batch}: BZ ok, {backend} == "
                f"{yardstick} bit for bit ({time.perf_counter() - t0:.2f} s); "
                f"engine='host': BZ ok, labels == unified, no kernel "
                f"launched, {host.calls['_compact']} compactions, "
                f"{host.calls['_grow']} growths, capacity {g.m + batch} -> "
                f"{c.capacity} ({t_host:.2f} s)")


def phase_small_weighted(device, n: int, m: int, n_batches: int,
                         batch: int, backend: str, yardstick: str) -> None:
    """Phase 2's replays on weighted maintainers: random weights 1-5 on
    the graph and on every insert list; the weighted peeling oracle
    after every batch."""
    from repro_torch.core.api import CoreMaintainer
    from repro_torch.core.weighted import weighted_core_oracle
    from repro_torch.graph.generators import erdos_renyi, rmat
    from repro_torch.graph.stream import churn_stream, mixed_stream

    graphs = {"er": erdos_renyi(n, m, seed=7),
              "rmat": rmat(int(np.log2(n)), m, seed=7)}
    rng = np.random.default_rng(13)
    for gname, g in graphs.items():
        for sname, stream in (
            ("mixed", mixed_stream(g, n_batches, batch, seed=11)),
            ("churn", churn_stream(g, n_batches, batch, seed=12)),
        ):
            w0 = rng.integers(1, MAX_WEIGHT + 1, g.m)
            a = CoreMaintainer.from_graph(g, device=device,
                                          kernel_backend=backend,
                                          weighted=True, weights=w0)
            b = CoreMaintainer.from_graph(g, device=device,
                                          kernel_backend=yardstick,
                                          weighted=True, weights=w0)
            live = WeightMirror(g.n, g.edge_array(), w0)
            t0 = time.perf_counter()
            for ev in stream:
                iw = rng.integers(1, MAX_WEIGHT + 1, len(ev.edges))
                sa = a.apply_batch(insert_edges=ev.edges,
                                   remove_edges=ev.removals,
                                   insert_weights=iw)
                sb = b.apply_batch(insert_edges=ev.edges,
                                   remove_edges=ev.removals,
                                   insert_weights=iw)
                live.apply(ev.edges, iw, ev.removals)
                where = f"phase 2 weighted {gname}/{sname} t={ev.t}"
                want = weighted_core_oracle(g.n, live.edges(), live.w)
                check(np.array_equal(a.cores(), want),
                      f"{where}: cores != weighted oracle")
                for name in ("core", "label", "w", "valid", "src"):
                    check(bool((getattr(a, name) == getattr(b, name)).all()),
                          f"{where}: {backend} != {yardstick} ({name})")
                for f in sa._fields:
                    check(int(getattr(sa, f)) == int(getattr(sb, f)),
                          f"{where}: stats.{f}")
                check(live.matches(a), f"{where}: weight column != mirror")
            log(f"phase 2 weighted {gname}/{sname}: n={g.n} m={g.m} "
                f"{n_batches} batches of {batch}, weights 1-{MAX_WEIGHT}: "
                f"weighted oracle ok, {backend} == {yardstick} bit for bit "
                f"({time.perf_counter() - t0:.2f} s)")


class HostSplit:
    """Where an ``engine="host"`` maintainer's time goes: wraps the
    device halves (``insert_batch`` and ``remove_batch`` as
    ``core/api.py`` calls them), the renumber gate, ``_compact`` and
    ``_grow`` of maintainer ``m``, each timed between device syncs and
    counted. A batch's wall less these parts is the host's share: the
    dedup against the ``edge_slot`` dict, the lane copies, the syncs.
    ``restore()`` puts the module's functions back."""

    MODULE = ("insert_batch", "remove_batch")
    METHODS = ("_maybe_renumber", "_compact", "_grow")

    def __init__(self, m) -> None:
        import repro_torch.core.api as api
        self.api, self.device = api, m.device
        self.secs = dict.fromkeys(self.MODULE + self.METHODS, 0.0)
        self.calls = dict.fromkeys(self.MODULE + self.METHODS, 0)
        self.saved = {k: getattr(api, k) for k in self.MODULE}
        for k in self.MODULE:
            setattr(api, k, self._timed(k, self.saved[k]))
        for k in self.METHODS:
            setattr(m, k, self._timed(k, getattr(m, k)))

    def _timed(self, key, fn):
        def run(*a, **kw):
            sync(self.device)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync(self.device)
            self.secs[key] += time.perf_counter() - t0
            self.calls[key] += 1
            return out
        return run

    def restore(self) -> None:
        for k, fn in self.saved.items():
            setattr(self.api, k, fn)


class WeightMirror:
    """Host mirror of a weighted maintainer's live edges, as sorted int64
    keys ``lo * n + hi`` with their weights, updated with the engine's
    batch semantics: removals first, then insertions without self-loops,
    the first row of an in-batch duplicate winning, and live edges
    keeping their stored weight."""

    def __init__(self, n: int, edges, weights) -> None:
        self.n = n
        keys = self._keys(edges)
        order = np.argsort(keys, kind="stable")
        self.keys = keys[order]
        self.w = np.asarray(weights, dtype=np.int64)[order]

    def _keys(self, edges) -> np.ndarray:
        e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        return np.minimum(e[:, 0], e[:, 1]) * self.n + np.maximum(
            e[:, 0], e[:, 1])

    def _find(self, q):
        pos = np.searchsorted(self.keys, q).clip(max=max(len(self.keys) - 1,
                                                         0))
        found = (self.keys[pos] == q) if len(self.keys) else np.zeros(
            len(q), bool)
        return pos, found

    def apply(self, ins, iw, rm) -> None:
        if rm is not None and len(rm):
            pos, found = self._find(self._keys(rm))
            keep = np.ones(len(self.keys), bool)
            keep[pos[found]] = False
            self.keys, self.w = self.keys[keep], self.w[keep]
        if ins is not None and len(ins):
            e = np.asarray(ins, dtype=np.int64).reshape(-1, 2)
            ok = e[:, 0] != e[:, 1]
            k, wk = self._keys(e)[ok], np.asarray(iw, dtype=np.int64)[ok]
            k, first = np.unique(k, return_index=True)
            wk = wk[first]
            _, found = self._find(k)
            keys = np.concatenate([self.keys, k[~found]])
            w = np.concatenate([self.w, wk[~found]])
            order = np.argsort(keys, kind="stable")
            self.keys, self.w = keys[order], w[order]

    def edges(self) -> np.ndarray:
        return np.stack([self.keys // self.n, self.keys % self.n], 1)

    def matches(self, m) -> bool:
        """The maintainer's live slots, keyed and sorted, carry exactly
        the mirror's edges and weights."""
        import torch
        live = torch.nonzero(m.valid).flatten()
        s, d = m.src[live].long(), m.dst[live].long()
        keys = torch.minimum(s, d) * m.n + torch.maximum(s, d)
        keys, order = torch.sort(keys)
        w = m.w[live][order]
        return (keys.shape[0] == len(self.keys)
                and np.array_equal(keys.cpu().numpy(), self.keys)
                and np.array_equal(w.cpu().numpy(), self.w))


def _stat_bytes(e: int, e_valid: int, n: int, stat: str) -> int:
    """Bytes a stat pass must move: the window's valid mask (1 B a slot),
    src and dst of the live slots only (a dead slot's endpoints are not
    needed); core, label (when a predicate reads it) and aux (when it
    reads one) once; the packed int32 output once."""
    from repro_torch.kernels.coremaint import _LABEL_STATS, _STATS
    reads_label = stat in _LABEL_STATS
    reads_aux = stat in ("din", "same_in")
    return (e + 8 * e_valid + 4 * n + 8 * n * reads_label + n * reads_aux
            + 4 * n * _STATS[stat][1])


def kernel_row(name, kname, got, want, run, run_plain, nbytes, ops,
               iters, device, shape: str) -> dict:
    """Hold a kernel's outputs to its plain version's (0 mismatches),
    time both with CUDA events, and return its ``kernels`` JSON row
    (``launches`` is filled in from the main path's run)."""
    err = 0
    for x, y in zip(got, want):
        check(x.dtype == y.dtype and x.shape == y.shape,
              f"phase 3 {name}: dtype/shape")
        err = max(err, int((x.long() - y.long()).abs().max())
                  if x.numel() else 0)
    check(err == 0, f"phase 3 {name}: max abs err {err}")
    ms = time_ms(run, iters, device)
    plain_ms = time_ms(run_plain, max(1, iters // 4), device)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    log(f"phase 3 {name}: {shape} mismatches=0 kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bytes={nbytes} "
        f"bound_ms={max(t_bytes, t_ops):.4f}")
    return dict(
        name=name, route="cuda",
        source="src/repro_torch/csrc/coremaint.cu",
        replaces=REPLACES[kname], launches=0, max_abs_err=float(err),
        ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None,
    )


def shuffled(device, cols, seed: int) -> list:
    """The window's columns in one seeded random slot order: no runs of
    one src are left."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    perm = torch.randperm(cols[0].shape[0], generator=gen, device=device)
    return [c[perm] for c in cols]


def phase_kernels(device, m, iters: int, seed: int = 0) -> list:
    """Each kernel against its plain version on the maintainer's state."""
    import torch
    from repro_torch.kernels import coremaint as K

    w = m._window(0)
    src, dst, valid = m.src[:w], m.dst[:w], m.valid[:w]
    core, label, n = m.core, m.label, m.n
    e_valid = int(valid.sum())
    log(f"phase 3 state: window E={w} live slots={e_valid} n={n}")
    gen = torch.Generator(device=device).manual_seed(seed)
    aux = torch.rand(n, generator=gen, device=device) < 0.5
    rows = []

    def record(name, kname, got, want, run, run_plain, nbytes, ops):
        rows.append(kernel_row(name, kname, got, want, run, run_plain,
                               nbytes, ops, iters, device, f"E={w} n={n}"))

    for stat in ("din", "same_in", "mcd_hi_dout", "hi_dout", "mcd"):
        a = aux if stat in ("din", "same_in") else None
        lab = label if stat in K._LABEL_STATS else None
        args = (src, dst, valid, core, lab, n, stat, a)
        got = K.coo_stat(*args)
        want = K.coo_stat_plain(*args)
        # ~2 compares and an add per predicate, per valid slot
        ops = e_valid * 3 * 2 * got.shape[1]
        record(f"coo_stat[{stat}]", "coo_stat", (got,), (want,),
               lambda: K.coo_stat(*args), lambda: K.coo_stat_plain(*args),
               _stat_bytes(w, e_valid, n, stat), ops)
    args = (src, dst, valid, core, label, n)
    record("fused_removal_round", "fused_removal_round",
           K.fused_removal_round(*args), K.fused_removal_round_plain(*args),
           lambda: K.fused_removal_round(*args),
           lambda: K.fused_removal_round_plain(*args),
           # + new_core, drop
           _stat_bytes(w, e_valid, n, "mcd_hi_dout") + 5 * n,
           e_valid * 18 + 3 * n)
    sargs = (*shuffled(device, (src, dst, valid), seed + 1), core, label, n)
    got = K.fused_removal_round(*sargs)
    for x, y, z in zip(got, K.fused_removal_round_plain(*sargs),
                       K.fused_removal_round(*args)):
        check(torch.equal(x, y) and torch.equal(x, z),
              "phase 3 fused_removal_round (shuffled): != plain or sorted")
    rows[-1]["shuffled_ms"] = time_ms(
        lambda: K.fused_removal_round(*sargs), iters, device)
    log(f"phase 3 fused_removal_round shuffled: mismatches=0 (== sorted) "
        f"kernel_ms={rows[-1]['shuffled_ms']:.4f}")
    record("fused_promotion_stats", "fused_promotion_stats",
           K.fused_promotion_stats(*args),
           K.fused_promotion_stats_plain(*args),
           lambda: K.fused_promotion_stats(*args),
           lambda: K.fused_promotion_stats_plain(*args),
           _stat_bytes(w, e_valid, n, "hi_dout") + n,  # + viol
           e_valid * 12 + 2 * n)
    return rows


def order_state(device, n: int, kmax: int, p_move: float, seed: int):
    """A vertex state at a cell's size: levels 0..kmax all held, a
    power-law share of them (RMAT) or most vertices on the top levels
    (ER), unique gap-spaced labels (a renumbered state), ``p_move`` of
    the vertices moving, eviction-round keys."""
    import torch
    from repro_torch.core.order import LABEL_GAP
    rng = np.random.default_rng(seed)
    if kmax > 100:
        core = np.minimum(rng.zipf(1.6, size=n) - 1, kmax)
    else:
        core = rng.binomial(kmax, 0.75, size=n)
    core[:kmax + 1] = np.arange(kmax + 1)
    label = (rng.permutation(n).astype(np.int64) - n // 2) * LABEL_GAP
    moving = rng.random(n) < p_move
    rkey = rng.integers(0, 60, size=n)
    return [torch.from_numpy(x).to(device) for x in
            (core.astype(np.int32), label, moving, rkey.astype(np.int32))]


def phase_order(device, iters: int) -> dict:
    """Phase 14: ``place_levels`` against the plain level reductions at
    the benchmark's sizes; returns its kernels row (``launches`` filled
    in from phase 4)."""
    import torch
    from repro_torch.core import order as O
    from repro_torch.kernels import order as KO

    row = dict(name="place_levels", route="cuda",
               source="src/repro_torch/csrc/order.cu",
               replaces="no TPU kernel: the reference's jnp segment_min / "
                        "segment_max", launches=0, max_abs_err=0.0,
               library_ms=None, cells={})
    for cell, n, kmax in ORDER_CELLS:
        n_levels = n + 2
        for p_move in ORDER_MOVING:
            core, label, moving, rkey = order_state(device, n, kmax, p_move,
                                                    seed=n)
            _, perm = O._mover_order(core, label, moving, n_levels, rkey)
            ranks = O._ranks(perm)
            KO.reset_spill_count()
            for at_head in (True, False):
                got = KO.place_levels(core, label, moving, ranks, at_head,
                                      n_levels)
                want = O.place_levels_plain(core, label, moving, ranks,
                                            at_head, n_levels)
                check(torch.equal(got, want),
                      f"phase 14 {cell} p_move={p_move} at_head={at_head}: "
                      f"{int((got != want).sum())} labels != plain")
            check(KO.spill_count() == 0,
                  f"phase 14 {cell}: {KO.spill_count()} vertices spilled")
            ms = time_ms(lambda: KO.place_levels(
                core, label, moving, ranks, False, n_levels), iters, device)
            plain_ms = time_ms(lambda: O.place_levels_plain(
                core, label, moving, ranks, False, n_levels),
                max(1, iters // 4), device)
            sort_ms = time_ms(lambda: O._ranks(O._mover_order(
                core, label, moving, n_levels, rkey)[1]), iters, device)
            n_move = int(moving.sum())
            # core, moving, label and the output once; the movers' ranks
            nbytes = 4 * n + n + 8 * n + 8 * n + 4 * n_move
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            log(f"phase 14 {cell}: n={n} levels={kmax + 1} "
                f"moving={n_move} mismatches=0 spilled=0 "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"sort_ms={sort_ms:.4f} bytes={nbytes} "
                f"bound_ms={bound_ms:.4f} share={100 * bound_ms / ms:.2f}%")
            row["cells"][f"{cell}@{p_move}"] = dict(
                ms=ms, plain_ms=plain_ms, sort_ms=sort_ms, bound_ms=bound_ms)
            if p_move == ORDER_MOVING[0] and cell == ORDER_CELLS[0][0]:
                row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by="bytes")
            del core, label, moving, rkey, perm, ranks, got, want
            torch.cuda.empty_cache()
    return row


def _wsum_bytes(e: int, e_valid: int, n: int) -> int:
    """Bytes a wsum pass must move: the window's valid mask (1 B a slot),
    src, dst and w of the live slots only (the kernel skips a dead slot
    before it reads them), core and the thresholds once, the int32
    output once."""
    return e + 12 * e_valid + 12 * n


def phase_kernels_weighted(device, m, iters: int) -> list:
    """``coo_stat[wsum]`` against its plain version on the weighted
    maintainer's state, at two thresholds on either side of the
    predicate: ``(core + 1) // 2`` (a bisection mid) and ``core + 1``,
    and at the first on a shuffled copy of the window."""
    import torch
    from repro_torch.kernels import coremaint as K

    w = m._window(0)
    src, dst, valid, wt = m.src[:w], m.dst[:w], m.valid[:w], m.w[:w]
    core, n = m.core, m.n
    e_valid = int(valid.sum())
    log(f"phase 3 weighted state: window E={w} live slots={e_valid} n={n}")
    rows = []
    for tname, thresh in (("(core+1)//2", (core + 1) // 2),
                          ("core+1", core + 1)):
        args = (src, dst, valid, core, None, n, "wsum", thresh, wt)
        got = K.coo_stat(*args)
        want = K.wsum_plain(src, dst, valid, wt, core, thresh, n)
        # two gathers, a compare and an add per endpoint, per live slot
        rows.append(kernel_row(
            "coo_stat[wsum]", "coo_stat[wsum]", (got,), (want,),
            lambda: K.coo_stat(*args),
            lambda: K.wsum_plain(src, dst, valid, wt, core, thresh, n),
            _wsum_bytes(w, e_valid, n), e_valid * 2 * 4, iters, device,
            f"E={w} n={n} thresh={tname} sum={int(got.sum())}"))
    # the bisection-like threshold on a shuffled copy of the window
    thresh = (core + 1) // 2
    ssrc, sdst, svalid, swt = shuffled(device, (src, dst, valid, wt), 2)
    sargs = (ssrc, sdst, svalid, core, None, n, "wsum", thresh, swt)
    got = K.coo_stat(*sargs)
    check(torch.equal(got, K.wsum_plain(ssrc, sdst, svalid, swt, core,
                                        thresh, n))
          and torch.equal(got, K.coo_stat(src, dst, valid, core, None, n,
                                          "wsum", thresh, wt)),
          "phase 3 coo_stat[wsum] (shuffled): != plain or sorted")
    rows[0]["shuffled_ms"] = time_ms(lambda: K.coo_stat(*sargs), iters,
                                     device)
    log(f"phase 3 coo_stat[wsum] shuffled thresh=(core+1)//2: mismatches=0 "
        f"(== sorted) kernel_ms={rows[0]['shuffled_ms']:.4f}")
    # both thresholds are checked and logged; the JSON row is the
    # bisection-like one
    return rows[:1]


def certificate_ok(m, core=None, label=None) -> bool:
    """k-order certificate: same-level successors + higher-core
    neighbours <= core for every vertex (``core``/``label``: the
    gathered state, where the maintainer holds an owned slice)."""
    from repro_torch.core import graph_ops as G
    core = m.core if core is None else core
    label = m.label if label is None else label
    hi, dout = G.hi_and_dout_same(m.src, m.dst, m.valid, core, label, m.n)
    return bool(((hi + dout) <= core).all())


def snapshot(m) -> tuple:
    """Device copies of the slot table (and weight column): phase 8's
    yardstick for the sharded engine's table after each batch."""
    cols = (m.src, m.dst, m.valid) + ((m.w,) if m.weighted else ())
    return tuple(x.clone() for x in cols)


def start_state(m) -> dict:
    """A device copy of a maintainer's state, for phase 8 to start the
    sharded engine where phases 4 and 5 start."""
    keys = ("src", "dst", "valid", "n_edges", "core", "label") + (
        ("w",) if m.weighted else ())
    st = {k: getattr(m, k).clone() for k in keys}
    st.update(n=m.n, capacity=m.capacity, n_levels=m.n_levels,
              weighted=m.weighted)
    return st


def phase_main(device, m, g, sample, stream) -> tuple:
    """The main path: burst removal, its re-insertion, mixed batches.
    Returns the launch counts, the ``(stat, mask)`` list that
    ``record_masks`` kept over the burst pair, and per batch its name,
    wall time, ``n_inserted``, ``n_removed``, rounds, high-water mark,
    host copies of the cores and labels and a device copy of the slot
    table after it (the yardstick of phases 4b and 8)."""
    import torch
    from repro_torch.core.decomposition import peel_decomposition
    from repro_torch.kernels import coremaint as K
    from repro_torch.kernels import order as KO

    batches = [("burst remove", None, sample),
               ("burst insert", sample, None)]
    batches += [(f"mixed {ev.t}", ev.edges, ev.removals) for ev in stream]
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    KO.reset_launches()
    history = []

    def run(name, ins, rm):
        before = dict(K.LAUNCHES)
        sync(device)
        t0 = time.perf_counter()
        st = m.apply_batch(insert_edges=ins, remove_edges=rm)
        sync(device)
        dt = time.perf_counter() - t0
        history.append(dict(name=name, wall_s=dt,
                            n_inserted=int(st.n_inserted),
                            n_removed=int(st.n_removed), cores=m.cores(),
                            labels=m.labels(),
                            rounds=(int(st.remove_rounds),
                                    int(st.insert_rounds)),
                            high_water=int(st.high_water),
                            table=snapshot(m)))
        moved = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES
                 if K.LAUNCHES[k] != before[k]}
        log(f"phase 4 {name}: wall_s={dt:.4f} "
            f"remove_rounds={int(st.remove_rounds)} "
            f"insert_rounds={int(st.insert_rounds)} "
            f"n_removed={int(st.n_removed)} n_inserted={int(st.n_inserted)} "
            f"n_dropped={int(st.n_dropped)} n_promoted={int(st.n_promoted)} "
            f"v_plus={int(st.v_plus)} launches={json.dumps(moved)}")

    with K.record_masks() as recorded:  # the burst pair
        for batch in batches[:2]:
            run(*batch)
    for batch in batches[2:]:
        run(*batch)
    launches = {**K.LAUNCHES, **KO.LAUNCHES}
    for k in (*MAIN_PATH_KERNELS, *KO.LAUNCHES):
        check(launches[k] > 0 or not on_card,
              f"phase 4: kernel {k} was never launched")
    peak = torch.cuda.max_memory_allocated() if on_card else None
    log(f"phase 4 launches={json.dumps(launches)} "
        f"max_memory_allocated={peak}")
    t0 = time.perf_counter()
    want, _ = peel_decomposition(m.src, m.dst, m.valid, m.n)
    check(torch.equal(m.core, want), "phase 4: cores != fresh peel")
    check(certificate_ok(m), "phase 4: k-order certificate violated")
    check(m.live_edges == g.m + sum(
        len(ev.edges) - len(ev.removals) for ev in stream),
        "phase 4: live edge count")
    log(f"phase 4: cores == fresh peel of the final live edge set, "
        f"certificate holds ({time.perf_counter() - t0:.1f} s)")
    return launches, recorded, history


def phase_applications(m) -> None:
    """The applications of ``core/applications.py`` on phase 4's final
    state: ``kcore_edge_mask(m, kmax)`` against the same mask computed
    in numpy from the slot table, ``densest_region_vertices`` against
    its definition."""
    import torch
    from repro_torch.core import applications as A

    t0 = time.perf_counter()
    core = m.core.cpu().numpy()
    src, dst = m.src.cpu().numpy(), m.dst.cpu().numpy()
    valid = m.valid.cpu().numpy()
    kmax = int(core.max())
    mask = A.kcore_edge_mask(m, kmax)
    check(mask.dtype == torch.bool and mask.device == m.device,
          "phase 4 applications: kcore_edge_mask dtype/device")
    keep = core >= kmax
    want = valid & keep[src] & keep[dst]
    check(np.array_equal(mask.cpu().numpy(), want),
          "phase 4 applications: kcore_edge_mask != numpy")
    top_frac = 0.01
    got = A.densest_region_vertices(m, top_frac)
    want_v = np.nonzero(core == kmax)[0]
    k = kmax
    while want_v.size < max(1, int(top_frac * m.n)) and k > 0:
        k -= 1
        want_v = np.nonzero(core >= k)[0]
    check(np.array_equal(got, want_v),
          "phase 4 applications: densest_region_vertices != numpy")
    log(f"phase 4 applications: kcore_edge_mask(kmax={kmax}) == numpy "
        f"({int(want.sum())} edges of the {kmax}-core), "
        f"densest_region_vertices(top_frac={top_frac}) == numpy "
        f"({got.size} vertices, cores >= {k}) "
        f"({time.perf_counter() - t0:.1f} s)")


def phase_host(device, g, sample, stream, history) -> None:
    """Phase 4's batches on an ``engine="host"`` maintainer built from
    the same graph: after each batch the cores, labels, ``n_inserted``
    and ``n_removed`` equal phase 4's (``history``), and no kernel
    launch counter moved; per batch the wall time and its split (host
    dedup, device fixpoints, renumber gate, compaction); at the end the
    cores against a fresh peel and the k-order certificate."""
    import torch
    from repro_torch.core.api import CoreMaintainer
    from repro_torch.core.decomposition import peel_decomposition
    from repro_torch.kernels import coremaint as K
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fm_interaction as FM
    from repro_torch.kernels import segment_ell as SE

    def counters():
        return {f"{mod.__name__}.{k}": v
                for mod in (K, SE, FM, FA) for k, v in mod.LAUNCHES.items()}

    t0 = time.perf_counter()
    m = CoreMaintainer.from_graph(g, init="jax-peel", device=device,
                                  engine="host")
    sync(device)
    log(f"phase 4b from_graph(init='jax-peel', engine='host'): "
        f"capacity={m.capacity} n_edges={int(m.n_edges)} "
        f"kernel_backend={m.kernel_backend} "
        f"({time.perf_counter() - t0:.1f} s)")
    check(m.kernel_backend == "torch", "phase 4b: kernel_backend")
    t0 = time.perf_counter()
    n_slots = len(m.edge_slot)
    log(f"phase 4b edge_slot dict: {n_slots} entries built in "
        f"{time.perf_counter() - t0:.1f} s (once, on first use)")
    batches = [("burst remove", None, sample),
               ("burst insert", sample, None)]
    batches += [(f"mixed {ev.t}", ev.edges, ev.removals) for ev in stream]
    check(len(batches) == len(history), "phase 4b: batch count")
    split = HostSplit(m)
    start = counters()
    try:
        for (name, ins, rm), want in zip(batches, history):
            secs = dict(split.secs)
            sync(device)
            t0 = time.perf_counter()
            st = m.apply_batch(insert_edges=ins, remove_edges=rm)
            sync(device)
            dt = time.perf_counter() - t0
            part = {k: split.secs[k] - secs[k] for k in secs}
            fix = part["insert_batch"] + part["remove_batch"]
            ren = part["_maybe_renumber"]
            rest = part["_compact"] + part["_grow"]
            host = dt - fix - ren - rest
            check(np.array_equal(m.cores(), want["cores"]),
                  f"phase 4b {name}: cores != phase 4")
            check(np.array_equal(m.labels(), want["labels"]),
                  f"phase 4b {name}: labels != phase 4")
            for f in ("n_inserted", "n_removed"):
                check(int(getattr(st, f)) == want[f],
                      f"phase 4b {name}: {f} != phase 4")
            check(counters() == start,
                  f"phase 4b {name}: a kernel launch counter moved")
            log(f"phase 4b {name}: wall_s={dt:.4f} (unified "
                f"{want['wall_s']:.4f}) host_dedup_s={host:.4f} "
                f"device_fixpoints_s={fix:.4f} renumber_gate_s={ren:.4f} "
                f"compact_grow_s={rest:.4f} "
                f"remove_rounds={int(st.remove_rounds)} "
                f"insert_rounds={int(st.insert_rounds)} "
                f"n_removed={int(st.n_removed)} "
                f"n_inserted={int(st.n_inserted)} "
                f"n_dropped={int(st.n_dropped)} "
                f"n_promoted={int(st.n_promoted)} "
                f"renumbered={bool(st.renumbered)} "
                f"high_water={int(st.high_water)}: cores, labels == phase 4")
    finally:
        split.restore()
    log(f"phase 4b calls={json.dumps(split.calls)} "
        f"launch counters unmoved ({sum(start.values())} before and after)")
    t0 = time.perf_counter()
    want, _ = peel_decomposition(m.src, m.dst, m.valid, m.n)
    check(torch.equal(m.core, want), "phase 4b: cores != fresh peel")
    check(certificate_ok(m), "phase 4b: k-order certificate violated")
    check(m.live_edges == len(m.edge_slot) == g.m + sum(
        len(ev.edges) - len(ev.removals) for ev in stream),
        "phase 4b: live edge count")
    log(f"phase 4b: cores == fresh peel of the final live edge set, "
        f"certificate holds ({time.perf_counter() - t0:.1f} s)")


def phase_path_masks(device, snap, recorded, rows, iters: int) -> None:
    """``din`` and ``same_in`` under the masks phase 4's burst pair passed
    them (``recorded``), on phase 3's window (``snap``): each mask's
    popcount and share of touched live slots (either endpoint in the
    mask); both kernels held to their plain versions (0 mismatches) and
    timed under the median-touch and the max-touch mask. Adds
    ``path_mask_ms``, ``path_mask_bound_ms`` and ``path_mask_density`` to
    their rows of ``rows``."""
    import torch
    from repro_torch.kernels import coremaint as K

    src, dst, valid, core, label = snap
    n, e = core.shape[0], src.shape[0]
    live = valid != 0
    e_valid = int(live.sum())
    s64, d64 = src.long(), dst.long()
    by_name = {r["name"]: r for r in rows}
    masks_all = [a for _, a in recorded if a is not None]
    check(masks_all, "phase 4: the burst pair recorded no mask")
    copy_ms = time_ms(lambda: masks_all[0].clone(), iters, device)
    log(f"phase 4 recorder: {len(recorded)} mask copies of {n} B, "
        f"{copy_ms:.4f} ms each on the device, {copy_ms * len(recorded):.4f} "
        f"ms in all inside the burst pair's walls")
    for stat in K._MASK_STATS:
        masks = [a.bool() for s, a in recorded if s == stat and a is not None]
        check(masks, f"phase 4: no {stat} call in the burst pair")
        pop = [int(a.sum()) for a in masks]
        touched = [int(((a[s64] | a[d64]) & live).sum()) / e_valid
                   for a in masks]
        order = sorted(range(len(masks)), key=touched.__getitem__)
        row = by_name[f"coo_stat[{stat}]"]
        row["path_mask_density"] = dict(
            calls=len(masks), popcount_median=float(np.median(pop)),
            popcount_max=max(pop), touched_median=float(np.median(touched)),
            touched_max=max(touched))
        row["path_mask_ms"], row["path_mask_bound_ms"] = {}, {}
        lab = label if stat in K._LABEL_STATS else None
        for kind, i in (("median", order[(len(order) - 1) // 2]),
                        ("max", order[-1])):
            args = (src, dst, valid, core, lab, n, stat, masks[i])
            check(torch.equal(K.coo_stat(*args), K.coo_stat_plain(*args)),
                  f"phase 4 {stat} under the {kind}-touch path mask: != "
                  f"plain")
            row["path_mask_ms"][kind] = time_ms(lambda: K.coo_stat(*args),
                                                iters, device)
            # the window and the mask once, the core (and label) of the
            # endpoints of touched slots once, the output once
            hit = (masks[i][s64] | masks[i][d64]) & live
            verts = int(torch.unique(torch.cat([s64[hit], d64[hit]])).numel())
            nbytes = (e + 8 * e_valid + n + 4 * n
                      + verts * (4 + 8 * (lab is not None)))
            row["path_mask_bound_ms"][kind] = nbytes / HBM_BYTES_PER_S * 1e3
            log(f"phase 4 {stat} path mask ({kind} touch): popcount={pop[i]} "
                f"touched={touched[i]:.6f} mismatches=0 "
                f"kernel_ms={row['path_mask_ms'][kind]:.4f} "
                f"bound_ms={row['path_mask_bound_ms'][kind]:.4f} "
                f"(50% mask: {row['ms']:.4f})")
        log(f"phase 4 {stat} path masks: {json.dumps(row['path_mask_density'])}"
            f" popcounts={pop} touched={[round(x, 6) for x in touched]}")


def phase_weighted(device, m, g, w0, pick, stream, seed: int = 1) -> tuple:
    """The weighted main path: the burst ``g.edge_array()[pick]`` removed
    and re-inserted with its own weights, then ``stream``'s mixed batches
    with random weights. Returns the launch counts and per batch its
    edits and what phase 8 holds the sharded engine to."""
    import torch
    from repro_torch.core.api import CoreMaintainer
    from repro_torch.core.order import renumber
    from repro_torch.graph.csr import build_csr
    from repro_torch.kernels import coremaint as K

    rng = np.random.default_rng(seed)
    sample = g.edge_array()[pick]
    batches = [("burst remove", None, None, sample),
               ("burst insert", sample, w0[pick], None)]
    batches += [(f"mixed {ev.t}", ev.edges,
                 rng.integers(1, MAX_WEIGHT + 1, len(ev.edges)), ev.removals)
                for ev in stream]
    mirror = WeightMirror(g.n, g.edge_array(), w0)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    history = []
    for name, ins, iw, rm in batches:
        before = K.LAUNCHES["coo_stat[wsum]"]
        sync(device)
        t0 = time.perf_counter()
        st = m.apply_batch(insert_edges=ins, remove_edges=rm,
                           insert_weights=iw)
        sync(device)
        dt = time.perf_counter() - t0
        history.append(dict(name=name, ins=ins, iw=iw, rm=rm, wall_s=dt,
                            n_inserted=int(st.n_inserted),
                            n_removed=int(st.n_removed), cores=m.cores(),
                            labels=m.labels(),
                            rounds=(int(st.remove_rounds),
                                    int(st.insert_rounds)),
                            high_water=int(st.high_water),
                            table=snapshot(m)))
        mirror.apply(ins, iw, rm)
        log(f"phase 5 {name}: wall_s={dt:.4f} "
            f"remove_rounds={int(st.remove_rounds)} "
            f"insert_rounds={int(st.insert_rounds)} "
            f"n_removed={int(st.n_removed)} n_inserted={int(st.n_inserted)} "
            f"n_dropped={int(st.n_dropped)} n_promoted={int(st.n_promoted)} "
            f"renumbered={bool(st.renumbered)} "
            f"wsum_launches={K.LAUNCHES['coo_stat[wsum]'] - before}")
    launches = dict(K.LAUNCHES)
    for k in WEIGHTED_PATH_KERNELS:
        check(launches[k] > 0 or not on_card,
              f"phase 5: kernel {k} was never launched")
    peak = torch.cuda.max_memory_allocated() if on_card else None
    log(f"phase 5 launches={json.dumps(launches)} "
        f"max_memory_allocated={peak}")
    t0 = time.perf_counter()
    check(mirror.matches(m), "phase 5: live weight column != host mirror")
    check(m.live_edges == len(mirror.keys) == g.m + sum(
        len(ev.edges) - len(ev.removals) for ev in stream),
        "phase 5: live edge count")
    check(torch.equal(m.label, renumber(m.core, m.label)),
          "phase 5: labels != order.renumber(core, label)")
    fresh_g = build_csr(g.n, mirror.edges())
    check(np.array_equal(fresh_g.edge_array(), mirror.edges()),
          "phase 5: build_csr reordered the mirror's edges")
    fresh = CoreMaintainer.from_graph(fresh_g, device=device, weighted=True,
                                      weights=mirror.w)
    check(torch.equal(m.core, fresh.core),
          "phase 5: cores != fresh weighted from_graph")
    log(f"phase 5: cores == fresh weighted from_graph of the final live "
        f"edges and weights, weight column == host mirror, labels "
        f"canonical ({time.perf_counter() - t0:.1f} s)")
    return launches, history


def start_world():
    """A world of one NCCL rank on ``cuda:0``, rendezvous through a file
    store in a temporary directory (no port, no network). NCCL builds
    its communicator at the first collective, so one all-reduce here
    keeps that set-up out of the first batch's wall."""
    import datetime
    import os
    import tempfile
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    store = dist.FileStore(os.path.join(tempfile.mkdtemp(), "store"), 1)
    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=300))
    log(f"phase 8 world of one NCCL rank: init_process_group "
        f"{time.perf_counter() - t0:.3f} s (the communicator is built at "
        f"the first collective: the maintainer's set-up all-reduce)")


def traffic_summary(log) -> dict:
    """Collective counts and bytes received, from the records of
    ``vertex_layout.record_traffic``: all-reduces (``psum*``, ``pmax*``,
    ``pmin*``; ``all_reduce_stat_bytes`` the replicated layout's
    statistics), all-gathers (``gather_*``: the free-list, the halo
    membership, the range layout's statistics), reduce-scatters (the
    range layout's ``regather``) and the ring's ``ppermute`` (at one rank
    the identity: recorded, nothing sent); apart, the halo layout's
    ``psum_edge`` all-reduces (the 2-axis mesh's edge group) and the
    sparse exchange's ``gather_frontier`` all-gathers."""
    red = [t for t in log if t.op.startswith(("psum", "pmax", "pmin"))]
    gat = [t for t in log if t.op.startswith("gather")]
    rs = [t for t in log if t.op == "regather"]
    pp = [t for t in log if t.op == "ppermute"]
    return dict(all_reduce=len(red),
                all_reduce_bytes=sum(t.recv_bytes for t in red),
                all_reduce_stat_bytes=sum(t.recv_bytes for t in red
                                          if t.op == "psum"),
                all_gather=len(gat),
                all_gather_bytes=sum(t.recv_bytes for t in gat),
                reduce_scatter=len(rs),
                reduce_scatter_bytes=sum(t.recv_bytes for t in rs),
                ppermute=len(pp),
                **{f"{op}{key}": fn([t for t in log if t.op == op])
                   for op in ("psum_edge", "gather_frontier")
                   for key, fn in (("", len), ("_bytes", lambda x: sum(
                       t.recv_bytes for t in x)))})


def phase_sharded(device, mesh, start, batches, history, tag,
                  vertex_sharding="replicated", beside=None,
                  **exchange) -> tuple:
    """Phase 8: ``engine="sharded"`` (a world of one NCCL rank,
    ``kernel_backend="cuda"``) with ``vertex_sharding`` from a device
    copy of the state phase 4 (``tag="4"``) or phase 5 (``tag="5"``)
    started from, through the same batches: after every batch the cores,
    labels, ``n_inserted``, ``n_removed``, the rounds and ``high_water``
    equal that phase's, and the slot table (and weights) equals the
    unified engine's (one shard: ascending slot ids, as there). Per
    batch the wall time beside that phase's (and beside an earlier
    pass's, ``beside = (name, walls)``), the launches of each kernel
    instance, the collectives, ``n_overflow`` and ``max_frontier``, and
    with a pinned sparse cap the refreshes (one id payload each). At the
    end a fresh peel and the certificate (unweighted). ``exchange``: the
    ``frontier_exchange`` / ``frontier_cap`` fields. Returns the launch
    counts over the run, the walls and per batch ``(max_frontier,
    n_overflow, refreshes)`` (refreshes None unless the cap is
    pinned)."""
    import torch
    from repro_torch.core.api import CoreMaintainer
    from repro_torch.core.vertex_layout import record_traffic
    from repro_torch.kernels import coremaint as K

    cap = exchange.get("frontier_cap", 0)
    where = f"phase 8 ({tag}, {vertex_sharding}" + (
        f", sparse cap {cap or 'planned'})" if exchange else ")")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # copies: the sharded engine updates the slot table in place, and
    # each pass starts from the same state
    m = CoreMaintainer(
        n=start["n"], capacity=start["capacity"], src=start["src"].clone(),
        dst=start["dst"].clone(), valid=start["valid"].clone(),
        n_edges=start["n_edges"].clone(), core=start["core"].clone(),
        label=start["label"].clone(), n_levels=start["n_levels"],
        engine="sharded", mesh=mesh, vertex_sharding=vertex_sharding,
        kernel_backend="cuda", weighted=start["weighted"],
        w=start["w"].clone() if start["weighted"] else None, **exchange)
    sync(device)
    check(m.src.shape[0] == m.capacity and m._n_shards == 1,
          f"{where}: one shard holds the whole table")
    check(m.core.shape[0] == m.n and m._owned_vertices == (
        vertex_sharding in ("range", "halo")), f"{where}: vertex placement")
    if vertex_sharding == "halo":
        check(m.mesh.mesh_dim_names == ("edge", "data")
              and m._table_group is not None and m._d_v == 1,
              f"{where}: the 2-axis (1, 1) mesh and its table group")
    log(f"{where} CoreMaintainer(engine='sharded', vertex_sharding="
        f"'{vertex_sharding}', world of one NCCL rank, kernel_backend="
        f"'cuda', weighted={m.weighted}): capacity={m.capacity} "
        f"({time.perf_counter() - t0:.3f} s, NCCL's communicator built "
        f"by the maintainer's set-up collective on the first pass)")
    check(len(batches) == len(history), f"{where}: batch count")
    K.reset_launches()
    total = {}
    walls, fronts = [], []
    for i, ((name, ins, iw, rm), h) in enumerate(zip(batches, history)):
        before = dict(K.LAUNCHES)
        with record_traffic() as tlog:
            sync(device)
            t1 = time.perf_counter()
            st = m.apply_batch(insert_edges=ins, remove_edges=rm,
                               insert_weights=iw)
            sync(device)
            dt = time.perf_counter() - t1
        walls.append(dt)
        check(np.array_equal(m.cores(), h["cores"]),
              f"{where} {name}: cores != phase {tag}")
        check(np.array_equal(m.labels(), h["labels"]),
              f"{where} {name}: labels != phase {tag}")
        for f in ("n_inserted", "n_removed", "high_water"):
            check(int(getattr(st, f)) == h[f],
                  f"{where} {name}: {f} != phase {tag}")
        rounds = (int(st.remove_rounds), int(st.insert_rounds))
        check(rounds == h["rounds"], f"{where} {name}: rounds != phase {tag}")
        check(all(torch.equal(a, b) for a, b in zip(snapshot(m),
                                                    h["table"])),
              f"{where} {name}: slot table != the unified engine's")
        moved = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES
                 if K.LAUNCHES[k] != before[k]}
        tr = traffic_summary(tlog)
        for k, v in tr.items():
            total[k] = total.get(k, 0) + v
        # a refresh sends one count-prefixed id payload of cap + 1 words
        refreshes = (sum(t.op == "gather_frontier"
                         and t.recv_bytes == (cap + 1) * 4 for t in tlog)
                     if cap else None)
        fronts.append((int(st.max_frontier), int(st.n_overflow),
                       refreshes))
        rep = ("" if beside is None else
               f", {beside[0]} {beside[1][i]:.4f}, "
               f"x{dt / beside[1][i]:.3f}")
        log(f"{where} {name}: wall_s={dt:.4f} (phase {tag} "
            f"{h['wall_s']:.4f}, x{dt / h['wall_s']:.3f}{rep}) "
            f"remove_rounds={rounds[0]} insert_rounds={rounds[1]} "
            f"max_frontier={fronts[-1][0]} n_overflow={fronts[-1][1]} "
            f"refreshes={refreshes} "
            f"launches={json.dumps(moved)} collectives={json.dumps(tr)}")
    launches = dict(K.LAUNCHES)
    for k in ("fused_removal_round", "fused_promotion_stats"):
        check(launches[k] == 0,
              f"{where}: fused decision {k} ran under a mesh axis")
    for k in (WEIGHTED_PATH_KERNELS if m.weighted else SHARDED_PATH_KERNELS):
        check(launches[k] > 0, f"{where}: kernel {k} was never launched")
    log(f"{where} launches={json.dumps(launches)} "
        f"collectives={json.dumps(total)} "
        f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
    t1 = time.perf_counter()
    if m.weighted:
        check(all(torch.equal(a, b) for a, b in zip(
            snapshot(m), history[-1]["table"])),
            f"{where}: final table and weights != phase 5's")
        log(f"{where}: final cores, labels, slot table and weight column "
            f"== phase 5's (held there against a fresh weighted "
            f"from_graph and the host mirror)")
    else:
        from repro_torch.core.decomposition import peel_decomposition
        core, label = m._full(m.core), m._full(m.label)
        want, _ = peel_decomposition(m.src, m.dst, m.valid, m.n)
        check(torch.equal(core, want), f"{where}: cores != fresh peel")
        check(certificate_ok(m, core, label),
              f"{where}: k-order certificate violated")
        log(f"{where}: cores == fresh peel of the final live edge set, "
            f"certificate holds ({time.perf_counter() - t1:.1f} s)")
    return launches, walls, fronts


def pinned_cap(fronts) -> int:
    """Phase 8 pass iii's sparse cap: the largest power of two below the
    largest per-batch ``max_frontier`` of the range pass (a refreshed
    count: the burst removal's peak is its largest drop set), which must
    not fall below the smallest."""
    peaks = [f for f, _, _ in fronts]
    cap = 1 << max(max(peaks) - 1, 1).bit_length() - 1
    check(min(peaks) <= cap < max(peaks),
          f"phase 8: no power of two between the range pass's per-batch "
          f"max_frontier {min(peaks)} and {max(peaks)}")
    return cap


def phase_8(device, sample, stream, kept, rows) -> None:
    """Phase 8 on an initialized world of one rank: the replicated, range
    and halo passes over phases 4 and 5's batches (``sample``: the burst,
    ``stream``: the mixed batches) from the start states and histories
    in ``kept`` (popped, so each is freed once its passes are done);
    each coremaint row of ``rows`` gains its launches on the passes."""
    import torch
    from repro_torch.launch.mesh import make_edge_mesh, make_edge_vertex_mesh
    t8 = time.perf_counter()
    mesh = make_edge_mesh()
    start4, history = kept.pop("start4"), kept.pop("history")
    start5, whistory = kept.pop("start5"), kept.pop("whistory")
    batches4 = [("burst remove", None, None, sample),
                ("burst insert", sample, None, None)]
    batches4 += [(f"mixed {ev.t}", ev.edges, None, ev.removals)
                 for ev in stream]
    batches5 = [(h["name"], h["ins"], h["iw"], h["rm"]) for h in whistory]
    slaunches, swalls, _ = phase_sharded(device, mesh, start4, batches4,
                                         history, "4")
    torch.cuda.empty_cache()
    swlaunches, swwalls, _ = phase_sharded(device, mesh, start5, batches5,
                                           whistory, "5")
    torch.cuda.empty_cache()
    t8r = time.perf_counter()
    rlaunches, rwalls, rfronts = phase_sharded(
        device, mesh, start4, batches4, history, "4",
        vertex_sharding="range", beside=("replicated", swalls))
    torch.cuda.empty_cache()
    t8h = time.perf_counter()
    mesh2 = make_edge_vertex_mesh(mesh_shape=(1, 1))
    # pass i: the 2-axis mesh with the planned sparse cap
    hlaunches, _, _ = phase_sharded(
        device, mesh2, start4, batches4, history, "4",
        vertex_sharding="halo", beside=("range", rwalls),
        frontier_exchange="sparse", frontier_cap=0)
    torch.cuda.empty_cache()
    # pass iii: the range engine, sparse at a pinned cap that overflows
    # in some batches
    cap = pinned_cap(rfronts)
    log(f"phase 8 pass iii: frontier_cap={cap} between the range pass's "
        f"per-batch max_frontier {[f for f, _, _ in rfronts]}")
    _, _, sfronts = phase_sharded(
        device, mesh, start4, batches4, history, "4",
        vertex_sharding="range", beside=("range", rwalls),
        frontier_exchange="sparse", frontier_cap=cap)
    check(any(ovf > 0 for _, ovf, _ in sfronts),
          "phase 8 pass iii: no sparse refresh overflowed the cap")
    check(any(ovf < refreshes for _, ovf, refreshes in sfronts),
          "phase 8 pass iii: every sparse refresh of every batch "
          "overflowed")
    log(f"phase 8 pass iii: (max_frontier, n_overflow, refreshes) a batch "
        f"{sfronts}: both arms ran")
    del start4, history, batches4
    torch.cuda.empty_cache()
    t8w = time.perf_counter()
    rwlaunches, rwwalls, _ = phase_sharded(
        device, mesh, start5, batches5, whistory, "5",
        vertex_sharding="range", beside=("replicated", swwalls))
    torch.cuda.empty_cache()
    t8hw = time.perf_counter()
    # pass ii: the weighted engine on the 2-axis mesh, dense
    hwlaunches, _, _ = phase_sharded(
        device, mesh2, start5, batches5, whistory, "5",
        vertex_sharding="halo", beside=("range", rwwalls))
    t8e = time.perf_counter()
    del start5, whistory, batches5
    torch.cuda.empty_cache()
    for r in rows:
        weighted = r["name"] == "coo_stat[wsum]"
        r["sharded_launches"] = (swlaunches if weighted
                                 else slaunches)[r["name"]]
        r["range_launches"] = (rwlaunches if weighted
                               else rlaunches)[r["name"]]
        r["halo_launches"] = (hwlaunches if weighted
                              else hlaunches)[r["name"]]
        if r["name"] in ("coo_stat[mcd_hi_dout]", "coo_stat[hi_dout]"):
            # their own counted path: the sharded engine's unfused rounds
            r["launches"] = slaunches[r["name"]]
            r["status"] = "on the sharded path (phase 8)"
    log(f"phase 8: the halo passes i and iii {t8w - t8h:.1f} s, "
        f"ii {t8e - t8hw:.1f} s")
    log(f"phase 8: {time.perf_counter() - t8:.1f} s (the smoke's growth "
        f"for the sharded engine; the range and halo passes "
        f"{time.perf_counter() - t8r:.1f} s)")



def _pad512(x: int) -> int:
    """The recsys cells' padding of a count to a multiple of 512."""
    return -(-x // 512) * 512


def wall_ms(fn, calls: int, device) -> float:
    """Median host-clock time of ``fn`` over ``calls`` calls after a
    warm-up, each ended by a device sync."""
    fn()
    sync(device)
    ts = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        sync(device)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


_SOURCES = {"ell_stat": "segment_ell.cu", "ell_aggregate": "segment_ell.cu",
            "fm_interaction": "fm_interaction.cu",
            "flash_attention": "flash_attention.cu"}


def close(got, want, tol) -> tuple:
    """``(within tol, max abs err)``; ``tol`` = (rtol, atol), (0, 0) is
    bit for bit."""
    import torch
    rtol, atol = tol
    if rtol == atol == 0:
        ok = torch.equal(got, want)
    else:
        ok = torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol)
    diff = (got.double() - want.double()).abs()
    return ok, float(diff.max()) if diff.numel() else 0.0


def float_row(name, kname, got, want, tol, run, run_plain, nbytes, ops,
              peak, iters, device, shape, library=None,
              library_call=None, library_tol=None,
              phase="phase 6") -> dict:
    """Hold a kernel's output to its plain version's within ``tol``, time
    both with CUDA events, and return its ``kernels`` JSON row; ``name``
    is also its launch counter's key. ``library`` is one PyTorch call
    (``library_call`` names it) computing the same function: it is held
    once to the plain version within ``library_tol`` (``tol`` when None)
    and timed as the yardstick."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{phase} {name}: dtype/shape")
    ok, err = close(got, want, tol)
    check(ok, f"{phase} {name}: max abs err {err} over rtol/atol {tol}")
    if library is not None:
        lib_tol = tol if library_tol is None else library_tol
        ok, lib_err = close(library(), want, lib_tol)
        log(f"{phase} {name}: {library_call} max abs err to the plain "
            f"version {lib_err}")
        check(ok, f"{phase} {name}: {library_call} differs from the plain "
              f"version by {lib_err} over rtol/atol {lib_tol}")
    ms = time_ms(run, iters, device)
    plain_ms = time_ms(run_plain, max(1, iters // 4), device)
    lib_ms = time_ms(library, iters, device) if library else None
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    log(f"{phase} {name}: {shape} max_abs_err={err} (rtol/atol {tol}) "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms} "
        f"bytes={nbytes} ops={ops} bound_ms={max(t_bytes, t_ops):.4f}")
    return dict(
        name=name, route="cuda",
        source=f"src/repro_torch/csrc/{_SOURCES[kname]}",
        replaces=REPLACES[kname], launches=0, max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=lib_ms,
        library_note=library_call if library else NO_LIBRARY[kname],
    )


def gather_bytes(nbrs, feats) -> int:
    """What ``ell_aggregate`` must move at the least, gathers counted as
    the card moves them: every live neighbour that reads a row (its id
    wraps into [0, n)) in the whole 32-byte sectors that row spans from
    ``feats``' base, plus ``nbrs`` and the output once."""
    import torch
    n = nbrs.shape[0]
    ids = nbrs.long()
    r = torch.where(ids < 0, ids + n + 1, ids)
    r = r[(ids < n) & (r >= 0) & (r < n)]
    row = feats.shape[1] * feats.element_size()
    start = feats.data_ptr() % 32 + r * row
    sectors = int(((start + row - 1) // 32 - start // 32 + 1).sum())
    return 32 * sectors + 4 * nbrs.numel() + row * n


def stat_values(core) -> dict:
    """``ell_stat``'s values by tag: the int32 core numbers, float32 cores
    plus seeded per-vertex noise (``0.1 * randn``, seed 1), int64 cores."""
    import torch
    gen = torch.Generator(device=core.device).manual_seed(1)
    noise = 0.1 * torch.randn(core.shape, generator=gen, device=core.device)
    return {"i32": core.int(), "f32": core.float() + noise,
            "i64": core.long()}


def add_gather_bound(row, nbrs, x, phase="phase 6") -> None:
    """``gather_bytes`` of ``x``'s rows (``[n]`` values as rows of one)
    and its time at 3.35 TB/s beside the row's measured time."""
    row["gather_bytes"] = gather_bytes(nbrs, x.view(x.shape[0], -1))
    row["gather_bound_ms"] = row["gather_bytes"] / HBM_BYTES_PER_S * 1e3
    log(f"{phase} {row['name']}: gather_bytes={row['gather_bytes']} "
        f"gather_bound_ms={row['gather_bound_ms']:.4f} "
        f"share_of_gather_bound={row['gather_bound_ms'] / row['ms']:.3f}")


def phase_ell_kernels(device, nbrs, core, feats, iters: int) -> list:
    """``ell_stat`` and ``ell_aggregate`` against their plain versions on
    the ER graph's ELL matrix, core numbers and features."""
    import torch
    from repro_torch.kernels import segment_ell as SE

    n, d = nbrs.shape
    nnz = int((nbrs < n).sum())
    shape = f"nbrs=[{n}, {d}] neighbours={nnz}"
    rows = []
    vals = stat_values(core)
    for op, tag in STAT_ROWS:
        v = vals[tag]

        def run(op=op, v=v):
            return SE.ell_stat(nbrs, v, v, op)

        def plain(op=op, v=v):
            return SE.ell_stat_plain(nbrs, v, v, op)
        library = None
        if tag == "f32":
            # float values only: embedding_bag takes no integer table; a
            # sum adds in its own order, and a max leaves the sentinel out
            # (these values never fall below it)
            def library(op=op, t=torch.cat([v, v.new_zeros(1)])[:, None]):
                return torch.nn.functional.embedding_bag(
                    nbrs, t, mode=op, padding_idx=n)[:, 0]
        # nbrs, the values (vals and self_vals, one tensor) and the output
        # once; a compare and an add per neighbour
        rows.append(float_row(
            f"ell_stat[{op},{tag}]", "ell_stat", run(), plain(), (0, 0),
            run, plain, 4 * n * d + 2 * v.element_size() * n, 2 * nnz,
            FP32_PEAK if tag == "f32" else INT32_OPS_PER_S, iters, device,
            f"{shape} {tag}", library=library,
            library_call="embedding_bag over vals with a zero row "
                         "appended, padding_idx=n",
            library_tol=(1e-5, 1e-5) if op == "sum" else (0, 0)))
        add_gather_bound(rows[-1], nbrs, v)
    for dtype, tag, tsum in ((torch.float32, "f32", (1e-5, 1e-5)),
                             (torch.bfloat16, "bf16", (2e-2, 1e-2))):
        fe = feats.to(dtype)
        size = fe.element_size()
        # the yardstick's table: feats with a zero row n, the pad id
        fe_ext = torch.cat([fe, fe.new_zeros((1, fe.shape[1]))])
        for op in ("sum", "max"):
            def run(op=op, fe=fe):
                return SE.ell_aggregate(nbrs, fe, op)

            def plain(op=op, fe=fe):
                return SE.ell_aggregate_plain(nbrs, fe, op)

            def library(op=op, fe_ext=fe_ext):
                # each row of nbrs a fixed-length bag; pad entries (id n)
                # left out, an empty bag 0 (this graph has no negative
                # ids, and randn features never lose a max to -1e30)
                return torch.nn.functional.embedding_bag(
                    nbrs, fe_ext, mode=op, padding_idx=n)
            # nbrs, feats and the output once; an add or a max per
            # neighbour and feature
            rows.append(float_row(
                f"ell_aggregate[{op},{tag}]", "ell_aggregate", run(),
                plain(), tsum if op == "sum" else (0, 0), run, plain,
                4 * n * d + 2 * size * fe.numel(), nnz * fe.shape[1],
                FP32_PEAK, iters, device, f"{shape} feats={list(fe.shape)} "
                f"{tag}", library=library,
                library_call="embedding_bag over feats with a zero row "
                             "appended, padding_idx=n"))
            add_gather_bound(rows[-1], nbrs, fe)
        del fe, fe_ext
    return rows


def phase_fm_kernel(device, emb, iters: int) -> list:
    """``fm_interaction`` against its plain version on DeepFM's
    serve_bulk embeddings (float32, rtol/atol 1e-4)."""
    from repro_torch.kernels import fm_interaction as FM

    def run():
        return FM.fm_interaction(emb)

    def plain():
        return FM.fm_interaction_plain(emb)
    # emb read once, the output written once; an add and a multiply-add
    # per element
    return [float_row("fm_interaction[f32]", "fm_interaction", run(),
                      plain(), (1e-4, 1e-4), run, plain,
                      emb.element_size() * (emb.numel() + emb.shape[0]),
                      3 * emb.numel(), FP32_PEAK, iters, device,
                      f"emb={list(emb.shape)} {emb.dtype}")]


def attention_inputs(device, dtype, seed: int):
    import torch
    a = ATTN
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((a["b"], a["h"], a["s"], a["d"]), generator=gen,
                    device=device).to(dtype)
    k, v = (torch.randn((a["b"], a["hkv"], a["s"], a["d"]), generator=gen,
                        device=device).to(dtype) for _ in range(2))
    return q, k, v


def row_rel_err(got, want) -> float:
    """Max over the rows (the last axis) of |got - want| / |want|."""
    g, w = got.double(), want.double()
    return float(((g - w).norm(dim=-1) / w.norm(dim=-1)).max())


def phase_attention_kernel(device, iters: int):
    """``flash_attention`` against its plain version at qwen2-7b's heads
    on the prefill cut, causal bfloat16 and full float32, with
    ``scaled_dot_product_attention`` as the library yardstick. Each output
    is held twice: elementwise at the reference's kernel-test tolerance
    (3e-2 bf16, 2e-3 f32), and row by row, |got - want| / |want| over each
    query row below 1e-2 (bf16: a few 2**-9 roundings; the late rows' small
    values make an elementwise atol blind to a dropped key tile) or 1e-4
    (f32). Each row also carries its TFLOP/s, its share of the bound and
    its kernel instance's registers and spills from the build's
    ``ptxas -v``. Returns the rows and, by row name, each case's inputs and
    output."""
    import torch
    from repro_torch.kernels import build as KB
    from repro_torch.kernels import flash_attention as FA

    rows, keep = [], {}
    for causal, dtype, tol, row_tol, peak in (
            (True, torch.bfloat16, 3e-2, 1e-2, BF16_PEAK),
            (False, torch.float32, 2e-3, 1e-4, FP32_PEAK)):
        q, k, v = attention_inputs(device, dtype, seed=int(causal))

        def run(q=q, k=k, v=v, causal=causal):
            return FA.flash_attention(q, k, v, causal=causal)

        def plain(q=q, k=k, v=v, causal=causal):
            return FA.flash_attention_plain(q, k, v, causal=causal)

        def library(q=q, k=k, v=v, causal=causal):
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True)
        s, d = q.shape[2], q.shape[3]
        pairs = s * (s + 1) // 2 if causal else s * s
        ops = 4 * q.shape[0] * q.shape[1] * d * pairs
        got, want, lib = run(), plain(), library()
        name = FA.launch_key(causal, dtype, d)
        rel, lib_rel = row_rel_err(got, want), row_rel_err(lib, want)
        # a reading, not a gate: elements off by more than 1e-3 + 1e-2 |want|
        wd = want.double()
        over = [int(((x.double() - wd).abs() > 1e-3 + 1e-2 * wd.abs()).sum())
                for x in (got, lib)]
        del wd, lib
        log(f"phase 6 {name}: max row-relative error to the plain version "
            f"{rel} (kernel), {lib_rel} (scaled_dot_product_attention), "
            f"limit {row_tol}; elements over atol 1e-3 + rtol 1e-2: "
            f"{over[0]} (kernel), {over[1]} (sdpa)")
        check(rel < row_tol and lib_rel < row_tol,
              f"phase 6 {name}: row-relative error {rel} / {lib_rel} over "
              f"{row_tol}")
        rows.append(float_row(
            name, "flash_attention", got, want, (tol, tol), run, plain,
            q.element_size() * (2 * q.numel() + k.numel() + v.numel()),
            ops, peak, iters, device,
            f"q={list(q.shape)} kv={list(k.shape)} causal={causal} "
            f"{dtype}", library=library,
            library_call="scaled_dot_product_attention"))
        row = rows[-1]
        row["row_rel_err"] = rel
        row["over_1e-2_1e-3"] = over[0]
        row["reduced"] = ("prefill_32k's 32 x 32,768 cut to "
                          f"{q.shape[0]} x {s}")
        # the instance's ptxas report (registers, spills), from the build
        kernel = (f"flash_wgmma_kernelILi{d}E" if dtype == torch.bfloat16
                  else f"flash_ffma_kernelILi{d}E")
        usage = list(KB.ptxas_usage(kernel).values())
        check(len(usage) == 1, f"phase 6 {name}: no ptxas report of {kernel}")
        row["ptxas"] = usage[0]
        row["tflops"] = ops / row["ms"] / 1e9
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        log(f"phase 6 {name}: {row['tflops']:.1f} TFLOP/s, "
            f"{row['share_of_bound']:.3f} of the bound, max abs err "
            f"{row['max_abs_err']} against plain (tolerance {tol}), "
            f"{kernel}: {usage[0]['registers']} registers, "
            f"{usage[0]['spill_stores']} B spill stores, "
            f"{usage[0]['spill_loads']} B spill loads")
        keep[name] = (q, k, v, causal, got)
    return rows, keep


# ---------------------------------------------------------------------------
# phase 9: the GNN stack at full() width on GNN_SHAPES's cells
# ---------------------------------------------------------------------------
def _pad512(x: int) -> int:
    return -(-x // 512) * 512


def ogb_products_batch(device, cell):
    """``GNN_SHAPES``' ``ogb_products`` cell (``cell``: its params) at
    full size as ``launch/steps.py`` draws it: nodes and directed edges
    each padded to a multiple of 512, senders and receivers uniform from
    ``default_rng(0)``, self-loops masked, ``d_feat`` normal features
    from a seeded generator on ``device``; one graph."""
    import torch
    from repro_torch.models import gnn as G

    n, e = _pad512(cell["n_nodes"]), _pad512(cell["n_edges"])
    rng = np.random.default_rng(0)
    snd = torch.from_numpy(rng.integers(0, n, size=e)).to(device)
    rcv = torch.from_numpy(rng.integers(0, n, size=e)).to(device)
    feat = torch.randn((n, cell["d_feat"]), device=device,
                       generator=torch.Generator(device).manual_seed(0))
    return G.GraphBatch(
        node_feat=feat, senders=snd, receivers=rcv, edge_mask=snd != rcv,
        node_mask=torch.ones(n, dtype=torch.bool, device=device),
        graph_id=torch.zeros(n, dtype=torch.int64, device=device),
        n_graphs=1)


def gnn_seeds(m, n_seeds: int) -> np.ndarray:
    """``n_seeds`` distinct vertices drawn with ``core_sampling_weights``
    of a maintainer (``default_rng(0)``): the GraphSAGE seeds the
    maintained cores bias toward dense regions."""
    from repro_torch.core.applications import core_sampling_weights

    w = core_sampling_weights(m)
    return np.random.default_rng(0).choice(m.n, size=n_seeds, replace=False,
                                           p=w)


def gnn_time(fn) -> tuple:
    """``(median ms, max_memory_allocated, warm-up output, last output)``
    of ``fn``: the peak statistics reset first, then one warm-up call and
    ``SERVE_CALLS`` calls timed with CUDA events."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first = fn()
    ts = []
    for _ in range(SERVE_CALLS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        ts.append(start.elapsed_time(end))
    return float(np.median(ts)), torch.cuda.max_memory_allocated(), first, out


def block_edges_in_graph(g, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Whether each ``(a[i], b[i])`` is an edge of the CSR graph ``g``,
    looked up in the neighbour lists of the rows ``a`` touches."""
    rows = np.unique(a)
    start = g.indptr[rows]
    cnt = g.indptr[rows + 1] - start
    idx = np.repeat(start - np.cumsum(cnt) + cnt, cnt) + np.arange(cnt.sum())
    keys = np.repeat(rows, cnt) * g.n + g.indices[idx]
    return np.isin(a.astype(np.int64) * g.n + b, keys)


def phase_gnn(device, g, seeds) -> None:
    """Phase 9: the GNN stack's forwards on the card at ``full()`` width
    on ``GNN_SHAPES``' cells, each against the same module moved to the
    CPU (``ogb_products``: against a second card forward). Tolerances are
    the tier-1 tests' (``tests/test_torch_gnn_*.py``): GIN, DimeNet
    float32, NequIP energies and forces rtol/atol 1e-4; DimeNet bfloat16
    3e-2; PNA float32 rtol/atol 1e-4 on the rows
    ``pna_conditioned_rows`` names, and on the rest (fed by a node of
    in-degree 0 or 1) the card's largest absolute error against the CPU's
    float64 output at most 3x the CPU float32 output's (floored at 1e-6
    of max |logit|); ``ogb_products``' two forwards rtol/atol 1e-4 on the
    conditioned rows, within 1e-4 of max |logit| on the rest. NequIP under a seeded rotation: at full depth the card's
    energies and forces equal the CPU's (the reference's 2x2->2 path is
    not equivariant from 3 layers on); at the reference's test depth (2
    layers, full width) the energy is invariant and the forces
    equivariant at ``tests/test_models.py``'s tolerances."""
    import copy
    import dataclasses

    import torch
    from repro_torch.configs import dimenet as dimenet_cfg
    from repro_torch.configs import gin_tu as gin_cfg
    from repro_torch.configs import nequip as nequip_cfg
    from repro_torch.configs import pna as pna_cfg
    from repro_torch.configs.common import GNN_SHAPES
    from repro_torch.data.graphs import load_cora_like, random_molecule_batch
    from repro_torch.graph.sampler import NeighborSampler
    from repro_torch.models import gnn as G

    t_phase = time.perf_counter()
    cells = {c.name: c.params for c in GNN_SHAPES}

    def weights():  # drawn on the host from one seed, copied to the card
        return torch.Generator().manual_seed(0)

    def on_cpu(model):
        return copy.deepcopy(model).to("cpu")

    def report(model, cell, ms, peak, nodes, edges, triplets, extra):
        log(f"phase 9 {model} {cell}: wall_ms={ms:.4f} "
            f"max_memory_allocated={peak} nodes={nodes} edges={edges} "
            f"triplets={triplets} {extra}")

    def finite(x, shape, where):
        check(tuple(x.shape) == tuple(shape) and x.dtype == torch.float32
              and bool(torch.isfinite(x).all()),
              f"phase 9 {where}: output {tuple(x.shape)} {x.dtype} is not "
              f"finite float32 of shape {tuple(shape)}")

    def close(got, want, tol, where):
        err = float((got.double() - want.double()).abs().max())
        check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
              f"phase 9 {where}: the outputs differ (max abs err {err}, "
              f"rtol/atol {tol})")
        return err

    # PNA full() on full_graph_sm: load_cora_like
    cell = cells["full_graph_sm"]
    cfg = pna_cfg.full()
    _, batch, _ = load_cora_like(device=device)
    n, e = batch.node_feat.shape[0], batch.senders.shape[0]
    check(batch.node_feat.shape == (cell["n_nodes"], cell["d_feat"]),
          "phase 9 pna full_graph_sm: load_cora_like's shape")
    model = G.pna_init(cfg, weights(), device=device)
    with torch.no_grad():
        ms, peak, _, got = gnn_time(lambda: model(batch))
        finite(got, (n, cfg.n_classes), "pna full_graph_sm")
        cpu, b_cpu = on_cpu(model), batch.to("cpu")
        want32 = cpu(b_cpu)
        want64 = cpu.double()(dataclasses.replace(
            b_cpu, node_feat=b_cpu.node_feat.double()))
    got = got.cpu()
    ok = G.pna_conditioned_rows(b_cpu, cfg.n_layers)
    check(bool(ok.any()), "phase 9 pna full_graph_sm: no conditioned row")
    err_ok = close(got[ok], want32[ok], 1e-4,
                   f"pna full_graph_sm ({int(ok.sum())} conditioned rows)")
    ref_err = float((want32.double() - want64)[~ok].abs().max())
    err = float((got.double() - want64)[~ok].abs().max())
    limit = 3 * max(ref_err, 1e-6 * float(want64.abs().max()))
    check(err <= limit, f"phase 9 pna full_graph_sm: card error {err} "
          f"against float64 over {limit} (3x the CPU float32 error)")
    report("pna", "full_graph_sm", ms, peak, n, e, 0,
           f"conditioned_rows={int(ok.sum())} max_abs_err_vs_cpu_on_them="
           f"{err_ok} other rows: card_err_vs_f64={err} "
           f"cpu_f32_err_vs_f64={ref_err}")
    del model, cpu, batch, b_cpu, got

    # PNA full() on ogb_products at full size, launch/steps.py's draws
    cell = cells["ogb_products"]
    cfg = dataclasses.replace(pna_cfg.full(), d_in=cell["d_feat"])
    t0 = time.perf_counter()
    batch = ogb_products_batch(device, cell)
    n, e = batch.node_feat.shape[0], batch.senders.shape[0]
    sync(device)
    t_data = time.perf_counter() - t0
    model = G.pna_init(cfg, weights(), device=device)
    base = torch.cuda.memory_allocated()
    with torch.no_grad():
        ms, peak, first, got = gnn_time(lambda: model(batch))
    finite(got, (n, cfg.n_classes), "pna ogb_products")
    ok = G.pna_conditioned_rows(batch, cfg.n_layers)
    n_ok = int(ok.sum())
    diff_ok = close(got[ok], first[ok], 1e-4,
                    f"pna ogb_products two forwards ({n_ok} conditioned "
                    f"rows)")
    diff = float((got[~ok] - first[~ok]).abs().max()) if n_ok < n else 0.0
    scale = float(first.abs().max())
    check(diff <= 1e-4 * scale, f"phase 9 pna ogb_products: two card "
          f"forwards differ by {diff} (max |logit| {scale})")
    # at most two [E, d_hidden] tensors live (msg, msg * msg), plus the
    # layer's [N, d_hidden] ones
    msg_bytes = e * cfg.d_hidden * 4
    check(peak - base <= 2.25 * msg_bytes, f"phase 9 pna ogb_products: "
          f"{(peak - base) / msg_bytes:.3f} message tensors over the inputs")
    report("pna", "ogb_products", ms, peak, n, e, 0,
           f"live_edges={int(batch.edge_mask.sum())} "
           f"edge_tensor_bytes={msg_bytes} peak_over_inputs_in_edge_tensors"
           f"={(peak - base) / msg_bytes:.3f} conditioned_rows={n_ok} "
           f"two_forwards_max_diff={diff_ok} / {diff} "
           f"max_abs_logit={scale} data_s={t_data:.1f}")
    del model, batch, first, got, ok
    torch.cuda.empty_cache()

    # GIN full() on a minibatch_lg block of phase 4's graph, seeded by the
    # final maintainer's core_sampling_weights
    cell = cells["minibatch_lg"]
    check(len(seeds) == cell["batch_nodes"], "phase 9: seed count")
    t0 = time.perf_counter()
    blk = NeighborSampler(g, fanouts=cell["fanout"], seed=0).sample(seeds)
    t_sample = time.perf_counter() - t0
    mult = int(np.prod([f + 1 for f in cell["fanout"]]))
    n_cap, e_cap = len(seeds) * mult, 2 * len(seeds) * mult
    check(blk.node_ids.shape == (n_cap,) and blk.senders.shape == (e_cap,),
          "phase 9 gin minibatch_lg: block capacities")
    live = blk.edge_mask
    s_loc, r_loc = blk.senders[live], blk.receivers[live]
    check(bool(blk.node_mask[s_loc].all() and blk.node_mask[r_loc].all()),
          "phase 9 gin minibatch_lg: a live edge joins a padded node")
    check(bool(block_edges_in_graph(g, blk.node_ids[s_loc],
                                    blk.node_ids[r_loc]).all()),
          "phase 9 gin minibatch_lg: a live edge is not an edge of g")
    check(int(blk.seed_mask.sum()) == len(np.unique(seeds)),
          "phase 9 gin minibatch_lg: seed positions")
    feat = torch.randn((n_cap, cell["d_feat"]), device=device,
                       generator=torch.Generator(device).manual_seed(1))
    batch = G.GraphBatch.from_block(blk, feat, device=device)
    cfg = dataclasses.replace(gin_cfg.full(), d_in=cell["d_feat"])
    model = G.gin_init(cfg, weights(), device=device)
    with torch.no_grad():
        ms, peak, _, got = gnn_time(lambda: model(batch))
        finite(got, (1, cfg.n_classes), "gin minibatch_lg")
        want = on_cpu(model)(batch.to("cpu"))
    err = close(got.cpu(), want, 1e-4, "gin minibatch_lg")
    report("gin-tu", "minibatch_lg", ms, peak, n_cap, e_cap, 0,
           f"live_nodes={int(blk.node_mask.sum())} "
           f"live_edges={int(live.sum())} sample_s={t_sample:.1f} "
           f"max_abs_err_vs_cpu={err}")
    del model, batch, feat, got

    # DimeNet full() (float32, then bfloat16) and NequIP full() on molecule
    cell = cells["molecule"]
    batch = random_molecule_batch(n_mols=cell["batch"],
                                  n_atoms=cell["n_nodes"],
                                  n_edges=cell["n_edges"], device=device)
    b_cpu = batch.to("cpu")
    n, e = batch.node_feat.shape[0], batch.senders.shape[0]
    tri = G.build_triplets(b_cpu.senders.numpy(), b_cpu.receivers.numpy(),
                           b_cpu.edge_mask.numpy(), 2 * e)
    tri_dev, tri_cpu = G.triplet_tensors(tri, device), G.triplet_tensors(
        tri, "cpu")
    n_tri = int(tri[2].sum())
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 3e-2)):
        cfg = dataclasses.replace(dimenet_cfg.full(), msg_dtype=dt)
        model = G.dimenet_init(cfg, weights(), device=device)
        with torch.no_grad():
            ms, peak, _, got = gnn_time(lambda: model(batch, *tri_dev))
            finite(got, (cell["batch"],), f"dimenet molecule {dt}")
            want = on_cpu(model)(b_cpu, *tri_cpu)
        err = close(got.cpu(), want, tol, f"dimenet molecule {dt}")
        report("dimenet", f"molecule[{str(dt)[6:]}]", ms, peak, n, e,
               2 * e, f"live_edges={int(batch.edge_mask.sum())} "
               f"live_triplets={n_tri} max_abs_err_vs_cpu={err}")
        del model, got

    model = G.nequip_init(nequip_cfg.full(), weights(), device=device)
    ms, peak, _, (energy, forces) = gnn_time(
        lambda: model.energy_forces(batch))
    finite(energy, (cell["batch"],), "nequip molecule energy")
    finite(forces, (n, 3), "nequip molecule forces")
    e_cpu, f_cpu = on_cpu(model).energy_forces(b_cpu)
    err_e = close(energy.cpu(), e_cpu, 1e-4, "nequip molecule energy")
    err_f = close(forces.cpu(), f_cpu, 1e-4, "nequip molecule forces")
    q, r = np.linalg.qr(np.random.default_rng(3).normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    rot = torch.from_numpy(q).to(device, torch.float32)
    b_rot = dataclasses.replace(batch, positions=batch.positions @ rot.T)
    # full depth: the reference's 2x2->2 path leaks a trace into the l=2
    # channel, so from 3 layers the energy is not invariant; the card
    # must deviate as the CPU does
    e_rot, f_rot = model.energy_forces(b_rot)
    e_rot_cpu, f_rot_cpu = on_cpu(model).energy_forces(b_rot.to("cpu"))
    close(e_rot.cpu(), e_rot_cpu, 1e-4, "nequip molecule rotated energy")
    close(f_rot.cpu(), f_rot_cpu, 1e-4, "nequip molecule rotated forces")
    dev_full = float((e_rot - energy).abs().max())
    # the reference's own rotation test's depth (tests/test_models.py:96)
    # at full() width: invariant and equivariant
    two = G.nequip_init(dataclasses.replace(nequip_cfg.full(), n_layers=2),
                        weights(), device=device)
    e2, f2 = two.energy_forces(batch)
    e2_rot, f2_rot = two.energy_forces(b_rot)
    check(torch.allclose(e2_rot, e2, rtol=1e-4, atol=1e-4),
          "phase 9 nequip (2 layers): energy not invariant under a rotation")
    check(torch.allclose(f2_rot, f2 @ rot.T, rtol=1e-3, atol=1e-4),
          "phase 9 nequip (2 layers): forces not equivariant")
    report("nequip", "molecule", ms, peak, n, e, 0,
           f"energy_forces max_abs_err_vs_cpu={err_e} / {err_f}; rotated "
           f"(5 layers) energy moves {dev_full} (the reference's trace "
           f"leak, card == CPU); 2 layers: energy moves "
           f"{float((e2_rot - e2).abs().max())}, forces "
           f"{float((f2_rot - f2 @ rot.T).abs().max())}")
    del two
    del model, batch
    torch.cuda.empty_cache()
    log(f"phase 9: every GNN check passed in "
        f"{time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 10: the LM stack at full() width on LM_SHAPES's cells
# ---------------------------------------------------------------------------
def lm_rel(got, want) -> float:
    """Relative L2 error of ``got`` against ``want`` (moved to ``got``'s
    device), in float64."""
    g, w = got.double(), want.to(got.device).double()
    return float((g - w).norm() / w.norm())


def lm_errors(last, cache, last_w, cache_w) -> list:
    """``lm_rel`` of the last logits, then of each layer's cache entries
    (K and V, or the latent and its rope key) taken together."""
    import torch

    names = [k for k in cache_w if k != "length"]
    out = [lm_rel(last, last_w)]
    for i in range(cache_w[names[0]].shape[0]):
        out.append(lm_rel(
            torch.cat([cache[k][i].reshape(-1) for k in names]),
            torch.cat([cache_w[k][i].reshape(-1).to(cache[k].device)
                       for k in names])))
    return out


def lm_within(tag, errs, yard, factor) -> None:
    """Each error of ``errs`` at most ``factor`` x the same entry of
    ``yard`` (index 0 the last logits, then layer by layer)."""
    worst = max(e / y for e, y in zip(errs, yard))
    log(f"phase 10 {tag}: relative L2 errors (logits, then layers) "
        f"{[round(e, 6) for e in errs]} against {[round(y, 6) for y in yard]}"
        f"; worst ratio {worst:.4f} (limit {factor})")
    check(all(e <= factor * y for e, y in zip(errs, yard)),
          f"phase 10 {tag}: an error over {factor}x its yardstick "
          f"(worst ratio {worst})")


def lm_decode(cfg, model, cache, tok, steps: int) -> tuple:
    """``steps`` greedy ``decode_step``s from ``tok``, each timed with
    CUDA events: ``(median ms of the steps after the first, peak bytes,
    last logits, generated tokens [B, steps], cache)``."""
    import torch
    from repro_torch.models import transformer as T

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev, out = [], []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        logits, cache = T.decode_step(cfg, model, cache, tok)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        end.record()
        ev.append((start, end))
        out.append(tok)
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in ev]
    return (float(np.median(ms[1:])), torch.cuda.max_memory_allocated(),
            logits, torch.stack(out, 1), cache)


def decode_bytes(model, cache) -> tuple:
    """Bytes a ``decode_step`` must move at the least (every weight but
    the embedding table, and the cache up to its length, read once) and
    those the plain path moves: the reference's arithmetic upcasts each
    layer's whole cache and the unembedding to float32 (read in their
    dtype, written and read again at 4 bytes an element)."""
    length = int(cache["length"])
    names = [k for k in cache if k != "length"]
    size = {k: cache[k].element_size() for k in names}
    slots = cache[names[0]].shape[2]
    live = sum(cache[k].numel() // slots * length * size[k] for k in names)
    whole = sum(cache[k].numel() for k in names)
    weights = sum(p.numel() * p.element_size() for n, p in
                  model.named_parameters() if n != "embed")
    un = model.unembed.numel()
    bound = weights + live
    plain = weights + 8 * un + sum(cache[k].numel() * size[k]
                                   for k in names) + 8 * whole
    return bound, plain


def lm_part(name, ms, peak, n_tok, launches, extra="") -> None:
    log(f"phase 10 {name}: wall_ms={ms:.4f} peak_bytes={peak} "
        f"tokens={n_tok} launches={launches}{extra}")


def lm_free(name) -> None:
    """Each of phase 10's models starts from a freed card: the previous
    one deleted by the caller, then collected and the cache emptied;
    under 1 GB may stay allocated."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    log(f"phase 10 {name}: memory_allocated={held} before its weights")
    check(held < 1e9, f"phase 10 {name}: {held} B still allocated")


def lm_sized(name, model, t0) -> None:
    """Print the model's parameters and bytes; both must be the reckoned
    ``LM_FULL_PARAMS`` (bf16: two bytes each), and the model must
    resolve to the kernel path."""
    n = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"phase 10 {name} full(): n_params={n} bytes={nbytes} "
        f"kernel_backend={model.kernel_backend} "
        f"init {time.perf_counter() - t0:.1f} s")
    check(n == LM_FULL_PARAMS[name] and nbytes == 2 * n,
          f"phase 10 {name}: {n} parameters, {nbytes} B (expected "
          f"{LM_FULL_PARAMS[name]}, twice as many bytes)")
    check(model.kernel_backend == "cuda", f"phase 10: {name} does not "
          "resolve to the kernel path on the card")


def lm_prefill_f32(cfg, model, tokens, last: int) -> tuple:
    """The float32 yardstick: what ``T.prefill`` computes on
    ``model.converted(torch.float32)`` (the plain path, its attention
    streamed in ``LM_F32_CHUNK``-key chunks where they divide the
    length), with one layer's weights cast at a time, so no float32 copy
    of the model is made. Returns the logits of the last ``last``
    positions (``[B, last, vocab]``) and the cache."""
    import dataclasses

    import torch
    from repro_torch.models import transformer as T

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                attn_chunk=LM_F32_CHUNK)
    x = T._embed(model, tokens).float()
    pos = torch.arange(tokens.shape[1], device=x.device)[None, :]
    cache = {}
    for i in range(cfg.n_layers):
        lp = {k: v.float() for k, v in T._layer(model, i).items()}
        x, _, lc = T._block(cfg32, lp, x, pos, "torch")
        for k, v in lc.items():
            if k not in cache:
                cache[k] = v.new_empty((cfg.n_layers,) + tuple(v.shape))
            cache[k][i] = v
        del lp, lc
    return T._logits(cfg32, model, x[:, -last:]), cache


def lm_prefill_4k(name, cfg, model, toks) -> None:
    """Phase 10's 1 x ``LM_PREFILL`` prefill of a GQA model (``toks``: the
    prompt, then ``LM_TF_STEPS`` more tokens) on the kernel path and on
    the plain path from the same weights, both timed: the kernel path
    launches ``flash_attention[causal,bf16,d128]`` exactly once a layer
    and the plain path none; the kernel path's relative L2 error against
    float32 (``lm_prefill_f32``; last logits, each layer's K and V) at
    most 1.5x the plain bf16 path's; ``forward`` on the kernel path once
    a layer, its logits at the prompt's end those of prefill; the
    teacher-forced decode: the kernel prefill's cache widened by
    ``LM_TF_STEPS`` slots, a ``decode_step`` on each next token against
    ``forward``'s logits there, at most 3x the bf16 forward's own error
    against float32 (two bf16 computations of one function, each off by
    about that much)."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import transformer as T

    key = FA.launch_key(True, torch.bfloat16, 128)
    prompt = toks[:, :LM_PREFILL]
    n0 = FA.LAUNCHES[key]
    last_k, cache_k = T.prefill(cfg, model, prompt, "cuda")
    torch.cuda.synchronize()
    check(FA.LAUNCHES[key] - n0 == cfg.n_layers,
          f"phase 10 {name} prefill 4k: {FA.LAUNCHES[key] - n0} kernel "
          f"launches, not one a layer ({cfg.n_layers})")
    n0 = sum(FA.LAUNCHES.values())
    last_p, cache_p = T.prefill(cfg, model, prompt, "torch")
    torch.cuda.synchronize()
    check(sum(FA.LAUNCHES.values()) == n0,
          f"phase 10 {name}: the plain path launched a kernel")
    for path, n in (("kernel", cfg.n_layers), ("plain", 0)):
        ms, peak = gnn_time(lambda: T.prefill(
            cfg, model, prompt, "cuda" if n else "torch"))[:2]
        lm_part(f"{name} prefill 1x{LM_PREFILL} {path}", ms, peak,
                LM_PREFILL, n, f" tokens_per_s={LM_PREFILL / ms * 1e3:.1f}")
    t0 = time.perf_counter()
    logits_f, cache_f = lm_prefill_f32(cfg, model, toks, LM_TF_STEPS + 1)
    last_f, want_f = logits_f[:, 0], logits_f[0, 1:]
    cache_f = {k: v[:, :, :LM_PREFILL] for k, v in cache_f.items()}
    torch.cuda.synchronize()
    log(f"phase 10 {name} float32 yardstick (the plain path in float32, "
        f"a layer's weights cast at a time, no float32 copy of the model):"
        f" {toks.shape[1]} tokens in {time.perf_counter() - t0:.1f} s")
    lm_within(f"{name} prefill 4k kernel vs float32",
              lm_errors(last_k, cache_k, last_f, cache_f),
              lm_errors(last_p, cache_p, last_f, cache_f), 1.5)
    del cache_p, cache_f, last_p, last_f, logits_f
    n0 = FA.LAUNCHES[key]
    logits_b, _ = T.forward(cfg, model, toks, "cuda")
    check(FA.LAUNCHES[key] - n0 == cfg.n_layers,
          f"phase 10 {name} forward: not one kernel launch a layer")
    fwd_b = logits_b[0, LM_PREFILL:].clone()
    check(lm_rel(last_k, logits_b[0, LM_PREFILL - 1:LM_PREFILL]) < 1e-2,
          f"phase 10 {name}: prefill's last logits != forward's")
    del logits_b
    cache = T.widen_cache(cache_k, LM_PREFILL + LM_TF_STEPS)
    del cache_k
    dec = []
    for i in range(LM_TF_STEPS):
        lg, cache = T.decode_step(cfg, model, cache, toks[:, LM_PREFILL + i])
        dec.append(lg[0])
    dec = torch.stack(dec)
    check(int(cache["length"]) == LM_PREFILL + LM_TF_STEPS,
          f"phase 10 {name}: cache length after the teacher-forced decode")
    err_fwd, err_dec = lm_rel(fwd_b, want_f), lm_rel(dec, fwd_b)
    log(f"phase 10 {name} teacher-forced decode: {LM_TF_STEPS} steps after "
        f"the kernel prefill, relative L2 to forward's logits {err_dec} "
        f"(limit 3x {err_fwd}, the bf16 forward's error against "
        f"float32; the decode's own {lm_rel(dec, want_f)}); argmax "
        f"agrees at {int((dec.argmax(-1) == fwd_b.argmax(-1)).sum())}"
        f"/{LM_TF_STEPS}")
    check(err_dec <= 3 * err_fwd, f"phase 10 {name} teacher-forced decode: "
          f"{err_dec} over 3x {err_fwd}")


def lm_cpu_check(name, cut, p) -> None:
    """``cut``, the first ``LM_CPU_LAYERS`` layers at full width (bf16, on
    the card), on the prompt ``p``: the card against the CPU's plain
    path, in float32 (the f32 kernel; relative L2 at most 1e-4 on the
    logits and each layer's cache) and in bfloat16 (the card's error
    against the CPU's float32 at most 1.5x the CPU bf16 plain path's);
    one kernel launch a layer in each dtype."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    key32 = FA.launch_key(True, torch.float32, 128)
    cpu32 = cut.converted(torch.float32, "cpu")
    truth = T.prefill(cpu32.cfg, cpu32, p.cpu())
    del cpu32
    cpu16 = cut.converted(device="cpu")
    plain16 = T.prefill(cpu16.cfg, cpu16, p.cpu())
    del cpu16
    n0, n32 = sum(FA.LAUNCHES.values()), FA.LAUNCHES[key32]
    card16 = T.prefill(cut.cfg, cut, p, "cuda")
    card32_m = cut.converted(torch.float32)
    card32 = T.prefill(card32_m.cfg, card32_m, p, "cuda")
    check(FA.LAUNCHES[key32] - n32 == LM_CPU_LAYERS
          and sum(FA.LAUNCHES.values()) - n0 == 2 * LM_CPU_LAYERS,
          f"phase 10 {name} card vs CPU: not one launch a layer in each "
          "dtype")
    del card32_m
    errs32 = lm_errors(*card32, *truth)
    log(f"phase 10 {name} {LM_CPU_LAYERS} layers 1x{p.shape[1]} float32 "
        f"card (kernel) vs CPU (plain): relative L2 {errs32} (limit 1e-4)")
    check(max(errs32) <= 1e-4, f"phase 10 {name} card vs CPU float32")
    lm_within(f"{name} {LM_CPU_LAYERS} layers 1x{p.shape[1]} bf16 card "
              "(kernel) vs CPU float32", lm_errors(*card16, *truth),
              lm_errors(*plain16, *truth), 1.5)
    log(f"phase 10 {name} card vs CPU: {time.perf_counter() - t0:.1f} s")


def phase_lm(device) -> tuple:
    """Phase 10: the LM stack at ``full()`` width and depth on the card,
    bfloat16 unless named, TF32 off, random weights drawn on the card
    (seeded ``torch.Generator``s), tokens from ``default_rng(0)``.

    Each model starts from a freed card (``lm_free``: under 1 GB
    allocated) and its parameters and bytes are checked against the
    reckoning (``lm_sized``, ``LM_FULL_PARAMS``).

    (a) qwen2-7b (7,615,616,512 parameters, 15.23 GB):
      * ``lm_prefill_4k``: 1 x 4,096 prefill on the kernel path and on
        the plain path (the reference's ``_attend``) from the same
        weights, both timed, and the plain path in float32 a layer at a
        time (``lm_prefill_f32``): the kernel path launches
        ``flash_attention[causal,bf16,d128]`` exactly 28 times (once a
        layer) and the plain path none; the kernel path's relative L2
        error against float32 (last logits, and each layer's K and V
        cache) at most 1.5x the plain bf16 path's; teacher-forced
        decode: the kernel prefill's cache widened by 8 slots, 8
        ``decode_step``s on the next 8 tokens against ``forward``'s
        logits (kernel path) at those positions: their relative L2
        difference at most 3x the bf16 forward's own error against the
        float32 forward there (two bf16 computations of one function,
        each off by about that much);
      * ``prefill_32k`` cut to batch 1 (32 -> 1): 1 x 32,768 on the
        kernel, timed; on the first 4 layers (a copy) the kernel path
        against the reference's streaming path (``attn_chunk=2048``,
        ``launch/steps.py``'s value for the full cells): the kernel's
        error against the streaming path run in float32 at most 1.5x
        the bf16 streaming path's; the kernel alone on layer 0's q, k,
        v at this length against the reference's streaming
        ``_attend_chunked`` and SDPA (a ``kernels`` row; each row-relative
        error below 1e-2, as in phase 6);
      * ``decode_32k`` cut to batch 16 (128 -> 16): a 1 x 32,256
        prefill, the cache widened to 32,768 and repeated over 16 rows,
        64 greedy steps;
      * ``long_500k`` at batch 1: a seeded random cache of 524,288
        slots (30.06 GB) at length 524,224, 64 greedy steps;
      * ``lm_cpu_check``: the first 2 layers (a copy) at full width on
        1 x 256: the card against the CPU's plain path, in float32 (the
        f32 kernel; relative L2 at most 1e-4 on the logits and each
        layer's cache) and in bfloat16 (the card's error against the
        CPU's float32 at most 1.5x the CPU bf16 plain path's).
    (b) deepseek-v2-lite-16b (16,210,311,168 parameters, 32.42 GB; MLA
      + 64-expert MoE, the plain path, no kernel): 1 x 4,096 prefill
      (expert capacity 481) and ``forward`` (finite, aux loss > 0), 16
      greedy decode steps; its first 2 layers in float32 against the
      CPU at 1e-4 (float32: a bf16 rounding can flip a token's experts).
    (c) qwen3-8b (8,190,735,360 parameters, 16.38 GB; ``qk_norm``: two
      RMSNorms over ``d_head`` = 128 between the projections and RoPE):
      ``lm_prefill_4k`` (36 launches a prefill) and ``lm_cpu_check``.
    (d) yi-34b, the whole model (34,388,917,248 parameters, 68.78 GB; 60
      layers, 56 query heads over 8 KV heads): a 1 x 4,096 prefill on
      the kernel path (exactly 60 launches), timed, its peak
      ``max_memory_allocated`` beside the card's ``total_memory``; 16
      greedy decode steps from its cache; the plain path's prefill from
      the same weights (its unchunked ``[1, 56, 4096, 4096]`` float32
      scores, or ``attn_chunk=2048`` where they do not fit, as printed),
      both held to ``lm_prefill_f32`` as in ``lm_prefill_4k`` (the
      caches compared on the host); ``lm_cpu_check``.

    Returns phase 10's launches by ``flash_attention`` counter (its
    counted path) and the ``kernels`` row of the kernel at 1 x 32,768."""
    import dataclasses
    import gc

    import torch
    from repro_torch.configs import (deepseek_v2_lite_16b, qwen2_7b,
                                     qwen3_8b, yi_34b)
    from repro_torch.configs.common import LM_SHAPES
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import transformer as T

    t10 = time.perf_counter()
    cells = {c.name: c.params for c in LM_SHAPES}
    key = FA.launch_key(True, torch.bfloat16, 128)
    key32 = FA.launch_key(True, torch.float32, 128)
    rng = np.random.default_rng(0)

    def tokens(n, vocab):
        return torch.from_numpy(rng.integers(0, vocab, (1, n)).astype(
            np.int32)).to(device)

    def launched():
        return FA.LAUNCHES[key] + FA.LAUNCHES[key32]

    FA.reset_launches()
    lm_free("qwen2-7b")
    cfg = qwen2_7b.full()
    t0 = time.perf_counter()
    model = T.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                          device=device)
    sync(device)
    lm_sized("qwen2-7b", model, t0)
    toks = tokens(LM_PREFILL + LM_TF_STEPS, cfg.vocab)
    with torch.no_grad():
        # ---- (a) 1 x 4,096: kernel, plain, float32 ----------------------
        lm_prefill_4k("qwen2-7b", cfg, model, toks)
        torch.cuda.empty_cache()

        # ---- (a) prefill_32k cut to batch 1 ------------------------------
        s32 = cells["prefill_32k"]["seq"]
        toks32 = tokens(s32, cfg.vocab)
        n0 = FA.LAUNCHES[key]
        ms32, peak32, (last32, _), _ = gnn_time(
            lambda: T.prefill(cfg, model, toks32, "cuda"))
        check(FA.LAUNCHES[key] - n0 == (SERVE_CALLS + 1) * cfg.n_layers,
              "phase 10 prefill 32k: not one kernel launch a layer")
        check(bool(torch.isfinite(last32).all()),
              "phase 10 prefill 32k: logits not finite")
        # every matmul weight on every token, but the unembedding on the
        # last token only (prefill's logits); the embedding is a gather
        lin = 2 * (cfg.n_params - 2 * cfg.vocab * cfg.d_model) * s32 \
            + 2 * cfg.vocab * cfg.d_model
        att = 4 * cfg.n_heads * cfg.d_head * s32 * (s32 + 1) // 2 \
            * cfg.n_layers
        lm_part(f"prefill_32k 1x{s32} kernel (batch 32 -> 1)", ms32,
                peak32, s32, cfg.n_layers,
                f" tokens_per_s={s32 / ms32 * 1e3:.1f} flops={lin + att} "
                f"bound_ms={(lin + att) / BF16_PEAK * 1e3:.4f}")
        del last32, _  # _: the last timed call's output, its 1.9 GB cache
        # the first layers against the reference's streaming path
        t0 = time.perf_counter()
        cut = model.converted(n_layers=LM_CHUNK_LAYERS)
        chunked = dataclasses.replace(cut.cfg, attn_chunk=LM_CHUNK)
        l_k, c_k = T.prefill(cut.cfg, cut, toks32, "cuda")
        n0 = launched()
        l_c, c_c = T.prefill(chunked, cut, toks32, "torch")
        cut32 = cut.converted(torch.float32)
        del cut
        l_f, c_f = T.prefill(dataclasses.replace(cut32.cfg,
                                                 attn_chunk=LM_CHUNK),
                             cut32, toks32, "torch")
        check(launched() == n0, "phase 10: the streaming path launched a "
              "kernel")
        del cut32
        sync(device)
        log(f"phase 10 prefill_32k first {LM_CHUNK_LAYERS} layers: kernel, "
            f"streaming bf16 and float32 (attn_chunk={LM_CHUNK}) in "
            f"{time.perf_counter() - t0:.1f} s")
        lm_within(f"prefill_32k {LM_CHUNK_LAYERS} layers kernel vs "
                  "streaming float32", lm_errors(l_k, c_k, l_f, c_f),
                  lm_errors(l_c, c_c, l_f, c_f), 1.5)
        del l_k, c_k, l_c, c_c, l_f, c_f
        torch.cuda.empty_cache()
        # the kernel alone on layer 0's q, k, v at 32k
        lp0 = T._layer(model, 0)
        h = T.rms_norm(model.embed[toks32.long()], lp0["ln_attn"],
                       cfg.norm_eps)
        q, k, v = T._gqa_qkv(cfg, lp0, h, torch.arange(
            s32, device=device)[None])
        del h
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        path = dict(FA.LAUNCHES)

        def run():
            return FA.flash_attention(qh, kh, vh, causal=True, block_q=s32,
                                      block_k=s32)

        def plain():
            return T._attend_chunked(q, k, v, True, LM_CHUNK).transpose(1, 2)

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True, enable_gqa=True)
        ops = 4 * cfg.n_heads * cfg.d_head * s32 * (s32 + 1) // 2
        got, want = run(), plain()
        row = float_row(
            f"{key} prefill_32k", "flash_attention", got, want,
            (3e-2, 3e-2), run, plain,
            qh.element_size() * (2 * qh.numel() + kh.numel() + vh.numel()),
            ops, BF16_PEAK, SERVE_CALLS, device,
            f"q={list(qh.shape)} kv={list(kh.shape)} causal=True "
            f"torch.bfloat16 (qwen2-7b layer 0)", library=library,
            library_call="scaled_dot_product_attention", phase="phase 10")
        rel, lib_rel = row_rel_err(got, want), row_rel_err(library(), want)
        log(f"phase 10 {row['name']}: max row-relative error to the plain "
            f"version {rel} (kernel), {lib_rel} "
            "(scaled_dot_product_attention), limit 1e-2")
        check(rel < 1e-2 and lib_rel < 1e-2,
              f"phase 10 {row['name']}: row-relative error {rel} / "
              f"{lib_rel} over 1e-2")
        row["row_rel_err"] = rel
        row["tflops"] = ops / row["ms"] / 1e9
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["reduced"] = "prefill_32k's 32 x 32,768 cut to 1 x 32,768"
        log(f"phase 10 {row['name']}: {row['tflops']:.1f} TFLOP/s, "
            f"{row['share_of_bound']:.3f} of the bound")
        FA.LAUNCHES.update(path)  # the timed launches are not the path's
        del lp0, q, k, v, qh, kh, vh, got, want
        torch.cuda.empty_cache()

        # ---- (a) decode_32k cut to batch 16 -------------------------------
        t_cache = cells["decode_32k"]["cache"]
        s_pre = t_cache - 512
        n0 = FA.LAUNCHES[key]
        last_d, cache_d = T.prefill(cfg, model, tokens(s_pre, cfg.vocab),
                                    "cuda")
        check(FA.LAUNCHES[key] - n0 == cfg.n_layers,
              "phase 10 decode_32k prefill: not one launch a layer")
        cache_d = T.widen_cache(cache_d, t_cache)
        for name in ("k", "v"):
            cache_d[name] = cache_d[name].expand(
                -1, LM_DECODE_BATCH, -1, -1, -1).contiguous()
        torch.cuda.empty_cache()
        tok = torch.argmax(last_d, dim=-1).to(torch.int32).expand(
            LM_DECODE_BATCH).contiguous()
        n0 = launched()
        ms_d, peak_d, lg, gen, cache_d = lm_decode(cfg, model, cache_d, tok,
                                                   LM_DECODE_STEPS)
        check(launched() == n0, "phase 10: a decode step launched a kernel")
        check(int(cache_d["length"]) == s_pre + LM_DECODE_STEPS
              and bool(torch.isfinite(lg).all())
              and bool(((gen >= 0) & (gen < cfg.vocab)).all()),
              "phase 10 decode_32k: length, logits or tokens")
        bound, plain_b = decode_bytes(model, cache_d)
        lm_part(f"decode_32k batch {LM_DECODE_BATCH} (128 -> "
                f"{LM_DECODE_BATCH}), cache {t_cache}, {LM_DECODE_STEPS} "
                "steps (ms a step)", ms_d, peak_d,
                LM_DECODE_BATCH * LM_DECODE_STEPS, 0,
                f" tokens_per_s={LM_DECODE_BATCH / ms_d * 1e3:.1f} "
                f"bound_bytes={bound} "
                f"bound_ms={bound / HBM_BYTES_PER_S * 1e3:.4f}"
                f" plain_bytes={plain_b} "
                f"plain_bytes_ms={plain_b / HBM_BYTES_PER_S * 1e3:.4f}")
        del cache_d, last_d, lg
        torch.cuda.empty_cache()

        # ---- (a) long_500k at batch 1 -------------------------------------
        t_long = cells["long_500k"]["cache"]
        cache_l = T.init_cache(cfg, cells["long_500k"]["batch"], t_long,
                               device)
        gen_c = torch.Generator(device=device).manual_seed(2)
        for name in ("k", "v"):
            for i in range(cfg.n_layers):
                cache_l[name][i].normal_(generator=gen_c)
        cache_l["length"].fill_(t_long - LM_DECODE_STEPS)
        n0 = launched()
        ms_l, peak_l, lg, gen, cache_l = lm_decode(
            cfg, model, cache_l, tokens(1, cfg.vocab)[0], LM_DECODE_STEPS)
        check(launched() == n0, "phase 10: a decode step launched a kernel")
        check(int(cache_l["length"]) == t_long
              and bool(torch.isfinite(lg).all()),
              "phase 10 long_500k: length or logits")
        bound, plain_b = decode_bytes(model, cache_l)
        lm_part(f"long_500k batch 1, cache {t_long} "
                f"({sum(cache_l[k].numel() * 2 for k in ('k', 'v'))} B) from "
                f"length {t_long - LM_DECODE_STEPS}, {LM_DECODE_STEPS} steps "
                "(ms a step)", ms_l, peak_l, LM_DECODE_STEPS, 0,
                f" tokens_per_s={1 / ms_l * 1e3:.1f} bound_bytes={bound} "
                f"bound_ms={bound / HBM_BYTES_PER_S * 1e3:.4f} "
                f"plain_bytes={plain_b} "
                f"plain_bytes_ms={plain_b / HBM_BYTES_PER_S * 1e3:.4f}")
        del cache_l, lg
        torch.cuda.empty_cache()

        # ---- (a) the first 2 layers, card against CPU ---------------------
        cut = model.converted(n_layers=LM_CPU_LAYERS)
        del model
        torch.cuda.empty_cache()
        lm_cpu_check("qwen2-7b", cut, toks[:, :LM_CPU_PROMPT])
        del cut
        torch.cuda.empty_cache()

        # ---- (b) deepseek-v2-lite-16b ------------------------------------
        lm_free("deepseek-v2-lite-16b")
        cfg_d = deepseek_v2_lite_16b.full()
        t0 = time.perf_counter()
        md = T.init_params(cfg_d, torch.Generator(device=device).manual_seed(
            0), device=device)
        sync(device)
        log(f"phase 10 deepseek-v2-lite-16b full(): n_params="
            f"{cfg_d.n_params} bytes="
            f"{sum(x.numel() * x.element_size() for x in md.parameters())} "
            f"kernel_backend={md.kernel_backend} "
            f"init {time.perf_counter() - t0:.1f} s")
        check(md.kernel_backend == "torch", "phase 10: MLA resolved to the "
              "kernel path")
        toks_d = tokens(LM_PREFILL, cfg_d.vocab)
        n0 = launched()
        ms_m, peak_m, (last_m, cache_m), _ = gnn_time(
            lambda: T.prefill(cfg_d, md, toks_d))
        logits_m, aux = T.forward(cfg_d, md, toks_d)
        cap = int(cfg_d.moe.capacity_factor * cfg_d.moe.top_k * LM_PREFILL
                  / cfg_d.moe.n_routed) + 1
        check(bool(torch.isfinite(last_m).all())
              and bool(torch.isfinite(logits_m).all()) and float(aux) > 0,
              "phase 10 deepseek-v2-lite-16b: logits not finite or aux <= 0")
        lm_part(f"deepseek-v2-lite-16b prefill 1x{LM_PREFILL} (expert "
                f"capacity {cap})", ms_m, peak_m, LM_PREFILL, 0,
                f" tokens_per_s={LM_PREFILL / ms_m * 1e3:.1f} "
                f"aux={float(aux)} "
                f"last logits vs forward's {lm_rel(last_m, logits_m[:, -1])}")
        del logits_m
        cache_m = T.widen_cache(cache_m, LM_PREFILL + LM_MOE_STEPS)
        tok = torch.argmax(last_m, dim=-1).to(torch.int32)
        ms_md, peak_md, lg, gen, cache_m = lm_decode(cfg_d, md, cache_m, tok,
                                                     LM_MOE_STEPS)
        check(launched() == n0, "phase 10: deepseek launched the kernel")
        check(int(cache_m["length"]) == LM_PREFILL + LM_MOE_STEPS
              and bool(torch.isfinite(lg).all()),
              "phase 10 deepseek decode: length or logits")
        lm_part(f"deepseek-v2-lite-16b decode batch 1, {LM_MOE_STEPS} steps "
                "(ms a step)", ms_md, peak_md, LM_MOE_STEPS, 0,
                f" tokens_per_s={1 / ms_md * 1e3:.1f}")
        del cache_m, lg, _
        cut = md.converted(torch.float32, n_layers=LM_CPU_LAYERS)
        del md
        torch.cuda.empty_cache()
        p = toks_d[:, :LM_CPU_PROMPT]
        card = T.prefill(cut.cfg, cut, p)
        cpu = cut.converted(device="cpu")
        want = T.prefill(cpu.cfg, cpu, p.cpu())
        errs = lm_errors(*card, *want)
        log(f"phase 10 deepseek-v2-lite-16b {LM_CPU_LAYERS} layers "
            f"1x{LM_CPU_PROMPT} float32 card vs CPU: relative L2 {errs} "
            "(limit 1e-4)")
        check(max(errs) <= 1e-4, "phase 10 deepseek card vs CPU float32")
        del cut, cpu, card, want
        torch.cuda.empty_cache()

        # ---- (c) qwen3-8b: qk_norm, 36 layers ------------------------------
        lm_free("qwen3-8b")
        cfg = qwen3_8b.full()
        t0 = time.perf_counter()
        model = T.init_params(cfg, torch.Generator(
            device=device).manual_seed(0), device=device)
        sync(device)
        lm_sized("qwen3-8b", model, t0)
        toks = tokens(LM_PREFILL + LM_TF_STEPS, cfg.vocab)
        lm_prefill_4k("qwen3-8b", cfg, model, toks)
        cut = model.converted(n_layers=LM_CPU_LAYERS)
        del model
        torch.cuda.empty_cache()
        lm_cpu_check("qwen3-8b", cut, toks[:, :LM_CPU_PROMPT])
        del cut

        # ---- (d) yi-34b: the whole model, 60 layers, on one card ---------
        lm_free("yi-34b")
        cfg = yi_34b.full()
        t0 = time.perf_counter()
        model = T.init_params(cfg, torch.Generator(
            device=device).manual_seed(0), device=device)
        sync(device)
        lm_sized("yi-34b", model, t0)
        toks = tokens(LM_PREFILL, cfg.vocab)
        total = torch.cuda.get_device_properties(0).total_memory
        n0 = FA.LAUNCHES[key]
        last_k, cache_k = T.prefill(cfg, model, toks, "cuda")
        sync(device)
        check(FA.LAUNCHES[key] - n0 == cfg.n_layers,
              f"phase 10 yi-34b prefill: {FA.LAUNCHES[key] - n0} kernel "
              f"launches, not one a layer ({cfg.n_layers})")
        ms_y, peak_y = gnn_time(
            lambda: T.prefill(cfg, model, toks, "cuda"))[:2]
        lm_part(f"yi-34b prefill 1x{LM_PREFILL} kernel", ms_y, peak_y,
                LM_PREFILL, cfg.n_layers,
                f" tokens_per_s={LM_PREFILL / ms_y * 1e3:.1f} "
                f"total_memory={total} peak_share={peak_y / total:.4f}")
        cache = T.widen_cache(cache_k, LM_PREFILL + LM_YI_STEPS)
        tok = torch.argmax(last_k, dim=-1).to(torch.int32)
        n0 = launched()
        ms_d, peak_d, lg, gen, cache = lm_decode(cfg, model, cache, tok,
                                                 LM_YI_STEPS)
        check(launched() == n0, "phase 10: a yi-34b decode step launched a "
              "kernel")
        check(int(cache["length"]) == LM_PREFILL + LM_YI_STEPS
              and bool(torch.isfinite(lg).all())
              and bool(((gen >= 0) & (gen < cfg.vocab)).all()),
              "phase 10 yi-34b decode: length, logits or tokens")
        lm_part(f"yi-34b decode batch 1, {LM_YI_STEPS} steps (ms a step)",
                ms_d, peak_d, LM_YI_STEPS, 0,
                f" tokens_per_s={1 / ms_d * 1e3:.1f}")
        del cache, lg
        # the comparisons run on the host: the card keeps its room for
        # the plain path's [1, 56, 4096, 4096] float32 scores
        last_k, cache_k = last_k.cpu(), {k: v.cpu()
                                         for k, v in cache_k.items()}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        n0 = launched()
        plain = cfg
        try:
            out = T.prefill(cfg, model, toks, "torch")
        except torch.cuda.OutOfMemoryError:
            out = None
        if out is None:
            gc.collect()
            torch.cuda.empty_cache()
            plain = dataclasses.replace(cfg, attn_chunk=LM_CHUNK)
            out = T.prefill(plain, model, toks, "torch")
        last_p, cache_p = out[0].cpu(), {k: v.cpu()
                                          for k, v in out[1].items()}
        del out
        check(launched() == n0, "phase 10: the yi-34b plain path launched "
              "a kernel")
        log(f"phase 10 yi-34b prefill 1x{LM_PREFILL} plain: "
            + ("the unchunked scores" if plain is cfg else
               f"attn_chunk={LM_CHUNK} (the unchunked scores did not fit)")
            + f", peak_bytes={torch.cuda.max_memory_allocated()} "
            f"total_memory={total}")
        t0 = time.perf_counter()
        logits_f, cache_f = lm_prefill_f32(cfg, model, toks, 1)
        log(f"phase 10 yi-34b float32 yardstick (a layer's weights cast at "
            f"a time): {time.perf_counter() - t0:.1f} s")
        lm_within("yi-34b prefill 4k kernel vs float32",
                  lm_errors(last_k, cache_k, logits_f[:, 0], cache_f),
                  lm_errors(last_p, cache_p, logits_f[:, 0], cache_f), 1.5)
        del last_k, cache_k, last_p, cache_p, logits_f, cache_f
        cut = model.converted(n_layers=LM_CPU_LAYERS)
        del model
        torch.cuda.empty_cache()
        lm_cpu_check("yi-34b", cut, toks[:, :LM_CPU_PROMPT])
        del cut
        torch.cuda.empty_cache()

    counts = {k: c for k, c in FA.LAUNCHES.items() if c}
    row["launches"] = counts.get(key, 0)
    row["lm_launches"] = row["launches"]
    row["status"] = "on the LM path (phase 10)"
    log(f"phase 10 launches={json.dumps(counts)}; every LM check passed "
        f"in {time.perf_counter() - t10:.1f} s")
    return counts, row


# ---------------------------------------------------------------------------
# phase 11: training on the card
# ---------------------------------------------------------------------------
_RESUME_CHILD = r'''
import os, signal, sys, time
import torch
torch.use_deterministic_algorithms(True)
torch.backends.cuda.matmul.allow_tf32 = False
from repro_torch.configs import qwen2_7b
from repro_torch.data.lm import synthetic_lm_batches
from repro_torch.models import transformer as T
from repro_torch.optim.params import named
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import TrainConfig, run_training

d, STEPS, KILL = sys.argv[1], 12, 5
cfg = qwen2_7b.smoke()  # bfloat16: the checkpoints hold bf16 leaves


def batches():
    for t, y in synthetic_lm_batches(cfg.vocab, 4, 64, seed=0):
        yield torch.from_numpy(t).cuda(), torch.from_numpy(y).cuda()


def fresh():
    return T.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                         device="cuda")


def lf(p, t, y):
    return T.loss_fn(cfg, p, t, y, kernel_backend="torch")


def tc(ckdir=None):
    return TrainConfig(lr=1e-3, warmup=2, total_steps=STEPS,
                       micro_batches=2, ckpt_dir=ckdir, ckpt_every=1000)


full, rep_full = run_training(fresh(), lf, batches(), tc())


def kill(step, _m):
    if step == KILL:  # inside the guard's window: run_training's loop
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.05)


seen = []
signal.signal(signal.SIGTERM, lambda *a: seen.append(a[0]))
_, rep1 = run_training(fresh(), lf, batches(), tc(d), on_step=kill)
assert rep1["final_step"] == KILL and not seen, (rep1["final_step"], seen)
assert ckpt.latest_step(d) == KILL, ckpt.latest_step(d)
stream = batches()
for _ in range(KILL + 1):
    next(stream)
res, rep2 = run_training(fresh(), lf, stream, tc(d))
assert len(rep2["history"]) == STEPS - KILL - 1 and not seen
n = 0
for k, t in named(full).items():
    assert torch.equal(t, named(res)[k]), k
    n += 1
for name in ("m", "v"):
    for k, t in rep_full["opt_state"][name].items():
        assert torch.equal(t, rep2["opt_state"][name][k]), (name, k)
        n += 1
assert int(rep2["opt_state"]["count"]) == STEPS
assert rep2["history"] == rep_full["history"][KILL + 1:]
print(f"resume: SIGTERM at step {KILL} of {STEPS}, checkpoint of step "
      f"{KILL} restored, {n} tensors and the losses of steps "
      f"{KILL + 1}-{STEPS - 1} equal the uninterrupted run bit for bit")
'''


def _named_equal(a, b) -> int:
    """Check two ``(module, opt_state)`` pairs equal bit for bit; return
    the tensors compared."""
    import torch
    from repro_torch.optim.params import named

    n = 0
    for k, t in named(a[0]).items():
        check(t.dtype == named(b[0])[k].dtype and
              torch.equal(t, named(b[0])[k]), f"phase 11c: {k} differs")
        n += 1
    for name in ("m", "v"):
        for k, t in a[1][name].items():
            check(torch.equal(t, b[1][name][k]), f"phase 11c: {name} {k}")
            n += 1
    check(int(a[1]["count"]) == int(b[1]["count"]), "phase 11c: count")
    return n + 1


def phase_train_lm(device, smi: str) -> tuple:
    """Phase 11a: qwen2-7b at ``full()`` width cut to ``TRAIN_LAYERS``
    layers, bfloat16, ``run_training`` for ``TRAIN_STEPS`` steps."""
    import dataclasses

    import torch
    from repro_torch.configs import qwen2_7b
    from repro_torch.data.lm import synthetic_lm_batches
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import transformer as T
    from repro_torch.optim.params import named
    from repro_torch.train.loop import TrainConfig, run_training

    cfg = dataclasses.replace(qwen2_7b.full(), n_layers=TRAIN_LAYERS)
    t0 = time.perf_counter()
    model = T.init_params(cfg, torch.Generator(device).manual_seed(0),
                          device=device)
    n_params = sum(p.numel() for p in model.parameters())
    data = synthetic_lm_batches(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    batches = [tuple(torch.from_numpy(x).to(device) for x in next(data))
               for _ in range(TRAIN_STEPS)]
    before = {k: p.detach().reshape(-1)[:4096].clone()
              for k, p in named(model).items()}
    sync(device)
    log(f"phase 11a qwen2-7b full() width, {TRAIN_LAYERS} of 28 layers, "
        f"bf16: {n_params} parameters; {TRAIN_STEPS} batches of "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, micro_batches={TRAIN_MB} "
        f"({time.perf_counter() - t0:.1f} s set-up)")

    h_before = dict(FA.LAUNCHES)
    ends = []

    def on_step(step, _m):  # metrics were read: the step is done
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()

    def lf(p, tokens, targets):
        return T.loss_fn(cfg, p, tokens, targets, kernel_backend="torch")

    tc = TrainConfig(lr=3e-4, warmup=1, total_steps=TRAIN_STEPS,
                     micro_batches=TRAIN_MB)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    model, report = run_training(model, lf, iter(batches), tc,
                                 on_step=on_step)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    hist = report["history"]
    check(len(hist) == TRAIN_STEPS == len(ends), "phase 11a: step count")
    walls = [start.elapsed_time(ends[0])] + [
        a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for i, (w, h) in enumerate(zip(walls, hist)):
        log(f"phase 11a step {i}: wall_ms={w:.4f} "
            f"tokens_per_s={tokens / (w / 1e3):.1f} loss={h['loss']:.6f} "
            f"grad_norm={h['grad_norm']:.6f} lr={h['lr']:.6e} | {smi}")
        check(all(np.isfinite(v) for v in h.values()),
              f"phase 11a: step {i} metrics not finite: {h}")
        check(h["grad_norm"] > 0, f"phase 11a: step {i} grad_norm 0")
    still = sorted(k for k, p in named(model).items()
                   if torch.equal(p.detach().reshape(-1)[:4096], before[k]))
    # the norm scales start at 1.0, where a bf16 ulp is 2^-8: with no
    # float32 master copy (the reference's arithmetic) an update of
    # lr * (step + wd) ~ 3e-4 rounds back to 1.0
    check(set(still) <= set(BF16_STILL),
          f"phase 11a: parameters that did not move: {still}")
    check(FA.LAUNCHES == h_before,
          "phase 11a: training launched the attention kernel")
    steady = float(np.median(walls[1:]))
    log(f"phase 11a: median step (steps 1-{TRAIN_STEPS - 1}) "
        f"{steady:.4f} ms, {tokens / (steady / 1e3):.1f} tokens/s; "
        f"max_memory_allocated={peak}; {len(before) - len(still)} of "
        f"{len(before)} parameter tensors moved (not {still}: bf16 "
        f"rounds their updates away at 1.0, no master copy); "
        f"flash_attention launches unchanged ({sum(h_before.values())}) "
        f"| {smi}")
    return model, report["opt_state"]


def phase_train_cpu(device) -> None:
    """Phase 11b: one training step (``make_train_step``, 2
    micro-batches) on the card and on the CPU from the same weights and
    tokens: qwen2-7b at ``full()`` width, 1 layer, float32, TF32 off,
    ``TRAIN_CPU_BATCH`` x ``TRAIN_CPU_SEQ`` tokens. Loss at rtol 1e-5,
    grad norm at 1e-4, ``m`` / ``v`` at a relative L2 error of 1e-3 a
    tensor, the update elementwise at ``1e-3 * lr`` where the CPU's
    gradient is at least 1e-6 (AdamW's first step is ``g / (|g| +
    1e-8)``: smaller gradients, which most of the 152,064 unembedding
    columns get, take their direction from their last bits) and at most
    ``2 * lr`` everywhere (``tests/test_torch_steps.py`` holds the port
    to the reference the same way)."""
    import dataclasses

    import torch
    from repro_torch.configs import qwen2_7b
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.optim.params import named
    from repro_torch.train.loop import TrainConfig, make_train_step

    t0 = time.perf_counter()
    cfg = dataclasses.replace(qwen2_7b.full(), n_layers=1,
                              dtype=torch.float32)
    card = T.init_params(cfg, torch.Generator(device).manual_seed(1),
                         device=device)
    host = card.converted(device="cpu")
    old = {k: p.detach().clone() for k, p in named(host).items()}
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (TRAIN_CPU_BATCH, TRAIN_CPU_SEQ + 1)).astype(np.int32))
    lr = 1e-4
    step = make_train_step(
        lambda p, t, y: T.loss_fn(cfg, p, t, y, kernel_backend="torch"),
        TrainConfig(lr=lr, warmup=0, total_steps=10, micro_batches=2))
    out = {}
    for name, model in (("card", card), ("cpu", host)):
        dev = model.embed.device
        state = adamw_init(model)
        t = toks.to(dev)
        t1 = time.perf_counter()
        _, state, met = step(model, state, 0, t[:, :-1], t[:, 1:])
        sync(dev)
        out[name] = (model, state, {k: float(v) for k, v in met.items()},
                     time.perf_counter() - t1)
    (gm, gs, gmet, gt), (cm, cs, cmet, ct) = out["card"], out["cpu"]
    check(abs(gmet["loss"] - cmet["loss"]) <= 1e-5 * abs(cmet["loss"]),
          f"phase 11b: loss {gmet['loss']} vs CPU {cmet['loss']}")
    check(abs(gmet["grad_norm"] - cmet["grad_norm"])
          <= 1e-4 * cmet["grad_norm"],
          f"phase 11b: grad_norm {gmet['grad_norm']} vs {cmet['grad_norm']}")
    worst = dict(m=0.0, v=0.0, upd=0.0, upd_all=0.0)
    for k, p in named(cm).items():  # compared on the card
        for mom in ("m", "v"):
            want = cs[mom][k].to(device)
            rel = float((gs[mom][k] - want).norm()
                        / max(float(want.norm()), 1e-30))
            worst[mom] = max(worst[mom], rel)
        base = old[k].to(device)
        diff = ((named(gm)[k].detach() - base)
                - (p.detach().to(device) - base)).abs()
        # m = (1 - b1) g after the first step
        big = (cs["m"][k].to(device) / 0.1).abs() >= 1e-6
        if bool(big.any()):
            worst["upd"] = max(worst["upd"], float(diff[big].max()) / lr)
        worst["upd_all"] = max(worst["upd_all"], float(diff.max()) / lr)
        del base, diff, big
    check(worst["m"] <= 1e-3 and worst["v"] <= 1e-3,
          f"phase 11b: moments off {worst}")
    check(worst["upd"] <= 1e-3 and worst["upd_all"] <= 2.0,
          f"phase 11b: updates off {worst}")
    log(f"phase 11b card vs CPU, 1 layer full width float32, "
        f"{TRAIN_CPU_BATCH} x {TRAIN_CPU_SEQ} tokens, 2 micro-batches: "
        f"loss {gmet['loss']:.7f} / {cmet['loss']:.7f}, grad_norm "
        f"{gmet['grad_norm']:.7f} / {cmet['grad_norm']:.7f}; worst "
        f"relative L2 m {worst['m']:.3e} v {worst['v']:.3e} (limit 1e-3); "
        f"update error / lr {worst['upd']:.3e} where |g| >= 1e-6 (limit "
        f"1e-3), {worst['upd_all']:.3e} anywhere (limit 2); step "
        f"{gt:.2f} s card, {ct:.2f} s CPU ({time.perf_counter() - t0:.1f} s)")


def phase_train_ckpt(device, model, opt_state, work: Path) -> None:
    """Phase 11c: (i) phase 11a's state saved once and restored once
    into fresh tensors, timed (the sha256 passes timed apart), bit for
    bit (bf16 leaves included); (ii) at ``smoke()`` width under
    ``torch.use_deterministic_algorithms``, in a child process, a run
    interrupted by a SIGTERM it sends itself inside ``run_training``'s
    loop, resumed from its checkpoint, equals an uninterrupted run bit
    for bit; (iii) ``python -m repro_torch.launch.train --arch qwen2-7b
    --smoke --steps 20 --ckpt-dir DIR`` twice, the second resuming. The
    child processes run after (i), so they share neither its timing nor
    the card."""
    import os
    import shutil

    import torch
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train import checkpoint as ckpt

    d = work / "full"
    free = shutil.disk_usage(work).free
    hashed = []
    sha256 = ckpt._sha256

    def timed_sha256(path):  # the commit hash, timed apart
        t = time.perf_counter()
        out = sha256(path)
        hashed.append(time.perf_counter() - t)
        return out

    ckpt._sha256 = timed_sha256
    try:
        t0 = time.perf_counter()
        path = ckpt.save_checkpoint(str(d), TRAIN_STEPS - 1,
                                    (model, opt_state))
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        like = T.LM(model.cfg, device)
        with torch.no_grad():
            for p in like.parameters():
                p.zero_()
        like_state = adamw_init(like)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step, _ = ckpt.restore_checkpoint(str(d), (like, like_state))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        ckpt._sha256 = sha256
    check(step == TRAIN_STEPS - 1, f"phase 11c: restored step {step}")
    n = _named_equal((model, opt_state), (like, like_state))
    log(f"phase 11c checkpoint of 11a's state: {nbytes} bytes ({n} "
        f"tensors: bf16 weights as |V2, float32 m and v), save "
        f"{save_s:.2f} s ({nbytes / save_s / 1e9:.3f} GB/s; its sha256 "
        f"{hashed[0]:.2f} s), restore {restore_s:.2f} s "
        f"({nbytes / restore_s / 1e9:.3f} GB/s; the commit's sha256 "
        f"{hashed[1]:.2f} s), bit for bit; {free} bytes free on the disk")
    del like, like_state
    shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUBLAS_WORKSPACE_CONFIG=":4096:8")

    def run(args, what):
        t0 = time.perf_counter()
        out = subprocess.run(args, env=env, capture_output=True, text=True,
                             timeout=600)
        check(out.returncode == 0,
              f"phase 11c: {what} failed:\n{out.stdout}\n"
              f"{out.stderr[-3000:]}")
        return out.stdout.strip().splitlines(), time.perf_counter() - t0

    lines, secs = run([sys.executable, "-c", _RESUME_CHILD,
                       str(work / "resume")], "the deterministic resume")
    check("bit for bit" in lines[-1],
          f"phase 11c: deterministic resume: {lines[-1]}")
    log(f"phase 11c {lines[-1]} (a child process, {secs:.1f} s)")
    launch = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
              "qwen2-7b", "--smoke", "--steps", "20", "--ckpt-dir",
              str(work / "launch")]
    runs = [run(launch, f"launch.train run {i + 1}") for i in range(2)]
    for i, (lines, secs) in enumerate(runs):
        log(f"phase 11c launch.train run {i + 1} ({secs:.1f} s): "
            f"{lines[0]} ... "
            f"{' / '.join(x for x in lines if 'resum' in x)} ... "
            f"{lines[-1]}")
    first, second = runs[0][0], runs[1][0]
    check(not any("resuming" in x for x in first),
          "phase 11c: the first launch.train run resumed")
    check(any("resuming after committed step" in x for x in second),
          "phase 11c: the second launch.train run did not resume")
    check(second[-1].startswith("[train] done @ step 20"),
          f"phase 11c: the resumed run ended with {second[-1]}")


def phase_train_gnn(device) -> dict:
    """Phase 11d: ``examples/train_gnn_torch.py``'s ``train`` at ``n =
    GNN_TRAIN["n"]``, ``m = 4 n``, one burst of ``GNN_TRAIN["burst"]``
    edges before each of ``GNN_TRAIN["steps"]`` PNA steps: the
    maintainer on the card (unified engine, kernel_backend "cuda"), the
    coremaint launch counts from 0 before it and read after it (the
    training path's launches of a, b and c), the final cores against a
    fresh peel and the k-order certificate, the loss improved."""
    import torch
    from repro_torch.core.decomposition import peel_decomposition
    from repro_torch.kernels import coremaint as K

    sys.path.insert(0, str(ROOT / "examples"))
    import train_gnn_torch as TG

    K.reset_launches()
    t0 = time.perf_counter()
    report, m, _ = TG.train(GNN_TRAIN["n"], GNN_TRAIN["steps"],
                            GNN_TRAIN["burst"], device, log_every=20,
                            say=lambda s: log(f"phase 11d {s}"))
    sync(device)
    wall = time.perf_counter() - t0
    counts = dict(K.LAUNCHES)
    check(m.kernel_backend == "cuda" and m.device.type == "cuda",
          f"phase 11d: maintainer on {m.device} / {m.kernel_backend}")
    for k in MAIN_PATH_KERNELS:
        check(counts[k] > 0, f"phase 11d: kernel {k} was never launched "
              "inside the training loop")
    hist = report["history"]
    check(len(hist) == GNN_TRAIN["steps"], "phase 11d: step count")
    check(hist[-1]["loss"] < hist[0]["loss"],
          f"phase 11d: loss {hist[0]['loss']} -> {hist[-1]['loss']}")
    want, _ = peel_decomposition(m.src, m.dst, m.valid, m.n)
    check(torch.equal(m.core, want), "phase 11d: cores != fresh peel")
    check(certificate_ok(m), "phase 11d: k-order certificate violated")
    log(f"phase 11d dynamic-graph PNA training, n={m.n} "
        f"live_edges={m.live_edges} {GNN_TRAIN['steps']} bursts of "
        f"{GNN_TRAIN['burst']}: loss {hist[0]['loss']:.6f} -> "
        f"{hist[-1]['loss']:.6f}; launches inside the loop "
        f"{json.dumps({k: c for k, c in counts.items() if c})}; cores == "
        f"fresh peel, certificate holds ({wall:.1f} s)")
    return counts


def phase_train_cells(device) -> None:
    """Phase 11e: ``build_cell`` train cells at ``full()``
    (``concrete_inputs(0)``), two steps each, the second timed (CUDA
    events; the first's wall holds its first-call costs): wall, peak
    memory, finite loss and grad norm, every parameter finite; PNA
    ``ogb_products`` at a 1/``OGB_TRAIN_CUT`` cut of its nodes and edges
    (its training step saves about three ``[E, 75]`` float32 tensors a
    layer: ~223 GB uncut); the coremaint cells on the reference's graph
    (``coremaint_graph``, one maintainer built with the device peel,
    both cells' inputs from its tensors), one step each, the cores after
    it equal to a fresh peel of the table."""
    import torch
    from repro_torch.configs import coremaint as CM
    from repro_torch.configs import get_arch
    from repro_torch.configs.common import ShapeCell
    from repro_torch.core.api import CoreMaintainer
    from repro_torch.core.decomposition import peel_decomposition
    from repro_torch.device import resolve_device
    from repro_torch.launch import steps as ST

    def timed(fn, *args):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end), torch.cuda.max_memory_allocated()

    progs = [ST.build_cell(a, s, device=device) for a, s in TRAIN_CELLS]
    cell = next(c for c in get_arch("pna").SHAPES if c.name == "ogb_products")
    cut = ShapeCell(f"ogb_products/{OGB_TRAIN_CUT}", cell.kind, dict(
        cell.params, n_nodes=cell.params["n_nodes"] // OGB_TRAIN_CUT,
        n_edges=cell.params["n_edges"] // OGB_TRAIN_CUT))
    progs.append(ST._gnn_cell("pna", get_arch("pna").full(), cut, False,
                              True, False, resolve_device(device)))
    for prog in progs:
        t0 = time.perf_counter()
        inputs = prog.concrete_inputs(0)
        sync(device)
        setup = time.perf_counter() - t0
        _, cold, _ = timed(prog.fn, *inputs)  # the cell's step, first call
        (params, state, met), ms, peak = timed(prog.fn, *inputs)
        loss, gn = float(met["loss"]), float(met["grad_norm"])
        check(np.isfinite(loss) and np.isfinite(gn),
              f"phase 11e {prog.name}: loss {loss} grad_norm {gn}")
        check(int(state["count"]) == 2, f"phase 11e {prog.name}: count")
        check(all(bool(torch.isfinite(p).all()) for p in params.parameters()),
              f"phase 11e {prog.name}: a parameter is not finite")
        log(f"phase 11e {prog.name}: wall_ms={ms:.4f} (the second step; "
            f"the first {cold:.4f}) peak_bytes={peak} loss={loss:.6f} "
            f"grad_norm={gn:.6f} parameters="
            f"{sum(p.numel() for p in params.parameters())} "
            f"(set-up {setup:.1f} s)")
        del inputs, params, state, met
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg = CM.full()
    m = CoreMaintainer.from_graph(ST.coremaint_graph(cfg),
                                  capacity=ST._pad512(cfg.edge_capacity),
                                  init="jax-peel", device=device)
    sync(device)
    log(f"phase 11e coremaint maintainer: n={m.n} "
        f"live_edges={m.live_edges} capacity={m.capacity} "
        f"(erdos_renyi and the device peel: {time.perf_counter() - t0:.1f} s)")
    for shape in ("remove_100k", "insert_100k"):
        prog = ST.build_cell("coremaint", shape, device=device)
        cell = next(c for c in CM.SHAPES if c.name == shape)
        inputs = ST.coremaint_batch(cfg, cell, m)  # the steps keep m intact
        out, ms, peak = timed(prog.fn, *inputs)
        if shape == "insert_100k":
            src, dst, valid, _, core, label, stats = out
        else:
            (valid, core, label, stats), (src, dst) = out, inputs[:2]
        t0 = time.perf_counter()
        want, _ = peel_decomposition(src, dst, valid, cfg.n_vertices)
        check(torch.equal(core, want),
              f"phase 11e {prog.name}: cores != fresh peel")
        log(f"phase 11e {prog.name}: wall_ms={ms:.4f} peak_bytes={peak} "
            f"capacity={src.shape[0]} "
            f"{' '.join(f'{k}={int(v)}' for k, v in stats._asdict().items())}"
            f"; cores == fresh peel ({time.perf_counter() - t0:.1f} s)")
        del inputs, out, src, dst, valid, core, label
        torch.cuda.empty_cache()


def phase_train(device, smi: str) -> dict:
    """Phase 11: training on the card (the module docstring); returns
    phase 11d's coremaint launches by counter."""
    import gc
    import shutil
    import tempfile

    import torch

    t11 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="phase11_", dir=ROOT / "build"))
    try:
        model, opt_state = phase_train_lm(device, smi)
        phase_train_ckpt(device, model, opt_state, work)
        del model, opt_state
        gc.collect()
        torch.cuda.empty_cache()
        phase_train_cpu(device)
        gc.collect()
        torch.cuda.empty_cache()
        counts = phase_train_gnn(device)
        torch.cuda.empty_cache()
        phase_train_cells(device)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"phase 11: {time.perf_counter() - t11:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# phase 12: the sharded paths (parallel/sharding.py, the pins, the dry-run)
# ---------------------------------------------------------------------------
def start_dryrun_child(out: Path):
    """Phase 12c's child, started first so it runs on the host's cores
    while 12a and 12b hold the card: ``python -m repro_torch.launch.dryrun
    --both-meshes --cells ...`` on fake 16x16 and 2x16x16 worlds of its
    own (no card, no real process group)."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--both-meshes", "--cells", ",".join(P12_CELLS), "--out",
           str(out)]
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def finish_dryrun_child(proc, out: Path, t_start: float) -> None:
    """Phase 12c: the child's exit code 0, then each cell's line: the
    matmul FLOPs x devices that ``model_flops`` explains (held to
    ``P12_RATIO``), wire bytes by collective kind, argument bytes a
    device and the dominant roofline term."""
    try:
        text, _ = proc.communicate(timeout=P12_DRYRUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        check(False, f"phase 12c: the dry-run child ran over "
              f"{P12_DRYRUN_TIMEOUT} s")
    if proc.returncode != 0:
        print(text[-6000:], file=sys.stderr)
    check(proc.returncode == 0,
          f"phase 12c: the dry-run child exited {proc.returncode}")
    results = json.loads(out.read_text())
    check(len(results) == 2 * len(P12_CELLS),
          f"phase 12c: {len(results)} results, not {2 * len(P12_CELLS)}")
    for r in results:
        key = (r["arch"], r["shape"])
        want = P12_RATIO[key][0 if r["mesh"] == "16x16" else 1]
        got = r["model_vs_hlo"] or 0.0
        coll = {k: v for k, v in r["collective_bytes"].items()
                if k != "op_counts" and v}
        log(f"phase 12c dry-run {r['arch']}:{r['shape']} on {r['mesh']}: "
            f"model_flops / (dot_flops x {r['n_devices']}) = {got:.6f} "
            f"(CPU {want}) dot_flops={r['dot_flops']:.6e} "
            f"collective_bytes={json.dumps(coll)} "
            f"ops={json.dumps(r['collective_bytes']['op_counts'])} "
            f"argument_bytes={r['mem']['argument_bytes']} "
            f"peak_bytes={r['mem']['peak_bytes']} "
            f"dominant={r['roofline']['dominant']} "
            f"t_compute_s={r['roofline']['t_compute_s']:.6e} "
            f"t_memory_s={r['roofline']['t_memory_s']:.6e} "
            f"t_collective_s={r['roofline']['t_collective_s']:.6e} "
            f"run_s={r['compile_s']}")
        check(r["dot_flops"] > 0, f"phase 12c {key}: no matmul counted")
        if want == 0.0:
            check(got == 0.0, f"phase 12c {key}: ratio {got}, want 0")
        else:
            check(abs(got / want - 1.0) <= 0.25,
                  f"phase 12c {key} {r['mesh']}: ratio {got} outside "
                  f"+-25% of the CPU's {want}")
    log(f"phase 12c: the dry-run child's {len(results)} cells in "
        f"{time.perf_counter() - t_start:.1f} s (beside 12a and 12b)")


def step_errors(tag, got, want, lr, g_min=1e-6, upd_tol=1e-2,
                m_tol=1e-3, rel=1e-5) -> None:
    """Two training steps' results ``(params, opt_state, metrics)`` from
    the same start (``got`` may hold DTensors): loss and grad norm within
    ``rel`` relative (1e-5; 1e-3 for the bfloat16 steps, whose atomics
    reorder), each first moment (0.1 x the clipped gradient) within
    ``m_tol`` relative L2, each parameter's update within ``upd_tol`` x
    ``lr`` where ``want``'s gradient is at least ``g_min`` and 2 ``lr``
    everywhere (tests/test_torch_steps.py's rule: AdamW's direction at a
    ~1e-8 gradient is its rounding)."""
    import torch

    def full(x):
        return x.full_tensor() if hasattr(x, "full_tensor") else x

    (pg, og, mg), (pw, ow, mw) = got, want
    loss_g, loss_w = float(full(mg["loss"])), float(mw["loss"])
    gn_g, gn_w = float(full(mg["grad_norm"])), float(mw["grad_norm"])
    check(abs(loss_g - loss_w) <= rel * abs(loss_w) + 1e-7,
          f"phase 12b {tag}: loss {loss_g} vs {loss_w}")
    check(abs(gn_g - gn_w) <= rel * abs(gn_w) + 1e-7,
          f"phase 12b {tag}: grad norm {gn_g} vs {gn_w}")
    worst_m = worst_u = 0.0
    params_w = dict(pw.named_parameters())
    for name, p in pg.named_parameters():
        m_g, m_w = full(og["m"][name]).float(), ow["m"][name].float()
        denom = float(m_w.norm()) or 1.0
        worst_m = max(worst_m, float((m_g - m_w).norm()) / denom)
        upd = (full(p).detach().float()
               - params_w[name].detach().float()).abs()
        big = (m_w / 0.1).abs() >= g_min
        if bool(big.any()):
            worst_u = max(worst_u, float(upd[big].max()) / lr)
        check(float(upd.max()) <= 2 * lr,
              f"phase 12b {tag}: {name} moved {float(upd.max())} apart")
    log(f"phase 12b {tag}: loss {loss_g:.8f} vs {loss_w:.8f}, grad norm "
        f"{gn_g:.6f} vs {gn_w:.6f}, moments worst relative L2 "
        f"{worst_m:.3e} (limit {m_tol}), updates worst {worst_u:.3e} lr "
        f"where |g| >= {g_min} (limit {upd_tol})")
    check(worst_m <= m_tol, f"phase 12b {tag}: moments {worst_m}")
    check(worst_u <= upd_tol, f"phase 12b {tag}: updates {worst_u} lr")


def phase_sharded_models(device) -> dict:
    """Phase 12 on a world of one NCCL rank (opened here when none is):

    (a) qwen2-7b ``full()`` (28 layers, bf16) prefill at 1 x 4,096 with
      its parameters placed by ``shard_params(lm_param_specs(cfg))`` as
      DTensors over a ``(1, 1)`` ``("data", "model")`` mesh, the config
      ``launch/steps.py``'s pinned one (``batch_axes="data"``,
      ``tp_axis="model"``, ``attn_chunk=2048``) on kernel h (each layer's
      attention a ``local_map`` region: one launch a layer a rank),
      tokens placed by ``lm_batch_spec``: 28 launches a prefill, the last
      logits and every layer's cache against the unsharded prefill of
      the same weights (before they were placed; relative L2 at most
      1e-3, bitwise equality reported), both timed (median of 5 CUDA
      events after a warm-up) with their peak memory;
    (b) ``build_cell("pna", "full_graph_sm")`` (pinned: ``shard_axes``
      over the mesh) and DimeNet ``molecule`` (pinned: ``shard_axes`` and
      ``msg_dtype=bfloat16``), one step each with their inputs placed by
      ``in_specs``: PNA against the same step built with
      ``REPRO_NO_PIN=1``; DimeNet against the unsharded bf16 step (both
      under deterministic scatters), and
      against the ``REPRO_NO_PIN`` float32 step within 2x the unsharded
      bf16 step's own distance to it (``step_errors``); then
      ``build_cell``'s qwen2-7b ``train_4k`` cell under ``multi_pod`` on
      a ``(1, 1, 1)`` ``("pod", "data", "model")`` mesh, cut to
      ``P12_TRAIN_LAYERS`` layers at ``P12_TRAIN_BATCH`` x 4,096 (256 x
      4,096 at 28 layers does not fit one card), one step against the
      same cell's step on plain tensors;
    (c) the dry-run child (``start_dryrun_child``), read last.

    Returns the sharded path's kernel launches by ``flash_attention``
    counter (the counts set to 0 after the unsharded prefills, read
    after the sharded ones)."""
    import dataclasses
    import os
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_arch, qwen2_7b
    from repro_torch.configs.common import ShapeCell
    from repro_torch.device import resolve_device
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.parallel import sharding as SH

    t12 = time.perf_counter()
    work = Path(tempfile.mkdtemp())
    child = start_dryrun_child(work / "dryrun.json")
    try:  # the child is stopped if 12a or 12b fails
        if not dist.is_initialized():
            start_world()
        mesh = make_mesh((1, 1), ("data", "model"))
        key = FA.launch_key(True, torch.bfloat16, 128)

        # ---- (a) the sharded qwen2-7b prefill on kernel h -----------------
        full = qwen2_7b.full()
        cfg = dataclasses.replace(full, batch_axes="data", tp_axis="model",
                                  attn_chunk=2048)
        t0 = time.perf_counter()
        model = T.init_params(
            full, torch.Generator(device=device).manual_seed(0),
            device=device)
        prompt = torch.from_numpy(np.random.default_rng(0).integers(
            0, full.vocab, (1, LM_PREFILL)).astype(np.int32)).to(device)
        sync(device)
        log(f"phase 12a qwen2-7b full(): init "
            f"{time.perf_counter() - t0:.1f} s")
        with torch.no_grad():
            last_u, cache_u = T.prefill(full, model, prompt, "cuda")
            ms_u, peak_u, _, _ = gnn_time(
                lambda: T.prefill(full, model, prompt, "cuda"))
            FA.reset_launches()  # from here on, the sharded path's launches
            SH.shard_params(model, SH.lm_param_specs(cfg), mesh)
            toks = SH.distribute(prompt, SH.lm_batch_spec(False), mesh)
            n0 = FA.LAUNCHES[key]
            last_s, cache_s = T.prefill(cfg, model, toks, "cuda")
            sync(device)
            check(FA.LAUNCHES[key] - n0 == cfg.n_layers,
                  f"phase 12a: {FA.LAUNCHES[key] - n0} kernel launches in the "
                  f"sharded prefill, not one a layer ({cfg.n_layers})")
            last_s = last_s.full_tensor()
            cache_s = {k: v.full_tensor() if hasattr(v, "full_tensor") else v
                       for k, v in cache_s.items()}
            errs = lm_errors(last_s, cache_s, last_u, cache_u)
            same = torch.equal(last_s, last_u) and all(
                torch.equal(cache_s[k], cache_u[k]) for k in ("k", "v"))
            log(f"phase 12a sharded vs unsharded prefill: relative L2 "
                f"(logits, then layers) max {max(errs):.3e} (limit 1e-3), bit "
                f"for bit {same}")
            check(max(errs) <= 1e-3, "phase 12a: sharded prefill != unsharded")
            del last_s, cache_s, last_u, cache_u
            ms_s, peak_s, _, _ = gnn_time(
                lambda: T.prefill(cfg, model, toks, "cuda"))
        log(f"phase 12a qwen2-7b prefill 1x{LM_PREFILL}: sharded wall_ms="
            f"{ms_s:.4f} peak_bytes={peak_s} beside unsharded wall_ms="
            f"{ms_u:.4f} peak_bytes={peak_u} (median of {SERVE_CALLS}); "
            f"{cfg.n_layers} launches a prefill")
        counts = {k: c for k, c in FA.LAUNCHES.items() if c}
        del model, toks
        torch.cuda.empty_cache()

        # ---- (b) sharded training steps ------------------------------------
        def run(prog, on_mesh):
            inputs = prog.concrete_inputs(0)
            if on_mesh is not None:
                inputs = SH.place(tuple(inputs), prog.in_specs, on_mesh)
            out = prog.fn(*inputs)
            sync(device)
            return out

        def no_pin(arch, shape):
            os.environ["REPRO_NO_PIN"] = "1"
            try:
                return ST.build_cell(arch, shape, device=device)
            finally:
                del os.environ["REPRO_NO_PIN"]

        t0 = time.perf_counter()
        # deterministic scatters (index_add_ sorts instead of adding
        # atomically), so that both sides of each comparison sum in one order
        # (PNA's ill-conditioned rows amplify the order's 1e-7 to 1e-3)
        torch.use_deterministic_algorithms(True, warn_only=True)
        pna = ST.build_cell("pna", "full_graph_sm", device=device)
        check(pna.abstract_inputs[0].cfg.shard_axes == ("data", "model"),
              "phase 12b: the full PNA cell is not pinned")
        step_errors("pna full_graph_sm sharded vs REPRO_NO_PIN",
                    run(pna, mesh), run(no_pin("pna", "full_graph_sm"), None),
                    1e-3)
        dev = resolve_device(device)
        dim_cell = next(c for c in get_arch("dimenet").SHAPES
                        if c.name == "molecule")
        dim = ST.build_cell("dimenet", "molecule", device=device)
        check(dim.abstract_inputs[0].cfg.msg_dtype == torch.bfloat16,
              "phase 12b: the full DimeNet cell is not pinned to bf16")
        sharded = run(dim, mesh)
        bf16 = run(ST._gnn_cell("dimenet", dataclasses.replace(
            get_arch("dimenet").full(), msg_dtype=torch.bfloat16), dim_cell,
            False, False, False, dev), None)
        f32 = run(no_pin("dimenet", "molecule"), None)
        step_errors("dimenet molecule (bf16) sharded vs unsharded bf16",
                    sharded, bf16, 1e-3, upd_tol=2.0, m_tol=5e-2, rel=1e-3)
        yard = abs(float(bf16[2]["loss"]) - float(f32[2]["loss"]))
        got = abs(float(sharded[2]["loss"].full_tensor())
                  - float(f32[2]["loss"]))
        log(f"phase 12b dimenet molecule: |loss - REPRO_NO_PIN float32 loss| "
            f"sharded bf16 {got:.6e}, unsharded bf16 {yard:.6e} (limit 2x + "
            f"1e-6)")
        check(got <= 2 * yard + 1e-6, "phase 12b dimenet: sharded bf16 loss "
              "farther from float32 than 2x the unsharded bf16's")
        del sharded, bf16, f32
        torch.use_deterministic_algorithms(False)
        log(f"phase 12b GNN steps {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        mesh3 = make_mesh((1, 1, 1), ("pod", "data", "model"))
        lm_cell = next(c for c in get_arch("qwen2-7b").SHAPES
                       if c.name == "train_4k")
        cut = ShapeCell(f"train_4k/cut{P12_TRAIN_BATCH}", lm_cell.kind, dict(
            lm_cell.params, batch=P12_TRAIN_BATCH))
        cut_cfg = dataclasses.replace(full, n_layers=P12_TRAIN_LAYERS)
        prog = ST._lm_cell("qwen2-7b", cut_cfg, cut, True, True, False, dev)
        check(prog.abstract_inputs[0].cfg.batch_axes == ("pod", "data"),
              "phase 12b: the multi_pod qwen2-7b cell is not pinned")
        torch.cuda.reset_peak_memory_stats()
        sharded = run(prog, mesh3)
        peak = torch.cuda.max_memory_allocated()
        step_errors(f"qwen2-7b train_4k multi_pod {P12_TRAIN_LAYERS} layers "
                    f"{P12_TRAIN_BATCH}x4096 sharded vs plain", sharded,
                    run(prog, None), 1e-4, upd_tol=2.0, m_tol=1e-2, rel=1e-3)
        log(f"phase 12b qwen2-7b multi_pod step: peak_bytes={peak} "
            f"({time.perf_counter() - t0:.1f} s)")
        del sharded
        torch.cuda.empty_cache()
    except BaseException:
        child.kill()
        child.communicate()
        raise

    finish_dryrun_child(child, work / "dryrun.json", t12)
    log(f"phase 12 launches={json.dumps(counts)}; every phase 12 check "
        f"passed in {time.perf_counter() - t12:.1f} s")
    return counts


def phase_deepfm(device) -> list:
    """DeepFM ``full()`` serving on the card with ``use_pallas_fm=True``
    at the recsys serve and retrieval cells, ids made as the reference's
    ``launch/steps.py::_recsys_cell`` makes them; logits held to the
    plain branch (rtol/atol 1e-4, TF32 off), retrieval scores to a
    float64 recomputation. Returns the kernels row of the FM kernel on
    ``serve_p99``'s embeddings (its launches are the
    ``fm_interaction[f32]`` counter's)."""
    import dataclasses

    import torch
    from repro_torch.configs import deepfm as deepfm_cfg
    from repro_torch.configs.common import RECSYS_SHAPES
    from repro_torch.kernels import fm_interaction as FM
    from repro_torch.models import recsys

    cfg = deepfm_cfg.full()
    cfg_fm = dataclasses.replace(cfg, use_pallas_fm=True)
    t0 = time.perf_counter()
    model = recsys.deepfm_init(
        cfg, torch.Generator(device=device).manual_seed(0))
    sync(device)
    log(f"phase 7a DeepFM full(): vocab_total={cfg.vocab_total} "
        f"embed_dim={cfg.embed_dim} mlp={cfg.mlp_dims} "
        f"n_params={cfg.n_params} init {time.perf_counter() - t0:.1f} s")
    rows = []
    for cell in RECSYS_SHAPES:
        if cell.kind not in ("serve", "retrieval"):
            continue  # DeepFM trains in phase 11e
        b = cell.params["batch"]
        rng = np.random.default_rng(0)
        ids = torch.from_numpy(rng.integers(
            0, cfg.rows_per_field, size=(b, cfg.n_sparse)).astype(
                np.int32)).to(device)
        with torch.no_grad():
            if cell.kind == "serve":
                before = FM.LAUNCHES["fm_interaction[f32]"]
                got = recsys.deepfm_forward(cfg_fm, model, ids)
                check(FM.LAUNCHES["fm_interaction[f32]"] == before + 1,
                      f"phase 7a {cell.name}: fm_interaction not launched")
                want = recsys.deepfm_forward(cfg, model, ids)
                check(got.shape == (b,) and got.dtype == torch.float32
                      and bool(torch.isfinite(got).all()),
                      f"phase 7a {cell.name}: logits shape/dtype/finite")
                err = float((got - want).abs().max())
                check(torch.allclose(got, want, rtol=1e-4, atol=1e-4),
                      f"phase 7a {cell.name}: use_pallas_fm logits differ "
                      f"from the plain branch by {err}")
                ms = wall_ms(lambda: recsys.deepfm_forward(cfg_fm, model,
                                                           ids),
                             SERVE_CALLS, device)
                ms_plain = wall_ms(lambda: recsys.deepfm_forward(
                    cfg, model, ids), SERVE_CALLS, device)
                _, emb = recsys._field_embeddings(cfg, model, ids)
                # the kernel timed alone is a measurement, not the path
                path_launches = dict(FM.LAUNCHES)
                fm_ms = time_ms(lambda: FM.fm_interaction(emb), ITERS,
                                device)
                if cell.name == "serve_p99":
                    rows.append(float_row(
                        f"fm_interaction[f32] {cell.name}", "fm_interaction",
                        FM.fm_interaction(emb), FM.fm_interaction_plain(emb),
                        (1e-4, 1e-4), lambda: FM.fm_interaction(emb),
                        lambda: FM.fm_interaction_plain(emb),
                        emb.element_size() * (emb.numel() + emb.shape[0]),
                        3 * emb.numel(), FP32_PEAK, ITERS, device,
                        f"emb={list(emb.shape)} {emb.dtype}",
                        phase="phase 7a"))
                    rows[-1]["counter"] = "fm_interaction[f32]"
                FM.LAUNCHES.update(path_launches)
                log(f"phase 7a {cell.name}: batch={b} logits max abs err "
                    f"to the plain branch {err} wall_ms={ms:.4f} "
                    f"(plain branch {ms_plain:.4f}) fm_kernel_ms="
                    f"{fm_ms:.4f} fm_share={fm_ms / ms:.4f}")
            else:
                nc = _pad512(cell.params["n_candidates"])
                cand = torch.from_numpy(rng.normal(
                    size=(nc, cfg.embed_dim)).astype(np.float32)).to(device)
                got = recsys.retrieval_score(cfg_fm, model, ids, cand)
                _, emb = recsys._field_embeddings(cfg, model, ids)
                want = emb.double().sum(1) @ cand.double().T
                err = float((got.double() - want).abs().max())
                check(got.shape == (b, nc) and bool(torch.isfinite(got).all())
                      and torch.allclose(got.double(), want, rtol=1e-4,
                                         atol=1e-4),
                      f"phase 7a {cell.name}: scores vs float64 ({err})")
                ms = wall_ms(lambda: recsys.retrieval_score(
                    cfg_fm, model, ids, cand), SERVE_CALLS, device)
                log(f"phase 7a {cell.name}: 1 query x {nc} candidates "
                    f"max abs err to float64 {err} wall_ms={ms:.4f}")
    del model
    return rows


def phase_api_on_core_state(device, me, nbrs, feats) -> None:
    """The kernel API on the ER graph's core-maintenance state:
    ``ell_stat`` ``count_ge`` / ``count_gt`` equal bit for bit to
    ``coo_stat``'s ``mcd`` / ``hi`` over the maintainer's slot window,
    ``mcd >= core`` everywhere, ``sum`` / ``max`` against the plain
    version, and ``ell_aggregate`` (float32 and bfloat16) as in phase
    6."""
    import torch
    from repro_torch.kernels import coremaint as K
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_ell as SE

    w = me._window(0)
    src, dst, valid = me.src[:w], me.dst[:w], me.valid[:w]
    core, n = me.core, me.n
    mcd = K.coo_stat(src, dst, valid, core, None, n, "mcd")[:, 0]
    hi = K.coo_stat(src, dst, valid, core, me.label, n, "mcd_hi_dout")[:, 1]
    ge = ops.ell_stat_op(nbrs, core, core, "count_ge")
    gt = ops.ell_stat_op(nbrs, core, core, "count_gt")
    check(torch.equal(ge, mcd), "phase 7b: ell_stat count_ge != coo_stat mcd")
    check(torch.equal(gt, hi), "phase 7b: ell_stat count_gt != coo_stat hi")
    check(bool((ge >= core).all()), "phase 7b: mcd < core somewhere")
    vals = stat_values(core)
    ge64 = ops.ell_stat_op(nbrs, vals["i64"], vals["i64"], "count_ge")
    check(torch.equal(ge64, mcd.long()),
          "phase 7b: ell_stat count_ge (int64) != coo_stat mcd")
    for op, tag in (("sum", "i32"), ("max", "i32"), ("sum", "i64"),
                    ("sum", "f32"), ("max", "f32")):
        v = vals[tag]
        check(torch.equal(ops.ell_stat_op(nbrs, v, v, op),
                          SE.ell_stat_plain(nbrs, v, v, op)),
              f"phase 7b: ell_stat {op} {tag} != plain")
    for dtype, tsum in ((torch.float32, (1e-5, 1e-5)),
                        (torch.bfloat16, (2e-2, 1e-2))):
        fe = feats.to(dtype)
        for op in ("sum", "max"):
            ok, err = close(ops.ell_aggregate_op(nbrs, fe, op),
                            SE.ell_aggregate_plain(nbrs, fe, op),
                            tsum if op == "sum" else (0, 0))
            check(ok, f"phase 7b: ell_aggregate {op} {dtype} differs from "
                  f"the plain version by {err}")
        del fe
    log(f"phase 7b: over the slot window (E={w}, n={n}) ell_stat count_ge "
        f"(int32, int64) == coo_stat mcd and count_gt == coo_stat hi bit "
        f"for bit, mcd >= core, sum/max (int32, float32), sum (int64) and "
        f"ell_aggregate sum/max (float32, bfloat16) == plain")


def start_audit_child():
    """Phase 13's ``python -m repro_torch.analysis.audit --engine
    unified,cuda,sharded --device cuda`` (a world of one NCCL rank of its
    own, at ``AuditParams``, against the committed manifests), started
    first so it runs beside the full-size runs; its JSON report goes to a
    file."""
    import os
    import tempfile
    out = Path(tempfile.mkdtemp()) / "audit.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.analysis.audit", "--engine",
         "unified,cuda,sharded", "--device", "cuda", "--out", str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    return proc, out


def p13_sync_warnings(records) -> int:
    """The ``torch.cuda`` sync-debug warnings among recorded warnings
    (one a synchronizing operation; the mode's own notice left out)."""
    return sum("synchronizing CUDA operation" in str(w.message)
               for w in records)


def p13_run(device, start, kb, ev, profile: bool) -> dict:
    """One maintainer from a copy of phase 4's starting state on
    ``kernel_backend=kb``, then phase 4's first mixed batch through
    ``apply_batch`` under the recorder: with ``profile``, counting each
    round's CUDA kernels (``torch.profiler``) and the loops' iterations,
    under ``torch.cuda``'s sync-debug mode (warn), the peak memory reset
    first; without, under the narrowing check (the dtype policy at full
    size, its flags read once after)."""
    import warnings
    import torch
    from repro_torch.analysis.rules import round_kernels
    from repro_torch.analysis.walker import RoundRecorder
    from repro_torch.core.api import CoreMaintainer
    from repro_torch.kernels import coremaint as K

    m = CoreMaintainer(
        n=start["n"], capacity=start["capacity"], src=start["src"].clone(),
        dst=start["dst"].clone(), valid=start["valid"].clone(),
        n_edges=start["n_edges"].clone(), core=start["core"].clone(),
        label=start["label"].clone(), n_levels=start["n_levels"],
        kernel_backend=kb)
    sync(device)
    out = dict(m=m)
    if not profile:
        with RoundRecorder(check_narrowing=True) as rec:
            st = m.apply_batch(insert_edges=ev.edges, remove_edges=ev.removals)
        sync(device)
        out.update(st=st, rec=rec)
        return out
    state_bytes = sum(t.numel() * t.element_size() for t in (
        m.src, m.dst, m.valid, m.n_edges, m.core, m.label))
    K.reset_launches()  # the counts of this run from 0
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    rec = RoundRecorder(profile_kernels=True)
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as wl:
        warnings.simplefilter("always")
        with rec:
            torch.cuda.set_sync_debug_mode("warn")
            try:
                st = m.apply_batch(insert_edges=ev.edges,
                                   remove_edges=ev.removals)
            finally:
                torch.cuda.set_sync_debug_mode(0)
    sync(device)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base + state_bytes
    out.update(st=st, rec=rec, wall=wall, peak=peak,
               warnings=p13_sync_warnings(wl),
               launches={k: c for k, c in K.LAUNCHES.items() if c},
               per_round=round_kernels(rec.sites))
    return out


def p13_check_syncs(kb, r, want, rm_rounds, ins_rounds) -> None:
    """Every sync of a phase 13 run is named in ``SYNC_SITES``; each loop
    condition syncs exactly once an iteration of its loop (rounds, waves
    and eviction rounds as the interpreter counted them), the fixpoints'
    iterations are the batch's rounds; ``core/api.py`` uploads the six
    lane arrays and syncs nowhere else; every other sync happens as often
    as the card's manifest counts it at ``AuditParams``; and the recorded
    syncs are exactly the sync-debug warnings."""
    from repro_torch.analysis.hostlint import sites_by_where
    from repro_torch.analysis.rules import LOOP_PERS, loop_sync_mismatches
    from repro_torch.analysis.walker import count_syncs

    named = sites_by_where()
    rec = r["rec"]
    got = count_syncs(rec.sites)
    it = {w: n for w, n in rec.iterations.items() if n}
    total = sum(sum(v.values()) for v in got.values())
    log(f"phase 13 {kb}: syncs {json.dumps(got)} total={total} "
        f"sync-debug warnings={r['warnings']}; loop iterations "
        f"{json.dumps(it)}")
    check(total == r["warnings"], f"phase 13 {kb}: {total} recorded syncs "
          f"but {r['warnings']} sync-debug warnings")
    check(it.get("core/remove.py::removal_fixpoint") == rm_rounds
          and it.get("core/insert.py::promotion_fixpoint") == ins_rounds,
          f"phase 13 {kb}: the fixpoints iterated {it} for {rm_rounds} "
          f"removal and {ins_rounds} promotion rounds")
    bad = loop_sync_mismatches(rec.sites, rec.iterations)
    check(not bad, f"phase 13 {kb}: {bad}")
    for kind, per in got.items():
        for where, cnt in per.items():
            entry = named.get((where, kind))
            check(entry is not None, f"phase 13 {kb}: an extra {kind} sync "
                  f"at {where} (no SYNC_SITES entry)")
            if kind == "round" and entry.per in LOOP_PERS:
                continue  # held to its loop's iterations above
            if where == "core/api.py::apply_batch":
                exp = P13_LANE_UPLOADS
            else:
                exp = want[kind].get(where)
            check(cnt == exp, f"phase 13 {kb}: {where} synced {cnt} times "
                  f"a batch, expected {exp}")


def phase_audit(device, start, stream) -> dict:
    """Phase 13: the auditor on the card at full size (the module
    docstring). Returns the cuda run's launches of the main path's kernels
    (the kernels line's ``audit_launches``)."""
    import torch
    from repro_torch.analysis.audit import load_budget
    from repro_torch.analysis.rules import eval_formula
    from repro_torch.analysis.walker import (RANGE_PREFIX, collectives,
                                             count_round_launches)
    from repro_torch.core.api import plan_window

    t_start = time.perf_counter()
    child, child_out = start_audit_child()
    ev = stream[0]
    runs = {kb: p13_run(device, start, kb, ev, profile=True)
            for kb in ("cuda", "torch")}
    a, b = runs["cuda"], runs["torch"]
    check(torch.equal(a["m"].core, b["m"].core)
          and torch.equal(a["m"].label, b["m"].label),
          "phase 13: cores or labels differ between the two backends")
    rm_rounds, ins_rounds = int(a["st"].remove_rounds), int(
        a["st"].insert_rounds)
    check((rm_rounds, ins_rounds) == (int(b["st"].remove_rounds),
                                       int(b["st"].insert_rounds)),
          "phase 13: round counts differ between the backends")
    # CUDA kernels round for round (a round: the ops between two of its
    # fixpoint's loop-condition syncs; rules.round_kernels, as the card
    # audit's launch_budget_twin counts them)
    check(set(a["per_round"]) == set(b["per_round"]),
          f"phase 13: the profiled rounds differ: {sorted(a['per_round'])} "
          f"vs {sorted(b['per_round'])}")
    for func, rounds in (("removal_fixpoint", rm_rounds),
                         ("promotion_fixpoint", ins_rounds)):
        pairs = []
        for k in range(rounds):
            key = f"{RANGE_PREFIX}{func}:{k}"
            check(key in a["per_round"], f"phase 13: no profiled {key}")
            na, nb = a["per_round"][key], b["per_round"][key]
            pairs.append((na, nb))
            check(na < nb, f"phase 13: {key}: cuda launches {na} kernels, "
                  f"not strictly fewer than torch's {nb}")
        ratios = [na / nb for na, nb in pairs]
        log(f"phase 13 {func}: CUDA kernels a round (cuda, torch) "
            f"{json.dumps(pairs)}; ratio {min(ratios):.4f}-"
            f"{max(ratios):.4f}")
        for k in range(min(rounds, 2)):  # the first two rounds by name
            key = f"{RANGE_PREFIX}{func}:{k}"
            for kb in ("cuda", "torch"):
                top = runs[kb]["rec"].kernel_names.get(key, {})
                log(f"phase 13 {key} {kb} kernels: " + json.dumps(
                    dict(sorted(top.items(), key=lambda x: -x[1])[:10])))
    ca = [(c.op, c.out_bytes) for c in collectives(a["rec"].sites)]
    cb = [(c.op, c.out_bytes) for c in collectives(b["rec"].sites)]
    check(ca == cb, f"phase 13: c10d schedules differ: {ca} vs {cb}")
    for kb, r in runs.items():
        seg: dict = {}
        for s in r["rec"].sites:
            if s.in_round:
                seg.setdefault(f"{s.round_func}:{s.round}", []).append(s)
        log(f"phase 13 {kb}: wall_s={r['wall']:.4f} remove_rounds="
            f"{rm_rounds} insert_rounds={ins_rounds} c10d={len(ca)} "
            f"launches={json.dumps(r['launches'])} launch-class ops of the "
            "first 4 segments (aten gather/scatter/sort, kernel calls): "
            + json.dumps({k: count_round_launches(v)
                          for k, v in list(seg.items())[:4]}))
    budget = load_budget("unified")
    want = budget["host_sync"].get("1x1@cuda", {}).get(
        "programs", {}).get("apply_batch")
    check(want is not None, "phase 13: the unified manifest has no "
          "'1x1@cuda' host_sync section (audit --write-budgets --device "
          "cuda)")
    for kb, r in runs.items():
        p13_check_syncs(kb, r, want, rm_rounds, ins_rounds)
    # the torch run's peak against the manifest's formula at this size
    m = b["m"]
    lanes = max(1 << max(len(ev.edges) - 1, 0).bit_length(),
                1 << max(len(ev.removals) - 1, 0).bit_length())
    hwm = int(start["valid"].nonzero().max()) + 1
    env = dict(n=m.n, d=1, d_e=1, d_v=1, cap=0, n_owned=m.n, n_pad=m.n,
               hcap=0, lanes=lanes, local_cap=m.capacity,
               window=plan_window(hwm, len(ev.edges), m.capacity))
    formula = budget["memory"]["1x1"]["programs"]["apply_batch"]["peak"]
    want_peak = eval_formula(formula, env)
    ratio = b["peak"] / want_peak
    log(f"phase 13 memory: torch peak {b['peak']} B, cuda peak {a['peak']}"
        f" B; the formula at n={m.n} capacity={m.capacity} window="
        f"{env['window']} lanes={lanes}: {want_peak} B; torch/formula "
        f"{ratio:.4f}")
    check(ratio <= P13_PEAK_MARGIN, f"phase 13: the torch peak is "
          f"{ratio:.4f}x the formula (> {P13_PEAK_MARGIN})")
    audit_launches = {k: a["launches"].get(k, 0) for k in MAIN_PATH_KERNELS}
    del runs, a, b, m
    # the dtype policy at full size: the narrowing check on fresh copies
    for kb in ("cuda", "torch"):
        r = p13_run(device, start, kb, ev, profile=False)
        n_copies = sum(s.op in ("_to_copy", "copy_") for s in r["rec"].sites)
        check(not r["rec"].narrowings, f"phase 13 {kb}: out-of-range "
              f"narrowings {r['rec'].narrowings[:3]}")
        log(f"phase 13 {kb}: dtype policy: no narrowing met a value outside "
            f"its type ({n_copies} copies checked)")
        del r
    torch.cuda.empty_cache()
    try:
        text = child.communicate(timeout=P13_AUDIT_TIMEOUT)[0]
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    tail = "\n".join(text.splitlines()[-15:])
    check(child.returncode == 0, f"phase 13: the card audit failed "
          f"(exit {child.returncode}):\n{tail}")
    report = json.loads(child_out.read_text())
    log("phase 13 audit --engine unified,cuda,sharded --device cuda: "
        + " ".join(f"{c['engine']}/{c['rule']}={c['status']}"
                   for c in report["checks"]))
    check(report["ok"], f"phase 13: the card audit found violations:\n{tail}")
    check(not report["not_run"], f"phase 13: checks not run on the card: "
          f"{report['not_run']}")
    log(f"phase 13: audit_launches={json.dumps(audit_launches)} "
        f"({time.perf_counter() - t_start:.1f} s)")
    return audit_launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.api import CoreMaintainer
    from repro_torch.graph.generators import rmat
    from repro_torch.graph.stream import mixed_stream
    from repro_torch.kernels import build as KB
    from repro_torch.kernels import coremaint as K

    device = "cuda"
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # phase 7a's tolerance
    # ---- phase 1 --------------------------------------------------------
    t0 = time.perf_counter()
    lib = KB.build()
    KB.library()
    log(f"phase 1 build: {lib.name} from {len(KB.sources())} sources in "
        f"{time.perf_counter() - t0:.1f} s")
    for fn, use in sorted(KB.ptxas_usage("").items()):
        log(f"phase 1 ptxas {fn}: {use}")
    smi = nvidia_smi_line()
    log(f"phase 1 card: {smi} | {torch.cuda.get_device_name(0)} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- phase 2 --------------------------------------------------------
    phase_small(device, SMALL_N, 5 * SMALL_N, SMALL_BATCHES, SMALL_BATCH,
                backend="cuda", yardstick="torch")
    phase_small_weighted(device, SMALL_N, 5 * SMALL_N, SMALL_BATCHES,
                         SMALL_BATCH, backend="cuda", yardstick="torch")

    # ---- phase 10: the LM stack, on a card nothing else holds ------------
    lm_counts, lm_row = phase_lm(device)
    torch.cuda.empty_cache()

    # ---- main path set-up (phase 3 runs on its state) --------------------
    t0 = time.perf_counter()
    g = rmat(SCALE, EDGES, seed=0)
    log(f"phase 4 graph: rmat({SCALE}, {EDGES}, seed=0) keeps "
        f"n={g.n} m={g.m} after build_csr ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    m = CoreMaintainer.from_graph(g, init="jax-peel", device=device)
    sync(device)
    log(f"phase 4 from_graph(init='jax-peel'): capacity={m.capacity} "
        f"window={m._window(BURST)} kmax={int(m.core.max())} "
        f"({time.perf_counter() - t0:.1f} s)")

    # ---- phase 3 --------------------------------------------------------
    rows = phase_kernels(device, m, ITERS)
    # ---- phase 14 -------------------------------------------------------
    order_row = phase_order(device, ITERS)
    w = m._window(0)
    snap = tuple(x.clone() for x in (m.src[:w], m.dst[:w], m.valid[:w],
                                     m.core, m.label))

    # ---- phase 4 --------------------------------------------------------
    start4 = start_state(m)  # phase 8 starts the sharded engine here
    rng = np.random.default_rng(0)
    pick = rng.choice(g.m, size=BURST, replace=False)
    t0 = time.perf_counter()
    stream = list(mixed_stream(g, MIXED_BATCHES, MIXED_SIZE, seed=0))
    log(f"phase 4 mixed_stream: {MIXED_BATCHES} batches of {MIXED_SIZE} "
        f"sampled in {time.perf_counter() - t0:.1f} s (host set-up)")
    launches, recorded, history = phase_main(
        device, m, g, g.edge_array()[pick], stream)
    phase_path_masks(device, snap, recorded, rows, ITERS)
    del snap, recorded
    phase_applications(m)
    seeds = gnn_seeds(m, GNN_SEEDS)  # phase 9's GraphSAGE seeds
    del m
    torch.cuda.empty_cache()

    # ---- phase 13: the auditor on the card, phase 4's batch ---------------
    audit_launches = phase_audit(device, start4, stream)
    order_row.update(launches=launches["place_levels"],
                     status="on the main path")
    for r in rows:
        r["launches"] = launches[r["name"]]
        # the unified engine fuses the mcd_hi_dout / hi_dout passes into
        # the fused wrappers; these stats serve other callers
        r["status"] = ("on the main path" if r["name"] in MAIN_PATH_KERNELS
                       else "ported, off the main path")
        if r["name"] in MAIN_PATH_KERNELS:
            r["audit_launches"] = audit_launches[r["name"]]

    # ---- phase 9: the GNN stack on the card -------------------------------
    phase_gnn(device, g, seeds)

    # ---- phase 11: training on the card -----------------------------------
    train_counts = phase_train(device, smi)

    # ---- phase 4b: the same batches on engine="host" ---------------------
    phase_host(device, g, g.edge_array()[pick], stream, history)

    # ---- weighted main path set-up (phase 3 runs on its state) ----------
    w0 = np.random.default_rng(1).integers(1, MAX_WEIGHT + 1, g.m)
    K.reset_launches()
    t0 = time.perf_counter()
    mw = CoreMaintainer.from_graph(g, device=device, weighted=True,
                                   weights=w0)
    sync(device)
    log(f"phase 5 from_graph(weighted=True, weights 1-{MAX_WEIGHT}): "
        f"capacity={mw.capacity} window={mw._window(BURST)} "
        f"kmax={int(mw.core.max())} wsum_launches="
        f"{K.LAUNCHES['coo_stat[wsum]']} ({time.perf_counter() - t0:.1f} s)")
    wrows = phase_kernels_weighted(device, mw, ITERS)

    # ---- phase 5 --------------------------------------------------------
    start5 = start_state(mw)
    wlaunches, whistory = phase_weighted(device, mw, g, w0, pick, stream)
    for r in wrows:
        r["launches"] = wlaunches[r["name"]]
        r["status"] = "on the weighted main path"
    rows += wrows
    del mw
    torch.cuda.empty_cache()

    # ---- phase 8: engine="sharded" on a world of one NCCL rank -----------
    start_world()
    kept = dict(start4=start4, history=history, start5=start5,
                whistory=whistory)
    del start4, history, start5, whistory
    phase_8(device, g.edge_array()[pick], stream, kept, rows)

    # ---- phase 12: the sharded paths, in phase 8's world ------------------
    sharded_counts = phase_sharded_models(device)
    torch.distributed.destroy_process_group()

    # ---- phases 6-7 set-up: the ER graph, its ELL matrix, its cores -----
    from repro_torch.graph.csr import ell_from_csr
    from repro_torch.graph.generators import erdos_renyi
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fm_interaction as FM
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_ell as SE

    t0 = time.perf_counter()
    ge = erdos_renyi(ER_N, ER_M, seed=0)
    ell = ell_from_csr(ge)
    log(f"phase 6 graph: erdos_renyi({ER_N}, {ER_M}, seed=0) keeps "
        f"m={ge.m}, ELL max_deg={ell.max_deg} "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    me = CoreMaintainer.from_graph(ge, init="jax-peel", device=device)
    nbrs = torch.from_numpy(ell.nbrs).to(device)
    del ell
    gen = torch.Generator(device=device).manual_seed(0)
    feats = torch.randn((ge.n, D_FEAT), generator=gen, device=device)
    emb = torch.randn((FM_BATCH, 39, 10), generator=gen, device=device)
    sync(device)
    log(f"phase 6 from_graph(init='jax-peel'): kmax={int(me.core.max())} "
        f"({time.perf_counter() - t0:.1f} s)")

    # ---- phase 6 --------------------------------------------------------
    t0 = time.perf_counter()
    new_rows = phase_ell_kernels(device, nbrs, me.core, feats, ITERS)
    new_rows += phase_fm_kernel(device, emb, ITERS)
    del emb
    attn_rows, attn_cases = phase_attention_kernel(device, ITERS)
    new_rows += attn_rows
    log(f"phase 6: {len(new_rows)} rows in {time.perf_counter() - t0:.1f} s")

    # ---- phase 7: the slice's path, launch counts from 0 -----------------
    for mod in (SE, FM, FA):
        mod.reset_launches()
    t0 = time.perf_counter()
    new_rows += phase_deepfm(device)
    phase_api_on_core_state(device, me, nbrs, feats)
    for name, (q, k, v, causal, want) in attn_cases.items():
        with torch.no_grad():
            got = ops.flash_attention_op(q, k, v, causal=causal)
        check(torch.equal(got, want),
              f"phase 7c: flash_attention_op != phase 6's {name} output")
        log(f"phase 7c: flash_attention_op at q={list(q.shape)} "
            f"kv={list(k.shape)} {name} == phase 6's output")
    del attn_cases
    new_launches = {**SE.LAUNCHES, **FM.LAUNCHES, **FA.LAUNCHES}
    log(f"phase 7 launches="
        f"{json.dumps({k: c for k, c in new_launches.items() if c})} "
        f"({time.perf_counter() - t0:.1f} s)")
    for r in new_rows:
        # every row is one kernel instance, and its name is its counter
        # (the serve_p99 FM row: the instance's counter)
        r["launches"] = new_launches[r.pop("counter", r["name"])]
        check(r["launches"] > 0,
              f"phase 7: kernel {r['name']} was never launched")
        r["status"] = "on the slice's path (phase 7)"
        if r["name"].startswith("flash_attention["):
            r["lm_launches"] = lm_counts.get(r["name"], 0)
            r["sharded_launches"] = sharded_counts.get(r["name"], 0)
    for r in rows:
        if r["name"] in MAIN_PATH_KERNELS:
            # launched inside phase 11d's training loop (counted from 0)
            r["train_launches"] = train_counts[r["name"]]
    lm_row["sharded_launches"] = sharded_counts.get(
        lm_row["name"].split(" ")[0], 0)  # the row of phase 10's counter
    rows += new_rows + [lm_row, order_row]

    log(f"smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
