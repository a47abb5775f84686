#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It needs a CUDA card and the CUDA toolkit (``nvcc``). Phases, each of
which makes the script exit non-zero when it fails:

  1. build   — compile every kernel from the checkout's sources, one
               ``nvcc`` per source, all at once (``sm_90a``; into
               ``build/kernels/``);
  2. kernels — each kernel against its plain PyTorch version on the card:
               ``hybrid_search`` bit for bit at the fig3a and scale shapes,
               on the edge cases of the tests (the grid ``HS_EDGE_*`` of
               ``hs_edge_case``: ties, pads, the full-block-all-less row,
               sentinel queries, both row sweeps) and repeatably;
               ``refresh_walk`` bit for bit (keys, idx, valid, steps per
               row) on ``refresh_case``'s crafted shard states, each of
               ``RW_RULES`` alone and all together, and at the main
               path's shape (``RW_CELL``), one launch a call; fig3a
               checks one launch a round; ``paged_attention`` at
               the reference's three test shapes in f32 and bf16 (atol
               2e-5 / 2e-2, rtol 2e-2) and the serving shape, plus the
               padding-page invariance, the edge cases of the tests
               (``seq_len`` 0, one page, past the table; lengths on split
               boundaries; ragged and one-page splits; S=64 with D=256;
               11, 16 and 32 query heads per KV head) and bitwise
               repeatability. Device times (``torch.profiler``, every
               device operation of a call) beside the bound, the
               wrapper's host time per call and, for ``paged_attention``,
               the nearest library call (gather + SDPA, timed only);
  3. fig3a   — the paper's single-machine configuration (Fig. 3a) as
               ``benchmarks/run.py`` runs it, YCSB r50 mix: 1 shard,
               Balancer, block probe on. The final key set must equal the
               sequential oracle's, and the protocol counts must equal the
               JAX reference's (recorded from a run of the reference with
               the same seeds and code path). The kernel's launch count
               shows the main path went through it, and the pre-pass's
               pointer walk must take ``FIG3A_WALK_STEPS`` steps (the
               lanes the kernel answers skip it). Then a second run
               under the per-phase timer (the round's breakdown);
  3a. fig3a_skip — fig3a's DiLi-against-skip-list rows: the skip list
               (``SKIP``: capacity 2**15, 14 levels, the load in one
               batch, the mix in batches of 64, its state on the card and
               each batch's serial pass over a host copy) at r10, r50 and
               r90, every result and the level-0 chain equal to the
               sequential oracle's and the digest of results and state to
               the reference's (``SKIPLIST_EXPECTED``); DiLi with the block
               probe at r10 against ``FIG3A_R10_EXPECTED``; ops/s of each
               and ``dili_over_skip_r{10,50}`` (r50's DiLi side is
               ``[fig3a]``'s run);
  4. client  — a few hundred ops through ``DiLiClient`` futures, each
               result equal to the oracle's;
  5. rebalance — ``benchmarks/run.py::rebalance`` part A: one Move of a
               125-key sublist between two servers at move_batch K = 1,
               4, 16, 32; the Move's rounds must equal the reference's
               (``REBALANCE_EXPECTED``) and the keys the inserted set;
  6. fig3b4  — fig3b's 4-server run (``benchmarks/run.py::fig3b``, block
               probe on, the balancer spreading sublists by Moves): the
               key set agrees with the ops' results
               (``check_against_results``), the protocol counts equal the
               reference's (``FIG3B4_EXPECTED``: rounds, hits, the batched
               replay's ``move_hits``, hops, keys per server), and
               ``hybrid_search`` launches on every server; the per-phase
               breakdown includes ``replay_prepass`` and ``bg_step``;
  6a. shardmap4 — the same run through the SPMD backend
               (``ShardMapBackend``: every server's round, its outbox
               bucketed by destination and the buckets exchanged on the
               card by a transpose): the counts equal the reference
               ``ShardMapBackend``'s (``SHARDMAP4_EXPECTED``: fig3b4's
               rounds, Move hits and keys, no fast-path lanes in its
               stats), ``check_against_results``, ``hybrid_search`` on
               every server; ops/s and ms per round beside fig3b4's,
               the ``bucket`` and ``exchange`` spans;
  6b. shardmap_faults — the SPMD backend's host-routed round under the
               lossy wire: the reference's N5 (``SHARDMAP_NEMESIS``) and
               its ShardMap crash schedule (``SHARDMAP_CRASH``, a WAL in
               a temporary directory), each against the sequential
               oracle with the reference's trace digest;
  6c. nemesis — the reference's B2 schedule (corpus entry mixed-p02 on
               two servers, key space 300, block probe) through the
               reliable transport over a lossy wire: every result and the
               key set equal the sequential oracle's, the round trace's
               digest equals the reference's (``NEMESIS_B2_DIGEST``), the
               probe answers lanes and ``hybrid_search`` runs on both
               servers;
  6d. crash  — corpus entry crash-during-move-copy with the block probe:
               server 1 is killed mid-Move and recovers from its WAL and
               snapshot (in a temporary directory) on the card; trace
               digest ``CRASH_DIGEST``, one recovery that replays rounds,
               the oracle; ms per recovery;
  6e. membership — ``SCALE_3_5_2`` (3 servers → 5 → 2 under traffic, no
               nemesis): trace digest with its ``mb`` lines
               (``MEMBERSHIP_DIGEST``) and the final active set;
  6f. nemesis4 — fig3b4's configuration, load and a ``NEMESIS4`` r50
               mix through ``DiLiClient`` over the lossy wire, with server
               1 crashed and recovered in the mix and the WAL in a
               temporary directory: the sequential oracle, one recovery,
               quiescence; rounds, ms per round and ops/s beside fig3b4's
               clean mix, transport counters, WAL bytes and fsync ms per
               round, recovery ms, the breakdown and launches per server;
  6g. zipf   — ``benchmarks/run.py::zipf`` at theta 0.99 (``ZIPF``: 4
               servers, the block probe, the balancer's hot-entry stage),
               read replication on and off, through ``DiLiClient``:
               rounds, the measured mix's ``rep_hits`` and the digest of
               every op's result equal the reference's
               (``ZIPF_EXPECTED``), the key set the sequential oracle's,
               replicas serve FINDs, ``hybrid_search`` launches on every
               server; ops/s on and off, their ratio, ms per round and
               the breakdown with the ``replica_serve`` and
               ``replica_step`` spans;
  6h. replica_nemesis — ``tests/test_replica.py``'s nemesis differential
               with replication forced on (``REPLICA_NEMESIS``): the
               windowed referee for replica-served FINDs, the exact
               oracle for the rest, the round trace's digest
               (``REPLICA_NEMESIS_DIGEST``) and replica hits;
  7. serving — Qwen2-0.5B at full width, f32, random weights from a fixed
               seed, through ``ServingEngine`` over a two-shard DiLi page
               index, as ``benchmarks/run.py::serving`` drives it (``SERVE``):
               static, rescan and range modes give identical greedy tokens,
               the index splits and moves between the shards live and the
               snapshot heals, and ``paged_attention`` launches once per
               layer per decode step; then a profiler window (busy share,
               device launches per decode step) and the kernel path
               against the gather path on 4 decode steps;
  7a. train — Qwen2-0.5B at full width, f32, random weights from a fixed
               seed, through the port's ``Trainer`` at ``launch/train.py``'s
               batch 4 x seq 256 (``TRAIN``): 8 steps on one batch, every
               loss finite, step 1's in the reference smoke test's band,
               the last below the first, and neither kernel launched; ms
               per step, tokens/s, peak memory and the device busy share
               (a profiler window); then at the qwen2_5_3b smoke config
               (``TRAIN_SMOKE``) the bitwise resume (killed after step 8,
               resumed from step 5's checkpoint, equal to the
               uninterrupted run bit for bit, under
               ``torch.use_deterministic_algorithms``) and step 1's loss
               on ``numpy_params`` weights against the reference's
               (``TRAIN_SMOKE_LOSS``, rtol 1e-4);
  7b. families — every other family the reference supports, at its
               published widths, f32, random weights from a fixed seed
               (``FAMILIES``): granite-moe-3b-a800m (moe),
               falcon-mamba-7b (ssm), zamba2-7b (hybrid),
               llava-next-mistral-7b (vision stub) and musicgen-medium
               (audio stub). Each serves at full depth (a batch of 2
               prompts of 128 positions, 4 teacher-forced decode steps,
               the first within ``tf_rtol`` of a full prefill's logits)
               and trains at a cut depth through the ``Trainer`` (4 steps
               of 2 x 256 on one batch: losses finite, the last below the
               first). Qwen2-0.5B's int8 KV cache (``KV_QUANT``): its
               bytes (D + 2) / 4D of the f32 cache's, decode logits within
               5% of the f32 cache's largest. Each family's smoke-config
               step-1 loss equals the reference's (``FAMILIES_SMOKE_LOSS``,
               rtol 1e-4), granite's smoke config resumes bit for bit, and
               neither kernel launches. ms per train step, tokens/s, peak
               memory, device launches per step, ms per decode step;
  7c. dryrun — (a) Qwen2-0.5B at full width, f32, ``TRAIN``'s batch,
               ``MESH_STEPS`` steps through ``build_train_step(mesh=
               make_host_mesh())`` on a one-card NCCL group: its losses
               equal the no-mesh step's (``MESH_RTOL``) from the same seed
               and weights, every weight a DTensor after the first step,
               neither kernel launched; ms per step beside ``[train]``'s
               and the model flops' share of the f32 peak. (b) the
               production dry-run (``python -m repro_torch.launch.dryrun``
               per cell of ``DRYRUN_CELLS``, a fake process group of 256 or
               512 ranks in a subprocess of its own, started after the
               build and run beside the other phases): every cell ends
               with finite per-device flops, bytes, collective bytes,
               roofline terms and MFU bound, dili-service with
               ``DRYRUN_A2A`` all-to-all bytes per device;
  8. scale   — the paper's capacities (2**21 pool nodes, 16384 registry
               entries) with ``SCALE_KEYS`` loaded keys and as many r50
               ops, checked against the oracle; then a window of rounds
               under the per-phase timer. Both DiLi phases log the walk's
               steps and its milliseconds per step;
  9. scale4  — four servers at those capacities each, ``SCALE4_KEYS``
               keys and as many r50 ops: the key set agrees with the
               ops' results, owned keys
               within 1.25x of the mean after the settle, a Move into each
               of servers 1-3; the breakdown.

The last lines are one JSON object per kernel (``{"kernels": [...]}``),
the card's name and power limit, and ``{"ok": true, "device": ...}``.
The script imports nothing of JAX or of the reference package.
"""
from __future__ import annotations

import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# fig3a r50 with the block probe, as the JAX reference gives it with the
# same config, seeds and driver; tests/test_torch_fig3a.py recomputes these
# from the reference and from the port on the CPU
FIG3A_EXPECTED = dict(rounds=107, load_rounds=34, settle_rounds=44,
                      fast_hits=1865, mut_hits=3228, blk_hits=4235,
                      sublists=29, keys=2218)

# fig3a r10 (the write-intensive mix, mixed_phase(4000, 8000, 0.1, seed=2))
# with the block probe, as the JAX reference gives it; recomputed by
# tests/test_torch_fig3a.py like FIG3A_EXPECTED
FIG3A_R10_EXPECTED = dict(rounds=107, load_rounds=34, settle_rounds=44,
                          fast_hits=366, mut_hits=4513, blk_hits=4006,
                          sublists=29, keys=2319)

# the skip-list baseline of benchmarks/run.py::fig3a: capacity, tower
# levels and the mix's batch (the load goes in one batch)
SKIP = dict(capacity=1 << 15, levels=14, batch=64)

# skiplist_digest of each mix's run (load and mix results, final state), as
# the JAX reference gives it; tests/test_torch_skiplist.py recomputes these
# from the reference and from the port on the CPU
SKIPLIST_EXPECTED = {
    10: "5121cfff7a2edc321fb15a4154fe9c6688a5c00bfda3ed212f25da0244a5cf31",
    50: "2e31e43f19bb8ba53c38ab732ca7d71520edc6e65cea6f29a5b0567c17d43eb3",
    90: "e16846bdc24cf43d81d17287842b33ad6fdd5d9ae4e7df873b4b3cde9758f912"}

# the training phase: Qwen2-0.5B at full width through the port's Trainer,
# launch/train.py's batch and sequence, one batch memorized for `steps`
# steps at a learning rate that makes the loss fall, then `timed` steps
# under the host clock and `profiled` under the profiler
TRAIN = dict(arch="qwen2_0_5b", batch=4, seq=256, steps=8, lr=1e-3,
             warmup=2, seed=0, timed=3, profiled=3)

# [dryrun]: TRAIN's model and batch for MESH_STEPS steps through the mesh
# path on a one-card NCCL group, losses within MESH_RTOL of the no-mesh
# step's; and the production dry-run's cells (arch, shape, multi_pod), each
# a `python -m repro_torch.launch.dryrun` subprocess started after the
# build and run one after another beside the other phases. dili-service's
# all-to-all bytes per device on 16x16 are the reference's own dry-run's
# (256 shards x cap_pair 4 x 15 fields x 4 bytes; tests/test_torch_dryrun.py)
MESH_STEPS = 2
MESH_RTOL = 1e-6
DRYRUN_CELLS = (("qwen2_72b", "train_4k", False),
                ("granite_moe_3b_a800m", "prefill_32k", False),
                ("falcon_mamba_7b", "decode_32k", False),
                ("zamba2_7b", "train_4k", True),
                ("dili-service", None, False))
DRYRUN_A2A = 61440
DRYRUN_KEYS = ("flops_per_device", "bytes_per_device",
               "collective_bytes_per_device", "roofline_mfu_bound")
DRYRUN_TIMEOUT = 900

# the training checks at the qwen2_5_3b smoke config (tests/
# test_substrates.py's cell and bitwise-resume schedule): weights drawn by
# numpy from `weights_seed` (convert.numpy_params), data seed 7;
# TRAIN_SMOKE_LOSS
# is the reference's step-1 loss on them, recomputed by
# tests/test_torch_trainer.py
TRAIN_SMOKE = dict(arch="qwen2_5_3b", seq=128, batch=2, data_seed=7,
                   weights_seed=11, init_seed=3, total=12, ckpt_every=5,
                   fail_at=8, lr=1e-3, warmup=2, schedule=30)
TRAIN_SMOKE_LOSS = 5.962843894958496

# the [families] phase: every non-dense family at its published widths,
# f32, random weights from `seed`. Serving at full depth: a batch of
# `serve_batch` prompts of `prompt` tokens (vision: half patch
# embeddings; audio: frame embeddings), then `decode` decode steps fed a
# fixed continuation (teacher forcing), the first checked against a full
# prefill of prompt + 1 tokens within `tf_rtol` of its largest logit
# (MoE at capacity factor n_experts / top_k there, so that neither run
# drops a token). Training at `train_layers` layers (the depth cut):
# `train_steps` Trainer steps on one batch of `train_batch` x
# `train_seq` at `lr`
FAMILIES = dict(
    archs={"granite_moe_3b_a800m": 8, "falcon_mamba_7b": 4,
           "zamba2_7b": 7, "llava_next_mistral_7b": 2,
           "musicgen_medium": 8},
    seed=0, serve_batch=2, prompt=128, decode=4, tf_rtol=1e-3,
    train_batch=2, train_seq=256, train_steps=4, lr=1e-3)

# the int8 KV cache at Qwen2-0.5B's full depth: prefill `prompt`, then
# `decode` teacher-forced steps with the int8 and the f32 cache; each
# step's logits within `rel` of the f32 cache's largest logit magnitude
KV_QUANT = dict(arch="qwen2_0_5b", prompt=128, decode=8, rel=0.05)

# step-1 loss of each family's smoke config on convert.numpy_params
# weights (seed `weights_seed`) and data seed `data_seed`, as the
# reference gives it; tests/test_torch_{moe,ssm,hybrid,modalities}.py
# recompute it. The reference's vision-stub loss is `batch` times the
# mean over the text tokens (ROADMAP Queue 3 item 7): its constant here
# is the reference's divided by `batch`, the port's loss
FAMILIES_SMOKE = dict(seq=128, batch=2, data_seed=7, weights_seed=11)
FAMILIES_SMOKE_LOSS = {"granite_moe_3b_a800m": 6.028960704803467,
                       "qwen3_moe_235b_a22b": 6.041755199432373,
                       "falcon_mamba_7b": 5.886418342590332,
                       "zamba2_7b": 6.076806545257568,
                       "llava_next_mistral_7b": 12.327347755432129 / 2,
                       "musicgen_medium": 4.667186260223389}

# the family whose smoke config repeats [train]'s bitwise resume
FAMILIES_RESUME = "granite_moe_3b_a800m"

# steps of the pre-pass's pointer walk (traverse.probe_batch.steps) over
# the port's fig3a run, load + settle + mix: the lanes the hybrid_search
# kernel answers skip the walk. Computed on the CPU by
# tests/test_torch_fig3a.py; with every lane walking it was 10,559
FIG3A_WALK_STEPS = 5287

# fig3b's 4-server run (benchmarks/run.py::fig3b with the block probe,
# load_phase(1500, 6000, seed=3), mixed_phase(12000, 6000, 0.5, seed=4)),
# as the JAX reference gives it: rounds of the load, the settle and the
# mix, the hit counters, the deepest delegation and the keys each server
# owns at the end. tests/test_torch_fig3b.py recomputes these from the
# reference and from the port on the CPU
FIG3B4_EXPECTED = dict(load_rounds=8, settle_rounds=120, mix_rounds=49,
                       fast_hits=662, mut_hits=704, blk_hits=1278,
                       move_hits=1327, max_hops=2, owned=[517, 554, 544, 303])

# the same run through the SPMD backend (ShardMapBackend, the routed
# round with the Local exchange), as the reference's ShardMapBackend gives
# it: the rounds, Move hits and keys of FIG3B4_EXPECTED, and fast_hits =
# mut_hits = 0, since the SPMD round's stats lanes carry no fast-path
# counts. tests/test_torch_shardmap_fig3b.py recomputes it
SHARDMAP4_EXPECTED = dict(FIG3B4_EXPECTED, fast_hits=0, mut_hits=0)

# benchmarks/run.py::rebalance part A: rounds to move one 125-key sublist
# between two servers at move_batch K, as the reference gives them
# (tests/test_torch_fig3b.py recomputes them)
REBALANCE_EXPECTED = {1: 138, 4: 45, 16: 21, 32: 17}

# Keys loaded (and r50 ops) in the 4-server scale phase, at the paper's
# capacities per server: 2**11. With 2**12, and the one-server scale
# phase at 2**15 keys, the whole script took 1020 s of its 1200 s limit
# on a slow H100 host (PERF.md, "Cells")
SCALE4_KEYS = 1 << 11

# Keys loaded (and r50 ops) in the scale phase: a quarter of the 2**16
# the capacities were sized for. With 2**16 the whole script once took
# 1120 s of its 1200 s limit on one H100 host, the round being
# host-bound, and 2**15 was cut too when the 4-server phases came in
# (PERF.md, "Cells")
SCALE_KEYS = 1 << 14

# rounds of the scale phase's window under the per-phase timer
SCALE_TIMED_ROUNDS = 32

# the nemesis corpus entries (tests/nemesis_corpus.json) the [nemesis] and
# [crash] phases replay; tests/test_torch_nemesis_replay.py holds them
# equal to the corpus
CORPUS = {
    "mixed-p02": dict(seed=101, n_ops=320, config=dict(
        drop_prob=0.2, dup_prob=0.2, reorder_prob=0.2, delay_prob=0.1,
        delay_rounds=3)),
    "crash-during-move-copy": dict(seed=707, n_ops=280, config=dict(
        drop_prob=0.05, dup_prob=0.05, reorder_prob=0.05,
        crashes=[[1, 36, 70]])),
}

# round-trace digests (core.net.trace_digest) of three schedules, as the
# JAX reference gives them: the reference's B2 run (tests/
# test_block_probe.py: mixed-p02 on 2 servers, key space 300, block
# probe), crash-during-move-copy with the block probe, and SCALE_3_5_2
# (seed 11, 200 ops, no nemesis, trace on). tests/test_torch_nemesis_
# replay.py, test_torch_durability_crash.py and test_torch_membership.py
# recompute them from the reference and from the port on the CPU
NEMESIS_B2_DIGEST = \
    "c701747a083aaff238213813126c816301484d7a70f0e6ec135c1ce74d7519d4"
CRASH_DIGEST = \
    "a19ae5613a6be8178ab666b3af9d5598ffe33b0cb5628e06ea88880f6518da37"
MEMBERSHIP_DIGEST = \
    "06b395377997b04ad7847781dd52d4d1c25bc3aef06951c57c9e9556b82d46fd"
MEMBERSHIP_ACTIVE = [0, 1]

# the [shardmap_faults] schedules, on the SPMD backend's host-routed
# round at the harness's shardmap size: the reference's N5
# (tests/test_nemesis.py, seed 11, 200 ops, default_nemesis(0.15)) and
# its ShardMap crash differential (tests/test_durability.py, seed 31, 150
# ops, server 1 down from round 40 to 80). The digests are their round
# traces' as the reference's ShardMapBackend gives them
# (tests/test_torch_shardmap_faults.py recomputes both)
SHARDMAP_NEMESIS = dict(seed=11, n_ops=200, config=dict(
    drop_prob=0.15, dup_prob=0.15, reorder_prob=0.15, delay_prob=0.075,
    delay_rounds=3))
SHARDMAP_CRASH = dict(seed=31, n_ops=150, config=dict(
    drop_prob=0.05, dup_prob=0.05, reorder_prob=0.05,
    crashes=[[1, 40, 80]]))
SHARDMAP_NEMESIS_DIGEST = \
    "e9f0e5545e830f45376eca498551f1d8310b35c8bb7ba3fd41fa65f8bd3b84de"
SHARDMAP_CRASH_DIGEST = \
    "13f4355126ea02e803b72e609598eb316cbbe805506e3a9463657c7eee8d0062"

# the [nemesis4] run: fig3b4's configuration and load (1,500 keys over
# 6,000, seed 3), then mix_ops r50 ops (seed 4), under the wire faults of
# corpus entry mixed-p015-range, with server crash_shard down for `down`
# rounds from crash_after rounds into the mix. The load ends at round
# mix_start, on the card as on the CPU (the run is deterministic); the
# crash plan is fixed before the run, so the phase fails if the load ends
# at another round
NEMESIS4 = dict(faults=dict(drop_prob=0.15, dup_prob=0.15, reorder_prob=0.15,
                            delay_prob=0.075, delay_rounds=3),
                mix_ops=1000, crash_shard=1, crash_after=20, down=30,
                mix_start=287)

# benchmarks/run.py::zipf at theta 0.99: 4 servers (pool 2**15, 256
# entries, batch 32, block probe), replication on or off, the Balancer
# with hot_rate 6, cold_rate 1, hot_share 0.45, replica_fanout 3; load
# n_load keys over key_space (seed 12), settle, a warm mix of n_ops at 90%
# reads (seed 13), then the measured read-only mix of n_ops (seed 14),
# all through DiLiClient in batches of `batch` per server per round
ZIPF = dict(theta=0.99, n_load=1000, n_ops=4000, key_space=4000, batch=32)

# what the JAX reference gives for ZIPF, replication on and off: rounds of
# load + settle, of the warm mix and of the measured mix, FINDs served by
# replicas in the measured mix, and the sha256 of every op's result in
# submission order (int32). tests/test_torch_zipf{,_off}.py recompute
# them from the reference (benchmarks/run.py's driver) and from the port
# on the CPU
ZIPF_EXPECTED = {
    "on": dict(setup_rounds=100, warm_rounds=82, rounds=33, rep_hits=2333,
               results="cca3f4e6a0f48138c34f2c106df58c0c"
                       "40127d504b9f887a9e80dfcffd24e248"),
    "off": dict(setup_rounds=100, warm_rounds=107, rounds=105, rep_hits=0,
                results="dadedf22d095d641dcf68c2bb623bbb015cc91790f"
                        "302cf939a085f371a54803"),
}

# tests/test_replica.py::test_differential_nemesis_with_replication: seed
# 47, 400 ops, default_nemesis(0.10), replication forced on (REP_OVERRIDES)
# and a balancer that replicates whatever the workload touches (REP_BAL);
# REPLICA_NEMESIS_DIGEST is its round-trace digest as the reference gives
# it (tests/test_torch_replica_nemesis.py recomputes it)
REPLICA_NEMESIS = dict(seed=47, n_ops=400, faults=dict(
    drop_prob=0.1, dup_prob=0.1, reorder_prob=0.1, delay_prob=0.05,
    delay_rounds=3))
REP_OVERRIDES = dict(replication=True, replica_sessions=4, replica_slots=8,
                     replica_batch=8, replica_refresh_rounds=4,
                     replica_staleness_rounds=32)
REP_BAL = dict(hot_rate=1.0, hot_share=0.0, cold_rate=0.0,
               replica_fanout=2)
REPLICA_NEMESIS_DIGEST = \
    "724dab1e035e3b63d1dad972aae3ae4df3f34a53bc34411521f2d9e574e936a7"

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, the CUDA-core f32
# rate (also the nearest table entry for int32 compares) and the bf16
# tensor-core rate
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

# the kernels of the port's paths, each built from csrc/<name>.cu
KERNELS = ("hybrid_search", "refresh_walk", "paged_attention")

# hybrid_search's edge grid (hs_edge_case), also the gpu tests': registry
# sizes around the 32-ary search's steps, row widths on both sweeps (C %
# 4 != 0 takes the scalar one), batch sizes around a warp and a block
HS_EDGE_M = (1, 2, 31, 32, 33, 1025, 16384)
HS_EDGE_C = (1, 3, 31, 32, 33, 160, 161)
HS_EDGE_B = (1, 31, 128, 4096)

# refresh_walk's ending rules (refresh_case): how a dirty row's walk ends.
# The rules of RW_VALID leave the row valid ("subtail_moving": the
# registered SubTail reached, itself moving, validates as in the
# reference). Also the gpu tests' and the CPU differential test's cases
RW_RULES = ("subtail", "tombstones", "subhead", "subtail_moving", "foreign",
            "null", "moving", "switched", "marked_subtail", "other_subtail",
            "overflow", "max_scan")
RW_VALID = ("subtail", "tombstones", "subhead", "subtail_moving")
# the main path's shape (dili_1srv: registry, block, pool and counter
# sizes; ~190 dirty rows a round), with a bound on the walk that the
# plain version, one host read a step, reaches in well under a second
RW_CELL = dict(m=16384, c=160, n=1 << 21, nc=16384, max_scan=256,
               dirty=190 / 14336)

# the serving phase (benchmarks/run.py::serving at the full width of
# Qwen2-0.5B, two DiLi shards): live requests, their prompt lengths and
# new tokens, parked sequences padding the page index, timed decode steps
# and the rebalance period
SERVE = dict(live=8, prompt_lo=256, prompt_hi=512, max_new=32, idle=32,
             page_size=16, steps=24, rebalance_every=4, seed=0)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ helpers

def time_cuda(fn, iters: int = 200, reps: int = 7) -> float:
    """Median over ``reps`` of the mean per-call time (ms) of ``iters``
    back-to-back calls, between two CUDA events. For a call whose host
    side outlasts its device work this is the host's issue rate."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / iters)
    return statistics.median(out)


def _device_events(prof):
    """``key_averages()`` rows that ran on the card (kernels, copies), not
    the host ops that launched them."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


def device_ms(fn, iters: int = 100, name: str | None = None,
              traces: int = 3) -> float:
    """Device time (ms) per call of ``fn``: the summed duration of the
    device operations it ran (or of those whose name holds ``name``) in a
    ``torch.profiler`` trace of ``iters`` calls. A trace can lose events
    (one smoke run on an H100 lost all of one trace and most of another),
    so ``traces`` traces are taken, those with fewer events than the
    fullest are dropped, and the median of the rest is returned."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in _device_events(prof)
              if name is None or name in e.key]
        runs.append((sum(e.count for e in ev),
                     sum(e.self_device_time_total for e in ev)))
    full = max(n for n, _ in runs)
    kept = sorted(t for n, t in runs if n == full)
    us = kept[(len(kept) - 1) // 2]
    if full == 0 or us <= 0:
        fail(f"the profiler saw no device time for {name or 'the call'} "
             f"in {traces} traces")
    if any(n < full for n, _ in runs):
        log(f"[profile] {sum(n < full for n, _ in runs)} of {traces} "
            f"traces of {name or 'a call'} lost device events")
    return us / 1e3 / iters


def drive_backend(backend, kinds, keys, batch, *, balancer=None,
                  max_drain=4000, log=None):
    """``benchmarks/run.py::_drive_backend``: feed ops round-robin at the
    raw backend surface, balancer every 4th round, then drain. With a
    list ``log``, every op's (kind, key, result) is appended to it as it
    completes."""
    n = len(kinds)
    pending = i = r = 0
    issued = {}

    def step():
        comps = backend.step()
        if log is not None:
            for op_id, val, _ in comps:
                log.append(issued.pop(op_id) + (int(val),))
        return len(comps)

    while i < n:
        for s in range(backend.n):
            j = min(i + batch, n)
            if i < j:
                ids = backend.submit(s, kinds[i:j].tolist(),
                                     keys[i:j].tolist())
                issued.update(zip(ids, zip(kinds[i:j].tolist(),
                                           keys[i:j].tolist())))
                pending += j - i
                i = j
        pending -= step()
        if balancer is not None and r % 4 == 3:
            balancer.step()
        r += 1
    for _ in range(max_drain):
        if pending == 0 and backend.quiescent():
            return
        pending -= step()
    fail(f"backend did not drain: pending={pending}")


def check_against_results(what: str, log, got_keys) -> None:
    """Servers fed in the same round race on a shared key, so a
    multi-server run has no single sequential oracle (the reference's
    fig3b4 run ends with 1,918 keys, the sequential order with 1,920).
    What must hold in any order: every result is 0 or 1; on every key the
    successful INSERTs and REMOVEs alternate from absent, so their count
    difference is 0 or 1; and the final key set is the set of keys where
    it is 1."""
    from repro_torch.core.types import OP_INSERT, OP_REMOVE
    bad = [x for x in log if x[2] not in (0, 1)]
    check(not bad, f"{what}: error results {bad[:5]}")
    net = {}
    for kind, key, val in log:
        if val and kind in (OP_INSERT, OP_REMOVE):
            net[key] = net.get(key, 0) + (1 if kind == OP_INSERT else -1)
    bad = [k for k, v in net.items() if v not in (0, 1)]
    check(not bad, f"{what}: keys {bad[:5]} were inserted or removed "
                   f"twice without the other in between")
    want = sorted(k for k, v in net.items() if v == 1)
    check(got_keys == want, f"{what}: the final key set ({len(got_keys)}) "
                            f"differs from the ops' results ({len(want)})")


def settle(backend, balancer, max_passes: int = 200) -> None:
    """``benchmarks/run.py::_settle``."""
    import numpy as np
    for _ in range(max_passes):
        if not any(balancer.step().values()):
            return
        drive_backend(backend, np.zeros(0, np.int64), np.zeros(0, np.int64),
                      64)


def bench_cfg(**kw):
    """``benchmarks/run.py::_bench_cfg(1, block_probe=True)``."""
    from repro_torch.core.types import DiLiConfig
    base = dict(num_shards=1, pool_capacity=1 << 15, max_sublists=256,
                max_ctrs=256, max_scan=1 << 15, batch_size=64,
                mailbox_cap=512, split_threshold=125, move_batch=32,
                find_fastpath=True, mut_fastpath=True, block_probe=True)
    base.update(kw)
    return DiLiConfig(**base)


def breakdown(timer, rounds: int) -> dict:
    """Per-round milliseconds of each timed phase."""
    return {k: round(1e3 * v / max(rounds, 1), 4)
            for k, v in sorted(timer.seconds.items())}


def walk_ms_per_step(timer, steps: int, rounds: int) -> str:
    """The pointer walk's timed milliseconds per walk step, with the steps
    behind them (the walk's calls also cost time when they take no
    step)."""
    ms = 1e3 * timer.seconds.get("probe_batch", 0.0)
    return (f"{ms / max(steps, 1):.4f} ms per walk step ({steps} steps, "
            f"{steps / max(rounds, 1):.2f} per round, "
            f"{timer.calls.get('probe_batch', 0)} calls)")


def owned_keys(backend) -> list:
    """Keys each server owns, from its own registry replica."""
    return [sum(e["size"] or 0 for e in backend.sublists(s)
                if e["owner"] == s) for s in range(backend.n)]


def fig3b4_workload():
    """``benchmarks/run.py::fig3b``'s load and its 4-server mix."""
    from repro_torch.data.ycsb import load_phase, mixed_phase
    return (load_phase(1500, 6000, seed=3),
            mixed_phase(3000 * 4, 6000, 0.5, seed=4))


def fig3b4_counts(backend, load_end: int, settle_end: int) -> dict:
    """The protocol counts ``FIG3B4_EXPECTED`` holds, from a backend that
    ran the load (ending at round ``load_end``), the settle (ending at
    ``settle_end``) and the mix."""
    st = backend.stats
    return dict(load_rounds=load_end, settle_rounds=settle_end - load_end,
                mix_rounds=st["rounds"] - settle_end,
                fast_hits=st["fast_hits"], mut_hits=st["mut_hits"],
                blk_hits=st["blk_hits"], move_hits=st["move_hits"],
                max_hops=st["max_hops"], owned=owned_keys(backend))


def rebalance_move(cluster_cls, cfg_cls, op_insert: int, k: int,
                   sync=lambda: None, **extra) -> dict:
    """``benchmarks/run.py::rebalance`` part A at ``move_batch`` k: two
    servers, 125 keys on server 0, then one Move of its sublist to
    server 1, run until quiet. Returns the Move's rounds, its seconds
    (``sync`` is called before each clock read) and the cluster."""
    cfg = cfg_cls(num_shards=2, pool_capacity=4096, max_sublists=32,
                  max_ctrs=32, max_scan=4096, batch_size=32,
                  mailbox_cap=256, move_batch=k)
    cl = cluster_cls(cfg, **extra)
    keys = list(range(10, 10 + 125 * 7, 7))
    cl.submit(0, [op_insert] * len(keys), keys)
    cl.run_until_quiet(600)
    r0 = cl.round_no
    sync()
    t0 = time.perf_counter()
    ok = cl.move(0, cl.sublists(0)[0]["keymax"], 1)
    cl.run_until_quiet(1200)
    sync()
    return dict(ok=bool(ok), rounds=cl.round_no - r0,
                seconds=time.perf_counter() - t0,
                keys_ok=cl.all_keys() == keys, cluster=cl)


class ShardLaunches:
    """Counts ``hybrid_search`` launches per server: wraps the round
    function both backends call (``Cluster`` and the SPMD round), reading
    the wrapper's count around each server's round. ``with
    ShardLaunches() as per: ...`` leaves ``per[s]``."""

    def __enter__(self):
        from repro_torch.core import distributed, sim
        from repro_torch.kernels import ops as K
        self.mods = (sim, distributed)
        self.per = {}
        self.orig = sim.shard_round

        def counted(state, bg, me, *a, **kw):
            n0 = K.hybrid_search.launches
            out = self.orig(state, bg, me, *a, **kw)
            self.per[int(me)] = self.per.get(int(me), 0) \
                + K.hybrid_search.launches - n0
            return out

        for mod in self.mods:
            mod.shard_round = counted
        return self.per

    def __exit__(self, *exc):
        for mod in self.mods:
            mod.shard_round = self.orig
        return False


def moves_by_target(backend):
    """Wrap ``backend.move`` to record the target of every Move the
    balancer's commands queue; returns the dict it fills."""
    targets = {}
    move = backend.move

    def counted(s, entry_keymax, target):
        ok = move(s, entry_keymax, target)
        if ok:
            targets[int(target)] = targets.get(int(target), 0) + 1
        return ok

    backend.move = counted
    return targets


def nemesis_cfg(num_shards: int = 4, *, backend: str = "local", **kw):
    """``tests/nemesis_harness.py::small_cfg`` at the size it gives
    ``backend`` (``"local"``, or the smaller ``"shardmap"`` one), with
    ``DiLiConfig`` fields overridden by ``kw``."""
    from repro_torch.core.types import DiLiConfig
    if backend == "local":
        cfg = DiLiConfig(num_shards=num_shards, pool_capacity=4096,
                         max_sublists=32, max_ctrs=32, max_scan=4096,
                         batch_size=16, mailbox_cap=256, move_batch=8)
    else:
        cfg = DiLiConfig(num_shards=num_shards, pool_capacity=1024,
                         max_sublists=16, max_ctrs=16, max_scan=1024,
                         batch_size=8, mailbox_cap=64, move_batch=4)
    return cfg._replace(**kw)


def make_backend(backend: str, cfg, **kw):
    """``tests/nemesis_harness.py::make_backend`` on the port: a
    ``LocalBackend`` or a ``ShardMapBackend`` of ``cfg``."""
    from repro_torch.api import LocalBackend, ShardMapBackend
    if backend == "local":
        return LocalBackend(cfg, **kw)
    if backend == "shardmap":
        kw.pop("trace", None)        # the SPMD backend always traces
        return ShardMapBackend(cfg, **kw)
    raise ValueError(f"unknown backend {backend!r}")


def spmd_cards(num_shards: int = 4) -> list:
    """The cards ``ShardMapBackend(device="cuda")`` places ``num_shards``
    servers on, in shard order (repeats where servers share a card)."""
    from repro_torch.core.distributed import placement
    return placement(bench_cfg(num_shards=num_shards), "cuda")


def sync_cards(devices) -> None:
    """Wait for each card in ``devices``."""
    import torch
    for d in dict.fromkeys(devices):
        torch.cuda.synchronize(d)


def reset_card_peaks(devices) -> None:
    import torch
    torch.cuda.init()   # the allocator keeps per-card stats once CUDA is up
    for d in dict.fromkeys(devices):
        torch.cuda.reset_peak_memory_stats(d)


def card_peaks_mib(devices) -> dict:
    """The peak allocated memory of each card in ``devices`` since the
    last ``reset_card_peaks``, in MiB."""
    import torch
    return {str(d): round(torch.cuda.max_memory_allocated(d) / 2**20, 1)
            for d in dict.fromkeys(devices)}


def placement_note(backend) -> str:
    """The card count and ``ShardMapBackend``'s placement, and whether
    the servers spread over cards or share one."""
    import torch
    place = [str(d) for d in backend.placement]
    used = sorted(set(place))
    where = (f"the {len(place)} servers spread over {len(used)} cards"
             if len(used) > 1 else
             f"all {len(place)} servers share {used[0]}")
    return (f"{torch.cuda.device_count()} card(s) visible, placement "
            f"{place}: {where}")


def exchange_bytes(backend) -> tuple:
    """Bytes one routed round's exchange writes into the inboxes (every
    source's ``cap_pair``-row bucket for every destination), and the part
    of them that crosses between cards: computed from the placement and
    ``cap_pair``, not measured."""
    from repro_torch.core import messages as M
    pl = backend.placement
    bucket = backend.cap_pair * M.FIELDS * 4
    cross = sum(a != b for a in pl for b in pl)
    return len(pl) ** 2 * bucket, cross * bucket


def round_no(backend) -> int:
    """The rounds a backend has run."""
    return backend.cluster.round_no if hasattr(backend, "cluster") \
        else backend.round_no


def round_trace(backend) -> list:
    return backend.cluster.round_trace if hasattr(backend, "cluster") \
        else backend.round_trace


def nemesis_differential(seed: int, nemesis, *, n_ops: int = 600,
                         key_space: int = 500, num_shards: int = 4,
                         ops_per_round: int = 8, split_threshold: int = 24,
                         drain_rounds: int = 12000, cfg_overrides=None,
                         balancer_kwargs=None, scan_every: int = 0,
                         device="cuda", durability=None, timer=None,
                         backend: str = "local") -> dict:
    """``tests/nemesis_harness.py::run_differential`` on the port's
    ``backend`` (``"local"`` or ``"shardmap"``, each at the harness's
    size for it): a load of keys, then rounds of mixed FIND/INSERT/REMOVE
    through ``DiLiClient`` (per-key FIFO admission makes the sequential
    oracle exact) with a seeded ``Balancer`` (``balancer_kwargs`` reach
    it) racing Splits, Moves, Merges and, with ``cfg.replication``,
    replicate/drop commands against them, under ``nemesis``; RANGE scans
    every ``scan_every`` batches. Same draws, same order, so its round
    trace equals the reference's. Returns the harness's result fields and
    the backend.

    The referee is the harness's: the sequential oracle judges every
    mutation, every FIND a primary served and the final key set exactly.
    A FIND the client sent to a read replica (``fut.via_replica``) is
    served from an image of bounded staleness, so it is judged by the
    *windowed* referee: its result must be a membership state the key
    held within the staleness window (in ops) before its submission.
    ``replica_window`` in the result is that window, 0 without
    replication."""
    import numpy as np
    from repro_torch.api import DiLiClient
    from repro_torch.core.balancer import Balancer
    from repro_torch.core.oracle import OracleList
    from repro_torch.core.types import OP_FIND, OP_INSERT, OP_REMOVE

    kind = backend
    cfg = nemesis_cfg(num_shards, backend=kind, **(cfg_overrides or {}))
    if scan_every:
        cfg = cfg._replace(
            range_scan=True,
            mailbox_cap=max(cfg.mailbox_cap,
                            cfg.range_lanes * (cfg.range_batch + 1) + 64))
    backend = make_backend(kind, cfg, seed=seed, nemesis=nemesis,
                           durability=durability, device=device, timer=timer)
    bal = Balancer(backend, split_threshold=split_threshold,
                   merge_threshold=6, rng=backend.balancer_rng,
                   **(balancer_kwargs or {}))
    client = DiLiClient(backend, balance=bal, balance_every=3)
    oracle = OracleList()
    rng = np.random.default_rng(seed + 1)

    # per-key membership history as (global op index, state after): the
    # windowed referee's record
    hist = {}
    opno = 0

    def apply_and_record(kinds_, keys_):
        nonlocal opno
        out = []
        for kk, ky in zip(kinds_, keys_):
            out.append(oracle.apply(kk, ky))
            if kk != OP_FIND:
                hist.setdefault(ky, []).append((opno, ky in oracle))
            opno += 1
        return out

    n_load = min(max(key_space // 4, 20), 150)
    base = rng.permutation(np.arange(1, key_space))[:n_load].tolist()
    futs, exps, starts = [client.insert_batch(base)], [[True] * len(base)], [0]
    apply_and_record([OP_INSERT] * len(base), base)
    client.drain(drain_rounds, run_balance=True)

    srng = np.random.default_rng(seed + 2)
    scans = []
    done = batch_no = 0
    while done < n_ops:
        k = min(ops_per_round, n_ops - done)
        kinds = rng.choice([OP_FIND, OP_INSERT, OP_REMOVE], k).tolist()
        keys = rng.integers(1, key_space, k).tolist()
        futs.append(client.submit(kinds, keys))
        starts.append(opno)
        exps.append(apply_and_record(kinds, keys))
        if scan_every and batch_no % scan_every == 0:
            lo = int(srng.integers(0, key_space))
            hi = lo + int(srng.integers(1, key_space // 2))
            limit = int(srng.integers(1, 64))
            want = sorted(x for x in oracle.snapshot() if lo <= x < hi)
            scans.append((lo, hi, limit, want[:limit],
                          client.range(lo, hi, limit)))
        client.pump()
        done += k
        batch_no += 1
    client.drain(drain_rounds)

    scan_mismatches = [(lo, hi, limit, want, got)
                       for lo, hi, limit, want, fut in scans
                       if (got := [kv[0] for kv in fut.items(wait=False)])
                       != want]

    # the staleness bound is in rounds and at most one batch is submitted
    # a round, so ops_per_round per round bounds the op-index drift across
    # the window (plus cadence and streaming slack)
    window = 0
    if cfg.replication:
        window = (cfg.replica_staleness_rounds + cfg.replica_refresh_rounds
                  + 16) * ops_per_round

    def replica_ok(key, t, got):
        lo, base_state, seen = t - window, False, set()
        for when, st in hist.get(key, []):
            if when <= lo:
                base_state = st
            elif when <= t:
                seen.add(bool(st))
        seen.add(bool(base_state))
        return bool(got) in seen

    mismatches, windowed = [], 0
    for start, batch, exp in zip(starts, futs, exps):
        for i, (fut, got, e) in enumerate(zip(batch, batch.results(), exp)):
            if bool(got) == e:
                continue
            if (window and fut.kind == OP_FIND
                    and getattr(fut, "via_replica", False)
                    and replica_ok(fut.key, start + i, got)):
                windowed += 1
                continue
            mismatches.append((fut.kind, fut.key, e, got))
    final = backend.all_keys()
    return dict(mismatches=mismatches, scan_mismatches=scan_mismatches,
                replica_window=window, replica_windowed=windowed,
                n_scans=len(scans), final_keys=final,
                oracle_keys=sorted(oracle.snapshot()),
                keys_match=final == sorted(oracle.snapshot()),
                quiescent=backend.quiescent(), rounds=round_no(backend),
                net_stats=dict(backend.net.stats),
                nemesis_stats=dict(backend.net.nemesis.stats),
                trace=round_trace(backend), backend=backend)


def check_differential(what: str, res: dict) -> None:
    """``tests/nemesis_harness.py::check``: every result and scan, the
    final key set and quiescence. ``res["mismatches"]`` already holds the
    windowed referee's verdict on replica-served FINDs (the staleness
    window the configuration states, ``res["replica_window"]`` ops) and
    the exact oracle's on everything else."""
    check(not res["mismatches"],
          f"{what}: results differ from the oracle {res['mismatches'][:5]}")
    check(not res["scan_mismatches"],
          f"{what}: scans differ from the oracle "
          f"{res['scan_mismatches'][:3]}")
    check(res["keys_match"], f"{what}: the final key set differs from the "
                             f"oracle's")
    check(res["quiescent"], f"{what}: the backend did not quiesce")


def zipf_cfg(replication: bool):
    """``benchmarks/run.py::zipf``'s ``cfg_for``."""
    from repro_torch.core.types import DiLiConfig
    return DiLiConfig(num_shards=4, pool_capacity=1 << 15, max_sublists=256,
                      max_ctrs=256, max_scan=1 << 15, batch_size=32,
                      mailbox_cap=512, split_threshold=125, move_batch=32,
                      block_probe=True, replication=replication,
                      replica_sessions=4, replica_slots=8, replica_batch=16,
                      replica_refresh_rounds=4, replica_staleness_rounds=64)


def drive_client(client, kinds, keys, batch, futs=None,
                 sync=lambda: None) -> float:
    """``benchmarks/run.py::_drive_client``: feed ``batch`` ops per server
    per round through the client, pump, then drain; returns the wall
    seconds (``sync`` is called before each clock read). Each submitted
    batch's futures are appended to ``futs``."""
    n = len(kinds)
    per_round = batch * client.backend.n
    sync()
    t0 = time.perf_counter()
    i = 0
    while i < n:
        j = min(i + per_round, n)
        f = client.submit(kinds[i:j].tolist(), keys[i:j].tolist())
        if futs is not None:
            futs.append(f)
        i = j
        client.pump()
    client.drain(4000)
    sync()
    return time.perf_counter() - t0


def results_digest(futs) -> str:
    """sha256 of every future's raw result code, in submission order, as
    int32."""
    import hashlib
    import numpy as np
    vals = [fut.raw() for f in futs for fut in f]
    return hashlib.sha256(np.asarray(vals, np.int32).tobytes()).hexdigest()


def oracle_check(futs):
    """The sequential oracle over every future, in submission order (per-key
    FIFO admission makes it exact through ``DiLiClient``): returns the ops
    whose result differs from it, FINDs a replica served (bounded
    staleness) left out, and the oracle's final keys."""
    from repro_torch.core.oracle import OracleList
    from repro_torch.core.types import OP_FIND
    oracle = OracleList()
    mismatches = []
    for f in futs:
        for fut, got in zip(f, f.results()):
            want = oracle.apply(fut.kind, fut.key)
            if bool(got) != want and not (
                    fut.kind == OP_FIND and getattr(fut, "via_replica",
                                                    False)):
                mismatches.append((fut.kind, fut.key, want, got))
    return mismatches, sorted(oracle.snapshot())


def zipf_run(replication: bool, *, theta: float = ZIPF["theta"],
             device="cuda", timer=None, sync=lambda: None) -> dict:
    """``benchmarks/run.py::zipf``'s run at ``theta``: load + settle, the
    warm mix, then the measured read-only mix (timed), on the port's local
    backend. Returns the rounds of each part, the measured mix's
    ``rep_hits``, ops/s and seconds, the results' digest, the round of the
    first accepted ``replicate`` and of the first replica-served FIND, the
    backend, and the sequential oracle's view (per-key FIFO admission
    makes it exact for the key set): ``keys_match``, and in
    ``mismatches`` the ops whose result differs from it, FINDs a replica
    served (bounded staleness) left out. The reference's own run has two
    such FINDs (ROADMAP Queue 3 item 5), so they are logged, and held by
    the results' digest."""
    from repro_torch.api import DiLiClient, LocalBackend
    from repro_torch.core.balancer import Balancer
    from repro_torch.data.ycsb import load_phase, mixed_phase

    z = ZIPF
    load = load_phase(z["n_load"], z["key_space"], seed=12)
    warm = mixed_phase(z["n_ops"], z["key_space"], 0.9, seed=13,
                       theta=theta)
    meas = mixed_phase(z["n_ops"], z["key_space"], 1.0, seed=14,
                       theta=theta)
    backend = LocalBackend(zipf_cfg(replication), device=device,
                           timer=timer)
    bal = Balancer(backend, hot_rate=6.0, cold_rate=1.0, hot_share=0.45,
                   replica_fanout=3)
    client = DiLiClient(backend, balance=bal, max_inflight=1024)
    st = backend.stats
    first = {}
    step, replicate = backend.step, backend.replicate

    def stepped():
        out = step()
        if st["rep_hits"] and "serve" not in first:
            first["serve"] = st["rounds"]
        return out

    def replicated(*a):
        ok = replicate(*a)
        if ok and "replicate" not in first:
            first["replicate"] = st["rounds"]
        return ok

    backend.step, backend.replicate = stepped, replicated
    futs = []
    drive_client(client, *load, z["batch"], futs)
    client.settle(max_rounds=8000)
    r_set = st["rounds"]
    drive_client(client, *warm, z["batch"], futs)
    r_warm, h0 = st["rounds"], st["rep_hits"]
    if timer is not None:
        timer.reset()
    dt = drive_client(client, *meas, z["batch"], futs, sync=sync)

    mismatches, oracle_keys = oracle_check(futs)
    final = backend.all_keys()
    return dict(setup_rounds=r_set, warm_rounds=r_warm - r_set,
                rounds=st["rounds"] - r_warm, rep_hits=st["rep_hits"] - h0,
                results=results_digest(futs), seconds=dt,
                ops_per_s=len(meas[0]) / dt, mismatches=mismatches,
                keys_match=final == oracle_keys,
                n_keys=len(final), first_replicate=first.get("replicate"),
                first_serve=first.get("serve"), backend=backend)


def phase_zipf() -> dict:
    """``benchmarks/run.py::zipf`` at theta 0.99 (``ZIPF``), replication on
    and off, each under the per-phase timer: rounds, the measured mix's
    ``rep_hits`` and the results' digest equal ``ZIPF_EXPECTED``, the key
    set equals the sequential oracle's, replicas serve FINDs with
    replication on, and ``hybrid_search`` launches on every server."""
    import torch
    from repro_torch.kernels import ops as K
    from repro_torch.timing import PhaseTimer

    runs = {}
    for label, on in (("on", True), ("off", False)):
        timer = PhaseTimer("cuda")
        K.hybrid_search.launches = 0
        with ShardLaunches() as per_server:
            t0 = time.perf_counter()
            r = zipf_run(on, device="cuda", timer=timer,
                         sync=torch.cuda.synchronize)
            torch.cuda.synchronize()
            r["total_s"] = time.perf_counter() - t0
        r.update(launches=K.hybrid_search.launches,
                 per_server=dict(per_server),
                 breakdown=breakdown(timer, r["rounds"]),
                 ms_per_round=1e3 * r["seconds"] / r["rounds"])
        r.pop("backend")
        got = {k: r[k] for k in ZIPF_EXPECTED[label]}
        check(got == ZIPF_EXPECTED[label],
              f"zipf {label}: {got} != the reference's "
              f"{ZIPF_EXPECTED[label]}")
        check(r["keys_match"], f"zipf {label}: the final key set differs "
                               f"from the oracle's")
        _launch_check(f"zipf {label}", per_server, range(4))
        log(f"[zipf] replication {label}, theta {ZIPF['theta']}: measured "
            f"read-only mix {r['ops_per_s']:.1f} ops/s ({r['rounds']} "
            f"rounds, {r['seconds']:.3f} s, {r['ms_per_round']:.3f} "
            f"ms/round), rep_hits {r['rep_hits']}; load + settle "
            f"{r['setup_rounds']} and warm {r['warm_rounds']} rounds, "
            f"{r['total_s']:.1f} s in all; counts and results digest equal "
            f"the reference's; first replicate at round "
            f"{r['first_replicate']}, first replica serve at "
            f"{r['first_serve']}; {r['n_keys']} keys = oracle; results "
            f"off the strict oracle (the reference's too) "
            f"{r['mismatches']}; hybrid_search launches {r['launches']}, "
            f"per server {dict(sorted(per_server.items()))}")
        log(f"[zipf] replication {label}: per-round ms over the measured "
            f"mix {json.dumps(r['breakdown'])}")
        runs[label] = r
    check(runs["on"]["rep_hits"] > 0, "zipf: no FIND was served by a "
                                      "replica with replication on")
    ratio = runs["on"]["ops_per_s"] / runs["off"]["ops_per_s"]
    log(f"[zipf] on/off: {ratio:.3f}x ops/s "
        f"({runs['on']['ops_per_s']:.1f} / {runs['off']['ops_per_s']:.1f}), "
        f"rounds {runs['on']['rounds']} / {runs['off']['rounds']}")
    return dict(runs=runs, ratio=ratio)


def phase_replica_nemesis() -> dict:
    """``tests/test_replica.py::test_differential_nemesis_with_replication``
    (``REPLICA_NEMESIS``): 4 servers, replication forced on, the balancer
    replicating what the workload touches, under the lossy wire. The
    windowed referee holds replica-served FINDs, the exact oracle the
    rest and the key set; the round trace digests to
    ``REPLICA_NEMESIS_DIGEST`` and replicas serve FINDs."""
    import torch
    from repro_torch.core.net import NemesisConfig, trace_digest

    e = REPLICA_NEMESIS
    t0 = time.perf_counter()
    res = nemesis_differential(
        e["seed"], NemesisConfig(**e["faults"]), n_ops=e["n_ops"],
        cfg_overrides=REP_OVERRIDES, balancer_kwargs=REP_BAL,
        device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check_differential("replica_nemesis", res)
    digest = trace_digest(res["trace"])
    check(digest == REPLICA_NEMESIS_DIGEST,
          f"replica_nemesis: round-trace digest {digest} != the "
          f"reference's {REPLICA_NEMESIS_DIGEST}")
    hits = res["backend"].stats["rep_hits"]
    check(hits > 0, "replica_nemesis: no FIND was served by a replica")
    log(f"[replica_nemesis] seed {e['seed']}, {e['n_ops']} ops on 4 "
        f"servers: {res['rounds']} rounds in {dt:.2f} s "
        f"({1e3 * dt / res['rounds']:.3f} ms/round); trace digest equals "
        f"the reference's; rep_hits {hits}, "
        f"{res['replica_windowed']} replica FINDs admitted by the "
        f"{res['replica_window']}-op window; transport {res['net_stats']}")
    return dict(rounds=res["rounds"], seconds=dt, rep_hits=hits)


# tests/membership_harness.py::SCALE_3_5_2: (round due, op, shard); an
# event fires once the cluster is past its round and no change is in
# flight (joins take the lowest retired slot, retires the highest active)
SCALE_3_5_2 = ((10, "join", None), (30, "join", None), (60, "retire", None),
               (90, "retire", None), (120, "retire", None))


def membership_differential(seed: int, nemesis, *, schedule=SCALE_3_5_2,
                            n_ops: int = 600, key_space: int = 500,
                            capacity: int = 6, initial_shards: int = 3,
                            ops_per_round: int = 8,
                            drain_rounds: int = 20000, trace: bool = True,
                            device="cuda", backend: str = "local") -> dict:
    """``tests/membership_harness.py::run_membership_differential`` on the
    port's ``backend`` (``"local"`` or ``"shardmap"``, at the harness's
    size for it): a cluster of ``capacity`` slots boots with
    ``initial_shards`` active, and ``schedule`` joins and retires shards
    under continuous mixed traffic through ``DiLiClient``. The local
    backend's round trace is on (``trace``) even without a nemesis: its
    ``mb`` lines witness the membership changes (the SPMD backend traces
    its host-routed rounds, those under a nemesis). Returns the harness's
    result fields and the backend."""
    import numpy as np
    from repro_torch.api import DiLiClient
    from repro_torch.core.balancer import Balancer
    from repro_torch.core.oracle import OracleList
    from repro_torch.core.types import OP_FIND, OP_INSERT, OP_REMOVE

    kind = backend
    backend = make_backend(kind, nemesis_cfg(capacity, backend=kind),
                           seed=seed, nemesis=nemesis,
                           initial_shards=initial_shards, trace=trace,
                           device=device)
    bal = Balancer(backend, split_threshold=24, merge_threshold=6,
                   rng=backend.balancer_rng)
    client = DiLiClient(backend, balance=bal, balance_every=3)
    oracle = OracleList()
    rng = np.random.default_rng(seed + 1)
    mb = backend.membership

    n_load = min(max(key_space // 4, 20), 150)
    base = rng.permutation(np.arange(1, key_space))[:n_load].tolist()
    futs, exps = [client.insert_batch(base)], [[True] * len(base)]
    oracle.apply_batch([OP_INSERT] * len(base), base)
    client.drain(drain_rounds, run_balance=True)

    pending = list(schedule)
    fired = []

    def maybe_fire():
        if not pending or mb.joining or mb.draining:
            return
        due, op, shard = pending[0]
        if round_no(backend) < due:
            return
        if op == "join":
            shard = backend.join_shard(shard)
        else:
            shard = max(mb.active) if shard is None else shard
            backend.retire_shard(shard)
        fired.append((round_no(backend), op, shard))
        pending.pop(0)

    done = stall = 0
    while done < n_ops or pending:
        maybe_fire()
        if done < n_ops:
            k = min(ops_per_round, n_ops - done)
            kinds = rng.choice([OP_FIND, OP_INSERT, OP_REMOVE], k).tolist()
            keys = rng.integers(1, key_space, k).tolist()
            futs.append(client.submit(kinds, keys))
            exps.append(oracle.apply_batch(kinds, keys))
            done += k
            client.pump()
        else:
            # the op stream is exhausted but the schedule is not: finish
            # the change in flight, then idle-step to the next due round
            client.settle(max_rounds=drain_rounds)
            if pending and not (mb.joining or mb.draining) \
                    and round_no(backend) < pending[0][0]:
                client.pump()
            stall += 1
            check(stall <= drain_rounds,
                  f"membership schedule stalled: fired={fired} "
                  f"pending={pending} view={mb.view()}")
    client.drain(drain_rounds)
    client.settle(max_rounds=drain_rounds)

    mismatches = [(fut.kind, fut.key, e, got)
                  for batch, exp in zip(futs, exps)
                  for fut, got, e in zip(batch, batch.results(), exp)
                  if bool(got) != e]
    final = backend.all_keys()
    n_joins = sum(1 for _, op, _ in fired if op == "join")
    return dict(mismatches=mismatches, scan_mismatches=[],
                final_keys=final, oracle_keys=sorted(oracle.snapshot()),
                keys_match=final == sorted(oracle.snapshot()),
                quiescent=backend.quiescent(), rounds=round_no(backend),
                schedule_done=not pending, fired=fired, view=mb.view(),
                mb_log=list(mb.log),
                expected_active=initial_shards + 2 * n_joins - len(fired),
                trace=round_trace(backend), backend=backend)


# ------------------------------------------------------------------ phases

def phase_build() -> None:
    """Build every kernel's source at once, one ``nvcc`` each."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import build as B
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        paths = dict(zip(KERNELS, pool.map(
            lambda name: B.build(name, verbose=True), KERNELS)))
    for name, path in paths.items():
        log(f"[build] {name} -> {path.relative_to(ROOT)} in "
            f"{B.build_seconds[name]:.2f} s")
    log(f"[build] all kernels in {time.perf_counter() - t0:.2f} s")


def _registry(rng, m_live, m, c, coverage=0.6):
    """Sorted keymin + sorted INT32_MAX-padded blocks, ``m_live`` live
    rows padded to ``m`` as the runtime's registry is."""
    import numpy as np
    imax = np.iinfo(np.int32).max
    bounds = np.sort(rng.choice(np.arange(0, 40 * m_live, 7), m_live,
                                replace=False))
    bounds[0] = -1
    keymin = np.full(m, imax, np.int32)
    keymin[:m_live] = bounds
    blocks = np.full((m, c), imax, np.int32)
    for i in range(m_live):
        lo = int(bounds[i]) + 1
        hi = int(bounds[i + 1]) if i + 1 < m_live else lo + 300
        take = np.sort(rng.permutation(np.arange(lo, max(hi, lo + 1)))
                       [:int(c * coverage)])
        blocks[i, :take.size] = take
    blocks[0, :] = np.arange(-c, 0)        # one full block, all < 0
    return keymin, blocks


def _queries(rng, blocks, b):
    """Half present keys, half misses, and the edges up front: the pad
    sentinel, the largest real key, and 0 — routed to the full block 0,
    whose keys are all below it (pos == C)."""
    import numpy as np
    imax = np.iinfo(np.int32).max
    live = blocks[blocks != imax]
    q = np.concatenate([rng.choice(live, b // 2),
                        rng.integers(-5, int(live.max()) + 5, b - b // 2)])
    q = q.astype(np.int32)
    q[:min(3, b)] = [imax, imax - 1, 0][:min(3, b)]
    return q


def hs_edge_case(m: int, c: int, b: int, seed: int = 0):
    """``hybrid_search`` inputs at the edges of the kernel's design, as
    numpy: ``keymin`` sorted with ties and INT32_MAX pads (the last quarter
    of the entries); rows sorted, each filled to a random count and padded
    with INT32_MAX, row 0 full with every key below ``keymin[1]`` (the
    full-block-all-less row, which a query of ``keymin[1]`` reaches); ``b``
    queries: the sentinels INT32_MAX, INT32_MAX - 1 and INT32_MIN first,
    then every ``keymin`` value and its neighbours, row keys and their
    neighbours, and random values, shuffled."""
    import numpy as np
    rng = np.random.default_rng(seed)
    imin, imax = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    live = max(1, m - m // 4)
    # ties: the live keymins are drawn from a pool a third their number
    pool = rng.integers(-10 * live * c, 10 * live * c, max(1, live // 3))
    km = np.sort(rng.choice(pool, live)).astype(np.int64)
    if live > 1:
        km[0] = km[1] - 2 * c - 2
    nxt = np.append(km[1:], km[-1] + 4 * c + 4)
    gap = np.maximum(nxt - km - 1, 1)
    rows = km[:, None] + 1 + np.sort(
        (rng.random((live, c)) * gap[:, None]).astype(np.int64), axis=1)
    fill = rng.integers(0, c + 1, live)
    fill[0] = c
    rows = np.where(np.arange(c)[None, :] < fill[:, None], rows, imax)
    keymin = np.full(m, imax, np.int64)
    keymin[:live] = km
    blocks = np.full((m, c), imax, np.int64)
    blocks[:live] = rows
    special = [imax, imax - 1, imin]
    near = np.concatenate([km - 1, km, km + 1])
    keys = rows[rows != imax]
    near_rows = rng.choice(keys, min(keys.size, 2 * b)) + \
        rng.integers(-1, 2, min(keys.size, 2 * b))
    rand = rng.integers(imin, imax, b, dtype=np.int64)
    q = np.concatenate([near, near_rows, rand])
    q = rng.permutation(q)[:max(b - len(special), 0)]
    q = np.concatenate([special, q])[:b]
    q = np.clip(q, imin, imax)
    return (keymin.astype(np.int32), blocks.astype(np.int32),
            q.astype(np.int32))


def refresh_case(m: int, c: int, n: int, nc: int, max_scan: int,
                 rules=RW_RULES, dirty: float = 0.5, me: int = 1,
                 seed: int = 0):
    """``refresh_walk`` inputs at the edges of its rules, as numpy: a dict
    keyed as the wrapper's parameters (``me`` and ``max_scan`` included)
    and a dict of what each row must give (``valid``, ``steps``, and the
    ``rule`` its walk ends by, "" where it does not walk).

    Of the ``size`` (7/8 of M) registry rows in use, a share ``dirty``
    walks a chain built to end by ``rules`` in turn, at a random depth,
    through live keys, tombstones (marked ``nxt``) and in-chain SubHeads.
    The rest are clean (valid; kept as they are) or fail the gate (a NULL
    or foreign SubHead, a switched counter slot, a moving head; their valid
    bit cleared). Rows past ``size``, the old blocks and every pool slot
    outside a chain hold random words. Chains lie at random pool slots;
    some counter slots lie out of range (clamped); refs carry mark bits
    where the pointer's source node is marked, and some SubHead refs carry
    one anyway."""
    import numpy as np
    rng = np.random.default_rng(seed)
    null = (1 << 22) - 1
    sh_key, st_key = -(2**31), 2**31 - 1
    other = (me + 1 + int(rng.integers(0, 500))) % 512

    def ref(sid, idx, mark=False):
        return (sid << 22) | idx | ((1 << 31) if mark else 0)

    key = rng.integers(-1000, 1000, n)
    nxt = rng.integers(0, 2**32, n, dtype=np.int64)
    ctr = rng.integers(0, nc, n)
    newloc = np.full(n, null, np.int64)
    stct = rng.integers(0, 1000, nc)
    bad_slots = rng.choice(np.arange(1, nc - 1), max(1, (nc - 2) // 8),
                           replace=False) if nc > 2 else np.zeros(0, int)
    stct[bad_slots] = -rng.integers(1, 1000, bad_slots.size)
    stct[bad_slots[:1]] = -(2**31)
    good_slots = np.setdiff1d(np.arange(nc), bad_slots)
    slots_in = iter(rng.permutation(n).tolist())
    size = m - m // 8
    subhead = rng.integers(0, 2**32, m, dtype=np.int64)
    subtail = rng.integers(0, 2**32, m, dtype=np.int64)
    reg_ctr = rng.integers(-3, nc + 3, m)
    keys = rng.integers(-(2**31), 2**31, (m, c), dtype=np.int64)
    idx = rng.integers(0, n, (m, c))
    valid = rng.random(m) < 0.5
    want_valid = np.zeros(m, bool)
    want_steps = np.zeros(m, np.int64)
    rule_of = [""] * m
    walks = 0

    def good_slot():
        # now and then out of range: clamped onto slot 0 or NC - 1, both good
        if rng.random() < 0.1:
            return int(rng.choice([-7, nc + 7]))
        return int(rng.choice(good_slots))

    def node(k, mark=False):
        i = next(slots_in)
        key[i] = k
        newloc[i] = null
        ctr[i] = good_slot()
        return i, mark

    def filler(n_live, n_tomb, n_sh=0):
        """Live keys, tombstones and in-chain SubHeads in random order."""
        kinds = ["live"] * n_live + ["tomb"] * n_tomb + ["sh"] * n_sh
        rng.shuffle(kinds)
        out = []
        for kd in kinds:
            if kd == "live":
                out.append(node(int(rng.integers(-10**6, 10**6))))
            elif kd == "tomb":
                out.append(node(int(rng.integers(-10**6, 10**6)), True))
            else:
                out.append(node(sh_key, rng.random() < 0.5))
        return out

    def prefix():
        """A chain start that ends by nothing: at most C live keys, room
        for one more step under the bound."""
        total = int(rng.integers(0, max(max_scan - 1, 1)))
        n_live = int(rng.integers(0, min(c, total) + 1))
        return filler(n_live, total - n_live)

    for e in range(size):
        u = rng.random()
        if u >= dirty:
            h, _ = node(sh_key)
            subhead[e] = ref(me, h, rng.random() < 0.25)
            reg_ctr[e] = good_slot()
            if u < dirty + (1 - dirty) / 2:             # clean
                valid[e] = want_valid[e] = True
                continue
            gate = int(rng.integers(0, 4))              # fails the gate
            if gate == 0:
                subhead[e] = ref(0, null, rng.random() < 0.5)
            elif gate == 1:
                subhead[e] = ref(other, h)
            elif gate == 2:
                reg_ctr[e] = int(rng.choice(bad_slots))
            else:
                newloc[h] = ref(other, int(rng.integers(0, n)))
            continue
        rule = rule_of[e] = rules[walks % len(rules)]
        walks += 1
        valid[e] = False
        h, _ = node(sh_key)
        subhead[e] = ref(me, h, rng.random() < 0.25)
        reg_ctr[e] = good_slot()
        st, _ = node(st_key)
        subtail[e] = ref(me, st, rng.random() < 0.25)
        # chain: the nodes the walk visits, the last one where it ends;
        # link: how the last pointer reaches it ("ok", "foreign", "null")
        link = "ok"
        if rule in ("subtail", "subtail_moving"):
            chain = filler(int(rng.integers(0, min(c, max_scan - 1) + 1)), 0)
            chain.append((st, False))
            if rule == "subtail_moving":
                newloc[st] = ref(other, int(rng.integers(0, n)))
        elif rule == "tombstones":
            n_live = int(rng.integers(0, min(c, max_scan - 2) + 1))
            n_tomb = int(rng.integers(1, max_scan - n_live))
            chain = filler(n_live, n_tomb) + [(st, False)]
        elif rule == "subhead":
            n_live = int(rng.integers(0, min(c, max_scan - 2) + 1))
            n_sh = int(rng.integers(1, min(3, max_scan - 1 - n_live) + 1))
            chain = filler(n_live, 0, n_sh) + [(st, False)]
        elif rule == "overflow":
            n_tomb = int(rng.integers(0, max_scan - c))
            chain = filler(c, n_tomb) + filler(1, 0)
        elif rule == "max_scan":
            n_live = int(rng.integers(0, c + 1))
            chain = filler(n_live, max_scan + 1 - n_live) + [(st, False)]
        else:
            chain = prefix()
            if rule == "foreign":
                link = "foreign"
                chain += filler(1, 0)
            elif rule == "null":
                link = "null"
                chain.append((n - 1, False))
            elif rule == "moving":
                end, _ = node(int(rng.integers(-10**6, 10**6)))
                newloc[end] = ref(me, int(rng.integers(0, n)))
                chain.append((end, False))
            elif rule == "switched":
                end, _ = node(int(rng.integers(-10**6, 10**6)))
                ctr[end] = int(rng.choice(bad_slots))
                chain.append((end, False))
            elif rule == "marked_subtail":
                chain.append((st, True))
            else:                                       # other_subtail
                end, _ = node(st_key)
                chain.append((end, False))
        # nxt[node] points at its successor and carries the node's mark
        prev, prev_mark = h, False
        for j, (i, mark) in enumerate(chain):
            last = j == len(chain) - 1
            if last and link == "foreign":
                nxt[prev] = ref(other, i, prev_mark)
            elif last and link == "null":
                nxt[prev] = ref(0, null, prev_mark)
            else:
                nxt[prev] = ref(me, i, prev_mark)
            prev, prev_mark = i, mark
        if link != "null":                  # the last node's own mark
            nxt[prev] = ref(me, int(rng.integers(0, n)), prev_mark)
        want_steps[e] = min(len(chain), max_scan)
        want_valid[e] = rule in RW_VALID

    def bits(a):
        return np.asarray(a, np.int64).astype(np.uint32).view(np.int32)

    args = dict(key=key.astype(np.int32), nxt=bits(nxt),
                ctr=ctr.astype(np.int32), newloc=bits(newloc),
                stct=stct.astype(np.int32), subhead=bits(subhead),
                subtail=bits(subtail), reg_ctr=reg_ctr.astype(np.int32),
                size=np.asarray(size, np.int32), keys=keys.astype(np.int32),
                idx=idx.astype(np.int32), valid=valid, me=me,
                max_scan=max_scan)
    return args, dict(valid=want_valid, steps=want_steps, rule=rule_of)


def phase_kernels() -> dict:
    """``hybrid_search`` against its plain twin on the card, bit for bit:
    the tests' hand-made cases, the edge grid (``hs_edge_case`` at every
    M, C and B of ``HS_EDGE_*``), rows off a 16-byte boundary, and the
    fig3a and scale shapes; repeated calls bitwise equal; a call issues
    the kernel and no other device operation. Then, per shape, the device
    time beside the bound, the wrapper's host time per call and the twin's
    time. Returns the timing record."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops as K

    dev = torch.device("cuda")
    imax = np.iinfo(np.int32).max

    def on_card(*xs):
        return [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                for x in xs]

    def vs_twin(a, what):
        outs = [K.hybrid_search(*a) for _ in range(3)]
        slot_r, found_r = K.hybrid_search_ref(*a)
        torch.cuda.synchronize()
        slot, found = outs[0]
        err = int((slot.long() - slot_r.long()).abs().max()) \
            if slot.numel() else 0
        err = max(err, int((found != found_r).sum()))
        check(err == 0, f"hybrid_search {what}: kernel != plain, max err "
                        f"{err}")
        check(all(torch.equal(slot, s) and torch.equal(found, f)
                  for s, f in outs[1:]),
              f"hybrid_search {what}: repeated calls differ")
        return err

    # the hand-made cases of the tests
    c = 8
    keymin = np.asarray([-1, 50], np.int32)
    blocks = np.full((2, c), imax, np.int32)
    blocks[0] = np.arange(10, 10 + c)
    blocks[1, :3] = [60, 70, 80]
    vs_twin(on_card(keymin, blocks,
                    np.asarray([49, 18, 75, 60, imax, 10], np.int32)),
            "full-block/sentinel case")
    rng = np.random.default_rng(0)
    for b in (3, 100, 129):
        km, bl = _registry(rng, 8, 8, 32)
        vs_twin(on_card(km, bl, rng.integers(-5, 400, b).astype(np.int32)),
                f"ragged B={b}")

    # the edge grid of the gpu tests
    before = K.hybrid_search.launches
    for m in HS_EDGE_M:
        for c in HS_EDGE_C:
            km, bl, q = on_card(*hs_edge_case(m, c, max(HS_EDGE_B),
                                              seed=m + c))
            for b in HS_EDGE_B:
                vs_twin((km, bl, q[:b]), f"edge M={m} C={c} B={b}")
    n_edge = len(HS_EDGE_M) * len(HS_EDGE_C) * len(HS_EDGE_B)
    check(K.hybrid_search.launches == before + 3 * n_edge,
          f"hybrid_search: {K.hybrid_search.launches - before} launches "
          f"counted for {3 * n_edge} calls")
    km, bl, q = hs_edge_case(256, 160, 4096, seed=7)
    flat = torch.empty(256 * 160 + 1, dtype=torch.int32, device=dev)
    shifted = flat[1:].view(256, 160)
    shifted.copy_(torch.from_numpy(bl).to(dev))
    vs_twin((on_card(km)[0], shifted, on_card(q)[0]),
            "rows off a 16-byte boundary (scalar sweep)")
    log(f"[kernels] hybrid_search: bit-identical to the twin on the tests' "
        f"cases and the edge grid (M {list(HS_EDGE_M)} x C "
        f"{list(HS_EDGE_C)} x B {list(HS_EDGE_B)}: ties, INT32_MAX pads, "
        f"the full-block-all-less row, sentinel queries) and on rows off a "
        f"16-byte boundary; 3 calls bitwise equal each")

    shapes = {"fig3a": (200, 256, 160, 128), "scale_path": (8000, 16384, 160,
                                                            128),
              "scale": (8000, 16384, 160, 4096)}
    rec = {}
    for name, (m_live, m, c, b) in shapes.items():
        km, bl = _registry(rng, m_live, m, c)
        q = _queries(rng, bl, b)
        args = on_card(km, bl, q)
        err = vs_twin(args, f"{name} (M={m}, C={c}, B={b})")
        # the wrapper's call is the kernel and nothing else on the device
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                K.hybrid_search(*args)
            torch.cuda.synchronize()
        ev = _device_events(prof)
        check(all("hybrid_search_kernel" in e.key for e in ev),
              f"hybrid_search {name}: a call ran other device work: "
              f"{[e.key for e in ev]}")
        # every device operation of the wrapper's call
        ms = device_ms(lambda: K.hybrid_search(*args))
        plain_ms = device_ms(lambda: K.hybrid_search_ref(*args))
        call_ms = time_cuda(lambda: K.hybrid_search(*args))
        plain_call_ms = time_cuda(lambda: K.hybrid_search_ref(*args),
                                  iters=50)
        # least work: each query, the row it reads and the outputs once,
        # plus the registry column; ops: a binary search's compares and
        # the row compares (two per key)
        entry = np.clip(np.searchsorted(km, q, side="left") - 1, 0, m - 1)
        rows = np.unique(entry).size
        nbytes = m * 4 + rows * c * 4 + b * 4 + b * 5
        nops = b * ((max(m, 2) - 1).bit_length() + 2 * c)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / CORE_OPS_PER_S * 1e3
        rec[name] = dict(ms=ms, plain_ms=plain_ms, call_ms=call_ms,
                         plain_call_ms=plain_call_ms, max_abs_err=err,
                         bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations", shape=[m, c, b])
        log(f"[kernels] hybrid_search {name} M={m} C={c} B={b}: kernel "
            f"{ms * 1e3:.3f} us on the device per call (the kernel alone), "
            f"bound {rec[name]['bound_ms'] * 1e3:.4f} us "
            f"({rec[name]['bound_by']}); one wrapper call back to back "
            f"{call_ms * 1e3:.2f} us; plain version (reference only) "
            f"{plain_ms * 1e3:.3f} us on the device, "
            f"{plain_call_ms * 1e3:.2f} us per call; bit-identical")
    return rec


def phase_refresh_kernel() -> dict:
    """``refresh_walk`` against its plain twin on the card, bit for bit:
    every ending rule of ``refresh_case`` alone and all together at a small
    shape (three seeds each), and the main path's shape (``RW_CELL``);
    each call one launch, its rows ending as built; a call runs the kernel
    and no other device work. Then at the main path's shape: the device
    time, the wrapper's host time, the plain version's time, and the least
    time, the longest walk's steps times one dependent load's latency,
    taken as the kernel's time a step on long chains (``max_scan`` rows
    at 32,768 steps) in a pool of the same size. Returns the record."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops as K

    dev = torch.device("cuda")

    def on_card(args):
        return {k: torch.from_numpy(np.array(v)).to(dev)
                if isinstance(v, np.ndarray) else v for k, v in args.items()}

    def vs_twin(args, want, what):
        n0 = K.refresh_walk.launches
        got = K.refresh_walk(**args)
        check(K.refresh_walk.launches == n0 + 1,
              f"refresh_walk {what}: {K.refresh_walk.launches - n0} "
              f"launches counted for one call")
        ref = K.refresh_walk_ref(**args)
        torch.cuda.synchronize()
        for name, a, b in zip(("keys", "idx", "valid", "steps"), got, ref):
            check(torch.equal(a, b), f"refresh_walk {what}: {name} differs "
                                     f"from the plain version")
        check(np.array_equal(got[2].cpu().numpy(), want["valid"])
              and np.array_equal(got[3].cpu().numpy(), want["steps"]),
              f"refresh_walk {what}: rows did not end as built")
        return got

    small = dict(m=48, c=8, n=2048, nc=16, max_scan=40)
    for seed in range(3):
        for rules in [(r,) for r in RW_RULES] + [RW_RULES]:
            args, want = refresh_case(**small, rules=rules, seed=seed)
            vs_twin(on_card(args), want, f"{'/'.join(rules)} seed {seed}")
    args, want = refresh_case(**RW_CELL, seed=5)
    cell = on_card(args)
    vs_twin(cell, want, "main path shape")
    dirty = int((want["steps"] > 0).sum())
    longest = int(want["steps"].max())
    log(f"[kernels] refresh_walk: bit-identical to the twin (keys, idx, "
        f"valid, steps per row) for each of {len(RW_RULES)} ending rules "
        f"alone and all together, 3 seeds each, and at the main path's "
        f"shape (M={RW_CELL['m']}, C={RW_CELL['c']}, pool {RW_CELL['n']}: "
        f"{dirty} dirty rows, the longest walk {longest} steps)")

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            K.refresh_walk(**cell)
        torch.cuda.synchronize()
    ev = _device_events(prof)
    check(all("refresh_walk_kernel" in e.key for e in ev),
          f"refresh_walk: a call ran other device work: "
          f"{[e.key for e in ev]}")
    ms = device_ms(lambda: K.refresh_walk(**cell))
    call_ms = time_cuda(lambda: K.refresh_walk(**cell))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        K.refresh_walk(**cell)
    host_ms = (time.perf_counter() - t0) * 1e3 / 200
    torch.cuda.synchronize()
    plain_ms = device_ms(lambda: K.refresh_walk_ref(**cell), iters=2)
    plain_call_ms = time_cuda(lambda: K.refresh_walk_ref(**cell), iters=2,
                              reps=3)

    # one dependent load's latency: chains of 32,768 steps, one load each
    # on the critical path, in a pool of the main path's size
    chase_steps = 1 << 15
    args, want = refresh_case(8, RW_CELL["c"], RW_CELL["n"], 16, chase_steps,
                              rules=("max_scan",), dirty=1.0, seed=3)
    chase = on_card(args)
    check(int(want["steps"].max()) == chase_steps, "refresh_walk: the chase "
          "case does not walk to its bound")
    step_ms = device_ms(lambda: K.refresh_walk(**chase), iters=5) \
        / chase_steps
    m, c = RW_CELL["m"], RW_CELL["c"]
    t_bytes = 4 * m * c * 4 / HBM_BYTES_PER_S * 1e3   # keys, idx in and out
    t_chain = longest * step_ms
    rec = dict(ms=ms, call_ms=call_ms, host_ms=host_ms, plain_ms=plain_ms,
               plain_call_ms=plain_call_ms, step_ms=step_ms,
               bound_ms=max(t_chain, t_bytes),
               bound_by="dependent loads" if t_chain >= t_bytes
               else "bytes", longest=longest, dirty=dirty,
               shape=[m, c, RW_CELL["n"]], max_abs_err=0)
    log(f"[kernels] refresh_walk M={m} C={c} pool {RW_CELL['n']}: kernel "
        f"{ms * 1e3:.3f} us on the device per call (the kernel alone), "
        f"bound {rec['bound_ms'] * 1e3:.3f} us ({rec['bound_by']}: "
        f"{longest} steps x {step_ms * 1e6:.1f} ns a dependent load, "
        f"measured on {chase_steps}-step chains; bytes "
        f"{t_bytes * 1e3:.3f} us); the wrapper's host side "
        f"{host_ms * 1e3:.2f} us a call, back to back {call_ms * 1e3:.2f} "
        f"us; plain version (reference only) {plain_ms * 1e3:.1f} us on "
        f"the device, {plain_call_ms * 1e3:.1f} us per call")
    return rec


# (B, H, KH, D, pages per sequence, page size): the reference's test shapes
# (tests/test_kernels.py) and the serving shape of Qwen2-0.5B
PAGED_SHAPES = {"test_gqa": (4, 8, 2, 64, 8, 16),
                "test_mha": (2, 16, 16, 128, 4, 32),
                "test_mqa": (8, 4, 1, 64, 16, 8)}
PAGED_TOL = {"f32": dict(atol=2e-5, rtol=2e-2),
             "bf16": dict(atol=2e-2, rtol=2e-2)}


def _paged_case(b, h, kh, d, pages, ps, dtype, seed, lens=None):
    """The reference test's inputs on the card: q and pages from a seeded
    normal, a random page table over a pool 3x the pages, random lengths
    (or ``lens``)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    pool = pages * 3
    dev = torch.device("cuda")

    def t(x):
        return torch.from_numpy(x.astype(np.float32)).to(dev, dtype)
    q = t(rng.standard_normal((b, h, d)))
    kp = t(rng.standard_normal((pool, ps, kh, d)) * 0.3)
    vp = t(rng.standard_normal((pool, ps, kh, d)) * 0.3)
    pt = rng.integers(0, pool, (b, pages)).astype(np.int32)
    sl = (rng.integers(1, pages * ps + 1, (b,)) if lens is None
          else np.asarray(lens)).astype(np.int32)
    return [q, kp, vp, torch.from_numpy(pt).to(dev),
            torch.from_numpy(sl).to(dev)]


def _paged_library(q, kp, vp, pt, sl, ps):
    """The nearest library call, timed for the table only: a gather of
    each sequence's pages, then ``scaled_dot_product_attention`` with GQA
    and the length mask."""
    import torch
    import torch.nn.functional as F
    b, h, d = q.shape
    pp = pt.shape[1]
    kh = kp.shape[2]
    k = kp[pt.long()].reshape(b, pp * ps, kh, d).transpose(1, 2)
    v = vp[pt.long()].reshape(b, pp * ps, kh, d).transpose(1, 2)
    mask = (torch.arange(pp * ps, device=q.device)[None, :]
            < sl[:, None])[:, None, None, :]
    return F.scaled_dot_product_attention(q[:, :, None, :], k, v,
                                          attn_mask=mask,
                                          enable_gqa=True)[:, :, 0]


def _paged_edge_cases(sms: int):
    """The edge cases of ``tests/test_torch_paged_attention.py``, each as
    (name, shape (B, H, KH, D, PP, S), lengths, dtypes)."""
    from repro_torch.kernels import paged_attention as PA
    cases = []
    b, h, kh, d, pp, ps = 6, 8, 2, 32, 4, 8
    cases.append(("edge_lengths", (b, h, kh, d, pp, ps),
                  [0, 1, ps, ps + 1, pp * ps, pp * ps + 5], ("f32", "bf16")))
    b, h, kh, d, pp, ps = 6, 8, 2, 64, 34, 16
    _, n_split, per = PA.plan(b, h, kh, pp, sms)
    check(n_split > 1, f"paged_attention: {pp} pages of {b} sequences "
                       f"gave one split on {sms} SMs")
    lens = []
    for i in (1, n_split - 2):
        start, end = i * per * ps, min((i + 1) * per, pp) * ps
        lens += [start + 1, end, start]
    cases.append(("split_boundaries", (b, h, kh, d, pp, ps), lens,
                  ("f32", "bf16")))
    b, h, kh, d, ps = 8, 14, 2, 64, 16
    ragged = next(n for n in range(5, 200)
                  if 1 < PA.plan(b, h, kh, n, sms)[1]
                  and n % PA.plan(b, h, kh, n, sms)[1])
    for pp in (ragged, 1):
        cases.append((f"pages_{pp}", (b, h, kh, d, pp, ps),
                      [0, 1, ps, pp * ps, pp * ps + 5, 3, ps + 1,
                       max(pp * ps - 1, 1)], ("f32", "bf16")))
    cases.append(("tiles_s64_d256", (3, 8, 2, 256, 3, 64), [1, 192, 100],
                  ("f32", "bf16")))
    for shape in ((4, 32, 1, 64, 6, 16), (3, 32, 2, 128, 5, 16),
                  (2, 22, 2, 64, 3, 32)):
        b, h, kh, d, pp, ps = shape
        cases.append((f"heads_{h // kh}", shape,
                      [0, 1, pp * ps, 17][:b] + [17] * max(b - 4, 0),
                      ("f32", "bf16")))
    return cases


def phase_paged_kernel(serve_lens) -> dict:
    """``paged_attention`` against its plain twin on the card, at the
    reference's test shapes in f32 and bf16 and at the serving shape (with
    the serving phase's prompt lengths); the padding-page invariance; the
    tests' edge cases; bitwise repeatability; and, per shape, the device
    time of every device operation a call issues beside the bound, the
    wrapper's host time per call and the library call."""
    import torch
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import paged_attention as PA

    sms = PA.sm_count(torch.device("cuda"))
    shapes = [(f"{n}_{dt}", shp, dt) for n, shp in PAGED_SHAPES.items()
              for dt in ("f32", "bf16")]
    pages = -(-(SERVE["prompt_hi"] + SERVE["max_new"]) // SERVE["page_size"])
    shapes.append(("serving_f32", (SERVE["live"], 14, 2, 64, pages,
                                   SERVE["page_size"]), "f32"))
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}

    def vs_twin(name, args, ps, dt):
        out = K.paged_attention(*args, page_size=ps)
        twin = K.paged_attention_ref(*args, page_size=ps)
        torch.cuda.synchronize()
        err = float((out.float() - twin.float()).abs().max())
        tol = PAGED_TOL[dt]
        ok = bool(torch.allclose(out.float(), twin.float(), **tol))
        check(ok, f"paged_attention {name}: kernel != twin, max err {err} "
                  f"(tolerance {tol})")
        return err, tol, twin

    rec = {}
    for name, (b, h, kh, d, pp, ps), dt in shapes:
        lens = serve_lens if name.startswith("serving") else None
        args = _paged_case(b, h, kh, d, pp, ps, dts[dt], seed=b * 100 + h,
                           lens=lens)
        err, tol, twin = vs_twin(name, args, ps, dt)
        lib = _paged_library(*args, ps)
        lib_err = float((lib.float() - twin.float()).abs().max())
        # every device operation of the wrapper's call, not only the
        # kernel: a memset or a second kernel would count here
        ms = device_ms(lambda: K.paged_attention(*args, page_size=ps))
        call_ms = time_cuda(lambda: K.paged_attention(*args, page_size=ps))
        plain_ms = device_ms(lambda: K.paged_attention_ref(*args,
                                                           page_size=ps))
        library_ms = device_ms(lambda: _paged_library(*args, ps))
        gb, n_split, per = PA.plan(b, h, kh, pp, sms)
        # least work: each live token's K and V rows once, q, the output,
        # the table and the lengths; 4*H*D flops per live token (q.k and
        # p*v), at the rate of the inputs' type
        live = int(args[4].clamp(max=pp * ps).sum())
        elt = args[0].element_size()
        nbytes = live * kh * d * 2 * elt + 2 * b * h * d * elt \
            + b * pp * 4 + b * 4
        nops = 4 * live * (h // kh) * kh * d
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / (CORE_OPS_PER_S if dt == "f32"
                        else BF16_OPS_PER_S) * 1e3
        rec[name] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                         library_ms=library_ms, max_abs_err=err,
                         library_err=lib_err, bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations", shape=[b, h, kh, d, pp, ps],
                         dtype=dt, splits=n_split, split_pages=per)
        log(f"[kernels] paged_attention {name} B={b} H={h} KH={kh} D={d} "
            f"PP={pp} S={ps}: max |kernel - twin| {err:.3e} (tolerance "
            f"{tol}); {n_split} splits of {per} pages "
            f"({b * h // gb * n_split} blocks on {sms} SMs); "
            f"{ms * 1e3:.3f} us on the device per "
            f"call, bound {rec[name]['bound_ms'] * 1e3:.4f} us "
            f"({rec[name]['bound_by']}); one wrapper call back to back "
            f"{call_ms * 1e3:.2f} us; twin {plain_ms * 1e3:.3f} us; "
            f"gather + SDPA {library_ms * 1e3:.3f} us (max |lib - twin| "
            f"{lib_err:.3e})")

    # the tests' edge cases against the twin
    for name, (b, h, kh, d, pp, ps), lens, dtypes in _paged_edge_cases(sms):
        for dt in dtypes:
            args = _paged_case(b, h, kh, d, pp, ps, dts[dt], seed=pp,
                               lens=lens)
            err, tol, _ = vs_twin(f"{name}_{dt}", args, ps, dt)
            log(f"[kernels] paged_attention {name}_{dt} B={b} H={h} KH={kh} "
                f"D={d} PP={pp} S={ps} lens {lens}: max |kernel - twin| "
                f"{err:.3e} (tolerance {tol})")

    # the splits merge in a fixed order: repeated calls are bitwise equal
    b, h, kh, d, pp, ps = rec["serving_f32"]["shape"]
    args = _paged_case(b, h, kh, d, pp, ps, torch.float32, seed=1,
                       lens=serve_lens)
    outs = [K.paged_attention(*args, page_size=ps) for _ in range(3)]
    torch.cuda.synchronize()
    check(all(torch.equal(outs[0], o) for o in outs[1:]),
          "paged_attention: repeated calls on the same inputs differ")
    log("[kernels] paged_attention: 3 calls at the serving shape are "
        "bitwise equal")

    # positions at or past seq_len never count: scrambling the fully
    # masked tail pages leaves the output unchanged
    q, kp, vp, pt, sl = _paged_case(2, 4, 2, 32, 4, 8, torch.float32, 0,
                                    lens=[9, 17])
    pt2 = pt.clone()
    pt2[0, 2:] = (pt2[0, 2:] + 5) % kp.shape[0]
    pt2[1, 3:] = (pt2[1, 3:] + 3) % kp.shape[0]
    o1 = K.paged_attention(q, kp, vp, pt, sl, page_size=8)
    o2 = K.paged_attention(q, kp, vp, pt2, sl, page_size=8)
    torch.cuda.synchronize()
    err = float((o1 - o2).abs().max())
    check(err <= 1e-6, f"paged_attention padding pages changed the output "
                       f"by {err}")
    log(f"[kernels] paged_attention ignores padding pages (max diff "
        f"{err:.1e})")
    return rec


def _run_fig3a(timer, read_pct: int = 50):
    import numpy as np
    import torch
    from repro_torch.api import LocalBackend
    from repro_torch.core.balancer import Balancer
    from repro_torch.core.oracle import OracleList
    from repro_torch.core.traverse import probe_batch
    from repro_torch.data.ycsb import load_phase, mixed_phase
    from repro_torch.kernels import ops as K

    load_kinds, load_keys = load_phase(2000, 8000, seed=1)
    kinds, keys = mixed_phase(4000, 8000, read_pct / 100, seed=2)
    expected = FIG3A_EXPECTED if read_pct == 50 else FIG3A_R10_EXPECTED
    what = f"fig3a r{read_pct}"
    backend = LocalBackend(bench_cfg(), device="cuda", timer=timer)
    bal = Balancer(backend)
    K.hybrid_search.launches = 0
    K.refresh_walk.launches = 0
    probe_batch.steps = 0
    drive_backend(backend, load_kinds, load_keys, 64, balancer=bal)
    load_rounds = backend.stats["rounds"]
    settle(backend, bal)
    settle_rounds = backend.stats["rounds"]
    if timer is not None:
        timer.reset()
    mix_steps0 = probe_batch.steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    drive_backend(backend, kinds, keys, 64, balancer=bal)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = K.hybrid_search.launches
    refresh_launches = K.refresh_walk.launches
    walk_steps = probe_batch.steps

    oracle = OracleList()
    oracle.apply_batch(load_kinds.tolist(), load_keys.tolist())
    oracle.apply_batch(kinds.tolist(), keys.tolist())
    got = backend.all_keys()
    check(got == sorted(oracle.snapshot()),
          f"{what}: final key set differs from the sequential oracle")
    st = backend.stats
    counts = dict(rounds=st["rounds"], load_rounds=load_rounds,
                  settle_rounds=settle_rounds, fast_hits=st["fast_hits"],
                  mut_hits=st["mut_hits"], blk_hits=st["blk_hits"],
                  sublists=sum(1 for e in backend.sublists(0)
                               if e["owner"] == 0), keys=len(got))
    check(counts == expected,
          f"{what}: counts {counts} != reference {expected}")
    check(launches > 0 and counts["blk_hits"] > 0,
          f"{what}: hybrid_search launched {launches} times, blk_hits "
          f"{counts['blk_hits']}: the main path did not reach the kernel")
    check(read_pct != 50 or walk_steps == FIG3A_WALK_STEPS < 10559,
          f"{what}: the pointer walk took {walk_steps} steps, not the "
          f"CPU's {FIG3A_WALK_STEPS}")
    # one server with the block probe: one refresh launch a round
    check(refresh_launches == st["rounds"],
          f"{what}: refresh_walk launched {refresh_launches} times over "
          f"{st['rounds']} rounds")
    mix_rounds = st["rounds"] - settle_rounds
    return dict(ops_per_s=len(kinds) / dt, seconds=dt,
                mix_rounds=mix_rounds, launches=launches,
                refresh_launches=refresh_launches, counts=counts,
                walk_steps=walk_steps, mix_walk_steps=walk_steps - mix_steps0,
                backend=backend, kinds=kinds, keys=keys)


def phase_fig3a() -> dict:
    from repro_torch.timing import PhaseTimer
    plain = _run_fig3a(None)
    log(f"[fig3a] r50 block probe: {plain['ops_per_s']:.1f} ops/s over the "
        f"mix ({plain['mix_rounds']} rounds, {plain['seconds']:.3f} s, "
        f"{1e3 * plain['seconds'] / plain['mix_rounds']:.3f} ms/round); "
        f"counts equal the reference: {plain['counts']}; hybrid_search "
        f"launches over load+settle+mix: {plain['launches']}; walk steps "
        f"{plain['walk_steps']} (= FIG3A_WALK_STEPS), "
        f"{plain['mix_walk_steps']} of them in the mix")
    timer = PhaseTimer("cuda")
    timed = _run_fig3a(timer)
    for k in ("backend", "kinds", "keys"):
        plain.pop(k)
        timed.pop(k)
    bd = breakdown(timer, timed["mix_rounds"])
    per_step = walk_ms_per_step(timer, timed["mix_walk_steps"],
                                timed["mix_rounds"])
    log(f"[fig3a] with the phase timer: {timed['ops_per_s']:.1f} ops/s; "
        f"per-round ms over the mix: {json.dumps(bd)}; round "
        f"{1e3 * timed['seconds'] / timed['mix_rounds']:.3f} ms; "
        f"probe_batch {per_step}")
    return dict(plain=plain, timed=timed, breakdown=bd)


def skiplist_digest(load_res, mix_res, sl) -> str:
    """SHA-256 over a skip-list run's results (load, then mix) and every
    field of its final ``SkipList`` (either package's), each leaf's
    shape, dtype and bytes."""
    import hashlib
    import numpy as np
    h = hashlib.sha256()
    for leaf in (load_res, mix_res, *sl):
        if hasattr(leaf, "detach"):
            leaf = leaf.detach().cpu().numpy()
        arr = np.array(leaf, order="C")
        h.update(f"{arr.shape}{arr.dtype}".encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def skiplist_run(read_pct: int, device="cuda") -> dict:
    """``benchmarks/run.py::fig3a``'s skip-list row: ``SKIP``'s list, the
    load in one ``apply_batch``, the r``read_pct`` mix in batches, timed
    from the first batch to the last with a device sync. Every result and
    the level-0 chain must equal the sequential oracle's."""
    import numpy as np
    import torch
    from repro_torch.core import skiplist as SL
    from repro_torch.core.oracle import OracleList
    from repro_torch.data.ycsb import load_phase, mixed_phase

    load_kinds, load_keys = load_phase(2000, 8000, seed=1)
    kinds, keys = mixed_phase(4000, 8000, read_pct / 100, seed=2)
    levels, bs = SKIP["levels"], SKIP["batch"]
    sl = SL.init(SKIP["capacity"], levels, device=device)
    sl, r_load = SL.apply_batch(sl, load_kinds, load_keys, levels)
    _sync(device)
    t0 = time.perf_counter()
    res = []
    for i in range(0, len(kinds), bs):
        sl, r = SL.apply_batch(sl, kinds[i:i + bs], keys[i:i + bs], levels)
        res.append(r)
    _sync(device)
    dt = time.perf_counter() - t0
    res = torch.cat(res)

    what = f"skiplist r{read_pct}"
    oracle = OracleList()
    check(r_load.cpu().bool().tolist()
          == oracle.apply_batch(load_kinds.tolist(), load_keys.tolist()),
          f"{what}: a load result differs from the sequential oracle's")
    check(res.cpu().bool().tolist()
          == oracle.apply_batch(kinds.tolist(), keys.tolist()),
          f"{what}: a mix result differs from the sequential oracle's")
    nxt, key = sl.nxt[0].cpu().numpy(), sl.key.cpu().numpy()
    chain, node = [], int(nxt[SL.HEAD])
    while node != SL.NIL and len(chain) <= len(key):
        chain.append(int(key[node]))
        node = int(nxt[node])
    check(chain == sorted(oracle.snapshot()),
          f"{what}: the level-0 chain differs from the oracle's key set")
    return dict(ops_per_s=len(kinds) / dt, seconds=dt, sl=sl,
                keys=len(chain),
                digest=skiplist_digest(r_load, res, sl))


def phase_fig3a_skip(f3: dict) -> dict:
    """fig3a's DiLi-against-skip-list rows: the skip list at r10, r50 and
    r90 against ``SKIPLIST_EXPECTED`` and the oracle, DiLi with the block
    probe at r10 against ``FIG3A_R10_EXPECTED``; DiLi's r50 side is
    ``[fig3a]``'s run."""
    dili10 = _run_fig3a(None, read_pct=10)
    for k in ("backend", "kinds", "keys"):
        dili10.pop(k)
    log(f"[fig3a_skip] DiLi r10 block probe: {dili10['ops_per_s']:.1f} "
        f"ops/s over the mix ({dili10['mix_rounds']} rounds, "
        f"{dili10['seconds']:.3f} s); counts equal the reference: "
        f"{dili10['counts']}; hybrid_search launches {dili10['launches']}, "
        f"walk steps {dili10['walk_steps']}")
    skip = {}
    for p in (10, 50, 90):
        r = skip[p] = skiplist_run(p)
        check(r["digest"] == SKIPLIST_EXPECTED[p],
              f"skiplist r{p}: digest {r['digest']} != reference "
              f"{SKIPLIST_EXPECTED[p]}")
        check(all(t.device.type == "cuda" for t in r.pop("sl")),
              f"skiplist r{p}: the state is not on the card")
        log(f"[fig3a_skip] skiplist_r{p}_ops_per_s {r['ops_per_s']:.1f} "
            f"({r['seconds']:.3f} s for 4000 ops, {r['keys']} keys); "
            f"results, chain and state digest equal the reference's")
    ratios = {10: dili10["ops_per_s"] / skip[10]["ops_per_s"],
              50: f3["plain"]["ops_per_s"] / skip[50]["ops_per_s"]}
    for p, v in ratios.items():
        log(f"[fig3a_skip] dili_over_skip_r{p} {v:.4f}")
    return dict(dili_r10=dili10, skip=skip, dili_over_skip=ratios)


def phase_client() -> None:
    import numpy as np
    from repro_torch.api import local_client
    from repro_torch.core.balancer import Balancer
    from repro_torch.core.oracle import OracleList
    from repro_torch.core.types import (DiLiConfig, OP_FIND, OP_INSERT,
                                        OP_REMOVE)

    cfg = DiLiConfig(num_shards=1, pool_capacity=4096, max_sublists=32,
                     max_ctrs=32, max_scan=4096, batch_size=16,
                     mailbox_cap=256, split_threshold=48, block_probe=True)
    client = local_client(cfg, device="cuda")
    client.balance = Balancer(client.backend)
    rng = np.random.default_rng(9)
    n = 400
    kinds = rng.choice([OP_FIND, OP_INSERT, OP_REMOVE], n,
                       p=[0.4, 0.4, 0.2]).tolist()
    keys = rng.integers(1, 300, n).tolist()
    futs = client.submit(kinds, keys)
    client.settle()
    got = [f.result(wait=False) for f in futs]
    oracle = OracleList()
    check(got == oracle.apply_batch(kinds, keys),
          "client: a future's result differs from the sequential oracle")
    check(client.all_keys() == sorted(oracle.snapshot()),
          "client: key set differs from the sequential oracle")
    log(f"[client] {n} ops through DiLiClient futures match the oracle; "
        f"stats {json.dumps(client.stats)}")


def phase_scale(n_keys: int, timed_rounds: int) -> dict:
    """Load, settle and an untimed r50 mix (ops/s) checked against the
    oracle; then ``timed_rounds`` more rounds of the same mix under the
    phase timer (the breakdown)."""
    import torch
    from repro_torch.api import LocalBackend
    from repro_torch.core.balancer import Balancer
    from repro_torch.core.oracle import OracleList
    from repro_torch.core.traverse import probe_batch
    from repro_torch.data.ycsb import load_phase, mixed_phase
    from repro_torch.kernels import ops as K
    from repro_torch.timing import PhaseTimer

    key_space = 1 << 21
    cfg = bench_cfg(pool_capacity=1 << 21, max_sublists=16384,
                    max_ctrs=16384)
    load_kinds, load_keys = load_phase(n_keys, key_space, seed=1)
    kinds, keys = mixed_phase(n_keys, key_space, 0.5, seed=2)
    backend = LocalBackend(cfg, device="cuda")
    bal = Balancer(backend)
    K.hybrid_search.launches = 0
    probe_batch.steps = 0
    t0 = time.perf_counter()
    drive_backend(backend, load_kinds, load_keys, 64, balancer=bal)
    t_load = time.perf_counter() - t0
    load_rounds = backend.stats["rounds"]
    settle(backend, bal)
    settle_rounds = backend.stats["rounds"]
    mix_steps0 = probe_batch.steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    drive_backend(backend, kinds, keys, 64, balancer=bal)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = K.hybrid_search.launches
    walk_steps = probe_batch.steps

    oracle = OracleList()
    oracle.apply_batch(load_kinds.tolist(), load_keys.tolist())
    oracle.apply_batch(kinds.tolist(), keys.tolist())
    got = backend.all_keys()
    check(got == sorted(oracle.snapshot()),
          "scale: final key set differs from the sequential oracle")
    st = dict(backend.stats)
    mix_rounds = st["rounds"] - settle_rounds
    sub = sum(1 for e in backend.sublists(0) if e["owner"] == 0)
    check(launches > 0 and st["blk_hits"] > 0,
          f"scale: hybrid_search launched {launches} times, blk_hits "
          f"{st['blk_hits']}")
    log(f"[scale] {n_keys} keys loaded into 2**21-node pool, "
        f"{sub} sublists: load {n_keys / t_load:.1f} ops/s "
        f"({load_rounds} rounds, {t_load:.1f} s), settle "
        f"{settle_rounds - load_rounds} rounds, r50 mix "
        f"{len(kinds) / dt:.1f} ops/s ({mix_rounds} rounds, {dt:.1f} s, "
        f"{1e3 * dt / mix_rounds:.3f} ms/round); fast_hits "
        f"{st['fast_hits']} mut_hits {st['mut_hits']} blk_hits "
        f"{st['blk_hits']}; launches {launches}; walk steps {walk_steps} "
        f"({walk_steps - mix_steps0} in the mix)")

    # the breakdown, from a window after the measured mix
    timer = PhaseTimer("cuda")
    backend.cluster.timer = timer
    r0, s0 = backend.stats["rounds"], probe_batch.steps
    n = 64 * timed_rounds
    t0 = time.perf_counter()
    drive_backend(backend, kinds[:n], keys[:n], 64, balancer=bal)
    torch.cuda.synchronize()
    dt_t = time.perf_counter() - t0
    backend.cluster.timer = None
    rounds_t = backend.stats["rounds"] - r0
    bd = breakdown(timer, rounds_t)
    log(f"[scale] with the phase timer, {rounds_t} more r50 rounds: "
        f"{n / dt_t:.1f} ops/s, round {1e3 * dt_t / rounds_t:.3f} ms; "
        f"per-round ms: {json.dumps(bd)}; probe_batch "
        f"{walk_ms_per_step(timer, probe_batch.steps - s0, rounds_t)}")
    return dict(ops_per_s=len(kinds) / dt, launches=launches,
                walk_steps=walk_steps)


def phase_rebalance() -> dict:
    """``benchmarks/run.py::rebalance`` part A on the card: one Move of a
    125-key sublist between two servers at K = 1, 4, 16, 32. The Move's
    rounds must equal the reference's and the keys the inserted set."""
    import torch
    from repro_torch.core.sim import Cluster
    from repro_torch.core.types import DiLiConfig, OP_INSERT
    from repro_torch.timing import PhaseTimer
    rec = {}
    for k, want in REBALANCE_EXPECTED.items():
        r = rebalance_move(Cluster, DiLiConfig, OP_INSERT, k,
                           sync=torch.cuda.synchronize, device="cuda")
        cl = r.pop("cluster")
        check(r["ok"], f"rebalance K={k}: the Move was refused")
        check(r["rounds"] == want,
              f"rebalance K={k}: the Move took {r['rounds']} rounds, the "
              f"reference {want}")
        check(r["keys_ok"], f"rebalance K={k}: keys differ from the "
                            f"inserted set after the Move")
        check(all(e["owner"] == 1 for s in range(2)
                  for e in cl.sublists(s)),
              f"rebalance K={k}: server 1 does not own the sublist")
        # the same Move again under the per-phase timer (its syncs make
        # it slower): the round's breakdown, replay_prepass included
        timer = PhaseTimer("cuda")
        t = rebalance_move(Cluster, DiLiConfig, OP_INSERT, k,
                           sync=torch.cuda.synchronize, device="cuda",
                           timer=timer)
        check(t["rounds"] == want, f"rebalance K={k}: the timed Move took "
                                   f"{t['rounds']} rounds")
        total = t["cluster"].round_no
        rec[k] = dict(rounds=r["rounds"], ms=1e3 * r["seconds"],
                      move_hits=cl.stats["move_hits"],
                      breakdown=breakdown(timer, total))
        log(f"[rebalance] K={k}: Move in {r['rounds']} rounds (= the "
            f"reference's), {1e3 * r['seconds']:.1f} ms, "
            f"{1e3 * r['seconds'] / r['rounds']:.2f} ms per round; "
            f"move_hits {cl.stats['move_hits']}; keys equal the inserted "
            f"set; timed run (load + Move, {total} rounds) "
            f"{1e3 * t['seconds']:.1f} ms for the Move, per-round ms "
            f"{json.dumps(rec[k]['breakdown'])}")
    return rec


def fig3b4_run(backend, timer) -> dict:
    """fig3b's load, settle and r50 mix on ``backend`` (the balancer every
    4th round), ``timer`` reset after the settle: the ops' results, the
    counts, the seconds of load + settle and of the mix, the per-round
    breakdowns, the pre-pass walk's steps in the mix, and
    ``hybrid_search``'s launches in all and per server."""
    from repro_torch.core import traverse
    from repro_torch.core.balancer import Balancer
    from repro_torch.kernels import ops as K

    (load_kinds, load_keys), (kinds, keys) = fig3b4_workload()
    bal = Balancer(backend)
    ops = []
    K.hybrid_search.launches = 0
    with ShardLaunches() as per_server:
        t0 = time.perf_counter()
        drive_backend(backend, load_kinds, load_keys, 64, balancer=bal,
                      log=ops)
        load_end = backend.stats["rounds"]
        settle(backend, bal)
        timer.synchronize()
        t_set = time.perf_counter() - t0
        settle_end = backend.stats["rounds"]
        bd_settle = breakdown(timer, settle_end)
        timer.reset()
        steps = traverse.probe_batch.steps
        t0 = time.perf_counter()
        drive_backend(backend, kinds, keys, 64, balancer=bal, log=ops)
        timer.synchronize()
        dt = time.perf_counter() - t0
        steps = traverse.probe_batch.steps - steps
    check(len(ops) == len(load_kinds) + len(kinds),
          f"fig3b4: {len(ops)} results for "
          f"{len(load_kinds) + len(kinds)} ops")
    counts = fig3b4_counts(backend, load_end, settle_end)
    return dict(ops=ops, n_mix=len(kinds), counts=counts, t_set=t_set,
                dt=dt, settle_end=settle_end, bd_settle=bd_settle,
                bd=breakdown(timer, counts["mix_rounds"]), walk_steps=steps,
                launches=K.hybrid_search.launches,
                per_server=dict(per_server))


def phase_fig3b4() -> dict:
    """fig3b's 4-server run (``benchmarks/run.py::fig3b``, block probe
    on): load, settle and the r50 mix under the balancer every 4th round,
    with the per-phase timer on (its syncs are the only difference from
    an untimed run). The key set must agree with the ops' results, the
    counts equal ``FIG3B4_EXPECTED``, and ``hybrid_search`` must launch on
    every server."""
    from repro_torch.api import LocalBackend
    from repro_torch.timing import PhaseTimer

    timer = PhaseTimer("cuda")
    backend = LocalBackend(bench_cfg(num_shards=4), device="cuda",
                           timer=timer)
    r = fig3b4_run(backend, timer)
    counts, per_server, dt = r["counts"], r["per_server"], r["dt"]
    check_against_results("fig3b4", r["ops"], backend.all_keys())
    check(counts == FIG3B4_EXPECTED,
          f"fig3b4: counts {counts} != reference {FIG3B4_EXPECTED}")
    check(all(per_server.get(s, 0) > 0 for s in range(4)),
          f"fig3b4: hybrid_search launches per server {per_server}: not "
          f"every server's pre-pass reached the kernel")
    mix_rounds = counts["mix_rounds"]
    settle_end, t_set = r["settle_end"], r["t_set"]
    log(f"[fig3b4] 4 servers, r50 block probe: {r['n_mix'] / dt:.1f} ops/s "
        f"over the mix ({mix_rounds} rounds, {dt:.3f} s, "
        f"{1e3 * dt / mix_rounds:.3f} ms/round); load + settle "
        f"{settle_end} rounds in {t_set:.1f} s "
        f"({1e3 * t_set / settle_end:.3f} ms/round); counts equal the "
        f"reference: {counts}; hybrid_search launches {r['launches']}, per "
        f"server {dict(sorted(per_server.items()))}")
    log(f"[fig3b4] per-round ms over load + settle (the Moves): "
        f"{json.dumps(r['bd_settle'])}")
    log(f"[fig3b4] per-round ms over the mix: {json.dumps(r['bd'])}; "
        f"{walk_ms_per_step(timer, r['walk_steps'], mix_rounds)}")
    return dict(ops_per_s=r["n_mix"] / dt, ms_per_round=1e3 * dt / mix_rounds,
                settle_ms_per_round=1e3 * t_set / settle_end,
                launches=r["launches"], per_server=per_server,
                breakdown=r["bd"], breakdown_settle=r["bd_settle"],
                counts=counts)


def phase_shardmap4(f3b: dict) -> dict:
    """fig3b4's configuration and workload through the SPMD backend
    (``ShardMapBackend``: the routed round, each server placed on a card
    of its own while there are cards, and folded onto them in turn when
    there are fewer; the Local exchange copies each bucket to its
    destination's card), with ``Balancer`` and ``drive_backend`` as in
    ``[fig3b4]``. The key set agrees with the ops' results, the counts
    equal ``SHARDMAP4_EXPECTED`` and ``hybrid_search`` launches on every
    server; ops/s and ms per round beside ``[fig3b4]``'s, the placement,
    each card's peak memory, and the exchange's bytes per round
    (computed from the placement) beside the ``bucket`` and ``exchange``
    spans. The timer synchronizes the cards the servers are placed on."""
    from repro_torch.api import ShardMapBackend
    from repro_torch.timing import PhaseTimer

    cards = spmd_cards()
    timer = PhaseTimer(cards)
    t0 = time.perf_counter()
    reset_card_peaks(cards)
    backend = ShardMapBackend(bench_cfg(num_shards=4), device="cuda",
                              timer=timer)
    check(backend.placement == cards,
          f"shardmap4: placement {backend.placement} != {cards}")
    log(f"[shardmap4] {placement_note(backend)}")
    r = fig3b4_run(backend, timer)
    peaks = card_peaks_mib(cards)
    xbytes, xcross = exchange_bytes(backend)
    counts, per_server, dt = r["counts"], r["per_server"], r["dt"]
    check_against_results("shardmap4", r["ops"], backend.all_keys())
    check(counts == SHARDMAP4_EXPECTED,
          f"shardmap4: counts {counts} != reference {SHARDMAP4_EXPECTED}")
    _launch_check("shardmap4", per_server, range(4))
    mix_rounds = counts["mix_rounds"]
    bd = r["bd"]
    ms = 1e3 * dt / mix_rounds
    log(f"[shardmap4] fig3b4 through ShardMapBackend (placed, Local "
        f"exchange): "
        f"{r['n_mix'] / dt:.1f} ops/s over the mix ({mix_rounds} rounds, "
        f"{dt:.3f} s, {ms:.3f} ms/round) against [fig3b4]'s "
        f"{f3b['ops_per_s']:.1f} ops/s, {f3b['ms_per_round']:.3f} "
        f"ms/round; load + settle {r['settle_end']} rounds in "
        f"{r['t_set']:.1f} s; counts equal the reference's: {counts}; "
        f"stats {json.dumps(backend.stats)}; hybrid_search launches "
        f"{r['launches']}, per server {dict(sorted(per_server.items()))}; "
        f"phase {time.perf_counter() - t0:.1f} s")
    log(f"[shardmap4] per-round ms over the mix: bucket "
        f"{bd.get('bucket', 0.0):.4f}, exchange "
        f"{bd.get('exchange', 0.0):.4f}; all {json.dumps(bd)}; "
        f"{walk_ms_per_step(timer, r['walk_steps'], mix_rounds)}")
    log(f"[shardmap4] exchange per round: {xbytes} bytes into the inboxes, "
        f"{xcross} of them between cards (computed, not measured), "
        f"{bd.get('exchange', 0.0):.4f} ms; peak memory per card (MiB) "
        f"{json.dumps(peaks)}")
    return dict(ops_per_s=r["n_mix"] / dt, ms_per_round=ms,
                launches=r["launches"], per_server=per_server, breakdown=bd,
                counts=counts, placement=[str(d) for d in backend.placement],
                peaks_mib=peaks, exchange_bytes=xbytes,
                exchange_cross_bytes=xcross)


def phase_scale4(n_keys: int) -> dict:
    """Four servers at the paper's capacities per server (2**21 pool
    nodes, 16384 registry entries and counters), else as fig3b4:
    ``n_keys`` loaded keys, the balancer's settle, then as many r50 ops,
    checked against the ops' results. After the settle the owned keys must be
    spread within 1.25x of the mean and each of servers 1-3 must have
    received a Move."""
    import torch
    from repro_torch.api import LocalBackend
    from repro_torch.core.balancer import Balancer
    from repro_torch.data.ycsb import load_phase, mixed_phase
    from repro_torch.kernels import ops as K
    from repro_torch.timing import PhaseTimer

    key_space = 1 << 21
    cfg = bench_cfg(num_shards=4, pool_capacity=1 << 21,
                    max_sublists=16384, max_ctrs=16384)
    load_kinds, load_keys = load_phase(n_keys, key_space, seed=1)
    kinds, keys = mixed_phase(n_keys, key_space, 0.5, seed=2)
    timer = PhaseTimer("cuda")
    backend = LocalBackend(cfg, device="cuda", timer=timer)
    bal = Balancer(backend)
    moves = moves_by_target(backend)
    ops = []
    K.hybrid_search.launches = 0
    with ShardLaunches() as per_server:
        t0 = time.perf_counter()
        drive_backend(backend, load_kinds, load_keys, 64, balancer=bal,
                      log=ops)
        load_end = backend.stats["rounds"]
        settle(backend, bal)
        torch.cuda.synchronize()
        t_set = time.perf_counter() - t0
        settle_end = backend.stats["rounds"]
        owned = owned_keys(backend)
        bd_settle = breakdown(timer, settle_end)
        timer.reset()
        t0 = time.perf_counter()
        drive_backend(backend, kinds, keys, 64, balancer=bal, log=ops)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = K.hybrid_search.launches

    check(len(ops) == 2 * n_keys,
          f"scale4: {len(ops)} results for {2 * n_keys} ops")
    check_against_results("scale4", ops, backend.all_keys())
    spread = max(owned) / (sum(owned) / len(owned))
    check(spread <= 1.25, f"scale4: owned keys {owned} after the settle, "
                          f"max/mean {spread:.3f} > 1.25")
    check(all(moves.get(s, 0) > 0 for s in (1, 2, 3)),
          f"scale4: Moves by target {moves}: a server got none")
    check(all(per_server.get(s, 0) > 0 for s in range(4)),
          f"scale4: hybrid_search launches per server {per_server}")
    st = dict(backend.stats)
    mix_rounds = st["rounds"] - settle_end
    bd = breakdown(timer, mix_rounds)
    log(f"[scale4] {n_keys} keys over 4 servers of 2**21 nodes / 16384 "
        f"entries: load + settle {settle_end} rounds ({load_end} load) in "
        f"{t_set:.1f} s ({1e3 * t_set / settle_end:.3f} ms/round); owned "
        f"keys after the settle {owned} (max/mean {spread:.3f}); Moves by "
        f"target {dict(sorted(moves.items()))}; r50 mix "
        f"{len(kinds) / dt:.1f} ops/s ({mix_rounds} rounds, {dt:.1f} s, "
        f"{1e3 * dt / mix_rounds:.3f} ms/round); stats {json.dumps(st)}; "
        f"hybrid_search launches {launches}, per server "
        f"{dict(sorted(per_server.items()))}")
    log(f"[scale4] per-round ms over load + settle: "
        f"{json.dumps(bd_settle)}")
    log(f"[scale4] per-round ms over the mix: {json.dumps(bd)}")
    backend.cluster.timer = None
    return dict(ops_per_s=len(kinds) / dt, ms_per_round=1e3 * dt / mix_rounds,
                launches=launches, per_server=per_server, moves=moves,
                spread=spread)


def nemesis4_cfg():
    """fig3b4's configuration: ``_bench_cfg(4, block_probe=True)``."""
    return bench_cfg(num_shards=4)


def nemesis4_nemesis():
    """``NEMESIS4``'s wire faults and its one crash, at absolute rounds."""
    from repro_torch.core.net import CrashPlan, NemesisConfig
    crash = NEMESIS4["mix_start"] + NEMESIS4["crash_after"]
    return NemesisConfig(**NEMESIS4["faults"], crashes=(CrashPlan(
        NEMESIS4["crash_shard"], crash, crash + NEMESIS4["down"]),))


def nemesis4_run(device, durability, *, mix_ops: int, timer=None) -> dict:
    """fig3b4's load and r50 mix, all through ``DiLiClient`` (per-key FIFO
    admission makes the sequential oracle exact), the balancer every 4th
    round, over the reliable transport under ``nemesis4_nemesis()``, with
    a WAL and snapshots in ``durability``. Returns the results, the
    oracle's, the round the mix started and the backend."""
    from repro_torch.api import DiLiClient, LocalBackend
    from repro_torch.core.balancer import Balancer
    from repro_torch.core.oracle import OracleList
    from repro_torch.data.ycsb import load_phase, mixed_phase

    backend = LocalBackend(nemesis4_cfg(), nemesis=nemesis4_nemesis(),
                           durability=durability, device=device, timer=timer)
    client = DiLiClient(backend, balance=Balancer(backend), balance_every=4)
    oracle = OracleList()
    load_kinds, load_keys = load_phase(1500, 6000, seed=3)
    futs = [client.submit(load_kinds.tolist(), load_keys.tolist())]
    exps = [oracle.apply_batch(load_kinds.tolist(), load_keys.tolist())]
    client.drain(4000, run_balance=True)
    mix_start = backend.cluster.round_no
    t0 = time.perf_counter()
    kinds, keys = mixed_phase(mix_ops, 6000, 0.5, seed=4)
    futs.append(client.submit(kinds.tolist(), keys.tolist()))
    exps.append(oracle.apply_batch(kinds.tolist(), keys.tolist()))
    client.drain(4000, run_balance=True)
    return dict(got=[bool(v) for f in futs for v in f.results(wait=False)],
                want=[bool(v) for e in exps for v in e],
                keys=backend.all_keys(), oracle_keys=sorted(oracle.snapshot()),
                mix_start=mix_start, mix_t0=t0, backend=backend)


def _launch_check(what: str, per_server: dict, servers) -> None:
    check(all(per_server.get(s, 0) > 0 for s in servers),
          f"{what}: hybrid_search launches per server {per_server}: the "
          f"pre-pass of a server of {list(servers)} never reached the "
          f"kernel")


def phase_nemesis() -> dict:
    """The reference's B2 schedule (``tests/test_block_probe.py``): corpus
    entry mixed-p02 on two servers with the block probe, under the lossy
    wire. Results and keys equal the oracle's, the round trace's digest
    equals ``NEMESIS_B2_DIGEST`` and the kernel runs on both servers."""
    import torch
    from repro_torch.core.net import NemesisConfig, trace_digest
    from repro_torch.kernels import ops as K

    e = CORPUS["mixed-p02"]
    K.hybrid_search.launches = 0
    with ShardLaunches() as per_server:
        t0 = time.perf_counter()
        res = nemesis_differential(
            e["seed"], NemesisConfig.from_dict(e["config"]),
            n_ops=e["n_ops"],
            num_shards=2, key_space=300, cfg_overrides={"block_probe": True},
            device="cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = K.hybrid_search.launches
    check_differential("nemesis", res)
    digest = trace_digest(res["trace"])
    check(digest == NEMESIS_B2_DIGEST,
          f"nemesis: round-trace digest {digest} != the reference's "
          f"{NEMESIS_B2_DIGEST}")
    blk = res["backend"].stats["blk_hits"]
    check(blk > 0, "nemesis: the block probe answered no lane")
    _launch_check("nemesis", per_server, range(2))
    log(f"[nemesis] mixed-p02 (seed {e['seed']}, {e['n_ops']} ops) on 2 "
        f"servers, block probe: {res['rounds']} rounds in {dt:.2f} s "
        f"({1e3 * dt / res['rounds']:.3f} ms/round); trace digest equals "
        f"the reference's; blk_hits {blk}; transport {res['net_stats']}, "
        f"wire {res['nemesis_stats']}; hybrid_search launches {launches}, "
        f"per server {dict(sorted(per_server.items()))}")
    return dict(rounds=res["rounds"], seconds=dt, launches=launches,
                per_server=dict(per_server))


class _TimedRecovery:
    """Wraps a ``Durability``'s ``recover`` to time each recovery (the
    snapshot load plus the WAL replay, device synced)."""

    def __init__(self, dur):
        import torch
        self.ms = []
        recover = dur.recover

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = recover(*a, **kw)
            torch.cuda.synchronize()
            self.ms.append(1e3 * (time.perf_counter() - t0))
            return out

        dur.recover = timed


def phase_crash() -> dict:
    """Corpus entry crash-during-move-copy with the block probe: server 1
    dies mid-Move and recovers from its WAL and snapshot on the card. The
    trace digest equals ``CRASH_DIGEST``, one recovery replays rounds, and
    the oracle holds."""
    import tempfile
    import torch
    from repro_torch.core.durability import Durability
    from repro_torch.core.net import NemesisConfig, trace_digest
    from repro_torch.kernels import ops as K

    e = CORPUS["crash-during-move-copy"]
    cfg = nemesis_cfg(block_probe=True)
    with tempfile.TemporaryDirectory(prefix="dili-wal-") as wal_dir:
        dur = Durability(wal_dir, cfg)
        rec = _TimedRecovery(dur)
        nem = NemesisConfig.from_dict(e["config"])
        K.hybrid_search.launches = 0
        with ShardLaunches() as per_server:
            t0 = time.perf_counter()
            res = nemesis_differential(
                e["seed"], nem, n_ops=e["n_ops"],
                cfg_overrides={"block_probe": True}, device="cuda",
                durability=dur)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        launches = K.hybrid_search.launches
    check_differential("crash", res)
    digest = trace_digest(res["trace"])
    check(digest == CRASH_DIGEST,
          f"crash: round-trace digest {digest} != the reference's "
          f"{CRASH_DIGEST}")
    st = dur.stats
    check(st["recoveries"] == 1 and len(rec.ms) == 1,
          f"crash: {st['recoveries']} recoveries, want 1")
    check(st["replayed_rounds"] > 0, "crash: recovery replayed no round")
    # the kernel runs where a round's client lanes meet a valid block:
    # here it must run on the server that crashed and recovered; in this
    # schedule server 3's pre-pass never reaches it
    _launch_check("crash", per_server, (e["config"]["crashes"][0][0],))
    log(f"[crash] crash-during-move-copy (seed {e['seed']}, server 1 down "
        f"rounds 36-70) on 4 servers, block probe: {res['rounds']} rounds "
        f"in {dt:.2f} s ({1e3 * dt / res['rounds']:.3f} ms/round); trace "
        f"digest equals the reference's; 1 recovery in {rec.ms[0]:.1f} ms "
        f"(snapshot load + replay of {st['replayed_rounds']} rounds, "
        f"{rec.ms[0] / st['replayed_rounds']:.2f} ms per replayed round); "
        f"durability {st}; hybrid_search launches {launches}, per server "
        f"{dict(sorted(per_server.items()))}")
    return dict(rounds=res["rounds"], seconds=dt, launches=launches,
                per_server=dict(per_server), recovery_ms=rec.ms[0],
                replayed_rounds=st["replayed_rounds"])


def phase_membership() -> dict:
    """``SCALE_3_5_2`` on ``LocalBackend`` with no nemesis: 3 servers grow
    to 5 and shrink to 2 under client traffic. The trace (its ``mb``
    lines included) digests to ``MEMBERSHIP_DIGEST`` and the final active
    set is the harness's."""
    import torch
    from repro_torch.core.net import trace_digest

    t0 = time.perf_counter()
    res = membership_differential(11, None, n_ops=200, device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check_differential("membership", res)
    check(res["schedule_done"], f"membership: schedule stalled "
                                f"{res['fired']}")
    v = res["view"]
    check(not v["joining"] and not v["draining"]
          and v["active"] == MEMBERSHIP_ACTIVE
          and len(v["active"]) == res["expected_active"],
          f"membership: final view {v}, want active {MEMBERSHIP_ACTIVE}")
    digest = trace_digest(res["trace"])
    check(digest == MEMBERSHIP_DIGEST,
          f"membership: round-trace digest {digest} != the reference's "
          f"{MEMBERSHIP_DIGEST}")
    log(f"[membership] SCALE_3_5_2 (seed 11, 200 ops, capacity 6): "
        f"{res['rounds']} rounds in {dt:.2f} s "
        f"({1e3 * dt / res['rounds']:.3f} ms/round); fired {res['fired']}; "
        f"active {v['active']} at epoch {v['epoch']}; trace digest (mb "
        f"lines included) equals the reference's")
    return dict(rounds=res["rounds"], seconds=dt)


def phase_shardmap_faults() -> dict:
    """The SPMD backend's host-routed round under the lossy wire:
    ``SHARDMAP_NEMESIS`` (the reference's N5) and ``SHARDMAP_CRASH``
    (server 1 killed at round 40 and recovered from its WAL and snapshot
    at 80, in a temporary directory) through ``nemesis_differential`` at
    the harness's shardmap size, the servers placed as in
    ``[shardmap4]``. Each passes the sequential oracle and its round
    trace digests to the reference's. The host routes the outboxes
    through the transport, so no bucket crosses between cards."""
    import tempfile
    from repro_torch.core.durability import Durability
    from repro_torch.core.net import NemesisConfig, trace_digest

    cards = spmd_cards()
    runs = {}
    for name, e, want in (("nemesis", SHARDMAP_NEMESIS,
                           SHARDMAP_NEMESIS_DIGEST),
                          ("crash", SHARDMAP_CRASH, SHARDMAP_CRASH_DIGEST)):
        with tempfile.TemporaryDirectory(prefix="dili-wal-") as wal_dir:
            dur = Durability(wal_dir, nemesis_cfg(backend="shardmap"))
            rec = _TimedRecovery(dur)
            t0 = time.perf_counter()
            crashes = len(e["config"].get("crashes", ()))
            reset_card_peaks(cards)
            res = nemesis_differential(
                e["seed"], NemesisConfig.from_dict(e["config"]),
                n_ops=e["n_ops"], backend="shardmap", device="cuda",
                durability=dur if crashes else None)
            sync_cards(cards)
            dt = time.perf_counter() - t0
        what = f"shardmap_{name}"
        check(res["backend"].placement == cards,
              f"{what}: placement {res['backend'].placement} != {cards}")
        check_differential(what, res)
        digest = trace_digest(res["trace"])
        check(digest == want, f"{what}: round-trace digest {digest} != "
                              f"the reference's {want}")
        check(dur.stats["recoveries"] == crashes == len(rec.ms),
              f"{what}: {dur.stats['recoveries']} recoveries, want "
              f"{crashes}")
        log(f"[shardmap_faults] {name} (seed {e['seed']}, {e['n_ops']} "
            f"ops, 4 servers, host-routed round): {res['rounds']} rounds "
            f"in {dt:.2f} s ({1e3 * dt / res['rounds']:.3f} ms/round); "
            f"trace digest equals the reference's; recovery ms "
            f"{[round(x, 1) for x in rec.ms]}; transport "
            f"{res['net_stats']}, wire {res['nemesis_stats']}")
        peaks = card_peaks_mib(cards)
        log(f"[shardmap_faults] {name}: {placement_note(res['backend'])}; "
            f"exchange host-routed, 0 bytes between cards; peak memory "
            f"per card (MiB) {json.dumps(peaks)}")
        runs[name] = dict(rounds=res["rounds"], seconds=dt,
                          ms_per_round=1e3 * dt / res["rounds"],
                          recovery_ms=rec.ms, peaks_mib=peaks)
    return runs


def phase_nemesis4(f3b: dict) -> dict:
    """fig3b4's configuration under the lossy wire with one crash: the
    load and the r50 mix through ``DiLiClient``, the WAL in a temporary
    directory. Every result and the key set equal the sequential oracle's,
    one recovery, the cluster quiesces; compared with fig3b4's clean mix
    of this run."""
    import tempfile
    import torch
    from repro_torch.core.durability import Durability, DurabilityConfig
    from repro_torch.kernels import ops as K
    from repro_torch.timing import PhaseTimer

    timer = PhaseTimer("cuda")
    with tempfile.TemporaryDirectory(prefix="dili-wal-") as wal_dir:
        dur = Durability(wal_dir, nemesis4_cfg(),
                         DurabilityConfig(snapshot_every=64))
        rec = _TimedRecovery(dur)
        K.hybrid_search.launches = 0
        with ShardLaunches() as per_server:
            t0 = time.perf_counter()
            r = nemesis4_run("cuda", dur, mix_ops=NEMESIS4["mix_ops"],
                             timer=timer)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        launches = K.hybrid_search.launches
    backend = r["backend"]
    cl = backend.cluster
    check(r["mix_start"] == NEMESIS4["mix_start"],
          f"nemesis4: the load ended at round {r['mix_start']}, not "
          f"{NEMESIS4['mix_start']}: the crash would miss the mix")
    check(r["got"] == r["want"], "nemesis4: results differ from the "
                                 "sequential oracle")
    check(r["keys"] == r["oracle_keys"], "nemesis4: the key set differs "
                                         "from the sequential oracle's")
    check(backend.quiescent(), "nemesis4: the cluster did not quiesce")
    check(dur.stats["recoveries"] == 1 and len(rec.ms) == 1,
          f"nemesis4: {dur.stats['recoveries']} recoveries, want 1")
    _launch_check("nemesis4", per_server, range(4))
    rounds = cl.round_no
    mix_rounds = rounds - r["mix_start"]
    dt = t1 - r["mix_t0"]
    bd = breakdown(timer, rounds)
    net, wire = backend.net.stats, backend.net.nemesis.stats
    fsync_ms = 1e3 * dur.fsync_seconds() / rounds
    log(f"[nemesis4] fig3b4 config, 4 servers, lossy wire, server 1 down "
        f"{NEMESIS4['down']} rounds from mix round "
        f"{NEMESIS4['crash_after']}: load + settle {r['mix_start']} rounds "
        f"in {r['mix_t0'] - t0:.1f} s; mix of {NEMESIS4['mix_ops']} ops "
        f"{mix_rounds} rounds in {dt:.2f} s "
        f"({1e3 * dt / mix_rounds:.3f} ms/round, "
        f"{NEMESIS4['mix_ops'] / dt:.1f} ops/s) against fig3b4's clean mix "
        f"{f3b['ms_per_round']:.3f} ms/round, {f3b['ops_per_s']:.1f} ops/s; "
        f"results and keys equal the oracle's")
    log(f"[nemesis4] transport: retransmits {net['retransmits']}, drops "
        f"{wire['dropped']}, dups {wire['duplicated']}, held "
        f"{wire['delayed']}, dup_dropped {net['dup_dropped']}, sent "
        f"{net['sent']}; WAL {dur.wal_bytes()} bytes "
        f"({dur.wal_bytes() / rounds:.0f} per round), fsync "
        f"{fsync_ms:.3f} ms per round ({dur.fsync_count()} fsyncs); "
        f"recovery {rec.ms[0]:.1f} ms, {dur.stats['replayed_rounds']} "
        f"rounds replayed")
    log(f"[nemesis4] per-round ms over all {rounds} rounds: "
        f"{json.dumps(bd)}; hybrid_search launches {launches}, per server "
        f"{dict(sorted(per_server.items()))}; phase {t1 - t0:.1f} s")
    return dict(rounds=rounds, mix_rounds=mix_rounds,
                ms_per_round=1e3 * dt / mix_rounds,
                ops_per_s=NEMESIS4["mix_ops"] / dt, launches=launches,
                per_server=dict(per_server), recovery_ms=rec.ms[0],
                replayed_rounds=dur.stats["replayed_rounds"],
                fsync_ms_per_round=fsync_ms, wal_bytes=dur.wal_bytes(),
                breakdown=bd)


def serve_requests(vocab: int):
    """The serving phase's live requests: prompt lengths and tokens drawn
    from ``SERVE["seed"]``."""
    import numpy as np
    rng = np.random.default_rng(SERVE["seed"])
    lens = rng.integers(SERVE["prompt_lo"], SERVE["prompt_hi"] + 1,
                        SERVE["live"])
    return [rng.integers(1, vocab, n).astype(np.int32) for n in lens]


def _timed(fn, spent):
    """``fn``, adding its wall time to ``spent[0]`` on each call that is
    not nested in another timed call (``spent[1]`` is the depth)."""
    def call(*a, **k):
        spent[1] += 1
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            spent[1] -= 1
            if spent[1] == 0:
                spent[0] += time.perf_counter() - t0
    return call


def settle_index(eng, max_passes: int = 200) -> int:
    """Run a serving engine's balancer over its page index to a fixed
    point, draining the DiLi client after each pass; returns the passes.
    Works on the reference's engine too (the same two calls)."""
    for passes in range(max_passes):
        if not any(eng.balancer.step().values()):
            return passes
        eng.kv.client.drain(600)
    fail(f"the page index did not settle in {max_passes} passes")


def _serve_mode(cfg, params, prompts, mode: str) -> dict:
    """One run of ``benchmarks/run.py::serving`` in ``mode`` (static,
    rescan or range): park the idle sequences, and in the migrating modes
    settle the parked index over the two shards (splits and Moves); admit
    the live ones, one warm step, then the timed steps with a rebalance
    every ``rebalance_every``-th (not in static). Without the settle no
    Move happens in the timed steps: while two entries are still over the
    split threshold, the page index's two background slots go to
    splits."""
    import torch
    from repro_torch.kernels import ops as K
    from repro_torch.serving.engine import Request, ServingEngine
    ps, live, idle = SERVE["page_size"], SERVE["live"], SERVE["idle"]
    pages = -(-(SERVE["prompt_hi"] + SERVE["max_new"]) // ps)
    eng = ServingEngine(cfg, params, page_size=ps,
                        num_pages=(live + idle + 2) * pages, max_batch=live,
                        dili_shards=2, use_kernel=True,
                        refresh_mode="rescan" if mode == "static" else mode,
                        device="cuda")
    stats = eng.kv.backend.stats
    moves = moves_by_target(eng.kv.backend)
    K.paged_attention.launches = 0
    K.hybrid_search.launches = 0
    t0 = time.perf_counter()
    for sid in range(live, live + idle):
        eng.kv.alloc_pages(sid, pages)
    park_rounds = stats["rounds"]
    t_park = time.perf_counter() - t0
    t0 = time.perf_counter()
    passes = settle_index(eng) if mode != "static" else 0
    torch.cuda.synchronize()
    settle_rec = dict(passes=passes, rounds=stats["rounds"] - park_rounds,
                      seconds=time.perf_counter() - t0,
                      moves=sum(moves.values()))
    r_admit = stats["rounds"]
    reqs = [Request(seq_id=i, prompt=p, max_new=SERVE["max_new"])
            for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    for r in reqs:
        eng.admit(r)
    torch.cuda.synchronize()
    t_admit = time.perf_counter() - t0
    admit_rounds = stats["rounds"] - r_admit
    eng.step()                                   # warm step
    torch.cuda.synchronize()
    # the rebalance's own cost: balancer + drain + heal, timed where the
    # engine calls them (nothing else calls them during the timed steps)
    spent = [0.0, 0]
    for obj, fn in ((eng.balancer, "step"), (eng.kv.client, "drain"),
                    (eng.kv, "refresh_seqs"), (eng.kv, "refresh_table")):
        setattr(obj, fn, _timed(getattr(obj, fn), spent))
    step_ms, reb = [], []
    t_all = time.perf_counter()
    for s in range(SERVE["steps"]):
        rebalance = mode != "static" and \
            s % SERVE["rebalance_every"] == SERVE["rebalance_every"] - 1
        r0, subs0 = stats["rounds"], len(eng.kv.backend.sublists(0))
        m0 = sum(moves.values())
        spent[0] = 0.0
        t0 = time.perf_counter()
        eng.step(rebalance=rebalance)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if rebalance:
            reb.append(dict(ms=1e3 * spent[0], step_ms=1e3 * dt,
                            rounds=stats["rounds"] - r0,
                            moves=sum(moves.values()) - m0,
                            sublists=(subs0,
                                      len(eng.kv.backend.sublists(0)))))
        else:
            step_ms.append(1e3 * dt)
    wall = time.perf_counter() - t_all
    for obj, fn in ((eng.balancer, "step"), (eng.kv.client, "drain"),
                    (eng.kv, "refresh_seqs"), (eng.kv, "refresh_table")):
        delattr(obj, fn)
    launches = K.paged_attention.launches
    return dict(eng=eng, reqs=reqs, pages=pages, wall=wall, step_ms=step_ms,
                reb=reb,
                launches=launches, hs_launches=K.hybrid_search.launches,
                tokens=[list(r.out) for r in reqs], stats=dict(stats),
                park=(park_rounds, t_park), admit=(admit_rounds, t_admit),
                sublists=len(eng.kv.backend.sublists(0)),
                moves=sum(x["moves"] for x in reb), settle=settle_rec,
                owned=owned_keys(eng.kv.backend))


def _kernel_vs_gather(eng, steps: int = 4) -> float:
    """``paged_decode_step`` with the kernel and with the gather on
    identical inputs for ``steps`` steps from the engine's live state.
    Logits within 1e-3; the pages written identically where the inputs
    are identical (layer 0, and every cell not written this step), the
    later layers' new K/V within 1e-3 (their inputs carry the two
    attentions' rounding). Returns the largest logit difference."""
    import numpy as np
    import torch
    from repro_torch.serving.paged import paged_decode_step
    cfg, ps = eng.cfg, eng.page_size
    live = [r for r in eng.active if not r.done]
    ids = [r.seq_id for r in live]
    pt = eng.kv.page_table(ids, [eng._pages(r) for r in live])
    sl = np.asarray([len(r.prompt) + len(r.out) - 1 for r in live],
                    np.int32)
    tok = torch.tensor([[r.out[-1]] for r in live], device="cuda")
    kp, vp = eng.kv.k_pages.clone(), eng.kv.v_pages.clone()
    worst = 0.0
    for _ in range(steps):
        ka, va = kp.clone(), vp.clone()
        kb, vb = kp.clone(), vp.clone()
        la, _, _ = paged_decode_step(eng.params, cfg, tok, ka, va, pt, sl,
                                     page_size=ps, use_kernel=True)
        lb, _, _ = paged_decode_step(eng.params, cfg, tok, kb, vb, pt, sl,
                                     page_size=ps, use_kernel=False)
        err = float((la - lb).abs().max())
        worst = max(worst, err)
        check(err <= 1e-3, f"serving: kernel vs gather logits differ by "
                           f"{err}")
        for a, b_, base in ((ka, kb, kp), (va, vb, vp)):
            check(torch.equal(a[0], b_[0]),
                  "serving: layer 0 pages differ between kernel and gather")
            new = (a != base) | (b_ != base)
            check(torch.equal(a[~new], b_[~new]),
                  "serving: a page cell outside this step's writes changed")
            check(float((a - b_).abs().max()) <= 1e-3,
                  "serving: later layers' new K/V differ by more than 1e-3")
        kp, vp = ka, va
        tok = la.argmax(-1, keepdim=True)
        sl = sl + 1
    return worst


def train_smoke_trainer(ckpt_dir: str, device="cuda", fail_at=None,
                        steps=None, arch=TRAIN_SMOKE["arch"]):
    """``tests/test_substrates.py``'s trainer at ``TRAIN_SMOKE``: the
    qwen2_5_3b smoke config (or ``arch``'s), its cell, data seed and
    schedule, a checkpoint every ``ckpt_every`` steps into ``ckpt_dir``,
    and a ``SimulatedFailure`` after step ``fail_at``; ``steps`` in place
    of its 12."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.synthetic import make_train_batch
    from repro_torch.models.config import ShapeCell
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train import (SimulatedFailure, Trainer,
                                           TrainerConfig)
    c = TRAIN_SMOKE
    cfg = get_smoke_config(arch)
    cell = ShapeCell("smoke_train", "train", c["seq"], c["batch"])

    def mk(step):
        return make_train_batch(cfg, cell, seed=c["data_seed"], step=step,
                                dtype=torch.float32, device=device)

    def hook(step):
        if step == fail_at:
            raise SimulatedFailure(f"injected at {step}")

    return Trainer(cfg, cell, AdamWConfig(lr=c["lr"], warmup_steps=c["warmup"],
                                          total_steps=c["schedule"]),
                   TrainerConfig(total_steps=steps or c["total"],
                                 ckpt_every=c["ckpt_every"],
                                 ckpt_dir=ckpt_dir, log_every=100),
                   make_batch=mk, failure_hook=hook, seed=c["init_seed"],
                   device=device)


def bitwise_resume(root: str, device="cuda",
                   arch=TRAIN_SMOKE["arch"]) -> dict:
    """Kill a run of ``train_smoke_trainer`` at ``arch``'s smoke config
    after step ``fail_at`` (after the step-5 checkpoint), restart it from
    the checkpoint, and hold its final weights bit for bit against an
    uninterrupted run's."""
    import os
    import torch
    from repro_torch.runtime.train import SimulatedFailure

    ref = train_smoke_trainer(os.path.join(root, "ref"), device, arch=arch)
    ref.run()
    ft = os.path.join(root, "ft")
    tr = train_smoke_trainer(ft, device, fail_at=TRAIN_SMOKE["fail_at"],
                             arch=arch)
    check(not tr.maybe_resume(), "bitwise resume: a fresh run resumed")
    try:
        tr.run()
        fail("bitwise resume: the injected failure did not fire")
    except SimulatedFailure:
        tr.mgr.wait()
    tr = train_smoke_trainer(ft, device, arch=arch)
    check(tr.maybe_resume() and tr.start_step == TRAIN_SMOKE["ckpt_every"],
          f"bitwise resume: resumed at {tr.start_step}, not at the step-"
          f"{TRAIN_SMOKE['ckpt_every']} checkpoint")
    tr.run()
    a, b = dict(ref.params.named_parameters()), \
        dict(tr.params.named_parameters())
    differ = [n for n in a if not torch.equal(a[n], b[n])]
    check(not differ, f"bitwise resume: {len(differ)} tensors differ from "
          f"the uninterrupted run's, first {differ[:3]}")
    return dict(tensors=len(a), resumed_at=TRAIN_SMOKE["ckpt_every"])


def train_smoke_loss(device="cuda") -> float:
    """Step 1's loss through the port's Trainer at ``TRAIN_SMOKE``, with
    ``convert.numpy_params`` weights: the reference's is
    ``TRAIN_SMOKE_LOSS``."""
    import tempfile
    from repro_torch import convert
    from repro_torch.optim import adamw_init
    with tempfile.TemporaryDirectory() as d:
        tr = train_smoke_trainer(d, device, steps=1)
        tr.params = convert.params_from_numpy(
            convert.numpy_params(tr.cfg, TRAIN_SMOKE["weights_seed"]),
            tr.cfg, device=device)
        tr.opt_state = adamw_init(tr.params)
        return tr.run()["metrics"][0]["loss"]


def phase_train() -> dict:
    """Qwen2-0.5B at full width, f32, random weights from a fixed seed,
    through the port's ``Trainer``: ``TRAIN["steps"]`` steps on one
    synthetic batch (the loss finite, in the reference smoke test's band
    at step 1, lower at the last step), then a timed window and a
    profiler window; then, at the qwen2_5_3b smoke config, the bitwise
    resume and the step-1 loss against the reference's."""
    import math
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_train_batch
    from repro_torch.kernels import ops as K
    from repro_torch.models.config import ShapeCell
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train import Trainer, TrainerConfig

    # full f32 GEMMs, as the reference's CPU numbers are
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = TRAIN
    cfg = get_config(c["arch"])
    cell = ShapeCell("cli", "train", c["seq"], c["batch"])
    batch = make_train_batch(cfg, cell, seed=0, step=0, dtype=torch.float32,
                             device="cuda")
    tokens = c["batch"] * c["seq"]
    K.hybrid_search.launches = 0
    K.paged_attention.launches = 0
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(cfg, cell, AdamWConfig(lr=c["lr"],
                                            warmup_steps=c["warmup"],
                                            total_steps=c["steps"]),
                     TrainerConfig(total_steps=c["steps"],
                                   ckpt_every=c["steps"] + 1, ckpt_dir=d,
                                   log_every=1),
                     make_batch=lambda step: batch, seed=c["seed"],
                     device="cuda")
        n_params = sum(p.numel() for p in tr.params.parameters())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = tr.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = [m["loss"] for m in out["metrics"]]
        check(len(losses) == c["steps"] and all(map(math.isfinite, losses)),
              f"train: losses {losses}")
        lo, hi = 0.1 * math.log(cfg.vocab), 3 * math.log(cfg.vocab) + 2
        check(lo < losses[0] < hi,
              f"train: step-1 loss {losses[0]:.4f} outside ({lo:.2f}, "
              f"{hi:.2f})")
        check(losses[-1] < losses[0],
              f"train: the loss did not fall: {losses}")

        # timed window: the train step alone, host clock with a sync
        step_ms = []
        for _ in range(c["timed"]):
            t1 = time.perf_counter()
            tr.step_fn(tr.params, tr.opt_state, batch)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t1))
        peak = torch.cuda.max_memory_allocated()
        # device activity only: host-side tracing of ~12,000 launches a
        # step would stretch the window's wall time
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for _ in range(c["profiled"]):
                tr.step_fn(tr.params, tr.opt_state, batch)
            torch.cuda.synchronize()
            pwall = time.perf_counter() - t1
    check(K.hybrid_search.launches == 0 and K.paged_attention.launches == 0,
          "train: the training path launched a DiLi or serving kernel")
    ev = _device_events(prof)
    busy = sum(e.self_device_time_total for e in ev) / 1e6
    check(busy > 0, "train: the profiler saw no device time")
    top = sorted(ev, key=lambda e: e.self_device_time_total,
                 reverse=True)[:5]
    ms = statistics.median(step_ms)
    log(f"[train] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab}, {n_params / 1e6:.1f} M f32 weights, remat "
        f"{cfg.remat}; batch {c['batch']} x seq {c['seq']}; losses over "
        f"{c['steps']} steps {[round(x, 4) for x in losses]} "
        f"({wall:.2f} s with the first step's warm-up)")
    log(f"[train] step {ms:.2f} ms median ({min(step_ms):.2f}-"
        f"{max(step_ms):.2f}), {tokens / ms * 1e3:.1f} tokens/s; peak "
        f"memory {peak / 2**30:.2f} GiB (max_memory_allocated); profiler "
        f"window of {c['profiled']} steps: wall {pwall * 1e3:.1f} ms, "
        f"device busy {busy * 1e3:.1f} ms ({100 * busy / pwall:.2f}%), "
        f"{sum(e.count for e in ev) / c['profiled']:.0f} device launches "
        f"per step; top: " + "; ".join(
            f"{e.key[:40]} x{e.count} {e.self_device_time_total / 1e3:.1f} "
            f"ms" for e in top))

    try:
        # atomics-free backward kernels where torch has them; cuBLAS's
        # workspace is pinned in main() before the first GEMM
        torch.use_deterministic_algorithms(True, warn_only=True)
        with tempfile.TemporaryDirectory() as d:
            res = bitwise_resume(d)
    finally:
        torch.use_deterministic_algorithms(False)
    loss = train_smoke_loss()
    check(math.isclose(loss, TRAIN_SMOKE_LOSS, rel_tol=1e-4),
          f"train: step-1 loss {loss!r} at the smoke config != the "
          f"reference's {TRAIN_SMOKE_LOSS!r} (rtol 1e-4)")
    log(f"[train] {TRAIN_SMOKE['arch']} smoke config: killed after step "
        f"{TRAIN_SMOKE['fail_at']}, resumed at step {res['resumed_at']}: "
        f"all {res['tensors']} weight tensors equal the uninterrupted "
        f"run's bit for bit; step-1 loss {loss!r} against the reference's "
        f"{TRAIN_SMOKE_LOSS!r} (rel {abs(loss / TRAIN_SMOKE_LOSS - 1):.2e})")
    return dict(losses=losses, ms_per_step=ms, tokens_per_s=tokens / ms * 1e3,
                peak_bytes=peak, busy_share=busy / pwall,
                launches=dict(
                    hybrid_search=K.hybrid_search.launches,
                    paged_attention=K.paged_attention.launches))


_CHILDREN: list = []


def _stop_children() -> None:
    for proc in _CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def start_dryrun(out_dir: str):
    """The production dry-run's cells, one ``python -m
    repro_torch.launch.dryrun`` subprocess each (its fake process group in
    a process of its own), run one after another on a thread beside the
    other phases; ``phase_dryrun`` joins it. Returns (thread, results:
    cell -> (returncode, seconds, JSON lines, output tail))."""
    import threading
    results = {}

    def run():
        for arch, shape, multi_pod in DRYRUN_CELLS:
            out = os.path.join(out_dir, f"{arch}_{shape}.jsonl")
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--out", out]
            cmd += ["--shape", shape] if shape else []
            cmd += ["--multi-pod"] if multi_pod else []
            t0 = time.perf_counter()
            proc = subprocess.Popen(
                cmd, cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
                env=dict(os.environ, PYTHONPATH=str(SRC)))
            _CHILDREN.append(proc)
            try:
                text, _ = proc.communicate(timeout=DRYRUN_TIMEOUT)
            except subprocess.TimeoutExpired:
                proc.kill()
                text, _ = proc.communicate()
            lines = (pathlib.Path(out).read_text().splitlines()
                     if os.path.exists(out) else [])
            results[(arch, shape, multi_pod)] = (
                proc.returncode, time.perf_counter() - t0,
                [json.loads(x) for x in lines], text[-3000:])

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread, results


def _mesh_train(mesh) -> dict:
    """``TRAIN``'s model, weights and batch for ``MESH_STEPS`` steps
    through ``build_train_step`` (with ``mesh``, or without one when it is
    None): losses and ms per step (host clock, a sync after each)."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_train_batch
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ShapeCell
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime.train import build_train_step
    c = TRAIN
    cfg = get_config(c["arch"])
    cell = ShapeCell("cli", "train", c["seq"], c["batch"])
    batch = make_train_batch(cfg, cell, seed=0, step=0, dtype=torch.float32,
                             device="cuda")
    params = T.init_params(cfg, seed=c["seed"], device="cuda")
    opt = adamw_init(params)
    step = build_train_step(cfg, AdamWConfig(
        lr=c["lr"], warmup_steps=c["warmup"], total_steps=c["steps"]),
        mesh)
    losses, ms = [], []
    for _ in range(MESH_STEPS):
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    meshed = all(isinstance(p, DTensor) for p in params.parameters())
    del params, opt
    _free_card()
    return dict(losses=losses, ms=ms, meshed=meshed, cfg=cfg, cell=cell)


def phase_dryrun(train: dict, dry) -> dict:
    """(a) Qwen2-0.5B at full width, f32, through
    ``build_train_step(mesh=make_host_mesh())`` on a one-card NCCL group:
    its losses against the no-mesh step's (``MESH_RTOL``) from the same
    seed and weights, ms per step beside ``[train]``'s, the model flops'
    share of the card's f32 peak; neither kernel launched. (b) the
    production dry-run's cells (``DRYRUN_CELLS``): each finished with
    finite per-device terms, dili-service with ``DRYRUN_A2A`` all-to-all
    bytes per device."""
    import math
    import torch
    from repro_torch.kernels import ops as K
    from repro_torch.launch.mesh import host_mesh
    from repro_torch.launch.roofline import PEAK_FLOPS_F32, model_flops
    K.hybrid_search.launches = 0
    K.paged_attention.launches = 0
    plain = _mesh_train(None)
    with host_mesh("cuda") as mesh:
        meshed = _mesh_train(mesh)
    check(meshed["meshed"] and not plain["meshed"],
          "dryrun: the mesh step did not run on DTensors")
    check(K.hybrid_search.launches == 0 and K.paged_attention.launches == 0,
          "dryrun: the mesh training path launched a DiLi or serving kernel")
    for a, b in zip(plain["losses"], meshed["losses"]):
        check(math.isfinite(b) and math.isclose(a, b, rel_tol=MESH_RTOL),
              f"dryrun: mesh losses {meshed['losses']} != no-mesh "
              f"{plain['losses']} (rtol {MESH_RTOL})")
    cfg, cell = meshed["cfg"], meshed["cell"]
    ms = statistics.median(meshed["ms"][1:] or meshed["ms"])
    flops = model_flops(cfg, cell)
    log(f"[dryrun] mesh step ({cfg.name}, f32, {cell.global_batch} x "
        f"{cell.seq_len}, 1-card NCCL mesh ('data',)): losses "
        f"{meshed['losses']} = no-mesh {plain['losses']} (rtol "
        f"{MESH_RTOL}); {ms:.2f} ms per step (steps "
        f"{[round(x, 2) for x in meshed['ms']]}; no-mesh "
        f"{[round(x, 2) for x in plain['ms']]}; [train]'s Trainer step "
        f"{train['ms_per_step']:.2f} ms); model_flops {flops:.4e} per "
        f"step = {flops / (ms / 1e3) / PEAK_FLOPS_F32 * 100:.2f}% of the "
        f"f32 peak (67 TFLOP/s, no tensor cores), "
        f"{torch.cuda.get_device_name(0)}")

    thread, results = dry
    t0 = time.perf_counter()
    thread.join(timeout=DRYRUN_TIMEOUT * len(DRYRUN_CELLS))
    waited = time.perf_counter() - t0
    check(not thread.is_alive(), "dryrun: the dry-run cells did not end")
    cells = {}
    for key in DRYRUN_CELLS:
        rc, secs, lines, tail = results.get(key, (None, 0.0, [], ""))
        name = f"{key[0]} x {key[1] or 'round'} x " + \
            ("2x16x16" if key[2] else "16x16")
        check(rc == 0 and len(lines) == 1,
              f"dryrun: {name} failed (rc {rc}):\n{tail}")
        res = lines[0]
        keys = DRYRUN_KEYS[:3] if key[0] == "dili-service" else DRYRUN_KEYS
        vals = [res[k] for k in keys] + list(res["terms_seconds"].values())
        check(all(isinstance(v, (int, float)) and math.isfinite(v)
                  for v in vals) and res["dominant"] in res["terms_seconds"],
              f"dryrun: {name}: terms not finite: {res}")
        if key[0] == "dili-service":
            check(res["collectives"].get("all-to-all") == DRYRUN_A2A,
                  f"dryrun: dili-service all-to-all bytes "
                  f"{res['collectives']} != {DRYRUN_A2A}")
        cells[name] = res
        t = res["terms_seconds"]
        log(f"[dryrun] {name}: {secs:.1f} s ({res['compile_seconds']} s "
            f"traced, seq {res.get('seq_len_traced', '-')}), flops/dev {res['flops_per_device']:.4e}, bytes/dev "
            f"{res['bytes_per_device']:.4e}, coll/dev "
            f"{res['collective_bytes_per_device']:.4e} "
            f"{res['collectives']} (by role "
            f"{res.get('collective_bytes_by_role', {})}); terms compute "
            f"{t['compute']:.4e} / "
            f"memory {t['memory']:.4e} / collective {t['collective']:.4e} "
            f"s -> {res['dominant']}; roofline_mfu_bound "
            f"{res.get('roofline_mfu_bound', float('nan')):.4e}")
    log(f"[dryrun] the cells ran beside the other phases; the phase "
        f"waited {waited:.1f} s for them")
    return dict(losses=meshed["losses"], ms_per_step=ms, cells=cells,
                waited=waited)


def families_smoke_loss(arch: str, device="cuda") -> float:
    """The port's step-1 loss at ``arch``'s smoke config on
    ``FAMILIES_SMOKE``'s weights and batch: the reference's is
    ``FAMILIES_SMOKE_LOSS[arch]``."""
    import torch
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.synthetic import make_train_batch
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ShapeCell
    c = FAMILIES_SMOKE
    cfg = get_smoke_config(arch)
    model = convert.params_from_numpy(
        convert.numpy_params(cfg, c["weights_seed"]), cfg, device=device)
    batch = make_train_batch(cfg, ShapeCell("smoke_train", "train",
                                            c["seq"], c["batch"]),
                             seed=c["data_seed"], step=0,
                             dtype=torch.float32, device=device)
    with torch.no_grad():
        return float(T.forward_train(model, cfg, batch)[0])


def _family_inputs(cfg, b: int, prompt: int, n_decode: int, seed: int):
    """Serving inputs on the card, drawn from ``seed``: the prompt batch
    (``prompt`` positions; vision: half of them patch embeddings), the
    inputs of ``n_decode`` decode steps continuing it, and the full
    prefill of the prompt and the first continuation position."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    n = prompt + n_decode
    if cfg.modality == "audio_stub":
        f = torch.randn((b, n, cfg.d_model), generator=g, device="cuda")
        return dict(prompt={"frame_embeds": f[:, :prompt]},
                    steps=[{"frame_embeds": f[:, prompt + i:prompt + i + 1]}
                           for i in range(n_decode)],
                    full={"frame_embeds": f[:, :prompt + 1]})
    li = prompt // 2 if cfg.modality == "vision_stub" else 0
    tok = torch.randint(0, cfg.vocab, (b, n - li), generator=g,
                        device="cuda")
    lt = prompt - li
    extra = {}
    if li:
        extra["patch_embeds"] = torch.randn((b, li, cfg.d_model),
                                            generator=g, device="cuda")
    return dict(prompt={**extra, "tokens": tok[:, :lt]},
                steps=[{"tokens": tok[:, lt + i:lt + i + 1]}
                       for i in range(n_decode)],
                full={**extra, "tokens": tok[:, :lt + 1]})


def _serve_run(model, cfg, inp, prompt: int, n_decode: int) -> dict:
    """Prefill, then the decode steps: host ms (each call ends in a
    device sync) and every call's logits."""
    import torch
    from repro_torch.models import transformer as T
    b = next(iter(inp["prompt"].values())).shape[0]
    cache = T.init_cache(cfg, b, prompt + n_decode, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = T.forward_serve(
        model, cfg, inp["prompt"], cache,
        torch.zeros((b,), dtype=torch.int32, device="cuda"), decode=False)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    out, step_ms = [logits], []
    for i, step in enumerate(inp["steps"][:n_decode]):
        t0 = time.perf_counter()
        logits, cache = T.forward_serve(
            model, cfg, step, cache,
            torch.full((b,), prompt + i, dtype=torch.int32, device="cuda"),
            decode=True)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        out.append(logits)
    return dict(prefill_ms=prefill_ms, decode_ms=statistics.median(step_ms),
                logits=out, cache=cache)


def _teacher_forced(model, cfg, inp, prompt: int, first=None) -> float:
    """max |decode logits of the first continuation position - the full
    prefill's| over the full prefill's largest |logit|; ``first`` is the
    decode's logits if already computed with ``cfg``."""
    import torch
    from repro_torch.models import transformer as T
    if first is None:
        first = _serve_run(model, cfg, inp, prompt, 1)["logits"][1]
    b = first.shape[0]
    full, _ = T.forward_serve(
        model, cfg, inp["full"], T.init_cache(cfg, b, prompt + 1,
                                              device="cuda"),
        torch.zeros((b,), dtype=torch.int32, device="cuda"), decode=False)
    return float((first - full).abs().max() / full.abs().max())


def _train_family(arch: str, layers: int) -> dict:
    """``FAMILIES["train_steps"]`` steps of the port's ``Trainer`` at
    ``arch``'s published widths and ``layers`` layers, on one batch: the
    losses, host ms per step (steps 2 on; each timed from the start of
    one step's batch to the next's, after a device sync), peak memory,
    and the last step under the CUDA profiler (device launches, busy
    share)."""
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_train_batch
    from repro_torch.models.config import ShapeCell
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train import Trainer, TrainerConfig
    c = FAMILIES
    cfg = get_config(arch).replace(n_layers=layers)
    cell = ShapeCell("families", "train", c["train_seq"], c["train_batch"])
    batch = make_train_batch(cfg, cell, seed=c["seed"], step=0,
                             dtype=torch.float32, device="cuda")
    n = c["train_steps"]
    stamps = []
    prof = profile(activities=[ProfilerActivity.CUDA])

    def mk(step):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        if step == n - 1:
            prof.start()
        return batch

    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(cfg, cell, AdamWConfig(lr=c["lr"], warmup_steps=1,
                                            total_steps=n),
                     TrainerConfig(total_steps=n, ckpt_every=n + 1,
                                   ckpt_dir=d, log_every=1),
                     make_batch=mk, seed=c["seed"], device="cuda")
        n_params = sum(p.numel() for p in tr.params.parameters())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = tr.run()
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        prof.stop()
        peak = torch.cuda.max_memory_allocated()
        del tr
    pwall = stamps[-1] - stamps[-2]
    ev = _device_events(prof)
    busy = sum(e.self_device_time_total for e in ev) / 1e6
    steps = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    ms = statistics.median(steps[1:])
    m = out["metrics"]
    return dict(cfg=cfg, train_params=n_params,
                losses=[x["loss"] for x in m],
                moe_aux=[x["moe_aux"] for x in m],
                moe_z=[x["moe_z"] for x in m], ms_per_step=ms,
                first_step_ms=steps[0],
                tokens_per_s=c["train_batch"] * c["train_seq"] / ms * 1e3,
                peak_bytes=peak, launches_per_step=sum(e.count for e in ev),
                busy_share=busy / pwall)


def _free_card() -> None:
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _kv_quant_run(seed: int) -> dict:
    """Qwen2-0.5B at full depth with the int8 and the f32 KV cache on the
    same weights and teacher-forced tokens: cache bytes, every decode
    step's logits against the f32 cache's, ms per decode step."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    c = KV_QUANT
    cfg = get_config(c["arch"])
    model = T.init_params(cfg, seed=seed, device="cuda")
    inp = _family_inputs(cfg, FAMILIES["serve_batch"], c["prompt"],
                         c["decode"], seed)
    runs = {name: _serve_run(model, dataclasses.replace(cfg, kv_quant=q),
                             inp, c["prompt"], c["decode"])
            for name, q in (("f32", False), ("int8", True))}
    nbytes = {name: sum(t.numel() * t.element_size()
                        for t in r["cache"].values())
              for name, r in runs.items()}
    rel = max(float((q - f).abs().max() / f.abs().max()) for q, f in
              zip(runs["int8"]["logits"], runs["f32"]["logits"]))
    del model, runs
    _free_card()
    return dict(cfg=cfg, bytes=nbytes, ratio=nbytes["int8"] / nbytes["f32"],
                want_ratio=(cfg.hd + 2) / (4 * cfg.hd), rel=rel)


def phase_families() -> dict:
    """Every non-dense family at its published widths, f32, random
    weights from a fixed seed (``FAMILIES``): serving at full depth
    (prefill, teacher-forced decode steps, the first against a full
    prefill), then training at a cut depth through the ``Trainer``; the
    int8 KV cache at Qwen2-0.5B (``KV_QUANT``); each family's smoke-config
    step-1 loss against the reference's (``FAMILIES_SMOKE_LOSS``) and the
    bitwise resume at ``FAMILIES_RESUME``'s smoke config. Neither kernel
    is on these paths."""
    import dataclasses
    import math
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as K
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    c = FAMILIES
    K.hybrid_search.launches = 0
    K.paged_attention.launches = 0
    rec = {}
    for arch, layers in c["archs"].items():
        cfg = get_config(arch)
        torch.cuda.reset_peak_memory_stats()
        model = T.init_params(cfg, seed=c["seed"], device="cuda")
        n_params = sum(p.numel() for p in model.parameters())
        inp = _family_inputs(cfg, c["serve_batch"], c["prompt"],
                             c["decode"], c["seed"])
        srv = _serve_run(model, cfg, inp, c["prompt"], c["decode"])
        check(all(bool(torch.isfinite(x).all()) for x in srv["logits"]),
              f"families: {arch}: non-finite serving logits")
        if cfg.family == "moe":
            # no token dropped in either run: both route every token alike
            m = cfg.moe
            tf = _teacher_forced(model, cfg.replace(moe=dataclasses.replace(
                m, capacity_factor=m.n_experts / m.top_k)), inp, c["prompt"])
        else:
            tf = _teacher_forced(model, cfg, inp, c["prompt"],
                                 first=srv["logits"][1])
        check(tf <= c["tf_rtol"],
              f"families: {arch}: teacher-forced decode differs from the "
              f"full prefill by {tf:.3e} of its largest logit (> "
              f"{c['tf_rtol']})")
        serve_peak = torch.cuda.max_memory_allocated()
        serve_ms = (srv["prefill_ms"], srv["decode_ms"])
        del model, srv
        _free_card()
        trn = _train_family(arch, layers)
        _free_card()
        losses = trn["losses"]
        check(all(map(math.isfinite, losses + trn["moe_aux"] + trn["moe_z"])),
              f"families: {arch}: losses {losses}")
        check(losses[-1] < losses[0],
              f"families: {arch}: the loss did not fall: {losses}")
        rec[arch] = dict(serve_params=n_params, prefill_ms=serve_ms[0],
                         decode_ms=serve_ms[1], tf_err=tf,
                         serve_peak_bytes=serve_peak, **{
                             k: v for k, v in trn.items() if k != "cfg"})
        log(f"[families] {cfg.name} ({cfg.family}, {smi}): serve "
            f"{cfg.n_layers} layers, {n_params / 1e9:.2f} B f32 weights, "
            f"batch {c['serve_batch']}: prefill {c['prompt']} in "
            f"{rec[arch]['prefill_ms']:.1f} ms, decode "
            f"{rec[arch]['decode_ms']:.2f} ms per step, peak "
            f"{serve_peak / 2**30:.2f} GiB, teacher-forced {tf:.2e}; train "
            f"{layers} layers ({trn['train_params'] / 1e9:.2f} B), batch "
            f"{c['train_batch']} x {c['train_seq']}: losses "
            f"{[round(x, 4) for x in losses]}"
            + (f", moe_aux {trn['moe_aux'][0]:.4f}, moe_z "
               f"{trn['moe_z'][0]:.4f}" if cfg.family == "moe" else "")
            + f"; {trn['ms_per_step']:.1f} ms per step (first "
            f"{trn['first_step_ms']:.1f}), {trn['tokens_per_s']:.1f} "
            f"tokens/s, peak {trn['peak_bytes'] / 2**30:.2f} GiB, "
            f"{trn['launches_per_step']} device launches per step, busy "
            f"{100 * trn['busy_share']:.2f}%")

    kv = _kv_quant_run(c["seed"])
    check(math.isclose(kv["ratio"], kv["want_ratio"], rel_tol=1e-12),
          f"families: int8 cache bytes {kv['bytes']} are "
          f"{kv['ratio']:.6f} of the f32 cache's, not (D + 2) / 4D = "
          f"{kv['want_ratio']:.6f}")
    check(kv["rel"] <= KV_QUANT["rel"],
          f"families: int8-cache decode logits differ from the f32 "
          f"cache's by {kv['rel']:.4f} of its largest logit (> "
          f"{KV_QUANT['rel']})")
    log(f"[families] {kv['cfg'].name} kv_quant ({smi}): cache "
        f"{kv['bytes']['int8']} bytes against {kv['bytes']['f32']} f32 "
        f"({kv['ratio']:.6f} = (D + 2) / 4D), prefill {KV_QUANT['prompt']} "
        f"+ {KV_QUANT['decode']} decode steps: logits within "
        f"{kv['rel']:.4f} of the f32 cache's largest")

    smoke = {}
    for arch, want in FAMILIES_SMOKE_LOSS.items():
        smoke[arch] = families_smoke_loss(arch)
        check(math.isclose(smoke[arch], want, rel_tol=1e-4),
              f"families: {arch} smoke step-1 loss {smoke[arch]!r} != "
              f"the reference's {want!r} (rtol 1e-4)")
    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        with tempfile.TemporaryDirectory() as d:
            res = bitwise_resume(d, arch=FAMILIES_RESUME)
    finally:
        torch.use_deterministic_algorithms(False)
    check(K.hybrid_search.launches == 0 and K.paged_attention.launches == 0,
          "families: a model family launched a DiLi or serving kernel")
    log(f"[families] smoke configs' step-1 losses equal the reference's "
        f"(rtol 1e-4): " + ", ".join(
            f"{a} {v:.6f}" for a, v in smoke.items())
        + f"; {FAMILIES_RESUME} smoke config: resumed at step "
        f"{res['resumed_at']}, all {res['tensors']} weight tensors equal "
        f"the uninterrupted run's bit for bit")
    return dict(runs=rec, kv_quant=kv, smoke=smoke,
                launches=dict(hybrid_search=K.hybrid_search.launches,
                              paged_attention=K.paged_attention.launches))


def phase_serving() -> dict:
    """Qwen2-0.5B at full width, f32, random weights from a fixed seed,
    through ``ServingEngine(use_kernel=True, dili_shards=2)`` in the three
    modes of ``benchmarks/run.py::serving``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config("qwen2_0_5b")
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=SERVE["seed"], dtype=torch.float32,
                           device="cuda")
    torch.cuda.synchronize()
    log(f"[serving] {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
        f"{sum(p.numel() for p in params.parameters()) / 1e6:.1f} M "
        f"random f32 weights in {time.perf_counter() - t0:.1f} s")
    prompts = serve_requests(cfg.vocab)
    runs = {}
    for mode in ("static", "rescan", "range"):
        r = runs[mode] = _serve_mode(cfg, params, prompts, mode)
        decode_steps = 1 + SERVE["steps"]
        check(r["launches"] == cfg.n_layers * decode_steps,
              f"serving {mode}: paged_attention launched {r['launches']} "
              f"times, not {cfg.n_layers} layers x {decode_steps} steps")
        toks = SERVE["steps"] * SERVE["live"]
        reb = r["reb"]
        log(f"[serving] {mode}: {toks / r['wall']:.1f} tokens/s over "
            f"{SERVE['steps']} steps ({r['wall']:.3f} s); decode step "
            f"{statistics.median(r['step_ms']):.2f} ms median "
            f"({min(r['step_ms']):.2f}-{max(r['step_ms']):.2f}); "
            + (f"rebalances (balancer + drain + heal) "
               f"{[round(x['ms'], 1) for x in reb]} ms in steps of "
               f"{[round(x['step_ms'], 1) for x in reb]} ms, DiLi rounds "
               f"{[x['rounds'] for x in reb]}, Moves "
               f"{[x['moves'] for x in reb]}, sublists "
               f"{[x['sublists'] for x in reb]}, owned keys per shard "
               f"{r['owned']}; settle of the parked index "
               f"{r['settle']['passes']} passes, {r['settle']['rounds']} "
               f"rounds, {r['settle']['moves']} Moves, "
               f"{r['settle']['seconds']:.1f} s; " if reb else "")
            + f"parking {SERVE['idle']} sequences {r['park'][0]} rounds "
            f"{r['park'][1]:.1f} s, admitting {SERVE['live']} "
            f"{r['admit'][0]} rounds {r['admit'][1]:.1f} s; "
            f"paged_attention launches {r['launches']}, hybrid_search "
            f"{r['hs_launches']}; stats {json.dumps(r['stats'])}")
    static, rescan, ranged = runs["static"], runs["rescan"], runs["range"]
    check(rescan["tokens"] == static["tokens"]
          and ranged["tokens"] == static["tokens"],
          "serving: greedy tokens differ across static/rescan/range")
    for mode in ("rescan", "range"):
        check(runs[mode]["sublists"] > 1,
              f"serving {mode}: the page index never split")
        check(runs[mode]["moves"] > 0,
              f"serving {mode}: no page-index sublist moved between the "
              f"two shards during the decode steps")
    check(ranged["stats"]["range_hits"] > 0,
          "serving range: no RANGE segment was served by the pre-pass")

    eng = static["eng"]
    # two windows of 2 decode steps; the one whose trace holds more device
    # events is kept (a trace can lose events)
    windows = []
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2):
                eng.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ev = _device_events(prof)
        windows.append((sum(e.count for e in ev), wall, ev))
    _, wall, ev = max(windows, key=lambda w: w[0])
    busy = sum(e.self_device_time_total for e in ev) / 1e6
    pa = sum(e.self_device_time_total for e in ev
             if "paged_attention_kernel" in e.key) / 1e6
    per_step = sum(e.count for e in ev) / 2
    top = sorted(ev, key=lambda e: e.self_device_time_total,
                 reverse=True)[:5]
    log(f"[serving] profiler, 2 decode steps: wall {wall * 1e3:.2f} ms, "
        f"device busy {busy * 1e3:.3f} ms ({100 * busy / wall:.2f}% of "
        f"wall), paged_attention {pa * 1e3:.3f} ms; {per_step:.0f} device "
        f"launches per decode step; top: " + "; ".join(
            f"{e.key[:40]} x{e.count} {e.self_device_time_total / 1e3:.3f} ms"
            for e in top))
    worst = _kernel_vs_gather(eng)
    log(f"[serving] kernel vs gather on 4 decode steps: max |logits| "
        f"difference {worst:.3e} (<= 1e-3), layer-0 pages identical")

    # decode to the end: each finished request frees its pages
    r0, t0 = eng.kv.backend.stats["rounds"], time.perf_counter()
    while eng.active:
        eng.step()
    t_free = time.perf_counter() - t0
    parked = SERVE["idle"] * static["pages"]
    check(all(r.done and len(r.out) == SERVE["max_new"]
              for r in static["reqs"])
          and len(eng.kv.free_slots) == eng.kv.num_pages - parked,
          "serving: finished requests did not free their pages")
    log(f"[serving] decoding to {SERVE['max_new']} tokens freed "
        f"{SERVE['live']} sequences' pages: "
        f"{eng.kv.backend.stats['rounds'] - r0} DiLi rounds, "
        f"{t_free:.1f} s")
    lens = [len(p) for p in prompts]
    return dict(runs={m: {k: v for k, v in r.items()
                          if k not in ("eng", "reqs")}
                      for m, r in runs.items()},
                busy_share=busy / wall, launches_per_step=per_step,
                lens=lens, kvg=worst)


# ------------------------------------------------------------------- main

def main() -> None:
    # a fixed cuBLAS workspace, before the first GEMM: [train]'s bitwise
    # resume runs under torch.use_deterministic_algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device: the port's smoke runs on a GPU")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()
    import atexit
    import tempfile
    atexit.register(_stop_children)

    phase_build()
    dry_dir = tempfile.TemporaryDirectory()
    dry = start_dryrun(dry_dir.name)
    krec = phase_kernels()
    rrec = phase_refresh_kernel()
    from repro_torch.configs import get_config
    serve_lens = [len(p) for p in
                  serve_requests(get_config("qwen2_0_5b").vocab)]
    prec = phase_paged_kernel(serve_lens)
    f3 = phase_fig3a()
    t_phase = time.perf_counter()
    f3s = phase_fig3a_skip(f3)
    log(f"[fig3a_skip] the phase in {time.perf_counter() - t_phase:.1f} s")
    phase_client()
    reb = phase_rebalance()
    f3b = phase_fig3b4()
    t_sm = time.perf_counter()
    smap = phase_shardmap4(f3b)
    smf = phase_shardmap_faults()
    log(f"[spmd] the two SPMD phases in {time.perf_counter() - t_sm:.1f} s")
    t_ft = time.perf_counter()
    nem = phase_nemesis()
    crash = phase_crash()
    mship = phase_membership()
    nem4 = phase_nemesis4(f3b)
    log(f"[fault] the four fault-tolerance phases in "
        f"{time.perf_counter() - t_ft:.1f} s")
    t_rep = time.perf_counter()
    zipf = phase_zipf()
    rnem = phase_replica_nemesis()
    log(f"[replication] the two replication phases in "
        f"{time.perf_counter() - t_rep:.1f} s")
    serving = phase_serving()
    t_phase = time.perf_counter()
    train = phase_train()
    log(f"[train] the phase in {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    fam = phase_families()
    log(f"[families] the phase in {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    phase_dryrun(train, dry)
    log(f"[dryrun] the phase in {time.perf_counter() - t_phase:.1f} s")
    scale = phase_scale(SCALE_KEYS, SCALE_TIMED_ROUNDS)
    scale4 = phase_scale4(SCALE4_KEYS)

    k = krec["fig3a"]
    p = prec["serving_f32"]
    kernels = [dict(
        name="hybrid_search", route="cuda",
        source="src/repro_torch/kernels/csrc/hybrid_search.cu",
        replaces="src/repro/kernels/hybrid_search.py:58",
        launches=f3["plain"]["launches"], max_abs_err=k["max_abs_err"],
        launches_fig3a_r10=f3s["dili_r10"]["launches"],
        launches_train=train["launches"]["hybrid_search"],
        launches_families=fam["launches"]["hybrid_search"],
        ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
        bound_by=k["bound_by"], library_ms=None,
        shape=k["shape"], call_ms=k["call_ms"],
        ms_scale_path=krec["scale_path"]["ms"], ms_scale=krec["scale"]["ms"],
        call_ms_scale=krec["scale"]["call_ms"],
        bound_ms_scale=krec["scale"]["bound_ms"],
        launches_scale=scale["launches"],
        launches_fig3b4=f3b["launches"],
        launches_fig3b4_per_server=f3b["per_server"],
        launches_shardmap4=smap["launches"],
        launches_shardmap4_per_server=smap["per_server"],
        launches_scale4=scale4["launches"],
        launches_scale4_per_server=scale4["per_server"],
        launches_nemesis=nem["launches"],
        launches_nemesis_per_server=nem["per_server"],
        launches_crash=crash["launches"],
        launches_crash_per_server=crash["per_server"],
        launches_nemesis4=nem4["launches"],
        launches_nemesis4_per_server=nem4["per_server"],
        launches_zipf=zipf["runs"]["on"]["launches"],
        launches_zipf_per_server=zipf["runs"]["on"]["per_server"],
        launches_zipf_off=zipf["runs"]["off"]["launches"],
        walk_steps_fig3a=f3["plain"]["walk_steps"],
        walk_steps_scale=scale["walk_steps"]), dict(
        name="refresh_walk", route="cuda",
        source="src/repro_torch/kernels/csrc/refresh_walk.cu",
        replaces=None, launches=f3["plain"]["refresh_launches"],
        launches_per_round=f3["plain"]["refresh_launches"]
        / f3["plain"]["counts"]["rounds"],
        max_abs_err=rrec["max_abs_err"], ms=rrec["ms"],
        plain_ms=rrec["plain_ms"], bound_ms=rrec["bound_ms"],
        bound_by=rrec["bound_by"], library_ms=None, shape=rrec["shape"],
        call_ms=rrec["call_ms"], host_ms=rrec["host_ms"],
        plain_call_ms=rrec["plain_call_ms"],
        dependent_load_ms=rrec["step_ms"], longest_walk=rrec["longest"],
        dirty_rows=rrec["dirty"]), dict(
        name="paged_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:29",
        launches=serving["runs"]["range"]["launches"],
        max_abs_err=p["max_abs_err"],
        ms=p["ms"], plain_ms=p["plain_ms"], bound_ms=p["bound_ms"],
        bound_by=p["bound_by"], library_ms=p["library_ms"],
        shape=p["shape"], dtype=p["dtype"], call_ms=p["call_ms"],
        splits=p["splits"], split_pages=p["split_pages"],
        serving_launches_per_step=serving["launches_per_step"],
        launches_all_modes=sum(r["launches"]
                               for r in serving["runs"].values()),
        serving_dili_shards=2,
        serving_moves={m: r["moves"] for m, r in serving["runs"].items()},
        launches_train=train["launches"]["paged_attention"],
        launches_families=fam["launches"]["paged_attention"],
        ms_by_shape={n: r["ms"] for n, r in prec.items()})]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(f"[rebalance] Move rounds by K "
        f"{ {k: r['rounds'] for k, r in reb.items()} }, ms "
        f"{ {k: round(r['ms'], 1) for k, r in reb.items()} }")
    log(f"[fault] nemesis {nem['rounds']} rounds, crash {crash['rounds']} "
        f"(recovery {crash['recovery_ms']:.1f} ms), membership "
        f"{mship['rounds']}, nemesis4 {nem4['rounds']} (mix "
        f"{nem4['ms_per_round']:.3f} ms/round, recovery "
        f"{nem4['recovery_ms']:.1f} ms)")
    log(f"[spmd] shardmap4 on {smap['placement']} "
        f"{smap['ms_per_round']:.3f} ms/round, "
        f"{smap['ops_per_s']:.1f} ops/s against fig3b4's "
        f"{f3b['ms_per_round']:.3f} / {f3b['ops_per_s']:.1f}; "
        f"shardmap_faults nemesis {smf['nemesis']['rounds']} rounds "
        f"({smf['nemesis']['ms_per_round']:.3f} ms/round), crash "
        f"{smf['crash']['rounds']} ({smf['crash']['ms_per_round']:.3f} "
        f"ms/round)")
    log(f"[replication] zipf on/off {zipf['ratio']:.3f}x, "
        f"{zipf['runs']['on']['ms_per_round']:.3f} / "
        f"{zipf['runs']['off']['ms_per_round']:.3f} ms/round, replica_step "
        f"{zipf['runs']['on']['breakdown'].get('replica_step', 0.0):.3f} "
        f"ms/round; replica_nemesis {rnem['rounds']} rounds, rep_hits "
        f"{rnem['rep_hits']}")
    log(f"[fig3a_skip] skiplist ops/s " + ", ".join(
        f"r{p} {r['ops_per_s']:.1f}" for p, r in f3s["skip"].items())
        + "; dili_over_skip " + ", ".join(
            f"r{p} {v:.4f}" for p, v in f3s["dili_over_skip"].items()))
    log(f"[train] {train['ms_per_step']:.2f} ms per step, "
        f"{train['tokens_per_s']:.1f} tokens/s, peak "
        f"{train['peak_bytes'] / 2**30:.2f} GiB, busy "
        f"{100 * train['busy_share']:.2f}%")
    log("[families] " + "; ".join(
        f"{a}: train {r['ms_per_step']:.1f} ms per step, "
        f"{r['tokens_per_s']:.1f} tokens/s, peak "
        f"{r['peak_bytes'] / 2**30:.2f} GiB; decode {r['decode_ms']:.2f} "
        f"ms per step" for a, r in fam["runs"].items()))
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
