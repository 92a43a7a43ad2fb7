#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of d-HNSW once on one NVIDIA GPU.

    python3 chip_smoke.py [--sweep]

Phases, each printing its own lines:

1. device: the card's name, the device count, and ``nvidia-smi``'s name
   and power limit;
2. kernel build: every ``src/repro_torch/kernels/*/csrc/*.cu`` with
   ``nvcc`` for ``sm_90a``;
3. index build on the host: ``sift_like(n=100_000, n_queries=2000)``,
   256 partitions (the paper's geometry, cut as ``reduced`` says);
4. kernels against their plain torch versions on the card at the shapes
   the paths give them (for the gather, the ids of every launch of
   phases 5, 8 and 9, planned as the engine plans them, and of phases
   10-14 and 18, recorded there, with 18b's gist launches also timed
   alone; for
   ``distance_topk``, the throughput benchmark's B=128 x N=4096 and the
   flat f32 twin of ``quant_topk``'s shape; for ``decode_attention``,
   phase 9's first decode call and a long-context shape; for
   ``beam_walk``, every round of phase 5w's batch and 18b's first two
   gist rounds, held on the paths' own inputs), with times
   (CUDA events) beside the bound, the plain version's time and the
   library call's time (for the top-k kernels the cuBLAS product alone);
5. exact search (``mode="full"``, b=4, ef=48, doorbell 16, RDMA fabric,
   the CUDA doorbell gather) for ``search_mode`` graph and scan, one batch
   of 2000 at k=10, held against the same engine with the gather off;
   5w: the graph batch once more, each round's ``beam_walk`` launch held
   against the plain loop on its inputs (phase 4's walk record);
6. int8 flat search (``quant_kernel="auto"``: the CUDA ``quant_topk``
   stage 1), held against ``quant_kernel="ref"``;
7. the throughput benchmark (``benchmarks/torch_throughput.py`` at the
   ``full`` preset, on the index of phase 3): QPS vs batch, cache and
   doorbell ablations, and ``distance_topk`` against its plain version;
   its doorbell-16 row must count what phase 5's scan batch counted;
8. int8 search through the per-pair stage 1 (``benchmarks/
   torch_quant.py``'s per-pair cell: ``quant_kernel="off"``,
   ``cache_frac`` 0.25, ``exact_frac`` 0.25, b=6, doorbell 16) in both
   search modes, 2000 queries in 4 batches, with the CUDA gather, held
   against the same engine with the gather off (in turns);
9. RAG serving at full width: ``RagServeEngine`` with ``qwen3-8b`` (36
   layers, d 4096, 32 query heads over 8 kv heads, vocab 151936; weights
   from a seeded generator on the card) over phase 5's exact-scan engine
   with the CUDA gather, whose 100k vectors are the documents' embeddings
   (240 tokens each): two ``serve`` calls of the same 8 prompts of 64
   tokens (prefill at S = 4 * 240 + 64 = 1024 through the flash path, 32
   greedy decode steps, every layer's decode attention through the CUDA
   ``decode_attention``), equal tokens from both; then a third call
   under ``torch.profiler``: the device's busy share over its decode
   loop;
10. insert at full size, on deep copies of phase 3's region: the
    exact-scan engine of phase 5 and the int8 flat engine of phase 6 each
    insert 256 held-out queries, then a burst of ``ov_cap + 8`` near
    copies of one base row that fills its group's overflow region and
    repacks it; a ``device="cpu"`` engine runs the same inserts.  Gids,
    verb counts and the insert ledger against the charge rule, the
    device region against the host's after the inserts and after the
    repack, the flat view against a fresh sync, routing against the CPU
    engine, self-recall@1, recall@10 against brute force over the grown
    data, and an int8 search at ``rerank_m=256`` (``quant_topk``'s
    large-k route); time an insert split into route, host write and
    device twin, the repack, and the searches after it;
11. bulk load: ``DHNSWEngine.build_streaming`` at ``benchmarks/
    ingest.py``'s full ``run_load`` geometry (20 000 rows, 64
    partitions, 8 chunks) against ``build`` of the same data, both
    serving on the card: meta, regions and a search of 500 queries
    bit-identical, and the ``LoadReport``'s counts;
12. the multi-node pools on phase 3's index, every shard an in-process
    child on the one card: (a) ``pool="sim_rdma"`` in phase 5's exact
    scan and phase 6's int8 flat configurations, bit-identical to
    ``LocalPool`` with equal counted stats, each verb's modeled seconds
    the fabric formula over its charges; (b) ``pool="sharded"`` over 4
    sim-RDMA children on ``benchmarks/torch_pool.py``'s straggler
    fabrics, placements ``round_robin`` and ``freq``, through its zipf
    workload (16 batches of 64), every batch bit-identical to
    ``LocalPool`` and its round trips equal to a count made apart from
    the pool's code, with the per-shard staged bytes, the modeled us a
    query, the gather launches and host syncs a batch; then phase 6's
    int8 flat configuration over 4 children (``quant_topk`` over the
    fanned-out flat view); (c) 3 shards at ``replication=2``: a child
    killed mid-stream, inserts, ``add_shard`` and ``remove_shard``, each
    step bit-identical to ``LocalPool``; (d) ``benchmarks/torch_pool.py
    --smoke`` but its two tables that fork servers, equal to
    ``BENCH_pool.json`` but the wall clock;
13. ``benchmarks/torch_serving.py --smoke``: the counted table equal to
    ``BENCH_serving.json``'s, the wall-clock rows printed (smoke size).
    The engines of 12d and 13 gather through the kernel too;
14. the remote memory pool, the memory nodes host processes on the
    card's machine (``python -m repro_torch.net.server``): (a) one node
    over the loopback bearer and over tcp in phase 5's exact scan and
    phase 6's int8 flat configurations, bit-identical to ``LocalPool``
    with equal counted stats, measured wire bytes equal to the model,
    the flat view over the wire equal to phase 6's and stage 1 through
    ``quant_topk``; (b) three nodes at ``replication=2``, 4 batches of
    500, node 0 killed with SIGKILL after two: bit-identical, one death,
    no lost group, 16 inserts; (c) a durable node (``--data-dir``) at
    ``benchmarks/ingest.py run_recovery``'s 8000 rows takes 64 appends,
    is killed, restarts and is re-attached from its WAL, then serves a
    bit-identical search; (d) ``torch_pool.py --smoke --transport
    --chaos`` and ``torch_ingest.py --smoke``, equal to the baselines but
    the clock.
15. the slice's LM families at full width over phase 5's exact-scan
    engine in phase 9's geometry (8 prompts of 64 tokens, 4 documents of
    240, 32 new tokens): (a) ``RagServeEngine`` with
    ``qwen3-moe-30b-a3b`` (128 experts, top-8; all 48 layers when they
    fit beside the index, else the deepest multiple of 8, printed), two
    calls with equal tokens, the prefill and decode times, the
    decode_attention launches and the share of expert assignments
    dropped at capacity; (b) one call each for ``mamba2-370m``,
    ``zamba2-2.7b``, ``pixtral-12b`` (full depth) and
    ``llama4-scout-17b-a16e`` (depth cut to 4), pixtral's model-level
    prefill with 256 patches, and ``whisper-tiny`` through
    ``model.prefill`` with frames (B=8, enc_seq 1500) and 32 decode
    steps; (c) the six configurations at full width and 2 layers in f32,
    card against CPU on the same weights: greedy tokens equal, logits
    within ``CARD_CPU_TOL``;
16. ``core.distributed.ShardedStore`` over phase 3's store, fetching
    phase 5's first round of spans: 4 gloo ranks (processes) on the one
    card over CUDA tensors, then 1 NCCL rank, each fetch one all-reduce,
    bit-equal to the store's rows;
17. training: (a) ``train_step.make_train_step`` on ``qwen3-8b`` at full
    width cut to 4 layers (f32 masters, grads and AdamW moments: 32.3
    GB), ``train_4k``'s S = 4096, a global batch of 8 in 2 micro-steps,
    one warm-up and 4 timed steps on seeded ``token_stream`` batches:
    the loss, grad norm and lr of each step, s a step, tokens/s, model
    FLOPs over the bf16 peak, peak memory; the first loss within 1.0 of
    ln V; (b) the six families' smoke configs in f32, two steps each
    (one with ``micro_steps = 2``) on the card and on the CPU from the
    same weights, equal at the CPU tests' tolerance; (c) the twin of
    ``test_loss_decreases`` through ``trainer.fit``; (d) (b)'s state
    through a checkpoint, and ``run_with_restarts`` with two injected
    failures against an uninterrupted run; (e)
    ``compressed_grad_reduce`` over 4 gloo ranks and 1 NCCL rank within
    5 % of the f32 mean;
18. the paper's evaluation through the port's twins of the reference's
    benchmarks, every engine with the CUDA gather: (a) the ``quick``
    preset (sift 20k, gist 4k at 960-d, batch 256): Fig. 6
    (``benchmarks/torch_latency_recall.py``: naive, no_doorbell and full
    x top-10, top-1 x ef 1..48), Tables 1-2 (``torch_breakdown.py``) and
    the insert study (``torch_insert.py``), every counted field equal to
    the JAX package's rows in ``benchmarks/torch_reference/
    paper_quick.json`` (a recall within one query's share, the queries
    whose gids differ from a CPU run printed); (b) the ``full`` preset's
    Fig. 6 and Tables 1-2 for sift on phase 3's index and for gist at
    20k x 960 (one host build, timed), each search's wall and host split,
    each dataset's peak device memory: naive's round trips a query equal
    to the route's distinct (query, partition) pairs, no_doorbell's net
    term between naive's and full's, recall@10 at ef 48 on sift of at
    least ``RECALL_FLOOR``; in (a) and (b) every scheme's reads go
    through ``gather_spans``; (c) ``torch_headline.py`` on phase 3's
    index, its full batch equal to phase 5's graph batch in gids and
    counted stats;
19. the mesh: (a) host only, in a subprocess on the fake backend (one
    process playing every rank, nothing on the card):
    ``launch/dryrun.py``'s cells of qwen3-8b and qwen3-moe-30b-a3b x
    train_4k, prefill_32k, decode_32k x the (16, 16) and (2, 16, 16)
    meshes and ``launch/dryrun_dhnsw.py``'s six variants on both, every
    spec and per-device byte count, the decode cells' totals (the
    reference's compiled ``argument_size_bytes``) and the d-HNSW rows'
    collective operand and wire bytes equal to the JAX package's in
    ``benchmarks/torch_reference/dryrun.json``; then, on a host mesh of
    one NCCL rank, (b) ``make_step`` of phase 17a's train cell, its loss,
    metrics and every updated param and moment bit for bit against the
    unmeshed step from the same weights and batch, s a step beside
    17a's; (c) ``make_prefill_step`` and ``make_decode_step`` with
    qwen3-8b at full width and depth, 8 prompts of 1024 tokens and 32
    greedy steps, every token equal to the unmeshed path's, every
    decode layer through ``decode_attention``; (d) ``moe._moe_shardmap``
    over 4 gloo rank processes on the card on (data, model) meshes (1, 4)
    and (2, 2) at qwen3-moe's width (one layer, 8 x 1024 tokens, bf16):
    routing equal to a plain version's in this process and y within the
    bf16 rounding of the sum of the ranks' shares, ms a call; (e)
    ``dryrun_dhnsw.make_step`` run for real at SIFT1M geometry (the 721
    MB f32 / 180 MB int8 store) over 4 gloo ranks on a (1, 4) mesh, all
    six variants: top-k ids equal to a one-rank run's up to ties, the
    counted all-reduce operand bytes equal to the dry run's of the same
    mesh, ms a step; (f) the meshed prefill and decode steps of every
    family over gloo rank processes on the card, each split over
    ``model`` as its placements are: (a) qwen3-8b at full width, 4
    layers, on (1, 4) (its kv cache over its heads), (b) qwen3-moe at
    full width, 4 layers, on (1, 8) (4 kv heads on 8 ranks: the cache
    over its sequence, ``decode_attention``'s partial mode on every
    shard, merged by log-sum-exp), (c) mamba2-370m at full depth,
    zamba2-2.7b at 6 layers (one use of its shared block) and
    whisper-tiny on (1, 4); 8 prompts of 1024 tokens and 8 decode steps,
    the weights drawn from one seed on the card, each meshed step fed
    the unmeshed path's greedy token.  Every path runs in f32 compute
    on the bf16 weights: each step's logits within ``F32_FAMILY_TOL`` of
    that step's max |logit| and each argmax equal wherever the unmeshed
    top-2 gap exceeds that; (b) runs in bf16 compute too, its first
    logits within ``family_bound``; the partial mode's launches counted
    in its wrapper, held against its plain version at the shard's shape
    (and with empty shards), timed beside SDPA.  19a also prints each
    cell's working set, FLOPs and collective bytes beside those of the
    tree whose meshed steps gathered their weights and cache over
    ``model`` (``MESH_GATHERED``) and holds each decode cell's working
    set to twice its arguments and each train cell's FLOPs to twice its
    model FLOPs; each train cell's working set and wire bytes stand
    beside the parent tree's (``MESH_NO_SP``, f5882fe, before sequence
    parallelism): the
    working set at most ``SP_WORKING_SET`` and fallen by at least the
    layer inputs' (tp - 1)/tp, the wire at most ``SP_WIRE`` x that of the
    step with it off; every prefill and decode cell's equal to the parent
    tree's; (g) Megatron
    sequence parallelism in the meshed train step: qwen3-8b at full
    width, 2 layers, 4 x 4096, on (1, 4) gloo rank processes on the card
    in f32 compute on bf16-rounded weights, the loss and grad norm within
    ``SP_TOL`` of the unmeshed step's on the same weights and batch, the
    sequence all-gathers counted on every rank, and the bytes a rank
    keeps allocated between forward and backward at most the unmeshed
    step's less ``SP_KEEP`` x L B S d 4 (tp - 1)/tp;
20. the six twins of ``examples/`` (``examples/torch_*.py``), each a
    subprocess with ``--device cuda``, all exiting 0; then
    ``torch_rag_serve.py``'s ``main`` in this process, its
    ``decode_attention`` launches counted into the kernels' line.

Phases 15-17 run right after phase 9 (the LM phases together, on a
host not yet loaded by the pool phases' servers and threads; 17 once
15's weights are freed), then phase 19 (its train step once 17a's
state is freed), then phase 20, then phase 18, then phases 10-14.  The
training path
launches none of the four kernels: phase 17a reads every count at 0.

Phase 4 runs last: the gather's launches include phase 9's retrieval,
planned from the engine's embedding of the prompts, and the launches of
the searches of phases 10-15 (recorded there, on the buffers they
read), and those of phase 18's twins; ``decode_attention`` is held at
the inputs of phase 9's first
decode call (captured there), of the first decode calls of phase 15's
qwen3-moe (G=8), llama4-scout (G=5), zamba2 (hd=80, G=1) and whisper
(hd=64, G=1), and at a long-context shape (B=16, S=32768); ``quant_topk`` is also held at the flat shape at k = 256 and
1024 and on group-2 codes, and ``distance_topk`` at k = 256.

Each top-k time stands beside the product alone through cuBLAS
(``torch.addmm`` over the same B x n_valid x D in f32, TF32 off), and
beside the device time of each kernel the launch ran (``torch.profiler``):
one kernel a call.

With ``--sweep``, phase 4 also times every launch shape of the kernels on
the same inputs (lines ``[4 sweep]``): ``decode_attention`` at each number
of warps sharing a kv head and of splits, each held against its plain
output, beside SDPA, and at the long shape the card's power draw and
clocks under the wrappers' cut and under SDPA; the gather beside one
contiguous copy of the same bytes; ``quant_topk`` and ``distance_topk``
at every cut (tile x chunks) of each of their shapes, each held against
its plain lists, the card's power and clocks under ``quant_topk`` at the
flat shape, and each of the three calls through copies of the kernel with
parts cut out (``TOPK_CUTS``: no candidates; no epilogue; no barrier or
copies) beside an FMA loop from registers.  The wrappers' launch shapes
(``decode_attention.ops.splits`` and ``warps_per_head``,
``quant_topk.ops.launch_shape``) were set from these lines.

Every kernel's launch counter is set to 0 just before each path is
driven and read just after.  The last lines are the kernels' JSON record
(launches summed over the paths that run each kernel), the
``nvidia-smi`` line, and ``{"ok": true, "device": ...}``.
Without a CUDA device the script exits non-zero and prints no result.
It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import ctypes
import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from benchmarks import (torch_breakdown, torch_common,  # noqa: E402
                        torch_dryrun_reference, torch_headline,
                        torch_ingest, torch_insert, torch_latency_recall,
                        torch_paper_reference, torch_pool, torch_quant,
                        torch_serving, torch_throughput)
from repro_torch import DHNSWEngine, EngineConfig  # noqa: E402
from repro_torch.core import device_store as DS  # noqa: E402
from repro_torch.core import layout as LA  # noqa: E402
from repro_torch.core import meta as ME  # noqa: E402
from repro_torch.core import scheduler as SCH  # noqa: E402
from repro_torch.core import search as S  # noqa: E402
from repro_torch.core.cost_model import RDMA_100G  # noqa: E402
from repro_torch.core.hnsw import HNSWParams, recall_at_k  # noqa: E402
from repro_torch.data.synthetic import sift_like, token_stream  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch import tree as TREE  # noqa: E402
from repro_torch.convert import SPEC_FIELDS  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.beam_walk import ops as BW  # noqa: E402
from repro_torch.kernels.beam_walk.ref import beam_walk_ref  # noqa: E402
from repro_torch.kernels.decode_attention import ops as DA  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref)
from repro_torch.kernels.distance_topk import ops as DO  # noqa: E402
from repro_torch.kernels.distance_topk.ref import distance_topk_ref  # noqa: E402
from repro_torch.kernels.gather_blocks import ops as GO  # noqa: E402
from repro_torch.kernels.gather_blocks.ref import gather_blocks_ref  # noqa: E402
from repro_torch.kernels.quant_topk import ops as QO  # noqa: E402
from repro_torch.kernels.quant_topk.ref import (  # noqa: E402
    dequantize_ref, ids_agree_up_to_ties, quant_topk_ref)
from repro_torch.launch import dryrun_dhnsw  # noqa: E402
from repro_torch.models import flash as FL  # noqa: E402
from repro_torch.models import layers as LY  # noqa: E402
from repro_torch.models import model as LM  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import params as PR  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.net import RemotePool, spawn_pool_servers  # noqa: E402
from repro_torch.obs.trace import TRACER  # noqa: E402
from repro_torch.pool import LocalPool  # noqa: E402
from repro_torch.pool.compute import ComputeClient  # noqa: E402
from repro_torch.pool.protocol import (  # noqa: E402
    PoolUnavailableError, span_wire_bytes)
from repro_torch.pool.sharded import ShardedPool  # noqa: E402
from repro_torch.quant.codec import quantize_groups  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    DECODE_SPAN, DocStore, RagServeEngine)
from repro_torch.train import adamw as ADAMW  # noqa: E402
from repro_torch.train import checkpoint as CKPT  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402
from repro_torch.train.trainer import fit, run_with_restarts  # noqa: E402

# H100 SXM published peaks (NVIDIA datasheet), at 700 W
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS_S = 67e12
PEAK_BF16_FLOPS_S = 989e12      # dense tensor-core bf16
# phase 4 times the gather's launches in runs whose outputs (one each)
# fit in this many bytes of the card's memory
GATHER_OUT_BYTES = 16e9

# the paper's SIFT1M run is 1M x 128-d with 500 partitions; the host-side
# index build (pure-Python HNSW, phase 3) takes 44-72 s at 100k on the
# card's host, so both are cut
REDUCED = {"n": [1_000_000, 100_000], "n_rep": [500, 256],
           "why": "host-side index build time (pure-Python HNSW)",
           "decode_32k_batch": [128, 16],
           "decode_32k_why": "decode_attention's long-context check holds "
                             "one layer's K/V and the plain version's f32 "
                             "copies of them on the card",
           "durable_n": [100_000, 8000],
           "gist_n": [1_000_000, 20_000],
           "gist_why": "the reference's full preset (benchmarks/common.py):"
                       " the host-side index build",
           "train_n_layers": [36, 4], "train_global_batch": [256, 8],
           "train_why": "f32 masters, gradients and AdamW moments of "
                        "qwen3-8b take 131 GB at 36 layers, 32.3 GB at 4; "
                        "a step of 256 x 4096 tokens at 4 layers is over "
                        "a minute of the script's limit",
           "durable_why": "a write-ahead log record is bounded at 64 MiB "
                          "(ingest/wal.py MAX_BODY, as the reference's): "
                          "the ATTACH record of the 100k region (285 MB) "
                          "would be skipped on replay as a torn tail"}
FULL = dict(n=100_000, n_queries=2000, n_rep=256, k=10, doorbell=16)
SEED = 0
TOPK_RTOL, TOPK_ATOL = 1e-5, 1e-3
RECALL_FLOOR = 0.8           # sanity floor for recall@10 at full size
PAIR_BATCHES = 4             # phase 8's batches, so the tiers are reused
# phase 9: qwen3-8b at full width and depth over the 100k index
RAG_ARCH = "qwen3-8b"
RAG = dict(doc_len=240, prompt_len=64, batch=8, max_new_tokens=32,
           docs_per_query=4, n_calls=2)
DECODE_LONG = dict(B=16, S=32768)   # decode_32k's length, batch cut to 16
# phase 11: benchmarks/ingest.py's full run_load geometry (8 chunks)
LOAD = dict(n=20_000, n_rep=64, n_chunks=8, n_queries=500, k=10)
# phase 12b: benchmarks/torch_pool.py's full shard cell (run_shards) at 4
# shards on phase 3's index
SHARD = dict(n_shards=4, n_batches=16, per_batch=64, migrate_every=64)
# phase 14b: benchmarks/pool.py run_chaos's protocol on phase 3's index:
# 3 servers at replication=2, 4 batches, server 0 killed after batch 2
CHAOS = dict(n_servers=3, n_batches=4, kill_after=2, n_insert=16)
# phase 14c: benchmarks/ingest.py run_recovery's full geometry (8000 rows,
# 64 appends), searched with 500 queries
DURABLE = dict(n=8000, n_append=64, n_search=500)
# phase 15: the slice's LM families served over phase 5's engine in phase
# 9's geometry (RAG less its call count); 15a qwen3-moe-30b-a3b (full
# depth if it fits beside the index, else the deepest multiple of 8),
# 15b the others, llama4-scout's depth cut (about 4.5 GB of bf16
# matrices a layer), whisper through model.prefill with frames
MOE_ARCH = "qwen3-moe-30b-a3b"
RAG_GEOM = {k: v for k, v in RAG.items() if k != "n_calls"}
FAMILY_DEPTH = {"mamba2-370m": None, "zamba2-2.7b": None,
                "pixtral-12b": None, "llama4-scout-17b-a16e": 4}
WHISPER = dict(arch="whisper-tiny", batch=8, prompt_len=64,
               max_new_tokens=32)
MEM_MARGIN = 8e9             # bytes left free beside a model's weights
# phase 15c: each configuration at full width and 2 layers (the hybrid 2
# uses of its shared block) in f32, card against CPU: logits within a few
# f32 ulps of the largest logit summed over d_model-long products
CARD_CPU_ARCHS = ("qwen3-moe-30b-a3b", "llama4-scout-17b-a16e",
                  "pixtral-12b", "mamba2-370m", "zamba2-2.7b",
                  "whisper-tiny")
CARD_CPU = dict(batch=2, seq=64, steps=4, n_layers=2)
CARD_CPU_TOL = dict(atol=1e-3, rtol=1e-3)
# phase 16: ShardedStore over 4 gloo ranks on the one card, and 1 NCCL rank
SHARD_STORE = dict(world=4, iters=20)
# phase 17: training.  (a) qwen3-8b at full width, 4 layers, train_4k's
# length, a global batch of 8 in 2 micro-steps, one warm-up step and 4
# timed; (b)-(d) the smoke configs of the six families in f32 at the CPU
# tests' size and tolerances (tests/lm_parity.py: 1e-5 of a leaf's
# largest magnitude for m and sqrt(v), which scales like the gradient,
# or 1e-3 of the learning rates applied for a param);
# (e) compressed_grad_reduce within 5 % of the f32 mean's largest value
# (tests/test_distributed.py's bound)
TRAIN_ARCH = "qwen3-8b"
TRAIN = dict(n_layers=4, seq=4096, batch=8, micro_steps=2, steps=4)
TRAIN_FAMILIES = ("qwen3-8b", "qwen3-moe-30b-a3b", "pixtral-12b",
                  "mamba2-370m", "zamba2-2.7b", "whisper-tiny")
TRAIN_SMOKE = dict(batch=4, seq=32)
F32_TRAIN, ADAM_STEP_TOL = 1e-5, 1e-3
COMPRESS = dict(world=4, shapes=((4096, 1024), (151_936,), (8, 128)))
COMPRESS_TOL = 0.05
# phase 19, the mesh: (a) the dry runs of these archs x shapes x both
# production meshes and of the six d-HNSW variants (host only, the fake
# backend); (b) 17a's geometry and (c) phase 9's (8 prompts of 1024
# tokens, the prefill's S, and 32 greedy steps) through the meshed steps
# on a host mesh of one NCCL rank; (d) _moe_shardmap over 4 gloo ranks on
# the card at qwen3-moe's width, one layer of 8 x 1024 tokens; y within
# MOE_TOL (bf16's unit roundoff) x the number of shares x the sum of
# their magnitudes; (e) the d-HNSW step at SIFT1M geometry over 4 ranks
MESH_ARCHS = ("qwen3-8b", "qwen3-moe-30b-a3b")
MESH_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
MESH_TRAIN_STEPS = 2         # 19b's timed steps after the checked one
MESH_SERVE = dict(batch=8, seq=1024, steps=32)
# 19d's runs: (data, model, seed offset, dtype; None: the config's
# bf16): both meshes, then a second seed and the f32 layer on (1, 4),
# which show the bf16 gap to be rounding and not a mis-ordered sum
MESH_MOE = dict(batch=8, seq=1024, iters=5,
                runs=((1, 4, 0, None), (2, 2, 0, None), (1, 4, 1, None),
                      (1, 4, 0, "float32")))
MOE_TOL = 2.0 ** -8
# the f32 run's bound, of the largest sum of the shares' magnitudes: the
# ranks' products and sums run in other orders than the plain version's
MOE_TOL_F32 = 1e-5
MESH_DHNSW = dict(world=4, iters=10)
# 19f: (tag, arch, depth (None: the config's), model ranks, compute dtype
# (None: the config's bf16)) on (1, ranks) meshes of gloo rank processes
# on the card; the geometry of phase 9's prompts (its cache 1032 long: 4
# and 8 ranks divide it) and 8 steps.  Every path runs in f32 compute on
# the bf16 serving weights, each step's logits held within
# F32_FAMILY_TOL x that step's max |logit| (the CPU tests hold 1e-5 at
# smoke width; the sums here are longer); (b), the sequence-sharded
# cache and the partial mode, also in bf16 compute, which times the
# partial mode at the serving dtype and holds its first logits to
# family_bound
MESH_FAMILIES = (("a", "qwen3-8b", 4, 4, "float32"),
                 ("b", "qwen3-moe-30b-a3b", 4, 8, None),
                 ("b f32", "qwen3-moe-30b-a3b", 4, 8, "float32"),
                 ("c", "mamba2-370m", None, 4, "float32"),
                 ("c", "zamba2-2.7b", 6, 4, "float32"),
                 ("c", "whisper-tiny", None, 4, "float32"))
F32_FAMILY_TOL = 1e-4
MESH_FAMILY_GEOM = dict(batch=8, seq=1024, steps=8)
MESH_FAMILY_SMOKE = dict(batch=2, seq=29, steps=3)     # a cache of 32
# the dry run of 19a's cells on the tree whose meshed steps gathered
# every weight but the experts' and the whole cache over ``model``
# (8b0a094; ``python -m repro_torch.launch.dryrun --arch <a> --shape all
# --both-meshes`` on the host): working set a device as its PeakCounter
# read it (the arguments' own storages counted again where ``to_local``
# first showed them), FLOPs a device, collective operand bytes a device,
# and the working set re-read there with this tree's ``PeakCounter``
# (``launch/dryrun.py`` swapped in)
MESH_GATHERED = {
    "qwen3-8b|train_4k|single": (
        64010502172, 1.32078834286592e15, 83256905812, 64008744988),
    "qwen3-8b|train_4k|multi": (
        40255373340, 6.6039417143296e14, 59330682976, 40253878300),
    "qwen3-8b|prefill_32k|single": (
        63049617408, 3.21609640443904e14, 20879638528, 62369261568),
    "qwen3-8b|prefill_32k|multi": (
        35668938752, 1.60804820221952e14, 10611982336, 34988713984),
    "qwen3-8b|decode_32k|single": (
        86939062336, 1.94171109376e11, 2762604544, 86258968640),
    "qwen3-8b|decode_32k|multi": (
        47076397088, 9.7085554688e10, 1553465344, 46396303392),
    "qwen3-moe-30b-a3b|train_4k|single": (
        49492115492, 7.7171972374528e14, 71951138912, 48987430948),
    "qwen3-moe-30b-a3b|train_4k|multi": (
        29780295716, 3.8585986187264e14, 47916523640, 29275873316),
    "qwen3-moe-30b-a3b|prefill_32k|single": (
        62355922948, 5.228190236672e14, 18310430720, 58706194436),
    "qwen3-moe-30b-a3b|prefill_32k|multi": (
        36988510212, 2.614095118336e14, 11062673408, 33338912772),
    "qwen3-moe-30b-a3b|decode_32k|single": (
        63696789568, 4.57762144256e11, 5427101696, 60047323200),
    "qwen3-moe-30b-a3b|decode_32k|multi": (
        25847581320, 3.4484518912e11, 4621008896, 22198114920)}
# 19a: the parent tree's dry run of the same cells (f5882fe, before sequence
# parallelism; ``python -m repro_torch.launch.dryrun --arch <a> --shape
# all --both-meshes`` on the host): working set a device and collective
# wire bytes a device
MESH_NO_SP = {
    "qwen3-8b|decode_32k|multi": (2301842480.0, 12915840.0),
    "qwen3-8b|decode_32k|single": (3579265120.0, 25831680.0),
    "qwen3-8b|prefill_32k|multi": (24463108096.0, 46368600480.0),
    "qwen3-8b|prefill_32k|single": (46827268096.0, 92170969920.0),
    "qwen3-8b|train_4k|multi": (18953794584.0, 97274619049.5),
    "qwen3-8b|train_4k|single": (35237032984.0, 188750484637.5),
    "qwen3-moe-30b-a3b|decode_32k|multi": (4681677876.0, 13092480.0),
    "qwen3-moe-30b-a3b|decode_32k|single": (5522851940.0, 26184960.0),
    "qwen3-moe-30b-a3b|prefill_32k|multi": (26910093316.0, 36679758240.0),
    "qwen3-moe-30b-a3b|prefill_32k|single": (48905154564.0, 73170772800.0),
    "qwen3-moe-30b-a3b|train_4k|multi": (18092246564.0, 73096006860.0),
    "qwen3-moe-30b-a3b|train_4k|single": (34037712420.0, 133565107380.0)}
# sequence parallelism's saved layer inputs, (tp - 1)/tp of L x B_loc x S
# x d x 2 B a train cell, and the working set a device it must come to
# at most (the layer inputs' share gone, one layer's gathered input of
# slack), each against this tree's step with sequence parallelism off
# (19a traces it where the cell runs more than one micro-step: each rank
# now takes its share of every micro-batch; otherwise f5882fe's step is
# that step); the wire may rise by the recompute's second
# all-gather a layer: 11 half-collectives (6 all-gathers, 5
# reduce-scatters) where the all-reduces were 5 (ring: one all-reduce =
# two halves), +10 %
SP_SAVED = {"qwen3-8b|train_4k|single": 18.12e9,
            "qwen3-8b|train_4k|multi": 9.06e9,
            "qwen3-moe-30b-a3b|train_4k|single": 6.04e9,
            "qwen3-moe-30b-a3b|train_4k|multi": 3.02e9}
SP_WORKING_SET = {"qwen3-8b|train_4k|single": 17.66e9,
                  "qwen3-8b|train_4k|multi": 10.17e9,
                  "qwen3-moe-30b-a3b|train_4k|single": 28.13e9,
                  "qwen3-moe-30b-a3b|train_4k|multi": 15.14e9}
SP_WIRE = 1.11
# 19g: the meshed train step sequence parallel over (1, model) gloo ranks
MESH_SP = dict(arch="qwen3-8b", n_layers=2, batch=4, seq=4096, model=4)
MESH_SP_SMOKE = dict(arch="qwen3-8b", n_layers=2, batch=2, seq=64, model=4)
SP_TOL, SP_KEEP = 1e-5, 0.9
# phase 20: each twin's arguments on the card (the CLI defaults but
# where a run would take minutes: train_lm's 200 steps, the demos'
# phases)
EXAMPLE_RUNS = (("quickstart", ()), ("rag_serve", ()),
                ("train_lm", ("--steps", "12")),
                ("live_ingest", ("--seconds", "1.0")),
                ("online_serving", ("--clients", "4", "--requests", "8",
                                    "--n", "8000")),
                ("distributed_search", ()))
MESH_SMOKE = False           # the CPU test's smoke sizes (never on the card)
# decode_attention vs its plain version: in bf16 within a few bf16 steps
# of the largest output (both sides round the same f32 result once, so
# they differ by at most one step of each element); in f32 at the gpu
# tests' tolerance
BF16_STEPS = 2.0 ** -6
F32_TOL = dict(atol=2e-5, rtol=1e-4)


def log(*a) -> None:
    print(*a, flush=True)


# ------------------------------------------------------------------ timing

def device_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` back-to-back
    calls (CUDA events, after a warm-up).  A sleep kernel ahead of the
    window keeps the device busy while the host enqueues the calls, so the
    events see device time, not launch latency."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_split(fn, iters: int = 10) -> dict:
    """Device milliseconds of one launch by kernel name (the name up to its
    template arguments), and how many launches of it ``torch.profiler``
    recorded over ``iters`` warmed calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "")
            name = re.split(r"[(<]", name.removeprefix("void "))[0]
            name = name.split("::")[-1]
            ms, n = out.get(name, (0.0, 0))
            out[name] = (ms + e.device_time_total / 1e3, n + e.count)
    # a mean over the kernel records the trace holds, which can be fewer
    # than the launches
    return {name: (round(ms / n, 4), f"{n} of {iters} calls")
            for name, (ms, n) in out.items()}


def power_under(fn, ms: float, seconds: float = 3.0) -> dict:
    """The card's power draw and clocks while ``fn`` (``ms`` of device time
    a call) runs back to back for about ``seconds``: ``nvidia-smi``
    samples every 100 ms; the first and last samples are dropped."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=power.draw,clocks.sm,clocks.mem",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(0.3)
        for _ in range(max(1, int(seconds * 1e3 / ms))):
            fn()
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        text = smi.communicate(timeout=60)[0]
    rows = [[float(x) for x in line.split(",")]
            for line in text.splitlines() if line.strip()]
    rows = rows[3:-2] or rows
    med = [sorted(col)[len(col) // 2] for col in zip(*rows)]
    return {"samples": len(rows), "watts_median": med[0],
            "watts_max": max(r[0] for r in rows), "sm_mhz_median": med[1],
            "sm_mhz_min": min(r[1] for r in rows), "mem_mhz_median": med[2]}


# ------------------------------------------------------------------ phases

def phase_device() -> dict:
    """Phase 1: the card.  Raises when torch sees no CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("torch sees no CUDA device")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[1 device] {name} x{count} | nvidia-smi: {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    return {"name": name, "count": count, "smi": smi}


def phase_kernel_build() -> float:
    """Phase 2: build every kernel from the checkout's sources."""
    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    dt = time.perf_counter() - t0
    log(f"[2 build] {len(_build.sources())} sources -> {path.name} in "
        f"{dt:.2f} s")
    return dt


def phase_index(n: int, n_queries: int, n_rep: int, *, seed: int = SEED,
                quant_group: int = 32):
    """Phase 3: the dataset, meta-HNSW and region, built once on the host
    exactly as ``ComputeClient.build`` builds them, plus a copy of the
    region with the int8 mirror attached for the int8 engines."""
    t0 = time.perf_counter()
    ds = sift_like(n=n, n_queries=n_queries, seed=seed)
    t1 = time.perf_counter()
    cfg = EngineConfig(n_rep=n_rep, seed=seed)
    meta = ME.build_meta(ds.data, cfg.n_rep, seed=cfg.seed,
                         meta_levels=cfg.meta_levels)
    store = LA.build_store(
        ds.data, meta,
        sub_params=HNSWParams(M=max(cfg.sub_M0 // 2, 2), M0=cfg.sub_M0,
                              ef_construction=cfg.ef_construction))
    t2 = time.perf_counter()
    qstore = LA.attach_quant_mirror(dataclasses.replace(store), quant_group)
    t3 = time.perf_counter()
    spec = store.spec
    log(f"[3 index] n={n} queries={n_queries} n_rep={n_rep}: data+gt "
        f"{t1 - t0:.1f} s, meta+store {t2 - t1:.1f} s, int8 mirror "
        f"{t3 - t2:.1f} s | np_max={spec.np_max} fetch_blocks="
        f"{spec.fetch_blocks} gblk={spec.gblk} vblk={spec.vblk} "
        f"n_blocks={spec.n_blocks} vec_buf={store.vec_buf.nbytes / 1e6:.1f}"
        f" MB")
    return ds, meta, store, qstore


def flat_view(qstore, device):
    """The dense-resident int8 flat database exactly as
    ``ComputeClient._sync_flat`` stages it: (codes, scales, n_valid), and
    its f32 twin: the same region rows, padded the same way."""
    spec = qstore.spec
    rows, _, _ = LA.flat_quant_rows(qstore)
    n = len(rows)
    idx = np.full(SCH.pow2_pad(max(n, 1), lo=256), -1, np.int64)
    idx[:n] = rows
    idx = torch.as_tensor(idx, dtype=torch.int32, device=device)
    codes, scales = DS.gather_quant_rows(
        torch.as_tensor(qstore.qvec_buf, device=device),
        torch.as_tensor(qstore.qscale_buf, device=device), idx,
        dim=spec.dim, group=spec.quant_group)
    vecs = DS.gather_rows(torch.as_tensor(qstore.vec_buf, device=device),
                          idx, dim=spec.dim)
    return codes, scales, vecs, n


def exact_config(n_rep: int, doorbell: int, search_mode: str = "scan",
                 gather: bool = True) -> EngineConfig:
    """The exact main path: ``mode="full"``, b=4, ef=48, RDMA fabric."""
    return EngineConfig(mode="full", search_mode=search_mode, b=4, ef=48,
                        n_rep=n_rep, doorbell=doorbell, fabric=RDMA_100G,
                        use_gather_kernel=gather)


def flat_config(n_rep: int, doorbell: int,
                quant_kernel: str = "auto") -> EngineConfig:
    """The int8 flat main path (phase 6): int8 scan, b=6, ``cache_frac``
    0.6, ``exact_frac`` 0.25, stage 1 over the flat view through
    ``quant_kernel``."""
    return EngineConfig(mode="full", search_mode="scan", b=6, n_rep=n_rep,
                        quant="int8", quant_kernel=quant_kernel,
                        cache_frac=0.6, exact_frac=0.25, doorbell=doorbell,
                        fabric=RDMA_100G)


def pairs_config(n_rep: int, doorbell: int, search_mode: str = "scan",
                 gather: bool = True) -> EngineConfig:
    """The int8 per-pair path: ``benchmarks/torch_quant.py``'s per-pair
    cell (``quant_kernel="off"``, ``cache_frac`` 0.25, ``exact_frac``
    0.25, ``rerank_m`` 0, b=6)."""
    return torch_quant.cell_config(
        quant="int8", exact_frac=0.25, rerank_m=0, n_rep=n_rep,
        quant_kernel="off", cache_frac=0.25, search_mode=search_mode,
        doorbell=doorbell, use_gather_kernel=gather)


def _route(meta, queries, device, b: int) -> np.ndarray:
    g = meta.graph
    pids, _ = S.meta_route(
        torch.as_tensor(g.vectors, dtype=torch.float32, device=device),
        torch.as_tensor(g.adjacency, dtype=torch.int32, device=device),
        torch.as_tensor(queries, dtype=torch.float32, device=device),
        int(g.entry), b=b, n_levels=g.n_levels)
    return pids.cpu().numpy()


def _round_ids(plan, store, device) -> list:
    """The block ids of each fetching round's one ``read_spans`` call."""
    return [torch.as_tensor(
        np.concatenate([store.span_block_ids(int(p)) for p in rnd.fetch_pids]),
        dtype=torch.int32, device=device)
        for rnd in plan.rounds if len(rnd.fetch_pids)]


def main_path_gathers(meta, store, queries, device, *, doorbell: int):
    """The block ids of every span read of one exact batch, round by
    round, planned as ``ComputeClient.search`` plans them on a fresh
    engine: meta-HNSW routing on ``device``, then ``plan_batch`` over an
    empty cache of ``ceil(cache_frac * n_rep)`` slots.  Each round reads
    all its fetched spans in one ``read_spans`` call, which is one gather
    launch for all its staged buffers.  Returns (ids per round, fetched
    spans)."""
    cfg = exact_config(meta.n_partitions, doorbell)
    cap = max(2, int(np.ceil(cfg.cache_frac * meta.n_partitions)))
    plan = SCH.plan_batch(_route(meta, queries, device, cfg.b),
                          SCH.LRUCacheState(cap), doorbell=cfg.doorbell)
    return _round_ids(plan, store, device), plan.n_fetches


def pair_path_gathers(meta, qstore, queries, device, *, doorbell: int,
                      search_mode: str, n_batches: int) -> list:
    """The block ids of every quantized span read of the int8 per-pair
    path over ``n_batches`` batches, planned as ``_stage1_pairs`` plans
    them on a fresh engine: each batch routed on its own, then
    ``plan_batch`` over the quantized tier, whose capacity is what
    ``_setup_quant`` gives this cell and whose state carries from batch
    to batch.  Each fetching round is one gather launch for all the
    quantized buffers (graph blocks, codes, scales).  Returns, per batch,
    (ids per round, fetched spans)."""
    cfg = pairs_config(meta.n_partitions, doorbell, search_mode)
    spec = qstore.spec
    cap = max(2, int(np.ceil(cfg.cache_frac * meta.n_partitions)))
    exact_cap = max(1, int(round(cap * cfg.exact_frac)))
    qpb = spec.quant_partition_bytes(include_graph=search_mode == "graph")
    cache = SCH.LRUCacheState(
        max(2, int((cap - exact_cap) * spec.partition_bytes() // qpb)))
    per = len(queries) // n_batches
    out = []
    for i in range(n_batches):
        plan = SCH.plan_batch(
            _route(meta, queries[i * per:(i + 1) * per], device, cfg.b),
            cache, doorbell=cfg.doorbell)
        out.append((_round_ids(plan, qstore, device), plan.n_fetches))
    return out


def rag_path_gathers(meta, store, queries, device, *, doorbell: int,
                     n_calls: int) -> list:
    """The block ids of every span read of phase 9's retrieval: ``n_calls``
    searches of the same embedded prompts on phase 5's exact-scan engine,
    each fused by the micro-batcher into one batch (padded to a power of
    two with copies of row 0, as ``MicroBatcher`` pads it) and planned as
    ``ComputeClient.search`` plans it, the cache carrying from call to
    call.  Returns, per call, (ids per round, fetched spans)."""
    cfg = exact_config(meta.n_partitions, doorbell)
    cap = max(2, int(np.ceil(cfg.cache_frac * meta.n_partitions)))
    cache = SCH.LRUCacheState(cap)
    pad = SCH.pow2_pad(len(queries), lo=1) - len(queries)
    fused = np.concatenate([queries, np.repeat(queries[:1], pad, axis=0)])
    out = []
    for _ in range(n_calls):
        plan = SCH.plan_batch(_route(meta, fused, device, cfg.b), cache,
                              doorbell=cfg.doorbell)
        out.append((_round_ids(plan, store, device), plan.n_fetches))
    return out


# the staged buffers each path's read_spans gathers from, in its order
EXACT_BUFS = ("graph", "vec")
PAIR_BUFS = ("graph", "codes", "scales")


def gather_launches(exact_gathers, pair_gathers, rag_gathers=(),
                    recorded=()) -> list:
    """Every gather launch of the main path, one per span read, as
    (buffers, ids): phase 5's counted batch in each search mode (graph,
    then scan), then phase 8's counted run in each search mode
    (``pair_gathers``: mode -> the result of ``pair_path_gathers``), then
    phase 9's retrieval (``rag_path_gathers``' result), then the launches
    phases 10-15 recorded (``recorded_launches``)."""
    out = [(EXACT_BUFS, ids) for _ in ("graph", "scan")
           for ids in exact_gathers[0]]
    for batches in pair_gathers.values():
        out += [(PAIR_BUFS, ids) for round_ids, _ in batches
                for ids in round_ids]
    out += [(EXACT_BUFS, ids) for round_ids, _ in rag_gathers
            for ids in round_ids]
    return out + list(recorded)


def _gather_record(bufs, launches, device, timed: bool,
                   sweep: bool = False) -> dict:
    """The span gather vs its plain version at every launch of the main
    path (``gather_launches``: one per span read, over all its buffers),
    exactly equal.  The record's work is those launches, in the path's
    order: ``ms``, ``plain_ms`` (``gather_blocks_ref`` per buffer),
    ``library_ms`` (``index_select`` per buffer) and ``bound_ms`` are of
    all of them together.  With ``sweep``, also one contiguous copy of
    the same bytes: the card's copy rate, beside the kernel's."""
    worst = 0.0
    nbytes = 0
    for names in dict.fromkeys(names for names, _ in launches):
        row_bytes = [bufs[n].shape[1] * bufs[n].element_size()
                     for n in names]
        seen = {id(i): i for b, i in launches if b == names}.values()
        for ids in seen:
            got = GO.gather_spans([bufs[n] for n in names], ids)
            for n, g in zip(names, got):
                want = gather_blocks_ref(bufs[n], ids)
                if g.dtype != want.dtype or not torch.equal(g, want):
                    raise AssertionError(f"gather_spans != plain on {n}")
                worst = max(worst,
                            float((g.double() - want.double()).abs().max()))
        rows = [int(ids.shape[0]) for b, ids in launches if b == names]
        part = sum(2 * m * sum(row_bytes) + 4 * m for m in rows)
        nbytes += part
        log(f"[4 kernels] gather_spans {'+'.join(names)} (rows of "
            f"{row_bytes} B), {len(rows)} launches of "
            f"m={sorted(set(rows))} rows: exact match | bound "
            f"{part / PEAK_BYTES_S * 1e3:.4f} ms (bytes)")
    rec = {"name": "gather_blocks", "route": "cuda",
           "source": "src/repro_torch/kernels/gather_blocks/csrc/"
                     "gather_blocks.cu",
           "replaces": "src/repro/kernels/gather_blocks/kernel.py:31",
           "launches": 0, "max_abs_err": worst, "ms": None,
           "plain_ms": None, "bound_ms": nbytes / PEAK_BYTES_S * 1e3,
           "bound_by": "bytes", "library_ms": None}
    if timed:
        rec["ms"], rec["plain_ms"], rec["library_ms"] = _gather_times(
            bufs, launches, device)
        if sweep:
            src = torch.empty(nbytes // 2, dtype=torch.uint8, device=device)
            dst = torch.empty_like(src)
            copy_ms = device_ms(lambda: dst.copy_(src), 20)
            log(f"[4 sweep] gather_spans: one contiguous copy of the same "
                f"bytes {copy_ms:.4f} ms ({rec['bound_ms'] / copy_ms:.3f} of "
                f"the bound); the kernel {rec['ms']:.4f} ms, "
                f"{copy_ms / rec['ms']:.3f} of the copy's rate")
            del src, dst
    log(f"[4 kernels] gather_spans, every span read of phases 5 and 8-18 "
        f"({len(launches)} launches, "
        f"{sum(len(names) for names, _ in launches)} buffer reads): "
        + (f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
           f"index_select {rec['library_ms']:.4f} ms, " if timed else "")
        + f"bound {rec['bound_ms']:.4f} ms (bytes)")
    return rec


def _gather_times(bufs, launches, device) -> tuple:
    """Device ms of ``launches`` (``gather_launches`` entries) back to
    back: the kernel, the plain version and ``index_select`` a buffer at a
    time.  Every launch writes an output of its own, so the launches are
    timed in runs whose outputs fit in ``GATHER_OUT_BYTES``, and the runs'
    times summed."""
    runs, size = [[]], 0
    for names, ids in launches:
        out = ids.shape[0] * sum(bufs[n].shape[1] * bufs[n].element_size()
                                 for n in names)
        if runs[-1] and size + out > GATHER_OUT_BYTES:
            runs.append([])
            size = 0
        runs[-1].append((names, ids))
        size += out
    return tuple(sum(t) for t in zip(*(_gather_run_times(bufs, run, device)
                                       for run in runs)))


def _gather_run_times(bufs, launches, device) -> tuple:
    work = [([bufs[n] for n in names], ids) for names, ids in launches]
    outs = [[torch.empty((ids.shape[0], b.shape[1]), dtype=b.dtype,
                         device=device) for b in bs] for bs, ids in work]
    bad = GO.flag(device)

    def kern():
        for (bs, ids), o in zip(work, outs):
            GO._launch(bs, ids, o, bad)

    def plain():
        for bs, ids in work:
            for b in bs:
                gather_blocks_ref(b, ids)

    def library():
        for bs, ids in work:
            for b in bs:
                torch.index_select(b, 0, ids)

    times = (device_ms(kern, 20), device_ms(plain, 20),
             device_ms(library, 20))
    if bad.item():
        raise AssertionError("gather_spans flagged an id out of range")
    return times


def _gather_part(bufs, launches, label: str, device, timed: bool) -> None:
    """One part of the gather's launches (``label``) timed alone beside
    its bound (``_gather_record`` holds them against the plain version
    with the rest)."""
    if not launches:
        raise AssertionError(f"gather_spans: no launch in {label}")
    nbytes = sum(2 * ids.shape[0] * sum(bufs[n].shape[1]
                                        * bufs[n].element_size()
                                        for n in names) + 4 * ids.shape[0]
                 for names, ids in launches)
    widths = sorted({bufs[n].shape[1] * bufs[n].element_size()
                     for names, _ in launches for n in names})
    bound = nbytes / PEAK_BYTES_S * 1e3
    line = (f"[4 kernels] gather_spans {label}: {len(launches)} launches, "
            f"rows of {widths} B, {nbytes / 1e6:.1f} MB moved | ")
    if timed:
        ms, plain_ms, lib_ms = _gather_times(bufs, launches, device)
        line += (f"kernel {ms:.4f} ms ({bound / ms:.3f} of the bound), plain "
                 f"{plain_ms:.4f} ms, index_select {lib_ms:.4f} ms, ")
    log(line + f"bound {bound:.4f} ms (bytes)")


def product_ms(q, x) -> float:
    """The product part alone through cuBLAS: ``torch.addmm`` of q2 - 2 q.x
    over the same B x n_valid x D in f32 (TF32 off).  A yardstick for the
    top-k kernels' product; no single torch call computes distance plus
    top-k, and the port never calls this."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q2 = (q * q).sum(-1, keepdim=True)
    xt = x.T
    return device_ms(lambda: torch.addmm(q2, q, xt, alpha=-2.0), 20)


def _topk_sweep(name: str, label: str, launch, want, B: int, nv: int,
                kk: int, quant: bool, bound_ms: float,
                power: bool = False) -> None:
    """``--sweep``: one top-k kernel at every cut (tile x chunks) of one
    shape, each held against the plain lists ``want`` as ``_topk_check``
    holds it, beside the bound; ``launch(bufs, tile, S)`` launches once.
    With ``power``, the card's draw and clocks under the wrappers' cut."""
    default = QO.launch_shape(B, nv, kk, quant)
    for tile in QO.TILES:
        if not QO.ctas_per_sm(tile, kk, quant):
            continue
        n_tiles = max(-(-nv // tile), 1)
        cuts = sorted({-(-n_tiles // -(-n_tiles // n)) for n in
                       (1, 2, 4, 8, 16, 24, 33, 48, 66, 99, 132, 264)
                       if n <= n_tiles} | ({default[1]} if tile == default[0]
                                           else set()))
        for S in cuts:
            bufs = QO.buffers(B, kk, S, want[0].device)
            launch(bufs, tile, S)
            _topk_check(f"{name} {label} tile={tile} S={S}", bufs[2],
                        bufs[3], *want, kk)
            ms = device_ms(lambda: launch(bufs, tile, S), 10)
            mark = " (the wrappers' cut)" if (tile, S) == default else ""
            log(f"[4 sweep] {name} {label}: tile {tile}, {S} chunks of "
                f"{-(-n_tiles // S)} tiles: {ms:.4f} ms, {bound_ms / ms:.3f} "
                f"of the bound{mark}")
    if power:
        bufs = QO.buffers(B, kk, default[1], want[0].device)
        fn = lambda: launch(bufs, *default)  # noqa: E731
        ms = device_ms(fn, 10)
        log(f"[4 sweep] power under {name} at the {label} shape "
            f"({ms:.4f} ms a call): {json.dumps(power_under(fn, ms))}")


# ``--sweep``: copies of kernels/csrc/topk_tile.cuh with parts cut out,
# each keeping every FMA of the product alive (only "full" is right)
_NONE_PASS = ("if (q0 + i < B && n0 + j < row_end)\n          pending",
              "if (q0 + i < B && n0 + j < row_end && acc[r][c] < -1e30f)\n"
              "          pending")
_NO_EPILOGUE = ("    if (sl != n_slices - 1) continue;",
                "    {\n      float sum = 0.f;\n#pragma unroll\n"
                "      for (int r = 0; r < TM; ++r)\n#pragma unroll\n"
                "        for (int c = 0; c < TN; ++c) sum += acc[r][c];\n"
                "      if (sl != n_slices - 1 || sum != -12345.f) continue;\n"
                "    }")
_NO_BARRIER = ("    __syncthreads();   // slice t landed",
               "    // slice t landed")
_NO_COPIES = ("  auto issue = [&](int t) {\n",
              "  auto issue = [&](int t) {\n"
              "    if (t >= 2 * n_slices) { cp_commit(); return; }\n")
TOPK_CUTS = {
    "full": [],                   # as it ships
    "product": [_NONE_PASS],      # no candidates: product, copies, epilogue
    "no_epilogue": [_NONE_PASS, _NO_EPILOGUE],   # product, copies, barriers
    "bare": [_NONE_PASS, _NO_EPILOGUE, _NO_BARRIER, _NO_COPIES]}
FMA_LOOP = r"""
#include <cuda_runtime.h>
__global__ void __launch_bounds__(256) fma_loop(float* out, int iters) {
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = threadIdx.x * 1e-3f + i;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = fmaf(acc[i], 0.999f, 1e-3f);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) s += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int fma_launch(void* out, int blocks, int iters) {
  fma_loop<<<blocks, 256>>>(static_cast<float*>(out), iters);
  return (int)cudaGetLastError();
}
"""


def topk_cut(cut: str) -> str:
    """kernels/csrc/topk_tile.cuh with ``cut``'s parts taken out."""
    text = (_build.KERNELS_DIR / "csrc" / "topk_tile.cuh").read_text()
    for old, new in TOPK_CUTS[cut]:
        if old not in text:
            raise RuntimeError(f"topk cut {cut}: the kernel no longer has "
                               f"{old!r}")
        text = text.replace(old, new)
    return text


def _build_cuts() -> dict:
    """One kernel library per cut, and the FMA loop's, under
    build/topk_cuts/ (one nvcc each, all started together)."""
    out = ROOT / "build" / "topk_cuts"
    jobs = {}
    for cut in TOPK_CUTS:
        root = out / cut
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(_build.KERNELS_DIR, root,
                        ignore=shutil.ignore_patterns("__pycache__", "*.py"))
        (root / "csrc" / "topk_tile.cuh").write_text(topk_cut(cut))
        jobs[cut] = sorted(map(str, root.glob("*/csrc/*.cu")))
    (out / "fma.cu").write_text(FMA_LOOP)
    jobs["fma"] = [str(out / "fma.cu")]
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
         str(out / f"{name}.so"), *srcs], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name, srcs in jobs.items()}
    libs = {}
    for name, p in procs.items():
        text = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on the {name} cut:\n{text}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        sigs = ({"fma_launch": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]}
                if name == "fma" else _build.SIGNATURES)
        for fn, argtypes in sigs.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def topk_anatomy(calls, device) -> None:
    """``--sweep``: each top-k call of ``calls`` ((label, launch(bufs, tile,
    S), B, n_valid, k, quant, GFLOP)) at the wrappers' cut through every
    cut of the kernel, and the FMA rate of a loop from registers."""
    libs = _build_cuts()
    shipped = _build.library()
    try:
        for cut in TOPK_CUTS:
            _build._lib = libs[cut]
            for label, launch, B, nv, k, quant, gflop in calls:
                tile, S = QO.launch_shape(B, nv, k, quant)
                bufs = QO.buffers(B, k, S, device)
                ms = device_ms(lambda: launch(bufs, tile, S), 20)
                log(f"[4 sweep] top-k cut {cut}, {label}: {ms:.4f} ms "
                    f"({gflop / ms:.1f} TFLOP/s of the product)")
    finally:
        _build._lib = shipped
    out = torch.empty(132 * 4 * 256, device=device)
    fma, iters = libs["fma"], 4000
    ms = device_ms(lambda: _build.check(
        fma.fma_launch(out.data_ptr(), 132 * 4, iters), "fma_loop"), 5)
    log(f"[4 sweep] FMA loop from registers (528 CTAs of 256 threads, 64 "
        f"accumulators): {2.0 * out.numel() * iters * 64 / ms / 1e9:.1f} "
        f"TFLOP/s")


def _topk_check(name: str, d, i, dr, ir, kk: int) -> tuple:
    """Kernel (k) lists against the plain version's (k + 1): ids equal up
    to ties, distances within rtol 1e-5 / atol 1e-3.  Returns (max |d -
    plain|, differing tied positions)."""
    d_h, i_h = d.cpu().numpy(), i.cpu().numpy()
    dr_h, ir_h = dr.cpu().numpy(), ir.cpu().numpy()
    ok, n_diff = ids_agree_up_to_ties(i_h, ir_h, dr_h, rtol=TOPK_RTOL)
    if not ok:
        raise AssertionError(f"{name} ids differ from plain beyond ties "
                             f"({n_diff} positions)")
    np.testing.assert_allclose(d_h, dr_h[:, :kk], rtol=TOPK_RTOL,
                               atol=TOPK_ATOL)
    return float(np.abs(d_h - dr_h[:, :kk]).max()), n_diff


def _distance_record(shapes, device, timed: bool, sweep: bool = False,
                     calls=None) -> dict:
    """distance_topk against its plain version at each of ``shapes``
    ((label, q, x, n_valid, k), the first one the throughput path's), in
    f32 and on bf16 inputs (against the plain version on the same
    f32-cast inputs), timed beside the cuBLAS product alone.  The record's
    numbers are the first shape's.  ``sweep``: ``_topk_sweep`` at each
    shape; ``calls`` collects each timed call for ``topk_anatomy``."""
    rec = {"name": "distance_topk", "route": "cuda",
           "source": "src/repro_torch/kernels/distance_topk/csrc/"
                     "distance_topk.cu",
           "replaces": "src/repro/kernels/distance_topk/kernel.py:87",
           "launches": 0, "max_abs_err": 0.0, "ms": None, "plain_ms": None,
           "bound_ms": None, "bound_by": None, "library_ms": None}
    for j, (label, q, x, nv, k) in enumerate(shapes):
        (B, D), N = q.shape, x.shape[0]
        kk = min(k, nv)
        err, n_diff = _topk_check(
            "distance_topk", *DO.distance_topk(q, x, kk, n_valid=nv),
            *distance_topk_ref(q, x, min(kk + 1, N), nv), kk)
        qb, xb = q.bfloat16(), x.bfloat16()
        err_b, n_diff_b = _topk_check(
            "distance_topk (bf16)", *DO.distance_topk(qb, xb, kk, n_valid=nv),
            *distance_topk_ref(qb.float(), xb.float(), min(kk + 1, N), nv),
            kk)
        flops = 2.0 * B * nv * D
        nbytes = B * D * 4 + nv * D * 4 + B * kk * 8
        bound_by = ("operations" if flops / PEAK_F32_FLOPS_S
                    >= nbytes / PEAK_BYTES_S else "bytes")
        bound_ms = max(flops / PEAK_F32_FLOPS_S, nbytes / PEAK_BYTES_S) * 1e3
        ms = plain_ms = gemm_ms = None
        if timed and kk > QO.K_MAX:     # the large-k route: two kernels
            ms = device_ms(lambda: DO.distance_topk(q, x, kk, n_valid=nv),
                           10)
            plain_ms = device_ms(lambda: distance_topk_ref(q, x, kk, nv), 3)
            gemm_ms = product_ms(q, x[:nv])
            split = kernel_split(lambda: DO.distance_topk(q, x, kk,
                                                          n_valid=nv))
            log(f"[4 kernels] distance_topk {label}: the large-k route; "
                f"device time by kernel {split}")
        elif timed:
            tile, S = QO.launch_shape(B, nv, kk, quant=False)
            bufs = QO.buffers(B, kk, S, device)

            def launch(bufs, tile, S, q=q, x=x, nv=nv, kk=kk):
                DO._launch(q, x, kk, nv, bufs, tile, S)
            ms = device_ms(lambda: launch(bufs, tile, S), 20)
            plain_ms = device_ms(lambda: distance_topk_ref(q, x, kk, nv), 5)
            gemm_ms = product_ms(q, x[:nv])
            log(f"[4 kernels] distance_topk {label}: tile {tile}, {S} "
                f"chunks; device time by kernel "
                f"{kernel_split(lambda: launch(bufs, tile, S))}")
            if calls is not None:
                calls.append((f"distance_topk {label}", launch, B, nv, kk,
                              False, flops / 1e9))
            if sweep:
                want = distance_topk_ref(q, x, min(kk + 1, N), nv)
                _topk_sweep("distance_topk", label, launch, want, B, nv, kk,
                            False, bound_ms)
        rec["max_abs_err"] = max(rec["max_abs_err"], err, err_b)
        if j == 0:
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by)
        log(f"[4 kernels] distance_topk {label} B={B} N={N} n_valid={nv} "
            f"D={D} k={kk}: ids equal up to ties ({n_diff} tied positions "
            f"differ; bf16 inputs {n_diff_b}), max |d - plain| "
            f"{max(err, err_b):.3g} | "
            + (f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, cuBLAS "
               f"product alone {gemm_ms:.4f} ms, " if timed else "")
            + f"library none (no single torch call computes distance plus "
              f"top-k), bound {bound_ms:.4f} ms ({bound_by}, "
              f"{flops / 1e9:.2f} GFLOP)")
    return rec


def long_decode_inputs(B: int, S: int, H: int, K: int, hd: int, dtype,
                       device, seed: int = SEED) -> tuple:
    """decode_attention's long-context inputs: q (B, H, hd), k/v (B, S, K,
    hd) drawn from a seeded generator on ``device``, pos = S."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device=device).to(dtype)
               for shape in ((B, H, hd), (B, S, K, hd), (B, S, K, hd)))
    return q, k, v, torch.full((B,), S, dtype=torch.int32, device=device)


def _sdpa(q, kt, vt, mask):
    """The library call: one ``scaled_dot_product_attention`` with GQA and
    a length mask, on k/v laid out (B, K, S, hd)."""
    return torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], kt, vt, attn_mask=mask, enable_gqa=True)[:, :, 0]


def _decode_checks(q, k, v, pos, route: bool) -> tuple:
    """decode_attention against its plain version on (q, k, v, pos): in
    bf16 within ``BF16_STEPS`` of the largest plain output, and on f32
    copies of the inputs at ``F32_TOL``.  With ``route``, also against
    ``attend_decode`` at pos - 1, the call the decode route replaces: in
    f32 at ``F32_TOL``, and in bf16 within the bound of attend_decode's
    one extra rounding (p cast to bf16 before the PV product moves the
    output by at most 2^-9 of max |v| over the valid entries) plus the
    same output steps.  Returns (max |out - plain| in q's dtype, the
    plain output in f32, the log text)."""
    got = DA.decode_attention(q, k, v, pos).float()
    want = decode_attention_ref(q, k, v, pos).to(q.dtype).float()
    err, peak = float((got - want).abs().max()), float(want.abs().max())
    line = f"max |plain| {peak:.3g}"
    lim = BF16_STEPS * peak
    if q.dtype == torch.bfloat16:
        if err > lim:
            raise AssertionError(f"decode_attention: max |out - plain| "
                                 f"{err:.3g} > {lim:.3g} in bf16")
        line += f", max |out - plain| {err:.3g} (limit {lim:.3g})"
    f32 = [t.float() for t in (q, k, v)]
    got32, want32 = (DA.decode_attention(*f32, pos),
                     decode_attention_ref(*f32, pos))
    if not torch.allclose(got32, want32, **F32_TOL):
        raise AssertionError("decode_attention != plain in f32")
    line += f", f32 max |out - plain| {float((got32 - want32).abs().max()):.3g}"
    if route:
        r32 = LY.attend_decode(*f32, pos - 1)
        if not torch.allclose(got32, r32, **F32_TOL):
            raise AssertionError("decode_attention at pos + 1 != "
                                 "attend_decode at pos, in f32")
        line += (f", f32 max |out - attend_decode(pos - 1)| "
                 f"{float((got32 - r32).abs().max()):.3g}")
        if q.dtype == torch.bfloat16:
            n = int(pos.max())
            r_lim = 2.0 ** -9 * float(v[:, :n].float().abs().max()) + lim
            r_err = float((got - LY.attend_decode(q, k, v, pos - 1).float())
                          .abs().max())
            if r_err > r_lim:
                raise AssertionError(f"decode_attention at pos + 1: max |out"
                                     f" - attend_decode(pos)| {r_err:.3g} > "
                                     f"{r_lim:.3g} in bf16")
            line += (f", max |out - attend_decode(pos - 1)| {r_err:.3g} "
                     f"(limit {r_lim:.3g})")
    del f32, got32, want32
    return err, want, line


def _decode_sweep(label: str, sets, want, bound_ms: float, sdpa,
                  sdpa_ms, power: bool) -> None:
    """``--sweep``: decode_attention at every cut of one shape's caches
    (warps sharing a kv head x splits) over the timed copies ``sets``,
    each held against the plain output ``want`` as ``_decode_checks``
    holds it, beside SDPA (``sdpa``, ``sdpa_ms``: the same copies) and
    the bound.  With ``power``, the card's draw and clocks under the
    wrappers' cut and under SDPA."""
    q, k = sets[0][0], sets[0][1]
    B, S, K = q.shape[0], k.shape[1], k.shape[2]
    lim = BF16_STEPS * float(want.abs().max())
    default = (DA.warps_per_head(B, K), DA.splits(B, K, S))
    tiles = -(-S // 64)
    cuts = dict.fromkeys(
        (n_split, split_len) for n in (1, 2, 3, 4, 6, 8, 12, 17, 33, 64)
        if n <= tiles for split_len in [-(-tiles // n) * 64]
        for n_split in [-(-S // split_len)])
    for wph in (1, 2, 4, 8):
        for n_split, split_len in cuts:
            bufs = [DA.buffers(a[0], a[1], n_split, split_len) for a in sets]
            DA._launch(*sets[0], *bufs[0], DA.WARPS, wph)
            got = bufs[0][2].float()
            err = float((got - want).abs().max())
            if (err > lim if q.dtype == torch.bfloat16
                    else not torch.allclose(got, want, **F32_TOL)):
                raise AssertionError(
                    f"decode_attention {label} wph={wph} n_split={n_split}:"
                    f" max |out - plain| {err:.3g} > {lim:.3g}")
            ms = device_ms(lambda: [DA._launch(*a, *b, DA.WARPS, wph)
                                    for a, b in zip(sets, bufs)],
                           20) / len(sets)
            mark = (" (the wrappers' cut)"
                    if (wph, (n_split, split_len)) == default else "")
            log(f"[4 sweep] decode_attention {label}: {wph} warps a kv "
                f"head, {n_split} splits of {split_len} keys: {ms:.4f} ms, "
                + (f"{ms / sdpa_ms:.3f} x SDPA, " if sdpa_ms else "")
                + f"{bound_ms / ms:.3f} of the bound{mark}")
    if power:
        bufs = [DA.buffers(a[0], a[1]) for a in sets]
        runs = {"decode_attention": lambda: [DA._launch(*a, *b) for a, b
                                             in zip(sets, bufs)]}
        if sdpa_ms:
            runs["SDPA"] = sdpa
        for name, fn in runs.items():
            ms = device_ms(fn, 20)
            log(f"[4 sweep] power under {name} at the {label} shape "
                f"({ms:.4f} ms a call): {json.dumps(power_under(fn, ms))}")


def _decode_record(shapes, device, timed: bool, sweep: bool = False) -> dict:
    """decode_attention against its plain version at each of ``shapes``
    ((label, q, k, v, pos), the first one the decode path's, then the
    first calls of the other paths' families, then ``long``), as
    ``_decode_checks`` holds it; at every shape but ``long`` (a call a
    path makes) also against ``attend_decode`` at pos - 1.  Timed over copies that together
    exceed the 50 MB L2 (the path finds each layer's cache cold: the
    whole model's weights stream between two calls on one layer).  The
    record's numbers are the first shape's.  ``sweep``: see
    ``_decode_sweep`` (power at the last shape)."""
    rec = {"name": "decode_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/decode_attention/csrc/"
                     "decode_attention.cu",
           "replaces": "src/repro/kernels/decode_attention/kernel.py:77",
           "launches": 0, "max_abs_err": 0.0, "ms": None, "plain_ms": None,
           "bound_ms": None, "bound_by": "bytes", "library_ms": None}
    for j, (label, q, k, v, pos) in enumerate(shapes):
        B, H, hd = q.shape
        S, K = k.shape[1], k.shape[2]
        err, want, line = _decode_checks(q, k, v, pos,
                                         route=label != "long")
        valid = int(torch.clamp(pos, 0, S).sum())
        nbytes = (2 * valid * K * hd * k.element_size()
                  + 2 * q.numel() * q.element_size() + 4 * B)
        bound_ms = nbytes / PEAK_BYTES_S * 1e3
        ms = plain_ms = lib_ms = None
        if timed:
            n_copy = max(1, -(-64_000_000 // (2 * k.numel() *
                                              k.element_size())))
            sets = [(q, k, v, pos)] + [(q, k.clone(), v.clone(), pos)
                                       for _ in range(n_copy - 1)]
            bufs = [DA.buffers(q, kk) for _, kk, _, _ in sets]
            ms = device_ms(lambda: [DA._launch(*a, *b) for a, b in
                                    zip(sets, bufs)], 20) / n_copy
            plain_ms = device_ms(lambda: [decode_attention_ref(*a)
                                          for a in sets], 3) / n_copy
            mask = (torch.arange(S, device=device)[None, :]
                    < pos[:, None])[:, None, None, :]
            lib = [(q, kk.transpose(1, 2).contiguous(),
                    vv.transpose(1, 2).contiguous(), mask)
                   for _, kk, vv, _ in sets]
            try:
                lib_err = float((_sdpa(*lib[0]).float() - want).abs().max())
                lib_ms = device_ms(lambda: [_sdpa(*a) for a in lib],
                                   5) / n_copy
                line += f", SDPA max |out - plain| {lib_err:.3g}"
            except RuntimeError as e:
                line += f", SDPA refused these inputs: {e}"
            if sweep:
                _decode_sweep(label, sets, want, bound_ms,
                              lambda: [_sdpa(*a) for a in lib], lib_ms,
                              power=j == len(shapes) - 1)
            del sets, bufs, lib
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if j == 0:
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       library_ms=lib_ms)
        log(f"[4 kernels] decode_attention {label} B={B} H={H} K={K} "
            f"hd={hd} S={S} pos={sorted(set(pos.tolist()))} "
            f"{str(q.dtype).replace('torch.', '')}: {line} | "
            + (f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
               + (f"{lib_ms:.4f} ms, " if lib_ms is not None else "none, ")
               if timed else "")
            + f"bound {bound_ms:.4f} ms (bytes, {nbytes / 1e6:.1f} MB)")
    return rec


def wide_topk(q, codes, scales, vecs, n_valid: int, group: int,
              timed: bool) -> None:
    """``quant_topk`` at the flat shape past the path's k: at k = 256 and
    1024 (the large-k route: the product into a distance matrix, then the
    per-query select) and, at the path's k = 20, on group-2 codes of the
    same rows quantized on the host by ``quant.codec.quantize_groups``
    (the per-code scale path).  Each held against its plain version as
    the path's call is, timed beside it and its bound."""
    B, D = q.shape
    c2, s2 = quantize_groups(vecs.cpu().numpy(), 2)
    c2 = torch.as_tensor(c2, device=q.device)
    s2 = torch.as_tensor(s2, device=q.device)
    for label, c, s, g, k in (("k=256", codes, scales, group, 256),
                              ("k=1024", codes, scales, group, 1024),
                              ("group 2", c2, s2, 2, 20)):
        kk = min(k, n_valid)
        err, n_diff = _topk_check(
            f"quant_topk {label}", *QO.quant_topk(q, c, s, kk, g,
                                                  n_valid=n_valid),
            *quant_topk_ref(q, c, s, min(kk + 1, c.shape[0]), g, n_valid),
            kk)
        flops = 2.0 * B * n_valid * D
        nbytes = (B * D * 4 + n_valid * D + n_valid * (D // g) * 4
                  + B * kk * 8)
        bound = max(flops / PEAK_F32_FLOPS_S, nbytes / PEAK_BYTES_S) * 1e3
        line = ""
        if timed:
            def fn(c=c, s=s, g=g, kk=kk):
                return QO.quant_topk(q, c, s, kk, g, n_valid=n_valid)
            ms = device_ms(fn, 10)
            plain_ms = device_ms(lambda: quant_topk_ref(
                q, c, s, kk, g, n_valid), 3)
            line = (f"kernel {ms:.4f} ms ({bound / ms:.3f} of the bound), "
                    f"plain {plain_ms:.4f} ms, device time by kernel "
                    f"{kernel_split(fn)}, ")
        route = "the large-k route" if kk > QO.K_MAX else "one launch"
        log(f"[4 kernels] quant_topk {label} B={B} n_valid={n_valid} D={D} "
            f"group={g} k={kk} ({route}): "
            f"ids equal up to ties ({n_diff} tied positions differ), max "
            f"|d - plain| {err:.3g} | {line}bound {bound:.4f} ms")


class _PlainWalkCounts(torch.overrides.TorchFunctionMode):
    """Reads, from inside the plain walk (``core/search.py
    batched_beam_search``), each lane's beam steps and its visited marks.
    The loop tests ``active.any()`` once an iteration, so a lane's steps
    are the sum of ``active`` over those tests (a lane that has stopped
    stays stopped); ``visited`` is the one bool tensor it scatters into."""

    def __init__(self):
        super().__init__()
        self.steps = self.visited = None

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.Tensor.any and args[0].dtype == torch.bool \
                and args[0].dim() == 1:
            a = args[0].to(torch.int64)
            self.steps = a if self.steps is None else self.steps + a
        elif func is torch.Tensor.scatter_ and args[0].dtype == torch.bool:
            self.visited = args[0]
        return out


def plain_walk_counts(vectors, adjacency, queries, entry, *, ef: int,
                      max_iters=None):
    """``beam_walk_ref`` on these inputs (the tracer held off) -> (dists,
    ids, each lane's beam steps (B,) int64, and the vector rows each lane
    read at least once (B,) int64: its visited nodes but node 0, which
    the loop marks without a read, plus the entry where that is node
    0)."""
    counts = _PlainWalkCounts()
    was, TRACER.enabled = TRACER.enabled, False
    try:
        with counts:
            d, i = beam_walk_ref(vectors, adjacency, queries, entry, ef=ef,
                                 max_iters=max_iters)
    finally:
        TRACER.enabled = was
    B, n = vectors.shape[:2]
    zeros = torch.zeros(B, dtype=torch.int64, device=queries.device)
    steps = zeros if counts.steps is None else counts.steps
    seen = (zeros if counts.visited is None
            else counts.visited[:, 1:n].sum(1) - (entry != 0).long())
    return d, i, steps, seen + 1


def _walk_parting(launch, args, lane: int, ef: int, max_iters) -> tuple:
    """Where one lane's kernel walk and plain walk part: both rerun on the
    lane alone with ``max_iters`` = 1, 2, ... until their beams' ids
    differ.  Returns (step, positions that differ, relative distance gap
    rank by rank there, and the largest relative gap in f64 between the
    rows the two beams hold at one such position); raises unless they
    part at a tie, the beams' distances equal rank by rank within
    ``TOPK_RTOL`` while their ids differ (two rows the two orders of
    summation rank the other way)."""
    one = tuple(a[lane:lane + 1] for a in args)
    for t in range(1, (max_iters or 2 * ef + 8) + 1):
        dk, ik = (x.cpu().numpy()[0] for x in launch(*one, ef=ef,
                                                     max_iters=t)[:2])
        was, TRACER.enabled = TRACER.enabled, False
        try:
            dp, ip = (x.cpu().numpy()[0] for x in beam_walk_ref(
                *one, ef=ef, max_iters=t))
        finally:
            TRACER.enabled = was
        if np.array_equal(ik, ip):
            continue
        at = np.nonzero(ik != ip)[0]
        with np.errstate(invalid="ignore"):
            gap = np.abs(dk[at] - dp[at]) / np.abs(dp[at])
        if not (np.isfinite(dp[at]).all() and (gap <= TOPK_RTOL).all()):
            raise AssertionError(
                f"lane {lane}: the walks part at step {t} beyond a tie: "
                f"positions {at.tolist()}, ids {ik[at].tolist()} against "
                f"{ip[at].tolist()}, distances {dk[at].tolist()} against "
                f"{dp[at].tolist()}")
        v, q = one[0][0].double(), one[2][0].double()
        n = v.shape[0]

        def d64(ids):
            rows = v[torch.as_tensor(ids, device=v.device).clamp(0, n - 1)]
            return ((rows - q) ** 2).sum(-1).cpu().numpy()
        a, b = d64(ik[at]), d64(ip[at])
        return t, at.tolist(), float(gap.max()), float(
            (np.abs(a - b) / np.maximum(a, b)).max())
    raise AssertionError(f"lane {lane}: its steps differ but its beams "
                         f"never part")


def _walk_round(launch, args, ef: int, max_iters, out, timed: bool) -> dict:
    """One walk launch of a path held against the plain loop on the same
    inputs: ids equal up to ties and distances within ``TOPK_RTOL``
    relative, every lane's steps equal to the plain loop's but in a lane
    whose walks part at a tie (``_walk_parting``), where the two orders
    of a distance's sum rank two rows the other way.  On the card,
    the launch's time (CUDA events), the plain loop's, and the bound:
    the bytes a lane must read at the least (one adjacency row a step,
    each vector row it visited once, the query, the outputs) at the HBM
    peak.  Returns the round's shape, its differences and its times."""
    vectors, adjacency, queries, entry = args
    d, i, steps = out
    d0, i0, steps0, rows = plain_walk_counts(*args, ef=ef,
                                             max_iters=max_iters)
    B, n, D = vectors.shape
    deg = adjacency.shape[2]
    what = f"beam_walk round ({B} lanes, n {n}, D {D}, ef {ef})"
    dk, ik, d0, i0 = (t.cpu().numpy() for t in (d, i, d0, i0))
    ok, n_diff = ids_agree_up_to_ties(ik, i0, d0, rtol=TOPK_RTOL)
    if not ok:
        raise AssertionError(f"{what}: {n_diff} ids differ beyond ties")
    if not np.allclose(dk, d0, rtol=TOPK_RTOL, atol=0):
        raise AssertionError(f"{what}: distances differ beyond "
                             f"rtol {TOPK_RTOL}")
    sk, s0 = steps.cpu().numpy(), steps0.cpu().numpy()
    lanes = np.nonzero(sk != s0)[0]
    if len(lanes) > max(1, B // 100):
        raise AssertionError(f"{what}: steps differ in {len(lanes)} lanes")
    partings = []
    for b in lanes.tolist():
        try:
            partings.append((b, int(sk[b]), int(s0[b]),
                             *_walk_parting(launch, args, b, ef, max_iters)))
        except AssertionError as e:
            raise AssertionError(f"{what}: steps differ in lane {b} ("
                                 f"{sk[b]} against {s0[b]}): {e}") from None
    fin = np.isfinite(d0)
    err = np.where(fin, np.abs(np.where(fin, dk, 0) - np.where(fin, d0, 0)),
                   0.0)
    rel = np.where(fin & (d0 != 0), err / np.where(d0 != 0, np.abs(d0), 1),
                   0.0)
    nbytes = 4 * (int(s0.sum()) * deg + int(rows.sum()) * D
                  + B * (D + 1) + B * ef * 3)
    rec = {"lanes": B, "n": n, "D": D, "deg": deg, "ef": ef,
           "steps_max": int(s0.max()) if B else 0, "ids_differ": n_diff,
           "partings": partings,
           "max_abs_err": float(err.max()) if err.size else 0.0,
           "max_rel_err": float(rel.max()) if rel.size else 0.0,
           "bytes": nbytes, "bound_ms": nbytes / PEAK_BYTES_S * 1e3,
           "upper_bytes": 4 * (int(s0.sum()) * deg * (D + 1) + B * D
                               + B * (D + 1) + B * ef * 3),
           "ms": None, "plain_ms": None}
    if timed:
        rec["ms"] = device_ms(lambda: launch(*args, ef=ef,
                                             max_iters=max_iters), 10)
        rec["plain_ms"] = device_ms(lambda: beam_walk_ref(
            *args, ef=ef, max_iters=max_iters), 2)
    return rec


class WalkCheck:
    """While active, holds each of the first ``limit`` (None: every) walk
    launches whose vectors ``want`` accepts against the plain loop, inside
    the call and on its inputs (``_walk_round``; nothing is kept past the
    call), into ``rounds``.  The path's own call goes to the real launch
    and returns its result, and the check's launches are taken back off
    ``BW.launches``, so the path's answers and counts are unchanged."""

    def __init__(self, want=None, limit=None, timed: bool = True):
        self.want, self.limit, self.timed = want, limit, timed
        self.rounds = []

    def __enter__(self) -> "WalkCheck":
        self.real = BW.launch
        BW.launch = self._call
        return self

    def _call(self, vectors, adjacency, queries, entry, *, ef: int,
              max_iters=None):
        out = self.real(vectors, adjacency, queries, entry, ef=ef,
                        max_iters=max_iters)
        if ((self.limit is None or len(self.rounds) < self.limit)
                and (self.want is None or self.want(vectors))):
            n = BW.launches
            self.rounds.append(_walk_round(
                self.real, (vectors, adjacency, queries, entry), ef,
                max_iters, out, self.timed))
            BW.launches = n
        return out

    def __exit__(self, *exc) -> None:
        BW.launch = self.real


def _walk_record(shapes, timed: bool) -> dict:
    """``beam_walk``'s phase 4 record from ``WalkCheck`` rounds: ``shapes``
    is [(label, rounds)], the first the main path's (phase 5's exact
    graph batch, every round).  ``ms``, ``plain_ms`` and ``bound_ms`` are
    a launch's, the mean over the first shape's rounds; ``max_abs_err``
    is the largest |d - plain| over every round.  Prints a line a
    shape."""
    for label, rounds in shapes:
        if not rounds:
            raise AssertionError(f"beam_walk: no {label} round was checked")
        lanes = [r["lanes"] for r in rounds]
        line = (f"[4 kernels] beam_walk {label}: {len(rounds)} rounds, "
                f"{min(lanes)}-{max(lanes)} lanes, n "
                f"{min(r['n'] for r in rounds)}-"
                f"{max(r['n'] for r in rounds)}, D {rounds[0]['D']}, deg "
                f"{rounds[0]['deg']}, ef {rounds[0]['ef']}, longest lane "
                f"{max(r['steps_max'] for r in rounds)} steps: ids equal up "
                f"to ties ({sum(r['ids_differ'] for r in rounds)} tied "
                f"positions differ), max rel |d - plain| "
                f"{max(r['max_rel_err'] for r in rounds):.3g}, every lane's "
                f"steps equal the plain loop's but "
                f"{sum(len(r['partings']) for r in rounds)} lanes of "
                f"{sum(lanes)} whose walks part at a tie (lane, steps, plain "
                f"steps, step parted, positions, rel gap, rel gap of the "
                f"rows in f64): "
                f"{[p for r in rounds for p in r['partings']][:6]}")
        if timed:
            ms = [r["ms"] for r in rounds]
            us_step = [1e3 * r["ms"] / max(r["steps_max"], 1) for r in rounds]
            line += (f" | kernel {min(ms):.4f}-{max(ms):.4f} ms a launch "
                     f"(sum {sum(ms):.4f}), {min(us_step):.2f}-"
                     f"{max(us_step):.2f} us a step of the longest lane, "
                     f"plain {sum(r['plain_ms'] for r in rounds):.2f} ms")
        upper = (sum(r["upper_bytes"] for r in rounds)
                 / sum(r["bytes"] for r in rounds))
        line += (f", bound (bytes read at the least) "
                 f"{sum(r['bound_ms'] for r in rounds):.4f} ms; every "
                 f"neighbour row a step would be {upper:.2f}x those bytes")
        log(line)
    rounds = shapes[0][1]

    def mean(key):
        return (sum(r[key] for r in rounds) / len(rounds)
                if rounds[0][key] is not None else None)
    return {"name": "beam_walk", "route": "cuda",
            "source": "src/repro_torch/kernels/beam_walk/csrc/beam_walk.cu",
            "replaces": "src/repro/core/search.py:114", "launches": 0,
            "max_abs_err": max(r["max_abs_err"] for _, rs in shapes
                               for r in rs),
            "ms": mean("ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": mean("bound_ms"), "bound_by": "bytes",
            "library_ms": None}


def phase_kernels(store, qstore, data, queries, launches, device, *,
                  k: int = 20, decode_shapes=(), sweep: bool = False,
                  extra_bufs=None, gather_parts=(), walks=()) -> list:
    """Phase 4: each kernel against its plain version at the paths'
    shapes.  gather_blocks: every launch of phases 5, 8-13
    (``gather_launches``: one per span read) on its staged buffers (int32
    graph blocks, f32 vector blocks, int8 codes, f32 scales), exactly
    equal.  quant_topk:
    the flat stage-1 call (all queries against the padded flat int8
    database).  distance_topk: the throughput benchmark's call
    (``queries[:128]`` x ``data[:4096]``, k=10) and the flat f32 twin of
    the quant_topk call.  Top-k ids equal up to ties and distances within
    rtol 1e-5 / atol 1e-3.  decode_attention: ``decode_shapes`` (see
    ``_decode_record``), when given.  beam_walk: the rounds ``WalkCheck``
    held against the plain loop on the paths (``walks``, see
    ``_walk_record``), when given.  ``extra_bufs`` names the buffers
    of the launches phases 10-18 recorded; ``gather_parts`` (label,
    buffer-name prefix) times those launches alone.  Beside the path's
    calls,
    ``quant_topk`` is held at the flat shape at k = 256 and 1024 (the
    large-k route) and on group-2 codes of the same rows (the per-code
    scale path), and ``distance_topk`` at k = 256 (``wide_topk``).  Times
    only on the card; ``sweep`` adds the ``--sweep`` lines."""
    timed = device.type == "cuda"
    bufs = {"graph": torch.as_tensor(store.graph_buf, device=device),
            "vec": torch.as_tensor(store.vec_buf, device=device),
            "codes": torch.as_tensor(qstore.qvec_buf, device=device),
            "scales": torch.as_tensor(qstore.qscale_buf, device=device),
            **(extra_bufs or {})}
    records = [_gather_record(bufs, launches, device, timed, sweep)]
    for label, prefix in gather_parts:
        _gather_part(bufs, [(names, ids) for names, ids in launches
                            if names[0].startswith(prefix)], label, device,
                     timed)

    calls = []           # the timed top-k calls, for ``topk_anatomy``
    codes, scales, vecs, n_valid = flat_view(qstore, device)
    q = torch.as_tensor(queries, dtype=torch.float32, device=device)
    group = qstore.spec.quant_group
    B, D = q.shape
    kk = min(k, n_valid)
    q_err, n_diff = _topk_check(
        "quant_topk", *QO.quant_topk(q, codes, scales, kk, group,
                                     n_valid=n_valid),
        *quant_topk_ref(q, codes, scales, kk + 1, group, n_valid), kk)
    flops = 2.0 * B * n_valid * D
    nbytes = (B * D * 4 + n_valid * D + n_valid * (D // group) * 4
              + B * kk * 8)
    rec = {"name": "quant_topk", "route": "cuda",
           "source": "src/repro_torch/kernels/quant_topk/csrc/quant_topk.cu",
           "replaces": "src/repro/kernels/quant_topk/kernel.py:72",
           "launches": 0, "max_abs_err": q_err, "ms": None,
           "plain_ms": None,
           "bound_ms": max(flops / PEAK_F32_FLOPS_S,
                           nbytes / PEAK_BYTES_S) * 1e3,
           "bound_by": ("operations" if flops / PEAK_F32_FLOPS_S
                        >= nbytes / PEAK_BYTES_S else "bytes"),
           "library_ms": None}
    if timed:
        tile, S = QO.launch_shape(B, n_valid, kk, quant=True)
        bufs_q = QO.buffers(B, kk, S, device)

        def launch(bufs, tile, S):
            QO._launch(q, codes, scales, kk, group, n_valid, bufs, tile, S)
        rec["ms"] = device_ms(lambda: launch(bufs_q, tile, S), 20)
        rec["plain_ms"] = device_ms(lambda: quant_topk_ref(
            q, codes, scales, kk, group, n_valid), 5)
        gemm_ms = product_ms(q, dequantize_ref(codes[:n_valid],
                                               scales[:n_valid], group))
        log(f"[4 kernels] quant_topk: tile {tile}, {S} chunks; device time "
            f"by kernel {kernel_split(lambda: launch(bufs_q, tile, S))}")
        calls.append(("quant_topk flat", launch, B, n_valid, kk, True,
                      flops / 1e9))
        if sweep:
            _topk_sweep("quant_topk", "flat", launch, quant_topk_ref(
                q, codes, scales, kk + 1, group, n_valid), B, n_valid, kk,
                True, rec["bound_ms"], power=True)
    records.append(rec)
    log(f"[4 kernels] quant_topk B={B} N={codes.shape[0]} n_valid={n_valid}"
        f" D={D} group={group} k={kk}: ids equal up to ties ({n_diff} tied"
        f" positions differ), max |d - plain| {q_err:.3g} | "
        + (f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
           f"cuBLAS product alone {gemm_ms:.4f} ms, " if timed else "")
        + f"library none, bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']}, {flops / 1e9:.1f} GFLOP)")
    wide_topk(q, codes, scales, vecs, n_valid, group, timed)
    x_small = torch.as_tensor(data[:4096], device=device)
    records.append(_distance_record(
        [("throughput", q[:128], x_small, x_small.shape[0], 10),
         ("flat f32", q, vecs, n_valid, k),
         ("flat f32 k=256", q, vecs, n_valid, 256)], device, timed, sweep,
        calls))
    if sweep and timed:
        topk_anatomy(calls, device)
    if decode_shapes:
        records.append(_decode_record(decode_shapes, device, timed, sweep))
    if walks:
        records.append(_walk_record(walks, timed))
    return records


KERNEL_OPS = {"gather_blocks": GO, "quant_topk": QO, "distance_topk": DO,
              "decode_attention": DA, "beam_walk": BW}


def _reset_launches() -> None:
    for ops in KERNEL_OPS.values():
        ops.launches = 0
    DA.partial_launches = 0


def _launches() -> dict:
    return {name: ops.launches for name, ops in KERNEL_OPS.items()}


def _search(eng, queries, k: int, device):
    """One main-path batch: every launch count is set to 0 just before it
    and read just after.  Returns (d, g, stats, wall s, launches)."""
    if device.type == "cuda":
        torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    d, g, st = eng.search(queries, k=k)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return d, g, st, wall, _launches()


def _in_turns(make_engine, variants, queries, k: int, device,
              n_batches: int = 1) -> dict:
    """Search the queries in ``n_batches`` batches with a fresh engine per
    variant, in turns (a, b, b, a), so that neither variant alone pays the
    warm-up.  Returns variant -> the first run's batches, each (d, g,
    stats, wall s, launches), and every run's batch walls."""
    per = len(queries) // n_batches
    out = {}
    for v in (*variants, *variants[::-1]):
        eng = make_engine(v)
        runs = [_search(eng, queries[i * per:(i + 1) * per], k, device)
                for i in range(n_batches)]
        walls = [r[3] for r in runs]
        if v in out:
            out[v]["walls"].append(walls)
        else:
            out[v] = {"batches": runs, "walls": [walls]}
    return out


def _host_split(st) -> str:
    return (f"route {st['meta_s']:.3f} s, plan {st['plan_s']:.3f} s, "
            f"serve {st['sub_s']:.3f} s")


def _counted_equal(st, other) -> bool:
    """The counted stats of two searches are equal."""
    keys = ("net", "n_rounds", "n_pairs", "cache_hits", "n_fetches",
            "rerank_rows", "rerank_hit_rows", "exact_admitted")
    return all(st.get(key) == other.get(key) for key in keys)


def _check_output(d, g, B: int, k: int, n: int, what: str) -> None:
    if d.shape != (B, k) or g.shape != (B, k):
        raise AssertionError(f"{what}: shapes {d.shape} {g.shape}")
    if not np.isfinite(d).all():
        raise AssertionError(f"{what}: non-finite distances")
    if not ((g >= 0) & (g < n)).all():
        raise AssertionError(f"{what}: gids outside [0, {n})")


def _counted(st) -> str:
    net = st["net"]
    return (f"net trips={net['round_trips']} descs={net['descriptors']} "
            f"bytes={net['bytes']:.0f} saved={net['bytes_saved']:.0f} | "
            f"rounds={st['n_rounds']} pairs={st['n_pairs']} "
            f"cache_hits={st['cache_hits']} fetches={st['n_fetches']}")


def phase_exact(ds, meta, store, device, *, k: int, doorbell: int,
                gathers, recall_floor: float = 0.0) -> dict:
    """Phase 5: exact search through the CUDA doorbell gather, held
    against the same engine with the gather off (an exact copy, so the
    results must be equal).  ``gathers`` is ``main_path_gathers``' result:
    each batch must fetch the spans it planned, in one gather launch per
    round (span read), so phase 4 timed the launches made here.
    On the card a graph batch walks each round in one ``beam_walk``
    launch, a scan batch in none.  Returns the gather and walk launches
    of the path, the scan batch's stats (its recall@k under
    ``recall_at_k``) and each search mode's first batch with the gather
    on (d, g, stats)."""
    launches = walks = 0
    batches = {}
    round_ids, n_fetches = gathers
    B, n = ds.queries.shape[0], ds.data.shape[0]
    for search_mode in ("graph", "scan"):
        def make(gather, search_mode=search_mode):
            cfg = exact_config(meta.n_partitions, doorbell, search_mode,
                               gather)
            return DHNSWEngine(cfg, device=device).adopt_built(
                meta, dataclasses.replace(store), ds.data)
        outs = _in_turns(make, (False, True), ds.queries, k, device)
        on, off = outs[True], outs[False]
        d, g, st, _, n_on = on["batches"][0]
        d0, g0, _, _, n_off = off["batches"][0]
        batches[search_mode] = (d, g, st)
        n_launch = n_on["gather_blocks"]
        if n_off["gather_blocks"]:
            raise AssertionError("gather_blocks launched with the gather off")
        want = len(round_ids) if device.type == "cuda" else 0
        if n_launch != want or st["n_fetches"] != n_fetches:
            raise AssertionError(
                f"exact {search_mode}: {n_launch} gather launches and "
                f"{st['n_fetches']} fetches, planned {want} and {n_fetches}")
        launches += n_launch
        want = (st["n_rounds"] if device.type == "cuda"
                and search_mode == "graph" else 0)
        if n_on["beam_walk"] != want or n_off["beam_walk"] != want:
            raise AssertionError(
                f"exact {search_mode}: {n_on['beam_walk']} and "
                f"{n_off['beam_walk']} walk launches, {want} rounds")
        walks += n_on["beam_walk"]
        _check_output(d, g, B, k, n, f"exact {search_mode}")
        if not (np.array_equal(g, g0) and np.array_equal(d, d0)):
            raise AssertionError(f"exact {search_mode}: gather kernel on/off "
                                 "results differ")
        rec = recall_at_k(g, ds.gt_ids[:, :k])
        if rec < recall_floor:
            raise AssertionError(f"exact {search_mode}: recall@{k} {rec}")
        log(f"[5 exact {search_mode}] recall@{k}={rec:.4f} | {_counted(st)}"
            f" | gather launches {n_launch} | wall s gather on "
            f"{[w[0] for w in on['walls']]}, off "
            f"{[w[0] for w in off['walls']]} (off, on, on, off) | walk "
            f"launches {n_on['beam_walk']} | host split (on, first run): "
            f"{_host_split(st)} | equal to gather off")
    st["recall_at_k"] = rec          # the scan batch's, phase 10's floor
    return {"gather_blocks": launches, "beam_walk": walks}, st, batches


def phase_walk(ds, meta, store, device, *, k: int, doorbell: int,
               graph_batch) -> list:
    """Phase 5w: phase 5's exact graph batch once more, on a fresh engine
    with the gather on, with every round's ``beam_walk`` launch held
    against the plain loop on its own inputs (``WalkCheck``): ids equal
    up to ties, distances within rtol 1e-5, every lane's steps equal, and
    the launch and the plain loop timed.  The batch's gids and counted
    stats must equal phase 5's (``graph_batch``: d, g, stats).  Returns
    the rounds for phase 4 (none off the card: there the walk is the
    plain loop and launches nothing)."""
    if device.type != "cuda":
        return []
    t0 = time.perf_counter()
    eng = DHNSWEngine(exact_config(meta.n_partitions, doorbell, "graph"),
                      device=device).adopt_built(
        meta, dataclasses.replace(store), ds.data)
    with WalkCheck() as check:
        d, g, st, _, n = _search(eng, ds.queries, k, device)
    d5, g5, st5 = graph_batch
    if not (np.array_equal(g, g5) and np.array_equal(d, d5)
            and _counted_equal(st, st5)):
        raise AssertionError("5w: the checked graph batch differs from "
                             "phase 5's")
    if n["beam_walk"] != st["n_rounds"] or len(check.rounds) != n[
            "beam_walk"]:
        raise AssertionError(f"5w: {n['beam_walk']} walk launches, "
                             f"{len(check.rounds)} checked, "
                             f"{st['n_rounds']} rounds")
    parted = sum(len(r["partings"]) for r in check.rounds)
    log(f"[5w walk] exact graph batch of {len(ds.queries)}: every one of "
        f"its {len(check.rounds)} walk launches equal to the plain loop "
        f"up to ties, every lane's steps equal but in {parted} lanes "
        f"whose walks part at a tie | "
        f"{time.perf_counter() - t0:.1f} s with the checks")
    return check.rounds


def phase_int8(ds, meta, qstore, device, *, k: int, doorbell: int,
               recall_floor: float = 0.0) -> dict:
    """Phase 6: int8 staged search with the flat stage 1 through the CUDA
    ``quant_topk`` ("auto"), held against the plain stage 1 ("ref")."""
    B, n = ds.queries.shape[0], ds.data.shape[0]

    def make(qk):
        cfg = flat_config(meta.n_partitions, doorbell, qk)
        return DHNSWEngine(cfg, device=device).adopt_built(
            meta, dataclasses.replace(qstore), ds.data)
    outs = _in_turns(make, ("ref", "auto"), ds.queries, k, device)
    auto, ref = outs["auto"], outs["ref"]
    d, g, st, _, n_auto = auto["batches"][0]
    dr, gr, sr, _, n_ref = ref["batches"][0]
    launches = n_auto["quant_topk"]
    want = "cuda" if device.type == "cuda" else "ref"
    if st["stage1_impl"] != want or sr["stage1_impl"] != "ref":
        raise AssertionError(f"stage1_impl {st['stage1_impl']} / "
                             f"{sr['stage1_impl']}")
    if device.type == "cuda" and launches == 0:
        raise AssertionError("quant_topk was not launched")
    if n_ref["quant_topk"]:
        raise AssertionError("quant_topk launched under quant_kernel='ref'")
    _check_output(d, g, B, k, n, "int8 flat")
    # the reference list for ties: the plain run's own top-k, extended by
    # one rank of +inf so the last place can only differ at a tie
    ext_d = np.concatenate([dr, np.full((B, 1), np.inf, np.float32)], 1)
    ext_g = np.concatenate([gr, np.full((B, 1), -1, gr.dtype)], 1)
    ok, n_diff = ids_agree_up_to_ties(g, ext_g, ext_d, rtol=TOPK_RTOL)
    if not ok:
        raise AssertionError(f"int8 flat: gids differ from the plain stage "
                             f"1 beyond ties ({n_diff} positions)")
    np.testing.assert_allclose(d, dr, rtol=TOPK_RTOL, atol=TOPK_ATOL)
    rec = recall_at_k(g, ds.gt_ids[:, :k])
    if rec < recall_floor:
        raise AssertionError(f"int8 flat: recall@{k} {rec}")
    log(f"[6 int8 flat] recall@{k}={rec:.4f} (ref stage 1: "
        f"{recall_at_k(gr, ds.gt_ids[:, :k]):.4f}) | {_counted(st)} | "
        f"stage1_impl={st['stage1_impl']} flat_rows={st['flat_rows']} "
        f"rerank_rows={st['rerank_rows']} | quant_topk launches {launches}"
        f" | wall s auto {[w[0] for w in auto['walls']]}, ref "
        f"{[w[0] for w in ref['walls']]} (ref, auto, "
        f"auto, ref) | host split (auto, first run): {_host_split(st)} | "
        f"{n_diff} positions differ from the ref, all at ties")
    return {"quant_topk": launches}


def phase_throughput(ds, meta, store, device, *, preset: dict,
                     scan_stats) -> dict:
    """Phase 7: ``benchmarks/torch_throughput.run`` on the index of phase
    3.  Its doorbell-16 row is the first batch of ``preset["batch"]``
    queries on a fresh scan engine with ``cache_frac`` 0.10, as phase 5's
    exact scan batch is, so it must count the same trips, bytes, hits and
    fetches.  Returns the path's kernel launches."""
    log(f"[7 throughput] benchmarks/torch_throughput.py, preset "
        f"{json.dumps(preset)}:")
    if device.type == "cuda":
        torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    rows = torch_throughput.run((meta, store, ds.data), preset=preset, ds=ds,
                                device=device)
    wall = time.perf_counter() - t0
    launches = _launches()
    if device.type == "cuda" and launches["distance_topk"] == 0:
        raise AssertionError("distance_topk was not launched on the "
                             "throughput path")
    db16 = next(r for r in rows if r["name"] == "doorbell/width16")
    net = scan_stats["net"]
    want = {"trips": net["round_trips"], "bytes": int(net["bytes"]),
            "hits": scan_stats["cache_hits"],
            "fetches": scan_stats["n_fetches"]}
    got = {key: db16[key] for key in want}
    if got != want:
        raise AssertionError(f"doorbell/width16 counted {got}, the exact scan"
                             f" batch of phase 5 {want}")
    log(f"[7 throughput] {len(rows)} rows in {wall:.1f} s | doorbell/width16 "
        f"counts what phase 5's scan batch counted {want} | launches "
        f"{launches}")
    return {"distance_topk": launches["distance_topk"]}


def phase_int8_pairs(ds, meta, qstore, device, *, k: int, doorbell: int,
                     gathers, n_batches: int = PAIR_BATCHES,
                     recall_floor: float = 0.0) -> dict:
    """Phase 8: int8 search through the per-pair stage 1
    (``pairs_config``) in both search modes over the queries in
    ``n_batches`` batches, so the tiers are reused.  Each mode runs with
    the CUDA gather and is held against the same engine with the gather
    off, in turns (an exact copy: gids, distances and counted stats
    equal).  ``gathers`` maps each mode to ``pair_path_gathers``' result:
    each batch must fetch the spans it planned, in one gather launch per
    round (span read), so phase 4 checked and timed the launches made
    here.  Returns the gather launches of the path."""
    B, n = ds.queries.shape[0], ds.data.shape[0]
    per = B // n_batches
    launches = 0
    for search_mode in ("scan", "graph"):
        def make(gather, search_mode=search_mode):
            cfg = pairs_config(meta.n_partitions, doorbell, search_mode,
                               gather)
            return DHNSWEngine(cfg, device=device).adopt_built(
                meta, dataclasses.replace(qstore), ds.data)
        outs = _in_turns(make, (False, True), ds.queries, k, device,
                         n_batches=n_batches)
        on, off = outs[True], outs[False]
        recs = []
        n_mode = 0
        for i, ((d, g, st, _, n_on), (d0, g0, st0, _, n_off),
                (round_ids, n_fetches)) in enumerate(zip(
                    on["batches"], off["batches"], gathers[search_mode])):
            what = f"int8 pairs {search_mode} batch {i}"
            if n_off["gather_blocks"]:
                raise AssertionError("gather_blocks launched with the gather "
                                     "off")
            if st["exact_admitted"]:
                raise AssertionError(
                    f"{what}: {st['exact_admitted']} spans admitted to the "
                    "exact tier, whose reads phase 4 did not plan")
            want = len(round_ids) if device.type == "cuda" else 0
            if n_on["gather_blocks"] != want or st["n_fetches"] != n_fetches:
                raise AssertionError(
                    f"{what}: {n_on['gather_blocks']} gather launches and "
                    f"{st['n_fetches']} fetches, planned {want} and "
                    f"{n_fetches}")
            n_mode += n_on["gather_blocks"]
            _check_output(d, g, per, k, n, what)
            if not (np.array_equal(g, g0) and np.array_equal(d, d0)
                    and _counted_equal(st, st0)):
                raise AssertionError(f"{what}: gather kernel on/off results "
                                     "differ")
            if "stage1_impl" in st or "quant_kernel" in st:
                raise AssertionError("the per-pair route names a stage 1")
            recs.append(recall_at_k(g, ds.gt_ids[i * per:(i + 1) * per, :k]))
            log(f"[8 int8 pairs {search_mode}] batch {i} of {per}: "
                f"{_counted(st)} | rerank_rows={st['rerank_rows']} "
                f"hit_rows={st['rerank_hit_rows']} admitted="
                f"{st['exact_admitted']} | gather launches "
                f"{n_on['gather_blocks']} | wall s gather on "
                f"{[w[i] for w in on['walls']]}, off "
                f"{[w[i] for w in off['walls']]} (off, on, on, off) | host "
                f"split (on, first run): {_host_split(st)}")
        rec = float(np.mean(recs))
        if rec < recall_floor:
            raise AssertionError(f"int8 pairs {search_mode}: recall@{k} {rec}")
        launches += n_mode
        log(f"[8 int8 pairs {search_mode}] recall@{k}={rec:.4f} over "
            f"{n_batches} batches | gather launches {n_mode} | wall s of the "
            f"{n_batches} batches gather on "
            f"{[sum(w) for w in on['walls']]}, off "
            f"{[sum(w) for w in off['walls']]} | equal to gather off")
    return {"gather_blocks": launches}


class FirstCall:
    """While active, records (cloned) the arguments of the first call of
    ``module.name``; every call still goes through to the real function,
    so its launches count as before."""

    def __init__(self, module, name: str):
        self.module, self.name, self.args = module, name, None

    def __enter__(self) -> "FirstCall":
        self.real = getattr(self.module, self.name)
        setattr(self.module, self.name, self._call)
        return self

    def _call(self, *args, **kw):
        if self.args is None:
            self.args = tuple(a.clone() for a in args)
        return self.real(*args, **kw)

    def __exit__(self, *exc) -> None:
        setattr(self.module, self.name, self.real)


def _busy_us(intervals) -> float:
    """Microseconds covered by the union of (start, end) intervals."""
    busy, end = 0.0, -np.inf
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def profile_serve(eng, prompts, decode_s: float) -> None:
    """One more ``eng.serve(prompts)`` under ``torch.profiler`` (CPU and
    CUDA activity): the device's busy share over the decode loop, the
    window the engine marks with ``DECODE_SPAN``, and the kernels' device
    time by name inside it.  ``decode_s`` is an unprofiled call's decode
    time (the same work: the same prompts and tokens), printed beside the
    profiled one as the profiler's cost; the device's busy time is held
    against both, since the profiler's host tracing slows only the
    host.  Prints
    "not measured" when the profiler records no device event.  Its
    launches are not the main path's: the caller sets the counts to 0
    afterwards."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    on_card = eng.device.type == "cuda"
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])) as prof:
        eng.serve(prompts)
    # the raw events: building prof.events()' tree takes tens of seconds at
    # this count (some 3000 host operations and as many kernels a step)
    events = [(e.name(), e.device_type(), e.start_ns() / 1e3,
               e.end_ns() / 1e3)
              for e in prof.profiler.kineto_results.events()]
    spans = [(s, t) for name, dt, s, t in events
             if name == DECODE_SPAN and dt == DeviceType.CPU]
    if len(spans) != 1:
        raise AssertionError(f"rag profile: {len(spans)} {DECODE_SPAN} "
                             f"ranges, want 1")
    a, b = spans[0]
    kern = [(name, max(s, a), min(t, b)) for name, dt, s, t in events
            if dt == DeviceType.CUDA and name != DECODE_SPAN and t > a
            and s < b]
    n_steps, wall_us = eng.max_new_tokens, b - a
    head = (f"[9 rag] decode profile: one more serve call, {n_steps} steps "
            f"in {wall_us / 1e3:.3f} ms ({wall_us / n_steps / 1e3:.3f} ms a "
            f"step profiled, {decode_s / n_steps * 1e3:.3f} ms unprofiled), "
            f"profiled and read in {time.perf_counter() - t0:.1f} s")
    if not kern:
        log(f"{head}; device busy share not measured (the profiler recorded "
            f"no device event)")
        return
    busy = _busy_us([(s, t) for _, s, t in kern])
    by: dict = {}          # kernel name -> [device us, count]
    for name, s, t in kern:
        name = "decode_attention" if "decode_attention" in name else name[:48]
        acc = by.setdefault(name, [0.0, 0])
        acc[0] += t - s
        acc[1] += 1
    top = sorted(by.items(), key=lambda kv: -kv[1][0])[:6]
    att_us, att_n = by.get("decode_attention", [0.0, 0])
    log(f"{head} | {len(kern)} device events | device busy "
        f"{busy / 1e3:.3f} ms ({busy / n_steps / 1e3:.3f} ms a step): busy "
        f"share {busy / wall_us:.4f} of the profiled window (idle "
        f"{1 - busy / wall_us:.4f}), {busy / (decode_s * 1e6):.4f} of the "
        f"unprofiled call's decode time (idle "
        f"{1 - busy / (decode_s * 1e6):.4f}) | decode_attention "
        f"{att_us / 1e3:.3f} ms in {att_n} launches, {att_us / max(att_n, 1):.2f} us each "
        f"(on the path's cold caches) | device ms by kernel, top 6: "
        + "; ".join(f"{k} {v[0] / 1e3:.3f} ({v[1]})" for k, v in top))


def _rag_calls(eng, prompts, gathers, capture, *, want_decode: int,
               on_card: bool) -> tuple:
    """Phase 9's counted ``serve`` calls, one per entry of ``gathers``
    (``rag_path_gathers``' plan), the first under ``capture``.  Each call
    is checked against its plan and ``want_decode`` decode_attention
    launches.  Returns (tokens per call, launches summed, the last call's
    decode seconds)."""
    cfg = eng.cfg
    B, Sp = prompts.shape
    S = eng.docs_per_query * eng.docs.tokens.shape[1] + Sp
    n_new = eng.max_new_tokens
    outs, launches = [], {name: 0 for name in KERNEL_OPS}
    for i, (round_ids, n_fetches) in enumerate(gathers):
        if on_card:
            torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        if i == 0:
            with capture:
                out, st = eng.serve(prompts)
        else:
            out, st = eng.serve(prompts)
        wall = time.perf_counter() - t0
        n = _launches()
        r = st.retrieval
        want_gather = len(round_ids) if on_card else 0
        if n["decode_attention"] != want_decode:
            raise AssertionError(f"rag call {i}: {n['decode_attention']} "
                                 f"decode_attention launches, want "
                                 f"{want_decode}")
        if n["gather_blocks"] != want_gather or r["n_fetches"] != n_fetches:
            raise AssertionError(
                f"rag call {i}: {n['gather_blocks']} gather launches and "
                f"{r['n_fetches']} fetches, planned {want_gather} and "
                f"{n_fetches}")
        if out.shape != (B, n_new) or not (
                (out >= 0) & (out < cfg.vocab_size)).all():
            raise AssertionError(f"rag call {i}: tokens {out.shape} out of "
                                 f"range")
        outs.append(out)
        for key in launches:
            launches[key] += n[key]
        net = r["net"]
        log(f"[9 rag] call {i}: wall {wall:.4f} s = retrieve "
            f"{st.retrieve_s:.4f} s + prefill {st.prefill_s:.4f} s (S={S}) "
            f"+ decode {st.decode_s:.4f} s ({B * n_new / st.decode_s:.1f} "
            f"tokens/s, {st.decode_s / n_new * 1e3:.3f} ms a step) | "
            f"retrieval: trips={net['round_trips']} bytes={net['bytes']:.0f}"
            f" fetches={r['n_fetches']} cache_hits={r['cache_hits']} | "
            f"launches {n}")
    return outs, launches, st.decode_s


def phase_rag(ds, meta, store, device, *, cfg, doorbell: int, doc_len: int,
              prompt_len: int, batch: int, max_new_tokens: int,
              docs_per_query: int, n_calls: int, seed: int = SEED) -> tuple:
    """Phase 9: ``RagServeEngine.serve`` with ``cfg`` over phase 5's
    exact-scan engine (the CUDA gather on), whose indexed vectors are the
    documents' embeddings; each document is ``doc_len`` tokens drawn with
    numpy from the seed, and so are the ``batch`` prompts.  ``n_calls``
    calls serve the same prompts: the tokens must be in range and equal
    across calls, every decode layer of a window-free, softcap-free model
    must go through ``decode_attention`` (``n_layers * max_new_tokens``
    launches a call on the card), and each call's retrieval must fetch
    the spans ``rag_path_gathers`` planned, in one gather launch per
    round.  Then ``profile_serve`` measures the
    device's busy share over the decode loop of one more call (not
    counted).  Returns (launches, the planned gathers, the inputs of the
    first decode_attention call)."""
    rng = np.random.default_rng(seed)
    docs = DocStore(ds.data, rng.integers(0, cfg.vocab_size,
                                          (len(ds.data), doc_len),
                                          dtype=np.int32))
    prompts = rng.integers(0, cfg.vocab_size, (batch, prompt_len),
                           dtype=np.int32)
    retriever = DHNSWEngine(exact_config(meta.n_partitions, doorbell, "scan"),
                            device=device).adopt_built(
        meta, dataclasses.replace(store), ds.data)
    t0 = time.perf_counter()
    eng = RagServeEngine(cfg, retriever, docs, max_new_tokens=max_new_tokens,
                         docs_per_query=docs_per_query, seed=seed,
                         device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in
                  [*eng.params["blocks"].values(), eng.params["embed"],
                   eng.params["final_norm"], eng.params["unembed"]])
    log(f"[9 rag] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} x {cfg.the_head_dim()}, vocab "
        f"{cfg.vocab_size}: weights {n_bytes / 1e9:.2f} GB drawn on "
        f"{device} in {time.perf_counter() - t0:.2f} s | docs "
        f"{len(ds.data)} x {doc_len} tokens, prompts {batch} x {prompt_len},"
        f" {docs_per_query} docs a prompt, {max_new_tokens} new tokens")
    gathers = rag_path_gathers(meta, store, eng._embed(prompts), device,
                               doorbell=doorbell, n_calls=n_calls)
    on_card = device.type == "cuda"
    want_decode = cfg.n_layers * max_new_tokens if on_card else 0
    capture = FirstCall(DA, "decode_attention")
    try:
        outs, launches, decode_s = _rag_calls(
            eng, prompts, gathers, capture, want_decode=want_decode,
            on_card=on_card)
        if any(not np.array_equal(outs[0], o) for o in outs[1:]):
            raise AssertionError("rag: the calls generated different tokens")
        if on_card and launches["gather_blocks"] == 0:
            raise AssertionError("rag: the gather kernel did not launch on "
                                 "the retrieval")
        log(f"[9 rag] {n_calls} calls generated equal tokens; first "
            f"sequence {outs[0][0][:8].tolist()}... | launches {launches}")
        profile_serve(eng, prompts, decode_s)
    finally:
        eng.close()
    _reset_launches()
    del eng
    _free(device)
    return launches, gathers, capture.args


# ------------------------------------------------------ insert and load

class CallLog:
    """While active, records every call of ``module.name`` (its buffers
    and a clone of its block ids: ``gather_spans(bufs, ids)``); each call
    still goes through to the real function, so its launches count."""

    def __init__(self, module, name: str):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self) -> "CallLog":
        self.real = getattr(self.module, self.name)
        setattr(self.module, self.name, self._call)
        return self

    def _call(self, bufs, ids):
        self.calls.append((tuple(bufs), ids.clone()))
        return self.real(bufs, ids)

    def __exit__(self, *exc) -> None:
        setattr(self.module, self.name, self.real)


class PathLog:
    """The launches and gather calls of a path's searches (phases 10-15):
    inside ``path()`` every launch count starts at 0 and is read at the
    end (into the dict it yields, and summed into ``launches``), and each
    ``gather_spans`` call is recorded (its buffers and ids) so phase 4
    holds the gather at these launches; on the card the gather launches
    must equal the recorded calls.  ``search`` runs one batch as a path
    and leaves in ``trips`` the round trips a sharded pool's ledger must
    have charged for it (``FanoutTrips``; None for other pools)."""

    def __init__(self, device):
        self.device = device
        self.launches = {name: 0 for name in KERNEL_OPS}
        self.calls = []
        self.trips = None

    @contextlib.contextmanager
    def path(self):
        n = {}
        with CallLog(GO, "gather_spans") as calls:
            _reset_launches()
            yield n
            n.update(_launches())
        for name, c in n.items():
            self.launches[name] += c
        if self.device.type == "cuda" and (n["gather_blocks"]
                                           != len(calls.calls)):
            raise AssertionError("gather launches and recorded calls differ")
        self.calls += calls.calls

    def search(self, eng, queries, k: int):
        with FanoutTrips(eng.pool) as trips, self.path():
            out = _search(eng, queries, k, self.device)
        self.trips = trips.total
        return out


def recorded_launches(calls, bufs: dict, tag: str) -> list:
    """Recorded ``gather_spans`` calls as ``gather_launches`` entries: each
    staged buffer gets a name in ``bufs`` (``tag`` and a serial number,
    one per distinct tensor), so phase 4 holds and times the launches on
    the very tensors they read."""
    names = {}
    for b, _ in calls:
        for t in b:
            if id(t) not in names:
                names[id(t)] = f"{tag}{len(names)}"
                bufs[names[id(t)]] = t
    return [(tuple(names[id(t)] for t in b), ids) for b, ids in calls]


class InsertClock:
    """Host seconds of the insert path's parts while active, each device
    part ended by a sync: ``route`` (the meta-HNSW routing), ``host``
    (the host region's writes: ``layout.insert_vector`` and the int8
    mirror's re-quantize), ``device`` (the device twin's scatters) and
    ``repack`` (the whole repack verb, its re-stage included; the parts
    inside it are not counted again)."""

    PARTS = ("route", "host", "device", "repack")

    def __init__(self, eng):
        self.eng = eng
        self.sec = dict.fromkeys(self.PARTS, 0.0)
        self._in_repack = False
        self._undo = []

    def _sync(self) -> None:
        if self.eng.device.type == "cuda":
            torch.cuda.synchronize()

    def _wrap(self, owner, name: str, part: str, instance: bool) -> None:
        real = getattr(owner, name)

        def timed(*a, **kw):
            if self._in_repack:
                return real(*a, **kw)
            self._in_repack = part == "repack"
            t0 = time.perf_counter()
            try:
                out = real(*a, **kw)
                self._sync()
            finally:
                self._in_repack = False
            self.sec[part] += time.perf_counter() - t0
            return out
        setattr(owner, name, timed)
        self._undo.append((owner, name, real, instance))

    def __enter__(self) -> "InsertClock":
        c = self.eng.client
        for owner, name, part, inst in (
                (c, "_route", "route", True),
                (LA, "insert_vector", "host", False),
                (LA, "refresh_quant_blocks", "host", False),
                (DS, "overflow_append", "device", False),
                (DS, "overflow_append_quant", "device", False),
                (c.pool, "repack", "repack", True)):
            self._wrap(owner, name, part, inst)
        return self

    def __exit__(self, *exc) -> None:
        for owner, name, real, inst in reversed(self._undo):
            if inst:
                delattr(owner, name)
            else:
                setattr(owner, name, real)
        self._undo = []


def _timed_insert(eng, vecs) -> tuple:
    """``eng.insert(vecs)`` under an ``InsertClock``: (gids, wall s, the
    clock's parts)."""
    on_card = eng.device.type == "cuda"
    with InsertClock(eng) as clock:
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        gids = eng.insert(vecs)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return gids, wall, clock.sec


def _region_equal(pool, what: str) -> None:
    """The pool's device region, copied back to the host, equals the host
    region bit for bit: graph and vector blocks, the int8 codes and
    scales when attached, and the meta table (``read_meta``)."""
    st = pool.store
    pairs = [("graph", pool._g_dev, st.graph_buf),
             ("vec", pool._v_dev, st.vec_buf),
             ("meta", pool.read_meta(), st.meta_table)]
    if pool._qv_dev is not None:
        pairs += [("codes", pool._qv_dev, st.qvec_buf),
                  ("scales", pool._qs_dev, st.qscale_buf)]
    for name, dev, host in pairs:
        got = dev.cpu().numpy()
        if (got.dtype != host.dtype or got.shape != host.shape
                or got.tobytes() != np.ascontiguousarray(host).tobytes()):
            raise AssertionError(f"{what}: the device {name} region differs "
                                 f"from the host's")


def _flat_equal_to_sync(client, what: str) -> int:
    """The int8 flat view grown by inserts (codes, scales and the payload
    twin, row for row by region row) equals a fresh ``_sync_flat`` of the
    same store.  Returns the view's rows."""
    from repro_torch.core.cost_model import NetLedger
    n = client._flat_n
    grown = [t[:n].cpu() for t in (client._flat_codes, client._flat_scales,
                                   client._flat_cols)]
    rows = client._flat_idx[:n].copy()
    client._sync_flat(NetLedger(client.cfg.fabric))
    if client._flat_n != n:
        raise AssertionError(f"{what}: flat view of {n} rows, a fresh sync "
                             f"has {client._flat_n}")
    at = {int(r): j for j, r in enumerate(client._flat_idx[:n])}
    if len(at) != n or set(at) != {int(r) for r in rows}:
        raise AssertionError(f"{what}: the flat view's rows differ from a "
                             f"fresh sync's")
    perm = torch.as_tensor([at[int(r)] for r in rows])
    fresh = (client._flat_codes, client._flat_scales, client._flat_cols)
    for name, old, new in zip(("codes", "scales", "cols"), grown, fresh):
        if not torch.equal(old, new[:n].cpu()[perm]):
            raise AssertionError(f"{what}: flat {name} differ from a fresh "
                                 f"sync")
    return n


def brute_force_gt(data: np.ndarray, queries: np.ndarray, k: int,
                   device) -> np.ndarray:
    """Exact top-k ids of ``queries`` over ``data`` (squared L2 in f32,
    TF32 off), computed on ``device`` in blocks of queries."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.as_tensor(data, device=device)
    x2 = (x * x).sum(-1)
    out = []
    for s in range(0, len(queries), 256):
        q = torch.as_tensor(queries[s:s + 256], device=device)
        d = (q * q).sum(-1, keepdim=True) - 2.0 * (q @ x.T) + x2[None]
        out.append(torch.topk(d, k, largest=False).indices.cpu().numpy())
    return np.concatenate(out)


def burst_target(eng, data: np.ndarray, n_burst: int) -> int:
    """A base row whose partition a burst of ``n_burst`` near copies can
    overflow and repack without a full rebuild: both partitions of its
    group (the one ``data[t]`` routes to and its partner) hold at most
    ``np_max - n_burst`` rows, overflow included.  The first such row in
    row order."""
    store, spec = eng.store, eng.store.spec
    mt = store.meta_table
    ov = mt[:, LA.MT_OV_A] + mt[:, LA.MT_OV_B]
    size = np.asarray(store.n_base) + ov
    fits = np.zeros(spec.n_partitions, bool)
    for p in range(spec.n_partitions):
        g = int(mt[p, LA.MT_GROUP])
        fits[p] = all(size[q] + n_burst <= spec.np_max
                      for q in (2 * g, 2 * g + 1) if q < spec.n_partitions)
    cand = np.nonzero(fits[eng.meta.assignments])[0]
    for t in cand[:64]:
        pid = int(eng.client._route(eng.client._t(data[t:t + 1]), b=1)[0, 0])
        if fits[pid]:
            return int(t)
    raise AssertionError("no partition can take the burst without a full "
                         "rebuild")


def _self_recall(eng, vecs, gids, k: int = 10) -> float:
    """Share of ``vecs`` whose nearest result is their own gid."""
    _, g, _ = eng.search(vecs, k=k)
    return float(np.mean(g[:, 0] == np.asarray(gids)))


def _insert_line(label: str, n: int, wall: float, sec: dict) -> str:
    other = wall - sum(sec.values())
    return (f"{label}: {n} inserts in {wall:.4f} s, "
            f"{wall / n * 1e6:.1f} us an insert = route "
            f"{sec['route'] / n * 1e6:.1f} + host write "
            f"{sec['host'] / n * 1e6:.1f} + device twin "
            f"{sec['device'] / n * 1e6:.1f} + repack "
            f"{sec['repack'] / n * 1e6:.1f} + other {other / n * 1e6:.1f} us"
            f" (repack {sec['repack']:.4f} s)")


def phase_insert(ds, meta, store, qstore, device, *, k: int, doorbell: int,
                 scan_recall: float, n_held: int = 256, burst_extra: int = 8,
                 seed: int = 1) -> tuple:
    """Phase 10: insert at full size, on deep copies of phase 3's store
    and qstore (no other phase sees a mutation).  The exact-scan engine
    of phase 5 (the CUDA gather on) and the int8 flat engine of phase 6
    (its flat view synced first) each insert ``queries[:n_held]``, then a
    burst of ``ov_cap + burst_extra`` near copies of one base row
    (``data[t] + 0.0005 N(0, 1)``, ``burst_target``: its group repacks
    without a full rebuild).  A ``device="cpu"`` port engine runs the
    same inserts on a third copy: the routed partitions must agree up to
    ties in the meta distances.  Checks: gids, verb counts, the insert
    ledger against the charge rule, the device region against the host
    region after the inserts and after the repack, the flat view against
    a fresh sync, self-recall@1 in scan mode, recall@10 over all queries
    against brute force over the grown data, and an int8 search with
    ``rerank_m=256`` (the large-k route of ``quant_topk``).  Returns
    (launches of the post-insert searches, the gather launches they made
    as ``gather_launches`` entries, their buffers)."""
    n0, dim = ds.data.shape
    held = np.ascontiguousarray(ds.queries[:n_held])
    on_card = device.type == "cuda"
    spec = store.spec
    rng = np.random.default_rng(seed)

    def exact_engine(dev):
        return DHNSWEngine(exact_config(meta.n_partitions, doorbell, "scan"),
                           device=dev).adopt_built(
            meta, copy.deepcopy(store), ds.data)
    eng = exact_engine(device)
    qcfg = flat_config(meta.n_partitions, doorbell)
    q8 = DHNSWEngine(qcfg, device=device).adopt_built(
        meta, copy.deepcopy(qstore), ds.data)
    twin = exact_engine(torch.device("cpu"))
    q8.search(ds.queries[:8], k=k)              # the flat view, synced
    wire = {"exact": dim * 4 + 8, "cpu": dim * 4 + 8,
            "int8": dim * 4 + 8 + dim + dim // qstore.spec.quant_group * 4}
    engines = (("exact", eng), ("int8", q8), ("cpu", twin))
    launches = {name: 0 for name in KERNEL_OPS}
    n_burst = spec.ov_cap + burst_extra
    burst = None
    for label in ("held-out", "burst"):
        if label == "burst":     # the target, after the held-out inserts
            t = burst_target(eng, ds.data, n_burst)
            burst = (ds.data[t][None] + 0.0005 * rng.standard_normal(
                (n_burst, dim))).astype(np.float32)
        vecs = held if label == "held-out" else burst
        for name, e in engines:
            n_pre = e.client._n0 + len(e.client._extra)
            totals = dict(e.pool.totals)
            verbs = dict(e.pool.verbs)
            gids, wall, sec = _timed_insert(e, vecs)
            if not np.array_equal(gids, np.arange(n_pre, n_pre + len(vecs))):
                raise AssertionError(f"insert {name} {label}: gids {gids[:3]}"
                                     f"... not from {n_pre}")
            repacks = e.pool.verbs["repack"] - verbs.get("repack", 0)
            # the append that finds the region full lands nothing and is
            # not counted; its row is appended again after the repack
            n_app = len(vecs)
            if e.pool.verbs["append"] - verbs.get("append", 0) != n_app:
                raise AssertionError(f"insert {name} {label}: "
                                     f"{dict(e.pool.verbs)}, want {n_app} "
                                     f"more appends")
            if label == "burst" and repacks < 1:
                raise AssertionError(f"insert {name}: the burst repacked "
                                     f"nothing")
            per = wire[name]
            want = {"round_trips": n_app, "descriptors": n_app,
                    "bytes": n_app * per}
            moved = {key: e.pool.totals[key] - totals[key] for key in totals}
            net = {key: e._last_insert_net[key] for key in want}
            if moved != want or net != want:
                raise AssertionError(f"insert {name} {label}: ledger {net}, "
                                     f"pool totals moved {moved}, want "
                                     f"{n_app} writes of {per} B")
            if name != "cpu":
                _region_equal(e.pool, f"insert {name} {label}")
            what = _insert_line(f"{name} {label}", len(vecs), wall, sec)
            log(f"[10 insert] {what} | {n_app} appends, {repacks} repacks, "
                f"{n_app} writes of "
                f"{per} B charged"
                + (" | device region equal to the host's" if name != "cpu"
                   else ""))
            if name == "int8" and label == "held-out":
                n_flat = _flat_equal_to_sync(e.client, "insert int8")
                log(f"[10 insert] int8 flat view after {len(vecs)} inserts: "
                    f"{n_flat} rows equal to a fresh sync (codes, scales, "
                    f"payload twin)")

    # routing against the CPU twin: equal up to ties in meta distances
    reps = meta.graph.vectors
    diff = [g for g, p in eng.client._extra_pid.items()
            if twin.client._extra_pid[g] != p]
    for g in diff:
        v = eng.client._extra[g]
        d = [float(((v - reps[p]) ** 2).sum()) for p in
             (eng.client._extra_pid[g], twin.client._extra_pid[g])]
        if abs(d[0] - d[1]) > 1e-5 * max(d):
            raise AssertionError(f"insert: gid {g} routed to {d} on the card "
                                 f"and the CPU beyond a tie")
    log(f"[10 insert] routed partitions equal to the CPU engine's for "
        f"{len(eng.client._extra_pid) - len(diff)} of "
        f"{len(eng.client._extra_pid)} rows ({len(diff)} at ties)")

    # searches after the inserts: the gather launches are recorded
    grown = np.concatenate([ds.data, held, burst])
    gt = brute_force_gt(grown, ds.queries, k, device)
    bufs = {}

    def timed(e, vecs):
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = e.search(vecs, k=k)
        if on_card:
            torch.cuda.synchronize()
        return (*out, time.perf_counter() - t0)

    exact_log = PathLog(device)
    with exact_log.path() as n_exact:
        self_q = _self_recall(eng, held[:64], n0 + np.arange(len(held[:64])))
        self_b = _self_recall(eng, burst[:32],
                              np.arange(n0 + n_held, n0 + n_held + 32))
        d, g, st, wall = timed(eng, ds.queries)
    recorded = recorded_launches(exact_log.calls, bufs, "insert.")
    _check_output(d, g, len(ds.queries), k, len(grown), "insert exact")
    rec = recall_at_k(g, gt)
    if self_q != 1.0 or self_b != 1.0:
        raise AssertionError(f"insert exact: self-recall@1 {self_q} "
                             f"(held-out) / {self_b} (burst), want 1.0")
    if rec < scan_recall - 0.01:
        raise AssertionError(f"insert exact: recall@{k} {rec} below phase "
                             f"5's {scan_recall} - 0.01")
    log(f"[10 insert] exact scan after the inserts: self-recall@1 "
        f"{self_q:.4f} (held-out[:64]) {self_b:.4f} (burst[:32]) | "
        f"recall@{k} {rec:.4f} vs brute force over {len(grown)} rows "
        f"(phase 5 scan {scan_recall:.4f}) | search wall {wall:.4f} s | "
        f"{_counted(st)} | gather launches {n_exact['gather_blocks']} "
        f"(3 searches)")

    _reset_launches()
    s8_q = _self_recall(q8, held[:64], n0 + np.arange(len(held[:64])))
    s8_b = _self_recall(q8, burst[:32],
                        np.arange(n0 + n_held, n0 + n_held + 32))
    d8, g8, st8, wall8 = timed(q8, ds.queries)
    n8 = _launches()
    q8.client.cfg = dataclasses.replace(qcfg, rerank_m=256)
    try:
        d9, g9, st9, wall9 = timed(q8, ds.queries)
    finally:
        q8.client.cfg = qcfg
    n9 = {key: v - n8[key] for key, v in _launches().items()}
    for key in launches:
        launches[key] += n_exact[key] + n8[key] + n9[key]
    want = "cuda" if on_card else "ref"
    if st8["stage1_impl"] != want or st9["stage1_impl"] != want:
        raise AssertionError(f"insert int8: stage 1 {st8['stage1_impl']} / "
                             f"{st9['stage1_impl']}")
    if on_card and (n9["quant_topk"] != 2 or st9["rerank_m"] != 256):
        raise AssertionError(f"insert int8: rerank_m=256 made "
                             f"{n9['quant_topk']} quant_topk launches, want "
                             f"the large-k route's 2")
    if s8_q != 1.0:
        raise AssertionError(f"insert int8: self-recall@1 {s8_q} of the "
                             f"held-out rows, want 1.0")
    _check_output(d8, g8, len(ds.queries), k, len(grown), "insert int8")
    _check_output(d9, g9, len(ds.queries), k, len(grown), "insert int8 m256")
    r8, r9 = recall_at_k(g8, gt), recall_at_k(g9, gt)
    if r9 < r8:
        raise AssertionError(f"insert int8: recall@{k} {r9} at rerank_m=256"
                             f" below {r8} at m={st8['rerank_m']}")
    log(f"[10 insert] int8 flat after the inserts: self-recall@1 "
        f"{s8_q:.4f} (held-out[:64]) {s8_b:.4f} (burst[:32], reported) | "
        f"recall@{k} {r8:.4f} at m={st8['rerank_m']} (wall {wall8:.4f} s), "
        f"{r9:.4f} at m=256 (wall {wall9:.4f} s, quant_topk launches "
        f"{n9['quant_topk']}: the large-k route) | flat_rows "
        f"{st8['flat_rows']} | launches {launches}")
    del eng, q8, twin
    if on_card:
        torch.cuda.empty_cache()
    return launches, recorded, bufs


def phase_load(device, *, n: int, n_rep: int, n_chunks: int,
               n_queries: int, k: int, doorbell: int,
               seed: int = SEED) -> tuple:
    """Phase 11: ``DHNSWEngine.build_streaming`` at ``benchmarks/
    ingest.py``'s full ``run_load`` geometry, and ``build`` of the same
    data, both serving on ``device`` (the exact-scan config, the CUDA
    gather on): meta, host and device regions, and a search of
    ``n_queries`` (gids and distances) must be bit-identical; the
    ``LoadReport`` counts ``n_chunks`` chunks, none failed, and a peak
    builder memory under half the dataset.  Returns (launches, the
    searches' gather launches as ``gather_launches`` entries, their
    buffers)."""
    from repro_torch.ingest import chunked_source
    ds = sift_like(n=n, n_queries=n_queries, seed=seed)
    cfg = dataclasses.replace(exact_config(n_rep, doorbell, "scan"),
                              seed=seed)
    t0 = time.perf_counter()
    mem = DHNSWEngine(cfg, device=device).build(ds.data)
    t1 = time.perf_counter()
    rows = n // n_chunks
    stream = DHNSWEngine(cfg, device=device).build_streaming(
        chunked_source(ds.data, rows), chunk_rows=rows)
    t2 = time.perf_counter()
    rep = stream.last_load_report
    for a in ("reps", "rep_ids", "assignments"):
        if not np.array_equal(getattr(mem.meta, a), getattr(stream.meta, a)):
            raise AssertionError(f"load: meta {a} differ")
    for a in ("vectors", "adjacency", "node_level"):
        if (getattr(mem.meta.graph, a).tobytes()
                != getattr(stream.meta.graph, a).tobytes()):
            raise AssertionError(f"load: meta graph {a} differ")
    for a in ("graph_buf", "vec_buf", "meta_table", "n_base"):
        x, y = getattr(mem.store, a), getattr(stream.store, a)
        if x.dtype != y.dtype or x.tobytes() != y.tobytes():
            raise AssertionError(f"load: region {a} differs")
    for a in ("_g_dev", "_v_dev", "_mt_dev"):
        if not torch.equal(getattr(mem.pool, a), getattr(stream.pool, a)):
            raise AssertionError(f"load: device region {a} differs")
    if (rep.chunks_total, rep.chunks_ok, rep.chunks_failed) != (
            n_chunks, n_chunks, 0):
        raise AssertionError(f"load: report {rep}")
    if not rep.peak_builder_bytes < rep.dataset_bytes / 2:
        raise AssertionError(f"load: peak builder {rep.peak_builder_bytes} "
                             f"B of a {rep.dataset_bytes} B dataset")
    load_log = PathLog(device)
    (d0, g0, st0, w0, _), (d1, g1, st1, w1, _) = (
        load_log.search(e, ds.queries, k) for e in (mem, stream))
    launches = load_log.launches
    if not (np.array_equal(d0, d1) and np.array_equal(g0, g1)
            and _counted_equal(st0, st1)):
        raise AssertionError("load: streamed and in-memory engines search "
                             "differently")
    _check_output(d0, g0, n_queries, k, n, "load")
    bufs = {}
    recorded = recorded_launches(load_log.calls, bufs, "load.")
    log(f"[11 load] {n} rows, n_rep {n_rep}: build {t1 - t0:.2f} s, "
        f"build_streaming {t2 - t1:.2f} s in {rep.chunks_total} chunks of "
        f"{rows} (0 failed), peak builder {rep.peak_builder_bytes / 1e6:.3f}"
        f" MB of a {rep.dataset_bytes / 1e6:.3f} MB dataset | meta, host "
        f"and device regions bit-identical | {n_queries} queries: gids and "
        f"distances bit-identical, recall@{k} "
        f"{recall_at_k(g0, ds.gt_ids[:, :k]):.4f}, wall {w0:.4f} / "
        f"{w1:.4f} s | gather launches {launches['gather_blocks']}")
    return launches, recorded, bufs


# ------------------------------------------------ multi-node pools, serving

class _DeadChild:
    """A vanished memory node: every verb raises ``PoolUnavailableError``,
    as a transport with a dead socket does."""

    _VERBS = ("read_spans", "read_rows", "read_quant_rows", "append",
              "repack", "refresh_blocks", "adopt", "_stage_quant",
              "snapshot", "close")

    def __getattr__(self, name):
        if name in self._VERBS:
            def boom(*a, **kw):
                raise PoolUnavailableError("node down (chip_smoke stub)")
            return boom
        raise AttributeError(name)


class FanoutTrips:
    """While active, counts the round trips a sharded pool's ledger must
    charge, apart from the pool's own fan-out code.  Each charged call of
    ``read_spans``, ``post_span_reads`` or ``post_row_reads`` is split by
    destination: a span (or row group) goes to ``owner_of_pid`` as the
    call starts, or, where that shard is dead after the call (a stub
    swapped in, or a memory node killed), to the shard serving it after
    the call (the failover retry, a part of its own).  Each part
    is cut into doorbell chunks of ceil(descriptors / max_doorbell)
    trips, and the call charges the most of any part: the shards answer
    in parallel.  ``total`` stays None for a pool that is not sharded."""

    _VERBS = ("read_spans", "post_span_reads", "post_row_reads")

    def __init__(self, pool):
        self.pool = pool
        self.total = 0 if isinstance(pool, ShardedPool) else None

    def __enter__(self) -> "FanoutTrips":
        if self.total is not None:
            for verb in self._VERBS:
                setattr(self.pool, verb,
                        self._wrap(verb, getattr(self.pool, verb)))
        return self

    def __exit__(self, *exc) -> None:
        if self.total is not None:
            for verb in self._VERBS:
                delattr(self.pool, verb)

    def _units(self, verb, args, kw) -> tuple:
        """(pids, descriptors of each) of one call; pids None when the
        call names no destinations (one node's charge)."""
        spec = self.pool.spec
        if verb == "post_row_reads":
            groups = list(args[0])
            return [p for p, _ in groups], [c for _, c in groups]
        per = span_wire_bytes(spec, quant=kw.get("quant", False),
                              quant_graph=kw.get("quant_graph", True))[1]
        if verb == "read_spans":
            pids = list(np.asarray(args[0]).reshape(-1))
        else:
            pids = kw.get("pids")
            if pids is None:
                return None, [per] * int(args[0])
            pids = list(np.asarray(pids).reshape(-1))
        return pids, [per] * len(pids)

    def _wrap(self, verb, real):
        pool = self.pool

        def owner(pid):           # a row group of no partition: shard 0
            return pool.owner_of_pid(pid) if pid >= 0 else 0

        def call(*args, ledger=None, **kw):
            if ledger is None:
                return real(*args, ledger=ledger, **kw)
            pids, descs = self._units(verb, args, kw)
            before = (None if pids is None
                      else [owner(p) for p in pids])
            out = real(*args, ledger=ledger, **kw)
            # a shard that served a span as the call started and is dead
            # after it died in the call: its slice failed, charged nothing
            dead = {s for s, up in enumerate(pool._alive) if not up}
            parts = {}
            for i, d in enumerate(descs):
                key = 0 if before is None else before[i]
                if key in dead:
                    key = ("retry", owner(pids[i]))
                parts.setdefault(key, []).append(d)
            db = max(int(kw.get("doorbell", 1)), 1)
            cap = ledger.fabric.max_doorbell
            self.total += max((sum(-(-sum(part[j:j + db]) // cap)
                                   for j in range(0, len(part), db))
                               for part in parts.values()), default=0)
            return out
        return call


def host_syncs(fn, device):
    """(``fn()``, the host syncs it made on the card): torch's sync debug
    mode warns at every synchronizing call (a ``.item()``, a copy to the
    host), and the warnings are counted.  None on the CPU."""
    if device.type != "cuda":
        return fn(), None
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in seen)


def _bit_equal(a, b, what: str) -> None:
    """Two search results (d, g, ...) are bit-identical."""
    if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
        raise AssertionError(f"{what}: results differ from LocalPool's")


def _fanout_counted(st, local, trips, what: str) -> None:
    """A sharded search's counted stats against LocalPool's on the same
    batch: everything the compute side counts is equal, and so are the
    bytes and descriptors of its ledger (each charge slice sums over the
    shards); its round trips equal ``trips``, the count ``FanoutTrips``
    made of the batch's charges (per-shard doorbell batches reduced by
    max: the shards answer in parallel)."""
    keys = ("n_rounds", "n_pairs", "cache_hits", "n_fetches",
            "rerank_rows", "rerank_hit_rows", "exact_admitted")
    net, lnet = st["net"], local["net"]
    if not (all(st.get(key) == local.get(key) for key in keys)
            and all(net[key] == lnet[key]
                    for key in ("bytes", "descriptors", "bytes_saved"))
            and trips is not None and net["round_trips"] == trips):
        raise AssertionError(f"{what}: counted {net} vs LocalPool's {lnet}, "
                             f"{trips} trips expected")


def _sim_formula(calls, fabric) -> dict:
    """Per verb: the fabric formula over the charges ``_transport`` saw,
    in their order (trips * rtt + descriptors * per_op + bytes / bw)."""
    out = {}
    for verb, b, d, t in calls:
        out[verb] = out.get(verb, 0.0) + (
            t * fabric.rtt_s + d * fabric.per_op_s + b / fabric.bw_Bps)
    return out


def phase_sim_rdma(ds, meta, store, qstore, device, *, k: int, doorbell: int,
                   log_: PathLog) -> None:
    """Phase 12a: ``pool="sim_rdma"`` on ``RDMA_100G`` in phase 5's exact
    scan configuration and phase 6's int8 flat one, one batch each, held
    in turns against the same configuration over ``LocalPool``: gids,
    distances and counted stats bit-identical, and each verb's modeled
    seconds equal to the fabric formula over that verb's charges (within
    1e-12 relative)."""
    B = len(ds.queries)
    exact = exact_config(meta.n_partitions, doorbell, "scan")
    flat = flat_config(meta.n_partitions, doorbell)
    for label, cfg, st0 in (("exact scan", exact, store),
                            ("int8 flat", flat, qstore)):
        runs = {}
        for pool in ("local", "sim_rdma", "sim_rdma", "local"):
            eng = DHNSWEngine(dataclasses.replace(cfg, pool=pool),
                              device=device).adopt_built(
                meta, dataclasses.replace(st0), ds.data)
            charges = []
            if pool == "sim_rdma":
                real = eng.pool._transport

                def seen(verb, n_bytes, descs, trips, real=real,
                         charges=charges):
                    charges.append((verb, float(n_bytes), float(descs),
                                    float(trips)))
                    return real(verb, n_bytes, descs, trips)
                eng.pool._transport = seen
            first = pool not in runs
            out = (log_.search(eng, ds.queries, k) if first
                   and pool == "sim_rdma" else
                   _search(eng, ds.queries, k, device))
            runs.setdefault(pool, []).append((out, eng, charges))
        (lo, _, _), (so, sim, charges) = runs["local"][0], runs["sim_rdma"][0]
        _bit_equal(so, lo, f"sim_rdma {label}")
        if not _counted_equal(so[2], lo[2]):
            raise AssertionError(f"sim_rdma {label}: counted stats differ")
        _check_output(so[0], so[1], B, k, ds.data.shape[0], f"sim {label}")
        want = _sim_formula(charges, RDMA_100G)
        got = sim.pool.sim_s
        if set(got) != set(want) or any(
                abs(got[v] - want[v]) > 1e-12 * abs(want[v]) for v in want):
            raise AssertionError(f"sim_rdma {label}: sim_s {got}, the fabric "
                                 f"formula {want}")
        walls = {p: [r[0][3] for r in rs] for p, rs in runs.items()}
        log(f"[12a sim_rdma {label}] bit-identical to LocalPool, counted net "
            f"equal ({_counted(so[2])}) | modeled "
            f"{sim.pool.sim_total_s / B * 1e6:.3f} us a query "
            f"({ {v: round(s * 1e6, 2) for v, s in got.items()} } us, each "
            f"verb = the fabric formula over its {len(charges)} charges) | "
            f"wall {so[3] / B * 1e6:.1f} us a query | wall s sim_rdma "
            f"{walls['sim_rdma']}, local {walls['local']} (local, sim, sim, "
            f"local) | launches {so[4]}")
        del runs
    if device.type == "cuda":
        torch.cuda.empty_cache()


def phase_sharded(ds, meta, store, qstore, device, *, k: int, doorbell: int,
                  n_shards: int, n_batches: int, per_batch: int,
                  migrate_every: int, log_: PathLog) -> None:
    """Phase 12b: ``pool="sharded"`` over ``n_shards`` sim-RDMA children on
    ``straggler_fabrics`` (``benchmarks/torch_pool.py``'s shard cell: b=3,
    ef=48, cache_frac 0.1, doorbell 16, the CUDA gather), placements
    ``round_robin`` and ``freq``, through the cell's zipf workload
    (``n_batches`` of ``per_batch`` of the queries).  Every batch is
    bit-identical to a LocalPool engine's on the same batch; the staged
    blocks partition the region at placement, and after the batches every
    group is staged on its serving shard; each shard's device bytes are its staged blocks plus the meta
    table; ``freq`` models less time a query than ``round_robin``.  Then
    phase 6's int8 flat configuration over ``n_shards`` local children:
    the fanned-out flat view equals LocalPool's, stage 1 runs through
    ``quant_topk``, and the results are bit-identical."""
    spec = store.spec
    batches = [ds.queries[i] for i in torch_pool.zipf_batches(
        len(ds.queries), n_batches, per_batch)]
    base = dict(n_shards=n_shards, n_rep=meta.n_partitions,
                migrate_every=migrate_every, doorbell=doorbell)
    local = DHNSWEngine(dataclasses.replace(
        torch_pool.shard_config(placement="round_robin", **base),
        pool="local"), device=device).adopt_built(
        meta, dataclasses.replace(store), ds.data)
    want, local_launch = [], 0
    for qb in batches:
        want.append(_search(local, qb, k, device))
        local_launch += want[-1][4]["gather_blocks"]
    local_wall = sum(w[3] for w in want)
    _, local_syncs = host_syncs(lambda: local.search(batches[0], k=k),
                                device)
    del local
    rows = {}
    for placement in ("round_robin", "freq"):
        cfg = torch_pool.shard_config(placement=placement, **base)
        mem0 = torch.cuda.memory_allocated() if device.type == "cuda" else 0
        eng = DHNSWEngine(cfg, device=device).adopt_built(
            meta, dataclasses.replace(store), ds.data)
        mem = (torch.cuda.memory_allocated() - mem0
               if device.type == "cuda" else None)
        stg0 = eng.pool.snapshot()["staging"]
        if sum(stg0["blocks_staged_by_shard"]) != spec.n_blocks:
            raise AssertionError(f"sharded {placement}: staged blocks "
                                 f"{stg0['blocks_staged_by_shard']} do not "
                                 f"partition {spec.n_blocks}")
        gathers, wall = 0, 0.0
        for i, qb in enumerate(batches):
            out = log_.search(eng, qb, k)
            _bit_equal(out, want[i], f"sharded {placement} batch {i}")
            _fanout_counted(out[2], want[i][2], log_.trips,
                            f"sharded {placement} batch {i}")
            gathers += out[4]["gather_blocks"]
            wall += out[3]
        snap = eng.pool.snapshot()
        row = torch_pool.shard_row(snap, n_shards=n_shards,
                                   placement=placement,
                                   nq=n_batches * per_batch, wall=wall)
        stg = snap["staging"]
        unstaged = [g for g in range(spec.n_groups) if g not in
                    eng.pool.children[eng.pool.owner_of_group(g)]._owned]
        if unstaged:
            raise AssertionError(f"sharded {placement}: groups {unstaged} "
                                 f"are not staged on their serving shard")
        per_blk = spec.block_bytes()
        mt = store.meta_table.nbytes
        for s, (nb, dev) in enumerate(zip(stg["blocks_staged_by_shard"],
                                          stg["device_bytes_by_shard"])):
            if dev != nb * per_blk + mt:
                raise AssertionError(f"sharded {placement} shard {s}: "
                                     f"{dev} device bytes, {nb} blocks")
        _, syncs = host_syncs(lambda: eng.search(batches[0], k=k), device)
        rows[placement] = row
        log(f"[12b sharded {placement}] {n_shards} shards, {n_batches} zipf "
            f"batches of {per_batch}: each bit-identical to LocalPool | "
            f"sim {row['sim_us_per_q']} us/q, {row['kb_per_q']} KB/q, "
            f"{row['round_trips_per_q']} trips/q, byte imbalance "
            f"{row['byte_imbalance']}, migrations {row['migrations']}, "
            f"groups {row['groups_by_shard']} | staged MB "
            f"{row['staged_mb_by_shard']} (blocks "
            f"{stg['blocks_staged_by_shard']}, restaged "
            f"{stg['restaged_blocks']}) = blocks x {per_blk} B + the {mt} B "
            f"meta table, sum {sum(stg['device_bytes_by_shard']) / 1e6:.3f} "
            f"MB beside memory_allocated's delta at adoption "
            + (f"{mem / 1e6:.3f} MB" if mem is not None else "not measured")
            + f" (it holds the compute side's caches and meta-HNSW too) | "
            f"gather launches a batch {gathers / n_batches:.2f} (LocalPool "
            f"{local_launch / n_batches:.2f}) | host syncs of one batch "
            f"{syncs} (LocalPool {local_syncs}) | wall of the batches "
            f"{wall:.4f} s (LocalPool {local_wall:.4f} s)")
        del eng
    if not rows["freq"]["sim_us_per_q"] < rows["round_robin"]["sim_us_per_q"]:
        raise AssertionError(f"freq {rows['freq']['sim_us_per_q']} us/q not "
                             f"below round_robin's "
                             f"{rows['round_robin']['sim_us_per_q']}")

    flat = flat_config(meta.n_partitions, doorbell)
    engines = {}
    for pool in ("local", "sharded"):
        engines[pool] = DHNSWEngine(
            dataclasses.replace(flat, pool=pool, n_shards=n_shards),
            device=device).adopt_built(meta, dataclasses.replace(qstore),
                                       ds.data)
    lo = _search(engines["local"], ds.queries, k, device)
    so = log_.search(engines["sharded"], ds.queries, k)
    _bit_equal(so, lo, "sharded int8 flat")
    _fanout_counted(so[2], lo[2], log_.trips, "sharded int8 flat")
    cl, cs = engines["local"].client, engines["sharded"].client
    for a in ("_flat_codes", "_flat_scales", "_flat_cols"):
        if cl._flat_n != cs._flat_n or not torch.equal(
                getattr(cl, a)[:cl._flat_n], getattr(cs, a)[:cs._flat_n]):
            raise AssertionError(f"sharded int8 flat: {a} differs from "
                                 f"LocalPool's flat view")
    want_impl = "cuda" if device.type == "cuda" else "ref"
    if so[2]["stage1_impl"] != want_impl or (
            device.type == "cuda" and so[4]["quant_topk"] == 0):
        raise AssertionError(f"sharded int8 flat: stage 1 "
                             f"{so[2]['stage1_impl']}, launches {so[4]}")
    log(f"[12b sharded int8 flat] {n_shards} local children: the fanned-out "
        f"flat view ({so[2]['flat_rows']} rows: codes, scales, payload) "
        f"equal to LocalPool's; stage 1 {so[2]['stage1_impl']}, results "
        f"bit-identical | {_counted(so[2])} (LocalPool trips "
        f"{lo[2]['net']['round_trips']}) | launches {so[4]} | wall "
        f"{so[3]:.4f} s, LocalPool {lo[3]:.4f} s")
    del engines
    if device.type == "cuda":
        torch.cuda.empty_cache()


def phase_failover(ds, meta, store, device, *, k: int, doorbell: int,
                   n_shards: int = 3, n_insert: int = 16,
                   log_: PathLog) -> None:
    """Phase 12c: replication and failover.  ``pool="sharded"`` over
    ``n_shards`` local children at ``replication=2`` in phase 5's exact
    scan configuration, on deep copies of phase 3's region, beside a
    LocalPool engine making the same calls: two batches, then child 0 is
    swapped for a dead node; the next batch raises nothing and stays
    bit-identical, its counted stats as ``_fanout_counted`` holds them
    (the failed slice charged nothing); one death, no lost group, and
    only the dead shard's groups re-staged.  Then ``n_insert`` inserts
    (equal gids) and a search, then ``add_shard`` and ``remove_shard``,
    each followed by a bit-identical search."""
    spec = store.spec
    cfg = exact_config(meta.n_partitions, doorbell, "scan")
    local = DHNSWEngine(cfg, device=device).adopt_built(
        meta, copy.deepcopy(store), ds.data)
    eng = DHNSWEngine(dataclasses.replace(
        cfg, pool="sharded", n_shards=n_shards, replication=2),
        device=device).adopt_built(meta, copy.deepcopy(store), ds.data)
    pool = eng.pool
    per = len(ds.queries) // 4
    qs = [ds.queries[i * per:(i + 1) * per] for i in range(4)]

    walls = []

    def both(q, what):
        lo = _search(local, q, k, device)
        so = log_.search(eng, q, k)
        _bit_equal(so, lo, what)
        _fanout_counted(so[2], lo[2], log_.trips, what)
        walls.append((round(so[3], 4), round(lo[3], 4)))
        return so, lo
    for i in range(2):
        both(qs[i], f"failover batch {i}")
    held0 = sum(1 for row in pool._replicas if (row == 0).any())
    pool.children[0] = _DeadChild()
    so, lo = both(qs[2], "failover batch 2 (shard 0 dead)")
    fo = dict(pool.failover)
    restaged = sum(c.staging["restaged_blocks"] for c in pool.children[1:])
    if (fo["deaths"], fo["lost_groups"]) != (1, 0) or not (
            0 < fo["rereplicated_groups"] <= held0) or (
            restaged != fo["rereplicated_groups"] * spec.group_blocks):
        raise AssertionError(f"failover: {fo}, {restaged} blocks re-staged, "
                             f"shard 0 held {held0} groups")
    new = np.ascontiguousarray(ds.queries[:n_insert])
    g_local, g_shard = local.insert(new), eng.insert(new)
    if not np.array_equal(g_local, g_shard):
        raise AssertionError(f"failover insert: gids {g_shard[:4]} vs "
                             f"{g_local[:4]}")
    both(qs[0], "failover after the inserts")
    added = pool.add_shard(lambda st: LocalPool(st, device=device,
                                                use_gather_kernel=True))
    both(qs[0], "failover after add_shard")
    pool.remove_shard(1)
    last, _ = both(qs[0], "failover after remove_shard")
    snap = pool.snapshot()
    log(f"[12c failover] {n_shards} shards, replication 2: child 0 dead "
        f"before batch 2, which raised nothing and stayed bit-identical | "
        f"its {_counted(so[2])}; LocalPool trips "
        f"{lo[2]['net']['round_trips']} | failover {fo} | {restaged} blocks re-staged "
        f"= {fo['rereplicated_groups']} groups of the {held0} shard 0 held "
        f"x {spec.group_blocks} | {n_insert} inserts: gids equal | "
        f"add_shard -> {added} ({snap['elastic']['moved_groups']} groups "
        f"moved), remove_shard(1): results unchanged | alive "
        f"{snap['alive']}, groups {snap['groups_by_shard']}, replicas "
        f"{snap['replicas_by_shard']} | wall s (sharded, LocalPool) of the "
        f"six searches (two, after the death, the inserts, add_shard, "
        f"remove_shard) {walls} | last launches {last[4]}")
    del local, eng
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _bench_fields_equal(got: dict, want: dict, table: str,
                        clock=("wall_s",)) -> None:
    """Every field of a benchmark table but those read off the host's
    clock (``clock``) is equal."""
    rows_g = got[table] if isinstance(got[table], list) else [got[table]]
    rows_w = want[table] if isinstance(want[table], list) else [want[table]]
    if len(rows_g) != len(rows_w):
        raise AssertionError(f"{table}: {len(rows_g)} rows, baseline "
                             f"{len(rows_w)}")
    for g, w in zip(rows_g, rows_w):
        diff = sorted(key for key in set(g) | set(w)
                      if key not in clock and g.get(key) != w.get(key))
        if diff:
            raise AssertionError(f"{table}: {diff} differ from the baseline")


# fields of the benchmark tables read off the host's clock or naming a
# server's port: printed, never compared
CLOCK = ("wall_s", "endpoint", "p50_ms", "p99_ms", "kill_batch_ms",
         "recover_wall_s")


def _transport_line(tr) -> str:
    return ", ".join(f"{r['transport']}"
                     + (f"/{r['bearer']}" if "bearer" in r else "")
                     + f" {r['round_trips_per_q']} trips/q "
                       f"{r['descriptors_per_q']} descs/q "
                       f"{r['model_kb_per_q']} KB/q"
                     + (f" wire {r['wire_kb_per_q']} KB/q in "
                        f"{r['wire_frames']} frames" if "bearer" in r
                        else "")
                     for r in tr)


def phase_pool_bench(device, log_: PathLog) -> None:
    """Phase 12d: ``benchmarks/torch_pool.py --smoke`` on ``device``: every
    field of its five tables (``rows``, ``shard_rows``, ``transport_rows``,
    ``chaos``, ``chaos_latency``) but those in ``CLOCK`` equals
    ``benchmarks/baselines/BENCH_pool.json``'s.  ``transport_rows`` and
    ``chaos`` fork ``python -m repro_torch.net.server`` memory nodes.  Its
    in-process engines gather through the CUDA kernel, one path in
    ``log_``."""
    base = json.loads((ROOT / "benchmarks" / "baselines"
                       / "BENCH_pool.json").read_text())
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, log_.path() as launches:
        blob = torch_pool.run(smoke=True, out=f"{tmp}/BENCH_torch_pool.json",
                              device=device)
    wall = time.perf_counter() - t0
    for table in ("rows", "shard_rows", "transport_rows", "chaos",
                  "chaos_latency"):
        _bench_fields_equal(blob, base, table, CLOCK)
    sr = {r["placement"]: r for r in blob["shard_rows"]}
    cl, ch = blob["chaos_latency"], blob["chaos"]
    log(f"[12d torch_pool --smoke] {len(blob['rows'])} fabric rows, "
        f"{len(blob['shard_rows'])} shard rows, "
        f"{len(blob['transport_rows'])} transport rows, the chaos and "
        f"chaos_latency rows equal to BENCH_pool.json but the clock | "
        f"shard_rows 2 shards: "
        + ", ".join(f"{p} {r['round_trips_per_q']} trips/q {r['kb_per_q']} "
                    f"KB/q staged_mb_max {r['staged_mb_max']} sim "
                    f"{r['sim_us_per_q']} us/q" for p, r in sr.items())
        + f" | transport_rows {_transport_line(blob['transport_rows'])}"
        f" | chaos replication {ch['replication']} batches "
        f"{ch['n_batches']} kill {ch['kill_batch']} re-replicated "
        f"{ch['rereplicate_mb']} MB bit-identical "
        f"{ch['bit_identical_to_local']} (p50 {ch['p50_ms']} ms, p99 "
        f"{ch['p99_ms']} ms)"
        f" | chaos_latency flagged {cl['flagged_shard']} mismatches "
        f"{cl['mismatches']} p99_on {cl['p99_on_us']} us burn_peak "
        f"{cl['burn_peak']} | {wall:.1f} s | launches {launches}")


def phase_serving(device, smi: str, log_: PathLog) -> None:
    """Phase 13: ``benchmarks/torch_serving.py --smoke`` on ``device``: the
    ``counted`` table equals ``BENCH_serving.json``'s; the wall-clock rows
    (smoke size: a few requests a client) are printed beside the card's
    name and power limit, never compared.  Its engines gather through
    the CUDA kernel, one path in ``log_``."""
    base = json.loads((ROOT / "benchmarks" / "baselines"
                       / "BENCH_serving.json").read_text())
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, log_.path() as launches:
        blob = torch_serving.run(smoke=True, device=device,
                                 out=f"{tmp}/BENCH_torch_serving.json")
    wall = time.perf_counter() - t0
    if blob["counted"] != base["counted"]:
        raise AssertionError(f"serving counted {blob['counted']} != the "
                             f"baseline's {base['counted']}")
    for r in blob["counted"]:
        log(f"[13 serving] counted C={r['clients']} {r['impl']}: "
            f"{r['round_trips_per_q']} trips/q {r['descriptors_per_q']} "
            f"descriptors/q {r['kb_per_q']} KB/q fused "
            f"{r['mean_fused_batch']} (= BENCH_serving.json)")
    for r in blob["rows"]:
        log(f"[13 serving] wall C={r['clients']} {r['impl']}: {r['qps']} qps"
            f", p50 {r['p50_ms']} ms, p99 {r['p99_ms']} ms ({smi}; smoke "
            f"size, not compared)")
    log(f"[13 serving] {wall:.1f} s | launches {launches}")


# ------------------------------------------------------ remote memory pool

class Wrapped:
    """While active, replaces ``obj.name`` with a wrapper that counts its
    calls and sums their host seconds (each ended by a sync on the card);
    the real method still runs."""

    def __init__(self, obj, name: str, device):
        self.obj, self.name, self.device = obj, name, device
        self.calls, self.seconds = 0, 0.0

    def __enter__(self) -> "Wrapped":
        real = getattr(self.obj, self.name)

        def call(*a, **kw):
            t0 = time.perf_counter()
            out = real(*a, **kw)
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            self.calls += 1
            self.seconds += time.perf_counter() - t0
            return out
        setattr(self.obj, self.name, call)
        return self

    def __exit__(self, *exc) -> None:
        delattr(self.obj, self.name)


def cuda_marks(pid) -> list:
    """The device files a process that holds a CUDA context has open or
    mapped (``/dev/nvidiactl``, ``/dev/nvidia<N>``, ``/dev/nvidia-uvm``),
    as ``/proc`` shows them.  The driver library is no mark: ``import
    torch`` maps ``libcuda.so`` before anything touches the card."""
    marks = set()
    for ln in Path(f"/proc/{pid}/maps").read_text().splitlines():
        if ln.split()[-1].startswith("/dev/nvidia"):
            marks.add(ln.split()[-1])
    for fd in Path(f"/proc/{pid}/fd").iterdir():
        try:
            target = os.readlink(fd)
        except OSError:           # closed while listed
            continue
        if target.startswith("/dev/nvidia"):
            marks.add(target)
    return sorted(marks)


def no_cuda_context(pids, what: str) -> str:
    """Holds that none of ``pids`` (memory-node processes) carries a CUDA
    context's marks (``cuda_marks``).  On the card this process must
    carry them, which shows that the check can see them at all."""
    own = cuda_marks(os.getpid())
    if torch.cuda.is_available() and torch.cuda.is_initialized() and not own:
        raise AssertionError(f"{what}: this process holds a CUDA context "
                             f"but /proc shows none of its marks")
    bad = {pid: m for pid in pids if (m := cuda_marks(pid))}
    if bad:
        raise AssertionError(f"{what}: memory nodes carry CUDA marks {bad}")
    return (f"no CUDA mark in /proc of the {len(pids)} memory nodes (this "
            f"process: {', '.join(own) or 'none, no card'})")


def _remote_equal(so, lo, what: str) -> None:
    """A remote search against LocalPool's on the same batch: bit-identical
    results and equal counted stats."""
    _bit_equal(so, lo, what)
    if not _counted_equal(so[2], lo[2]):
        raise AssertionError(f"{what}: counted stats {_counted(so[2])} vs "
                             f"LocalPool's {_counted(lo[2])}")


def _wire_line(wire, nq: int, before=None) -> str:
    """The wire's bytes (both ways) and request frames, since ``before``
    (a copy of the counters) when given."""
    b = before or {"bytes_rx": 0, "bytes_tx": 0, "frames_tx": 0}
    mb = (wire["bytes_rx"] + wire["bytes_tx"] - b["bytes_rx"]
          - b["bytes_tx"]) / 1e6
    return (f"wire {mb:.3f} MB in {wire['frames_tx'] - b['frames_tx']} "
            f"frames ({mb * 1e3 / nq:.2f} KB a query)")


def phase_remote(ds, meta, store, qstore, device, *, k: int, doorbell: int,
                 log_: PathLog) -> None:
    """Phase 14a: one memory node.  ``pool="remote"`` over the loopback
    bearer (an in-process ``HostRegion``) and over tcp to one spawned
    ``python -m repro_torch.net.server``, in phase 5's exact scan and phase
    6's int8 flat configurations, one batch each, beside LocalPool: gids
    and distances bit-identical, counted stats equal, every data verb's
    measured payload equal to the modeled bytes; on the int8 flat engine
    the flat view fetched over the wire equals LocalPool's and stage 1
    runs through ``quant_topk``.  Prints the batch and flat-sync walls,
    the wire MB and frames, and the host-to-device uploads a batch."""
    B = len(ds.queries)
    exact = exact_config(meta.n_partitions, doorbell, "scan")
    flat = flat_config(meta.n_partitions, doorbell)
    with spawn_pool_servers(1, with_procs=True) as (eps, procs):
        for label, cfg, st0 in (("exact scan", exact, store),
                                ("int8 flat", flat, qstore)):
            local = DHNSWEngine(cfg, device=device).adopt_built(
                meta, dataclasses.replace(st0), ds.data)
            with Wrapped(local.client, "_sync_flat", device) as lsync:
                lo = _search(local, ds.queries, k, device)
            for bearer in ("loopback", "tcp"):
                what = f"remote/{bearer} {label}"
                t0 = time.perf_counter()
                eng = DHNSWEngine(dataclasses.replace(
                    cfg, pool="remote", bearer=bearer,
                    endpoints=(eps[0],) if bearer == "tcp" else None),
                    device=device).adopt_built(
                    meta, dataclasses.replace(st0), ds.data)
                attach_s = time.perf_counter() - t0
                w0 = dict(eng.pool.wire)
                with Wrapped(eng.client, "_sync_flat", device) as sync, \
                        Wrapped(eng.pool, "_up", device) as ups:
                    so = log_.search(eng, ds.queries, k)
                _remote_equal(so, lo, what)
                _check_output(so[0], so[1], B, k, ds.data.shape[0], what)
                snap = eng.pool.snapshot()
                wvm = snap["wire_vs_model"]
                off = {v: r for v, r in wvm.items() if v.startswith("read")
                       and r["measured"] != r["modeled"]}
                if not wvm or off:
                    raise AssertionError(f"{what}: wire vs model {wvm}")
                line = ""
                if label == "int8 flat":
                    cl, cr = local.client, eng.client
                    for a in ("_flat_codes", "_flat_scales", "_flat_cols"):
                        if cl._flat_n != cr._flat_n or not torch.equal(
                                getattr(cl, a)[:cl._flat_n],
                                getattr(cr, a)[:cr._flat_n]):
                            raise AssertionError(f"{what}: {a} differs from "
                                                 f"LocalPool's flat view")
                    want_impl = "cuda" if device.type == "cuda" else "ref"
                    if so[2]["stage1_impl"] != want_impl or (
                            device.type == "cuda"
                            and so[4]["quant_topk"] == 0):
                        raise AssertionError(f"{what}: stage 1 "
                                             f"{so[2]['stage1_impl']}, "
                                             f"launches {so[4]}")
                    line = (f" | flat view ({cr._flat_n} rows) equal to "
                            f"LocalPool's, stage 1 {so[2]['stage1_impl']}, "
                            f"flat sync {sync.seconds:.4f} s (LocalPool "
                            f"{lsync.seconds:.4f} s)")
                log(f"[14a {what}] bit-identical to LocalPool, counted net "
                    f"equal ({_counted(so[2])}), measured = modeled bytes "
                    f"for {sorted(v for v in wvm if v.startswith('read'))}"
                    f"{line} | batch wall {so[3]:.4f} s (LocalPool "
                    f"{lo[3]:.4f} s) | {_wire_line(snap['wire'], B, w0)} "
                    f"| "
                    f"uploads a batch {ups.calls} | attach {attach_s:.2f} s "
                    f"| launches {so[4]}")
                del eng
            del local
        log(f"[14a] {no_cuda_context([p.pid for p in procs], '14a')}")
    if device.type == "cuda":
        torch.cuda.empty_cache()


def phase_remote_chaos(ds, meta, store, device, *, k: int, doorbell: int,
                       n_servers: int, n_batches: int, kill_after: int,
                       n_insert: int, log_: PathLog) -> None:
    """Phase 14b: ``benchmarks/pool.py run_chaos``'s protocol on phase 3's
    index: ``n_servers`` spawned memory nodes at ``replication=2`` in phase
    5's exact scan configuration, beside a LocalPool engine in lockstep,
    ``n_batches`` batches; after ``kill_after`` of them server 0 gets
    SIGKILL.  Every batch bit-identical, its counted stats as
    ``_fanout_counted`` holds them (the batch that meets the death too:
    the failed slice charged nothing, its retry is a part of its own);
    one death, no lost group, at least one read retry; then ``n_insert``
    inserts through both (equal gids) and a bit-identical search."""
    cfg = exact_config(meta.n_partitions, doorbell, "scan")
    local = DHNSWEngine(cfg, device=device).adopt_built(
        meta, copy.deepcopy(store), ds.data)
    per = len(ds.queries) // n_batches
    qs = [ds.queries[i * per:(i + 1) * per] for i in range(n_batches)]
    walls = []

    def both(q, what):
        lo = _search(local, q, k, device)
        so = log_.search(eng, q, k)
        _bit_equal(so, lo, what)
        _fanout_counted(so[2], lo[2], log_.trips, what)
        walls.append((round(so[3], 4), round(lo[3], 4)))
        return so
    with spawn_pool_servers(n_servers, with_procs=True) as (eps, procs):
        eng = DHNSWEngine(dataclasses.replace(
            cfg, pool="remote", endpoints=tuple(eps), replication=2),
            device=device).adopt_built(meta, copy.deepcopy(store), ds.data)
        for i, q in enumerate(qs):
            if i == kill_after:
                procs[0].kill()
                procs[0].wait(timeout=10)
            both(q, f"14b batch {i}")
        fo = dict(eng.pool.failover)
        if (fo["deaths"], fo["lost_groups"]) != (1, 0) or (
                fo["read_retries"] < 1):
            raise AssertionError(f"14b failover {fo}")
        new = np.ascontiguousarray(ds.queries[:n_insert])
        g_local, g_remote = local.insert(new), eng.insert(new)
        if not np.array_equal(g_local, g_remote):
            raise AssertionError(f"14b insert: gids {g_remote[:4]} vs "
                                 f"{g_local[:4]}")
        last = both(qs[0], "14b after the inserts")
        snap = eng.pool.snapshot()
        seen = no_cuda_context([p.pid for p in procs[1:]], "14b")
    log(f"[14b chaos] {n_servers} memory nodes, replication 2, SIGKILL to "
        f"server 0 after batch {kill_after}: every batch bit-identical to "
        f"LocalPool, nothing raised | failover {fo} | re-replicated "
        f"{fo['rereplicate_bytes'] / 1e6:.3f} MB | wall of the batch that "
        f"met the death {walls[kill_after][0]} s (LocalPool "
        f"{walls[kill_after][1]} s) | wall s (remote, LocalPool) "
        f"{walls} | {n_insert} inserts: gids equal, then a search "
        f"bit-identical | alive {snap['alive']} | "
        f"{_wire_line(snap['wire_total'], len(ds.queries))} | last "
        f"launches {last[4]} | {seen}")
    del local, eng
    if device.type == "cuda":
        torch.cuda.empty_cache()


def phase_remote_durable(device, *, k: int, doorbell: int, n: int,
                         n_append: int, n_search: int,
                         log_: PathLog) -> None:
    """Phase 14c: one durable memory node (``--data-dir``) holds the region
    of ``benchmarks/ingest.py run_recovery``'s geometry (``n`` rows, 8
    partitions, ``ov_cap`` = ``n_append``; phase 3's region is past the
    write-ahead log's record bound, ``REDUCED``); ``n_append`` held-out
    queries are appended through its
    ``RemotePool`` and through a LocalPool twin; the server gets SIGKILL,
    restarts on the same directory, and a ``RemotePool`` built with
    ``attach="auto"`` connects, searched through a ``ComputeClient`` made
    by its public constructor (``make_pool_factory`` builds pools that
    upload anew): it must re-attach through the fingerprint handshake
    (``attached_via == "recovered"``, every logged record replayed), and a
    search of the last ``n_search`` queries (the appended ones among them,
    each appended to the partition the meta-HNSW routes it to) is
    bit-identical to a LocalPool engine over the twin's region and finds
    every appended row."""
    ds = sift_like(n=n, n_queries=n_search, seed=SEED)
    meta = ME.build_meta(ds.data, 8, seed=0, meta_levels=2)
    store = LA.build_store(ds.data, meta, ov_cap=max(n_append, 8),
                           sub_params=HNSWParams(M=4, M0=8,
                                                 ef_construction=40))
    cfg = exact_config(meta.n_partitions, doorbell, "scan")
    vecs = np.ascontiguousarray(ds.queries[-n_append:])
    pids = _route(meta, vecs, device, 1)[:, 0]
    mirror = copy.deepcopy(store)
    twin = LocalPool(mirror, device=device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_wal_") as ddir:
        with spawn_pool_servers(1, data_dirs=[ddir],
                                with_procs=True) as (eps, procs):
            t0 = time.perf_counter()
            rp = RemotePool(copy.deepcopy(store), eps[0], device=device)
            attach_s = time.perf_counter() - t0
            for i, (vec, pid) in enumerate(zip(vecs, pids)):
                gid = ds.data.shape[0] + i
                a, b = (p.append(vec, gid, int(pid), ledger=None)
                        for p in (twin, rp))
                if not a == b >= 0:
                    raise AssertionError(f"14c append {i}: slots {a}, {b}")
            pre = rp.server_stats()["ingest"]
            procs[0].kill()
            procs[0].wait(timeout=10)
        t0 = time.perf_counter()
        with spawn_pool_servers(1, data_dirs=[ddir]) as eps2:
            # make_pool_factory's pools upload the region anew
            # (attach="always"); recovery asks for attach="auto"
            rec = ComputeClient(
                dataclasses.replace(cfg, pool="remote",
                                    endpoints=(eps2[0],)),
                lambda st: RemotePool(st, eps2[0], device=device,
                                      fabric=cfg.fabric, attach="auto"),
                device).adopt_built(meta, mirror, ds.data)
            recover_s = time.perf_counter() - t0
            ing = rec.pool.server_stats()["ingest"]
            if rec.pool.attached_via != "recovered" or (
                    ing["replayed_records"] != pre["wal_records"]
                    or pre["wal_records"] != 1 + n_append):
                raise AssertionError(f"14c: attached via "
                                     f"{rec.pool.attached_via}, logged "
                                     f"{pre}, recovered {ing}")
            loc = DHNSWEngine(cfg, device=device).adopt_built(
                meta, mirror, ds.data)
            q = ds.queries[-n_search:]
            lo = _search(loc, q, k, device)
            so = log_.search(rec, q, k)
            _remote_equal(so, lo, "14c recovered")
            found = int(sum(ds.data.shape[0] + i in so[1][-n_append + i]
                            for i in range(n_append)))
            if found != n_append:
                raise AssertionError(f"14c: {found} of the {n_append} "
                                     f"appended rows found by their own "
                                     f"query")
    log(f"[14c durable] {n_append} appends logged ({pre['wal_records']} WAL "
        f"records, {pre['wal_bytes'] / 1e6:.3f} MB: the ATTACH of the "
        f"region and the appends) -> SIGKILL -> restart: attached via "
        f"{rec.pool.attached_via}, {ing['replayed_records']} records "
        f"replayed, checkpoint {ing['checkpoint_bytes'] / 1e6:.3f} MB | "
        f"recovery wall {recover_s:.2f} s (restart, replay, checkpoint, "
        f"handshake; the first ATTACH took {attach_s:.2f} s) | search of "
        f"{n_search} bit-identical to LocalPool over the twin's region, "
        f"each appended row found by its own query | wall {so[3]:.4f} s "
        f"(LocalPool {lo[3]:.4f} s) | launches {so[4]}")
    del rec, loc, twin
    if device.type == "cuda":
        torch.cuda.empty_cache()


def phase_remote_bench(device, log_: PathLog) -> None:
    """Phase 14d: ``benchmarks/torch_ingest.py --smoke`` on ``device``:
    every field of ``recovery`` (a durable memory node killed and
    recovered from its log) but those in ``CLOCK`` equals
    ``benchmarks/baselines/BENCH_ingest.json``'s.  One path in
    ``log_``; its pools (a ``LocalPool`` twin and ``RemotePool``s) append
    and read rows and gather no span."""
    base = json.loads((ROOT / "benchmarks" / "baselines"
                       / "BENCH_ingest.json").read_text())
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, log_.path() as launches:
        ingest = torch_ingest.run(smoke=True, device=device,
                                  out=f"{tmp}/BENCH_torch_ingest.json")
    wall = time.perf_counter() - t0
    _bench_fields_equal(ingest, base, "recovery", CLOCK)
    rc = ingest["recovery"]
    log(f"[14d torch_ingest --smoke] recovery equal to the baseline but "
        f"the clock: {rc['n_appends']} appends, {rc['wal_records']} "
        f"records {rc['wal_kb']} KB, replayed {rc['replayed_records']}, "
        f"checkpoint {rc['checkpoint_kb']} KB, via {rc['attached_via']} "
        f"({rc['recover_wall_s']} s) | {wall:.1f} s | launches {launches}")


# ------------------------------------------------------ LM families (15)

def attention_layers(cfg) -> int:
    """Layers a decode step sends through ``decode_attention``: every
    decoder layer of the transformer families and of encdec, the hybrid's
    shared block once a use, none of mamba2's (these configurations have
    no sliding window and no score softcap)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers


def param_bytes(cfg) -> int:
    """Bytes of a serving copy's parameters (``stored_dtype``)."""
    return sum(int(np.prod(d.shape)) * LM.stored_dtype(cfg, path[-1]).itemsize
               for path, d in PR._leaves(LM.param_defs(cfg)))


def layer_bytes(cfg) -> int:
    """Bytes a layer adds to a serving copy."""
    return (param_bytes(cfg.replace(n_layers=1))
            - param_bytes(cfg.replace(n_layers=0)))


def fit_depth(cfg, device, *, step: int = 8,
              margin: float = MEM_MARGIN) -> tuple[int, int]:
    """(``cfg.n_layers``, or the deepest multiple of ``step`` whose
    serving copy fits the card's free memory with ``margin`` bytes to
    spare; the free bytes)."""
    free, _ = torch.cuda.mem_get_info(device)
    base, per = param_bytes(cfg.replace(n_layers=0)), layer_bytes(cfg)
    if base + cfg.n_layers * per + margin <= free:
        return cfg.n_layers, free
    depth = int((free - margin - base) // per) // step * step
    if depth < step:
        raise AssertionError(f"{cfg.name}: {free / 1e9:.1f} GB free, "
                             f"{per / 1e9:.2f} GB a layer")
    return depth, free


def _tree_bytes(tree) -> int:
    return sum(_tree_bytes(v) if isinstance(v, dict) else
               v.numel() * v.element_size() for v in tree.values())


def _free(device) -> None:
    """Collect unreachable cycles, then hand the card's cached blocks
    back, so the next model's weights find the memory free."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


class ExpertDrops:
    """While active, counts the expert assignments of every ``moe_ffn``
    call and those past each expert's capacity C (sum over experts of
    max(0, count - C), the assignments of rank >= C in order of arrival),
    from the router's choices and apart from the dispatch code; calls of
    ``batch`` tokens are decode steps, the others prefills.  Sums stay on
    the device until ``shares`` reads them."""

    def __init__(self, batch: int):
        self.batch = batch
        self.acc = {"prefill": [], "decode": []}

    def __enter__(self) -> "ExpertDrops":
        self.real = MOE._route
        MOE._route = self._call
        return self

    def _call(self, cfg, xf, router):
        top_p, top_i, aux = self.real(cfg, xf, router)
        T = xf.shape[0]
        counts = torch.bincount(top_i.reshape(-1), minlength=cfg.n_experts)
        dropped = torch.clamp(counts - MOE._capacity(cfg, T), min=0).sum()
        key = "decode" if T == self.batch else "prefill"
        self.acc[key].append((top_i.numel(), dropped))
        return top_p, top_i, aux

    def __exit__(self, *exc) -> None:
        MOE._route = self.real

    def shares(self, n_layers: int) -> dict:
        """Per kind: assignments, dropped, their share, and the share at
        the first and at the last layer (a call walks the layers in
        order)."""
        out = {}
        for key, v in self.acc.items():
            d = [int(x) for _, x in v]
            n = [m for m, _ in v]
            out[key] = {"assigned": sum(n), "dropped": sum(d),
                        "share": sum(d) / max(sum(n), 1),
                        "first_layer": sum(d[::n_layers])
                        / max(sum(n[::n_layers]), 1),
                        "last_layer": sum(d[n_layers - 1::n_layers])
                        / max(sum(n[n_layers - 1::n_layers]), 1)}
        return out


def host_drop_share(xf: torch.Tensor, router: torch.Tensor, cfg) -> float:
    """The share of expert assignments past capacity when the router sees
    the rows ``xf`` (T, d): top-k of the logits in f64 on the host, each
    expert's count against C = max(ceil(T k cf / E), 4); written apart
    from ``models/moe.py``."""
    x = xf.double().cpu().numpy()
    logits = x @ router.double().cpu().numpy()
    T, E, k = x.shape[0], cfg.n_experts, cfg.moe_top_k
    top = np.argsort(-logits, axis=1, kind="stable")[:, :k]
    counts = np.bincount(top.reshape(-1), minlength=E)
    C = max(int(np.ceil(T * k * cfg.capacity_factor / E)), 4)
    return float(np.maximum(counts - C, 0).sum() / (T * k))


class MoeLayer0:
    """While active, keeps the tokens of the first prefill; ``read(eng)``
    then rebuilds that prefill's layer 0 on the card from the engine's
    parameters and reads what its router sees: the distinct documents in
    the batch, the rms of the embedding and of the attention output that
    is added to it, the cosine of the router inputs of neighbouring
    positions and of positions S/2 apart, and the drop share recomputed
    on the host (``host_drop_share``) for the router input itself, for
    the embedding alone in its place, and for the distinct rows alone."""

    def __enter__(self) -> "MoeLayer0":
        self.tokens, self.real = None, LM.prefill

        def prefill(cfg, params, batch, *a, **k):
            if self.tokens is None:
                self.tokens = batch["tokens"].clone()
            return self.real(cfg, params, batch, *a, **k)
        LM.prefill = prefill
        return self

    def __exit__(self, *exc) -> None:
        LM.prefill = self.real

    def read(self, eng, *, doc_len: int, docs_per_query: int) -> dict:
        cfg, p, tok = eng.cfg, eng.params, self.tokens
        B, S = tok.shape
        d = cfg.d_model
        blk = PR.layer(p["blocks"], 0)
        with torch.inference_mode():
            x0 = LY.embed(p, tok, PR.compute_dtype(cfg))
            h, _ = TF._attn_block(cfg, blk, x0, int(TF.layer_windows(cfg)[0]),
                                  mode="prefill")
            xf = LY.rms_norm(h, blk["mlp_norm"], cfg.norm_eps)
            xe = LY.rms_norm(x0, blk["mlp_norm"], cfg.norm_eps)

            def rms(t):
                return float(t.float().pow(2).mean().sqrt())

            def cos(t, lag):
                t = t.float()
                return float(torch.nn.functional.cosine_similarity(
                    t[:, lag:], t[:, :S - lag], dim=-1).abs().mean())
            docs = tok[:, :doc_len * docs_per_query].reshape(-1, doc_len)
            flat = xf.reshape(-1, d)
            out = {"docs": int(torch.unique(docs, dim=0).shape[0]),
                   "slots": int(docs.shape[0]),
                   "rms_embed": rms(x0), "rms_attn": rms(h - x0),
                   "cos_next": cos(xf, 1), "cos_half": cos(xf, S // 2),
                   "cos_next_embed": cos(xe, 1),
                   "cos_half_embed": cos(xe, S // 2),
                   "share": host_drop_share(flat, blk["router"], cfg),
                   "share_embed": host_drop_share(xe.reshape(-1, d),
                                                  blk["router"], cfg)}
            uniq = torch.unique(flat.float(), dim=0)
            out["distinct_rows"] = int(uniq.shape[0])
            out["share_distinct"] = host_drop_share(uniq, blk["router"], cfg)
        return out


def serve_family(ds, meta, store, device, cfg, *, log_, tag: str,
                 doorbell: int, doc_len: int, prompt_len: int, batch: int,
                 max_new_tokens: int, docs_per_query: int, n_calls: int,
                 seed: int = SEED, first=(), after=None) -> list:
    """``RagServeEngine.serve`` with ``cfg`` over phase 5's exact-scan
    engine (the CUDA gather on), in phase 9's geometry: documents of
    ``doc_len`` tokens drawn with numpy from the seed, ``batch`` prompts.
    Each of ``n_calls`` calls is one path of ``log_`` (its gather calls
    recorded for phase 4), the first inside the contexts ``first``; each
    must make ``attention_layers(cfg) * max_new_tokens`` decode_attention
    launches and, on the card, gather launches exactly when its retrieval
    fetched (a later call can hit the cache for every span), and give
    tokens in range, equal across calls.  ``after(eng)`` runs before the engine
    is closed.  Returns (the tokens of each call, the launches summed
    over the calls)."""
    rng = np.random.default_rng(seed)
    docs = DocStore(ds.data, rng.integers(0, cfg.vocab_size,
                                          (len(ds.data), doc_len),
                                          dtype=np.int32))
    prompts = rng.integers(0, cfg.vocab_size, (batch, prompt_len),
                           dtype=np.int32)
    retriever = DHNSWEngine(exact_config(meta.n_partitions, doorbell, "scan"),
                            device=device).adopt_built(
        meta, dataclasses.replace(store), ds.data)
    t0 = time.perf_counter()
    eng = RagServeEngine(cfg, retriever, docs, max_new_tokens=max_new_tokens,
                         docs_per_query=docs_per_query, seed=seed,
                         device=device)
    _free(device)
    heads = (f"heads {cfg.n_heads}/{cfg.n_kv_heads} x {cfg.the_head_dim()}"
             if cfg.n_heads else f"ssm state {cfg.ssm_state}")
    log(f"[{tag}] {cfg.name} ({cfg.family}): {cfg.n_layers} layers, d "
        f"{cfg.d_model}, {heads}, vocab {cfg.vocab_size}: weights "
        f"{_tree_bytes(eng.params) / 1e9:.2f} GB drawn on {device} in "
        f"{time.perf_counter() - t0:.2f} s | {batch} prompts x {prompt_len}"
        f" + {docs_per_query} docs x {doc_len}, {max_new_tokens} new tokens")
    S = docs_per_query * doc_len + prompt_len
    on_card = device.type == "cuda"
    want = attention_layers(cfg) * max_new_tokens if on_card else 0
    outs, launches = [], {name: 0 for name in KERNEL_OPS}
    try:
        for i in range(n_calls):
            with contextlib.ExitStack() as stack:
                for ctx in (first if i == 0 else ()):
                    stack.enter_context(ctx)
                with log_.path() as n:
                    t0 = time.perf_counter()
                    out, st = eng.serve(prompts)
                    wall = time.perf_counter() - t0
            fetched = st.retrieval["n_fetches"] > 0
            if n["decode_attention"] != want or (
                    on_card and (n["gather_blocks"] > 0) != fetched):
                raise AssertionError(f"{tag} call {i}: launches {n} and "
                                     f"{st.retrieval['n_fetches']} fetches,"
                                     f" want {want} decode_attention and a "
                                     f"gather launch iff a fetch")
            if out.shape != (batch, max_new_tokens) or not (
                    (out >= 0) & (out < cfg.vocab_size)).all():
                raise AssertionError(f"{tag} call {i}: tokens out of range")
            outs.append(out)
            for name in launches:
                launches[name] += n[name]
            log(f"[{tag}] call {i}: wall {wall:.4f} s = retrieve "
                f"{st.retrieve_s:.4f} s + prefill {st.prefill_s:.4f} s "
                f"(S={S}) + decode {st.decode_s:.4f} s "
                f"({batch * max_new_tokens / st.decode_s:.1f} tokens/s, "
                f"{st.decode_s / max_new_tokens * 1e3:.3f} ms a step) | "
                f"fetches {st.retrieval['n_fetches']} | launches {n}")
        if any(not np.array_equal(outs[0], o) for o in outs[1:]):
            raise AssertionError(f"{tag}: the calls generated different "
                                 f"tokens")
        if after is not None:
            after(eng)
    finally:
        eng.close()
    del eng, retriever
    _free(device)
    return outs, launches


def phase_moe_serve(ds, meta, store, device, *, log_, capture, doorbell,
                    **rag) -> None:
    """Phase 15a: ``serve_family`` with qwen3-moe-30b-a3b at full width
    (128 experts, top-8) and, memory allowing, full depth, two calls
    with equal tokens; the first counts the expert assignments dropped at
    capacity in prefill and in decode (``ExpertDrops``) and captures the
    first decode_attention call for phase 4."""
    cfg = get_config(MOE_ARCH)
    depth, free = fit_depth(cfg, device)
    cut = ("full depth" if depth == cfg.n_layers else
           f"depth cut from {cfg.n_layers} to {depth} to fit beside the "
           f"index")
    log(f"[15a moe] {cfg.name}: {param_bytes(cfg.replace(n_layers=depth)) / 1e9:.2f}"
        f" GB of parameters at {depth} layers ({cut}); "
        f"{free / 1e9:.1f} GB free")
    drops, layer0, seen = ExpertDrops(rag["batch"]), MoeLayer0(), {}
    outs, launches = serve_family(
        ds, meta, store, device, cfg.replace(n_layers=depth), log_=log_,
        tag="15a moe", doorbell=doorbell, n_calls=2,
        first=(capture, drops, layer0), after=lambda eng: seen.update(
            layer0.read(eng, doc_len=rag["doc_len"],
                        docs_per_query=rag["docs_per_query"])), **rag)
    sh = drops.shares(depth)
    log(f"[15a moe] 2 calls generated equal tokens; first sequence "
        f"{outs[0][0][:8].tolist()}... | decode_attention launches "
        f"{launches['decode_attention']} | expert assignments dropped at "
        f"capacity (first call): "
        + "; ".join(f"{k} {v['dropped']} of {v['assigned']} "
                    f"({v['share']:.5f}; layer 0 {v['first_layer']:.5f}, "
                    f"layer {depth - 1} {v['last_layer']:.5f})"
                    for k, v in sh.items()))
    r = seen
    log(f"[15a moe layer 0] the first call's prefill: {r['docs']} distinct "
        f"documents in its {r['slots']} slots, {r['distinct_rows']} distinct"
        f" router input rows of {rag['batch'] * (rag['prompt_len'] + rag['doc_len'] * rag['docs_per_query'])}"
        f" | rms: embedding {r['rms_embed']:.6f}, layer 0's attention "
        f"output {r['rms_attn']:.6f} | router input |cosine| of neighbouring"
        f" positions {r['cos_next']:.4f}, of positions S/2 apart "
        f"{r['cos_half']:.4f} (embedding alone {r['cos_next_embed']:.4f}, "
        f"{r['cos_half_embed']:.4f}) | dropped at capacity, recomputed on "
        f"the host: {r['share']:.5f} (counted in the call "
        f"{sh['prefill']['first_layer']:.5f}); with the embedding alone as "
        f"the router input {r['share_embed']:.5f}; the distinct rows alone "
        f"{r['share_distinct']:.5f}")


def _pixtral_patches(eng, *, log_, n_steps: int, seed: int = SEED) -> None:
    """pixtral's model-level prefill with ``n_patches`` patch embeddings
    (seeded, on the card) prepended to the RAG geometry's 1024 tokens,
    then ``n_steps`` greedy decode steps: finite logits, one
    decode_attention launch a layer a step."""
    cfg, dev = eng.cfg, eng.device
    B, S = 8, 1024
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), device=dev,
                                     generator=gen),
             "patches": torch.randn((B, cfg.n_patches, cfg.d_model),
                                    device=dev, generator=gen)}
    S_all = S + cfg.n_patches
    with log_.path() as n, torch.inference_mode():
        t0 = time.perf_counter()
        logits, cache = LM.prefill(cfg, eng.params, batch, S_all + n_steps)
        _free(dev)
        pre = time.perf_counter() - t0
        tok = logits[:, -1].argmax(-1).to(torch.int32)
        pos = torch.full((B,), S_all, dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        for _ in range(n_steps):
            logits, cache = LM.decode_step(cfg, eng.params, cache, tok, pos)
            tok = logits.argmax(-1).to(torch.int32)
            pos = pos + 1
        _free(dev)
        dec = time.perf_counter() - t0
    want = cfg.n_layers * n_steps if dev.type == "cuda" else 0
    if not torch.isfinite(logits).all() or n["decode_attention"] != want:
        raise AssertionError(f"15b pixtral patches: launches {n}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    log(f"[15b vlm] {cfg.name} model-level prefill with {cfg.n_patches} "
        f"patches + {S} tokens (S={S_all}, B={B}): {pre:.4f} s, "
        f"{n_steps} decode steps {dec / n_steps * 1e3:.3f} ms a step | "
        f"launches {n}")
    del cache, logits


def phase_whisper(device, *, log_, capture, arch: str, batch: int,
                  prompt_len: int, max_new_tokens: int,
                  seed: int = SEED) -> None:
    """Phase 15b, encdec: whisper-tiny through ``model.prefill`` with frame
    embeddings (B x enc_seq 1500, seeded on the card; the engine passes
    none, as the reference's) and ``max_new_tokens`` greedy decode steps,
    each decoder layer's self-attention through decode_attention."""
    cfg = get_config(arch)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = PR.init_params(LM.param_defs(cfg), gen,
                            cast=lambda n, t: t.to(LM.stored_dtype(cfg, n)))
    batch_in = {"tokens": torch.randint(0, cfg.vocab_size,
                                        (batch, prompt_len), device=device,
                                        generator=gen),
                "frames": torch.randn((batch, cfg.enc_seq, cfg.d_model),
                                      device=device, generator=gen)}
    with capture, log_.path() as n, torch.inference_mode():
        t0 = time.perf_counter()
        logits, cache = LM.prefill(cfg, params, batch_in,
                                   prompt_len + max_new_tokens)
        _free(device)
        pre = time.perf_counter() - t0
        tok = logits[:, -1].argmax(-1).to(torch.int32)
        pos = torch.full((batch,), prompt_len, dtype=torch.int32,
                         device=device)
        out = []
        t0 = time.perf_counter()
        for _ in range(max_new_tokens):
            out.append(tok)
            logits, cache = LM.decode_step(cfg, params, cache, tok, pos)
            tok = logits.argmax(-1).to(torch.int32)
            pos = pos + 1
        _free(device)
        dec = time.perf_counter() - t0
    want = (attention_layers(cfg) * max_new_tokens
            if device.type == "cuda" else 0)
    if n["decode_attention"] != want or not torch.isfinite(logits).all():
        raise AssertionError(f"15b whisper: launches {n}, want {want}")
    log(f"[15b encdec] {cfg.name}: {cfg.n_enc_layers}+{cfg.n_layers} layers"
        f", d {cfg.d_model}, enc_seq {cfg.enc_seq}, B={batch}: prefill "
        f"{pre:.4f} s (S={prompt_len}), decode {dec:.4f} s "
        f"({batch * max_new_tokens / dec:.1f} tokens/s, "
        f"{dec / max_new_tokens * 1e3:.3f} ms a step) | first sequence "
        f"{torch.stack(out, 1)[0, :8].tolist()}... | launches {n}")
    del params, cache
    _free(device)


def phase_families_serve(ds, meta, store, device, *, log_, captures,
                         doorbell, **rag) -> None:
    """Phase 15b: one ``serve_family`` call each for the families beside
    moe (``FAMILY_DEPTH``: full depth, or the printed cut), pixtral's
    model-level prefill with patches, and whisper (``phase_whisper``)."""
    for arch, depth in FAMILY_DEPTH.items():
        cfg = get_config(arch)
        if depth is not None:
            log(f"[15b] {cfg.name}: depth cut from {cfg.n_layers} to "
                f"{depth} ({layer_bytes(cfg) / 1e9:.2f} GB a layer)")
            cfg = cfg.replace(n_layers=depth)
        after = (lambda eng: _pixtral_patches(eng, log_=log_, n_steps=4)
                 if cfg.family == "vlm" else None)
        cap = captures.get(arch)
        serve_family(ds, meta, store, device, cfg, log_=log_,
                     tag=f"15b {cfg.family}", doorbell=doorbell, n_calls=1,
                     first=(cap,) if cap else (), after=after, **rag)
    phase_whisper(device, log_=log_, capture=captures[WHISPER["arch"]],
                  **WHISPER)


def _family_inputs(cfg, batch: int, seq: int, seed: int = SEED) -> dict:
    """Seeded numpy inputs of a prefill (tokens; frames or patches)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq))}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (batch, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def phase_card_vs_cpu(device, *, batch: int, seq: int, steps: int,
                      n_layers: int) -> None:
    """Phase 15c: each configuration of this slice at full width, cut to
    ``n_layers`` layers (the hybrid to ``n_layers`` uses of its shared
    block), in f32: weights drawn once on the card and copied to the CPU,
    a prefill of ``batch`` x ``seq`` tokens and ``steps`` greedy decode
    steps on both, fed the card's tokens.  The CPU path is the one the
    tests hold against the JAX package; the card's runs cuBLAS (TF32 off)
    and decode_attention.  Greedy tokens equal, logits within
    ``CARD_CPU_TOL``.  Its launches are a comparison, not the main path:
    the counts are set to 0 after it."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for f32 products")
    cpu = torch.device("cpu")
    for arch in CARD_CPU_ARCHS:
        full = get_config(arch)
        depth = n_layers * (full.attn_every if full.family == "hybrid" else 1)
        cfg = full.replace(n_layers=depth, dtype="float32")
        t0 = time.perf_counter()
        params = PR.init_params(LM.param_defs(cfg), torch.Generator(
            device=device).manual_seed(SEED))
        host = _tree_to(params, cpu)
        inputs = _family_inputs(cfg, batch, seq)
        S_all = seq + (cfg.n_patches if cfg.family == "vlm" else 0)
        errs, toks = [], []
        with torch.inference_mode():
            (la, ca), (lb, cb) = (
                LM.prefill(cfg, p, {k: torch.as_tensor(v, device=dev)
                                    for k, v in inputs.items()},
                           S_all + steps)
                for dev, p in ((device, params), (cpu, host)))
            la, lb = la[:, -1], lb[:, -1]
            pos = torch.full((batch,), S_all, dtype=torch.int32)
            for step in range(steps + 1):
                a = la.cpu()
                errs.append(float((a - lb).abs().max()))
                if not torch.allclose(a, lb, **CARD_CPU_TOL):
                    raise AssertionError(f"15c {arch} step {step}: card and "
                                         f"CPU logits differ by "
                                         f"{errs[-1]:.3g}")
                ta, tb = a.argmax(-1), lb.argmax(-1)
                if not torch.equal(ta, tb):
                    raise AssertionError(f"15c {arch} step {step}: greedy "
                                         f"tokens {ta.tolist()} on the card,"
                                         f" {tb.tolist()} on the CPU")
                toks.append(ta.tolist())
                if step == steps:
                    break
                tok = ta.to(torch.int32)
                la, ca = LM.decode_step(cfg, params, ca, tok.to(device),
                                        pos.to(device))
                lb, cb = LM.decode_step(cfg, host, cb, tok, pos)
                pos = pos + 1
            for a, b in zip(ca, cb):
                if not torch.allclose(a.cpu(), b, **CARD_CPU_TOL):
                    raise AssertionError(
                        f"15c {arch}: caches differ by "
                        f"{float((a.cpu() - b).abs().max()):.3g}")
        log(f"[15c card vs cpu] {cfg.name} ({cfg.family}, {depth} layers, "
            f"full width, f32): prefill B={batch} S={S_all} and {steps} "
            f"decode steps; greedy tokens equal, first two steps {toks[:2]};"
            f" max |card - cpu| of the logits by step "
            f"{[f'{e:.3g}' for e in errs]}; caches within {CARD_CPU_TOL} | "
            f"{time.perf_counter() - t0:.1f} s")
        del params, host, la, lb, ca, cb
        _free(device)
    _reset_launches()


def _tree_to(tree: dict, device) -> dict:
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


# ------------------------------------------------------ sharded store (16)

# one rank of phase 16: argv = src dir, backend, world, rank, device, the
# directory holding store.npz; writes <backend>_<device>_rank<rank>.npz
SHARD_RANK = r"""
import sys, time
import numpy as np
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
from repro_torch.core.distributed import ShardedStore
from repro_torch.core.layout import LayoutSpec, Store
_, _, backend, world, rank, dev, tmp, iters = sys.argv
world, rank, iters = int(world), int(rank), int(iters)
dist.init_process_group(backend, init_method=f"file://{tmp}/rdv_{backend}_{dev}",
                        world_size=world, rank=rank)
a = np.load(f"{tmp}/store.npz")
store = Store(spec=LayoutSpec(**{k[5:]: int(a[k]) for k in a.files
                                 if k.startswith("spec_")}),
              graph_buf=a["graph_buf"], vec_buf=a["vec_buf"],
              meta_table=a["meta_table"], n_base=a["n_base"])
ss = ShardedStore(store, device=dev)
calls = []
real = dist.all_reduce
dist.all_reduce = lambda *x, **k: calls.append(1) or real(*x, **k)
sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
g, v = ss.fetch(a["ids"])
sync()
dist.barrier()
t0 = time.perf_counter()
for _ in range(iters):
    ss.fetch(a["ids"])
sync()
ms = (time.perf_counter() - t0) / iters * 1e3
np.savez(f"{tmp}/{backend}_{dev}_rank{rank}.npz", g=g.cpu().numpy(),
         v=v.cpu().numpy(), ms=ms, calls=len(calls) / (iters + 1),
         bytes=ss.stats["operand_bytes"] / ss.stats["fetches"],
         per_shard=ss.per_shard, device=str(ss.graph_buf.device))
dist.destroy_process_group()
"""


def _run_ranks(tmp: str, backend: str, world: int, dev: str,
               iters: int) -> list:
    """Run ``world`` ranks of ``SHARD_RANK``; their result files.  A rank
    that exits without its file fails the phase."""
    procs = [subprocess.Popen(
        [sys.executable, "-c", SHARD_RANK, str(ROOT / "src"), backend,
         str(world), str(r), dev, tmp, str(iters)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for r, (p, err) in enumerate(zip(procs, errs)):
        path = Path(tmp) / f"{backend}_{dev}_rank{r}.npz"
        if not path.exists():
            raise AssertionError(f"16 {backend} rank {r} exited "
                                 f"{p.returncode}: {err[-2000:]}")
        out.append(dict(np.load(path)))
    return out


def phase_sharded_store(store, ids, device, *, world: int,
                        iters: int) -> None:
    """Phase 16: ``core.distributed.ShardedStore`` over phase 3's store,
    fetching ``ids`` (phase 5's first round of spans): ``world`` ranks,
    each its own process on the one card, in a gloo group over CUDA
    tensors (NCCL puts no two ranks on one device), then one rank in an
    NCCL group (on the CPU: the gloo ranks alone, over CPU tensors).
    Every rank's fetch must be bit-equal to ``store.graph_buf[ids]`` and
    ``store.vec_buf[ids]``, with one collective a fetch; a rank that
    raises fails the phase (nothing reruns on CPU tensors)."""
    want_g = store.graph_buf[ids]
    want_v = store.vec_buf[ids].view(np.int32)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ss_") as tmp:
        np.savez(f"{tmp}/store.npz", graph_buf=store.graph_buf,
                 vec_buf=store.vec_buf, meta_table=store.meta_table,
                 n_base=store.n_base, ids=ids,
                 **{f"spec_{f}": int(getattr(store.spec, f))
                    for f in SPEC_FIELDS})
        on_card = device.type == "cuda"
        for backend, n in (("gloo", world), ("nccl", 1))[:1 + on_card]:
            t0 = time.perf_counter()
            res = _run_ranks(tmp, backend, n, device.type, iters)
            for r, got in enumerate(res):
                if not (np.array_equal(got["g"], want_g) and np.array_equal(
                        got["v"].view(np.int32), want_v)):
                    raise AssertionError(f"16 {backend} rank {r}: fetch not "
                                         f"bit-equal to the store's rows")
                if float(got["calls"]) != 1.0:
                    raise AssertionError(f"16 {backend} rank {r}: "
                                         f"{got['calls']} collectives a fetch")
            ms = [float(r["ms"]) for r in res]
            log(f"[16 sharded store] {backend}, {n} rank(s) on "
                f"{res[0]['device']}: {len(ids)} blocks a fetch "
                f"({float(res[0]['bytes']) / 1e6:.3f} MB all-reduce operand, "
                f"{int(res[0]['per_shard'])} blocks a shard), one "
                f"collective a fetch, bit-equal to the store's rows on every"
                f" rank | ms a fetch (host clock, {iters} fetches, each rank)"
                f" {[f'{m:.4f}' for m in ms]} | {time.perf_counter() - t0:.1f}"
                f" s with the ranks' start")


# ------------------------------------------------------------ training (17)

def _train_batch(cfg, seed: int, *, batch: int, seq: int) -> dict:
    """Seeded numpy inputs of a train step (the CPU tests' kind): tokens,
    labels (three ``ignore_id``), frames or patches."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(
               np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(
               np.int32)}
    out["labels"][0, :3] = -1
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (batch, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def _on(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


class UpdateClock:
    """While active, the host seconds of every ``adamw.update`` call
    (synchronized before and after on the card): the optimizer's share
    of a step."""

    def __init__(self, device):
        self.device, self.s = device, []

    def __enter__(self):
        self.real = ADAMW.update

        def timed(*a, **k):
            _sync(self.device)
            t0 = time.perf_counter()
            out = self.real(*a, **k)
            _sync(self.device)
            self.s.append(time.perf_counter() - t0)
            return out
        ADAMW.update = timed
        return self

    def __exit__(self, *exc):
        ADAMW.update = self.real


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def train_split(cfg, device, *, batch: int, seq: int,
                micro_steps: int) -> dict:
    """Seconds a step of 17a spends in the flash attention (each layer of
    each micro-step: the forward, its recompute and the backward) and in
    the chunked CE (its forward, each chunk's recompute and the
    backward), each timed alone at the step's shapes (CUDA events, after
    a warm-up)."""
    dt = PR.compute_dtype(cfg)
    gen = torch.Generator(device=device).manual_seed(SEED)
    B = batch // micro_steps

    def rand(*shape, dtype=dt):
        return torch.randn(shape, generator=gen, device=device).to(
            dtype).requires_grad_()
    hd, H, K = cfg.the_head_dim(), cfg.n_heads, cfg.n_kv_heads
    q, k, v = rand(B, seq, H, hd), rand(B, seq, K, hd), rand(B, seq, K, hd)
    do = torch.randn(q.shape, generator=gen, device=device).to(dt)

    def fwd():
        FL.flash_attention(q, k, v)

    def fwd_bwd():
        FL.flash_attention(q, k, v).backward(do)
    x = rand(B, seq, cfg.d_model)
    w = rand(cfg.d_model, cfg.vocab_size, dtype=torch.float32)
    labels = torch.randint(0, cfg.vocab_size, (B, seq), generator=gen,
                           device=device)

    def ce():
        LY.chunked_cross_entropy(x, w, labels).backward()
    layer_ms = device_ms(fwd, 2) + device_ms(fwd_bwd, 2)
    return {"flash_s": cfg.n_layers * micro_steps * layer_ms / 1e3,
            "ce_s": micro_steps * device_ms(ce, 2) / 1e3}


def phase_train(device, smi: str, *, arch: str, n_layers: int, seq: int,
                batch: int, micro_steps: int, steps: int) -> dict:
    """Phase 17a, the main path: ``make_train_step`` on ``arch`` at full
    width cut to ``n_layers`` (bf16 compute over f32 masters drawn from
    a seeded generator on the card), ``token_stream`` batches of
    ``batch`` x ``seq`` in ``micro_steps`` micro-steps: one warm-up step,
    then ``steps`` timed (host clock ended by a sync).  Every launch
    count is set to 0 before and read after: training reaches none of
    the four kernels.  Fails on a non-finite loss or a first loss more
    than 1.0 from ln V."""
    cfg = get_config(arch).replace(n_layers=n_layers)
    shape = InputShape("train_4k", seq, batch, "train")
    on_card = device.type == "cuda"
    _free(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
        free = torch.cuda.mem_get_info(device)[0]
    t0 = time.perf_counter()
    params = PR.init_params(LM.param_defs(cfg), torch.Generator(
        device=device).manual_seed(SEED))
    opt = ADAMW.init(params)
    state_gb = 4 * sum(t.numel() for t in TREE.leaves(params)) * 4 / 1e9
    step = TS.make_train_step(cfg, shape, micro_steps=micro_steps)
    stream = token_stream(cfg.vocab_size, batch, seq, seed=SEED)
    rows = []
    _reset_launches()
    with UpdateClock(device) as upd:
        for i in range(1 + steps):
            b = _on(next(stream), device)
            _sync(device)
            t = time.perf_counter()
            params, opt, m = step(params, opt, b)
            _sync(device)
            dt = time.perf_counter() - t
            vals = {k: float(v) for k, v in m.items()}
            if not all(np.isfinite(v) for v in vals.values()):
                raise AssertionError(f"17a step {i}: {vals}")
            rows.append((dt, vals))
    launches = _launches()
    if any(launches.values()):
        raise AssertionError(f"17a: the training path launched {launches}")
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    split = (train_split(cfg, device, batch=batch, seq=seq,
                         micro_steps=micro_steps) if on_card else None)
    first, lnv = rows[0][1]["loss"], float(np.log(cfg.vocab_size))
    if abs(first - lnv) > 1.0:
        raise AssertionError(f"17a: first loss {first} vs ln V {lnv}")
    timed = [dt for dt, _ in rows[1:]]
    step_s = float(np.mean(timed))
    tokens = batch * seq
    flops = LM.model_flops(cfg, shape)
    for i, (dt, v) in enumerate(rows):
        log(f"[17a train] step {i}{' (warm-up)' if i == 0 else ''}: loss "
            f"{v['loss']:.6f} grad_norm {v['grad_norm']:.6f} lr "
            f"{v['lr']:.6g} | {dt:.4f} s (adamw {upd.s[i]:.4f} s)")
    out = {"step_s": step_s, "tokens_s": tokens / step_s,
           "flop_share": flops / step_s / PEAK_BF16_FLOPS_S,
           "peak_gb": peak / 1e9, "first_loss": first}
    log(f"[17a train] {cfg.name} full width, {n_layers} layers, "
        f"{cfg.param_count() / 1e9:.4f} B params, f32 masters + grads + "
        f"m + v {state_gb:.2f} GB; batch {batch} x {seq} in {micro_steps} "
        f"micro-steps (flash at S={seq}, chunked CE in {seq // 512} "
        f"chunks): {step_s:.4f} s a step (steps {[f'{t:.4f}' for t in timed]}"
        f"), {out['tokens_s']:.1f} tokens/s, model FLOPs {flops:.4g} a step "
        f"= {out['flop_share']:.4f} of the bf16 dense peak (bound "
        f"{flops / PEAK_BF16_FLOPS_S:.4f} s); first loss {first:.4f} (ln V "
        f"{lnv:.4f}); peak allocated {out['peak_gb']:.2f} GB"
        + (f" of {free / 1e9:.1f} GB free" if on_card else "")
        + f"; adamw {np.mean(upd.s[1:]):.4f} s a step; launches {launches}"
        f" | {smi} | {time.perf_counter() - t0:.1f} s")
    if split:
        rest = step_s - split["flash_s"] - split["ce_s"] - np.mean(upd.s[1:])
        out.update(split)
        log(f"[17a split] a step's flash attention {split['flash_s']:.4f} s"
            f" ({split['flash_s'] / step_s:.3f} of the step: forward, "
            f"recompute and backward of {n_layers} layers x {micro_steps} "
            f"micro-steps, f32 in plain torch), chunked CE "
            f"{split['ce_s']:.4f} s ({split['ce_s'] / step_s:.3f}), adamw "
            f"{np.mean(upd.s[1:]):.4f} s, the rest (bf16 products, norms, "
            f"rope, remat's recompute of them) {rest:.4f} s "
            f"({rest / step_s:.3f}); each timed alone (CUDA events)")
    del params, opt, step
    _free(device)
    return out


def _close(a, b, what: str, *, lrs: float = 0.0) -> None:
    """``b`` against ``a`` at the CPU tests' tolerance: ``F32_TRAIN`` of
    the leaf's largest magnitude, or ``ADAM_STEP_TOL`` of the learning
    rates ``lrs`` applied (a param)."""
    a, b = (t.detach().cpu().float().numpy() for t in (a, b))
    tol = max(F32_TRAIN * float(np.abs(a).max()), ADAM_STEP_TOL * lrs)
    if not np.abs(a - b).max() <= tol:
        raise AssertionError(f"17 {what}: differ by "
                             f"{np.abs(a - b).max():.3g} (tolerance "
                             f"{tol:.3g})")


def phase_train_families(device, *, batch: int, seq: int) -> dict:
    """Phase 17b: each family's smoke config in f32, the card against the
    CPU from the same weights (drawn on the CPU, copied): two steps of
    ``make_train_step``, the second with ``micro_steps = 2``; loss, aux,
    grad_norm and lr each step, then every param, m and sqrt(v).  Returns
    the card's states (for 17d)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for f32 products")
    cpu = torch.device("cpu")
    states = {}
    for arch in TRAIN_FAMILIES:
        t0 = time.perf_counter()
        cfg = smoke_config(arch).replace(dtype="float32")
        shape = InputShape("smoke", seq, batch, "train")
        host = PR.init_params(LM.param_defs(cfg),
                              torch.Generator().manual_seed(SEED))
        sides = [(dev, TREE.tree_map(lambda t: t.to(dev, copy=True), host))
                 for dev in (device, cpu)]
        sides = [(dev, p, ADAMW.init(p)) for dev, p in sides]
        lrs, errs = 0.0, []
        for n, seed in ((1, 1), (2, 2)):
            step = TS.make_train_step(cfg, shape, micro_steps=n)
            b = _train_batch(cfg, seed, batch=batch, seq=seq)
            ms = []
            for i, (dev, p, o) in enumerate(sides):
                p, o, m = step(p, o, _on(b, dev))
                sides[i] = (dev, p, o)
                ms.append({k: float(v) for k, v in m.items()})
            for k in ms[0]:
                err = abs(ms[0][k] - ms[1][k]) / max(abs(ms[0][k]), 1.0)
                errs.append(err)
                if err > F32_TRAIN:
                    raise AssertionError(f"17b {arch} {k}: card {ms[0][k]} "
                                         f"CPU {ms[1][k]}")
            lrs += ms[0]["lr"]
        (_, pa, oa), (_, pb, ob) = sides
        for a, b in zip(TREE.leaves(pa), TREE.leaves(pb)):
            _close(a, b, f"{arch} param", lrs=lrs)
        for a, b in zip(TREE.leaves(oa.m), TREE.leaves(ob.m)):
            _close(a, b, f"{arch} m")
        for a, b in zip(TREE.leaves(oa.v), TREE.leaves(ob.v)):
            _close(a.sqrt(), b.sqrt(), f"{arch} sqrt(v)")
        states[arch] = (cfg, pa, oa)
        log(f"[17b train card vs cpu] {arch} smoke f32: 2 steps (micro 1, "
            f"2); metrics within {max(errs):.3g} relative; "
            f"{len(TREE.leaves(pa))} params, their m and sqrt(v) within the "
            f"CPU tests' tolerance; loss {ms[0]['loss']:.6f} | "
            f"{time.perf_counter() - t0:.1f} s")
    return states


def phase_train_converge(device, *, batch: int, seq: int) -> None:
    """Phase 17c: the twin of ``tests/test_train.py::test_loss_decreases``
    through the port's ``fit`` on the card."""
    t0 = time.perf_counter()
    cfg = smoke_config(TRAIN_ARCH)
    b = next(token_stream(cfg.vocab_size, batch, seq, seed=SEED))
    rep = fit(cfg, InputShape("tiny", seq, batch, "train"),
              iter(lambda: b, None), 30, log_every=0, device=device)
    first, last = np.mean(rep.losses[:5]), np.mean(rep.losses[-5:])
    if not last < first - 0.2:
        raise AssertionError(f"17c: loss {first} -> {last}")
    log(f"[17c converge] {cfg.name} smoke, one batch, 30 steps: mean loss "
        f"of the first 5 {first:.4f}, of the last 5 {last:.4f} | "
        f"{time.perf_counter() - t0:.1f} s")


def phase_train_restarts(device, states: dict, *, batch: int,
                         seq: int) -> None:
    """Phase 17d: 17b's card state through a checkpoint (bit-equal
    leaves on the card), then ``run_with_restarts`` of 10 train steps
    with failures injected before steps 3 and 7: 2 restores, and the
    final state equal to an uninterrupted run's at the CPU tests'
    tolerance (the largest difference printed: 0 when the card's step is
    deterministic)."""
    t0 = time.perf_counter()
    cfg, p, o = states[TRAIN_ARCH]
    shape = InputShape("smoke", seq, batch, "train")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        CKPT.save(tmp, 2, (p, o))
        (p2, o2), step = CKPT.restore(tmp, (p, o))
        pairs = list(zip(TREE.leaves((p, o)), TREE.leaves((p2, o2))))
        if step != 2 or not all(b.device == a.device and torch.equal(a, b)
                                for a, b in pairs):
            raise AssertionError("17d: the checkpoint did not round-trip")
    train = TS.make_train_step(cfg, shape)
    batches = [_on(_train_batch(cfg, 10 + i, batch=batch, seq=seq), device)
               for i in range(10)]

    def fresh():
        q = PR.init_params(LM.param_defs(cfg), torch.Generator(
            device=device).manual_seed(SEED))
        return q, ADAMW.init(q)

    def step_fn(state, i):
        if i in fail_at:
            fail_at.discard(i)
            raise RuntimeError(f"injected failure at {i}")
        return train(*state, batches[i])[:2]

    fail_at = set()
    want = fresh()
    for i in range(10):
        want = step_fn(want, i)
    fail_at = {3, 7}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_restart_") as tmp:
        got, rep = run_with_restarts(step_fn, fresh(), 10, ckpt_dir=tmp,
                                     ckpt_every=2)
    if rep.steps_done != 10 or rep.n_restores != 2 or int(got[1].step) != 10:
        raise AssertionError(f"17d: {rep}")
    lrs = float(sum(ADAMW.cosine_lr(torch.tensor(i + 1)) for i in range(10)))
    for a, b in zip(TREE.leaves(want[0]), TREE.leaves(got[0])):
        _close(a, b, "restarted vs uninterrupted param", lrs=lrs)
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(TREE.leaves(want), TREE.leaves(got)))
    log(f"[17d checkpoint] {len(pairs)} leaves bit-equal after a round "
        f"trip on the card; run_with_restarts: 10 steps, "
        f"{rep.n_failures} failures, {rep.n_restores} restores, final "
        f"state within the CPU tests' tolerance of an uninterrupted run "
        f"(largest difference {diff:.3g}) | "
        f"{time.perf_counter() - t0:.1f} s")


# one rank of phase 17e: argv = src dir, backend, world, rank, device, tmp;
# writes <backend>_rank<rank>.npz
COMPRESS_RANK = r"""
import sys, time
import numpy as np
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
from repro_torch.distributed.compression import (compressed_grad_reduce,
                                                 init_error_state)
_, _, backend, world, rank, dev, tmp = sys.argv
world, rank = int(world), int(rank)
dist.init_process_group(backend, init_method=f"file://{tmp}/rdv_{backend}",
                        world_size=world, rank=rank)
a = np.load(f"{tmp}/grads.npz")
g = {k: torch.as_tensor(a[k][rank], device=dev) for k in a.files}
err = init_error_state(g)
sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
ghat, err = compressed_grad_reduce(g, err)
sync()
t0 = time.perf_counter()
compressed_grad_reduce(g, err)
sync()
ms = (time.perf_counter() - t0) * 1e3
np.savez(f"{tmp}/{backend}_rank{rank}.npz", ms=ms,
         device=str(ghat["g0"].device),
         **{k: v.cpu().numpy() for k, v in ghat.items()})
dist.destroy_process_group()
"""


def phase_compression(device, *, world: int, shapes) -> None:
    """Phase 17e: ``compressed_grad_reduce`` over ``world`` gloo ranks
    (processes) on the one card's tensors, then 1 NCCL rank (on the CPU:
    the gloo ranks alone): the dequantized mean within ``COMPRESS_TOL``
    of the largest |f32 mean| on every rank."""
    rng = np.random.default_rng(SEED)
    grads = {f"g{i}": rng.standard_normal((world,) + shp).astype(np.float32)
             for i, shp in enumerate(shapes)}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cg_") as tmp:
        np.savez(f"{tmp}/grads.npz", **grads)
        on_card = device.type == "cuda"
        runs = [("gloo", world)] + ([("nccl", 1)] if on_card else [])
        t0 = time.perf_counter()
        procs = {(backend, r): subprocess.Popen(
            [sys.executable, "-c", COMPRESS_RANK, str(ROOT / "src"), backend,
             str(n), str(r), device.type, tmp], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
            for backend, n in runs for r in range(n)}
        errs = {}
        try:
            for key, p in procs.items():
                errs[key] = p.communicate(timeout=300)[1]
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for backend, n in runs:
            worst, ms = 0.0, []
            for r in range(n):
                path = Path(tmp) / f"{backend}_rank{r}.npz"
                if not path.exists():
                    raise AssertionError(
                        f"17e {backend} rank {r} exited "
                        f"{procs[(backend, r)].returncode}: "
                        f"{errs[(backend, r)][-2000:]}")
                got = np.load(path)
                ms.append(float(got["ms"]))
                for k, g in grads.items():
                    want = g[:n].mean(0)
                    err = float(np.abs(got[k] - want).max()
                                / np.abs(want).max())
                    worst = max(worst, err)
                    if err >= COMPRESS_TOL:
                        raise AssertionError(f"17e {backend} rank {r} {k}: "
                                             f"{err:.4f} of max |mean|")
            log(f"[17e compression] {backend}, {n} rank(s) on "
                f"{got['device']}: {len(grads)} leaves "
                f"({sum(int(np.prod(s)) for s in shapes)} values), the int8 "
                f"mean within {worst:.4f} of max |f32 mean| (bound "
                f"{COMPRESS_TOL}) | ms a reduce (host clock, each rank) "
                f"{[f'{m:.3f}' for m in ms]}")
        log(f"[17e] {time.perf_counter() - t0:.1f} s with the ranks' start")


def phase_training(device, smi: str) -> dict:
    """Phase 17: the training path and its checks (a)-(e).  Returns
    17a's numbers."""
    t17 = time.perf_counter()
    out = phase_train(device, smi, arch=TRAIN_ARCH, **TRAIN)
    states = phase_train_families(device, **TRAIN_SMOKE)
    phase_train_converge(device, **TRAIN_SMOKE)
    phase_train_restarts(device, states, **TRAIN_SMOKE)
    del states
    _free(device)
    phase_compression(device, **COMPRESS)
    _reset_launches()
    log(f"[17] {time.perf_counter() - t17:.1f} s")
    return out


# ------------------------------------------------------------- the mesh (19)

# one process of phase 19a: argv = src dir, archs, shapes; the dry runs of
# the cells on both production meshes and the d-HNSW variants on both and
# on a (1, 4) mesh (19e's), each a JSON line, all on the fake backend
MESH_DRYRUN = r"""
import json, logging, sys, time
sys.path.insert(0, sys.argv[1])
logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
    logging.ERROR)
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun as D, dryrun_dhnsw as H
from repro_torch.launch.mesh import fake_world
from repro_torch.models.params import AbstractMesh
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
for arch in sys.argv[2].split(","):
    for sid in sys.argv[3].split(","):
        for mp in (False, True):
            t = time.perf_counter()
            r = D.run_cell(arch, sid, mp)
            r["wall_s"] = time.perf_counter() - t
            r["specs"] = D.cell_specs(
                get_config(arch), SHAPES[sid],
                AbstractMesh(*MESHES["multi" if mp else "single"]),
                r["micro_steps"])
            print("CELL " + json.dumps(r), flush=True)
from repro_torch.models import transformer as TF
on = TF.seq_parallel
TF.seq_parallel = lambda shape, mesh: False
for arch in sys.argv[2].split(","):
    # a cell of one micro-step runs as f5882fe's did with it off
    if ("train_4k" in sys.argv[3].split(",")
            and D.MICRO_OVERRIDES.get((arch, "train_4k"), 1) > 1):
        for mp in (False, True):
            r = D.run_cell(arch, "train_4k", mp)
            print("NOSP " + json.dumps(r), flush=True)
TF.seq_parallel = on
for mp in (False, True):
    for v in H.VARIANTS:
        t = time.perf_counter()
        r = H.run(v, mp)
        r["wall_s"] = time.perf_counter() - t
        print("DHNSW " + json.dumps(r), flush=True)
fake_world(%(world)d)
mesh = init_device_mesh("cpu", (1, %(world)d), mesh_dim_names=("data", "model"))
for v in H.VARIANTS:
    print("DHNSW14 " + json.dumps({"variant": v, **H.count(mesh, v)}),
          flush=True)
"""

# one rank of phase 19d: argv = src dir, rank, tmp dir, data, model,
# iters, device, smoke (1: the smoke config), batch, seq, seed, dtype
# ("-": the config's), tag; writes moe_<tag>_rank<rank>.npz
MESH_MOE_RANK = r"""
import sys, time
import numpy as np
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
rank, tmp = int(sys.argv[2]), sys.argv[3]
data, model, iters = int(sys.argv[4]), int(sys.argv[5]), int(sys.argv[6])
dev, smoke = sys.argv[7], sys.argv[8] == "1"
batch, seq = int(sys.argv[9]), int(sys.argv[10])
seed, dtype, tag = int(sys.argv[11]), sys.argv[12], sys.argv[13]
if dev == "cuda":
    torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv_moe_{tag}",
                        world_size=data * model, rank=rank)
from torch.distributed.device_mesh import init_device_mesh
sys.path.insert(0, sys.argv[1] + "/..")
import chip_smoke as CS
from repro_torch.models import moe as MOE
from repro_torch.models.params import NamedSharding, P, local_part, param_shardings
mesh = init_device_mesh(dev, (data, model), mesh_dim_names=("data", "model"))
cfg, p, x = CS.moe_inputs(torch.device(dev), smoke, batch, seq, seed=seed,
                          dtype=None if dtype == "-" else dtype)
sh = param_shardings(MOE.moe_param_defs(cfg, (), ()), mesh)
loc = {k: local_part(v, sh[k]).contiguous() for k, v in p.items()}
del p
x = local_part(x, NamedSharding(mesh, P("data", None, None))).contiguous()
assert MOE.use_shardmap(cfg, mesh)
routes = []
real = MOE._route


def capture(*a):
    out = real(*a)
    routes.append(out[1])
    return out


with torch.no_grad():
    MOE._route = capture
    y, _ = MOE._moe_shardmap(cfg, loc, x, mesh)
    MOE._route = real
    CS._sync(x.device)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        MOE._moe_shardmap(cfg, loc, x, mesh)
    CS._sync(x.device)
ms = (time.perf_counter() - t0) / iters * 1e3
np.savez(f"{tmp}/moe_{tag}_rank{rank}.npz",
         y=y.float().cpu().numpy(), top_i=routes[0].cpu().numpy(), ms=ms,
         experts=loc["we_g"].shape[0], ff=loc["we_g"].shape[2])
dist.destroy_process_group()
"""

# one rank of phase 19e: argv = src dir, rank, tmp dir, world, iters,
# device, small (1: ``dhnsw_small``'s store); writes dhnsw_rank<rank>.npz
MESH_DHNSW_RANK = r"""
import sys, time
import numpy as np
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
rank, tmp = int(sys.argv[2]), sys.argv[3]
world, iters, dev = int(sys.argv[4]), int(sys.argv[5]), sys.argv[6]
if dev == "cuda":
    torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv_dhnsw",
                        world_size=world, rank=rank)
from torch.distributed.device_mesh import init_device_mesh
sys.path.insert(0, sys.argv[1] + "/..")
import chip_smoke as CS
if sys.argv[7] == "1":
    CS.dhnsw_small()
mesh = init_device_mesh(dev, (1, world), mesh_dim_names=("data", "model"))
out = CS.dhnsw_steps(mesh, torch.device(dev), iters)
np.savez(f"{tmp}/dhnsw_rank{rank}.npz", **out)
dist.destroy_process_group()
"""


# one rank of phase 19f: argv = src dir, rank, tmp dir, model ranks, runs
# (JSON: [tag, arch, depth, dtype, the unmeshed path's .npz]), device,
# smoke (1: smoke configs), geometry (JSON); writes
# fam<model>_rank<rank>.npz
MESH_FAMILY_RANK = r"""
import faulthandler, json, sys
faulthandler.enable()
import numpy as np
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
rank, tmp, model = int(sys.argv[2]), sys.argv[3], int(sys.argv[4])
runs, dev = json.loads(sys.argv[5]), sys.argv[6]
smoke, geom = sys.argv[7] == "1", json.loads(sys.argv[8])
if dev == "cuda":
    torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv_fam{model}",
                        world_size=model, rank=rank)
from torch.distributed.device_mesh import init_device_mesh
sys.path.insert(0, sys.argv[1] + "/..")
import chip_smoke as CS
mesh = init_device_mesh(dev, (1, model), mesh_dim_names=("data", "model"))
out = {}
for tag, arch, depth, dtype, want in runs:
    got = CS.family_meshed(mesh, torch.device(dev),
                           CS.family_config(arch, depth, smoke, dtype), want,
                           **geom)
    out.update({f"{tag} {arch}|{k}": v for k, v in got.items()})
    CS._free(torch.device(dev))
np.savez(f"{tmp}/fam{model}_rank{rank}.npz", **out)
dist.destroy_process_group()
"""


def _spawn(code: str, args_of, n: int, what: str, tmp: str,
           out_of) -> list:
    """Run ``n`` processes of ``code`` (argv: the src dir, then
    ``args_of(rank)``); each must leave ``out_of(rank)`` under ``tmp``.
    A process that exits without it fails the phase."""
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(ROOT / "src"), *map(str, args_of(r))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=600)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for r, (p, err) in enumerate(zip(procs, errs)):
        path = Path(tmp) / out_of(r)
        if not path.exists():
            raise AssertionError(f"{what} rank {r} exited {p.returncode}: "
                                 f"{err[-3000:]}")
        out.append(dict(np.load(path)))
    return out


def phase_mesh_dryrun() -> dict:
    """Phase 19a, host-only: ``launch/dryrun.py``'s cells and
    ``launch/dryrun_dhnsw.py``'s variants on the fake backend (one
    subprocess playing every rank; nothing on the card), held to the
    JAX package's numbers in ``benchmarks/torch_reference/dryrun.json``:
    every spec and per-device byte count of the cells, the decode cells'
    totals against the reference's compiled ``argument_size_bytes``, and
    the d-HNSW rows' collective operand and wire bytes.  Returns the
    (1, 4) mesh's d-HNSW counts for 19e."""
    t0 = time.perf_counter()
    archs, shapes = MESH_ARCHS, MESH_SHAPES
    out = subprocess.run(
        [sys.executable, "-c", MESH_DRYRUN % {"world": MESH_DHNSW["world"]},
         str(ROOT / "src"), ",".join(archs), ",".join(shapes)],
        capture_output=True, text=True, timeout=900)
    if out.returncode:
        raise AssertionError(f"19a dry run exited {out.returncode}: "
                             f"{out.stderr[-3000:]}")
    ref = torch_dryrun_reference.load()
    want_h = {(r["cell"], r["mesh"]): r for r in ref["dhnsw"]}
    n_cells, counts = 0, {}
    no_sp = {}          # this tree's train cells, sequence parallelism off
    for line in out.stdout.splitlines():
        if line.startswith("NOSP "):
            r = json.loads(line[5:])
            no_sp[f"{r['arch']}|{r['shape']}|{r['mesh']}"] = (
                r["memory"]["working_set_bytes"],
                r["collectives"]["wire_bytes_per_device"])
    for line in out.stdout.splitlines():
        kind, _, body = line.partition(" ")
        if kind not in ("CELL", "DHNSW", "DHNSW14"):
            continue
        r = json.loads(body)
        if kind == "DHNSW14":
            counts[r["variant"]] = r
            continue
        if kind == "DHNSW":
            want = want_h[(r["cell"], r["mesh"])]
            bad = [k for k in torch_dryrun_reference.DHNSW_FIELDS
                   if r[k] != want[k]]
            if bad:
                raise AssertionError(f"19a {r['cell']} {r['mesh']}: {bad} "
                                     f"differ from the reference's")
            log(f"[19a dry run] {r['cell']} {r['mesh']}: all-reduce "
                f"operand {r['coll_kinds']} B, wire {r['wire_dev']:.0f} B a "
                f"device, {r['n_collectives']} collective(s), args "
                f"{r['arg_bytes']} B (= the reference's); flops "
                f"{r['flops_dev']:.4g}, bytes {r['bytes_dev']:.4g}, "
                f"t_compute {r['t_compute']:.3g} s t_memory "
                f"{r['t_memory']:.3g} s t_collective {r['t_collective']:.3g}"
                f" s (H100 peaks), {r['dominant']} | traced in "
                f"{r['wall_s']:.2f} s")
            continue
        if r["status"] != "ok":
            raise AssertionError(f"19a {r['arch']} {r['shape']} {r['mesh']}:"
                                 f" {r.get('error', r['status'])}")
        key = f"{r['arch']}|{r['shape']}|{r['mesh']}"
        want = ref["cells"][key]
        mem = {k: r["memory"][k] for k in want["memory"]}
        if mem != want["memory"] or r["specs"] != want["specs"]:
            raise AssertionError(f"19a {key}: specs or bytes {mem} differ "
                                 f"from the reference's {want['memory']}")
        if ("compiled_argument_size_bytes" in want
                and mem["argument_size_bytes"]
                != want["compiled_argument_size_bytes"]):
            raise AssertionError(f"19a {key}: {mem['argument_size_bytes']} "
                                 f"argument bytes, the reference compiled "
                                 f"{want['compiled_argument_size_bytes']}")
        c = r["collectives"]
        ws, flops = r["memory"]["working_set_bytes"], r["cost"]["flops"]
        args = mem["argument_size_bytes"]
        if r["shape"].startswith("decode") and ws > 2 * args:
            raise AssertionError(f"19a {key}: working set {ws} B a device "
                                 f"> twice its {args} B of arguments")
        dense = get_config(r["arch"]).family == "dense"
        if (r["shape"].startswith("train") and dense
                and flops > 2 * r["model_flops"] / r["n_devices"]):
            raise AssertionError(f"19a {key}: {flops:.4g} FLOPs a device > "
                                 f"twice its model FLOPs")
        old = MESH_GATHERED.get(key)
        n_cells += 1
        sp_line = _sp_check(key, ws, c["wire_bytes_per_device"],
                            no_sp.get(key, MESH_NO_SP.get(key)))
        log(f"[19a dry run] {key}: {r['n_devices']} ranks, params "
            f"{mem['param_bytes']} opt {mem['opt_bytes']} cache "
            f"{mem['cache_bytes']} inputs {mem['input_bytes']} = "
            f"{mem['argument_size_bytes']} B a device (= the reference's"
            + (", = its compiled argument size" if
               "compiled_argument_size_bytes" in want else "")
            + f"; {len(r['specs'])} specs equal); working set "
            f"{r['memory']['working_set_bytes']:.6g} B a device (the "
            f"arguments + {r['memory']['peak_transient_bytes']:.6g} B at the "
            f"traced step's peak); flops {r['cost']['flops']:.4g}"
            f" a device (model FLOPs / devices "
            f"{r['model_flops'] / r['n_devices']:.4g}), collectives "
            f"{c['n_collectives']} ({ {k: f'{v:.4g}' for k, v in c['operand_bytes_by_kind'].items()} }"
            f" B), wire {c['wire_bytes_per_device']:.4g} B a device; "
            f"micro-steps {r['micro_steps']}; traced at units "
            f"{r['traced_units']['traced']} of {r['traced_units']['units']} "
            f"in {r['trace_s']} s ({r['wall_s']:.2f} s with the bytes)"
            + (f" | the gathering tree: working set {old[3]:.6g} B "
               f"({ws / old[3]:.4f} of it; {old[0]:.6g} B as its own counter "
               f"read it), flops {old[1]:.4g} ({flops / old[1]:.4f}), "
               f"collective operand {old[2]:.4g} B "
               f"({c['operand_bytes_total'] / old[2]:.4f})" if old else "")
            + sp_line)
    if n_cells != len(archs) * len(shapes) * 2 or len(counts) != 6:
        raise AssertionError(f"19a: {n_cells} cells, {len(counts)} (1, 4) "
                             f"counts")
    log(f"[19a] {n_cells} cells and 12 d-HNSW rows equal to the reference's "
        f"| host only (fake backend, FakeTensorMode) | "
        f"{time.perf_counter() - t0:.1f} s with the process's start")
    return counts


def _sp_check(key: str, ws: float, wire: float, off) -> str:
    """19a's reading of a cell against f5882fe's (``MESH_NO_SP``) and, for
    a train cell, against this tree's step with sequence parallelism off
    (``off``: working set, wire): the working set within
    ``SP_WORKING_SET`` and fallen from ``off``'s by at least
    ``SP_SAVED``, the wire between ``off``'s and ``SP_WIRE`` x it; any
    other cell's both equal to f5882fe's."""
    if key not in MESH_NO_SP:
        return ""
    ws0, wire0 = MESH_NO_SP[key]
    if key in SP_SAVED:
        ws1, wire1 = off
        if ws > SP_WORKING_SET[key] or ws1 - ws < SP_SAVED[key]:
            raise AssertionError(
                f"19a {key}: working set {ws:.6g} B a device, "
                f"{ws1:.6g} with sequence parallelism off: fallen by "
                f"{ws1 - ws:.6g}, the layer inputs' share "
                f"{SP_SAVED[key]:.6g}, bound {SP_WORKING_SET[key]:.6g}")
        if not wire1 <= wire <= SP_WIRE * wire1:
            raise AssertionError(f"19a {key}: wire {wire:.6g} B a device, "
                                 f"{wire1:.6g} with sequence parallelism "
                                 f"off (x{SP_WIRE} at most)")
        return (f" | sequence parallel: working set {ws:.6g} B a device, "
                f"{ws1:.6g} off (fallen by {ws1 - ws:.6g}, the layer "
                f"inputs' share {SP_SAVED[key]:.6g}; bound "
                f"{SP_WORKING_SET[key]:.6g}), f5882fe's {ws0:.6g}; wire "
                f"{wire:.6g} B, {wire1:.6g} off (x{wire / wire1:.4f}), "
                f"f5882fe's {wire0:.6g} (x{wire / wire0:.4f})")
    if (ws, wire) != (ws0, wire0):
        raise AssertionError(f"19a {key}: working set {ws} and wire {wire} "
                             f"B a device, f5882fe's {ws0} and {wire0}")
    return " | working set and wire equal to f5882fe's"


def _as_dtensor(t, mesh, sharding):
    """``t`` as the DTensor ``sharding`` places on a mesh of one rank,
    sharing its storage (the whole tensor is the rank's shard)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, mesh, sharding.placements, run_check=False)


def phase_mesh_train(device, mesh, smi: str, *, step_17a: float,
                     arch: str, n_layers: int, seq: int, batch: int,
                     micro_steps: int, steps: int) -> None:
    """Phase 19b: ``make_step`` of a train cell on ``mesh`` (the host
    mesh of one NCCL rank) at phase 17a's geometry, against the unmeshed
    step from the same seeded weights and batch: the loss, the metrics
    and every updated param and moment bit for bit; then s a step."""
    cfg = get_config(arch).replace(n_layers=n_layers)
    shape = InputShape("train_4k", seq, batch, "train")
    _free(device)
    stream = token_stream(cfg.vocab_size, batch, seq, seed=SEED)
    b = _on(next(stream), device)

    def fresh():
        p = PR.init_params(LM.param_defs(cfg), torch.Generator(
            device=device).manual_seed(SEED))
        return p, ADAMW.init(p)
    t0 = time.perf_counter()
    params, opt = fresh()
    step = TS.make_train_step(cfg, shape, micro_steps=micro_steps)
    _sync(device)
    t = time.perf_counter()
    params, opt, m = step(params, opt, b)
    _sync(device)
    plain_s = time.perf_counter() - t
    want_m = {k: float(v) for k, v in m.items()}
    want = [x.cpu() for x in TREE.leaves((params, opt))]
    del params, opt, step, m
    _free(device)
    step, (p_sh, o_sh, b_sh), _, _ = TS.make_step(cfg, shape, mesh,
                                                  micro_steps=micro_steps)
    params, opt = fresh()
    params = TREE.tree_map(lambda x, s: _as_dtensor(x, mesh, s), params, p_sh)
    opt = ADAMW.AdamWState(
        _as_dtensor(opt.step, mesh, o_sh.step),
        TREE.tree_map(lambda x, s: _as_dtensor(x, mesh, s), opt.m, o_sh.m),
        TREE.tree_map(lambda x, s: _as_dtensor(x, mesh, s), opt.v, o_sh.v))
    db = {k: _as_dtensor(v, mesh, b_sh[k]) for k, v in b.items()}
    _reset_launches()
    _sync(device)
    t = time.perf_counter()
    params, opt, m = step(params, opt, db)
    _sync(device)
    first_s = time.perf_counter() - t
    got_m = {k: float(v) for k, v in m.items()}
    if got_m != want_m:
        raise AssertionError(f"19b metrics {got_m} vs unmeshed {want_m}")
    leaves = [x.to_local() for x in TREE.leaves((params, opt))]
    diff = [i for i, (x, w) in enumerate(zip(leaves, want))
            if not torch.equal(x.cpu(), w)]
    if diff:
        raise AssertionError(f"19b: {len(diff)} of {len(want)} leaves "
                             f"differ from the unmeshed step's")
    del want
    times = []
    for _ in range(steps):
        db = {k: _as_dtensor(v, mesh, b_sh[k])
              for k, v in _on(next(stream), device).items()}
        _sync(device)
        t = time.perf_counter()
        params, opt, m = step(params, opt, db)
        _sync(device)
        times.append(time.perf_counter() - t)
        if not np.isfinite(float(m["loss"])):
            raise AssertionError(f"19b: loss {float(m['loss'])}")
    launches = _launches()
    log(f"[19b mesh train] make_step on the host mesh "
        f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} (1 "
        f"{dist.get_backend()} rank) at "
        f"17a's geometry ({cfg.name}, {n_layers} layers, {batch} x {seq} in "
        f"{micro_steps} micro-steps): loss {got_m['loss']:.6f} grad_norm "
        f"{got_m['grad_norm']:.6f}, metrics and all {len(leaves)} params and "
        f"moments after the step equal the unmeshed step's bit for bit | "
        f"{float(np.mean(times)):.4f} s a step meshed (steps "
        f"{[f'{x:.4f}' for x in times]}, the first {first_s:.4f} s) against "
        f"17a's {step_17a:.4f} s (the unmeshed first step here "
        f"{plain_s:.4f} s); launches {launches} | {smi} | "
        f"{time.perf_counter() - t0:.1f} s")
    del params, opt, step, leaves
    _free(device)


def phase_mesh_serve(device, mesh, *, arch: str, batch: int, seq: int,
                     steps: int) -> int:
    """Phase 19c: ``make_prefill_step`` and ``make_decode_step`` on
    ``mesh`` at ``arch``'s full width and depth in phase 9's geometry
    (``batch`` prompts of ``seq`` tokens, ``steps`` greedy decode
    steps), the serving weights (``serve_param_defs``: bf16) drawn from a
    seed, against ``model.prefill`` / ``model.decode_step`` unmeshed on
    the same tensors: every token equal.  Returns the meshed path's
    ``decode_attention`` launches (every layer of every decode step)."""
    cfg = get_config(arch)
    _free(device)
    t0 = time.perf_counter()
    params = PR.init_params(LM.serve_param_defs(cfg), torch.Generator(
        device=device).manual_seed(SEED))
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    toks = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                         device=device, dtype=torch.int32)
    total = seq + steps

    def at(i):
        return torch.full((batch,), seq + i, dtype=torch.int32, device=device)

    with torch.no_grad():
        _sync(device)
        t = time.perf_counter()
        logits, cache = LM.prefill(cfg, params, {"tokens": toks}, total)
        want = [logits[:, -1].argmax(-1).to(torch.int32)]
        for i in range(steps):
            logits, cache = LM.decode_step(cfg, params, cache, want[-1], at(i))
            want.append(logits.argmax(-1).to(torch.int32))
        _sync(device)
        plain_s = time.perf_counter() - t
        del cache, logits
        pre, (p_sh, b_sh), _, _ = TS.make_prefill_step(
            cfg, InputShape("prefill", seq, batch, "prefill"), mesh)
        dec, (_, c_sh, t_sh, q_sh), _, (_, c_abs, _, _) = \
            TS.make_decode_step(cfg, InputShape("decode", total, batch,
                                                "decode"), mesh)
        dparams = TREE.tree_map(lambda x, s: _as_dtensor(x, mesh, s), params,
                                p_sh)
        _reset_launches()
        _sync(device)
        t = time.perf_counter()
        logits, short = pre(dparams, {"tokens": _as_dtensor(
            toks, mesh, b_sh["tokens"])})
        cache = []
        for c, s, a in zip(short, c_sh, c_abs):   # into a cache of `total`
            full = torch.zeros(a.shape, dtype=a.dtype, device=device)
            full[:, :, :seq] = c.to_local()
            cache.append(_as_dtensor(full, mesh, s))
        del short
        got = [logits.to_local()[:, -1].argmax(-1).to(torch.int32)]
        t_pre = time.perf_counter() - t
        for i in range(steps):
            logits, cache = dec(dparams, tuple(cache),
                                _as_dtensor(got[-1], mesh, t_sh),
                                _as_dtensor(at(i), mesh, q_sh))
            got.append(logits.to_local().argmax(-1).to(torch.int32))
        _sync(device)
        mesh_s = time.perf_counter() - t
        launches = _launches()
    want, got = torch.stack(want, 1), torch.stack(got, 1)
    if not torch.equal(want, got):
        raise AssertionError(f"19c: {int((want != got).sum())} of "
                             f"{want.numel()} tokens differ from the "
                             f"unmeshed path's")
    want_da = cfg.n_layers * steps if device.type == "cuda" else 0
    if launches["decode_attention"] != want_da:
        raise AssertionError(f"19c: {launches['decode_attention']} "
                             f"decode_attention launches, {want_da} layers "
                             f"x steps")
    log(f"[19c mesh serve] make_prefill_step + make_decode_step on the host "
        f"mesh at {cfg.name} full width and depth ({cfg.n_layers} layers, "
        f"bf16 serving weights), {batch} prompts x {seq} tokens, {steps} "
        f"greedy steps: all {got.numel()} tokens equal to the unmeshed "
        f"model.prefill / decode_step's | meshed {mesh_s:.3f} s (prefill "
        f"{t_pre:.3f} s) vs unmeshed {plain_s:.3f} s; launches {launches} | "
        f"{time.perf_counter() - t0:.1f} s")
    del params, dparams, cache, logits
    _free(device)
    return launches["decode_attention"]


def moe_inputs(device, smoke: bool, batch: int, seq: int, *,
               seed: int = SEED, dtype=None) -> tuple:
    """Phase 19d's layer, the same in every process: qwen3-moe-30b-a3b's
    router and experts (f32, drawn from ``seed`` on ``device``; its smoke
    config with ``smoke``; its compute dtype ``dtype`` where given) and
    an input of ``batch`` x ``seq`` tokens in its compute dtype."""
    cfg = (smoke_config if smoke else get_config)(MOE_ARCH)
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    p = PR.init_params(MOE.moe_param_defs(cfg, (), ()), gen)
    x = torch.randn((batch, seq, cfg.d_model),
                    generator=gen, device=device).to(PR.compute_dtype(cfg))
    return cfg, p, x


def moe_plain(cfg, p, x, ep: int) -> tuple:
    """The expert-parallel layer written plainly, in one process: for each
    of ``ep`` ranks its experts' kept assignments (rank within the expert,
    in order of arrival, below the capacity of ``x``'s tokens), each
    expert's SwiGLU on its tokens in the compute dtype, the gated outputs
    summed in f32 into the rank's share, rounded to the compute dtype
    once.  -> (the shares (ep, *x.shape) f32, top_i)."""
    dt = x.dtype
    xf = x.reshape(-1, x.shape[-1])
    T, k, E = xf.shape[0], cfg.moe_top_k, cfg.n_experts
    probs = torch.softmax(xf.float() @ p["router"].float(), -1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :k], top_i[:, :k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    C = MOE._capacity(cfg, T, ep)
    fe, fp = top_i.reshape(-1), top_p.reshape(-1)
    ft = torch.arange(T, device=x.device).repeat_interleave(k)
    shares = []
    for r in range(ep):
        share = torch.zeros((T, xf.shape[1]), dtype=torch.float32,
                            device=x.device)
        for e in range(r * E // ep, (r + 1) * E // ep):
            sel = torch.nonzero(fe == e)[:, 0][:C]     # arrival order
            xs = xf[ft[sel]]
            h = torch.nn.functional.silu(xs @ p["we_g"][e].to(dt)) * (
                xs @ p["we_u"][e].to(dt))
            share.index_add_(0, ft[sel], ((h @ p["we_d"][e].to(dt))
                                          * fp[sel][:, None].to(dt)).float())
        shares.append(share.to(dt).float().reshape(x.shape))
    return torch.stack(shares), top_i


def phase_mesh_moe(device, *, batch: int, seq: int, iters: int,
                   runs) -> None:
    """Phase 19d: ``moe._moe_shardmap`` over 4 gloo rank processes on the
    one card (NCCL puts no two ranks on one card), on (data, model)
    meshes (1, 4) and (2, 2), at qwen3-moe-30b-a3b's width (d 2048, 128
    experts, expert_d_ff 768, top-8), one layer, ``batch`` x ``seq``
    tokens in bf16; then on (1, 4) with a second seed, and with the
    layer in f32.  Each rank's routing equal to a plain version's in
    this process, which runs each rank's share and sums them, and its y
    within, in bf16, the rounding of a sum of the ranks' shares
    (element-wise ``MOE_TOL`` x the number of shares x the sum of their
    magnitudes), in f32 ``MOE_TOL_F32`` of the largest sum of the shares'
    magnitudes; ms a call on each rank."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_moe_") as tmp:
        for data, model, seed, dtype in runs:
            t = time.perf_counter()
            tag = f"{data}x{model}_s{seed}_{dtype or 'bf16'}"
            cfg, p, x = moe_inputs(device, MESH_SMOKE, batch, seq,
                                   seed=SEED + seed, dtype=dtype)
            f32 = x.dtype == torch.float32
            res = _spawn(MESH_MOE_RANK, lambda r: (
                r, tmp, data, model, iters, device.type, int(MESH_SMOKE),
                batch, seq, SEED + seed, dtype or "-", tag),
                         data * model, f"19d {tag}", tmp,
                         lambda r: f"moe_{tag}_rank{r}.npz")
            errs, rel, mag = [], [], []
            for r, got in enumerate(res):
                d = r // model
                xs = x[d * batch // data:(d + 1) * batch // data]
                with torch.no_grad():
                    shares, top_i = moe_plain(cfg, p, xs, model)
                if not np.array_equal(got["top_i"], top_i.cpu().numpy()):
                    raise AssertionError(f"19d {tag} rank {r}: routing "
                                         f"differs from the plain version's")
                want = shares.sum(0).cpu().numpy()
                # bf16: the rounding of the sum of `model` shares (each
                # rounded once, then model - 1 additions), element-wise
                absum = shares.abs().sum(0).cpu().numpy()
                bound = (np.full_like(absum, MOE_TOL_F32 * absum.max()) if f32
                         else MOE_TOL * model * absum)
                err = np.abs(got["y"] - want)
                if not (err <= bound).all():
                    i = int(np.argmax(err - bound))
                    raise AssertionError(
                        f"19d {tag} rank {r}: y differs by "
                        f"{err.flat[i]:.4g} at an element whose bound is "
                        f"{bound.flat[i]:.4g}")
                errs.append(float((err / np.maximum(bound, 1e-30)).max()))
                rel.append(float(err.max() / np.abs(want).max()))
                mag.append(float((err / np.maximum(absum, 1e-30)).max()))
            log(f"[19d moe shardmap] mesh (data, model) = ({data}, {model}) "
                f"over {data * model} gloo ranks on the card, seed "
                f"SEED+{seed}, {x.dtype}: "
                f"{int(res[0]['experts'])} experts x ff "
                f"{int(res[0]['ff'])} on each rank (E/ep, ff gathered over "
                f"data in bf16), {batch // data} x {seq} tokens a rank; "
                f"routing equal to the plain version's, y within "
                f"{max(errs):.3g} of its bound ("
                + (f"{MOE_TOL_F32:.4g} x the largest sum of the shares' "
                   f"magnitudes" if f32 else f"element-wise {model} x "
                   f"{MOE_TOL:.4g} x the sum of the shares' magnitudes")
                + f"), max |diff| {max(mag):.3g} of the element's sum of "
                f"the shares' magnitudes, {max(rel):.3g} of max |y| | ms a "
                f"call (host clock, {iters} calls, each rank) "
                f"{[f'{float(g['ms']):.2f}' for g in res]} | "
                f"{time.perf_counter() - t:.1f} s with the ranks' start")
            del p, x
            _free(device)
    log(f"[19d] {time.perf_counter() - t0:.1f} s")


def dhnsw_inputs(device, variant: str, tp: int, dp: int = 1) -> dict:
    """Phase 19e's full-size arguments of ``variant`` (the same in every
    process): the SIFT1M-geometry store (``dryrun_dhnsw.N_BLOCKS`` blocks
    of ``VBLK`` values in [-1, 1), f32 or its int8 codes, zero-padded to
    the variant's block count on a mesh of ``tp`` model ranks), one
    doorbell batch of ``M_FETCH`` spans of random
    partitions, its pairs' queries, slots and validity."""
    H = dryrun_dhnsw
    gen = torch.Generator(device=device).manual_seed(SEED)
    n_blocks = H.geometry(PR.AbstractMesh((tp,), ("model",)), variant)[0]
    vec = torch.zeros((n_blocks, H.VBLK), dtype=torch.float32, device=device)
    vec[:H.N_BLOCKS] = torch.rand((H.N_BLOCKS, H.VBLK), generator=gen,
                                  device=device) * 2 - 1
    parts = torch.randint(0, H.N_PARTS, (dp, H.M_FETCH), generator=gen,
                          device=device)
    starts = (parts // 2) * H.GROUP_BLOCKS + (parts % 2) * H.DATA_BLOCKS
    ids = (starts[..., None] + torch.arange(H.FETCH_BLOCKS, device=device)
           ).reshape(dp, -1).to(torch.int32)
    q = torch.rand((dp, H.PAIRS, H.DIM), generator=gen, device=device) * 2 - 1
    slot = torch.randint(0, H.M_FETCH, (dp, H.PAIRS), generator=gen,
                         device=device, dtype=torch.int32)
    valid = torch.rand((dp, H.PAIRS), generator=gen, device=device) < 0.9
    if variant in ("int8_rest", "span_dma", "bf16_serve"):
        vec = torch.clamp(torch.round(vec * 127), -127, 127).to(torch.int8)
    if variant == "baseline":
        ids, q, slot, valid = ids[0], q[0], slot[0], valid[0]
    return {"vec": vec, "ids": ids, "q": q, "slot": slot, "valid": valid}


def dhnsw_steps(mesh, device, iters: int) -> dict:
    """Every d-HNSW variant's step on ``mesh`` over phase 19e's inputs:
    each one's top-k ids and distances (this rank's), the collectives it
    ran (counted by ``dryrun.CollectiveCounter``) and ms a step."""
    from repro_torch.core.mesh import CollectiveCounter, axis_size
    out = {}
    for v in dryrun_dhnsw.VARIANTS:
        step, _, in_sh, _ = dryrun_dhnsw.make_step(mesh, v)
        a = dhnsw_inputs(device, v, axis_size(mesh, "model"))
        args = [PR.shard_tensor(a[k], s) for k, s in zip(
            ("vec", "ids", "q", "slot", "valid"), in_sh)]
        del a
        with CollectiveCounter() as cc:
            d, i = step(*args)
        _sync(device)
        t = time.perf_counter()
        for _ in range(iters):
            step(*args)
        _sync(device)
        c = cc.summary()
        out[f"{v}_ids"] = i.to_local().cpu().numpy()
        out[f"{v}_d"] = d.to_local().cpu().numpy()
        out[f"{v}_ms"] = (time.perf_counter() - t) / iters * 1e3
        out[f"{v}_operand"] = c["operand_bytes_total"]
        out[f"{v}_n"] = c["n_collectives"]
        del args
    return out


def dhnsw_small() -> None:
    """The d-HNSW store cut to 4 groups (8 partitions) for a CPU run of
    19e (``MESH_SMOKE``); the fetch and serve shapes stay."""
    dryrun_dhnsw.N_PARTS = 8
    dryrun_dhnsw.N_BLOCKS = 4 * dryrun_dhnsw.GROUP_BLOCKS


def _ids_tie_equal(ids, d, ref_ids, ref_d) -> bool:
    """Top-k ids equal to the reference's, or differing only where the
    two distances tie (within 1e-6 relative)."""
    with np.errstate(invalid="ignore"):             # inf - inf
        tie = (d == ref_d) | (np.abs(d - ref_d)
                              <= 1e-6 * np.abs(ref_d) + 1e-12)
    return bool(np.all((ids == ref_ids) | tie))


def phase_mesh_dhnsw(device, mesh1, counts: dict, *, world: int,
                     iters: int) -> None:
    """Phase 19e: ``dryrun_dhnsw.make_step`` run for real: the SIFT1M
    geometry's store (721 MB in f32, 180 MB in int8) over ``world`` gloo
    rank processes on the card, a (1, ``world``) mesh, all six variants:
    each rank's top-k ids equal to this process's run on ``mesh1`` (one
    rank) up to ties, and the all-reduce operand bytes each step counted
    equal to the port's dry run of the same mesh (``counts``, 19a)."""
    t0 = time.perf_counter()
    if MESH_SMOKE:
        dhnsw_small()
    one = dhnsw_steps(mesh1, device, iters)
    _free(device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dhnsw_") as tmp:
        res = _spawn(MESH_DHNSW_RANK, lambda r: (
            r, tmp, world, iters, device.type, int(MESH_SMOKE)), world,
            "19e", tmp, lambda r: f"dhnsw_rank{r}.npz")
    for v in dryrun_dhnsw.VARIANTS:
        want = counts[v]["collectives"]
        for r, got in enumerate(res):
            if not _ids_tie_equal(got[f"{v}_ids"], got[f"{v}_d"],
                                  one[f"{v}_ids"], one[f"{v}_d"]):
                raise AssertionError(f"19e {v} rank {r}: top-k ids differ "
                                     f"from the one-rank run's")
            if (float(got[f"{v}_operand"]) != want["operand_bytes_total"]
                    or int(got[f"{v}_n"]) != want["n_collectives"]):
                raise AssertionError(
                    f"19e {v} rank {r}: {float(got[f'{v}_operand'])} B in "
                    f"{int(got[f'{v}_n'])} collective(s), the dry run "
                    f"{want['operand_bytes_total']} B in "
                    f"{want['n_collectives']}")
        log(f"[19e d-HNSW step] {v} on a (1, {world}) mesh of gloo ranks on "
            f"the card: top-k ids equal to the one-rank run's; "
            f"{int(res[0][f'{v}_n'])} all-reduce of "
            f"{float(res[0][f'{v}_operand']):.0f} B a step (= the dry "
            f"run's) | ms a step (host clock, {iters} steps) each rank "
            f"{[f'{float(g[f'{v}_ms']):.3f}' for g in res]}, one rank "
            f"{one[f'{v}_ms']:.3f}")
    log(f"[19e] {time.perf_counter() - t0:.1f} s with the ranks' start")


def family_config(arch: str, depth, smoke: bool, dtype=None):
    """19f's configuration of ``arch``: full width (the smoke config's
    with ``smoke``), ``depth`` layers and compute ``dtype`` where given."""
    cfg = (smoke_config if smoke else get_config)(arch)
    if depth is not None:
        cfg = cfg.replace(n_layers=depth)
    return cfg if dtype is None else cfg.replace(dtype=dtype)


def family_inputs(cfg, device, batch: int, seq: int) -> dict:
    """19f's prompts (and whisper's frames), drawn from a seed on
    ``device``: the same in every process."""
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq),
                                   generator=gen, device=device,
                                   dtype=torch.int32)}
    if cfg.family == "encdec":
        out["frames"] = torch.randn((batch, cfg.enc_seq, cfg.d_model),
                                    generator=gen, device=device)
    return out


def family_unmeshed(cfg, device, *, batch: int, seq: int,
                    steps: int) -> dict:
    """19f's unmeshed path on the card: the serving weights drawn from
    ``SEED`` (``serve_param_defs``: bf16), ``model.prefill`` into a cache
    of seq + steps and ``steps`` greedy ``decode_step``s.  Returns the
    tokens (B, steps + 1), every step's logits (B, steps + 1, V) f32 on
    the host, each step's top-2 logit gap a row, ms a decode step, and in
    bf16 ``eps``: the first logits' largest distance from the same path
    in f32 (the weights' values cast up, f32 compute): its own bf16
    rounding."""
    total = seq + steps
    params = PR.init_params(LM.serve_param_defs(cfg), torch.Generator(
        device=device).manual_seed(SEED))
    inputs = family_inputs(cfg, device, batch, seq)
    toks, gaps, every, ms = [], [], [], []
    with torch.no_grad():
        logits, cache = LM.prefill(cfg, params, inputs, total)
        logits = logits[:, -1]
        for i in range(steps + 1):
            every.append(logits.float().cpu())
            top2 = torch.topk(logits.float(), 2, dim=-1).values
            gaps.append((top2[:, 0] - top2[:, 1]).cpu())
            toks.append(logits.argmax(-1).to(torch.int32))
            if i == steps:
                break
            pos = torch.full((batch,), seq + i, dtype=torch.int32,
                             device=device)
            _sync(device)
            t = time.perf_counter()
            logits, cache = LM.decode_step(cfg, params, cache, toks[-1], pos)
            _sync(device)
            ms.append((time.perf_counter() - t) * 1e3)
        del cache
        eps = None
        if cfg.dtype == "bfloat16":
            c32 = cfg.replace(dtype="float32")
            p32 = TREE.tree_map(lambda t: t.float(), params)
            del params
            f32 = LM.prefill(c32, p32, inputs, total)[0][:, -1]
            eps = float((every[0] - f32.cpu()).abs().max())
            del p32, f32
    return {"tokens": torch.stack(toks, 1).cpu().numpy(),
            "logits": torch.stack(every, 1).numpy(),
            "gaps": torch.stack(gaps, 1).numpy(), "ms": ms, "eps": eps}


def _placed_params(defs, shardings, device) -> dict:
    """``init_params(defs, SEED)``'s values, drawn leaf by leaf in its
    order on ``device``, each leaf kept as this rank's shard (a DTensor
    placed by ``shardings``): no rank holds the whole model."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    out: dict = {}
    for path, d in PR._leaves(defs):
        sh = shardings
        for key in path:
            sh = sh[key]
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = PR.shard_tensor(PR.init_leaf(d, gen), sh)
    return out


def _grow_cache(c, sh, shape, seq: int, mesh):
    """A prefill's cache tensor ``c`` (a DTensor over ``seq`` positions)
    as the decode's of ``shape`` placed by ``sh``: sequence shards
    gathered over ``model`` (the list form of all-gather, which gloo runs
    on CUDA tensors), zeros past the prompt, cut again."""
    from torch.distributed.tensor import DTensor
    loc = c.to_local()
    m = list(mesh.mesh_dim_names).index("model")
    if c.placements[m].is_shard(2):
        parts = [torch.empty_like(loc) for _ in range(mesh.size(m))]
        dist.all_gather(parts, loc.contiguous(), group=mesh.get_group(m))
        loc = torch.cat(parts, 2)
    grown = loc.new_zeros(loc.shape[:2] + (shape[2],) + loc.shape[3:])
    grown[:, :, :seq] = loc
    if "model" in sh.spec and sh.spec.index("model") == 2:
        n = shape[2] // mesh.size(m)
        grown = grown[:, :, mesh.get_local_rank("model") * n:][:, :, :n]
    return DTensor.from_local(grown.contiguous(), mesh, sh.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=PR.contiguous_stride(shape))


def _partial_check(q, k, v, n, device) -> dict:
    """``decode_attention``'s partial mode against its plain version on a
    shard's captured inputs and with every other row's shard emptied
    (count 0: a zero row and lse -inf): out at ``F32_TOL`` (f32 rows both
    ways), lse within 1e-5; on the card timed beside the plain version
    and SDPA at the shard's shape, and its bytes bound."""
    def check(n):
        o, lse = DA.decode_attention(q, k, v, n, partial=True)
        wo, wl = decode_attention_ref(q, k, v, n, partial=True)
        fin = torch.isfinite(wl)
        if not (torch.allclose(o, wo, **F32_TOL)
                and torch.equal(torch.isneginf(lse), torch.isneginf(wl))
                and torch.allclose(lse[fin], wl[fin], atol=1e-5, rtol=0)
                and not o[n == 0].any()):
            raise AssertionError("19f decode_attention partial mode != "
                                 "its plain version")
        return float((o - wo).abs().max())
    empty = n.clone()
    empty[::2] = 0
    out = {"err": max(check(n), check(empty)), "shape": list(q.shape)
           + list(k.shape[1:]), "counts": n.tolist()}
    if device.type == "cuda":
        B, H, hd = q.shape
        S, K = k.shape[1], k.shape[2]
        valid = int(n.clamp(0, S).sum())
        out["bound_ms"] = (2 * valid * K * hd * k.element_size()
                           + q.numel() * q.element_size()
                           + 4 * q.numel() + 4 * B * H + 4 * B) \
            / PEAK_BYTES_S * 1e3
        out["ms"] = device_ms(lambda: DA.decode_attention(
            q, k, v, n, partial=True), 20)
        out["plain_ms"] = device_ms(lambda: decode_attention_ref(
            q, k, v, n, partial=True), 3)
        mask = (torch.arange(S, device=device)[None, :]
                < n[:, None])[:, None, None, :]
        kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
        # SDPA at the shard's shape: a full row stands in for an empty one
        # (SDPA's softmax of a row with no key is not defined)
        mask = mask | (n[:, None, None, None] == 0)
        out["sdpa_ms"] = device_ms(lambda: _sdpa(q, kt, vt, mask), 5)
    return out


def family_meshed(mesh, device, cfg, want: str, *, batch: int, seq: int,
                  steps: int) -> dict:
    """One 19f rank's run: ``make_prefill_step`` then ``steps``
    ``make_decode_step``s on ``mesh``, the weights drawn as
    ``family_unmeshed`` draws them (each rank keeping its shards), each
    step fed the unmeshed path's token (``want``: an ``.npz`` of its
    tokens and logits), so that every step's logits answer the same
    question as the unmeshed path's.  The launch counts are set to 0
    before the prefill and read after the last step.  Returns each
    step's argmax and largest distance from the unmeshed logits a row
    (the logits gathered: the same on every rank), ms a decode step, the
    launches and the partial mode's (``ops.partial_launches``), and the
    partial mode's check at its first call's inputs where it ran."""
    total = seq + steps
    ref = np.load(want)
    ref_toks = torch.from_numpy(ref["tokens"]).to(device)
    pre, (p_sh, b_sh), _, _ = TS.make_prefill_step(
        cfg, InputShape("prefill", seq, batch, "prefill"), mesh)
    dec, (_, c_sh, t_sh, q_sh), _, (_, c_abs, _, _) = TS.make_decode_step(
        cfg, InputShape("decode", total, batch, "decode"), mesh)
    params = _placed_params(LM.serve_param_defs(cfg), p_sh, device)
    inputs = {k: PR.shard_tensor(v, b_sh[k])
              for k, v in family_inputs(cfg, device, batch, seq).items()}
    real, first = DA.decode_attention, []

    def spy(q, k, v, pos, **kw):    # keeps the first partial call's inputs
        if kw.get("partial") and not first:
            first.append(tuple(t.clone() for t in (q, k, v, pos)))
        return real(q, k, v, pos, **kw)
    DA.decode_attention = spy
    toks, errs, ms = [], [], []

    def seen(logits, i):       # logits: this rank's (B, V)
        got = logits.float().cpu()
        toks.append(got.argmax(-1).to(torch.int32))
        errs.append((got - torch.from_numpy(ref["logits"][:, i]))
                    .abs().amax(-1))
    try:
        with torch.no_grad():
            _reset_launches()
            logits, short = pre(params, inputs)
            # the sequence caches (seq long here, total in the decode's)
            # grow; the O(1) and cross-attention ones pass as they are
            cache = tuple(_grow_cache(c, sh, a.shape, seq, mesh)
                          if c.shape[2] == seq and a.shape[2] == total
                          else c for c, sh, a in zip(short, c_sh, c_abs))
            del short
            seen(logits.to_local()[:, -1], 0)
            for i in range(steps):
                pos = torch.full((batch,), seq + i, dtype=torch.int32,
                                 device=device)
                _sync(device)
                t = time.perf_counter()
                logits, cache = dec(params, cache,
                                    PR.shard_tensor(ref_toks[:, i], t_sh),
                                    PR.shard_tensor(pos, q_sh))
                _sync(device)
                ms.append((time.perf_counter() - t) * 1e3)
                seen(logits.to_local(), i + 1)
            launches, partial = _launches(), DA.partial_launches
    finally:
        DA.decode_attention = real
    out = {"tokens": torch.stack(toks, 1).numpy(),
           "errs": torch.stack(errs, 1).numpy(), "ms": np.asarray(ms),
           "da": launches["decode_attention"], "partial": partial}
    if first:
        for k, v in _partial_check(*first[0], device).items():
            out["pc_" + k] = np.asarray(v)
    return out


def family_bound(eps: float, tp: int) -> float:
    """19f's bound on a logit's distance between the meshed and the
    unmeshed path, stated before the first chip run: both are bf16
    roundings of one f32 computation, the unmeshed within ``eps`` of it
    (its f32 twin, measured); a row-parallel sum over ``tp`` ranks
    rounds each of the tp partial products to bf16 and adds them in
    bf16, 2 tp - 1 roundings where the unmeshed product rounds once, so
    the meshed path lies within (2 tp - 1) eps of the f32 result and
    within 2 tp eps of the unmeshed path."""
    return 2 * tp * eps


def phase_mesh_families(device, smi: str) -> int:
    """Phase 19f: every family's meshed prefill and decode steps over
    gloo rank processes on the card (``MESH_FAMILIES``), each against
    ``family_unmeshed`` on the same card and seed, every decode step fed
    the unmeshed path's token.  On every rank each step's logits lie
    within the path's bound of the unmeshed ones (f32 compute: every
    step, ``F32_FAMILY_TOL`` x that step's max |logit|; bf16: the first
    step, ``family_bound``), and each argmax equals the unmeshed token
    wherever the unmeshed top-2 gap exceeds that bound.  Where the cache
    lies over its sequence, every rank launched the partial mode on every
    decode layer (``ops.partial_launches``), held against its plain
    version.  Returns the ranks' ``decode_attention`` launches."""
    t19 = time.perf_counter()
    geom = MESH_FAMILY_SMOKE if MESH_SMOKE else MESH_FAMILY_GEOM
    da = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fam_") as tmp:
        want = {}
        for n, (tag, arch, depth, model, dtype) in enumerate(MESH_FAMILIES):
            _free(device)
            t = time.perf_counter()
            w = family_unmeshed(family_config(arch, depth, MESH_SMOKE, dtype),
                                device, **geom)
            w["s"] = time.perf_counter() - t
            w["path"] = f"{tmp}/want{n}.npz"
            np.savez(w["path"], tokens=w["tokens"], logits=w["logits"])
            want[tag, arch] = w
        _free(device)
        for model in sorted({f[3] for f in MESH_FAMILIES}):
            runs = [(tag, arch, depth, dt, want[tag, arch]["path"])
                    for tag, arch, depth, m, dt in MESH_FAMILIES
                    if m == model]
            t = time.perf_counter()
            res = _spawn(MESH_FAMILY_RANK, lambda r: (
                r, tmp, model, json.dumps(runs), device.type,
                int(MESH_SMOKE), json.dumps(geom)), model, f"19f {model}",
                tmp, lambda r: f"fam{model}_rank{r}.npz")
            spawn_s = time.perf_counter() - t
            for tag, arch, depth, dt, _ in runs:
                cfg = family_config(arch, depth, MESH_SMOKE, dt)
                w = want[tag, arch]
                key = f"{tag} {arch}"
                top = np.abs(w["logits"]).max(axis=(0, 2))   # a step
                if w["eps"] is None:        # f32 compute
                    bound, held = F32_FAMILY_TOL * top, len(top)
                    why = (f"{F32_FAMILY_TOL:g} x the step's max |logit|, "
                           f"{top.min():.4g}-{top.max():.4g}")
                else:
                    bound, held = np.full(top.shape, family_bound(
                        w["eps"], model)), 1
                    why = f"2 x {model} x eps {w['eps']:.4g}"
                checked = w["gaps"] > bound[None, :]
                for r, got in enumerate(res):
                    toks, errs = got[f"{key}|tokens"], got[f"{key}|errs"]
                    for b, i in np.argwhere(checked & (toks != w["tokens"])):
                        raise AssertionError(
                            f"19f {arch} rank {r} row {b} step {i}: token "
                            f"{toks[b, i]}, the unmeshed {w['tokens'][b, i]}"
                            f" (top-2 gap {w['gaps'][b, i]:.4g} > bound "
                            f"{bound[i]:.4g})")
                    for b, i in np.argwhere(errs[:, :held]
                                            > bound[None, :held]):
                        raise AssertionError(
                            f"19f {arch} rank {r} row {b} step {i}: logits "
                            f"{errs[b, i]:.4g} from the unmeshed, bound "
                            f"{bound[i]:.4g}")
                    da += int(got[f"{key}|da"])
                errs = np.stack([g[f"{key}|errs"] for g in res])
                rel = errs / top[None, None, :]
                kv = TF.kv_layout(cfg, PR.AbstractMesh(
                    (1, model), ("data", "model")), geom["seq"]
                    + geom["steps"]) if cfg.n_kv_heads else "none"
                n_attn = (cfg.n_layers if cfg.family != "hybrid"
                          else cfg.n_layers // cfg.attn_every)
                line = ""
                if kv == "seq" and cfg.family != "ssm":
                    parts = [int(g[f"{key}|partial"]) for g in res]
                    if device.type == "cuda" and parts != [
                            n_attn * geom["steps"]] * model:
                        raise AssertionError(f"19f {arch}: partial-mode "
                                             f"launches {parts} a rank")
                    pc = {k[len(key) + 4:]: v for k, v in res[0].items()
                          if k.startswith(f"{key}|pc_")}
                    line = (f"; partial mode {parts} launches a rank, at "
                            f"the first call's shard (B, H, hd, S_l, K, hd) "
                            f"= {pc['shape'].tolist()} equal to its plain "
                            f"version (max |diff| {float(pc['err']):.3g}, "
                            f"empty rows included)")
                    if "ms" in pc:
                        line += (f": {float(pc['ms']):.4f} ms, bound "
                                 f"{float(pc['bound_ms']):.4f} ms (bytes), "
                                 f"plain {float(pc['plain_ms']):.4f} ms, SDPA"
                                 f" {float(pc['sdpa_ms']):.4f} ms")
                ms = np.concatenate([g[f"{key}|ms"][1:] for g in res])
                log(f"[19f mesh {tag}] {cfg.name} ({cfg.n_layers} layers, "
                    f"{cfg.dtype} compute on bf16 weights) on (1, {model}) "
                    f"gloo ranks on {device.type}, kv "
                    f"cache {kv or 'whole'}: {batch_line(geom)}, each "
                    f"meshed step fed the unmeshed token; argmax equal to "
                    f"the unmeshed token on every rank at {int(checked.sum())}"
                    f" of {checked.size} (row, step), every one whose "
                    f"unmeshed top-2 gap exceeds the bound ({why}; gaps at "
                    f"step 0 {np.round(w['gaps'][:, 0], 4).tolist()}); "
                    f"logits of {held} of {len(top)} steps within "
                    f"{errs[:, :, :held].max():.4g} "
                    f"({rel[:, :, :held].max():.3g} of the step's max "
                    f"|logit|; bound {bound[:held].min():.4g}"
                    f"{'' if held == 1 else ' or more'})"
                    + ("" if held == len(top) else
                       f", later steps within {rel.max():.3g} of it, not held")
                    + line + f" | ms a decode step meshed (host clock, "
                    f"each rank, steps 2 on) {np.median(ms):.2f} "
                    f"[{ms.min():.2f}, {ms.max():.2f}], unmeshed "
                    f"{np.median(w['ms'][1:] or w['ms']):.2f}; "
                    f"decode_attention launches "
                    f"{[int(g[f'{key}|da']) for g in res]} a rank | "
                    f"unmeshed {w['s']:.1f} s")
            log(f"[19f] {model} ranks: {spawn_s:.1f} s with their start "
                f"| {smi}")
    log(f"[19f] {time.perf_counter() - t19:.1f} s")
    return da


# one rank of phase 19g: argv = src dir, rank, tmp dir, model ranks,
# device, smoke (1: the smoke config), geometry (JSON); writes
# sp_rank<rank>.npz
MESH_SP_RANK = r"""
import faulthandler, json, sys
faulthandler.enable()
import numpy as np
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
rank, tmp, model, dev = int(sys.argv[2]), sys.argv[3], int(sys.argv[4]), \
    sys.argv[5]
smoke, geom = sys.argv[6] == "1", json.loads(sys.argv[7])
if dev == "cuda":
    torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv_sp",
                        world_size=model, rank=rank)
from torch.distributed.device_mesh import init_device_mesh
sys.path.insert(0, sys.argv[1] + "/..")
import chip_smoke as CS
mesh = init_device_mesh(dev, (1, model), mesh_dim_names=("data", "model"))
out = CS.sp_step(CS.sp_config(geom, smoke), torch.device(dev), geom, mesh)
np.savez(f"{tmp}/sp_rank{rank}.npz", **out)
dist.destroy_process_group()
"""


def sp_config(geom: dict, smoke: bool):
    """19g's configuration: full width (the smoke config's with
    ``smoke``), ``geom``'s depth, f32 compute."""
    cfg = (smoke_config if smoke else get_config)(geom["arch"])
    return cfg.replace(n_layers=geom["n_layers"], dtype="float32")


def sp_step(cfg, device, geom: dict, mesh=None) -> dict:
    """One train step of 19g from weights drawn from ``SEED`` on
    ``device`` (rounded to bf16, kept in f32 masters) and the seeded
    batch, unmeshed or on ``mesh`` (each rank's shards cut from the same
    draw): loss, grad norm, s, the bytes allocated between the forward
    and the backward (``loss_fn``'s result held, on the card) and the
    collectives counted (all-gathers over ``model`` of a (B, S/tp, d)
    f32 sequence shard)."""
    from repro_torch.core.mesh import CollectiveCounter
    B, S = geom["batch"], geom["seq"]
    shape = InputShape("train_4k", S, B, "train")
    params = PR.init_params(
        LM.param_defs(cfg), torch.Generator(device=device).manual_seed(SEED),
        cast=lambda name, t: t.to(torch.bfloat16).to(t.dtype))
    batch = _on(next(token_stream(cfg.vocab_size, B, S, seed=SEED)), device)
    if mesh is None:
        step, opt = TS.make_train_step(cfg, shape), ADAMW.init(params)
    else:
        step, (p_sh, o_sh, b_sh), _, _ = TS.make_step(cfg, shape, mesh)
        params = TREE.tree_map(PR.shard_tensor, params, p_sh)
        zeros = TREE.tree_map(lambda t: torch.zeros(t.shape, device=device),
                              params)
        opt = ADAMW.AdamWState(
            PR.shard_tensor(torch.zeros((), dtype=torch.int32,
                                        device=device), o_sh.step),
            TREE.tree_map(PR.shard_tensor, zeros, o_sh.m),
            TREE.tree_map(PR.shard_tensor, zeros, o_sh.v))
        del zeros
        batch = {k: PR.shard_tensor(v, b_sh[k]) for k, v in batch.items()}
    _free(device)
    cuda = device.type == "cuda"
    kept, real = [], TS.loss_fn

    def probe(*a, **k):           # the step's forward, its result held
        _sync(device)
        before = torch.cuda.memory_allocated() if cuda else 0
        out = real(*a, **k)
        _sync(device)
        kept.append((torch.cuda.memory_allocated() if cuda else 0) - before)
        return out
    TS.loss_fn = probe
    try:
        t = time.perf_counter()
        with CollectiveCounter() as cc:
            params, opt, m = step(params, opt, batch)
        _sync(device)
        step_s = time.perf_counter() - t
    finally:
        TS.loss_fn = real
    tp = 1 if mesh is None else PR.axis_size(mesh, "model")
    shard = B * S // tp * cfg.d_model * 4
    seq = sum(1 for kind, nbytes, g in cc.ops
              if kind == "all-gather" and g == tp and nbytes == shard)
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "s": step_s, "kept": kept[0], "seq_gathers": seq,
           "n_collectives": len(cc.ops),
           "peak": torch.cuda.max_memory_allocated() if cuda else 0}
    del params, opt, step, batch
    _free(device)
    return out


def phase_mesh_sp(device, smi: str) -> None:
    """Phase 19g: the meshed train step sequence parallel (the
    reference's ``seq_shard``: S over ``model`` between the layers) over
    (1, model) gloo rank processes on the card, against the unmeshed
    step in this process on the same weights and batch: the loss and
    grad norm within ``SP_TOL`` (relative), the sequence all-gathers
    counted on every rank, and each rank's bytes kept between forward
    and backward at most the unmeshed step's less ``SP_KEEP`` x
    L B S d 4 (tp - 1)/tp (on the card)."""
    t0 = time.perf_counter()
    geom = MESH_SP_SMOKE if MESH_SMOKE else MESH_SP
    cfg, tp = sp_config(geom, MESH_SMOKE), geom["model"]
    _free(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    want = sp_step(cfg, device, geom)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sp_") as tmp:
        t = time.perf_counter()
        res = _spawn(MESH_SP_RANK, lambda r: (
            r, tmp, tp, device.type, int(MESH_SMOKE), json.dumps(geom)), tp,
            "19g", tmp, lambda r: f"sp_rank{r}.npz")
        spawn_s = time.perf_counter() - t
    res = [{k: float(v) for k, v in r.items()} for r in res]
    saved = (cfg.n_layers * geom["batch"] * geom["seq"] * cfg.d_model * 4
             * (tp - 1) / tp)
    for r, got in enumerate(res):
        for k in ("loss", "grad_norm"):
            if abs(got[k] - want[k]) > SP_TOL * abs(want[k]):
                raise AssertionError(f"19g rank {r}: {k} {got[k]!r}, the "
                                     f"unmeshed step's {want[k]!r}")
        if got["seq_gathers"] < 2 * cfg.n_layers:
            raise AssertionError(f"19g rank {r}: {got['seq_gathers']:.0f} "
                                 f"sequence all-gathers")
        if (device.type == "cuda"
                and got["kept"] > want["kept"] - SP_KEEP * saved):
            raise AssertionError(
                f"19g rank {r}: {got['kept']:.6g} B kept between forward "
                f"and backward, the unmeshed step {want['kept']:.6g} B, "
                f"bound {want['kept'] - SP_KEEP * saved:.6g}")
    rel = max(abs(r[k] - want[k]) / abs(want[k])
              for r in res for k in ("loss", "grad_norm"))
    log(f"[19g mesh sp] {cfg.name} ({cfg.n_layers} layers, f32 compute on "
        f"bf16-rounded weights), {geom['batch']} x {geom['seq']}, on (1, "
        f"{tp}) gloo ranks on {device.type}, sequence parallel: loss "
        f"{[r['loss'] for r in res]} grad_norm "
        f"{[r['grad_norm'] for r in res]} against the unmeshed "
        f"{want['loss']!r} / {want['grad_norm']!r} (max rel diff "
        f"{rel:.3g}, bound {SP_TOL:g}); sequence all-gathers a rank "
        f"{[int(r['seq_gathers']) for r in res]} of "
        f"{[int(r['n_collectives']) for r in res]} collectives; bytes kept "
        f"between forward and backward a rank "
        f"{[int(r['kept']) for r in res]} against the unmeshed "
        f"{int(want['kept'])} (fallen by at least "
        f"{want['kept'] - max(r['kept'] for r in res):.6g}, the layer inputs'"
        f" share {saved:.6g}, bound {SP_KEEP:g} of it); peak allocated a "
        f"rank {[int(r['peak']) for r in res]}, unmeshed "
        f"{int(want['peak'])} | s a step: ranks "
        f"{[round(r['s'], 4) for r in res]}, unmeshed {want['s']:.4f} "
        f"(gloo's host copies) | {smi} | {spawn_s:.1f} s for the ranks, "
        f"{time.perf_counter() - t0:.1f} s")


def phase_examples(device, smi: str) -> int:
    """Phase 20: the six twins of ``examples/`` as subprocesses with
    ``--device <device>`` at ``EXAMPLE_RUNS``' arguments, run side by
    side, each exiting 0; then ``torch_rag_serve.py``'s ``main`` here,
    every count set to 0 just before it and read just after.  Returns its
    ``decode_attention`` launches."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ex_") as tmp:
        procs = {}
        for name, args in EXAMPLE_RUNS:
            if name == "train_lm":
                args = args + ("--ckpt-dir", f"{tmp}/ckpt")
            procs[name] = subprocess.Popen(
                [sys.executable, str(ROOT / "examples" / f"torch_{name}.py"),
                 "--device", device.type, *args], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True,
                env=dict(os.environ, OMP_NUM_THREADS="2"))
        outs = {}
        try:
            for name, p in procs.items():
                out, err = p.communicate(timeout=600)
                outs[name] = (p.returncode, out, err,
                              time.perf_counter() - t0)
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for name, (rc, out, err, s) in outs.items():
        if rc:
            raise AssertionError(f"20 torch_{name}.py exited {rc}: "
                                 f"{err[-3000:]}")
        lines = [x for x in out.splitlines() if x.strip()]
        log(f"[20 example] torch_{name}.py --device {device.type} exited 0 "
            f"in {s:.1f} s (all six side by side): "
            + " / ".join(x.strip() for x in lines))
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import torch_rag_serve
    finally:
        sys.path.remove(str(ROOT / "examples"))
    _reset_launches()
    t = time.perf_counter()
    torch_rag_serve.main(["--device", device.type])
    launches = _launches()
    if device.type == "cuda" and launches["decode_attention"] == 0:
        raise AssertionError("20 torch_rag_serve.py: no decode_attention "
                             "launch")
    log(f"[20 examples] six twins exited 0; torch_rag_serve.main here in "
        f"{time.perf_counter() - t:.1f} s, launches {launches} | {smi} | "
        f"{time.perf_counter() - t0:.1f} s")
    return launches["decode_attention"]


def batch_line(geom: dict) -> str:
    return (f"{geom['batch']} prompts x {geom['seq']} tokens, "
            f"{geom['steps']} greedy steps")


def phase_mesh(device, smi: str, *, step_17a: float) -> int:
    """Phase 19, the mesh: (a) the dry runs (host only), then on a host
    mesh of one NCCL rank (b) the meshed train step and (c) the meshed
    serve steps, (d) ``_moe_shardmap``, (e) the d-HNSW step, (f) every
    family's meshed serve steps over gloo ranks on the card and (g) the
    meshed train step sequence parallel over gloo ranks on the card.  Returns
    the ``decode_attention`` launches of 19c and 19f."""
    from repro_torch.launch.mesh import make_host_mesh
    t19 = time.perf_counter()
    counts = phase_mesh_dryrun()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=f"file://{tmp}/rdv", world_size=1, rank=0)
        try:
            mesh = make_host_mesh(device_type=device.type)
            phase_mesh_train(device, mesh, smi, step_17a=step_17a,
                             arch=TRAIN_ARCH,
                             **{**TRAIN, "steps": MESH_TRAIN_STEPS})
            da = phase_mesh_serve(device, mesh, arch=RAG_ARCH, **MESH_SERVE)
            phase_mesh_moe(device, **MESH_MOE)
            phase_mesh_dhnsw(device, mesh, counts, **MESH_DHNSW)
            da += phase_mesh_families(device, smi)
            phase_mesh_sp(device, smi)
        finally:
            dist.destroy_process_group()
    log(f"[19] {time.perf_counter() - t19:.1f} s")
    return da


# ------------------------------------------ the paper's evaluation (18)

def _paper_cell(name: str) -> tuple:
    """(dataset, k, mode, ef) of a paper row: ``fig6/<ds>@top<k>/<mode>/
    ef<ef>``, ``table/<ds>@1/<mode>`` (ef 48) or ``fig6/<ds>/headline``
    (its recall is the top-10 full row's at ef 48)."""
    parts = name.split("/")
    if parts[-1] == "headline":
        return parts[1], 10, "full", 48
    ds_name, top = parts[1].split("@")
    ef = int(parts[3].removeprefix("ef")) if len(parts) > 3 else 48
    return ds_name, int(top.removeprefix("top")), parts[2], ef


def _paper_path(log_: PathLog, preset: dict, name: str, device,
                tag: str) -> tuple:
    """Fig. 6, then Tables 1-2 on dataset ``name`` through the twins at
    ``preset``, as one path of ``log_``: the engines' span caches carry
    from Fig. 6 into the tables, as under ``benchmarks/run.py``.  Prints
    each search's wall, host split and gather launches beside the twins'
    CSV rows.  Returns (rows, row name -> its measured search: d, g,
    stats, wall s, gather launches)."""
    seen = {}
    last = [0]

    def observe(row, d, g, st, wall):
        n = GO.launches - last[0]
        last[0] = GO.launches
        seen[row["name"]] = dict(d=d, g=g, stats=st, wall=wall, launches=n)
        log(f"[{tag}] {row['name']}: wall {wall:.4f} s, meta_s "
            f"{st['meta_s']:.4f} plan_s {st['plan_s']:.4f} sub_s "
            f"{st['sub_s']:.4f} | gather launches {n}")
    with log_.path():
        rows = torch_latency_recall.run((name,), preset=preset,
                                        device=device, observe=observe)
        rows += torch_breakdown.run((name,), preset=preset, device=device,
                                    observe=observe)
    return rows, seen


def _paper_checks(seen: dict, preset: dict, device, tag: str) -> None:
    """Naive's round trips a query are the distinct (query, partition)
    pairs of the route over B, counted here from ``meta_route`` apart
    from the pool's code; no-doorbell's net term lies between naive's and
    full's at every point; on the card every scheme launched
    ``gather_spans``."""
    names = sorted({_paper_cell(n)[0] for n in seen})
    for ds_name in names:
        queries = torch_common.batched_queries(
            torch_common.dataset(ds_name, preset), preset["batch"])
        meta = torch_common.index(ds_name, preset)[0]
        pids = _route(meta, queries, device, 4)
        want = sum(len(set(r.tolist())) for r in pids) / len(queries)
        for n, s in seen.items():
            if _paper_cell(n)[0] == ds_name and _paper_cell(n)[2] == "naive":
                got = s["stats"]["round_trips_per_query"]
                if got != want:
                    raise AssertionError(f"{tag} {n}: naive rtpq {got}, the "
                                         f"route's distinct pairs {want}")
    for n, s in seen.items():
        if _paper_cell(n)[2] != "no_doorbell":
            continue
        net = {m: seen[n.replace("/no_doorbell", f"/{m}")]["stats"]["net"][
            "latency_s"] for m in torch_latency_recall.MODES}
        if not net["full"] <= net["no_doorbell"] <= net["naive"]:
            raise AssertionError(f"{tag} {n}: net terms {net} out of order")
    launches = {m: sum(s["launches"] for n, s in seen.items()
                       if _paper_cell(n)[2] == m)
                for m in torch_latency_recall.MODES}
    if device.type == "cuda" and min(launches.values()) <= 0:
        raise AssertionError(f"{tag}: gather_spans launches by scheme "
                             f"{launches}")
    log(f"[{tag}] naive rtpq = the route's distinct (query, partition) "
        f"pairs / B on {names}; no_doorbell's net between naive's and "
        f"full's at {len(seen) // 3} points; gather launches by scheme "
        f"{launches}")


def _gid_diff(name: str, seen: dict, preset: dict) -> None:
    """Print each query whose gids differ between the card's search of
    row ``name`` and the same search on CPU tensors (the reference's
    arithmetic), with the distances and the ground truth."""
    ds_name, k, mode, ef = _paper_cell(name)
    if name.endswith("/headline"):
        name = f"fig6/{ds_name}@top10/full/ef48"
    ds = torch_common.dataset(ds_name, preset)
    queries = torch_common.batched_queries(ds, preset["batch"])
    d, g, _ = torch_common.engine(ds_name, mode, preset=preset,
                                  device="cpu").search(queries, k=k, ef=ef)
    card = seen[name]
    for i in range(min(len(g), len(ds.queries))):
        if not np.array_equal(card["g"][i], g[i]):
            log(f"[18a] {name} query {i}: card gids {card['g'][i].tolist()} "
                f"d {card['d'][i].tolist()} | cpu gids {g[i].tolist()} d "
                f"{d[i].tolist()} | gt {ds.gt_ids[i, :k].tolist()}")


def _paper_against_reference(rows: list, seen: dict, preset: dict,
                             reference: list) -> int:
    """Every counted field of every row equal to ``reference``'s (the
    JAX package's rows); a recall may differ by at most one query's
    share, 1/(n k) (and its two roundings), and then the queries whose
    gids differ from a CPU run are printed.  Returns the recalls that
    differ."""
    want = {r["name"]: torch_paper_reference.counted(r) for r in reference}
    got = {r["name"]: torch_paper_reference.counted(r) for r in rows}
    if sorted(got) != sorted(want):
        raise AssertionError(f"18a rows {sorted(set(got) ^ set(want))} "
                             "not in both the run and the reference")
    n_diff = 0
    for name, w in want.items():
        for key, val in w.items():
            if key == "name" or got[name][key] == val:
                continue
            if not key.startswith("recall"):
                raise AssertionError(f"18a {name}: {key} {got[name][key]}, "
                                     f"the reference's {val}")
            ds_name, k, _, _ = _paper_cell(name)
            n = min(preset["batch"],
                    len(torch_common.dataset(ds_name, preset).queries))
            log(f"[18a] {name}: {key} {got[name][key]}, the reference's "
                f"{val} (one query's share {1 / (n * k):.5f})")
            if abs(got[name][key] - val) > 1 / (n * k) + 1e-4:
                raise AssertionError(f"18a {name}: {key} {got[name][key]} "
                                     f"differs from the reference's {val} "
                                     "by more than one query's share")
            _gid_diff(name, seen, preset)
            n_diff += 1
    return n_diff


def _paper_datasets(preset: dict, device, logs: dict, tag: str,
                    label: str) -> tuple:
    """``_paper_path`` on sift, then gist, at ``preset``, each a path of
    its own ``PathLog`` (``logs[label.<dataset>]``); prints each one's
    time, its index build (on the host, timed; none for an index handed
    in) and its peak device memory.  Returns (rows, searches)."""
    rows, seen = [], {}
    for name in ("sift", "gist"):
        t0 = time.perf_counter()
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        logs[f"{label}.{name}"] = PathLog(device)
        r, s = _paper_path(logs[f"{label}.{name}"], preset, name, device,
                           tag)
        rows += r
        seen.update(s)
        peak = (f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB"
                if device.type == "cuda" else "not measured (CPU)")
        build = torch_common.index(name, preset)[3]
        log(f"[{tag} {name}] {torch_common.dataset(name, preset).data.shape}"
            f": {len(r)} rows in {time.perf_counter() - t0:.1f} s, "
            + ("index handed in" if build is None else
               f"the host index build {build:.1f} s of it")
            + f" | peak device memory {peak}")
    return rows, seen


def phase_paper_headline(ds, meta, store, device, log_: PathLog, *,
                         graph_batch) -> None:
    """Phase 18c: ``benchmarks/torch_headline.py`` on phase 3's index.
    Its ``full`` batch runs on a fresh engine in phase 5's graph
    configuration, so its gids and counted stats must equal phase 5's
    graph batch (``graph_batch``: d, g, stats)."""
    with log_.path() as n:
        res = torch_headline.run(index=(meta, store), ds=ds, device=device)
    d5, g5, st5 = graph_batch
    f = res["full"]
    if not (np.array_equal(f["g"], g5) and _counted_equal(f["stats"], st5)):
        raise AssertionError("18c: the headline's full batch differs from "
                             "phase 5's graph batch")
    net = {m: r["stats"]["net"]["latency_s"] for m, r in res.items()}
    log(f"[18c headline] recall@10 {f['recall']:.4f} | rtpq "
        + ", ".join(f"{m} {r['stats']['round_trips_per_query']:.5f}"
                    for m, r in res.items())
        + f" | naive/full net {net['naive'] / net['full']:.1f}x | beside "
        "headline_full.py's docstring (the JAX package on a CPU, not a "
        "card): recall@10 ~0.86, rtpq 4.0 -> 0.01, ~32x | wall s a batch "
        + ", ".join(f"{m} {r['wall']:.4f} ({_host_split(r['stats'])})"
                    for m, r in res.items())
        + f" | full batch = phase 5's graph batch: gids, counted stats"
        + (", distances" if np.array_equal(f["d"], d5) else "")
        + f" | gather launches {n['gather_blocks']}")


def phase_paper(ds, meta, store, device, *, graph_batch, quick=None,
                full=None, reference=None,
                recall_floor: float = RECALL_FLOOR,
                walk_check=None) -> tuple:
    """Phase 18: the paper's evaluation through the port's twins.  (a)
    the ``quick`` preset (``quick``; sift 20k, gist 4k, batch 256): Fig.
    6, Tables 1-2 and insert, every counted field equal to ``reference``
    (default: the committed ``benchmarks/torch_reference/
    paper_quick.json``); (b) the ``full`` preset (``full``): Fig. 6 and
    Tables 1-2 for sift on phase 3's index and for gist (20k x 960, one
    host build, timed), ``_paper_checks``, recall@10 at ef 48 on sift of
    at least ``recall_floor``, each dataset's peak device memory; (c) the
    headline run.  Every search gathers through ``gather_spans``; the
    calls are recorded for phase 4.  ``walk_check`` (a ``WalkCheck``) is
    active over (b), for phase 4's walk rounds.  Returns (launches, the
    recorded gather launches as ``gather_launches`` entries, their
    buffers)."""
    t18 = time.perf_counter()
    quick = torch_common.PRESETS["quick"] if quick is None else quick
    full = torch_common.PRESETS["full"] if full is None else full
    reference = (torch_paper_reference.load()["rows"] if reference is None
                 else reference)
    logs = {}
    torch_common.clear()
    rows, seen = _paper_datasets(quick, device, logs, "18a", "quick")
    logs["quick.insert"] = PathLog(device)
    t0 = time.perf_counter()
    with logs["quick.insert"].path():
        rows += torch_insert.run(preset=quick, device=device)
    log(f"[18a insert] {time.perf_counter() - t0:.1f} s with its build")
    _paper_checks(seen, quick, device, "18a")
    n_diff = _paper_against_reference(rows, seen, quick, reference)
    log(f"[18a] {len(rows)} rows: every counted field equal to the "
        f"reference's ({n_diff} recalls within one query's share) | "
        f"{time.perf_counter() - t18:.1f} s")

    torch_common.clear()
    torch_common.adopt_index("sift", ds, meta, store, preset=full)
    with walk_check or contextlib.nullcontext():
        rows, seen = _paper_datasets(full, device, logs, "18b", "full")
    _paper_checks(seen, full, device, "18b")
    rec = seen["fig6/sift@top10/full/ef48"]
    got = next(r["recall"] for r in rows
               if r["name"] == "fig6/sift@top10/full/ef48")
    if got < recall_floor:
        raise AssertionError(f"18b sift recall@10 at ef 48 {got}")
    log(f"[18b] sift recall@10 at ef 48 {got} >= {recall_floor} | full "
        f"batch wall {rec['wall']:.4f} s")
    torch_common.clear()

    logs["headline"] = PathLog(device)
    phase_paper_headline(ds, meta, store, device, logs["headline"],
                         graph_batch=graph_batch)
    launches = {name: sum(lg.launches[name] for lg in logs.values())
                for name in KERNEL_OPS}
    bufs, recorded = {}, []
    for tag, lg in logs.items():
        recorded += recorded_launches(lg.calls, bufs, f"paper.{tag}.")
    _free(device)
    log(f"[18] {time.perf_counter() - t18:.1f} s | launches {launches}")
    return launches, recorded, bufs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweep", action="store_true",
                    help="phase 4 also times every launch shape of the "
                         "streaming kernels")
    args = ap.parse_args(argv)
    dev_info = phase_device()
    device = torch.device("cuda")
    log("reduced: " + json.dumps(REDUCED))
    phase_kernel_build()
    ds, meta, store, qstore = phase_index(FULL["n"], FULL["n_queries"],
                                          FULL["n_rep"])
    gathers = main_path_gathers(meta, store, ds.queries, device,
                                doorbell=FULL["doorbell"])
    pair_gathers = {mode: pair_path_gathers(
        meta, qstore, ds.queries, device, doorbell=FULL["doorbell"],
        search_mode=mode, n_batches=PAIR_BATCHES) for mode in ("scan", "graph")}
    launches, scan_stats, exact_batches = phase_exact(
        ds, meta, store, device, k=FULL["k"], doorbell=FULL["doorbell"],
        gathers=gathers, recall_floor=RECALL_FLOOR)
    sift_walks = phase_walk(ds, meta, store, device, k=FULL["k"],
                            doorbell=FULL["doorbell"],
                            graph_batch=exact_batches["graph"])
    launches.update(phase_int8(ds, meta, qstore, device, k=FULL["k"],
                               doorbell=FULL["doorbell"],
                               recall_floor=RECALL_FLOOR))
    launches.update(phase_throughput(
        ds, meta, store, device, preset=torch_common.PRESETS["full"],
        scan_stats=scan_stats))
    pairs = phase_int8_pairs(ds, meta, qstore, device, k=FULL["k"],
                             doorbell=FULL["doorbell"], gathers=pair_gathers,
                             n_batches=PAIR_BATCHES,
                             recall_floor=RECALL_FLOOR)
    launches["gather_blocks"] += pairs["gather_blocks"]
    rag_launches, rag_gathers, first = phase_rag(
        ds, meta, store, device, cfg=get_config(RAG_ARCH),
        doorbell=FULL["doorbell"], **RAG)
    launches["gather_blocks"] += rag_launches["gather_blocks"]
    launches["decode_attention"] = rag_launches["decode_attention"]
    # the other LM families next, while the host is not yet loaded by the
    # pool phases' servers and threads (their decode is host-bound too)
    fams = PathLog(device)
    t15 = time.perf_counter()
    captures = {arch: FirstCall(DA, "decode_attention") for arch in (
        MOE_ARCH, "llama4-scout-17b-a16e", "zamba2-2.7b", WHISPER["arch"])}
    phase_moe_serve(ds, meta, store, device, log_=fams,
                    capture=captures[MOE_ARCH], doorbell=FULL["doorbell"],
                    **RAG_GEOM)
    phase_families_serve(ds, meta, store, device, log_=fams,
                         captures=captures, doorbell=FULL["doorbell"],
                         **RAG_GEOM)
    log(f"[15a-b] {time.perf_counter() - t15:.1f} s")
    t15 = time.perf_counter()
    phase_card_vs_cpu(device, **CARD_CPU)
    log(f"[15c] {time.perf_counter() - t15:.1f} s")
    phase_sharded_store(store, gathers[0][0].cpu().numpy(), device,
                        **SHARD_STORE)
    train = phase_training(device, dev_info["smi"])
    launches["decode_attention"] += phase_mesh(
        device, dev_info["smi"], step_17a=train["step_s"])
    launches["decode_attention"] += phase_examples(device, dev_info["smi"])
    gist_walks = WalkCheck(want=lambda v: v.shape[2] == 960, limit=2)
    paper_launches, paper_recorded, paper_bufs = phase_paper(
        ds, meta, store, device, graph_batch=exact_batches["graph"],
        walk_check=gist_walks)
    ins_launches, ins_recorded, ins_bufs = phase_insert(
        ds, meta, store, qstore, device, k=FULL["k"],
        doorbell=FULL["doorbell"], scan_recall=scan_stats["recall_at_k"])
    load_launches, load_recorded, load_bufs = phase_load(
        device, doorbell=FULL["doorbell"], **LOAD)
    pools = PathLog(device)
    t12 = time.perf_counter()
    phase_sim_rdma(ds, meta, store, qstore, device, k=FULL["k"],
                   doorbell=FULL["doorbell"], log_=pools)
    phase_sharded(ds, meta, store, qstore, device, k=FULL["k"],
                  doorbell=FULL["doorbell"], log_=pools, **SHARD)
    phase_failover(ds, meta, store, device, k=FULL["k"],
                   doorbell=FULL["doorbell"], log_=pools)
    phase_pool_bench(device, pools)
    phase_serving(device, dev_info["smi"], pools)
    log(f"[12-13] {time.perf_counter() - t12:.1f} s")
    t14 = time.perf_counter()
    phase_remote(ds, meta, store, qstore, device, k=FULL["k"],
                 doorbell=FULL["doorbell"], log_=pools)
    phase_remote_chaos(ds, meta, store, device, k=FULL["k"],
                       doorbell=FULL["doorbell"], log_=pools, **CHAOS)
    phase_remote_durable(device, k=FULL["k"], doorbell=FULL["doorbell"],
                         log_=pools, **DURABLE)
    phase_remote_bench(device, pools)
    log(f"[14] {time.perf_counter() - t14:.1f} s")
    pool_bufs = {}
    pool_recorded = recorded_launches(fams.calls + pools.calls, pool_bufs,
                                      "pool.")
    for name in launches:
        launches[name] += (ins_launches[name] + load_launches[name]
                           + fams.launches[name] + pools.launches[name]
                           + paper_launches[name])
    planned = gather_launches(gathers, pair_gathers, rag_gathers,
                              ins_recorded + load_recorded + pool_recorded
                              + paper_recorded)
    if launches["gather_blocks"] != len(planned):
        raise AssertionError(f"{launches['gather_blocks']} gather launches on "
                             f"the main path, {len(planned)} span reads "
                             f"planned (one launch each)")
    q, k, v, pos = first
    if any(cap.args is None for cap in captures.values()):
        raise AssertionError("a family's decode made no decode_attention "
                             "call")
    records = phase_kernels(store, qstore, ds.data, ds.queries, planned,
                            device, decode_shapes=[
                                ("path", q, k, v, pos),
                                *[(arch, *cap.args)
                                  for arch, cap in captures.items()],
                                ("long", *long_decode_inputs(
                                    **DECODE_LONG, H=q.shape[1],
                                    K=k.shape[2], hd=q.shape[2],
                                    dtype=q.dtype, device=device))],
                            sweep=args.sweep,
                            extra_bufs={**ins_bufs, **load_bufs,
                                        **pool_bufs, **paper_bufs},
                            gather_parts=[("18b gist (960-d rows)",
                                           "paper.full.gist.")],
                            walks=[("5w sift exact graph", sift_walks),
                                   ("18b gist (960-d rows)",
                                    gist_walks.rounds)])
    for r in records:
        r["launches"] = launches[r["name"]]
        if r["launches"] <= 0:
            raise AssertionError(f"{r['name']} not launched on the main path")
    log(json.dumps({"kernels": records}))
    log(dev_info["smi"])
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": dev_info["name"],
                                           "count": dev_info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
