#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one card and check it end to end.

    python3 chip_smoke.py            # from the root of a checkout

Phases (each prints one JSON line per result):
  1. build   — compile every CUDA kernel of the port from
               src/repro_torch/kernels/csrc (one nvcc per source, in parallel);
  2. kernels — hold each kernel against its plain PyTorch version on the card
               at its path's shapes and variants (serving: bf16 and int8 K/V,
               GQA groups 1 and 4, ragged lengths with an empty row, the
               split-K decode kernel also at gemma-2b's and starcoder2's
               decode shapes, with its splits and launches, prefill at
               gemma-2b's head dim 256 (bf16 and int8 pools), decode and
               prefill at starcoder2-15b's shape under its 4096-token
               sliding window with contexts to 6144, decode and prefill at
               yi-6b's G 8 and dbrx-132b's G 6, batched LoRA at every other
               dense arch's and the MoE archs' attention projection shapes
               and rows and at the SSM archs' in_proj and out_proj, rank
               mask, int8 bank, and the per-row Eq. 7 batched dual-LoRA
               product at its entry point; training: the LoRA and dual-LoRA
               products of a 2048-row batch, flash attention at B=8, S=256
               with a window, Sq < Sk and GQA variants and at gemma-2b's
               head dim 256, the LoRA product at gemma-2b's train-step
               projections, at the fixed path's 8 decode rows and at the
               baselines' ranks 8 and 32, and the two
               autograd backwards against plain autograd); the two
               attention kernels and the four LoRA kernels also with fp32
               activations, which run their fp32 CUDA-core tile (bf16 runs
               the tensor-core tile), held tight, and bf16 attention and
               dual-LoRA outputs held per row to the tile's own arithmetic
               (kernels/attn_tile.py, kernels/lora_tile.py); time kernel
               (CUDA events around back-to-back calls, and
               ``device_ms``: its own device time
               per call from a torch.profiler trace), plain version and one
               library call computing the same function (a yardstick the
               port never calls; for decode also its device time); at the
               prefill shape, the LoRA shrink's
               and epilogue's share of the call's device time;
  3. serve   — llama2-7b at full width, 16 of 32 layers (LLAMA_LAYERS, the
               script's time limit), bf16, random weights from
               --seed, 8 tenants with non-zero rank-16 adapters: 8 ragged
               requests (prompts 128-1024 tokens, 32 new tokens) through
               MultiTenantEngine.generate with paged_backend="cuda", counting
               kernel launches; then the same requests with "torch", holding
               first-chunk logits and greedy tokens to stated tolerances; the
               "cuda" run four times, in turns with overlapped dispatch (the
               default) and without (on, off, off, on), streams bitwise
               equal; four traced runs in the same turns;
  3b. serve_trace — the same engine under an open-loop Poisson trace
               (serving/trace.py: 16 requests at 2/s, prompts 1-1024 and
               outputs 1-64 tokens, lognormal, over the 8 tenants; 8 slots
               of 1088 tokens): logical mode (arrivals mapped to rounds)
               with overlap on and off, streams bitwise equal, some decode
               chunks deferred; realtime mode in the same four turns, with
               TTFT from the scheduled arrival, TPOT, goodput and
               wall-clock queue waits, streams held to the logical ones by
               the margin rule; one traced realtime run;
  4. serve_options — the same llama2-7b weights, 16 layers: a ragged int8
               adapter bank (buckets 4, 8, 16; 6 tenants by register_dual),
               12 requests of byte-tokenized log text sharing a 512-token
               prefix per tenant, int8 K/V, prefix caching over a pool
               pinned at about 3/4 of residency: a cold run (prefix hits, preemption), a warm run (the pool
               reused across calls) and a speculative run, with the
               "cuda"/"torch" first-chunk logits, the first suffix chunk
               after a prefix hit against the same positions prefilled
               cold, and the streams held to stated tolerances; one traced
               warm run;
  4b. sharded — the same weights cut to 8 of their 16 layers (the
               script's time limit), the serve cell's 8 requests and 8
               tenants' rank-16 fused adapters in a ShardedAdapterRegistry,
               8 slots, "cuda", overlap on: num_shards 1, 2 and 4 (streams
               bitwise equal, adapter placement for all 8), the prefix
               cache cold then warm at 2 shards on a pinned pool (cold
               bitwise the run without the cache, every full block hit on
               its shard, warm against cold by the margin rule), a
               hot-swap at 2 shards after the first decode round
               (untouched streams bitwise those of the run without it),
               int8 K/V over a ragged int8 bank at 1 and 2 shards (bitwise),
               the first chunk "cuda" vs "torch" through the 2-shard
               registry's kernel view; TTFT, decode tok/s and peak memory
               per run, the bank concatenation's ms;
  4c. fixed  — the fixed-batch path on the sharded phase's 16 layers: one
               64-token prompt, 16 new tokens, cache_len 128: generate_fixed over the 8 tenants (batched
               LoRA at 8 rows a step) and the single-tenant Engine with one
               Eq. 7-merged adapter (lora_matmul at 8 rows a step), the
               last prompt position's logits "cuda" vs "torch", the
               streams against the continuous engine's by the margin rule,
               ms per step and tok/s;
  5. train   — FDLoRA Algorithm 1 on the same llama2-7b weights (16 layers,
               full width, bf16), rank-16 adapters on all 7 targets, 2
               clients of 8 x 256-token SFT batches: one train step and one
               fused evaluation through "cuda" and "torch" held to stated
               bounds, then FDLoRATrainer.fit through the kernels (12 train
               steps, 18 fused evaluations), publish into an AdapterRegistry
               and generate from it; FDLoRA's answer accuracy on 32
               held-out examples a client; one traced train step and one
               traced fused evaluation;
  5b. baselines — the same weights and data: Local and the six baselines
               (FedAvg, FedProx, FedAMP, FedRep, FedRoD, FedKD) each fit
               through the kernels at FedConfig(n_clients=2, rounds=2,
               local_steps=1), with s per round, train tokens/s, peak
               memory, bytes communicated, launches by tile and the answer
               accuracy of the returned adapters beside FDLoRA's; one step
               of FedProx, FedRoD (rank 2r) and FedKD (a rank-r/2 student)
               and answer_accuracy through "cuda" and "torch" held to
               stated bounds; one make_fdlora_round_step round (2 clients
               stacked, K 2) with the pseudo-gradient in fp32 and in bf16,
               the bf16 one held to a derived bound; one traced FedRoD
               step;
  5c. remat — activation recomputation (ModelConfig.remat and
               remat_policy; every train step of the other phases runs at
               the configs' default, remat "full") on the same llama2-7b
               weights, 16 layers, bf16, rank-16 adapters on all 7
               targets, 4,096-token SFT rows: (a) one row at remat off,
               "full" and "dots": the loss and every adapter gradient of
               "full" and "dots" bitwise off's when two off runs are
               bitwise equal (else within twice their distance), a warmed,
               timed step per setting with its mfu and its peak beside the
               dry run's (within 25%), lora_matmul and flash launches
               ("full": both twice a forward; "dots": flash twice,
               lora_matmul once, its outputs saved: a hard check); (b) the
               dry run (its walks in host processes beside the card) picks
               the most rows of 8, 4, 2 at which "full" fits 60% of the
               card (the walk leaves out about 1.14 GB a row and the
               allocator's fragmentation) and off passes 90% of it, and
               the most at which "dots" fits 60%:
               one step each there, its peak beside the walk's and off's
               predicted peak, the flash backward's fp32 probabilities'
               bytes beside the predicted temp;
  6. dense_family — with llama2-7b's weights freed, gemma-2b, olmo-1b,
               yi-6b and starcoder2-15b in turn at their published width
               and at most 8 layers (the script's time limit), bf16,
               random weights from --seed, 4 tenants with
               rank-16 fused adapters: 4 requests (prompts 128-1024 tokens;
               starcoder2-15b one more of 4,608 tokens, past its window),
               16 new tokens, through "cuda" with overlap on and off
               (streams bitwise equal, every serving kernel launched,
               prefill attention and batched LoRA on their tensor-core
               tiles), the first chunk held to "torch" (bf16 and fp32
               activations); gemma-2b also a train step held to "torch"
               (flash attention at head dim 256), starcoder2-15b the long
               prompt's last chunk, where the window binds, held to
               "torch", and "torch" without the window shown to miss it;
  7. moe     — dbrx-132b (8 of its 40 layers) and kimi-k2-1t-a32b (1 of
               its 61) at their published width, bf16, random weights from
               --seed, 4 tenants with rank-16 fused adapters (the router's
               pair included): 4 requests (prompts 128-1024 tokens), 16 new
               tokens, through "cuda" with overlap on and off (streams
               bitwise equal, every serving kernel launched, prefill
               attention and batched LoRA on their tensor-core tiles), the
               decode step beside the byte bound of reading every expert;
               the first chunk twice through "cuda" (bitwise equal) and
               through "torch" with each layer's expert ids pinned to the
               "cuda" run's (bf16; dbrx-132b also fp32 activations), every
               routing flip held by the router-logit margin, the dropped
               copies per layer equal; one traced dbrx-132b run with the
               expert products and the routing and dispatch as rows of
               their own;
  8. ssm     — mamba2-2.7b (16 of its 64 layers) and jamba-v0.1-52b (8 of its
               32: one period, every pattern entry once) at their published
               width, bf16, random weights from --seed, 4 tenants with
               rank-16 fused adapters (the mamba in_proj/out_proj pairs
               included): the dense_family cell's 4 requests and 2 more
               over 4 slots (two slots reused), 16 new tokens, through
               "cuda" with overlap on and off (streams bitwise equal,
               batched LoRA on its tensor-core tile; jamba also both paged
               attention kernels), the decode rate beside the byte bound of
               a step (weights, and every slot's recurrent state read and
               written); the per-slot state's bytes against the shapes'
               count; the first chunk held to "torch" (bf16 and fp32
               activations; jamba's expert ids pinned as in phase moe); on
               mamba2 64 prompt tokens prefilled in chunks of 16 against
               the same tokens fed one at a time through decode_step (bf16
               and fp32); each reused slot's state zero at admission and
               its stream against the same request in a fresh slot by the
               margin rule; one traced mamba2 run of the first 4 requests
               with the per-token scan as a row of its own and the host
               time spent issuing it;
               its kernel lines (kernels phase) hold batched LoRA at both
               archs' in_proj (N tails of 80 and 160 columns past a
               multiple of 256) and out_proj shapes;
  9. vlm_encdec — internvl2-26b at 24 of its 48 layers (the script's time
               limit), published width, bf16,
               random weights from --seed, 4 tenants with rank-16 fused
               adapters: phase dense_family's 4 text-only requests through
               "cuda" with overlap on and off (streams bitwise equal, every
               serving kernel launched on its tensor-core tiles), the first
               chunk held to "torch" (bf16 and fp32 activations); then one
               LoRA train step of 2 rows, each 256 seeded stub patch
               embeddings and 256 SFT tokens, held to "torch" (bf16 at 24
               layers, fp32 at the first 8), with each step's peak memory;
               whisper-small in full (12 + 12 layers, 1,500 stub frames):
               one train step of 8 x 256 SFT tokens through lora_matmul and
               non-causal flash attention held to "torch" (the cross-
               attention's wv gradients exactly 0 on both backends), then
               prefill_cross and 32 greedy decode_step calls for 8 rows
               with one Eq. 7-fused rank-16 adapter: the first step's
               logits against "torch", the streams by the margin rule, the
               teacher-forced fp32 decode logits against forward's within
               1% of the largest logit, ms a step and tok/s; its kernel
               lines (kernels phase) hold every new shape: batched LoRA and
               lora_matmul at internvl2-26b's projections, flash attention
               at its G 6, lora_matmul at whisper's three projection shapes
               at 12,000, 2,048 and 8 rows, flash attention at head dim 64
               non-causal (1,500 x 1,500, 256 x 1,500, 1 x 1,500) and
               causal (256);
 10. train_families — one LoRA train step of dbrx-132b (the deepest of at
               most 8 of its 40 layers whose dry-run peak fits in 90% of
               the card), mamba2-2.7b (all 64 layers, the SSD chunked
               scan) and jamba-v0.1-52b (8 of 32) at published width,
               bf16, random weights from --seed, rank-16 adapters on every
               target (the router's and the mamba projections' pairs
               included), 2 x 256 SFT tokens, through the kernels: step
               seconds, mfu and peak memory beside the dry run's
               prediction for the same config and batch
               (launch/dryrun.py on the meta device: argument bytes equal
               exactly, the measured peak within 25% of the predicted);
               loss and adapter gradients "cuda" vs "torch" in bf16 at
               that depth and in fp32 at the first layer of each kind,
               routing pinned, and a stage-3 fused evaluation; the train
               phase's llama2-7b step is held to its prediction too;
 11. full_train — full fine-tuning (make_full_train_step: every weight
               trains, AdamW, no adapter) of llama2-7b at full width,
               bf16, random weights from --seed, 8 x 256 SFT tokens, at
               the deepest of at most 32 layers whose dry-run peak (the
               full step walked on the meta device by launch/dryrun.py's
               measure) fits in 90% of the card, found by bisection (the
               depths tried are emitted): one warmed, timed step with its
               mfu and its measured peak within 2% of the dry run's, one
               traced step (the AdamW update, the clip and the new weights
               as rows of their own);
               flash attention launched on its tensor-core tile in every
               layer and no LoRA kernel launched; loss and every weight's
               gradient "cuda" vs "torch" in bf16 at that depth and in
               fp32 at one layer, then the weights after one fp32 AdamW
               step; fused_forward with two seeded rank-16 adapter trees
               (the dual-LoRA kernel in every projection) against the
               plain merge;
 12. mesh_round — FDLoRA's round over a torch.distributed mesh
               (launch/mesh.py, federated/mesh_job.py) on llama2-7b at
               full width, 4 of 32 layers (the script's time limit),
               bf16, random weights from
               --seed, rank-16 adapters on all 7 targets, 2 clients, K 2,
               8 x 256 SFT rows: (a) world size 1 on NCCL in this process,
               the mesh round bitwise the meshless one, compress_outer
               none and bf16; (b) world size 2 on this card (gloo, spawned,
               each rank building the weights from the seed), pod 2:
               θ_s', every client's state and the loss bitwise (a)'s on
               both ranks, both modes, lora_matmul and flash attention on
               their tensor-core tiles on each rank, exactly one pod
               all-reduce a round of the adapter tree's bytes; (c) world
               size 2, data 2: one client's rows split 4 + 4, fp32, one
               layer, its loss within 4 fp32 ulps of the single-rank
               round's and θ within a derived bound; (d) world size 2,
               model 2: each rank 16 of the 32 heads, 5,504 of the 11,008
               ff columns and 16,000 of the 32,000 vocabulary columns,
               (a)'s round otherwise: replicated leaves and loss bitwise
               equal across the ranks, θ_s' gathered from the shards
               within the train phase's bf16 bounds of (a)'s, the kernels
               on their tensor-core tiles at the local shapes, the
               collectives equal to the dry run's walk of the rank, each
               rank's peak within 25% of the dry run's; (e) (c)'s fp32
               round at model 2 against the single rank;
               s per round, the all-reduce's host ms (gloo through the
               host on a shared card, not a link rate), the collectives by
               op and group, the peak memory per rank;
 12b. mesh_serve — serving over a torch.distributed mesh
               (ServeConfig.mesh; launch/serve.ServeJob the rank program):
               llama2-7b at full width, 4 of 32 layers (the script's
               time limit), bf16, random weights from --seed, 8 tenants' rank-16 adapters, 8
               requests (prompts 128-512 tokens, 16 new tokens) through
               MultiTenantEngine.generate on "cuda"; the meshless runs at
               num_shards 2 and 1 here, then two ranks on this card
               (gloo, spawned): (a) mesh (1, 2, 1), num_shards 2, each
               rank 4 of the 8 slots, streams bitwise the meshless ones
               or held by the margin rule; (b) mesh (1, 1, 2), each rank
               16 of 32 heads and kv heads, half the ff columns and the
               vocabulary of base, bank and pools: the first chunk's
               logits within 10% of the largest logit, streams by the
               margin rule, the collectives equal to the dry run's
               prefill and decode walks at (1, 1, 2), each rank's peak
               beside the dry run's, the all-reduces' host ms beside the
               data sheet's NVLink time; (c) under (b), int8 K/V with the
               prefix cache, warm against cold by the margin rule; the
               three serving kernels launched on every rank in each case
               at the rank's shapes (those shapes are held in the kernels
               phase); decode tok/s and TTFT beside the meshless runs';
 12c. mesh_moe — experts over a torch.distributed mesh: dbrx-132b at full
               width, 2 of 40 layers (the script's time limit), bf16,
               random weights from
               --seed, 4 tenants' rank-16 fused adapters (the router's
               pair included), 8 requests (prompts 128-512 tokens, 16 new
               tokens); the meshless engine (1 and 2 shards) and rounds
               here, then one spawn of two ranks on this card (gloo):
               (a) mesh (1, 1, 2), each rank 24 of 48 heads, 4 of 8 kv
               heads, 8 of 16 experts (drawn shard by shard) and half the
               vocabulary and bank: routing bitwise equal on both ranks,
               the first chunk against the meshless chunk with each
               layer's expert ids pinned to the ranks' within 10% of the
               largest logit, dropped copies equal, routing flips held by
               the router-logit margin, streams by the margin rule, the
               collectives equal to the dry run's prefill and decode
               walks, peaks beside the dry run's, decode tok/s beside the
               rank's expert-read byte bound; (b) mesh (1, 2, 1),
               num_shards 2, each rank the whole base and 4 slots: the
               same first-chunk rule (capacity and slots of the fused
               batch), streams and collectives; (c) one FDLoRA round (2
               clients, K 1, 4 x 256 SFT rows a client) at (1, 1, 2) and
               (1, 2, 1) against the meshless round: bf16 at the phase's
               depth (loss and aux metric within 2%, θ_s''s worst leaf
               within 25% of its travel or, where larger, twice the worst
               leaf of the same meshless round on the plain path,
               collectives equal to the dry run's), fp32 at one layer
               (loss within 16 ulps, aux within 4, each leaf within 1e-3
               of its travel); its kernel lines
               (kernels phase) hold decode and prefill at H 24 over Kv 4,
               batched LoRA at each rank's wq, wk/wv and wo shards at 2,048
               and 8 rows, lora_matmul at the round's 1,024 rows and flash
               attention at B 4, H 24, Kv 4, S 256;
 12d. mesh_ssm — mamba layers over a torch.distributed mesh: mamba2-2.7b
               (8 of 64 layers) and jamba-v0.1-52b (8 of 32, one period)
               at full width, bf16, random weights from --seed, 4
               tenants' rank-16 fused adapters, 8 requests (prompts
               128-512 tokens, 16 new tokens); the meshless engines and
               rounds here, then one spawn of two ranks on this card
               (gloo): (a) mesh (1, 1, 2), both archs, each rank half the
               SSM heads and its heads' columns of every in_proj and conv
               segment: the first chunk within 10% of the largest logit
               (jamba's expert ids pinned to the ranks'), streams by the
               margin rule, collectives equal to the dry run's walks,
               peaks beside the dry run's, decode tok/s beside meshless;
               (b) mesh (1, 2, 1), num_shards 2, mamba2-2.7b: the same
               first-chunk and stream rules, every slot reset reading zero
               state on the rank that owns it; (c) one FDLoRA round (2
               clients, K 1, 4 x 256 rows) at model 2: jamba and mamba2 in
               bf16 by mesh_moe (c)'s rules, mamba2 in fp32 at one layer,
               in_proj's B and C columns bitwise equal on the ranks; its
               kernel lines (kernels phase) hold batched LoRA at both
               archs' in_proj shards (2560 -> 5416, 4096 -> 8288) at 2,048
               and 8 rows, lora_matmul there at 1,024 rows, and jamba's
               decode, prefill and flash attention at H 16 over Kv 4;
 12e. mesh_vlm_encdec — the VLM and the encoder-decoder over a
               torch.distributed mesh: internvl2-26b (4 of 48 layers) and
               whisper-small (12 + 12 layers) at full width, bf16, random
               weights from --seed, at mesh (1, 1, 2): each rank half the
               heads, kv heads and ff columns and the whole vocabulary
               (92,553 and 51,865 entries, which 2 does not divide);
               the meshless runs here, then one spawn of two ranks on
               this card (gloo): (a) internvl2 serving 8 text-only
               requests (prompts 128-512 tokens, 16 new) over 4 tenants'
               rank-16 fused adapters: the first chunk within 10% of the
               largest logit and bitwise equal on the ranks, streams by
               the margin rule, collectives equal to the dry run's walks;
               (b) internvl2 rounds (2 clients, K 1, 2 rows of 256 stub
               patches + 256 tokens): bf16 by mesh_moe (c)'s rules, fp32
               at one layer; (c) whisper-small: a train step of 8 x
               (1,500 frames + 256 tokens) against meshless, cross_attn
               wv's gradient exactly 0 on both ranks, rounds (bf16, fp32
               at 1 + 1 layers), prefill_cross and 32 greedy decode steps
               of 8 rows (first step by the first-chunk rule, streams by
               the margin rule, each rank's cross K/V half the meshless
               bytes); its kernel lines (kernels phase) hold batched LoRA
               at internvl2's w_gate/w_up and w_out shards at 2,048 and 8
               rows, lora_matmul there at 1,024 rows and at whisper's
               encoder shards at 12,000 rows, and non-causal flash
               attention at whisper's 6 heads over 1,500 frames;
 13. the card's name and power limit, the kernel summary line, and last the
     result line.

batched_dual_lora_matmul, which no path of the port (or of the reference
package) calls, is driven at its own entry point in the kernels phase, at
the serving shapes, and held against its plain version there.

Needs a CUDA device and the repository's src/ beside this file; exits
non-zero otherwise, and on any failed check.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ARCH = "llama2-7b"
# llama2-7b's layers (of 32) in the serve, serve_options, train, baselines
# and remat cells: the script's time limit (the card's host paces them)
LLAMA_LAYERS = 16


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class CheckFailed(RuntimeError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back runs (CUDA
    events around the run, after ``warmup`` runs)."""
    import torch
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


# kernels of the four LoRA kernels, by the part of the call they compute
# (their tile's name says which: lora_mma_* and the dual merge the
# tensor-core tile, the others the fp32 tile)
LORA_PARTS = (("lora_mma_dual_zprep_kernel", "z_prep"),
              ("lora_mma_dual_bprep_kernel", "b_prep"),
              ("lora_mma_dual_reduce_kernel", "split_k_reduce"),
              ("dual_lora_merge_kernel", "merge"),
              ("dual_lora_xa_kernel", "shrink"),
              ("dual_lora_xw_kernel", "tile"),
              ("batched_dual_xa_kernel", "shrink"),
              ("batched_dual_xw_kernel", "tile"),
              ("lora_mma_shrink_kernel", "shrink"),
              ("lora_mma_zprep_kernel", "z_prep"),
              ("lora_mma_bprep_kernel", "b_prep"),
              ("lora_mma_reduce_kernel", "split_k_reduce"),
              ("lora_mma_kernel", "tile"),
              ("lora_shrink_kernel", "shrink"),
              ("lora_matmul_kernel", "tile"),
              ("single_lora_xa_kernel", "shrink"),
              ("single_lora_xw_kernel", "tile"))


def device_ms(fn, reps: int, parts=()):
    """The kernel's own device time per call: every CUDA kernel's device
    time in a ``torch.profiler`` trace of ``reps`` back-to-back calls of
    ``fn``, over ``reps`` (the wrapper's host cost, which CUDA events
    around short calls read instead, is left out).  ``parts`` ((name
    substring, part), ...) splits it by kernel.  Returns (ms, {part: ms}).

    A trace now and then comes back with device events missing (seen on
    sub-millisecond windows), which lowers the sum: a trace counts only if
    it holds ``reps`` times the device events of a traced single call, and
    is taken again otherwise (``DEVICE_TRACE_RETAKES`` counts how often).
    A single call's trace can drop events too (its window is the
    shortest), never add them, so the count per call is the most any of
    the attempts' single-call traces held.  The losses fall at a trace's
    edges (on torch 2.11 the windowed prefill's traces each lost exactly
    one event, a single call's its only one, 8 times running), so each
    trace opens and closes with a spin kernel of its own, left out of the
    sums, and the calls measured sit inside."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def trace(n):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(EDGE_CYCLES)
            for _ in range(n):
                fn()
            torch.cuda._sleep(EDGE_CYCLES)
            torch.cuda.synchronize()
        return [ev for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA
                and "spin_kernel" not in ev.key]

    fn()
    torch.cuda.synchronize()
    per_call = 0
    for attempt in range(TRACE_ATTEMPTS):
        per_call = max(per_call, sum(ev.count for ev in trace(1)))
        evs = trace(reps)
        seen = sum(ev.count for ev in evs)
        if per_call > 0 and seen == reps * per_call:
            break
        DEVICE_TRACE_RETAKES.append({"events": seen, "per_call": per_call,
                                     "reps": reps})
    else:
        require(False, f"{TRACE_ATTEMPTS} profiler traces dropped device "
                       f"events: {DEVICE_TRACE_RETAKES[-TRACE_ATTEMPTS:]}")
    total, split = 0.0, {}
    for ev in evs:
        ms = (getattr(ev, "self_device_time_total", None)
              or getattr(ev, "self_cuda_time_total", 0)) / 1e3 / reps
        total += ms
        part = next((p for k, p in parts if k in ev.key), None)
        if part is not None:
            split[part] = split.get(part, 0.0) + ms
    require(total > 0, "the profiler saw no device time")
    return total, split


# traces of device_ms taken again because they lacked device events, and
# how many tries a measurement gets (one windowed prefill shape on an H100
# once lost events in 4 tries running; 5 traces of a whole run lost some)
DEVICE_TRACE_RETAKES = []
TRACE_ATTEMPTS = 8
EDGE_CYCLES = 20_000       # each edge kernel spins about 10 µs


def bound(bytes_moved: float, flops: float, fp32: bool = False):
    """(least ms, what sets it): bytes over the memory rate against
    operations over the bf16 tensor-core peak (``fp32``: the fp32 peak
    outside the tensor cores); the H100 data sheet's peaks, from
    ``repro_torch.analysis.roofline`` as the dry run reads them."""
    from repro_torch.analysis import roofline as rl
    t_bytes = bytes_moved / rl.HBM_BW * 1e3
    t_ops = flops / (rl.FP32_FLOPS if fp32 else rl.PEAK_FLOPS) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def _pools(gen, NB, bs, Kv, hd, device, int8: bool):
    import torch
    from repro_torch.kernels.quant import quantize_int8
    kf = torch.randn((NB, bs, Kv, hd), generator=gen, device=device)
    vf = torch.randn((NB, bs, Kv, hd), generator=gen, device=device)
    if not int8:
        return kf.to(torch.bfloat16), vf.to(torch.bfloat16), None, None
    kq, ks = quantize_int8(kf, dim=-1)
    vq, vs = quantize_int8(vf, dim=-1)
    return kq, vq, ks, vs


def _tables(gen, B, MB, device):
    """Disjoint block tables over blocks 1..B*MB (block 0 is scratch)."""
    import torch
    perm = torch.randperm(B * MB, generator=gen, device=device) + 1
    return perm.reshape(B, MB).to(torch.int32).contiguous()


def _bf16_tol(ref) -> float:
    """Two bf16 roundings of the largest output: both sides compute in
    fp32 from the same inputs and round once, in another summation order."""
    return float(ref.float().abs().max()) * 2.0 ** -7 + 1e-5


def _attn_tol(ref, v) -> float:
    """An attention kernel against its plain version.  bf16: two bf16
    roundings of the largest output, plus one bf16 rounding of the largest
    |v| (dequantized): the tensor-core tile rounds P (or P·v_scale) to bf16
    as its mma operand, as the TPU kernel does, where the plain version
    keeps P in fp32 (or rounds it after normalising); each output is a
    convex sum of v, so that rounding moves it by at most 2^-8·max|v|.
    fp32: the fp32 tile, summation order only, tight."""
    import torch
    top = float(ref.float().abs().max())
    if ref.dtype == torch.float32:
        return 2e-5 + 1e-5 * top
    return _bf16_tol(ref) + float(v.float().abs().max()) * 2.0 ** -8


def _tile_check(what, out, tile_ref):
    """A bf16 output of the tensor-core tile against its tile reference
    (``kernels/attn_tile.py``: the plain arithmetic rounding P where and as
    the tile does): every row within two bf16 ulps of its own largest
    output.  A fault confined to long rows (a dropped or stale key tile)
    moves those rows' small outputs far past that, where ``_attn_tol``,
    set by the largest output of the whole tensor, may not see it.
    Returns {"tile_max_abs_err", "tile_err_ratio"} (ratio <= 1 holds)."""
    from repro_torch.kernels.attn_tile import tile_errors
    err, ratio = tile_errors(out, tile_ref)
    require(ratio <= 1.0, f"{what}: a row is {ratio:.3g}x its bound of two "
            f"bf16 ulps off the tile reference (max abs err {err})")
    return {"tile_max_abs_err": err, "tile_err_ratio": ratio}


def _one_tile(name, fn, dtype):
    """Run ``fn`` once with the counts at 0 and require that kernel
    ``name`` launched the tile its dtype picks: mma for bf16, f32 for
    fp32.  Returns fn's result."""
    import torch
    from repro_torch import kernels
    kernels.reset_launch_counts()
    out = fn()
    tiles = kernels.tile_counts()[name]
    want = ({"mma": 1, "f32": 0} if dtype == torch.bfloat16
            else {"mma": 0, "f32": 1})
    require(tiles == want, f"{name} {dtype}: tiles launched {tiles}, not "
            f"{want}")
    return out


def _gathered(k_pool, v_pool, ks, vs, bt, H):
    """K/V gathered per row and expanded to H heads, (B, H, L, hd) bf16 —
    the library yardstick's input, prepared outside its timing."""
    from repro_torch.kernels.ref import _gather_pool
    Kv = k_pool.shape[2]
    k = _gather_pool(k_pool, ks, bt, H // Kv)
    v = _gather_pool(v_pool, vs, bt, H // Kv)
    return (k.permute(0, 2, 1, 3).contiguous(),
            v.permute(0, 2, 1, 3).contiguous())


# the decode kernel's two kernels, by the part of the call they compute
DECODE_PARTS = (("paged_decode_split_kernel", "split"),
                ("paged_decode_combine_kernel", "combine"))


def check_decode(gen, device, lengths, G, int8, reps, H=32, hd=128, bs=16,
                 window=0):
    """The split-K decode kernel against its plain version (bf16 q: two
    bf16 roundings of the largest output); its time (events and device),
    its device time by part (split, combine) and SPLIT with the live
    splits of each row (with a ``window``, whole splits below it drop
    out); SDPA over K/V gathered outside its timing, by events and by
    device time, as the library yardstick."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.kernels.paged_attention import (SPLIT, paged_attention,
                                                     paged_attention_ref)
    B = len(lengths)
    Kv = H // G
    MB = -(-max(lengths) // bs)
    kp, vp, ks, vs = _pools(gen, 1 + B * MB, bs, Kv, hd, device, int8)
    bt = _tables(gen, B, MB, device)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    q = torch.randn((B, H, hd), generator=gen, device=device).to(torch.bfloat16)

    def call():
        return paged_attention(q, kp, vp, bt, lens, k_scale=ks, v_scale=vs,
                               sliding_window=window)

    kernels.reset_launch_counts()
    out = call()
    f = paged_attention
    launched = {"calls": f.launches, "splits_per_row": f.launches_split,
                "combine": f.launches_combine}
    ref = paged_attention_ref(q, kp, vp, bt, lens, k_scale=ks, v_scale=vs,
                              sliding_window=window)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    tol = _bf16_tol(ref)
    what = f"paged_attention G={G} hd={hd} int8={int8} window={window}"
    require(bool(torch.isfinite(out.float()).all()), f"{what}: not finite")
    require(err <= tol, f"{what}: err {err} > {tol}")
    zero_rows = [i for i, n in enumerate(lengths) if n == 0]
    require(all(float(out[i].float().abs().max()) == 0.0 for i in zero_rows),
            f"{what}: an empty decode row is not zero")
    # each row's live splits, worked out from its length and the window
    # (not measured)
    row_splits = [-(-n // SPLIT) - (max(0, n - window) // SPLIT if window
                                    else 0) for n in lengths]
    want = {"calls": 1, "splits_per_row": -(-MB * bs // SPLIT),
            "combine": int(MB * bs > SPLIT)}
    require(launched == want, f"{what}: launched {launched}, not {want}")
    ms = time_ms(call, reps)
    dev_ms, parts = device_ms(call, reps, DECODE_PARTS)
    require(set(parts) == ({"split", "combine"} if want["combine"]
                           else {"split"}),
            f"{what}: device parts {sorted(parts)}")
    plain_ms = time_ms(lambda: paged_attention_ref(
        q, kp, vp, bt, lens, k_scale=ks, v_scale=vs, sliding_window=window),
        max(1, reps // 4), 1)
    kg, vg = _gathered(kp, vp, ks, vs, bt, H)
    kg, vg = kg.to(torch.bfloat16), vg.to(torch.bfloat16)
    L = kg.shape[2]
    k_pos = torch.arange(L, device=device)[None, :]
    mask = k_pos < lens[:, None]
    if window:
        mask &= k_pos >= lens[:, None] - window
    mask = mask[:, None, None, :]
    q4 = q[:, :, None, :]

    def library():
        return F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask)

    library_ms = time_ms(library, reps)
    library_device_ms, _ = device_ms(library, reps)
    # positions attended: the window's worth of each row
    ctx = int(sum(min(n, window) if window else n for n in lengths))
    kv_bytes = (1 if int8 else 2) * 2 * ctx * Kv * hd + (8 * ctx * Kv if int8
                                                          else 0)
    nbytes = kv_bytes + 2 * 2 * B * H * hd + 4 * B * (MB + 1)
    flops = 4 * hd * H * ctx
    b_ms, b_by = bound(nbytes, flops)
    return {"name": "paged_attention", "G": G, "kv": "int8" if int8 else "bf16",
            "B": B, "H": H, "hd": hd, "bs": bs, "window": window,
            "lengths": lengths,
            "split_len": SPLIT, "row_splits_from_lengths": row_splits,
            "launched": launched,
            "max_abs_err": err, "tol": tol, "ms": ms, "device_ms": dev_ms,
            "device_ms_by_part": parts, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_device_ms": library_device_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def check_prefill(gen, device, lengths, T, G, int8, reps, H=32, hd=128,
                  bs=16, dtype=None, window=0):
    """Tolerance: ``_attn_tol`` against the plain version (bf16 queries:
    the tensor-core tile, also held per row to its tile reference by
    ``_tile_check``; fp32: the fp32 tile, tight).  SDPA over K/V gathered
    outside its timing, by events and by device time, is the library
    yardstick."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.attn_tile import paged_prefill_tile_ref
    from repro_torch.kernels.paged_prefill import (paged_prefill_attention,
                                                   paged_prefill_attention_ref)
    dtype = dtype or torch.bfloat16
    B = len(lengths)
    Kv = H // G
    MB = -(-(max(lengths) + T) // bs)
    kp, vp, ks, vs = _pools(gen, 1 + B * MB, bs, Kv, hd, device, int8)
    bt = _tables(gen, B, MB, device)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    q = torch.randn((B, T, H, hd), generator=gen, device=device).to(dtype)
    kw = {"k_scale": ks, "v_scale": vs, "sliding_window": window}

    def call():
        return paged_prefill_attention(q, kp, vp, bt, lens, **kw)

    what = f"paged_prefill G={G} hd={hd} int8={int8} window={window}"
    out = _one_tile("paged_prefill_attention", call, dtype)
    ref = paged_prefill_attention_ref(q, kp, vp, bt, lens, **kw)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    tol = _attn_tol(ref, vp.float() * vs[..., None] if int8 else vp)
    require(bool(torch.isfinite(out.float()).all()),
            f"{what}: output not finite")
    require(err <= tol, f"{what} {dtype}: err {err} > {tol}")
    tile = {}
    if dtype == torch.bfloat16:
        tile = _tile_check(what, out, paged_prefill_tile_ref(
            q, kp, vp, bt, lens, **kw))
    ms = time_ms(call, reps)
    dev_ms, _ = device_ms(call, reps)
    plain_ms = time_ms(lambda: paged_prefill_attention_ref(
        q, kp, vp, bt, lens, **kw), max(1, reps // 4), 1)
    kg, vg = _gathered(kp, vp, ks, vs, bt, H)
    kg, vg = kg.to(dtype), vg.to(dtype)
    L = kg.shape[2]
    q_pos = lens[:, None] + torch.arange(T, device=device)[None, :]
    k_pos = torch.arange(L, device=device)[None, None, :]
    mask = k_pos <= q_pos[:, :, None]
    if window:
        mask &= k_pos > q_pos[:, :, None] - window
    mask = mask[:, None]
    qt = q.permute(0, 2, 1, 3).contiguous()

    def library():
        return F.scaled_dot_product_attention(qt, kg, vg, attn_mask=mask)

    library_ms = time_ms(library, reps)
    library_device_ms, _ = device_ms(library, reps)
    W = window or 1 << 30
    # positions read per row (from the first query's window start), and
    # (query, key) pairs attended
    ctx = sum(n + T - max(0, n - W + 1) for n in lengths)
    pairs = sum(min(n + t + 1, W) for n in lengths for t in range(T))
    kv_bytes = (1 if int8 else 2) * 2 * ctx * Kv * hd + (8 * ctx * Kv if int8
                                                          else 0)
    q_el = q.element_size()
    nbytes = kv_bytes + 2 * q_el * B * T * H * hd + 4 * B * (MB + 1)
    flops = 4 * hd * H * pairs
    b_ms, b_by = bound(nbytes, flops, fp32=dtype == torch.float32)
    return {"name": "paged_prefill_attention", "G": G,
            "kv": "int8" if int8 else "bf16",
            "q": "bf16" if dtype == torch.bfloat16 else "fp32",
            "tile": "mma" if dtype == torch.bfloat16 else "f32",
            "B": B, "T": T, "H": H,
            "hd": hd, "bs": bs, "window": window, "lengths": lengths,
            "max_abs_err": err, "tol": tol, **tile, "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_device_ms": library_device_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def _lora_tol(ref) -> float:
    """A LoRA kernel against its plain version: bf16, two bf16 roundings
    of the largest output (both compute in fp32 and round once, in another
    order); fp32 (the fp32 tile), 1e-4 + 1e-4·max|out|, the card tests'
    tolerance."""
    import torch
    if ref.dtype == torch.float32:
        return 1e-4 + 1e-4 * float(ref.abs().max())
    return _bf16_tol(ref)


def _lora_share(parts, dead_parts, total):
    """The shrink's and the epilogue's device ms and share of a call: the
    shrink, the LoRA operands' preparation, any split-K reduction, and the
    tile's time beyond the same tile with no live row (which then runs no
    LoRA stage): the expand z·B, the epilogue of the LoRA product."""
    epi = parts["tile"] - dead_parts["tile"]
    lora = epi + sum(parts.get(k, 0.0) for k in ("shrink", "z_prep", "b_prep",
                                                  "split_k_reduce"))
    return {"tile_without_lora_ms": dead_parts["tile"], "epilogue_ms": epi,
            "shrink_and_epilogue_ms": lora,
            "shrink_and_epilogue_share": lora / total}


def check_lora(gen, device, M, K, N, C, r, variant, reps, dtype=None,
               by_request=False, share=False, tail=False):
    """batched_lora_matmul against its plain version (``_lora_tol``): bf16
    activations run the tensor-core tile, fp32 ones (over the same bf16 W)
    the fp32 tile.  Every row draws its own client, so every tile mixes
    clients, unless ``by_request``: rows in runs of 256 per client, as a
    prefill dispatch lays them out.  ``share``: also the shrink's and the
    epilogue's share of the call's device time (``_lora_share``).
    ``tail``: also the error over the columns past the last multiple of
    256 (an N tail the tile's column guard must hold)."""
    import torch
    from repro_torch.kernels.batched_lora import (batched_lora_matmul,
                                                  batched_lora_matmul_ref)
    from repro_torch.kernels.quant import quantize_int8
    dtype = dtype or torch.bfloat16
    x = torch.randn((M, K), generator=gen, device=device).to(dtype)
    w = (torch.randn((K, N), generator=gen, device=device)
         * K ** -0.5).to(torch.bfloat16)
    a = torch.randn((C, K, r), generator=gen, device=device) / r
    b = torch.randn((C, r, N), generator=gen, device=device) * 0.02
    if by_request:
        ids = torch.randint(0, C, (-(-M // 256),), generator=gen,
                            device=device, dtype=torch.int32)
        ids = torch.repeat_interleave(ids, 256)[:M].contiguous()
    else:
        ids = torch.randint(0, C, (M,), generator=gen, device=device,
                            dtype=torch.int32)
    kw = {}
    if variant == "rank_mask":
        kw["ranks"] = torch.randint(1, r + 1, (C,), generator=gen,
                                    device=device, dtype=torch.int32)
    if variant == "int8_bank":
        a, sa = quantize_int8(a, dim=(1, 2))
        b, sb = quantize_int8(b, dim=(1, 2))
        kw.update(a_scale=sa.contiguous(), b_scale=sb.contiguous())
    scale = 2.0

    def call():
        return batched_lora_matmul(x, w, a, b, ids, scale, **kw)
    out = _one_tile("batched_lora_matmul", call, dtype)
    ref = batched_lora_matmul_ref(x, w, a, b, ids, scale, **kw)
    tol = _lora_tol(ref)
    err = _check_close(f"batched_lora {variant} M={M} {dtype}", out, ref, tol)
    extra = {}
    if tail:
        n0 = N // 256 * 256
        require(n0 < N, f"N {N} has no tail past a multiple of 256")
        extra["tail_columns"] = N - n0
        extra["tail_max_abs_err"] = _check_close(
            f"batched_lora N tail M={M} N={N}", out[:, n0:], ref[:, n0:], tol)
    ms = time_ms(call, reps)
    dev_ms, parts = device_ms(call, reps, LORA_PARTS)
    if share:
        dead = torch.full_like(ids, -1)
        _, dead_parts = device_ms(lambda: batched_lora_matmul(
            x, w, a, b, dead, scale, **kw), reps, LORA_PARTS)
        extra.update(_lora_share(parts, dead_parts, dev_ms))
    plain_ms = time_ms(lambda: batched_lora_matmul_ref(
        x, w, a, b, ids, scale, **kw), max(1, reps // 4), 1)
    library_ms = time_ms(lambda: torch.matmul(x, w.to(dtype)), reps)
    active = int(torch.unique(ids).numel())
    bank_el = 1 if variant == "int8_bank" else 4
    x_el = x.element_size()
    nbytes = (x_el * M * K + 2 * K * N + x_el * M * N + 4 * M
              + active * bank_el * r * (K + N))
    flops = 2 * M * K * N + 2 * M * r * (K + N)
    b_ms, b_by = bound(nbytes, flops, fp32=dtype == torch.float32)
    return {"name": "batched_lora_matmul", "variant": variant,
            "activations": "bf16" if dtype == torch.bfloat16 else "fp32",
            "tile": "mma" if dtype == torch.bfloat16 else "f32",
            "ids": "by_request" if by_request else "per_row", "M": M,
            "K": K, "N": N, "C": C, "r": r, "max_abs_err": err, "tol": tol,
            "ms": ms, "device_ms": dev_ms, "device_ms_by_part": parts,
            **extra, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def dual_inputs(gen, device, M, K, N, C, r):
    """Serving-shape inputs of batched_dual_lora_matmul: bf16 x and W, an
    fp32 personalized bank and global pair, per-row clients and fusion
    weights drawn in [-0.2, 1.2] (the reference test's range)."""
    import torch
    x = torch.randn((M, K), generator=gen, device=device).to(torch.bfloat16)
    w = (torch.randn((K, N), generator=gen, device=device)
         * K ** -0.5).to(torch.bfloat16)
    a1 = torch.randn((C, K, r), generator=gen, device=device) / r
    b1 = torch.randn((C, r, N), generator=gen, device=device) * 0.02
    a2 = torch.randn((K, r), generator=gen, device=device) / r
    b2 = torch.randn((r, N), generator=gen, device=device) * 0.02
    ids = torch.randint(0, C, (M,), generator=gen, device=device,
                        dtype=torch.int32)
    fw = torch.rand((M, 2), generator=gen, device=device) * 1.4 - 0.2
    return x, w, a1, b1, a2, b2, ids, fw


def check_dual_batched(inputs, out, reps):
    """batched_dual_lora_matmul's output ``out`` (from the entry-point run,
    bf16: the tensor-core tile) against its plain version, each row against
    the tile model (``_tile_check``), and rows sharing one (w1, w2) against
    batched_lora_matmul on the pre-merged bank; both to two bf16 roundings
    of the largest output."""
    import torch
    from repro_torch.kernels.batched_lora import (
        batched_dual_lora_matmul, batched_dual_lora_matmul_ref,
        batched_lora_matmul)
    from repro_torch.kernels.lora_tile import dual_split_plan_ref
    x, w, a1, b1, a2, b2, ids, fw = inputs
    M, K = x.shape
    N, (C, _, r) = w.shape[1], a1.shape
    scale = 2.0
    ref = batched_dual_lora_matmul_ref(x, w, a1, b1, a2, b2, ids, fw, scale)
    tol = _bf16_tol(ref)
    err = _check_close("batched_dual_lora_matmul", out, ref, tol)
    tile = _tile_check(f"batched_dual_lora_matmul M={M}", out,
                       dual_split_plan_ref(x, w, a1, b1, a2, b2, ids, fw,
                                           scale))
    # one shared (w1, w2): the Eq. 7 pre-merged bank through the plain
    # batched kernel
    w1, w2 = 0.7, 0.4
    fw1 = torch.tensor([[w1, w2]], device=x.device).expand(M, 2).contiguous()
    merged = batched_lora_matmul(x, w, (w1 * a1 + w2 * a2).contiguous(),
                                 (w1 * b1 + w2 * b2).contiguous(), ids, scale)
    shared_err = _check_close(
        "batched_dual_lora_matmul vs pre-merged batched_lora_matmul",
        batched_dual_lora_matmul(x, w, a1, b1, a2, b2, ids, fw1, scale),
        merged, _bf16_tol(merged))

    def call():
        return batched_dual_lora_matmul(x, w, a1, b1, a2, b2, ids, fw, scale)
    ms = time_ms(call, reps)
    dev_ms, parts = device_ms(call, reps, LORA_PARTS)
    plain_ms = time_ms(lambda: batched_dual_lora_matmul_ref(
        x, w, a1, b1, a2, b2, ids, fw, scale), max(1, reps // 4), 1)
    library_ms = time_ms(lambda: torch.matmul(x, w), reps)
    active = int(torch.unique(ids).numel())
    # x, W, the active clients' A1/B1 and the global pair read once, ids and
    # weights, y written
    nbytes = (2 * M * K + 2 * K * N + 4 * (active + 1) * r * (K + N)
              + 12 * M + 2 * M * N)
    # the base product plus both pairs' shrink and expand per row
    flops = 2 * M * K * N + 4 * M * r * (K + N)
    b_ms, b_by = bound(nbytes, flops)
    return {"name": "batched_dual_lora_matmul", "activations": "bf16",
            "tile": "mma", "M": M, "K": K, "N": N, "C": C, "r": r,
            "max_abs_err": err, "tol": tol, **tile,
            "shared_weights_vs_merged_err": shared_err, "ms": ms,
            "device_ms": dev_ms, "device_ms_by_part": parts,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def check_dual_batched_fp32(inputs, reps):
    """batched_dual_lora_matmul with fp32 activations over the same bf16
    W: the fp32 tile, held at 1e-4 + 1e-4·max|out| (``_lora_tol``)."""
    import torch
    from repro_torch.kernels.batched_lora import (
        batched_dual_lora_matmul, batched_dual_lora_matmul_ref)
    x, w, a1, b1, a2, b2, ids, fw = inputs
    x = x.float()
    M, K = x.shape
    N, r = w.shape[1], a1.shape[2]

    def call():
        return batched_dual_lora_matmul(x, w, a1, b1, a2, b2, ids, fw, 2.0)
    out = _one_tile("batched_dual_lora_matmul", call, torch.float32)
    ref = batched_dual_lora_matmul_ref(x, w, a1, b1, a2, b2, ids, fw, 2.0)
    tol = _lora_tol(ref)
    err = _check_close("batched_dual_lora_matmul fp32", out, ref, tol)
    ms = time_ms(call, reps)
    dev_ms, parts = device_ms(call, reps, LORA_PARTS)
    active = int(torch.unique(ids).numel())
    nbytes = (4 * M * K + 2 * K * N + 4 * (active + 1) * r * (K + N)
              + 12 * M + 4 * M * N)
    b_ms, b_by = bound(nbytes, 2 * M * K * N + 4 * M * r * (K + N),
                       fp32=True)
    return {"name": "batched_dual_lora_matmul", "activations": "fp32",
            "tile": "f32", "M": M, "K": K, "N": N, "r": r,
            "max_abs_err": err, "tol": tol, "ms": ms, "device_ms": dev_ms,
            "device_ms_by_part": parts, "bound_ms": b_ms, "bound_by": b_by}


def dual_entry_point(device, seed: int, reps: int, B: int, T: int):
    """batched_dual_lora_matmul at its own entry point (no path calls it):
    one call at the decode shape (B x 4096 x 4096) and one at the prefill
    shape (B*T x 4096 x 11008), C = 8, r = 16, with the launch counts set to
    0 just before and read just after; then each output is checked and the
    kernel timed.  Returns (prefill-shape result, launches)."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.batched_lora import batched_dual_lora_matmul
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    shapes = ((B, 4096, 4096), (B * T, 4096, 11008))
    inputs = [dual_inputs(gen, device, M, K, N, 8, 16) for M, K, N in shapes]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    outs = [batched_dual_lora_matmul(*inp, 2.0) for inp in inputs]
    torch.cuda.synchronize()
    launches = kernels.launch_counts()["batched_dual_lora_matmul"]
    require(launches == len(shapes),
            f"batched_dual_lora_matmul launched {launches} times, not "
            f"{len(shapes)}")
    require_mma_tile(kernels.tile_counts(), "batched_dual_lora_matmul",
                     "the batched dual-LoRA entry point")
    results = [check_dual_batched(inp, out, reps)
               for inp, out in zip(inputs, outs)]
    for res in results:
        emit(res)
    emit(check_dual_batched_fp32(inputs[-1], reps))
    return results[-1], launches


def _lora_inputs(gen, device, M, K, N, r):
    import torch
    x = torch.randn((M, K), generator=gen, device=device).to(torch.bfloat16)
    w = (torch.randn((K, N), generator=gen, device=device)
         * K ** -0.5).to(torch.bfloat16)
    a = torch.randn((K, r), generator=gen, device=device) / r
    b = torch.randn((r, N), generator=gen, device=device) * 0.02
    return x, w, a, b


def _check_close(name, out, ref, tol):
    import torch
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    require(bool(torch.isfinite(out.float()).all()), f"{name} output not finite")
    require(err <= tol, f"{name}: err {err} > {tol}")
    return err


def check_single_lora(gen, device, M, K, N, r, reps, dtype=None,
                      share=False):
    """lora_matmul at a training projection's shape, against its plain
    version (``_lora_tol``): bf16 activations run the tensor-core tile,
    fp32 ones (over the same bf16 W) the fp32 tile.  ``share``: the
    shrink's and the epilogue's share of the call's device time, the
    epilogue timed through batched_lora_matmul with one client, which runs
    the same tile code (ids 0 against ids -1)."""
    import torch
    from repro_torch.kernels.batched_lora import batched_lora_matmul
    from repro_torch.kernels.lora_matmul import lora_matmul, lora_matmul_ref
    dtype = dtype or torch.bfloat16
    x, w, a, b = _lora_inputs(gen, device, M, K, N, r)
    x = x.to(dtype)
    scale = 2.0
    ref = lora_matmul_ref(x, w, a, b, scale)
    tol = _lora_tol(ref)
    out = _one_tile("lora_matmul", lambda: lora_matmul(x, w, a, b, scale),
                    dtype)
    err = _check_close(f"lora_matmul {dtype}", out, ref, tol)
    ms = time_ms(lambda: lora_matmul(x, w, a, b, scale), reps)
    dev_ms, parts = device_ms(lambda: lora_matmul(x, w, a, b, scale), reps,
                              LORA_PARTS)
    extra = {}
    if share:
        one = torch.zeros((M,), dtype=torch.int32, device=device)
        _, live = device_ms(lambda: batched_lora_matmul(
            x, w, a[None], b[None], one, scale), reps, LORA_PARTS)
        _, dead = device_ms(lambda: batched_lora_matmul(
            x, w, a[None], b[None], one - 1, scale), reps, LORA_PARTS)
        extra = _lora_share(parts, {"tile": parts["tile"] - live["tile"]
                                    + dead["tile"]}, dev_ms)
    plain_ms = time_ms(lambda: lora_matmul_ref(x, w, a, b, scale),
                       max(1, reps // 4), 1)
    ab, bb, wd = a.to(x.dtype), b.to(x.dtype), w.to(x.dtype)
    library_ms = time_ms(lambda: torch.matmul(x, wd) + (x @ ab) @ bb, reps)
    # x, W in; A, B fp32 in; y out and z = x·A out (fp32)
    x_el = x.element_size()
    nbytes = (x_el * M * K + 2 * K * N + 4 * r * (K + N) + x_el * M * N
              + 4 * M * r)
    flops = 2 * M * K * N + 2 * M * r * (K + N)
    b_ms, b_by = bound(nbytes, flops, fp32=dtype == torch.float32)
    return {"name": "lora_matmul",
            "activations": "bf16" if dtype == torch.bfloat16 else "fp32",
            "tile": "mma" if dtype == torch.bfloat16 else "f32",
            "M": M, "K": K, "N": N, "r": r,
            "max_abs_err": err, "tol": tol, "ms": ms, "device_ms": dev_ms,
            "device_ms_by_part": parts, **extra, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by}


def check_dual_lora(gen, device, M, K, N, r, reps, dtype=None):
    """dual_lora_matmul at a fused evaluation's shape, fusion weights
    (0.6, 0.6), against its plain version (``_lora_tol``): bf16
    activations run the tensor-core tile and each row is also held to the
    tile model (``_tile_check``), fp32 ones (over the same bf16 W) the fp32
    tile."""
    import torch
    from repro_torch.kernels.dual_lora import (dual_lora_matmul,
                                               dual_lora_matmul_ref)
    from repro_torch.kernels.lora_tile import dual_split_plan_ref
    dtype = dtype or torch.bfloat16
    x, w, a1, b1 = _lora_inputs(gen, device, M, K, N, r)
    x = x.to(dtype)
    a2 = torch.randn((K, r), generator=gen, device=device) / r
    b2 = torch.randn((r, N), generator=gen, device=device) * 0.02
    fw = torch.tensor([0.6, 0.6], device=device)
    scale = 2.0

    def call():
        return dual_lora_matmul(x, w, a1, b1, a2, b2, fw, scale)
    ref = dual_lora_matmul_ref(x, w, a1, b1, a2, b2, fw[0], fw[1], scale)
    tol = _lora_tol(ref)
    out = _one_tile("dual_lora_matmul", call, dtype)
    err = _check_close(f"dual_lora_matmul {dtype}", out, ref, tol)
    tile = {}
    if dtype == torch.bfloat16:
        tile = _tile_check(f"dual_lora_matmul {M}x{K}x{N}", out,
                           dual_split_plan_ref(x, w, a1, b1, a2, b2, None,
                                               fw, scale))
    ms = time_ms(call, reps)
    dev_ms, parts = device_ms(call, reps, LORA_PARTS)
    plain_ms = time_ms(lambda: dual_lora_matmul_ref(
        x, w, a1, b1, a2, b2, fw[0], fw[1], scale), max(1, reps // 4), 1)
    am = (0.6 * a1 + 0.6 * a2).to(x.dtype)     # merged outside the timing
    bm = (0.6 * b1 + 0.6 * b2).to(x.dtype)
    wd = w.to(x.dtype)
    library_ms = time_ms(lambda: torch.matmul(x, wd) + (x @ am) @ bm, reps)
    x_el = x.element_size()
    nbytes = (x_el * M * K + 2 * K * N + 8 * r * (K + N) + 8
              + x_el * M * N)
    flops = 2 * M * K * N + 2 * M * r * (K + N) + 3 * r * (K + N)
    b_ms, b_by = bound(nbytes, flops, fp32=dtype == torch.float32)
    return {"name": "dual_lora_matmul",
            "activations": "bf16" if dtype == torch.bfloat16 else "fp32",
            "tile": "mma" if dtype == torch.bfloat16 else "f32",
            "M": M, "K": K, "N": N, "r": r,
            "max_abs_err": err, "tol": tol, **tile, "ms": ms,
            "device_ms": dev_ms, "device_ms_by_part": parts,
            "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by}


def check_flash(gen, device, B, H, Kv, Sq, Sk, d, window, reps, dtype=None,
                causal=True):
    """flash_attention on model-layout (B, S, heads, d) tensors read through
    strided views, as the training forward calls it (``causal=False``: an
    encoder's or a cross-attention's, every key attended).  Tolerance:
    ``_attn_tol`` against the plain version (bf16: the tensor-core tile
    and the plain version each round the probabilities to bf16, at other
    points, and ``_tile_check`` holds each row to the tile reference;
    fp32: tight)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.attn_tile import flash_attention_tile_ref
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    dtype = dtype or torch.bfloat16
    q = torch.randn((B, Sq, H, d), generator=gen, device=device).to(
        dtype).transpose(1, 2)
    k, v = (torch.randn((B, Sk, Kv, d), generator=gen, device=device).to(
        dtype).transpose(1, 2) for _ in range(2))
    kw = {"causal": causal, "sliding_window": window}
    ref = flash_attention_ref(q, k, v, **kw)
    tol = _attn_tol(ref, v)
    out = _one_tile("flash_attention", lambda: flash_attention(q, k, v, **kw),
                    dtype)
    err = _check_close(f"flash_attention {dtype}", out, ref, tol)
    tile = {}
    if dtype == torch.bfloat16:
        tile = _tile_check(f"flash_attention causal={causal} window={window} "
                           f"Sq={Sq} Sk={Sk} Kv={Kv}", out,
                           flash_attention_tile_ref(q, k, v, **kw))
    ms = time_ms(lambda: flash_attention(q, k, v, **kw), reps)
    dev_ms, _ = device_ms(lambda: flash_attention(q, k, v, **kw), reps)
    plain_ms = time_ms(lambda: flash_attention_ref(q, k, v, **kw),
                       max(1, reps // 4), 1)
    # yardstick: SDPA on contiguous (B, H, S, d) with kv heads repeated and
    # the end-aligned mask built outside the timing
    qc = q.contiguous()
    kc, vc = (torch.repeat_interleave(t, H // Kv, dim=1).contiguous()
              for t in (k, v))
    q_pos = torch.arange(Sq, device=device) + (Sk - Sq)
    k_pos = torch.arange(Sk, device=device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    if not causal and window == 0:
        def library():
            return F.scaled_dot_product_attention(qc, kc, vc)
    elif Sq == Sk and window == 0:
        def library():
            return F.scaled_dot_product_attention(qc, kc, vc, is_causal=True)
    else:
        def library():
            return F.scaled_dot_product_attention(qc, kc, vc, attn_mask=mask)
    library_ms = time_ms(library, reps)
    library_device_ms, _ = device_ms(library, reps)
    pairs = int(mask.sum())
    nbytes = q.element_size() * (2 * B * H * Sq * d + 2 * B * Kv * Sk * d)
    flops = 4 * d * pairs * B * H
    b_ms, b_by = bound(nbytes, flops, fp32=dtype == torch.float32)
    return {"name": "flash_attention",
            "dtype": "bf16" if dtype == torch.bfloat16 else "fp32",
            "tile": "mma" if dtype == torch.bfloat16 else "f32",
            "B": B, "H": H, "Kv": Kv, "Sq": Sq,
            "Sk": Sk, "d": d, "causal": causal, "window": window,
            "max_abs_err": err,
            "tol": tol, **tile, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_device_ms": library_device_ms, "bound_ms": b_ms,
            "bound_by": b_by}


def check_backwards(gen, device):
    """The two autograd functions against plain autograd through the plain
    versions, fp32, on a small shape: the forwards differ in summation order
    only and the backwards are plain PyTorch, so gradients agree to 1e-4."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.lora_matmul import lora_matmul, lora_matmul_ref
    out = {"phase": "backward", "tol": 1e-4}
    M, K, N, r = 256, 512, 384, 16
    w = torch.randn((K, N), generator=gen, device=device) * K ** -0.5
    leaves = [torch.randn(s, generator=gen, device=device) * sd
              for s, sd in (((M, K), 1.0), ((K, r), 1.0 / r), ((r, N), 0.02))]
    dy = torch.randn((M, N), generator=gen, device=device)
    qkv = [torch.randn((2, h, 128, 64), generator=gen, device=device)
           for h in (8, 2, 2)]
    do = torch.randn((2, 8, 128, 64), generator=gen, device=device)
    for name, fns, inputs, g_out in (
            ("lora_matmul", (lambda x, a, b: lora_matmul(x, w, a, b, 2.0),
                             lambda x, a, b: lora_matmul_ref(x, w, a, b, 2.0)),
             leaves, dy),
            ("flash_attention", (
                lambda q, k, v: flash_attention(q, k, v, sliding_window=40),
                lambda q, k, v: flash_attention_ref(q, k, v,
                                                    sliding_window=40)),
             qkv, do)):
        grads = []
        for fn in fns:
            ts = [t.clone().requires_grad_(True) for t in inputs]
            grads.append(torch.autograd.grad(fn(*ts), ts, g_out))
        err = max(float((g - gr).abs().max() / gr.abs().max().clamp(min=1e-30))
                  for g, gr in zip(*grads))
        out[f"{name}_max_rel_grad_err"] = err
        require(err <= 1e-4, f"{name} backward: rel err {err} > 1e-4")
    emit(out)


def training_kernels(device, seed: int, reps: int, registers=None):
    """The training path's kernels, and ``lora_matmul`` at the fixed
    path's decode rows (``registers``: ptxas's count per kernel of
    lora_matmul.cu); returns {name: main-shape result}."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    main = {}
    for K, N in ((4096, 11008), (4096, 4096)):
        res = check_single_lora(gen, device, 2048, K, N, 16, reps,
                                share=(K, N) == (4096, 11008))
        emit(res)
        main.setdefault("lora_matmul", res)
        res = check_dual_lora(gen, device, 2048, K, N, 16, reps)
        emit(res)
        main.setdefault("dual_lora_matmul", res)
    for H, Kv, Sq, Sk, window in ((32, 32, 256, 256, 0), (32, 32, 256, 256, 64),
                                  (32, 32, 128, 256, 0), (32, 8, 256, 256, 0)):
        res = check_flash(gen, device, 8, H, Kv, Sq, Sk, 128, window, reps)
        emit(res)
        main.setdefault("flash_attention", res)
    # gemma-2b's shape: head dim 256, 8 query heads over one kv head
    emit(check_flash(gen, device, 8, 8, 1, 256, 256, 256, 0, reps))
    # gemma-2b's train step (phase dense_family): a 2048-row batch through
    # each of its projections
    for K, N in projection_shapes("gemma-2b"):
        emit({**check_single_lora(gen, device, 2048, K, N, 16, reps),
              "arch": "gemma-2b"})
    # the baselines' ranks (phase baselines): FedKD's student at r/2 = 8 (a
    # partial 16-wide rank group of the tensor-core tile), FedRoD's
    # concatenated pair at 2r = 32 (two groups)
    for r in (8, 32):
        emit({**check_single_lora(gen, device, 2048, 4096, 11008, r, reps),
              "path": "baselines"})
    # the single-tenant engine's decode rows (phase fixed): 8 rows through
    # llama2-7b's projections, the tile's split-K plan
    for K, N in ((4096, 4096), (4096, 11008), (11008, 4096)):
        emit({**check_single_lora(gen, device, 8, K, N, 16, reps),
              "path": "fixed", "registers": registers})
    # the "model" axis at 2 (phase mesh_round (d)): each rank's shard of
    # llama2-7b's projections (w_gate/w_up, w_out, wq/wk/wv, wo) and its
    # 16 of 32 heads
    for K, N in ((4096, 5504), (5504, 4096), (4096, 2048), (2048, 4096)):
        emit({**check_single_lora(gen, device, 2048, K, N, 16, reps),
              "path": "mesh_round (d)"})
    emit({**check_flash(gen, device, 8, 16, 16, 256, 256, 128, 0, reps),
          "path": "mesh_round (d)"})
    # fp32 at the main shape: the fp32 tile, held tight
    emit(check_flash(gen, device, 8, 32, 32, 256, 256, 128, 0, reps,
                     dtype=torch.float32))
    check_backwards(gen, device)
    # fp32 activations through lora_matmul and dual_lora_matmul: the fp32
    # tile, held tight
    emit(check_single_lora(gen, device, 2048, 4096, 11008, 16, reps,
                           dtype=torch.float32))
    emit(check_dual_lora(gen, device, 2048, 4096, 11008, 16, reps,
                         dtype=torch.float32))
    return main


def kernel_phase(device, seed: int, reps: int, main_lengths, T: int):
    """Every kernel in every variant; returns {name: main-shape result}."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    main = {}
    # decode rows as in the serving run (context + the step), one empty row
    dec_lengths = [0] + [n + 1 for n in main_lengths[1:]]
    for G in (1, 4):
        for int8 in (False, True):
            res = check_decode(gen, device, dec_lengths, G, int8, reps)
            emit(res)
            if G == 1 and not int8:
                main["paged_attention"] = res
    # the main decode shape must have run several splits of a row: the
    # combine kernel launched (its counter) and took device time (its trace)
    dec = main["paged_attention"]
    require(dec["launched"]["combine"] == 1
            and dec["device_ms_by_part"].get("combine", 0.0) > 0,
            f"the main decode shape ran one split per row: launched "
            f"{dec['launched']}, device parts {dec['device_ms_by_part']}")
    # gemma-2b's decode shape (G 8, head dim 256) and starcoder2-15b's
    # (G 12, head dim 128), at the same lengths
    emit(check_decode(gen, device, dec_lengths, 8, False, reps, H=8, hd=256))
    emit(check_decode(gen, device, dec_lengths, 12, False, reps, H=48))
    # yi-6b's (G 8, head dim 128)
    emit(check_decode(gen, device, dec_lengths, 8, False, reps, H=32))
    # prefill: a chunk of T behind ragged earlier context, one fresh row
    pre_lengths = [0] + [min(n, 768) for n in main_lengths[1:]]
    for G in (1, 4):
        for int8 in (False, True):
            res = check_prefill(gen, device, pre_lengths, T, G, int8, reps)
            emit(res)
            if G == 1 and not int8:
                main["paged_prefill_attention"] = res
    # fp32 queries (the fp32 tile, held tight) over both pool types
    for int8 in (False, True):
        emit(check_prefill(gen, device, pre_lengths, T, 1, int8, reps,
                           dtype=torch.float32))
    # gemma-2b's prefill shape: head dim 256, G 8 over one kv head; yi-6b's
    # (G 8, head dim 128)
    for int8 in (False, True):
        emit(check_prefill(gen, device, pre_lengths, T, 8, int8, reps, H=8,
                           hd=256))
    emit(check_prefill(gen, device, pre_lengths, T, 8, False, reps, H=32))
    # starcoder2-15b's shapes (G 12, hd 128) under its 4096-token window,
    # contexts to 6144: the window binds in the long rows, and whole
    # decode splits below it drop out
    win_dec = [0, 1000, 2048, 4095, 4097, 4500, 5000, 6144]
    res = check_decode(gen, device, win_dec, 12, False, reps, H=48,
                       window=4096)
    require(res["launched"]["combine"] == 1,
            "the windowed decode shape ran one split per row")
    emit(res)
    win_pre = [0, 1000, 3900, 4200, 5000, 6144 - T]
    emit(check_prefill(gen, device, win_pre, T, 12, False, reps, H=48,
                       window=4096))
    B = len(main_lengths)
    for M, K, N in ((B, 4096, 4096), (B * T, 4096, 11008)):
        for variant in ("f32_bank", "rank_mask", "int8_bank"):
            main_row = M == B * T and variant == "f32_bank"
            res = check_lora(gen, device, M, K, N, 8, 16, variant, reps,
                             share=main_row)
            emit(res)
            if main_row:
                main["batched_lora_matmul"] = res
    # the prefill shape with rows in runs of one client per request, as a
    # dispatch lays them out; fp32 activations (the fp32 tile, held tight)
    emit(check_lora(gen, device, B * T, 4096, 11008, 8, 16, "f32_bank", reps,
                    by_request=True, share=True))
    emit(check_lora(gen, device, B * T, 4096, 11008, 8, 16, "f32_bank", reps,
                    dtype=torch.float32))
    # the other dense archs' projections at phase dense_family's rows (a
    # decode step: one row per request; a prefill dispatch: T per request)
    # over its 4 tenants: every variant at gemma-2b's and starcoder2-15b's
    # shapes, the served fp32 bank at olmo-1b's and yi-6b's shapes not held
    # above
    seen = {(4096, 4096), (4096, 11008)}
    for arch in DENSE_FAMILY:
        rows = dense_requests(arch)
        variants = (("f32_bank", "rank_mask", "int8_bank")
                    if arch in ("gemma-2b", "starcoder2-15b")
                    else ("f32_bank",))
        for K, N in projection_shapes(arch):
            if (K, N) in seen:
                continue
            seen.add((K, N))
            for M in (rows, rows * T):
                for variant in variants:
                    emit({**check_lora(gen, device, M, K, N, DENSE_TENANTS,
                                       16, variant, reps), "arch": arch})
    moe_kernels(gen, device, reps, dec_lengths, pre_lengths, T, seen)
    ssm_kernels(gen, device, reps, T, seen)
    vlm_encdec_kernels(gen, device, reps, T, seen)
    mesh_serve_kernels(gen, device, reps, dec_lengths, pre_lengths, T)
    mesh_moe_kernels(gen, device, reps, dec_lengths, pre_lengths, T)
    mesh_ssm_kernels(gen, device, reps, dec_lengths, pre_lengths, T)
    mesh_vlm_encdec_kernels(gen, device, reps, T)
    return main


def mesh_serve_kernels(gen, device, reps, dec_lengths, pre_lengths, T):
    """Phase mesh_serve (b)'s per-rank shapes at "model" 2: llama2-7b's
    16 of 32 query heads over 16 of 32 kv heads (G 1) in decode and
    prefill at the serve cell's lengths, and batched LoRA at each rank's
    projections (wq/wk/wv 4096 -> 2048, w_gate/w_up 4096 -> 5504, w_out
    5504 -> 4096, wo 2048 -> 4096) at a decode step's 8 rows and a
    prefill chunk's 8 x T, over the phase's 8 tenants."""
    path = {"path": "mesh_serve (b)", "model_axis": 2}
    emit({**check_decode(gen, device, dec_lengths, 1, False, reps, H=16),
          **path})
    emit({**check_prefill(gen, device, pre_lengths, T, 1, False, reps,
                          H=16), **path})
    B = len(dec_lengths)
    for K, N in ((4096, 2048), (4096, 5504), (5504, 4096), (2048, 4096)):
        for M in (B, B * T):
            emit({**check_lora(gen, device, M, K, N, 8, 16, "f32_bank",
                               reps), **path})


def moe_kernels(gen, device, reps, dec_lengths, pre_lengths, T, seen):
    """The MoE archs' attention projections (the only ones batched LoRA
    runs there) not in ``seen``, at phase moe's rows over its 4 tenants,
    and dbrx-132b's attention (H 48 over Kv 8: G 6, a group count no other
    cell runs) at the serve cell's decode and prefill lengths."""
    for arch, _ in MOE_FAMILY:
        for K, N in projection_shapes(arch):
            if (K, N) in seen:
                continue
            seen.add((K, N))
            for M in (MOE_REQUESTS, MOE_REQUESTS * T):
                emit({**check_lora(gen, device, M, K, N, MOE_TENANTS, 16,
                                   "f32_bank", reps), "arch": arch})
    emit({**check_decode(gen, device, dec_lengths, 6, False, reps, H=48),
          "arch": "dbrx-132b"})
    emit({**check_prefill(gen, device, pre_lengths, T, 6, False, reps, H=48),
          "arch": "dbrx-132b"})


# ---------------------------------------------------------------------------
# phase 3: the serving path
# ---------------------------------------------------------------------------

def first_chunk_logits(eng, reqs, sc, backend, rows=None):
    """Logits of the first prefill dispatch the engine would make for
    ``reqs`` (all slots admitted, fresh pool of ``sc.kv_dtype``, the
    registry's bank in ``backend``'s layout), through ``backend``
    (``launch/serve.first_chunk_logits``; ``rows``: those rows alone)."""
    import dataclasses
    from repro_torch.launch import serve
    return serve.first_chunk_logits(
        eng, reqs, dataclasses.replace(sc, paged_backend=backend), rows)


def compare_first_chunk(eng, reqs, sc, dtype_name, rel_tol, extra=None):
    """First prefill chunk through "cuda" and "torch" on fresh pools: the
    max logit error must stay within ``rel_tol`` of the largest logit, and
    each row's greedy token must agree wherever the torch path's top-2
    margin exceeds twice that error.  The "cuda" chunk must run
    batched_lora_matmul on the tile its activations pick: the tensor-core
    tile for bf16, the fp32 tile for fp32."""
    import torch
    from repro_torch import kernels
    kernels.reset_launch_counts()
    lc, n_new = first_chunk_logits(eng, reqs, sc, "cuda")
    lora_tiles = kernels.tile_counts()["batched_lora_matmul"]
    lt, _ = first_chunk_logits(eng, reqs, sc, "torch")
    valid = (torch.arange(lc.shape[1], device=lc.device)[None, :]
             < n_new.to(lc.device)[:, None])
    err = float((lc - lt).abs()[valid].max())
    scale = float(lt.abs()[valid].max())
    tol = rel_tol * scale
    rows = torch.arange(lc.shape[0], device=lc.device)
    last = n_new.to(lc.device).long() - 1
    top2 = torch.topk(lt[rows, last], 2, dim=-1).values
    decisive = (top2[:, 0] - top2[:, 1]) > 2 * err
    agree = lc[rows, last].argmax(-1) == lt[rows, last].argmax(-1)
    emit({"phase": "compare", "activations": dtype_name,
          "first_chunk_max_abs_logit_err": err, "max_abs_logit": scale,
          "tol": tol, "first_token_agree": int(agree.sum()),
          "rows": int(rows.numel()), "decisive_rows": int(decisive.sum()),
          "lora_tiles_cuda": lora_tiles, **(extra or {})})
    want, other = (("mma", "f32") if dtype_name == "bfloat16"
                   else ("f32", "mma"))
    require(lora_tiles[want] > 0 and lora_tiles[other] == 0,
            f"{dtype_name} first chunk: batched_lora_matmul tiles "
            f"{lora_tiles}, not only {want}")
    require(bool(torch.isfinite(lc).all()), "cuda logits not finite")
    require(err <= tol, f"{dtype_name} first-chunk logit error {err} > {tol}")
    require(bool(agree[decisive].all()),
            "greedy token differs on a row whose margin exceeds the error")
    return err


def require_mma_tile(tiles, name, what):
    """A bf16 run: kernel ``name`` ran its tensor-core tile, never its fp32
    tile."""
    t = tiles[name]
    require(t["mma"] > 0 and t["f32"] == 0,
            f"{what}: {name} tiles {t}; a bf16 run must launch the "
            "tensor-core tile and not the fp32 one")


def serve_phase(device, seed: int, n_requests: int, new_tokens: int,
                prompt_min: int, prompt_max: int, T: int, cfg=None,
                tenants: int = 8, rank: int = 16):
    """Returns (launch counts of the overlapped "cuda" run, the
    engine)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (build_engine, ragged_requests,
                                          timed_stream)
    from repro_torch.serving.engine import ServeConfig
    cfg = cfg or get_config(ARCH)
    t0 = time.perf_counter()
    eng = build_engine(cfg, tenants, device, seed, rank=rank)
    torch.cuda.synchronize()
    emit({"phase": "model", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "params": cfg.count_params(),
          "dtype": cfg.dtype, "tenants": tenants, "rank": rank,
          "init_s": time.perf_counter() - t0,
          "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9})
    reqs = ragged_requests(n_requests, tenants, cfg.vocab_size, prompt_min,
                           prompt_max, seed)
    sc = ServeConfig(batch_size=n_requests, max_new_tokens=new_tokens,
                     prefill_chunk=T, block_size=16, paged_backend="cuda")
    # warm-up on two short requests (cuBLAS handles, allocator)
    eng.generate(ragged_requests(2, tenants, cfg.vocab_size, 8, 16, seed + 1),
                 ServeConfig(batch_size=2, max_new_tokens=2, prefill_chunk=8,
                             paged_backend="cuda"))
    results = {}
    # the "cuda" path with overlapped dispatch (the default) and with the
    # synchronous loop, in turns (on, off, off, on: neither side always runs
    # first), then the plain "torch" path
    runs = [("cuda", True), ("cuda", False), ("cuda", False), ("cuda", True),
            ("torch", True)]
    for i, (backend, overlap) in enumerate(runs):
        sc.paged_backend, sc.overlap = backend, overlap
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        outs, ttft, dec_s, dec_tok, total_s = timed_stream(eng, reqs, sc)
        counts = kernels.launch_counts()
        tiles = kernels.tile_counts()
        st = eng.last_stats
        results.setdefault((backend, overlap), (outs, counts, tiles))
        require(outs == results[backend, overlap][0],
                f"serve: two {backend} runs with overlap={overlap} differ")
        emit({"phase": "serve", "backend": backend, "overlap": overlap,
              "turn": runs[:i + 1].count((backend, overlap)),
              "requests": len(reqs),
              "prompt_lens": [len(r.prompt) for r in reqs],
              "new_tokens": new_tokens, "prefill_chunk": T,
              "tokens": sum(len(o) for o in outs),
              "ttft_ms_p50": float(np.percentile(ttft, 50)) * 1e3,
              "ttft_ms_max": max(ttft) * 1e3,
              "decode_tokens": dec_tok, "decode_s": dec_s,
              "decode_tok_per_s": dec_tok / dec_s if dec_s > 0 else None,
              "total_s": total_s,
              "prefill_dispatches": st["prefill_dispatches"],
              "decode_dispatches": st["decode_dispatches"],
              "deferred_chunks": st["deferred_chunks"],
              "preemptions": st["preemptions"], "launches": counts,
              "tile_launches": tiles,
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
        for o in outs:
            require(len(o) == new_tokens and all(0 <= t < cfg.vocab_size
                                                 for t in o),
                    f"{backend}: a stream is malformed")
    cuda_counts = results["cuda", True][1]
    for name in kernels.SERVING:
        require(cuda_counts[name] > 0,
                f"kernel {name} was never launched on the serving path")
    for overlap in (True, False):
        for name in ("paged_prefill_attention", "batched_lora_matmul"):
            require_mma_tile(results["cuda", overlap][2], name,
                             f"serve overlap={overlap}")
    require(all(n == 0 for n in results["torch", True][1].values()),
            "the torch backend launched a CUDA kernel")
    # the same dispatches on the same inputs: bitwise equal streams
    require(results["cuda", True][0] == results["cuda", False][0],
            "serve: streams with overlap on and off differ")

    streams_c, streams_t = results["cuda", True][0], results["torch", True][0]
    matched = [next((i for i, (a, b) in enumerate(zip(c, t)) if a != b),
                    len(c)) for c, t in zip(streams_c, streams_t)]
    # bf16: the two paths round activations at different places (the LoRA
    # epilogue rounds once where the torch path rounds twice; the attention
    # tile rounds unnormalised probabilities where the torch path rounds
    # normalised ones), 224 projections deep.  The bound is a sanity bound:
    # a wrong mask or a lost LoRA term moves logits by O(their largest
    # value).
    compare_first_chunk(
        eng, reqs, sc, "bfloat16", rel_tol=0.1,
        extra={"stream_prefix_matched": matched,
               "stream_tokens_agree_fraction":
                   sum(matched) / sum(len(c) for c in streams_c)})
    # fp32 activations over the same bf16 weights: the paths differ in
    # summation order only, except that K/V are stored in bf16 pools, where
    # that order noise now and then flips a rounding by one bf16 ulp; 32
    # layers carry those flips to the logits (bring-up runs on an H100:
    # 0.23% of the largest logit), so the bound is 1%
    from repro_torch.models.api import Model
    from repro_torch.serving.engine import MultiTenantEngine
    cfg32 = cfg.with_overrides(dtype="float32")
    eng32 = MultiTenantEngine(Model(cfg32, device), cfg32, eng.params,
                              eng.registry)
    compare_first_chunk(eng32, reqs, sc, "float32", rel_tol=1e-2)
    for i, overlap in enumerate((True, False, False, True)):
        profile_phase(eng, reqs, dataclasses.replace(sc, overlap=overlap),
                      check=i == 0)
    return cuda_counts, eng


KERNEL_FAMILIES = (("paged_decode_split_kernel", "paged_attention (split)"),
                   ("paged_decode_combine_kernel",
                    "paged_attention (combine)"),
                   ("paged_prefill_mma_kernel",
                    "paged_prefill_attention (tensor-core tile)"),
                   ("paged_prefill_kernel",
                    "paged_prefill_attention (fp32 tile)"),
                   ("lora_mma_shrink_kernel", "batched_lora_matmul (shrink)"),
                   ("lora_mma_zprep_kernel",
                    "batched_lora_matmul (z operand prep)"),
                   ("lora_mma_bprep_kernel",
                    "batched_lora_matmul (B operand prep)"),
                   ("lora_mma_reduce_kernel",
                    "batched_lora_matmul (split-K reduction + epilogue)"),
                   ("lora_mma_kernel",
                    "batched_lora_matmul (tensor-core tile + LoRA stages)"),
                   ("lora_matmul_kernel",
                    "batched_lora_matmul (fp32 tile + epilogue)"),
                   ("lora_shrink_kernel", "batched_lora_matmul (fp32 shrink)"))
TRAIN_FAMILIES = (("lora_mma_shrink_kernel", "lora_matmul (shrink)"),
                  ("lora_mma_zprep_kernel", "lora_matmul (z operand prep)"),
                  ("lora_mma_bprep_kernel", "lora_matmul (B operand prep)"),
                  ("lora_mma_reduce_kernel",
                   "lora_matmul (split-K reduction + epilogue)"),
                  ("lora_mma_kernel",
                   "lora_matmul (tensor-core tile + LoRA stages)"),
                  ("single_lora_xw_kernel", "lora_matmul (fp32 tile + epilogue)"),
                  ("single_lora_xa_kernel", "lora_matmul (fp32 shrink)"),
                  ("flash_attn_mma_kernel",
                   "flash_attention (tensor-core tile)"),
                  ("flash_attn_fwd_kernel", "flash_attention (fp32 tile)"),
                  ("dual_lora_", "dual_lora_matmul"),
                  *((k, "cuBLAS matmuls (plain backward, lm_head)")
                    for k in ("gemm", "nvjet", "xmma", "cutlass")))
# a bf16 fused evaluation runs dual_lora_matmul for every projection, so
# the LoRA tile's kernels there are its parts
FUSED_EVAL_FAMILIES = (("dual_lora_merge_kernel",
                        "dual_lora_matmul (pair merge)"),
                       ("lora_mma_shrink_kernel", "dual_lora_matmul (shrink)"),
                       ("lora_mma_zprep_kernel",
                        "dual_lora_matmul (z operand prep)"),
                       ("lora_mma_bprep_kernel",
                        "dual_lora_matmul (B operand prep)"),
                       ("lora_mma_reduce_kernel",
                        "dual_lora_matmul (split-K reduction + epilogue)"),
                       ("lora_mma_kernel",
                        "dual_lora_matmul (tensor-core tile + LoRA stages)"),
                       ("flash_attn_mma_kernel",
                        "flash_attention (tensor-core tile)"),
                       *((k, "cuBLAS matmuls (lm_head)")
                         for k in ("gemm", "nvjet", "xmma", "cutlass")))


def traced(fn, families, other: str, check: bool = False, ranges=()):
    """Run ``fn`` once under ``torch.profiler`` (CPU + CUDA activity);
    returns (wall ms, {family: device ms}) with kernels sorted into
    ``families`` by name.  A kernel of the port's own (a name with
    ``lora``, ``attn`` or ``paged``) that no family claims is a fault.
    Tracing slows the host, so the idle share it gives is an upper
    bound.  The device events are read from the profiler's raw results:
    ``key_averages()`` builds a Python event per CPU op as well, minutes
    for a trace of some seconds of serving.  With ``check`` the busy time
    is also read through ``key_averages()``, the two must agree within
    0.1%, and that reading comes back as a third value.

    ``ranges``: ((``record_function`` name, family), ...), innermost
    first: a kernel whose launching host op (the profiler's correlation
    ids) started inside such a range belongs to its family, whatever its
    name; the ranges' own device events are left out.  A kernel the trace
    links to no host op and no name claims goes to ``other`` marked
    "launch not linked"."""
    import bisect

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = list(prof.profiler.kineto_results.events())
    # host ops and ranges only, not the CUDA runtime's calls ("cuda...",
    # "cu..."), which number their correlation ids apart: a kernel links
    # to the op it was launched under
    host = {ev.correlation_id(): ev for ev in events
            if ranges and ev.device_type() != DeviceType.CUDA
            and not ev.name().startswith("cu")}
    spans = {r: sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns())
                       for ev in host.values() if ev.name() == r)
             for r, _ in ranges}

    def in_range(r, t):
        i = bisect.bisect_right(spans[r], (t, float("inf"))) - 1
        return i >= 0 and spans[r][i][0] <= t <= spans[r][i][1]

    fam = {}
    for ev in events:
        if ev.device_type() != DeviceType.CUDA or ev.name() in spans:
            continue
        key = ev.name()
        parent = host.get(ev.linked_correlation_id())
        name = None if parent is None else next(
            (f for r, f in ranges if in_range(r, parent.start_ns())), None)
        name = name or next((f for k, f in families if k in key), None)
        require(name is not None or not any(
            k in key for k in ("lora", "attn", "paged")),
            f"traced kernel {key[:120]} belongs to no family")
        if name is None:
            name = (f"{other}; launch not linked" if ranges and parent is None
                    else other)
        fam[name] = fam.get(name, 0.0) + ev.duration_ns() / 1e6
    if check:
        busy = sum(fam.values())
        ka = sum((getattr(ev, "self_device_time_total", None)
                  or getattr(ev, "self_cuda_time_total", 0))
                 for ev in prof.key_averages()
                 if ev.device_type == DeviceType.CUDA) / 1e3
        require(abs(ka - busy) <= 1e-3 * busy, f"device busy ms from the "
                f"raw events {busy} differs from key_averages' {ka}")
        return wall * 1e3, fam, ka
    return wall * 1e3, fam


def _profile_line(fam, wall_ms, **extra):
    busy_ms = sum(fam.values())
    return {**extra, "traced_wall_ms": wall_ms,
            "device_busy_ms": busy_ms if fam else "not measured",
            "device_idle_share": (1 - busy_ms / wall_ms) if fam
            else "not measured",
            "device_ms_by_kernel": dict(sorted(fam.items(),
                                               key=lambda kv: -kv[1]))}


def _decode_share(fam):
    """paged_attention's device ms (split + combine) in a traced serving
    run and its share of the busy time; the run must have launched it."""
    ms = sum(v for k, v in fam.items() if k.startswith("paged_attention ("))
    require(ms > 0, "the traced serving run shows no paged_attention kernel")
    return {"paged_attention_ms": ms,
            "paged_attention_share_of_busy": ms / sum(fam.values())}


def profile_phase(eng, reqs, sc, new_tokens: int = 8, check: bool = False):
    """One traced serving run: device time by kernel family and the
    device's idle share of the traced wall time; the untraced runs above
    give the end-to-end numbers.  ``check``: also read the busy time
    through ``key_averages()`` (see ``traced``)."""
    import dataclasses
    sc2 = dataclasses.replace(sc, max_new_tokens=new_tokens,
                              paged_backend="cuda")
    wall_ms, fam, *ka = traced(
        lambda: eng.generate(reqs, sc2), KERNEL_FAMILIES,
        "other device work (torch: lm_head, norms, rope, scatter, "
        "sampling, copies)", check=check)
    emit(_profile_line(fam, wall_ms, phase="profile", overlap=sc.overlap,
                       requests=len(reqs), new_tokens=new_tokens,
                       **({"key_averages_busy_ms": ka[0]} if ka else {}),
                       **_decode_share(fam)))


# ---------------------------------------------------------------------------
# phase 3b: an open-loop trace through the serve phase's engine
# ---------------------------------------------------------------------------

def _trace_line(rep, **extra):
    st = rep["last_stats"]
    return {**extra, "mode": rep["mode"], "unit": rep["unit"],
            "completed": rep["completed"],
            "emitted_tokens": rep["emitted_tokens"],
            "elapsed": rep["elapsed"],
            "goodput_tok_per_unit": rep["goodput_tok_per_unit"],
            "ttft": rep["ttft"], "tpot": rep["tpot"],
            "per_class": rep["per_class"],
            "queue_waits": st["classes"],
            **{k: st[k] for k in ("prefill_dispatches", "decode_dispatches",
                                  "deferred_chunks", "preemptions")}}


# llama2-7b's layers the serve_trace phase serves (of 32): the phase is
# host-paced, so its time follows the depth, and the script must stay
# inside its time limit
SERVE_TRACE_LAYERS = 8


def serve_trace_phase(device, seed: int, n_requests: int = 16,
                      depth: int = SERVE_TRACE_LAYERS, tenants: int = 8,
                      rank: int = 16):
    """An open-loop Poisson trace (``serving/trace.py``) through the serve
    cell's engine (llama2-7b at full width, ``tenants`` rank-16 fused
    adapters) cut to ``depth`` layers: logical mode (arrivals mapped to
    rounds) with overlap on and off, streams bitwise equal; realtime mode
    with overlap on and off, TTFT from each scheduled arrival, TPOT,
    goodput and wall-clock queue waits, streams held to the logical ones
    by the margin rule (the batch make-up differs), whose error is this
    engine's bf16 first chunk "cuda" vs "torch"; one traced realtime
    run."""
    import dataclasses

    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_engine, ragged_requests
    from repro_torch.serving.engine import ServeConfig
    from repro_torch.serving.kv_cache import kv_bytes_per_block
    from repro_torch.serving.trace import run_trace, synth_trace
    full = get_config(ARCH)
    eng = build_engine(full.with_overrides(n_layers=depth), tenants, device,
                       seed, rank=rank)
    cfg = eng.cfg
    emit({"phase": "model", "arch": cfg.name, "n_layers": depth,
          "published_n_layers": full.n_layers, "for": "serve_trace",
          "params": cfg.count_params(), "dtype": cfg.dtype,
          "tenants": tenants, "rank": rank})
    eng.generate(ragged_requests(2, tenants, cfg.vocab_size, 8, 16, seed + 1),
                 ServeConfig(batch_size=2, max_new_tokens=2, prefill_chunk=8,
                             paged_backend="cuda"))
    trace = synth_trace(seed, n_requests, arrival="poisson", rate=2.0,
                        prompt_mean=256, prompt_sigma=0.6, prompt_max=1024,
                        out_mean=32, out_sigma=0.6, out_max=64,
                        clients=tuple(f"client{i}" for i in range(8)),
                        vocab_size=cfg.vocab_size)
    # 8 slots of 68 blocks of 16 tokens (1088, the longest span)
    sc = ServeConfig(batch_size=8, block_size=16, prefill_chunk=256,
                     num_blocks=545, max_blocks_per_slot=68,
                     paged_backend="cuda")
    emit({"phase": "serve_trace_config", "requests": n_requests,
          "arrival": "poisson", "rate_per_s": 2.0,
          "arrivals_s": [e.arrival_s for e in trace],
          "prompt_lens": [len(e.prompt) for e in trace],
          "max_new_tokens": [e.max_new_tokens for e in trace],
          "priorities": [e.priority for e in trace],
          "clients": [e.client_id for e in trace],
          "batch": 8, "block_size": 16, "prefill_chunk": 256,
          "num_blocks": 545, "max_blocks_per_slot": 68,
          "scan_chunk": sc.scan_chunk, "rounds_per_s": 8.0,
          "pool_gb": 545 * kv_bytes_per_block(
              16, cfg.n_kv_heads, cfg.resolved_head_dim, "f32")
          * cfg.n_layers / 1e9})

    def check(rep, what):
        require(rep["completed"] == n_requests,
                f"{what}: {rep['completed']} of {n_requests} completed")
        for rid, e in enumerate(trace):
            got = rep["streams"].get(rid, [])
            require(len(got) == e.max_new_tokens and all(
                0 <= t < cfg.vocab_size for t in got),
                f"{what}: stream {rid} is malformed")

    logical = {}
    for overlap in (True, False):
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = run_trace(eng, dataclasses.replace(sc, overlap=overlap), trace,
                        rounds_per_s=8.0)
        wall_s = time.perf_counter() - t0
        counts, tiles = kernels.launch_counts(), kernels.tile_counts()
        emit(_trace_line(rep, phase="serve_trace", overlap=overlap,
                         wall_s=wall_s, launches=counts,
                         tile_launches=tiles))
        check(rep, f"serve_trace logical overlap={overlap}")
        for name in ("paged_prefill_attention", "batched_lora_matmul"):
            require_mma_tile(tiles, name, f"serve_trace overlap={overlap}")
        if overlap:
            for name in kernels.SERVING:
                require(counts[name] > 0, f"serve_trace: kernel {name} was "
                        "never launched in the overlapped run")
        logical[overlap] = rep
    require(logical[True]["streams"] == logical[False]["streams"],
            "serve_trace: logical streams with overlap on and off differ")
    require(logical[True]["last_stats"]["deferred_chunks"] > 0,
            "serve_trace: no decode chunk was deferred")

    reqs = [e.request() for e in trace]
    err_bf16 = compare_first_chunk(
        eng, reqs[:sc.batch_size], dataclasses.replace(sc, max_new_tokens=64),
        "bfloat16", rel_tol=0.1, extra={"for": "serve_trace",
                                        "n_layers": depth})
    want = [logical[True]["streams"][rid] for rid in range(n_requests)]
    for overlap in (True, False, False, True):      # in turns
        rep = run_trace(eng, dataclasses.replace(sc, overlap=overlap), trace,
                        realtime=True, time_scale=1.0)
        check(rep, f"serve_trace realtime overlap={overlap}")
        got = [rep["streams"][rid] for rid in range(n_requests)]
        t0 = time.perf_counter()
        matched = streams_by_margin(
            eng, reqs, sc, got, want, err_bf16,
            f"serve_trace realtime overlap={overlap} vs logical")
        emit(_trace_line(rep, phase="serve_trace", overlap=overlap,
                         matched_logical_prefix=matched,
                         streams_equal_logical=got == want,
                         margin_check_s=time.perf_counter() - t0))
    t0 = time.perf_counter()
    wall_ms, fam = traced(
        lambda: run_trace(eng, sc, trace, realtime=True, time_scale=1.0),
        KERNEL_FAMILIES, "other device work (torch: lm_head, norms, rope, "
        "scatter, sampling, copies)")
    # the profiler's own cost after the run: reading its events back
    emit(_profile_line(fam, wall_ms, phase="profile_serve_trace",
                       overlap=True, mode="realtime", requests=n_requests,
                       trace_processing_s=time.perf_counter() - t0
                       - wall_ms / 1e3, **_decode_share(fam)))


# ---------------------------------------------------------------------------
# phase 4: the serving options (int8 K/V, ragged int8 bank, prefix cache,
# speculative decoding)
# ---------------------------------------------------------------------------

def feed_chunks(eng, kv, cache, slot, seq, sc, backend):
    """Feed ``seq[lengths[slot]:]`` to ``slot`` of ``kv`` as a batch of one,
    in ``sc.prefill_chunk``-token prefill dispatches through ``backend``
    (blocks sealed as they fill, as the engine does).  Returns ([(first
    position, logits (n, V))], cache)."""
    import dataclasses

    import torch
    dev = eng.device
    T = sc.prefill_chunk
    bank = eng.bank_for(dataclasses.replace(sc, paged_backend=backend))
    ids = torch.tensor([eng.registry.acquire(seq.client_id)],
                       dtype=torch.int32, device=dev)
    toks = [int(t) for t in seq.prompt]
    out, pos = [], int(kv.lengths[slot])
    while pos < len(toks):
        n = min(T, len(toks) - pos)
        require(kv.ensure(slot, pos + n), "teacher-forcing pool too small")
        bt, lens = kv.device_tables(dev)
        chunk = torch.zeros((1, T), dtype=torch.int32)
        chunk[0, :n] = torch.tensor(toks[pos:pos + n])
        logits, cache = eng.model.prefill_step(
            eng.params, cache, chunk.to(dev), lens[slot:slot + 1],
            torch.tensor([n], dtype=torch.int32, device=dev), adapters=bank,
            lora_scale=eng.scale, adapter_ids=ids,
            block_tables=bt[slot:slot + 1], paged_backend=backend)
        kv.advance(slot, n, tokens=toks[pos:pos + n])
        out.append((pos, logits[0, :n]))
        pos += n
    return out, cache


def _fresh_pool(eng, sc, n_tokens, slots=1):
    from repro_torch.serving.kv_cache import PagedKVCache, blocks_needed
    per = blocks_needed(n_tokens, sc.block_size)
    kv = PagedKVCache(slots, sc.block_size, 1 + slots * per, per,
                      prefix_cache=True)
    return kv, eng.model.init_paged_decode_cache(1 + slots * per,
                                                 sc.block_size,
                                                 kv_dtype=sc.kv_dtype,
                                                 num_slots=slots)


def next_token_margin(eng, req, tokens, sc, backend="cuda"):
    """Top-2 margin of the logits after ``req.prompt + tokens`` (fresh
    pool, prefill chunks): the margin of the stream's next greedy
    decision."""
    import dataclasses

    import numpy as np
    import torch
    seq = dataclasses.replace(req, prompt=np.concatenate(
        [np.asarray(req.prompt, np.int32), np.asarray(tokens, np.int32)]))
    kv, cache = _fresh_pool(eng, sc, len(seq.prompt))
    kv.admit(0)
    out, _ = feed_chunks(eng, kv, cache, 0, seq, sc, backend)
    top2 = torch.topk(out[-1][1][-1], 2).values
    return float(top2[0] - top2[1])


def streams_by_margin(eng, reqs, sc, got, want, err, what):
    """Streams ``got`` against ``want``: equal wherever the top-2 margin
    exceeds twice ``err``.  At each stream's first difference the margin
    of that decision (teacher-forced on ``want``'s history) must be at most
    2 err.  Returns each stream's matched-prefix length."""
    matched = []
    for req, g, w in zip(reqs, got, want):
        t = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                 min(len(g), len(w)))
        matched.append(t)
        if t < min(len(g), len(w)):
            m = next_token_margin(eng, req, w[:t], sc)
            require(m <= 2 * err,
                    f"{what}: {req.client_id} differs at token {t} where the "
                    f"margin {m} exceeds 2 x {err}")
    return matched


def warm_chunk_check(eng32, req_a, req_b, prefix_len, sc):
    """The first suffix chunk of ``req_b`` after a prefix hit on blocks that
    ``req_a`` (same tenant, same prefix) sealed, against the same positions
    of ``req_b`` prefilled cold, fp32 activations, through "cuda": the max
    logit difference must stay within 1% of the largest logit."""
    import torch
    kv, cache = _fresh_pool(eng32, sc, len(req_a.prompt) + len(req_b.prompt),
                            slots=2)
    scope = (req_a.client_id, eng32.registry.version(req_a.client_id))
    kv.admit(0, scope, req_a.prompt)
    _, cache = feed_chunks(eng32, kv, cache, 0, req_a, sc, "cuda")
    kv.release(0)
    hit = kv.admit(1, scope, req_b.prompt)
    require(hit >= prefix_len, f"warm-chunk check: hit {hit} tokens, under "
            f"the {prefix_len}-token prefix")
    warm, _ = feed_chunks(eng32, kv, cache, 1, req_b, sc, "cuda")
    kv2, cache2 = _fresh_pool(eng32, sc, len(req_b.prompt))
    kv2.admit(0)
    cold, _ = feed_chunks(eng32, kv2, cache2, 0, req_b, sc, "cuda")
    cold_all = torch.cat([lg for _, lg in cold])       # every position
    pos0, lw = warm[0]
    lc = cold_all[pos0:pos0 + lw.shape[0]]
    err = float((lw - lc).abs().max())
    top = float(lc.abs().max())
    emit({"phase": "warm_chunk", "activations": "float32",
          "prefix_hit_tokens": hit, "first_suffix_position": pos0,
          "positions": int(lw.shape[0]), "max_abs_logit_err": err,
          "max_abs_logit": top, "tol": 1e-2 * top})
    require(err <= 1e-2 * top, f"warm suffix chunk logit error {err} > "
            f"{1e-2 * top}")


def bank_bytes(registry):
    """(ragged int8 bank, its kernel view, a uniform rank-16 fp32 bank of
    the same capacity) in bytes."""
    from repro_torch.core.lora import block_target_shapes, tree_leaves
    own = sum(t.numel() * t.element_size()
              for _, t in tree_leaves(registry.bank()))
    view = sum(t.numel() * t.element_size()
               for _, t in tree_leaves(registry.kernel_bank()))
    cfg = registry._cfg
    per_layer = sum(din * 16 + 16 * dout
                    for tmap in block_target_shapes(cfg).values()
                    for din, dout in tmap.values())
    uniform = 4 * registry.capacity * cfg.n_layers * per_layer
    return own, view, uniform


def tenant_text(rng, tenant: int, n_tokens: int):
    """``n_tokens`` byte-tokenized log-anomaly examples (prompt, answer) of
    ``tenant``'s log source: the repo's FDLoRA data, templated text of the
    kind a tenant sends, in the byte tokenizer's ids."""
    import numpy as np
    from repro_torch.data.synthetic import gen_log_dataset
    from repro_torch.data.tokenizer import ByteTokenizer
    tok = ByteTokenizer()
    ids = []
    while len(ids) < n_tokens:
        for ex in gen_log_dataset(rng, 8, tenant):
            ids += tok.encode(ex.prompt + ex.answer + "\n", add_bos=False)
    return np.asarray(ids[:n_tokens], np.int32)


def serve_options_phase(device, seed: int, params, cfg, T: int = 256,
                        prefix_len: int = 512, new_tokens: int = 32):
    """llama2-7b, the serve cell's layers, bf16: int8 K/V, a ragged int8
    bank, prefix caching on a pool pinned below residency, then
    speculative decoding.
    Returns the cold run's launch counts."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.launch.serve import timed_stream
    from repro_torch.core.lora import init_adapters
    from repro_torch.models.api import Model
    from repro_torch.serving.engine import (MultiTenantEngine, Request,
                                            ServeConfig)
    from repro_torch.serving.kv_cache import blocks_needed, kv_bytes_per_block
    from repro_torch.serving.registry import AdapterRegistry

    registry = AdapterRegistry(cfg, capacity=8, ranks=[4, 8, 16],
                               bank_dtype="int8", device=device)
    tenant_ranks = [4, 4, 8, 8, 16, 16]
    for i, rank in enumerate(tenant_ranks):
        # A ~ N(0, 1) / r, so x·A·B grows like 1 / sqrt(r) at a fixed B
        # spread; B ~ N(0, (0.02 sqrt(r / 16))^2) gives every tenant the
        # update size of the serve phase's rank-16 adapters (a lower-rank
        # adapter is not a larger one)
        b_std = 0.02 * (rank / 16) ** 0.5
        ad_p = init_adapters(cfg, rank, seed=seed + 200 + 2 * i,
                             device=device, b_std=b_std)
        ad_s = init_adapters(cfg, rank, seed=seed + 201 + 2 * i,
                             device=device, b_std=b_std)
        registry.register_dual(f"tenant{i}", ad_p, ad_s, [0.6, 0.6])
        del ad_p, ad_s
    eng = MultiTenantEngine(Model(cfg, device), cfg, params, registry)
    own, view, uniform = bank_bytes(registry)
    emit({"phase": "bank_bytes", "capacity": registry.capacity,
          "bucket_ranks": registry.bucket_ranks,
          "bucket_sizes": registry.bucket_sizes,
          "slot_ranks": registry.slot_ranks().tolist(),
          "ragged_int8_bank_bytes": own,
          "kernel_view_bytes": view,
          "uniform_rank16_fp32_bank_bytes": uniform,
          "uniform_over_ragged": uniform / own})

    # two requests per tenant: the tenant's 512-token prefix (a few-shot
    # context of its own log source) plus a seeded suffix of 64-256 tokens
    # of further log examples; every tenant's first request, then the
    # seconds
    rng = np.random.default_rng(seed + 300)
    prefixes = [tenant_text(rng, i, prefix_len)
                for i in range(len(tenant_ranks))]
    reqs = []
    for _ in range(2):
        for i, pre in enumerate(prefixes):
            suf = tenant_text(rng, i, int(rng.integers(64, 257)))
            reqs.append(Request(f"tenant{i}", np.concatenate([pre, suf])))
    spans = [blocks_needed(len(r.prompt) + new_tokens, 16) for r in reqs]
    resident = sum(sorted(spans)[-8:])          # 8 slots of the longest
    num_blocks = 1 + (3 * resident) // 4
    sc = ServeConfig(batch_size=8, max_new_tokens=new_tokens,
                     prefill_chunk=T, block_size=16, num_blocks=num_blocks,
                     kv_dtype="int8", prefix_cache=True,
                     paged_backend="cuda")
    emit({"phase": "serve_options_config", "requests": len(reqs),
          "prompt_lens": [len(r.prompt) for r in reqs],
          "prefix_len": prefix_len, "new_tokens": new_tokens,
          "tenant_ranks": tenant_ranks, "batch": sc.batch_size,
          "prefill_chunk": T, "block_size": 16,
          "blocks_for_8_resident": resident, "num_blocks": num_blocks,
          "pool_gb": num_blocks * kv_bytes_per_block(
              16, cfg.n_kv_heads, cfg.resolved_head_dim, "int8")
          * cfg.n_layers / 1e9})

    def run(name, reqs_, sc_):
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        outs, ttft, dec_s, dec_tok, total_s = timed_stream(eng, reqs_, sc_)
        counts = kernels.launch_counts()
        tiles = kernels.tile_counts()
        st = eng.last_stats
        line = {"phase": "serve_options", "run": name,
                "requests": len(reqs_), "tokens": sum(len(o) for o in outs),
                "ttft_ms_p50": float(np.percentile(ttft, 50)) * 1e3,
                "ttft_ms_max": max(ttft) * 1e3,
                "decode_tokens": dec_tok, "decode_s": dec_s,
                "decode_tok_per_s": dec_tok / dec_s if dec_s > 0 else None,
                "total_s": total_s,
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                "launches": counts, "tile_launches": tiles,
                **{k: st[k] for k in (
                    "prefill_dispatches", "decode_dispatches",
                    "verify_dispatches", "preemptions", "prompt_tokens",
                    "prefix_hit_tokens", "prefix_hit_rate",
                    "prefix_pool_reused", "prefix_evictions",
                    "drafted_tokens", "accepted_tokens", "acceptance_rate",
                    "rollback_tokens", "kv_dtype")}}
        emit(line)
        for o in outs:
            require(len(o) == sc_.max_new_tokens and all(
                0 <= t < cfg.vocab_size for t in o),
                f"serve_options {name}: a stream is malformed")
        for kernel in ("paged_prefill_attention", "batched_lora_matmul"):
            require_mma_tile(tiles, kernel, f"serve_options {name}")
        return outs, st, counts

    # 1. cold: prefix hits inside the call, preemption, every serving kernel
    eng.release_prefix_cache()
    cold, st_cold, counts = run("cold", reqs, sc)
    require(st_cold["prefix_hit_tokens"] > 0, "cold run: no prefix hit")
    require(st_cold["preemptions"] > 0, "cold run: no preemption")
    for name in kernels.SERVING:
        require(counts[name] > 0,
                f"kernel {name} was never launched on the options path")
    # 2. warm: the same requests against the pool kept by the cold run
    warm, st_warm, _ = run("warm", reqs, sc)
    require(st_warm["prefix_pool_reused"], "warm run: pool not reused")
    require(st_warm["prefix_hit_rate"] > st_cold["prefix_hit_rate"],
            "warm run: hit rate not above the cold run's")
    # 3. speculative: each prompt extended by its own first 16 greedy tokens
    # from the cold run, so the drafter finds runs to copy
    spec_reqs = [dataclasses.replace(r, prompt=np.concatenate(
        [r.prompt, np.asarray(o[:16], np.int32)])) for r, o in zip(reqs, cold)]
    sc_spec = dataclasses.replace(sc, spec_decode=True, spec_k=4)
    spec, st_spec, _ = run("spec", spec_reqs, sc_spec)
    require(st_spec["verify_dispatches"] > 0, "spec run: no verify dispatch")
    require(st_spec["accepted_tokens"] > 0, "spec run: no draft accepted")

    # 4. the properties, to stated tolerances.  First-chunk logits "cuda"
    # vs "torch" with int8 K/V and the ragged int8 bank (compare_first_chunk's
    # bounds); the first 8 requests, as one dispatch would hold them.
    first = reqs[:8]
    err_bf16 = compare_first_chunk(eng, first, sc, "bfloat16", rel_tol=0.1,
                                   extra={"kv_dtype": "int8",
                                          "bank": "ragged int8"})
    # fp32 activations: with bf16 pools (the serve phase's) the paths differ
    # by summation order, and that noise flips a pool rounding by one bf16
    # ulp now and then: 1%.  int8 pools turn the same noise into flips of
    # one int8 step, amax/127 of a (position, kv-head) row, about 3x a bf16
    # ulp of a typical element (|x| ~ amax/3), so flips move logits about
    # 3x as far: 3%.  A wrong scale, mask or bucket moves them by O(10%).
    cfg32 = cfg.with_overrides(dtype="float32")
    eng32 = MultiTenantEngine(Model(cfg32, device), cfg32, params, registry)
    compare_first_chunk(eng32, first, dataclasses.replace(sc, kv_dtype="f32"),
                        "float32", rel_tol=1e-2,
                        extra={"kv_dtype": "f32", "bank": "ragged int8"})
    compare_first_chunk(eng32, first, sc, "float32", rel_tol=3e-2,
                        extra={"kv_dtype": "int8", "bank": "ragged int8"})
    warm_chunk_check(eng32, reqs[0], reqs[6], prefix_len, sc)
    del eng32
    # streams: warm vs cold and spec vs cold (the spec stream's first 16
    # tokens continue where the cold stream's first 16 ended), equal
    # wherever the margin exceeds twice the bf16 cuda-vs-torch error
    m_warm = streams_by_margin(eng, reqs, sc, warm, cold, err_bf16,
                               "warm vs cold")
    m_spec = streams_by_margin(eng, spec_reqs, sc,
                               [o[:16] for o in spec],
                               [o[16:32] for o in cold], err_bf16,
                               "spec vs cold")
    emit({"phase": "serve_options_streams", "err_bound": 2 * err_bf16,
          "warm_vs_cold_matched": m_warm,
          "spec_vs_cold_matched_of_16": m_spec})
    # one traced warm run, 8 new tokens: device time by kernel family
    sc8 = dataclasses.replace(sc, max_new_tokens=8)
    wall_ms, fam = traced(lambda: eng.generate(reqs, sc8), KERNEL_FAMILIES,
                          "other device work (torch: lm_head, norms, rope, "
                          "scatter-quantize, sampling, copies)")
    st = eng.last_stats
    emit(_profile_line(fam, wall_ms, phase="profile_serve_options",
                       requests=len(reqs), new_tokens=8,
                       **_decode_share(fam),
                       **{k: st[k] for k in (
                           "prefix_pool_reused", "prefix_hit_rate",
                           "prefill_dispatches", "decode_dispatches")}))
    eng.release_prefix_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 4b: sharded serving and hot-swap across shards
# ---------------------------------------------------------------------------

def fused_trees(cfg, device, tenants=8, ranks=None):
    """Each tenant's Eq. 7-fused adapter: the serve cell's seeds (those of
    ``build_engine``), tenant i at ``ranks[i % len]`` with ``ranks``, built
    once for every registry of the phase."""
    from repro_torch.core.dual_lora import merge
    from repro_torch.core.lora import init_adapters
    trees = []
    for i in range(tenants):
        rank = ranks[i % len(ranks)] if ranks else 16
        # B ~ N(0, (0.02 sqrt(r / 16))^2), as in serve_options: a rank-r
        # tenant's update the size of a rank-16 one's (at a fixed B spread
        # x·A·B grows like 1 / sqrt(r), and unscaled rank-4 updates, twice
        # the size, carry bf16 noise to 62% of the largest first-chunk
        # logit; PERF.md, the sharded phase)
        pair = [init_adapters(cfg, rank, seed=10 + 2 * i + j, device=device,
                              b_std=0.02 * (rank / 16) ** 0.5)
                for j in (0, 1)]
        trees.append(merge(*pair, [0.6, 0.6]))
    return trees


def sharded_engine(device, params, cfg, shards, trees, capacity=8,
                   ranks=None, bank_dtype="f32"):
    """A MultiTenantEngine over a ShardedAdapterRegistry of ``shards``
    shards holding ``trees`` (client i the i-th), and the ms of its first
    bank build (the concatenation of the shards' banks, and for a ragged
    bank the kernel view)."""
    import torch
    from repro_torch.models.api import Model
    from repro_torch.serving.engine import MultiTenantEngine
    from repro_torch.serving.sharded import ShardedAdapterRegistry
    reg = ShardedAdapterRegistry(cfg, capacity, num_shards=shards,
                                 ranks=ranks, bank_dtype=bank_dtype,
                                 device=device)
    for i, tree in enumerate(trees):
        reg.register(f"client{i}", tree)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reg.kernel_bank()
    torch.cuda.synchronize()
    return (MultiTenantEngine(Model(cfg, device), cfg, params, reg),
            (time.perf_counter() - t0) * 1e3)


SHARDED_LAYERS = 8


def sharded_phase(device, seed: int, params, cfg, prompt_lens, T: int = 256,
                  new_tokens: int = 32, depth: int = SHARDED_LAYERS):
    """llama2-7b cut to ``depth`` of its layers (the script's time
    limit), bf16: the serve cell's 8 requests and 8
    tenants' rank-16 fused adapters in a ShardedAdapterRegistry of
    capacity 8, 8 slots, through "cuda" with overlap on: num_shards 1, 2
    and 4 (streams bitwise equal), the prefix cache cold then warm at 2
    shards on a pinned pool, int8 K/V over a ragged int8 bank (ranks 4, 8,
    16) at 1 and 2 shards, and a hot-swap at 2 shards that re-registers
    one client after the first decode round.  Returns (the launch counts
    of the 2-shard run, an engine at 1 shard at ``depth`` layers for the
    fixed phase)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core.lora import tree_leaves
    from repro_torch.launch.serve import (ragged_requests, register_client,
                                          timed_stream)
    from repro_torch.models.api import Model
    from repro_torch.serving.engine import MultiTenantEngine, ServeConfig
    from repro_torch.serving.kv_cache import blocks_needed
    full_cfg = cfg.with_overrides(lora_rank=16)
    cfg = full_cfg.with_overrides(n_layers=depth)
    params = dict(params, layers=params["layers"][:depth])
    reqs = ragged_requests(8, 8, cfg.vocab_size, 128, 1024, seed)
    require(sorted(len(r.prompt) for r in reqs) == list(prompt_lens),
            "the sharded phase's requests are not the serve cell's")
    sc = ServeConfig(batch_size=8, max_new_tokens=new_tokens,
                     prefill_chunk=T, block_size=16, paged_backend="cuda")
    per = blocks_needed(max(len(r.prompt) for r in reqs) + new_tokens, 16)
    # a pool pinned at full residency: 8 slots x the longest span, which
    # splits into whole shards at 1, 2 and 4
    pinned = dict(num_blocks=1 + 8 * per, max_blocks_per_slot=per)

    def run(name, eng, sc_, reqs_=reqs):
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        outs, ttft, dec_s, dec_tok, total_s = timed_stream(eng, reqs_, sc_)
        counts, tiles = kernels.launch_counts(), kernels.tile_counts()
        st = eng.last_stats
        emit({"phase": "sharded", "run": name, "n_layers": depth,
              "num_shards": sc_.num_shards,
              "kv_dtype": sc_.kv_dtype, "prefix_cache": sc_.prefix_cache,
              "requests": len(reqs_), "tokens": sum(len(o) for o in outs),
              "ttft_ms_p50": float(np.percentile(ttft, 50)) * 1e3,
              "ttft_ms_max": max(ttft) * 1e3, "decode_tokens": dec_tok,
              "decode_s": dec_s,
              "decode_tok_per_s": dec_tok / dec_s if dec_s > 0 else None,
              "total_s": total_s,
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
              "launches": counts, "tile_launches": tiles,
              **{k: st[k] for k in (
                  "prefill_dispatches", "decode_dispatches", "preemptions",
                  "prefix_hit_tokens", "prefix_pool_reused",
                  "adapter_bank_refreshes", "deferred_chunks")},
              "shard_placements": st.get("shard_placements")})
        for o in outs:
            require(len(o) == new_tokens and all(0 <= t < cfg.vocab_size
                                                 for t in o),
                    f"sharded {name}: a stream is malformed")
        for name_ in kernels.SERVING:
            require(counts[name_] > 0,
                    f"sharded {name}: kernel {name_} never launched")
        for kernel in ("paged_prefill_attention", "batched_lora_matmul"):
            require_mma_tile(tiles, kernel, f"sharded {name}")
        return outs, st, counts

    streams, engines, concat_ms = {}, {}, {}
    full_trees = fused_trees(full_cfg, device)
    trees = [{"layers": t["layers"][:depth]} for t in full_trees]
    for shards in (1, 2, 4):
        eng, concat_ms[f"f32_{shards}"] = sharded_engine(
            device, params, cfg, shards, trees)
        if shards == 1:                 # warm-up (cuBLAS handles, allocator)
            eng.generate(ragged_requests(2, 8, cfg.vocab_size, 8, 16,
                                         seed + 1),
                         ServeConfig(batch_size=2, max_new_tokens=2,
                                     prefill_chunk=8, paged_backend="cuda"))
        sc_s = dataclasses.replace(sc, num_shards=shards)
        streams[shards], st, counts = run(f"f32_{shards}", eng, sc_s)
        if shards > 1:
            require(st["shard_placements"]["adapter"] == 8,
                    f"{shards} shards: placements {st['shard_placements']}")
            require(streams[shards] == streams[1],
                    f"streams at {shards} shards differ from one pool")
        if shards == 2:
            counts2 = counts
        engines[shards] = eng
    del engines[4], trees
    torch.cuda.empty_cache()
    # prefix cache: cold then warm on the pinned pool at 2 shards.  Cold
    # makes the dispatches of the run without the cache: bitwise equal.
    # Warm re-matches every full block of each prompt on the shard that
    # sealed it.  Warm against cold is the margin rule (below), not
    # bitwise: a token that the cold run makes as a feedback row of a
    # 2048-row prefill dispatch (LoRA's wgmma plan, the prefill kernel)
    # the warm run makes in an 8-row decode dispatch (split-K plan, the
    # decode kernel)
    eng = engines[2]
    sc_p = dataclasses.replace(sc, num_shards=2, prefix_cache=True, **pinned)
    eng.release_prefix_cache()
    cold, _, _ = run("prefix_cold_2", eng, sc_p)
    warm, st_warm, _ = run("prefix_warm_2", eng, sc_p)
    eng.release_prefix_cache()
    hits = sum((len(r.prompt) - 1) // 16 * 16 for r in reqs)
    require(st_warm["prefix_pool_reused"]
            and st_warm["prefix_hit_tokens"] == hits,
            f"warm run: reused {st_warm['prefix_pool_reused']}, "
            f"{st_warm['prefix_hit_tokens']} hit tokens, not {hits}")
    require(st_warm["shard_placements"]["prefix"] == len(reqs),
            f"warm run: placements {st_warm['shard_placements']}")
    require(cold == streams[1], "cold prefix-cache streams differ from the "
            "streams without the cache")
    # hot-swap at 2 shards: client 3 re-registers after the first decode
    # round; the other clients' streams must stay those of the f32_2 run
    kernels.reset_launch_counts()
    ses = eng.session(dataclasses.replace(sc, num_shards=2), reqs)
    swapped = [[] for _ in reqs]
    swap_ms = None
    while ses.has_work:
        decodes = ses.sched.decode_dispatches
        for rid, toks, _ in ses.step():
            swapped[rid].extend(toks)
        if swap_ms is None and ses.sched.decode_dispatches > decodes:
            register_client(eng.registry, cfg, 3, device, 900, None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.registry.kernel_bank()
            torch.cuda.synchronize()
            swap_ms = (time.perf_counter() - t0) * 1e3
    st = ses.finalize()
    moved = [i for i, r in enumerate(reqs) if r.client_id == "client3"]
    untouched = [i for i in range(len(reqs)) if i not in moved]
    emit({"phase": "sharded_hot_swap", "swapped_client": "client3",
          "adapter_bank_refreshes": st["adapter_bank_refreshes"],
          "bank_concat_ms_after_swap": swap_ms,
          "untouched_equal": all(swapped[i] == streams[2][i]
                                 for i in untouched),
          "swapped_stream_moved": any(swapped[i] != streams[2][i]
                                      for i in moved),
          "launches": kernels.launch_counts()})
    require(swap_ms is not None and st["adapter_bank_refreshes"] >= 1,
            "hot-swap: the bank was never refreshed")
    require(all(swapped[i] == streams[2][i] for i in untouched),
            "hot-swap: an untouched client's stream moved")
    # the first chunk "cuda" vs "torch" through the 2-shard registry's
    # kernel view (bf16 <= 10%; fp32 activations <= 1%)
    err_bf16 = compare_first_chunk(eng, reqs, sc, "bfloat16", rel_tol=0.1,
                                   extra={"num_shards": 2})
    cfg32 = cfg.with_overrides(dtype="float32")
    compare_first_chunk(MultiTenantEngine(Model(cfg32, device), cfg32,
                                          params, eng.registry),
                        reqs, sc, "float32", rel_tol=1e-2,
                        extra={"num_shards": 2})
    # warm against cold by the margin rule (2-shard engine, bf16 error)
    m_warm = streams_by_margin(eng, reqs, sc, warm, cold, err_bf16,
                               "sharded warm vs cold")
    emit({"phase": "sharded_streams", "shards_bitwise": [2, 4],
          "err_bound": 2 * err_bf16, "warm_vs_cold_matched": m_warm,
          "warm_equals_cold": warm == cold})
    del eng, engines[2]
    torch.cuda.empty_cache()
    # int8 K/V over a ragged int8 bank, at 1 and 2 shards: capacity 16 (8
    # slots a shard at 2: buckets of 3, 3, 2 for the tenants' 4, 8, 16)
    int8 = {}
    trees = fused_trees(cfg, device, ranks=[4, 8, 16])
    for shards in (1, 2):
        eng, concat_ms[f"int8_ragged_{shards}"] = sharded_engine(
            device, params, cfg, shards, trees, capacity=16,
            ranks=[4, 8, 16], bank_dtype="int8")
        sc_i = dataclasses.replace(sc, num_shards=shards, kv_dtype="int8")
        int8[shards], st, _ = run(f"int8_ragged_{shards}", eng, sc_i)
        if shards > 1:
            require(int8[2] == int8[1], "int8 streams at 2 shards differ "
                    "from one pool")
            compare_first_chunk(eng, reqs, sc_i, "bfloat16", rel_tol=0.1,
                                extra={"num_shards": 2, "kv_dtype": "int8",
                                       "bank": "ragged int8"})
            compare_first_chunk(
                MultiTenantEngine(Model(cfg32, device), cfg32, params,
                                  eng.registry),
                reqs, dataclasses.replace(sc_i, kv_dtype="f32"), "float32",
                rel_tol=1e-2, extra={"num_shards": 2, "kv_dtype": "f32",
                                     "bank": "ragged int8"})
        del eng
        torch.cuda.empty_cache()
    del trees
    emit({"phase": "bank_concat", "n_layers": depth,
          "ms_first_build": concat_ms, "ms_after_swap": swap_ms,
          "f32_bank_gb": sum(t.numel() * t.element_size() for _, t in
                             tree_leaves(engines[1].registry.bank())) / 1e9})
    del engines
    return counts2, sharded_engine(
        device, params, cfg, 1,
        [{"layers": t["layers"][:depth]} for t in full_trees])[0]


# ---------------------------------------------------------------------------
# phase 4c: the fixed-batch path and the single-tenant engine
# ---------------------------------------------------------------------------

def fixed_phase(eng, seed: int, prompt_len: int = 64, new_tokens: int = 16,
                cache_len: int = 128):
    """llama2-7b at the sharded phase's layers (the script's time limit),
    bf16: one seeded 64-token prompt, 16 new
    tokens, cache_len 128, greedy.  ``generate_fixed`` serves 8 requests,
    one per tenant, over the fp32 bank (batched LoRA at M = 8 per step);
    ``Engine.generate`` serves 8 rows with one Eq. 7-merged adapter
    (``lora_matmul`` at M = 8).  Checks: each path's logits at the last
    prompt position "cuda" vs "torch" (bf16 <= 10%, fp32 activations <=
    1% of the largest logit), ``generate_fixed``'s streams against the
    continuous "cuda" engine's by the margin rule, the kernels' launch
    counters on their tensor-core tiles.  Returns {kernel: launches}."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core.dual_lora import merge
    from repro_torch.core.lora import init_adapters
    from repro_torch.models.api import Model
    from repro_torch.serving.engine import (Engine, MultiTenantEngine,
                                            Request, ServeConfig)
    cfg, dev = eng.cfg, eng.device
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, cfg.vocab_size, prompt_len).astype(np.int32)
    reqs = [Request(f"client{i}", prompt) for i in range(8)]
    sc = ServeConfig(batch_size=8, max_new_tokens=new_tokens,
                     cache_len=cache_len, paged_backend="cuda")
    pair = [init_adapters(cfg, seed=seed + s, device=dev, b_std=0.02)
            for s in (700, 701)]
    single = Engine(eng.model, cfg, eng.params, merge(*pair, [0.6, 0.6]))
    del pair
    steps = prompt_len + new_tokens - 1
    out, launched = {}, {}
    for name, fn, kernel in (
            ("generate_fixed", lambda: eng.generate_fixed(reqs, sc),
             "batched_lora_matmul"),
            ("engine_generate",
             lambda: single.generate(np.tile(prompt, (8, 1)), sc),
             "lora_matmul")):
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts, tiles = kernels.launch_counts(), kernels.tile_counts()
        emit({"phase": "fixed", "run": name, "rows": 8,
              "prompt_len": prompt_len, "new_tokens": new_tokens,
              "cache_len": cache_len, "steps": steps, "s": secs,
              "ms_per_step": secs / steps * 1e3,
              "tok_per_s": 8 * new_tokens / secs,
              "launches": counts, "tile_launches": tiles})
        require(tuple(res.shape) == (8, new_tokens)
                and bool(((res >= 0) & (res < cfg.vocab_size)).all()),
                f"fixed {name}: malformed output")
        require(counts[kernel] > 0, f"fixed {name}: {kernel} never launched")
        require_mma_tile(tiles, kernel, f"fixed {name}")
        out[name], launched[kernel] = res.cpu().tolist(), counts[kernel]
    # the last prompt position's logits through the fixed path's own
    # sequential prefill, "cuda" vs "torch"
    prompts = torch.as_tensor(np.tile(prompt, (8, 1)), device=dev)
    ids = torch.tensor([eng.registry.acquire(r.client_id) for r in reqs],
                       dtype=torch.int32, device=dev)
    cfg32 = cfg.with_overrides(dtype="float32")
    eng32 = MultiTenantEngine(Model(cfg32, dev), cfg32, eng.params,
                              eng.registry)
    err = {}
    for name, e, routed, dtype_name, rel in (
            ("generate_fixed", eng, True, "bfloat16", 0.1),
            ("generate_fixed", eng32, True, "float32", 1e-2),
            ("engine_generate", single, False, "bfloat16", 0.1)):
        logits = {}
        for backend in ("cuda", "torch"):
            bank = (e.bank_for(dataclasses.replace(sc, paged_backend=backend))
                    if routed else single.adapters)
            _, _, logits[backend] = e._prefill(
                e.params, bank, ids if routed else None,
                e.model.init_decode_cache(8, cache_len), prompts, backend)
        lc, lt = logits["cuda"], logits["torch"]
        e_ = float((lc - lt).abs().max())
        top = float(lt.abs().max())
        top2 = torch.topk(lt, 2, dim=-1).values
        decisive = (top2[:, 0] - top2[:, 1]) > 2 * e_
        agree = lc.argmax(-1) == lt.argmax(-1)
        emit({"phase": "fixed_compare", "run": name,
              "activations": dtype_name, "last_prompt_max_abs_logit_err": e_,
              "max_abs_logit": top, "tol": rel * top,
              "first_token_agree": int(agree.sum()), "rows": 8,
              "decisive_rows": int(decisive.sum())})
        require(bool(torch.isfinite(lc).all()), f"fixed {name}: cuda "
                "logits not finite")
        require(e_ <= rel * top, f"fixed {name} {dtype_name}: logit error "
                f"{e_} > {rel * top}")
        require(bool(agree[decisive].all()), f"fixed {name}: greedy token "
                "differs on a row whose margin exceeds the error")
        err.setdefault((name, dtype_name), e_)
    del eng32
    # against the continuous engine on the same requests: the two paths
    # attend differently (plain SDPA over the ring against the paged
    # kernels), so the rule is the margin rule, not bitwise
    csc = ServeConfig(batch_size=8, max_new_tokens=new_tokens,
                      prefill_chunk=256, block_size=16, paged_backend="cuda")
    cont = eng.generate(reqs, csc)
    matched = streams_by_margin(eng, reqs, csc, out["generate_fixed"],
                                [o.tolist() for o in cont],
                                err["generate_fixed", "bfloat16"],
                                "fixed vs continuous")
    emit({"phase": "fixed_streams", "err_bound":
          2 * err["generate_fixed", "bfloat16"],
          "fixed_vs_continuous_matched": matched})
    return launched


# ---------------------------------------------------------------------------
# phase 5: the training path (FDLoRA Algorithm 1)
# ---------------------------------------------------------------------------

def _rel(a, b) -> float:
    """||a - b|| / ||b|| in fp32."""
    import torch
    return float(torch.linalg.vector_norm((a - b).float())
                 / torch.linalg.vector_norm(b.float()).clamp(min=1e-30))


def compare_grads(vg, batch, dtype_name, loss_tol, grad_tol,
                  phase="compare_train_step", zero=(),
                  needs=("lora_matmul", "flash_attention"), pin=None,
                  **extra):
    """One step's loss and every adapter gradient through "cuda" and
    "torch" from the same adapters and batch: ``vg(backend) -> (loss,
    metrics, grads)``.  The "torch" step must launch no kernel.  Bounds are
    relative: ``|Δloss| <= loss_tol·|loss|`` and, per adapter leaf,
    ``||Δg|| <= grad_tol·||g||``; leaves whose path holds a string of
    ``zero`` must have gradients exactly 0 on both backends.  Each step's
    peak memory is reported.  The "cuda" step must launch every kernel of
    ``needs``.  ``pin`` (a :class:`RoutingPin`) pins the "torch" step's
    expert ids to the "cuda" step's.  Returns the "cuda" step's launch
    counts."""
    import torch
    from repro_torch import kernels
    from repro_torch.core.lora import tree_leaves
    out, peak = {}, {}
    for backend in ("cuda", "torch"):
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        with pin(backend) if pin else contextlib.nullcontext():
            loss, _, grads = vg(backend)
        torch.cuda.synchronize()
        peak[backend] = torch.cuda.max_memory_allocated() / 1e9
        tiles = kernels.tile_counts()
        out[backend] = (loss, dict(tree_leaves(grads)),
                        kernels.launch_counts(),
                        {k: tiles[k] for k in ("flash_attention",
                                               "lora_matmul")})
        del grads
    (lc, gc, nc, tiles), (lt, gt, nt, _) = out["cuda"], out["torch"]
    zero_leaves = sorted(p for p in gt if any(z in p for z in zero))
    nonzero = [f"{b} {p}" for b, g in (("cuda", gc), ("torch", gt))
               for p in zero_leaves if bool(g[p].any())]
    loss_err = abs(float(lc) - float(lt)) / abs(float(lt))
    grad_errs = {p: _rel(gc[p], gt[p]) for p in gt if p not in zero_leaves}
    worst = max(grad_errs, key=grad_errs.get)
    what = f"{extra.get('method', 'train step')} {dtype_name}"
    emit({"phase": phase, **extra, "activations": dtype_name,
          "rows": int(batch["tokens"].numel()), "loss_cuda": float(lc),
          "loss_torch": float(lt), "loss_rel_err": loss_err,
          "loss_tol": loss_tol, "grad_leaves": len(grad_errs),
          "max_grad_rel_err": grad_errs[worst], "worst_leaf": worst,
          "median_grad_rel_err": sorted(grad_errs.values())[
              len(grad_errs) // 2], "grad_tol": grad_tol,
          "launches_cuda": nc, "tiles_cuda": tiles, "peak_memory_gb": peak,
          **({"zero_grad_leaves": zero_leaves, "nonzero": nonzero}
             if zero else {}),
          **({"routing_flips": pin.flips} if pin else {})})
    require(all(torch.isfinite(g).all() for g in gc.values()),
            f"{what}: a cuda gradient is not finite")
    require(len(zero_leaves) >= len(zero) and not nonzero,
            f"{what}: gradients that must be 0: {zero_leaves}, non-zero: "
            f"{nonzero}")
    require(loss_err <= loss_tol,
            f"{what}: loss rel err {loss_err} > {loss_tol}")
    require(grad_errs[worst] <= grad_tol,
            f"{what}: gradient {worst} rel err {grad_errs[worst]} > "
            f"{grad_tol}")
    require(all(nc[n] > 0 for n in needs),
            f"{what}: the cuda step did not launch its kernels {needs}")
    want = "mma" if dtype_name == "bfloat16" else "f32"
    for name in ("flash_attention", "lora_matmul"):
        require(tiles[name][want] == nc[name],
                f"{what}: {name} tiles {tiles[name]}, not all {want}")
    require(all(n == 0 for n in nt.values()),
            f"{what}: the torch step launched a CUDA kernel")
    return nc


def compare_train_step(model, cfg, params, adapters, batch, dtype_name,
                       loss_tol, grad_tol, **kw):
    """``compare_grads`` for the plain LoRA train step; returns the "cuda"
    step's launch counts."""
    from repro_torch.training.train_step import lora_value_and_grad
    return compare_grads(lambda backend: lora_value_and_grad(
        model, cfg, backend)(params, adapters, batch), batch, dtype_name,
        loss_tol, grad_tol, **kw)


def compare_fused_eval(model, cfg, params, ad_p, ad_s, batch, dtype_name,
                       tol, pin=None, **extra):
    """The AdaFusion objective at w = (0.6, 0.6) through "cuda" (the
    dual-LoRA kernel merges on the chip) and "torch" (merge, then the plain
    forward): ``|Δloss| <= tol·|loss|``; ``pin`` as ``compare_grads``'."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.training.train_step import make_fused_eval_fn
    w = np.asarray([0.6, 0.6], np.float32)
    losses, counts = {}, {}
    for backend in ("cuda", "torch"):
        kernels.reset_launch_counts()
        with pin(backend) if pin else contextlib.nullcontext():
            loss, _ = make_fused_eval_fn(model, cfg, backend)(
                params, ad_p, ad_s, w, batch)
        losses[backend], counts[backend] = float(loss), kernels.launch_counts()
        if backend == "cuda":
            tiles = kernels.tile_counts()["dual_lora_matmul"]
    err = abs(losses["cuda"] - losses["torch"]) / abs(losses["torch"])
    emit({"phase": "compare_fused_eval", **extra,
          "activations": dtype_name,
          "w": w.tolist(), "loss_cuda": losses["cuda"],
          "loss_torch": losses["torch"], "loss_rel_err": err, "tol": tol,
          "launches_cuda": counts["cuda"], "dual_lora_tiles_cuda": tiles,
          **({"routing_flips": pin.flips} if pin else {})})
    require(err <= tol, f"{dtype_name} fused-eval loss rel err {err} > {tol}")
    require(counts["cuda"]["dual_lora_matmul"] > 0,
            "the cuda fused evaluation did not launch dual_lora_matmul")
    want = "mma" if dtype_name == "bfloat16" else "f32"
    require(tiles[want] == counts["cuda"]["dual_lora_matmul"],
            f"{dtype_name} fused evaluation: dual_lora_matmul tiles {tiles}, "
            f"not all {want}")
    require(all(n == 0 for n in counts["torch"].values()),
            "the torch fused evaluation launched a CUDA kernel")


# the train and baselines cells' data: 2 clients of 8 x 256-token SFT
# batches of log windows (64 examples each), and 32 held-out examples per
# client from generators of their own
TRAIN_CLIENTS, TRAIN_BATCH, TRAIN_SEQ, HELD_OUT = 2, 8, 256, 32


def train_batchers(seed: int):
    import numpy as np
    from repro_torch.data.pipeline import SFTBatcher
    from repro_torch.data.synthetic import gen_log_dataset
    from repro_torch.data.tokenizer import ByteTokenizer
    rng = np.random.default_rng(seed)
    return [SFTBatcher(gen_log_dataset(rng, 64, i), ByteTokenizer(),
                       TRAIN_SEQ, TRAIN_BATCH, seed=i)
            for i in range(TRAIN_CLIENTS)]


def held_out_examples(seed: int, n_clients: int):
    import numpy as np
    from repro_torch.data.synthetic import gen_log_dataset
    return [gen_log_dataset(np.random.default_rng(seed + 1000 + i), HELD_OUT,
                            i) for i in range(n_clients)]


def train_phase(device, seed: int, params, cfg):
    """FDLoRA on llama2-7b: the cuda/torch comparisons, then the fit through
    the kernels, FDLoRA's answer accuracy on the held-out examples,
    publish and serve, and one traced train step.  Returns the launch
    counts of the fit and the accuracy per client."""
    import math

    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core.fdlora import FDLoRAConfig, FDLoRATrainer
    from repro_torch.core.lora import init_adapters, tree_leaves
    from repro_torch.data.synthetic import answer_accuracy, gen_log_dataset
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.models.api import Model
    from repro_torch.serving.engine import (MultiTenantEngine, Request,
                                            ServeConfig)
    from repro_torch.serving.registry import AdapterRegistry
    from repro_torch.training.train_step import make_lora_train_step
    from repro_torch.training.optimizers import adamw

    model = Model(cfg, device)
    tok = ByteTokenizer()
    S, B, n_clients = TRAIN_SEQ, TRAIN_BATCH, TRAIN_CLIENTS
    batchers = train_batchers(seed)

    def dev_batch(raw, rows=None):
        return {k: torch.as_tensor(v[:rows]).to(device)
                for k, v in raw.items()}

    # 1-2: "cuda" against "torch" from the same adapters (B non-zero) and
    # the same batch.  bf16: the paths round at other places (the LoRA
    # kernels round once where the plain dense rounds twice, the attention
    # tile rounds unnormalised probabilities) through every layer, forward and
    # backward; the serve phase's logits differ by 3.7% of their largest
    # value for that reason alone.  A lost LoRA term, a wrong mask or a
    # wrong backward term moves a gradient by O(its size), so the bounds
    # are 2% on the loss and 25% per gradient leaf.  fp32 activations over
    # the same bf16 weights: summation order only, so 1e-3 and 1e-2.
    ad = init_adapters(cfg, seed=seed + 100, device=device, b_std=0.02)
    ad_s = init_adapters(cfg, seed=seed + 101, device=device, b_std=0.02)
    raw = batchers[0].sample()
    t0 = time.perf_counter()
    compare_train_step(model, cfg, params, ad, dev_batch(raw), "bfloat16",
                       loss_tol=2e-2, grad_tol=0.25)
    compare_fused_eval(model, cfg, params, ad, ad_s, dev_batch(raw),
                       "bfloat16", tol=2e-2)
    cfg32 = cfg.with_overrides(dtype="float32")
    model32 = Model(cfg32, device)
    # half the batch: the plain fp32 path keeps an fp32 copy of every
    # weight it multiplies for its backward (26 GB at full depth)
    compare_train_step(model32, cfg32, params, ad, dev_batch(raw, B // 2),
                       "float32", loss_tol=1e-3, grad_tol=1e-2)
    compare_fused_eval(model32, cfg32, params, ad, ad_s, dev_batch(raw),
                       "float32", tol=1e-3)
    del ad, ad_s, model32
    torch.cuda.empty_cache()
    compare_s = time.perf_counter() - t0

    # 3-4: the whole of Algorithm 1 through the kernels
    fed = FDLoRAConfig(n_clients=n_clients, stage1_steps=2, rounds=2,
                       inner_steps=2, sync_every=1, fusion_steps=1,
                       few_shot_k=8, batch_size=B, seed=seed)
    tr = FDLoRATrainer(model, cfg, fed, params, device=device)
    require(tr.paged_backend == "cuda", "the trainer did not pick 'cuda'")
    step_s = []
    inner_step = tr._step

    def timed_step(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner_step(*args)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        return out
    tr._step = timed_step
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clients = tr.stage1(batchers)
    tr.stage2(clients, batchers)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tr.stage3(clients, batchers)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = kernels.launch_counts()
    tiles = kernels.tile_counts()
    losses = [h["loss"] for h in tr.history]
    weights = [c.fusion_weights.tolist() for c in clients]
    med = float(np.median(step_s))
    fit_peak = torch.cuda.max_memory_allocated() / 1e9
    # one more train step (client 0's personalized adapter, a fresh AdamW
    # state, a batch of the cell) beside the dry run's prediction
    opt = adamw()
    _, predicted = predicted_step(
        cfg, make_lora_train_step(model, cfg, opt, paged_backend="cuda"),
        (params, clients[0].personalized,
         opt.init(clients[0].personalized), dev_batch(batchers[0].sample())),
        B, S)
    emit({"phase": "train", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "dtype": cfg.dtype, "rank": cfg.lora_rank,
          "alpha": cfg.lora_alpha, "targets": list(cfg.lora_targets),
          "clients": n_clients, "batch": B, "seq": S,
          "train_steps": len(step_s),
          "fused_evals": n_clients * (1 + 8 * fed.fusion_steps),
          "step_s": step_s, "median_step_s": med,
          "train_tokens_per_s": B * S / med,
          "stage1_2_s": t1 - t0, "stage3_s": t2 - t1,
          "round_losses": losses, "fusion_weights": weights,
          "peak_memory_gb": fit_peak, "predicted_step": predicted,
          "launches": counts, "tile_launches": tiles,
          "compare_s": compare_s})
    require(len(step_s) == 12, f"{len(step_s)} train steps, not 12")
    require(all(math.isfinite(x) for x in losses), "a round loss is not finite")
    require(all(math.isfinite(x) for w in weights for x in w),
            "a fusion weight is not finite")
    require(all(bool(torch.isfinite(t).all())
                for c in clients for _, t in tree_leaves(c.personalized)),
            "a personalized adapter is not finite")
    for name in kernels.TRAINING:
        require(counts[name] > 0,
                f"kernel {name} was never launched on the training path")
    for name in ("flash_attention", "lora_matmul", "dual_lora_matmul"):
        require_mma_tile(tiles, name, "train")
    # FDLoRA's fused adapters on the held-out examples, beside which the
    # baselines phase reads its methods'
    t0 = time.perf_counter()
    accuracy = [answer_accuracy(model, cfg, params, tr.fused_adapters(c),
                                ex, tok, S, tr.scale)
                for c, ex in zip(clients, held_out_examples(seed, n_clients))]
    emit({"phase": "train_accuracy", "method": "fdlora",
          "held_out_per_client": HELD_OUT, "max_len": S,
          "answer_accuracy": accuracy, "s": time.perf_counter() - t0})

    # 5: publish into the serving slice and generate from it
    registry = AdapterRegistry(cfg, capacity=n_clients, device=device)
    slots = tr.publish(registry, clients)
    eng = MultiTenantEngine(model, cfg, params, registry)
    kernels.reset_launch_counts()
    prompts = [gen_log_dataset(np.random.default_rng(seed + 7), 1, i)[0]
               for i in range(n_clients)]
    reqs = [Request(f"client{i}", np.asarray(tok.encode(ex.prompt), np.int32))
            for i, ex in enumerate(prompts)]
    outs = eng.generate(reqs, ServeConfig(batch_size=n_clients,
                                          max_new_tokens=8, prefill_chunk=64,
                                          block_size=16, paged_backend="cuda"))
    emit({"phase": "publish_and_serve", "slots": slots,
          "versions": {c: registry.version(c) for c in slots},
          "prompt_lens": [len(r.prompt) for r in reqs],
          "tokens": [[int(t) for t in o] for o in outs]})
    require(all(len(o) == 8 and all(0 <= t < cfg.vocab_size for t in o)
                for o in outs), "a stream from the published adapters is "
            "malformed")
    require_mma_tile(kernels.tile_counts(), "batched_lora_matmul",
                     "publish_and_serve")
    del eng, registry

    # one traced train step
    step = make_lora_train_step(model, cfg, adamw(), paged_backend="cuda")
    ad = clients[0].personalized
    st = adamw().init(ad)
    batch = dev_batch(batchers[0].sample())
    wall_ms, fam = traced(lambda: step(params, ad, st, batch),
                          TRAIN_FAMILIES,
                          "other device work (norms, rope, softmax, "
                          "elementwise, optimizer)")
    emit(_profile_line(fam, wall_ms, phase="profile_train_step",
                       rows=B * S))
    # one traced fused evaluation, stage 3's unit of work, as the trainer
    # runs it (client 0's personalized adapter and the global one)
    wall_ms, fam = traced(lambda: tr.fused_eval_loss(
        clients[0], [0.6, 0.6], batchers[0].sample()), FUSED_EVAL_FAMILIES,
        "other device work (norms, rope, softmax, elementwise, lm_head, "
        "loss, copies)")
    dual = sum(v for k, v in fam.items() if k.startswith("dual_lora_matmul"))
    emit(_profile_line(fam, wall_ms, phase="profile_fused_eval", rows=B * S,
                       dual_lora_matmul_ms=dual,
                       dual_lora_matmul_share_of_busy=dual / max(
                           sum(fam.values()), 1e-30)))
    return counts, accuracy


# ---------------------------------------------------------------------------
# phase 5b: the federated baselines, answer_accuracy and the client-stacked
# round step
# ---------------------------------------------------------------------------

# the paper's comparison, cut from 5 clients x 30 rounds to the train cell's
# 2 clients, 2 rounds of one local step each
BASELINE_FED = dict(n_clients=TRAIN_CLIENTS, rounds=2, local_steps=1)


def _finite(tree) -> bool:
    import torch
    from repro_torch.core.lora import tree_leaves
    return all(bool(torch.isfinite(t).all()) for _, t in tree_leaves(tree))


def compare_baseline_steps(model, cfg, params, batch, dtype_name, loss_tol,
                           grad_tol, seed, rows):
    """One step's loss and gradients of FedProx, FedRoD and FedKD through
    "cuda" and "torch" (``compare_grads``) from the same adapters (B
    non-zero) and batch, its first ``rows[method]`` rows: FedProx a rank-r
    adapter with a rank-r global one in its prox term, FedRoD a rank-r
    generic and personal pair (its second forward at rank 2r), FedKD a
    rank-r teacher and a rank-r/2 student."""
    import torch
    from repro_torch.core.lora import init_adapters
    from repro_torch.federated.baselines import BASELINES, FedConfig
    from repro_torch.training.train_step import value_and_grad
    r = cfg.lora_rank
    fed = FedConfig(**BASELINE_FED, seed=seed)
    for k, (name, ranks) in enumerate((("fedprox", (r, r)),
                                       ("fedrod", (r, r)),
                                       ("fedkd", (r, max(2, r // 2))))):
        first, second = (init_adapters(cfg, rank=rk, seed=seed + 110 + 2 * k
                                       + j, device=model.device, b_std=0.02)
                         for j, rk in enumerate(ranks))
        trees, extra = ((first, (second,)) if name == "fedprox"
                        else ((first, second), ()))
        b = {key: v[:rows[name]] for key, v in batch.items()}

        def vg(backend):
            method = BASELINES[name](model, cfg, fed, params,
                                     device=model.device,
                                     paged_backend=backend)
            return value_and_grad(method.loss_fn())(trees, params, b, *extra)
        compare_grads(vg, b, dtype_name, loss_tol, grad_tol,
                      phase="compare_baseline_step", method=name,
                      ranks=list(ranks))


def compare_answer_accuracy(model, cfg, params, adapters, examples, tok,
                            max_len, scale):
    """``answer_accuracy`` through "cuda" and "torch" on the same adapters
    and examples: the greedy answer byte must agree on every example whose
    top-2 margin at the answer position ("torch" logits) is at least twice
    the largest logit difference there (``serve_options``' margin rule), so
    the accuracies differ by at most the examples under it."""
    import torch
    from repro_torch import kernels
    from repro_torch.data.synthetic import answer_accuracy, answer_logits
    from repro_torch.models.api import Model
    model_t = Model(cfg.with_overrides(paged_backend="torch"), model.device)
    out = {}
    for backend, m in (("cuda", model), ("torch", model_t)):
        kernels.reset_launch_counts()
        logits = answer_logits(m, params, adapters, examples, tok, max_len,
                               scale)
        acc = answer_accuracy(m, cfg, params, adapters, examples, tok,
                              max_len, scale)
        torch.cuda.synchronize()
        out[backend] = (logits, acc, kernels.launch_counts(),
                        kernels.tile_counts())
    (lc, acc_c, nc, tiles), (lt, acc_t, nt, _) = out["cuda"], out["torch"]
    err = float((lc - lt).abs().max())
    top2 = torch.topk(lt, 2, dim=-1).values
    close = (top2[:, 0] - top2[:, 1]) < 2 * err
    differ = lc.argmax(-1) != lt.argmax(-1)
    emit({"phase": "compare_answer_accuracy", "examples": len(examples),
          "max_len": max_len, "accuracy_cuda": acc_c, "accuracy_torch": acc_t,
          "max_abs_logit_err": err, "max_abs_logit": float(lt.abs().max()),
          "under_margin": int(close.sum()), "picks_differ": int(differ.sum()),
          "launches_cuda": {k: nc[k] for k in ("lora_matmul",
                                               "flash_attention")}})
    require(not bool((differ & ~close).any()),
            f"answer_accuracy: {int((differ & ~close).sum())} examples pick "
            f"another answer byte through cuda though their margin is at "
            f"least 2 x {err}")
    require(abs(acc_c - acc_t) * len(examples) <= int(close.sum()) + 1e-6,
            f"answer_accuracy cuda {acc_c} vs torch {acc_t}")
    for name in ("lora_matmul", "flash_attention"):
        require_mma_tile(tiles, name, "answer_accuracy")
    require(all(n == 0 for n in nt.values()),
            "the torch answer_accuracy launched a CUDA kernel")


def round_step_check(model, cfg, params, batchers, seed, K: int = 2):
    """One ``make_fdlora_round_step`` round over the clients stacked on a
    leading axis (K inner steps each, the paper's Nesterov outer step at
    FDLoRAConfig's defaults), with ``compress_outer`` "none" and "bf16"
    from the same θ_s (B non-zero) and batches, ``sync_personalized`` on so
    that each run's θ_i come back.

    The bound on the bf16 run: each client's pseudo-gradient d_i = θ_s −
    θ_i rounds to bf16 (8 significant bits: relative error ≤ 2^-8), and
    so does their mean (another 2^-8 of a value ≤ (1 + 2^-8)·max_i |d_i|),
    so the mean is off by at most 2^-7·(1 + 2^-9)·max_i |d_i|; the first
    Nesterov step (velocity from zero) moves θ_s by lr·(1 + momentum) times
    it.  So, elementwise, |θ'_bf16 − (θ_s − lr·(1 + μ)·mean_i d_i)| ≤
    lr·(1 + μ)·2^-7·(1 + 2^-8)·max_i |d_i| plus two fp32 ulps of θ' for
    the outer step's own rounding (the "none" run is held to those two
    ulps alone)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core.fdlora import FDLoRAConfig
    from repro_torch.core.lora import init_adapters, tree_leaves
    from repro_torch.core.outer_opt import make_outer_optimizer
    from repro_torch.federated.distributed import (make_fdlora_round_step,
                                                   stack_clients)
    from repro_torch.training.optimizers import adamw
    fc = FDLoRAConfig()
    inner = adamw(lr=fc.inner_lr, weight_decay=fc.inner_weight_decay)
    outer = make_outer_optimizer(fc.outer_kind, fc.outer_lr,
                                 fc.outer_momentum)
    step_lr = fc.outer_lr * (1 + fc.outer_momentum)
    theta = init_adapters(cfg, seed=seed + 120, device=model.device,
                          b_std=0.02)
    samples = [[b.sample() for _ in range(K)] for b in batchers]
    batches = {key: torch.as_tensor(np.stack([np.stack([s[key] for s in row])
                                              for row in samples])
                                    ).to(model.device)
               for key in ("tokens", "loss_mask")}
    runs = {}
    for compress in ("none", "bf16"):
        state = {"inner_opt": stack_clients([inner.init(theta)]
                                            * len(batchers)),
                 "outer_opt": outer.init(theta)}
        rs = make_fdlora_round_step(model, cfg, inner, outer, K,
                                    sync_personalized=True,
                                    compress_outer=compress)
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, st, loss = rs(params, theta, state, batches)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts, tiles = kernels.launch_counts(), kernels.tile_counts()
        worst, moved, at = 0.0, 0, {}
        for (path, prev), (_, got), (_, ti) in zip(
                tree_leaves(theta), tree_leaves(new),
                tree_leaves(st["personalized"])):
            d = prev[None] - ti
            upd = step_lr * (prev - ti.mean(dim=0))
            want = prev - upd
            # two ulps of θ' and four of the update (its own roundings,
            # which alone remain where θ_s and the update cancel)
            bnd = (2.0 ** -22 * torch.maximum(got.abs(), want.abs())
                   + 2.0 ** -21 * upd.abs())
            if compress == "bf16":
                bnd = bnd + (step_lr * 2.0 ** -7 * (1 + 2.0 ** -8)
                             * d.abs().amax(dim=0))
            ratio = (got - want).abs() / bnd.clamp(min=1e-30)
            i = int(ratio.argmax())
            if float(ratio.reshape(-1)[i]) > worst:
                worst = float(ratio.reshape(-1)[i])
                at = {"leaf": path, **{k: float(t.reshape(-1)[i]) for k, t in
                                       (("theta_s", prev), ("got", got),
                                        ("want", want), ("update", upd))}}
            moved += int((got != want).sum())
        runs[compress] = st["personalized"]
        emit({"phase": "round_step", "compress_outer": compress,
              "clients": len(batchers), "inner_steps": K,
              "batch": list(batches["tokens"].shape[2:]),
              "outer": [fc.outer_kind, fc.outer_lr, fc.outer_momentum],
              "s_per_round": secs,
              "train_tokens_per_s": batches["tokens"].numel() / secs,
              "loss": float(loss), "max_err_over_bound": worst,
              "worst_element": at, "elements_off_the_fp32_step": moved,
              "launches": {k: counts[k] for k in ("lora_matmul",
                                                  "flash_attention")}})
        require(bool(torch.isfinite(loss)) and _finite(new),
                f"round step ({compress}): θ_s' or the loss is not finite")
        require(worst <= 1.0, f"round step ({compress}): θ_s' off the "
                f"outer step from its own θ_i by {worst} x the bound")
        for name in ("lora_matmul", "flash_attention"):
            require_mma_tile(tiles, name, f"round step ({compress})")
        del new, st, state
    same = all(torch.equal(a, b) for (_, a), (_, b) in
               zip(tree_leaves(runs["none"]), tree_leaves(runs["bf16"])))
    emit({"phase": "round_step_theta_i", "bitwise_equal_across_runs": same})


def baselines_phase(device, seed: int, params, cfg, fdlora_accuracy):
    """The six baselines and Local on llama2-7b through the kernels at the
    train cell's data (``BASELINE_FED``), each with s per round, train
    tokens/s, peak memory, bytes communicated, its kernel launches by tile
    and its adapters' answer accuracy on the held-out examples beside
    FDLoRA's; "cuda" against "torch" on one step of FedProx, FedRoD and
    FedKD and on ``answer_accuracy``; the client-stacked round step; one
    traced FedRoD step."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core.lora import init_adapters, lora_scale, tree_leaves
    from repro_torch.data.synthetic import answer_accuracy
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.federated.baselines import BASELINES, FedConfig
    from repro_torch.models.api import Model

    model = Model(cfg, device)
    tok = ByteTokenizer()
    S, B = TRAIN_SEQ, TRAIN_BATCH
    held = held_out_examples(seed, TRAIN_CLIENTS)
    raw = train_batchers(seed)[0].sample()
    batch = {k: torch.as_tensor(v).to(device) for k, v in raw.items()}
    t0 = time.perf_counter()
    # 1: the new loss terms, "cuda" against "torch", at the train phase's
    # bounds; fp32 activations at fewer rows: the plain fp32 path keeps an
    # fp32 copy of every weight it multiplies for its backward (26 GB at
    # full depth), once per forward, and FedRoD and FedKD run two
    compare_baseline_steps(model, cfg, params, batch, "bfloat16", 2e-2, 0.25,
                           seed, rows={"fedprox": B, "fedrod": B,
                                       "fedkd": B})
    cfg32 = cfg.with_overrides(dtype="float32")
    compare_baseline_steps(Model(cfg32, device), cfg32, params, batch,
                           "float32", 1e-3, 1e-2, seed,
                           rows={"fedprox": B // 2, "fedrod": 1, "fedkd": 1})
    compare_s = time.perf_counter() - t0

    # 2: each method's fit through the kernels
    fed = FedConfig(**BASELINE_FED, seed=seed)
    steps = fed.rounds * fed.n_clients * fed.local_steps
    comm, kept = {}, None
    for name, cls in BASELINES.items():
        method = cls(model, cfg, fed, params, device=device)
        require(method.paged_backend == "cuda",
                f"{name} did not pick 'cuda'")
        batchers = train_batchers(seed)
        # each step starts by moving its batch to the card: the times
        # between those moves (synchronised) are the steps' (with a
        # round's aggregation in the step after it)
        marks, to_dev = [], method._dev

        def marked(raw, to_dev=to_dev, marks=marks):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            return to_dev(raw)
        method._dev = marked
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ads = method.fit(batchers)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        step_s = np.diff(marks + [t1 + secs]).tolist()
        counts, tiles = kernels.launch_counts(), kernels.tile_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        t2 = time.perf_counter()
        acc = [answer_accuracy(model, cfg, params, ad, ex, tok, S,
                               method.scale) for ad, ex in zip(ads, held)]
        ranks = sorted({t.shape[1] for ad in ads for p, t in tree_leaves(ad)
                        if p.endswith("['a']")})
        comm[name] = method.comm_bytes
        emit({"phase": "baselines", "method": name, **BASELINE_FED,
              "cut": "5 clients x 30 rounds (the paper's) cut to 2 x 2",
              "batch": B, "seq": S, "train_steps": steps,
              "s": secs, "s_per_round": secs / fed.rounds,
              "step_s": step_s,
              "train_tokens_per_s": steps * B * S / secs,
              "peak_memory_gb": peak, "comm_bytes": method.comm_bytes,
              "returned_ranks": ranks,
              "launches": {k: counts[k] for k in ("lora_matmul",
                                                  "flash_attention")},
              "tiles": {k: tiles[k] for k in ("lora_matmul",
                                              "flash_attention")},
              "answer_accuracy": acc,
              "fdlora_answer_accuracy": fdlora_accuracy,
              "held_out_per_client": HELD_OUT,
              "accuracy_s": time.perf_counter() - t2})
        require(len(ads) == fed.n_clients and all(_finite(a) for a in ads),
                f"{name}: a returned adapter is not finite")
        require((method.comm_bytes == 0) == (name == "local"),
                f"{name}: comm_bytes {method.comm_bytes}")
        for k in ("lora_matmul", "flash_attention"):
            require_mma_tile(tiles, k, name)
        require(all(counts[k] == 0 for k in counts
                    if k not in ("lora_matmul", "flash_attention")),
                f"{name} launched a kernel off the training path: {counts}")
        if name == "fedavg":
            require(all(torch.equal(a, b) for (_, a), (_, b) in
                        zip(tree_leaves(ads[0]), tree_leaves(ads[1]))),
                    "FedAvg's clients differ")
            kept = ads[0]
        del ads, method
    require(comm["fedkd"] < comm["fedavg"],
            f"FedKD sent {comm['fedkd']} bytes, not fewer than FedAvg's "
            f"{comm['fedavg']}")

    # 3: answer_accuracy "cuda" against "torch" on FedAvg's adapters
    compare_answer_accuracy(model, cfg, params, kept, held[0], tok, S,
                            lora_scale(cfg))
    del kept

    # 4: the client-stacked round step
    round_step_check(model, cfg, params, train_batchers(seed), seed)

    # 5: one traced FedRoD step (two forwards, the second at rank 2r)
    rod = BASELINES["fedrod"](model, cfg, fed, params, device=device)
    step = rod._make_step(rod.loss_fn())
    pair = tuple(init_adapters(cfg, seed=seed + 130 + j, device=device,
                               b_std=0.02) for j in range(2))
    st = rod.opt.init(pair)
    wall_ms, fam = traced(lambda: step(pair, st, batch), TRAIN_FAMILIES,
                          "other device work (norms, rope, softmax, "
                          "elementwise, optimizer)")
    emit(_profile_line(fam, wall_ms, phase="profile_baseline_step",
                       method="fedrod", rows=B * S, compare_s=compare_s))


# ---------------------------------------------------------------------------
# phase 6: the rest of the dense family at full width, 8 layers at most
# ---------------------------------------------------------------------------

# why each arch is here: gemma-2b runs head dim 256 (one kv head, a 256,000
# token tied vocabulary); olmo-1b MHA with a non-parametric LayerNorm and
# tied embeddings; yi-6b GQA 8 over 32 layers; starcoder2-15b G 12, a
# gate-less GELU MLP (6 LoRA targets), LayerNorm with bias and a 4,096
# token sliding window
DENSE_FAMILY = ("gemma-2b", "olmo-1b", "yi-6b", "starcoder2-15b")
DENSE_LAYERS = 8            # the script's time limit: yi-6b 8 of 32,
                            # starcoder2-15b 8 of 40, gemma-2b 8 of 18,
                            # olmo-1b 8 of 16
DENSE_TENANTS = 4
DENSE_REQUESTS = 4          # and one of LONG_PROMPT tokens under a window
LONG_PROMPT = 4608


def dense_requests(arch) -> int:
    """The requests phase dense_family serves ``arch`` at once."""
    from repro_torch.configs import get_config
    return DENSE_REQUESTS + bool(get_config(arch).sliding_window)


def projection_shapes(arch):
    """The (K, N) of ``arch``'s projections that run batched_lora_matmul,
    sorted: every LoRA target but an MoE router (whose adapter takes the
    plain lora_delta)."""
    from repro_torch.configs import get_config
    from repro_torch.core.lora import block_target_shapes
    cfg = get_config(arch)
    return sorted({kn for entry in cfg.layer_pattern
                   for part in block_target_shapes(cfg, entry).values()
                   for name, kn in part.items() if name != "router"})


def window_chunk_check(eng, req, sc, dtype_name, rel_tol):
    """``req``'s prompt (longer than the window) fed in chunks through
    "cuda" up to its last chunk; then the last chunk, where every query's
    window starts past position 0, through "cuda" and "torch" on copies
    of the same pools: ``compare_first_chunk``'s rule over every position
    of the chunk (max logit error within ``rel_tol`` of the largest logit;
    the greedy token equal wherever the top-2 margin exceeds twice it).
    The same chunk through "torch" with the window off must miss "torch"
    with it by more than that limit, so the check sees the window."""
    import copy
    import dataclasses

    import torch
    from repro_torch import kernels
    from repro_torch.models.api import Model
    cfg = eng.model.cfg
    no_window = copy.copy(eng)
    no_window.model = Model(cfg.with_overrides(sliding_window=0), eng.device)
    T, n = sc.prefill_chunk, len(req.prompt)
    last0 = (n - 1) // T * T
    require(last0 >= cfg.sliding_window > 0,
            f"the last chunk (from {last0}) does not pass the window "
            f"{cfg.sliding_window}")
    kv, cache = _fresh_pool(eng, sc, n)
    kv.admit(0)
    head = dataclasses.replace(req, prompt=req.prompt[:last0])
    _, cache = feed_chunks(eng, kv, cache, 0, head, sc, "cuda")
    out = {}
    for name, e, backend in (("cuda", eng, "cuda"), ("torch", eng, "torch"),
                             ("no_window", no_window, "torch")):
        kernels.reset_launch_counts()
        pools = {"layers": [{k: t.clone() for k, t in layer.items()}
                            for layer in cache["layers"]]}
        (pos, logits), = feed_chunks(e, copy.deepcopy(kv), pools, 0, req,
                                     sc, backend)[0]
        out[name] = (logits, kernels.launch_counts())
        del pools
    (lc, nc), (lt, nt), (ln, nn) = out["cuda"], out["torch"], out["no_window"]
    err = float((lc - lt).abs().max())
    window_effect = float((ln - lt).abs().max())
    top = float(lt.abs().max())
    top2 = torch.topk(lt, 2, dim=-1).values
    decisive = (top2[:, 0] - top2[:, 1]) > 2 * err
    agree = lc.argmax(-1) == lt.argmax(-1)
    emit({"phase": "window_chunk", "arch": cfg.name, "activations": dtype_name,
          "window": cfg.sliding_window, "prompt_len": n,
          "chunk_first_position": pos, "positions": int(lc.shape[0]),
          "max_abs_logit_err": err, "max_abs_logit": top,
          "tol": rel_tol * top, "decisive_positions": int(decisive.sum()),
          "greedy_agree": int(agree.sum()),
          "no_window_max_abs_logit_diff": window_effect,
          "launches_cuda": nc})
    require(bool(torch.isfinite(lc).all()), "window chunk: cuda logits not "
            "finite")
    require(err <= rel_tol * top, f"{cfg.name} {dtype_name} window chunk: "
            f"logit error {err} > {rel_tol * top}")
    require(bool(agree[decisive].all()), f"{cfg.name} window chunk: a greedy "
            "token differs where the margin exceeds twice the error")
    require(window_effect > rel_tol * top, f"{cfg.name} {dtype_name} window "
            f"chunk: without the window the logits move {window_effect}, "
            f"not past the limit {rel_tol * top}")
    require(nc["paged_prefill_attention"] > 0
            and all(v == 0 for v in (*nt.values(), *nn.values())),
            f"window chunk launches: cuda {nc}, torch {nt}, {nn}")


def serve_and_check(eng, reqs, sc, needs, mma_names, extra=None,
                    off_ctx=None):
    """Serve ``reqs`` through ``sc.paged_backend`` with overlap on, then
    off (the counts and peak memory reset before each run), emitting a
    ``serve`` line for each (``extra``'s fields added); every stream must be
    ``sc.max_new_tokens`` tokens of the vocabulary, each kernel of
    ``needs`` launched, each of ``mma_names`` on its tensor-core tile
    only, and the streams of the two runs bitwise equal.  ``off_ctx``: a
    context manager the overlap-off run runs under.  Returns ({overlap:
    streams}, the overlap-on run's launch counts)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.launch.serve import timed_stream
    cfg = eng.cfg
    streams, counts = {}, None
    for overlap in (True, False):
        sc.overlap = overlap
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        with (off_ctx if off_ctx is not None and not overlap
              else contextlib.nullcontext()):
            outs, ttft, dec_s, dec_tok, total_s = timed_stream(eng, reqs,
                                                                 sc)
        launches = kernels.launch_counts()
        tiles = kernels.tile_counts()
        st = eng.last_stats
        emit({"phase": "serve", "arch": cfg.name, "backend": sc.paged_backend,
              "overlap": overlap, "requests": len(reqs),
              "prompt_lens": [len(r.prompt) for r in reqs],
              "new_tokens": sc.max_new_tokens,
              "prefill_chunk": sc.prefill_chunk,
              "tokens": sum(len(o) for o in outs),
              "ttft_ms_p50": float(np.percentile(ttft, 50)) * 1e3,
              "ttft_ms_max": max(ttft) * 1e3,
              "decode_tokens": dec_tok, "decode_s": dec_s,
              "decode_tok_per_s": dec_tok / dec_s if dec_s > 0 else None,
              "total_s": total_s,
              "prefill_dispatches": st["prefill_dispatches"],
              "decode_dispatches": st["decode_dispatches"],
              "launches": launches, "tile_launches": tiles,
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
              **(extra or {})})
        for o in outs:
            require(len(o) == sc.max_new_tokens
                    and all(0 <= t < cfg.vocab_size for t in o),
                    f"{cfg.name}: a stream is malformed")
        for name in needs:
            require(launches[name] > 0, f"{cfg.name}: kernel {name} was "
                    "never launched on the serving path")
        for name in mma_names:
            require_mma_tile(tiles, name, f"{cfg.name} overlap={overlap}")
        streams[overlap] = outs
        if overlap:
            counts = launches
    require(streams[True] == streams[False],
            f"{cfg.name}: streams with overlap on and off differ")
    return streams, counts


class Ranges:
    """Puts each function ``module.attr`` of ``wrapped`` ({(module, attr):
    ``record_function`` name}) under its range for one traced run, and
    sums the host seconds spent in those calls and their number (their
    kernels run asynchronously, so this is the cost of issuing them; a
    call inside another wrapped one counts in both).  Nothing in the
    package changes: the wrappers are installed and removed around the
    run."""

    def __init__(self, wrapped):
        self.wrapped = wrapped
        self.host_s, self.calls = 0.0, 0

    def __enter__(self):
        self._orig = {key: getattr(*key) for key in self.wrapped}
        for (mod, attr), name in self.wrapped.items():
            setattr(mod, attr, self._ranged(self._orig[mod, attr], name))
        return self

    def _ranged(self, orig, name):
        from torch.profiler import record_function

        def call(*a, **kw):
            t = time.perf_counter()
            with record_function(name):
                out = orig(*a, **kw)
            self.host_s += time.perf_counter() - t
            self.calls += 1
            return out
        return call

    def __exit__(self, *exc):
        for (mod, attr), orig in self._orig.items():
            setattr(mod, attr, orig)


def dense_family_phase(device, seed: int, T: int = 256,
                       tenants: int = DENSE_TENANTS, rank: int = 16,
                       new_tokens: int = 16):
    """Each of ``DENSE_FAMILY`` at its published width and at most
    ``DENSE_LAYERS`` of its layers (the script's time limit), bf16, seeded
    weights, ``tenants`` rank-16 fused adapters: 4 requests
    (prompts from the seed in [128, 1024]; starcoder2-15b one more of
    4,608 tokens), greedy, through "cuda" with overlap on and off (streams
    bitwise equal, every serving kernel launched, prefill attention and
    batched LoRA on their tensor-core tiles), the first chunk against
    "torch" (bf16 <= 10%, fp32 activations <= 1%); gemma-2b also a train
    step against "torch" (flash attention at head dim 256), starcoder2-15b
    its long prompt's last chunk against "torch" with the window binding.
    Returns {arch: launch counts of its overlapped run}."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.lora import init_adapters
    from repro_torch.data.pipeline import SFTBatcher
    from repro_torch.data.synthetic import gen_log_dataset
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.launch.serve import build_engine, ragged_requests
    from repro_torch.models.api import Model
    from repro_torch.serving.engine import (MultiTenantEngine, Request,
                                            ServeConfig)
    counts = {}
    for arch in DENSE_FAMILY:
        full = get_config(arch)
        cfg = full.with_overrides(lora_rank=rank, n_layers=min(
            full.n_layers, DENSE_LAYERS))
        t0 = time.perf_counter()
        eng = build_engine(cfg, tenants, device, seed, rank=rank)
        torch.cuda.synchronize()
        emit({"phase": "model", "arch": cfg.name, "n_layers": cfg.n_layers,
              "published_n_layers": full.n_layers,
              "d_model": cfg.d_model, "n_heads": cfg.n_heads,
              "n_kv_heads": cfg.n_kv_heads,
              "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
              "vocab_size": cfg.vocab_size, "mlp_type": cfg.mlp_type,
              "norm_type": cfg.norm_type,
              "sliding_window": cfg.sliding_window,
              "params": cfg.count_params(), "dtype": cfg.dtype,
              "tenants": tenants, "rank": rank,
              "init_s": time.perf_counter() - t0,
              "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9})
        reqs = ragged_requests(DENSE_REQUESTS, tenants, cfg.vocab_size, 128,
                               1024, seed)
        long_req = None
        if cfg.sliding_window:
            rng = np.random.default_rng(seed + 3)
            long_req = Request("client0", rng.integers(
                0, cfg.vocab_size, LONG_PROMPT).astype(np.int32))
        served = reqs + ([long_req] if long_req is not None else [])
        require(len(served) == dense_requests(arch),
                f"{arch}: {len(served)} requests, the kernel rows assume "
                f"{dense_requests(arch)}")
        sc = ServeConfig(batch_size=len(served), max_new_tokens=new_tokens,
                         prefill_chunk=T, block_size=16, paged_backend="cuda")
        eng.generate(ragged_requests(2, tenants, cfg.vocab_size, 8, 16,
                                     seed + 1),
                     ServeConfig(batch_size=2, max_new_tokens=2,
                                 prefill_chunk=8, paged_backend="cuda"))
        _, counts[arch] = serve_and_check(
            eng, served, sc, kernels.SERVING,
            ("paged_prefill_attention", "batched_lora_matmul"))
        # one traced run (overlap on): device time by kernel family, idle
        wall_ms, fam = traced(
            lambda: eng.generate(served, dataclasses.replace(sc,
                                                             overlap=True)),
            KERNEL_FAMILIES, "other device work (torch: lm_head, norms, "
            "rope, scatter, sampling, copies)")
        emit(_profile_line(fam, wall_ms, phase="profile_dense_family",
                           arch=cfg.name, requests=len(served),
                           new_tokens=new_tokens, **_decode_share(fam)))
        compare_first_chunk(eng, reqs, sc, "bfloat16", rel_tol=0.1,
                            extra={"arch": cfg.name})
        cfg32 = eng.cfg.with_overrides(dtype="float32")
        eng32 = MultiTenantEngine(Model(cfg32, device), cfg32, eng.params,
                                  eng.registry)
        compare_first_chunk(eng32, reqs, sc, "float32", rel_tol=1e-2,
                            extra={"arch": cfg.name})
        if long_req is not None:
            window_chunk_check(eng, long_req, sc, "bfloat16", 0.1)
            window_chunk_check(eng32, long_req, sc, "float32", 1e-2)
        del eng32
        if arch == "gemma-2b":
            # one client's SFT batch through a train step, "cuda" against
            # "torch", at the train phase's bounds
            tok = ByteTokenizer()
            raw = SFTBatcher(gen_log_dataset(np.random.default_rng(seed), 64,
                                             0), tok, 256, 8,
                             seed=0).sample()
            batch = {k: torch.as_tensor(v).to(device) for k, v in raw.items()}
            ad = init_adapters(eng.cfg, seed=seed + 100, device=device,
                               b_std=0.02)
            compare_train_step(eng.model, eng.cfg, eng.params, ad, batch,
                               "bfloat16", loss_tol=2e-2, grad_tol=0.25)
            compare_train_step(Model(cfg32, device), cfg32, eng.params, ad,
                               {k: v[:4] for k, v in batch.items()},
                               "float32", loss_tol=1e-3, grad_tol=1e-2)
            del ad, batch
        del eng
        torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 7: the MoE family
# ---------------------------------------------------------------------------

# (arch, layers served): dbrx-132b's published width at 8 of its 40 layers
# (54.6 GB of bf16 weights), kimi-k2-1t-a32b's at 1 of its 61 (38.5 GB);
# the whole depth of either does not fit one 80 GB card
MOE_FAMILY = (("dbrx-132b", 8), ("kimi-k2-1t-a32b", 1))
MOE_TENANTS = 4
MOE_REQUESTS = 4


def RoutingLog(pinned=None):
    """``repro_torch.models.moe.RoutingLog``: each MoE layer's router
    logits, ids and keep mask, its routing pinned to ``pinned`` if
    given."""
    from repro_torch.models import moe
    return moe.RoutingLog(pinned)


def _flips(ids_a, ids_b):
    """(token, layer) pairs whose expert sets differ, per layer: a bool
    (T,) each."""
    import torch
    return [(torch.sort(a, -1).values != torch.sort(b, -1).values).any(-1)
            for a, b in zip(ids_a, ids_b)]


def moe_first_chunk(eng, reqs, sc, dtype_name, rel_tol, repeat=False):
    """The first prefill chunk through "cuda", and through "torch" with
    each layer's expert ids pinned to the "cuda" run's: the pinned logits
    held to ``compare_first_chunk``'s rule (max error within ``rel_tol``
    of the largest logit, the greedy token equal wherever the top-2
    margin exceeds twice it), the dropped copies equal per layer.  A
    (token, layer) whose top-k set on the pinned "torch" run differs from
    "cuda"'s is a flip; each must be one the rounding can make: its k-th
    vs (k+1)-th router-logit gap at most twice that layer's router-logit
    error "cuda" vs pinned "torch".  The unpinned "torch" chunk is
    reported (its error and its flips).  ``repeat``: "cuda" twice,
    bitwise equal.  Returns the emitted line."""
    import torch
    from repro_torch import kernels
    cfg = eng.cfg
    k = cfg.n_experts_per_tok
    kernels.reset_launch_counts()
    with RoutingLog() as rc:
        lc, n_new = first_chunk_logits(eng, reqs, sc, "cuda")
    launches, tiles = kernels.launch_counts(), kernels.tile_counts()
    if repeat:
        with RoutingLog() as rc2:
            lc2, _ = first_chunk_logits(eng, reqs, sc, "cuda")
        require(torch.equal(lc, lc2) and all(
            torch.equal(a, b) for a, b in zip(rc.ids, rc2.ids)),
            f"{cfg.name}: two cuda runs of the first chunk differ")
        del lc2, rc2
    ids_c = rc.ids
    kernels.reset_launch_counts()
    with RoutingLog(pinned=ids_c) as rt:
        lt, _ = first_chunk_logits(eng, reqs, sc, "torch")
    with RoutingLog() as rf:
        lf, _ = first_chunk_logits(eng, reqs, sc, "torch")
    torch_launches = kernels.launch_counts()
    n_moe = sum(cfg.layer_entry(i).endswith("+moe")
                for i in range(cfg.n_layers))
    require(len(rc.ids) == len(rt.ids) == n_moe,
            f"{cfg.name}: {len(rc.ids)} routed layers, not {n_moe}")
    valid = (torch.arange(lc.shape[1], device=lc.device)[None, :]
             < n_new.to(lc.device)[:, None])
    err = float((lc - lt).abs()[valid].max())
    err_free = float((lc - lf).abs()[valid].max())
    scale = float(lt.abs()[valid].max())
    tol = rel_tol * scale
    rows = torch.arange(lc.shape[0], device=lc.device)
    last = n_new.to(lc.device).long() - 1
    top2 = torch.topk(lt[rows, last], 2, dim=-1).values
    decisive = (top2[:, 0] - top2[:, 1]) > 2 * err
    agree = lc[rows, last].argmax(-1) == lt[rows, last].argmax(-1)
    router_err = [float((a - b).abs().max())
                  for a, b in zip(rc.logits, rt.logits)]
    flips = _flips(ids_c, rt.ids)
    worst_gap = []                       # per layer: largest flipped gap
    for logits_t, flip, e in zip(rt.logits, flips, router_err):
        top = torch.topk(logits_t, k + 1, dim=-1).values
        gap = (top[:, k - 1] - top[:, k])[flip]
        worst_gap.append(float(gap.max()) if gap.numel() else None)
        require(worst_gap[-1] is None or worst_gap[-1] <= 2 * e,
                f"{cfg.name} {dtype_name}: a routing flip with router-logit "
                f"gap {worst_gap[-1]} > 2 x the router error {e}")
    free_flips = _flips(ids_c, rf.ids)
    dropped_c, dropped_t = rc.dropped, rt.dropped
    line = {"phase": "moe_compare", "arch": cfg.name,
            "activations": dtype_name,
            "tokens": int(lc.shape[0] * lc.shape[1]),
            "pinned_max_abs_logit_err": err, "max_abs_logit": scale,
            "tol": tol, "first_token_agree": int(agree.sum()),
            "rows": int(rows.numel()), "decisive_rows": int(decisive.sum()),
            "router_logit_err_by_layer": router_err,
            "flips_by_layer": [int(f.sum()) for f in flips],
            "flip_worst_gap_by_layer": worst_gap,
            "unpinned_max_abs_logit_err": err_free,
            "unpinned_flips_by_layer": [int(f.sum()) for f in free_flips],
            "dropped_copies_by_layer": dropped_c,
            "lora_tiles_cuda": tiles["batched_lora_matmul"],
            "launches_cuda": launches, "repeat_bitwise": repeat or None}
    emit(line)
    want, other = (("mma", "f32") if dtype_name == "bfloat16"
                   else ("f32", "mma"))
    t = tiles["batched_lora_matmul"]
    require(t[want] > 0 and t[other] == 0,
            f"{cfg.name} {dtype_name} first chunk: batched_lora_matmul tiles "
            f"{t}, not only {want}")
    require(all(v == 0 for v in torch_launches.values()),
            f"{cfg.name}: the torch backend launched {torch_launches}")
    require(bool(torch.isfinite(lc).all()), f"{cfg.name}: cuda logits not "
            "finite")
    require(err <= tol, f"{cfg.name} {dtype_name} pinned first-chunk logit "
            f"error {err} > {tol}")
    require(bool(agree[decisive].all()), f"{cfg.name} {dtype_name}: a greedy "
            "token differs on a row whose margin exceeds the error")
    require(dropped_c == dropped_t, f"{cfg.name}: dropped copies differ, "
            f"cuda {dropped_c}, pinned torch {dropped_t}")
    return line


MOE_RANGES = (("moe_expert_bmm", "MoE expert bmm (cuBLAS)"),
              ("moe_dispatch", "MoE routing and dispatch (router product "
               "and LoRA, softmax, sort, scatter, gather, combine)"))


def moe_phase(device, seed: int, T: int = 256, tenants: int = MOE_TENANTS,
              rank: int = 16, new_tokens: int = 16):
    """Each of ``MOE_FAMILY`` at its published width and the depth named
    there, bf16, seeded weights, ``tenants`` rank-16 Eq. 7-fused adapters
    (the router's pair included): ``MOE_REQUESTS`` requests (prompts from
    the seed in [128, 1024]), greedy, 16 new tokens, 256-token chunks,
    through "cuda" with overlap on and off (streams bitwise equal, every
    serving kernel launched, prefill attention and batched LoRA on their
    tensor-core tiles); one traced run with the MoE layer's expert
    products and its routing and dispatch as rows of their own; the first
    chunk against "torch" with pinned routing (``moe_first_chunk``): bf16
    (two "cuda" runs bitwise equal) and, for dbrx-132b, fp32 activations.
    Returns {arch: launch counts of its overlapped run}."""
    import dataclasses
    import gc

    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_engine, ragged_requests
    from repro_torch.models import moe
    from repro_torch.models.api import Model
    from repro_torch.serving.engine import MultiTenantEngine, ServeConfig
    counts = {}
    for arch, depth in MOE_FAMILY:
        # earlier phases' engines can linger in reference cycles: free them
        # before 55 GB of weights go on the card
        gc.collect()
        torch.cuda.empty_cache()
        full = get_config(arch)
        cfg = full.with_overrides(n_layers=depth, lora_rank=rank)
        t0 = time.perf_counter()
        eng = build_engine(cfg, tenants, device, seed, rank=rank)
        torch.cuda.synchronize()
        expert_bytes = (depth * 3 * cfg.n_experts * cfg.d_model
                        * cfg.resolved_d_ff_moe * 2)
        emit({"phase": "model", "arch": cfg.name, "n_layers": depth,
              "published_n_layers": full.n_layers, "d_model": cfg.d_model,
              "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
              "head_dim": cfg.resolved_head_dim,
              "n_experts": cfg.n_experts, "top_k": cfg.n_experts_per_tok,
              "d_ff_moe": cfg.resolved_d_ff_moe,
              "capacity_factor": cfg.moe_capacity_factor,
              "vocab_size": cfg.vocab_size, "norm_type": cfg.norm_type,
              "params": cfg.count_params(),
              "active_params": cfg.count_active_params(),
              "expert_weight_bytes": expert_bytes, "dtype": cfg.dtype,
              "tenants": tenants, "rank": rank,
              "init_s": time.perf_counter() - t0,
              "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9})
        reqs = ragged_requests(MOE_REQUESTS, tenants, cfg.vocab_size, 128,
                               1024, seed)
        sc = ServeConfig(batch_size=len(reqs), max_new_tokens=new_tokens,
                         prefill_chunk=T, block_size=16, paged_backend="cuda")
        eng.generate(ragged_requests(2, tenants, cfg.vocab_size, 8, 16,
                                     seed + 1),
                     ServeConfig(batch_size=2, max_new_tokens=2,
                                 prefill_chunk=8, paged_backend="cuda"))
        # a decode step reads every expert's weights (cap rounds up to 64
        # slots an expert): the byte bound of one step at 3.35 TB/s
        bound_step_ms = bound(expert_bytes, 0)[0]
        _, counts[arch] = serve_and_check(
            eng, reqs, sc, kernels.SERVING,
            ("paged_prefill_attention", "batched_lora_matmul"),
            extra={"expert_read_bound_ms_per_step": bound_step_ms,
                   "expert_read_bound_tok_per_s":
                       len(reqs) / bound_step_ms * 1e3})
        if arch == MOE_FAMILY[0][0]:
            with Ranges({(moe, "apply_moe"): "moe_dispatch",
                         (moe, "_bmm_f32"): "moe_expert_bmm"}):
                wall_ms, fam = traced(
                    lambda: eng.generate(reqs, dataclasses.replace(
                        sc, overlap=True)), KERNEL_FAMILIES,
                    "other device work (torch: lm_head, norms, rope, "
                    "scatter, sampling, copies)", ranges=MOE_RANGES)
            emit(_profile_line(fam, wall_ms, phase="profile_moe",
                               arch=cfg.name, requests=len(reqs),
                               new_tokens=new_tokens, **_decode_share(fam)))
        moe_first_chunk(eng, reqs, sc, "bfloat16", rel_tol=0.1, repeat=True)
        if arch == MOE_FAMILY[0][0]:
            cfg32 = eng.cfg.with_overrides(dtype="float32")
            eng32 = MultiTenantEngine(Model(cfg32, device), cfg32,
                                      eng.params, eng.registry)
            moe_first_chunk(eng32, reqs, sc, "float32", rel_tol=1e-2)
            del eng32
        del eng
    return counts


# ---------------------------------------------------------------------------
# phase 8: the SSM and hybrid families
# ---------------------------------------------------------------------------

# (arch, layers served): mamba2-2.7b at half its depth (the script's time
# limit; the per-token scan is host-paced, so the phase's time goes with
# depth); jamba-v0.1-52b at 8 of its 32 layers, one period that holds
# every pattern entry once (26.5 GB; all 32 would take 103 GB, more than
# one 80 GB card)
SSM_FAMILY = (("mamba2-2.7b", 16), ("jamba-v0.1-52b", 8))  # the script's
#                                                             time limit
SSM_TENANTS = 4
SSM_SLOTS = 4
SSM_TOKEN_CHECK = 64        # prompt tokens fed one at a time on mamba2


def ssm_kernels(gen, device, reps, T, seen):
    """The SSM archs' projections that run batched_lora_matmul (mamba's
    ``in_proj`` and ``out_proj``; jamba's attention and MLP too) not in
    ``seen``, at phase ssm's decode (4) and prefill (4 x T) rows over its
    4 tenants; an N past a multiple of 256 (the ``in_proj`` shapes: 80
    and 160 columns) has its tail held on its own."""
    for arch, _ in SSM_FAMILY:
        for K, N in projection_shapes(arch):
            if (K, N) in seen:
                continue
            seen.add((K, N))
            for M in (SSM_SLOTS, SSM_SLOTS * T):
                emit({**check_lora(gen, device, M, K, N, SSM_TENANTS, 16,
                                   "f32_bank", reps, tail=N % 256 != 0),
                      "arch": arch})


SSM_RANGES = (("ssm_scan", "SSM recurrence: the per-token scan (torch)"),)


class ResetLog:
    """Wraps the engine's ``reset_slot`` for one run: each admission's slot,
    and whether every mamba layer's ``h`` and ``conv`` rows of that slot
    read zero right after the reset, before the slot's first chunk (kept
    on the card until the run is over)."""

    def __enter__(self):
        import torch
        from repro_torch.serving import engine
        self._orig = orig = engine.reset_slot
        self.slots, self._zero = [], []

        def reset(cache, slot):
            out = orig(cache, slot)
            rows = [layer[k][slot] for layer in out["layers"]
                    for k in ("h", "conv") if k in layer]
            self.slots.append(slot)
            self._zero.append(torch.stack([r.abs().amax() == 0
                                           for r in rows]).all())
            return out

        engine.reset_slot = reset
        return self

    def __exit__(self, *exc):
        from repro_torch.serving import engine
        engine.reset_slot = self._orig

    def zeroed(self):
        return [bool(z) for z in self._zero]


def ssm_state_bytes(cfg) -> int:
    """One slot's decode state counted from the shapes: per mamba layer h
    (H, P, N) fp32 and conv (K-1, d_inner + 2 G N) bf16."""
    H = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    conv_dim = cfg.ssm_expand * cfg.d_model + 2 * cfg.ssm_n_groups * \
        cfg.ssm_d_state
    n_mamba = sum(cfg.layer_entry(i).startswith("mamba+")
                  for i in range(cfg.n_layers))
    return n_mamba * (H * cfg.ssm_head_dim * cfg.ssm_d_state * 4
                      + (cfg.ssm_d_conv - 1) * conv_dim * 2)


def ssm_requests(vocab, seed):
    """The dense_family cell's 4 requests (prompts from the seed in [128,
    1024]) and 2 more, 6 over the 4 tenants."""
    from repro_torch.launch.serve import ragged_requests
    more = ragged_requests(2, SSM_TENANTS, vocab, 128, 1024, seed + 2)
    return (ragged_requests(DENSE_REQUESTS, SSM_TENANTS, vocab, 128, 1024,
                            seed) + more)


def token_by_token_check(eng, req, sc, dtype_name, rel_tol,
                         n_tokens=SSM_TOKEN_CHECK, T=16):
    """``req``'s first ``n_tokens`` prompt tokens prefilled in chunks of
    ``T`` and fed one at a time through ``decode_step``, both through
    "cuda" from fresh state: the last position's logits held by
    ``compare_first_chunk``'s rule (max error within ``rel_tol`` of the
    largest logit; the greedy token equal where the top-2 margin exceeds
    twice it)."""
    import dataclasses

    import torch
    from repro_torch import kernels
    seq = dataclasses.replace(req, prompt=req.prompt[:n_tokens])
    sc2 = dataclasses.replace(sc, prefill_chunk=T, paged_backend="cuda")
    kv, cache = _fresh_pool(eng, sc2, n_tokens)
    kv.admit(0)
    kernels.reset_launch_counts()
    out, _ = feed_chunks(eng, kv, cache, 0, seq, sc2, "cuda")
    lc = out[-1][1][-1]
    chunk_launches = kernels.launch_counts()
    dev = eng.device
    kv, cache = _fresh_pool(eng, sc2, n_tokens)
    kv.admit(0)
    require(kv.ensure(0, n_tokens), "token-by-token pool too small")
    bt, _ = kv.device_tables(dev)
    ids = torch.tensor([eng.registry.acquire(req.client_id)],
                       dtype=torch.int32, device=dev)
    bank = eng.bank_for(sc2)
    toks = torch.as_tensor(seq.prompt, dtype=torch.int32).to(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for t in range(n_tokens):
        logits, cache = eng.model.decode_step(
            eng.params, cache, toks[t:t + 1][None],
            torch.full((1,), t, dtype=torch.int32, device=dev),
            adapters=bank, lora_scale=eng.scale, adapter_ids=ids,
            block_tables=bt, paged_backend="cuda")
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n_tokens * 1e3
    ld = logits[0, 0]
    err = float((lc - ld).abs().max())
    top = float(ld.abs().max())
    top2 = torch.topk(ld, 2).values
    margin = float(top2[0] - top2[1])
    agree = bool(lc.argmax() == ld.argmax())
    emit({"phase": "ssm_token_by_token", "arch": eng.cfg.name,
          "activations": dtype_name, "tokens": n_tokens, "prefill_chunk": T,
          "max_abs_logit_err": err, "max_abs_logit": top,
          "tol": rel_tol * top, "greedy_agree": agree,
          "top2_margin": margin, "decode_step_ms": step_ms,
          "launches_chunks": chunk_launches,
          "launches_steps": kernels.launch_counts()})
    require(bool(torch.isfinite(lc).all() and torch.isfinite(ld).all()),
            f"{eng.cfg.name} token-by-token: logits not finite")
    require(err <= rel_tol * top, f"{eng.cfg.name} {dtype_name}: chunked "
            f"prefill vs one token at a time, logit error {err} > "
            f"{rel_tol * top}")
    require(agree or margin <= 2 * err, f"{eng.cfg.name} {dtype_name}: the "
            "greedy token differs where the margin exceeds twice the error")


def ssm_phase(device, seed: int, T: int = 256, new_tokens: int = 16,
              rank: int = 16):
    """Each of ``SSM_FAMILY`` at its published width and the depth named
    there, bf16, seeded weights, ``SSM_TENANTS`` rank-16 Eq. 7-fused
    adapters (the mamba projections' included): 6 requests over 4 slots
    (two slots reused), greedy, 16 new tokens, 256-token chunks, through
    "cuda" with overlap on and off (streams bitwise equal, batched LoRA on
    its tensor-core tile, both paged attention kernels for jamba), the
    decode rate beside the byte bound of a step; the overlap-off run logs
    the slot resets (each reused slot's state zero before its first chunk,
    its stream against the same request in a fresh slot by the margin
    rule); one traced mamba2 run of the first 4 requests with the
    per-token scan as a row of its own; the first chunk against "torch"
    (bf16 <= 10%, fp32 activations <= 1%; jamba's expert ids pinned as in
    phase moe); on mamba2 64 prompt tokens prefilled in chunks of 16
    against the same tokens fed one at a time.
    Returns {arch: launch counts of its overlapped run}."""
    import dataclasses
    import gc

    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.lora import tree_leaves
    from repro_torch.launch.serve import build_engine
    from repro_torch.models import mamba2
    from repro_torch.models.api import Model
    from repro_torch.serving.engine import MultiTenantEngine, ServeConfig
    counts = {}
    for arch, depth in SSM_FAMILY:
        gc.collect()
        torch.cuda.empty_cache()
        full = get_config(arch)
        cfg = full.with_overrides(n_layers=depth, lora_rank=rank)
        t0 = time.perf_counter()
        eng = build_engine(cfg, SSM_TENANTS, device, seed, rank=rank)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        # the state the pool holds per slot, against the shapes' count
        pool = eng.model.init_paged_decode_cache(2, 16,
                                                 num_slots=SSM_SLOTS)
        state = sum(t.numel() * t.element_size() for layer in pool["layers"]
                    for k, t in layer.items() if k in ("h", "conv"))
        want_state = SSM_SLOTS * ssm_state_bytes(cfg)
        require(state == want_state, f"{arch}: SSM state {state} B, the "
                f"shapes count {want_state} B")
        del pool
        weight_bytes = sum(t.numel() * t.element_size()
                           for _, t in tree_leaves(eng.params))
        emit({"phase": "model", "arch": cfg.name, "n_layers": depth,
              "published_n_layers": full.n_layers, "d_model": cfg.d_model,
              "layer_pattern": list(cfg.layer_pattern),
              "ssm_d_state": cfg.ssm_d_state,
              "ssm_head_dim": cfg.ssm_head_dim,
              "ssm_n_heads": cfg.ssm_n_heads,
              "ssm_d_inner": cfg.ssm_d_inner,
              "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
              "sliding_window": cfg.sliding_window,
              "n_experts": cfg.n_experts, "vocab_size": cfg.vocab_size,
              "params": cfg.count_params(), "weight_bytes": weight_bytes,
              "ssm_state_bytes_per_slot": state // SSM_SLOTS,
              "dtype": cfg.dtype, "tenants": SSM_TENANTS, "rank": rank,
              "init_s": init_s,
              "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9})
        reqs = ssm_requests(cfg.vocab_size, seed)
        sc = ServeConfig(batch_size=SSM_SLOTS, max_new_tokens=new_tokens,
                         prefill_chunk=T, block_size=16, paged_backend="cuda")
        eng.generate(ssm_requests(cfg.vocab_size, seed + 1)[:2],
                     ServeConfig(batch_size=2, max_new_tokens=2,
                                 prefill_chunk=8, paged_backend="cuda"))
        needs, mma_names = ((("batched_lora_matmul",),) * 2
                            if not cfg.has_mixer("attn") else
                            (kernels.SERVING, ("paged_prefill_attention",
                                               "batched_lora_matmul")))
        # a decode step reads every weight (jamba: every expert of its MoE
        # layers; capacity rounds up to cover them all) and reads and
        # writes every slot's state
        step_bytes = weight_bytes + 2 * SSM_SLOTS * (state // SSM_SLOTS)
        bound_step_ms = bound(step_bytes, 0)[0]
        # the overlap-off run logs each admission's slot reset (one
        # reduction an admission, no wait for the card)
        log = ResetLog()
        streams, counts[arch] = serve_and_check(
            eng, reqs, sc, needs, mma_names,
            extra={"slots": SSM_SLOTS, "decode_step_bytes": step_bytes,
                   "byte_bound_ms_per_step": bound_step_ms,
                   "byte_bound_tok_per_s": SSM_SLOTS / bound_step_ms * 1e3},
            off_ctx=log)
        if arch == SSM_FAMILY[0][0]:
            # the first wave alone (4 requests, 8 new tokens): the trace
            # slows the host, and the scan's share shows in one wave
            sc_tr = dataclasses.replace(sc, overlap=True, max_new_tokens=8)
            with Ranges({(mamba2, "ssm_recurrence"): "ssm_scan"}) as rg:
                wall_ms, fam = traced(
                    lambda: eng.generate(reqs[:SSM_SLOTS], sc_tr),
                    KERNEL_FAMILIES,
                    "other device work (torch: conv, gated norm, softplus, "
                    "lm_head, norms, sampling, copies)", ranges=SSM_RANGES)
            busy = sum(fam.values())
            kinds = {"ssm_scan": sum(v for k, v in fam.items()
                                     if k.startswith("SSM recurrence")),
                     "batched_lora": sum(v for k, v in fam.items()
                                         if k.startswith("batched_lora")),
                     "other": sum(v for k, v in fam.items()
                                  if k.startswith("other device work"))}
            emit(_profile_line(fam, wall_ms, phase="profile_ssm",
                               arch=cfg.name, requests=SSM_SLOTS,
                               new_tokens=sc_tr.max_new_tokens,
                               device_ms_by_kind=kinds,
                               scan_share_of_busy=(kinds["ssm_scan"] / busy
                                                   if busy else None),
                               scan_host_ms=rg.host_s * 1e3,
                               scan_calls=rg.calls,
                               scan_host_share_of_wall=(rg.host_s * 1e3
                                                        / wall_ms)))
        # the first chunk against "torch"; its bf16 error is the margin
        # rule's error for the slot-reuse streams below
        if cfg.has_moe():
            err_bf16 = max(moe_first_chunk(eng, reqs[:SSM_SLOTS], sc,
                                           "bfloat16", rel_tol=0.1)
                           ["pinned_max_abs_logit_err"], 0.0)
        else:
            err_bf16 = compare_first_chunk(eng, reqs[:SSM_SLOTS], sc,
                                           "bfloat16", rel_tol=0.1,
                                           extra={"arch": cfg.name})
        cfg32 = eng.cfg.with_overrides(dtype="float32")
        eng32 = MultiTenantEngine(Model(cfg32, device), cfg32, eng.params,
                                  eng.registry)
        if cfg.has_moe():
            moe_first_chunk(eng32, reqs[:SSM_SLOTS], sc, "float32",
                            rel_tol=1e-2)
        else:
            compare_first_chunk(eng32, reqs[:SSM_SLOTS], sc, "float32",
                                rel_tol=1e-2, extra={"arch": cfg.name})
            token_by_token_check(eng, reqs[0], sc, "bfloat16", 0.1)
            token_by_token_check(eng32, reqs[0], sc, "float32", 1e-2)
        del eng32
        # slot reuse (the logged overlap-off run): each admission's slot
        # read zero state, and each request admitted into a reused slot
        # streams as it does in a fresh one (both together in a fresh
        # session of 2 slots: another LoRA plan, and for jamba other MoE
        # capacity, so by the margin rule)
        zeroed = log.zeroed()
        reused = [i for i, s in enumerate(log.slots)
                  if s in log.slots[:i]]
        fresh = [[int(t) for t in o] for o in eng.generate(
            [reqs[i] for i in reused],
            dataclasses.replace(sc, batch_size=len(reused)))]
        got = [[int(t) for t in streams[False][i]] for i in reused]
        matched = streams_by_margin(
            eng, [reqs[i] for i in reused], sc, got, fresh, err_bf16,
            f"{arch} reused slot")
        emit({"phase": "ssm_slot_reuse", "arch": cfg.name,
              "admission_slots": log.slots, "state_zeroed": zeroed,
              "reused_requests": reused, "matched_prefix": matched,
              "bitwise_fresh": [g == f for g, f in zip(got, fresh)],
              "err_bound": err_bf16})
        require(len(log.slots) == len(reqs) and all(zeroed),
                f"{arch}: a slot's state was not zero at admission: "
                f"{list(zip(log.slots, zeroed))}")
        require(len(reused) == len(reqs) - SSM_SLOTS,
                f"{arch}: {len(reused)} admissions into reused slots, not "
                f"{len(reqs) - SSM_SLOTS}")
        del eng
        torch.cuda.empty_cache()
    return counts



# ---------------------------------------------------------------------------
# phase 9: the VLM and encoder-decoder families
# ---------------------------------------------------------------------------

VLM_ARCH = "internvl2-26b"
VLM_TENANTS = 4
VLM_REQUESTS = 4
VLM_TRAIN_ROWS = 2          # each 256 patch embeddings, then 256 SFT tokens
VLM_LAYERS = 24             # of internvl2-26b's 48: the script's time limit
# the fp32 train step reads an fp32 copy of every weight it multiplies on
# the plain path (79 GB at all 48 layers): it runs on the first 8
VLM_FP32_LAYERS = 8
ENCDEC_ARCH = "whisper-small"
ENCDEC_TRAIN_ROWS = 8       # each 1,500 stub frames and 256 SFT tokens
ENCDEC_ROWS = 8             # decode rows
ENCDEC_STEPS = 32           # greedy decode steps
# whisper's decode runs lora_matmul and flash attention; cuBLAS carries
# the cross K/V products, the lm_head and the ring-buffer attention
WHISPER_DECODE_FAMILIES = (
    *((k, f) for k, f in TRAIN_FAMILIES if not f.startswith("cuBLAS")),
    *((k, "cuBLAS matmuls (cross K/V, lm_head, ring-buffer attention)")
      for k in ("gemm", "nvjet", "xmma", "cutlass")))


def vlm_encdec_kernels(gen, device, reps, T, seen):
    """The shapes phase vlm_encdec gives the kernels that no earlier line
    holds: batched LoRA at internvl2-26b's projections not in ``seen`` (4
    decode and 4 x T prefill rows over 4 tenants), lora_matmul at its
    train step's 1,024 rows and flash attention at its G 6 over 512
    causal positions; lora_matmul at whisper-small's three projection
    shapes at its encoder's 12,000 train rows, its decoder's 2,048 and
    its decode step's 8, and flash attention at whisper's head dim 64:
    non-causal over the encoder's 1,500 frames, the cross-attention's 256
    and 1 queries against them, and the decoder's causal 256."""
    from repro_torch.configs import get_config
    vlm, enc = get_config(VLM_ARCH), get_config(ENCDEC_ARCH)
    S = vlm.n_patch_tokens + T
    for K, N in projection_shapes(VLM_ARCH):
        if (K, N) not in seen:
            seen.add((K, N))
            for M in (VLM_REQUESTS, VLM_REQUESTS * T):
                emit({**check_lora(gen, device, M, K, N, VLM_TENANTS, 16,
                                   "f32_bank", reps), "arch": VLM_ARCH})
        emit({**check_single_lora(gen, device, VLM_TRAIN_ROWS * S, K, N, 16,
                                  reps), "arch": VLM_ARCH})
    emit({**check_flash(gen, device, VLM_TRAIN_ROWS, vlm.n_heads,
                        vlm.n_kv_heads, S, S, vlm.resolved_head_dim, 0,
                        reps), "arch": VLM_ARCH})
    F = enc.encoder_seq_len
    for K, N in projection_shapes(ENCDEC_ARCH):
        for M in (ENCDEC_TRAIN_ROWS * F, ENCDEC_TRAIN_ROWS * T, ENCDEC_ROWS):
            emit({**check_single_lora(gen, device, M, K, N, enc.lora_rank,
                                      reps), "arch": ENCDEC_ARCH})
    H, hd = enc.n_heads, enc.resolved_head_dim
    for B, Sq, Sk, causal in ((ENCDEC_TRAIN_ROWS, F, F, False),
                              (ENCDEC_TRAIN_ROWS, T, F, False),
                              (ENCDEC_ROWS, 1, F, False),
                              (ENCDEC_TRAIN_ROWS, T, T, True)):
        emit({**check_flash(gen, device, B, H, H, Sq, Sk, hd, 0, reps,
                            causal=causal), "arch": ENCDEC_ARCH})


def sft_batch(seed: int, rows: int, T: int, vocab: int, device):
    """``rows`` SFT rows of T byte tokens (the log dataset from ``seed``)
    with their loss mask, on ``device``."""
    import numpy as np
    import torch
    from repro_torch.data.pipeline import SFTBatcher
    from repro_torch.data.synthetic import gen_log_dataset
    from repro_torch.data.tokenizer import ByteTokenizer
    raw = SFTBatcher(gen_log_dataset(np.random.default_rng(seed), 64, 0),
                     ByteTokenizer(), T, rows, seed=0).sample()
    raw["tokens"] = raw["tokens"] % vocab
    return {k: torch.as_tensor(v).to(device) for k, v in raw.items()}


def vlm_phase(device, seed: int, T: int, new_tokens: int, rank: int):
    """internvl2-26b at ``VLM_LAYERS`` of its 48 layers: serve (as phase
    dense_family), then
    a train step with stub patch embeddings.  Returns {"serve", "train":
    launch counts}."""
    import dataclasses
    import gc

    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.lora import init_adapters, tree_leaves
    from repro_torch.launch.serve import build_engine, ragged_requests
    from repro_torch.models.api import Model
    from repro_torch.serving.engine import MultiTenantEngine, ServeConfig
    cfg = get_config(VLM_ARCH).with_overrides(lora_rank=rank,
                                              n_layers=VLM_LAYERS)
    t0 = time.perf_counter()
    eng = build_engine(cfg, VLM_TENANTS, device, seed, rank=rank)
    torch.cuda.synchronize()
    emit({"phase": "model", "arch": cfg.name, "family": cfg.family,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
          "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
          "vocab_size": cfg.vocab_size, "n_patch_tokens": cfg.n_patch_tokens,
          "params": cfg.count_params(),
          "weight_bytes": sum(t.numel() * t.element_size()
                              for _, t in tree_leaves(eng.params)),
          "dtype": cfg.dtype, "tenants": VLM_TENANTS, "rank": rank,
          "init_s": time.perf_counter() - t0,
          "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9})
    # text-only requests, as the reference serves the VLM
    reqs = ragged_requests(VLM_REQUESTS, VLM_TENANTS, cfg.vocab_size, 128,
                           1024, seed)
    sc = ServeConfig(batch_size=len(reqs), max_new_tokens=new_tokens,
                     prefill_chunk=T, block_size=16, paged_backend="cuda")
    eng.generate(ragged_requests(2, VLM_TENANTS, cfg.vocab_size, 8, 16,
                                 seed + 1),
                 ServeConfig(batch_size=2, max_new_tokens=2, prefill_chunk=8,
                             paged_backend="cuda"))
    _, serve_counts = serve_and_check(
        eng, reqs, sc, kernels.SERVING,
        ("paged_prefill_attention", "batched_lora_matmul"),
        extra={"text_only": True})
    # one traced run (overlap on): device time by kernel family, idle
    wall_ms, fam = traced(
        lambda: eng.generate(reqs, dataclasses.replace(sc, overlap=True)),
        KERNEL_FAMILIES, "other device work (torch: lm_head, norms, rope, "
        "scatter, sampling, copies)")
    emit(_profile_line(fam, wall_ms, phase="profile_vlm", arch=cfg.name,
                       requests=len(reqs), new_tokens=new_tokens,
                       **_decode_share(fam)))
    compare_first_chunk(eng, reqs, sc, "bfloat16", rel_tol=0.1,
                        extra={"arch": cfg.name})
    cfg32 = eng.cfg.with_overrides(dtype="float32")
    eng32 = MultiTenantEngine(Model(cfg32, device), cfg32, eng.params,
                              eng.registry)
    compare_first_chunk(eng32, reqs, sc, "float32", rel_tol=1e-2,
                        extra={"arch": cfg.name})
    params, model, cfg = eng.params, eng.model, eng.cfg
    del eng, eng32
    gc.collect()
    torch.cuda.empty_cache()            # the pools and the bank are gone
    # one train step: each row 256 seeded stub patch embeddings (the
    # embedding table's scale), then 256 SFT tokens; the loss reads the
    # text positions only
    batch = sft_batch(seed, VLM_TRAIN_ROWS, T, cfg.vocab_size, device)
    g = torch.Generator(device=device).manual_seed(seed + 7)
    batch["patch_embeds"] = torch.randn(
        (VLM_TRAIN_ROWS, cfg.n_patch_tokens, cfg.d_model), generator=g,
        device=device) * 0.02
    ad = init_adapters(cfg, seed=seed + 100, device=device, b_std=0.02)
    info = {"arch": cfg.name, "patch_tokens": cfg.n_patch_tokens,
            "text_tokens": T}
    train_counts = compare_train_step(
        model, cfg, params, ad, batch, "bfloat16", loss_tol=2e-2,
        grad_tol=0.25, n_layers=cfg.n_layers, **info)
    cut = cfg32.with_overrides(n_layers=VLM_FP32_LAYERS)
    compare_train_step(
        Model(cut, device), cut,
        dict(params, layers=params["layers"][:VLM_FP32_LAYERS]),
        {"layers": ad["layers"][:VLM_FP32_LAYERS]},
        {k: v[:1] for k, v in batch.items()}, "float32", loss_tol=1e-3,
        grad_tol=1e-2, n_layers=VLM_FP32_LAYERS, **info)
    del params, ad, batch
    return {"serve": {n: serve_counts[n] for n in kernels.SERVING},
            "train": {n: train_counts[n] for n in kernels.TRAINING}}


def whisper_decode(model, cfg, params, adapters, enc, first, backend,
                   forced=None, mesh=None):
    """``prefill_cross`` then ``ENCDEC_STEPS`` greedy ``decode_step`` calls
    from ``first`` (B, 1), through ``backend`` (``forced`` (B, steps):
    teacher forcing, step t fed ``forced[:, t]``).  ``mesh``: on this
    rank's shards of its model group, the caches at its kv heads, each
    step's token as every rank takes it (``dryrun.greedy_tokens``).
    Returns (tokens (B, steps + 1), logits (B, steps, V) fp32 (the rank's
    block of the vocabulary where the group splits it), prefill s, decode
    s, launch counts)."""
    import torch
    from repro_torch import kernels
    from repro_torch.core.lora import lora_scale
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.dryrun import greedy_tokens
    from repro_torch.models import encdec
    scale = lora_scale(cfg)
    tp = None if mesh is None else mesh_lib.model_group(mesh)
    with torch.no_grad():
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache = model.init_decode_cache(first.shape[0], 2 * ENCDEC_STEPS,
                                        tp=tp)
        cache["cross_k"], cache["cross_v"] = encdec.prefill_cross(
            params, enc, cfg, adapters, scale, paged_backend=backend, tp=tp)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tok, toks, logits = first, [first], []
        for t in range(ENCDEC_STEPS):
            if forced is not None:
                tok = forced[:, t:t + 1]
            lg, cache = model.decode_step(params, cache, tok, t,
                                          adapters=adapters,
                                          lora_scale=scale,
                                          paged_backend=backend, tp=tp)
            logits.append(lg[:, 0])
            if mesh is None:
                tok = lg[:, 0].argmax(-1, keepdim=True).to(torch.int32)
            else:
                tok = greedy_tokens(cfg, lg, mesh, tp, ())[:, None]
            toks.append(tok)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    return (torch.cat(toks, 1), torch.stack(logits, 1), t1 - t0, t2 - t1,
            kernels.launch_counts())


def decode_margin_rule(tc, lc, tt, lt, rel_tol, what):
    """Streams ``tc`` ("cuda") and ``tt`` ("torch"), each (B, steps + 1)
    from one first token, with their steps' logits ``lc``/``lt`` (B,
    steps, V).  Row by row, over the steps that read the same tokens on
    both sides: the logit error stays within ``rel_tol`` of the largest
    logit; at the first step whose greedy tokens differ, the torch step's
    top-2 margin is at most twice that step's error.  Returns (tokens
    matched per row, the largest error compared)."""
    import torch
    matched, worst = [], 0.0
    for b in range(tc.shape[0]):
        n = 0
        for t in range(lc.shape[1]):
            err = float((lc[b, t] - lt[b, t]).abs().max())
            top = float(lt[b, t].abs().max())
            worst = max(worst, err)
            require(err <= rel_tol * top, f"{what} row {b} step {t}: logit "
                    f"error {err} > {rel_tol * top}")
            if int(tc[b, t + 1]) != int(tt[b, t + 1]):
                top2 = torch.topk(lt[b, t], 2).values
                margin = float(top2[0] - top2[1])
                require(margin <= 2 * err, f"{what} row {b} step {t}: "
                        f"greedy tokens differ where the margin {margin} "
                        f"exceeds twice the error {err}")
                break
            n += 1
        matched.append(n)
    return matched, worst


def whisper_phase(device, seed: int, T: int, rank: int):
    """whisper-small in full (12 + 12 layers, 1,500 frames): a train step
    over stub frames, then prefill_cross and greedy decode.  Returns
    {"train", "decode": launch counts}."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.dual_lora import merge
    from repro_torch.core.lora import init_adapters, lora_scale
    from repro_torch.models.api import Model
    cfg = get_config(ENCDEC_ARCH).with_overrides(lora_rank=rank)
    model = Model(cfg, device)
    t0 = time.perf_counter()
    params = model.init(seed)
    torch.cuda.synchronize()
    F, V = cfg.encoder_seq_len, cfg.vocab_size
    emit({"phase": "model", "arch": cfg.name, "family": cfg.family,
          "n_encoder_layers": cfg.n_encoder_layers, "n_layers": cfg.n_layers,
          "encoder_seq_len": F, "d_model": cfg.d_model,
          "n_heads": cfg.n_heads, "head_dim": cfg.resolved_head_dim,
          "d_ff": cfg.d_ff, "vocab_size": V, "mlp_type": cfg.mlp_type,
          "norm_type": cfg.norm_type, "lora_targets": list(cfg.lora_targets),
          "params": cfg.count_params(), "dtype": cfg.dtype, "rank": rank,
          "init_s": time.perf_counter() - t0,
          "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9})
    g = torch.Generator(device=device).manual_seed(seed + 11)
    # a train step over seeded stub frames (unit scale: a conv frontend's
    # output) and 256 SFT tokens a row
    batch = sft_batch(seed, ENCDEC_TRAIN_ROWS, T, V, device)
    batch["enc_embeds"] = torch.randn((ENCDEC_TRAIN_ROWS, F, cfg.d_model),
                                      generator=g, device=device)
    ad = init_adapters(cfg, seed=seed + 100, device=device, b_std=0.02)
    info = {"arch": cfg.name, "frames": F, "text_tokens": T}
    cfg32 = cfg.with_overrides(dtype="float32")
    model32 = Model(cfg32, device)
    train_counts = compare_train_step(
        model, cfg, params, ad, batch, "bfloat16", loss_tol=2e-2,
        grad_tol=0.25, zero=("['cross_attn']['wv']",), **info)
    compare_train_step(model32, cfg32, params, ad,
                       {k: v[:4] for k, v in batch.items()}, "float32",
                       loss_tol=1e-3, grad_tol=1e-2,
                       zero=("['cross_attn']['wv']",), **info)
    # flash attention: per forward 12 encoder layers and 12 cross-
    # attentions without a mask, 12 causal decoder self-attentions
    want = cfg.n_encoder_layers + 2 * cfg.n_layers
    require(train_counts["flash_attention"] == want,
            f"whisper train step: {train_counts['flash_attention']} flash "
            f"launches, not {want}")
    del ad, batch
    # decode: 8 rows of stub frames, one Eq. 7-fused rank-16 adapter
    fused = merge(*(init_adapters(cfg, seed=seed + 20 + j, device=device,
                                  b_std=0.02) for j in (0, 1)), [0.6, 0.6])
    enc = torch.randn((ENCDEC_ROWS, F, cfg.d_model), generator=g,
                      device=device)
    first = torch.randint(0, V, (ENCDEC_ROWS, 1), generator=g,
                          device=device, dtype=torch.int32)
    tc, lc, pre_c, dec_c, nc = whisper_decode(model, cfg, params, fused, enc,
                                              first, "cuda")
    wall_ms, fam = traced(
        lambda: whisper_decode(model, cfg, params, fused, enc, first,
                               "cuda"), WHISPER_DECODE_FAMILIES,
        "other device work (torch: ring-buffer attention, norms, GELU, "
        "embeddings, argmax, copies)")
    emit(_profile_line(fam, wall_ms, phase="profile_whisper_decode",
                       arch=cfg.name, rows=ENCDEC_ROWS, steps=ENCDEC_STEPS,
                       includes="prefill_cross and every decode step"))
    tt, lt, pre_t, dec_t, nt = whisper_decode(model, cfg, params, fused, enc,
                                              first, "torch")
    # the first step by compare_first_chunk's rule
    err0 = float((lc[:, 0] - lt[:, 0]).abs().max())
    top0 = float(lt[:, 0].abs().max())
    top2 = torch.topk(lt[:, 0], 2, dim=-1).values
    decisive = (top2[:, 0] - top2[:, 1]) > 2 * err0
    agree = lc[:, 0].argmax(-1) == lt[:, 0].argmax(-1)
    matched, worst = decode_margin_rule(tc, lc, tt, lt, 0.1,
                                        "whisper decode bf16")
    # teacher-forced: the cuda stream's tokens through decode_step (bf16
    # ring buffers and cross K/V) and through forward (K/V unrounded), fp32
    # activations, both on the kernels
    forced = tc[:, :ENCDEC_STEPS]
    _, ld32, _, _, _ = whisper_decode(model32, cfg32, params, fused, enc,
                                      first, "cuda", forced=forced)
    with torch.no_grad():
        lf32, _ = model32.forward(params, {"enc_embeds": enc,
                                           "tokens": forced},
                                  adapters=fused, lora_scale=lora_scale(cfg),
                                  paged_backend="cuda")
    tf_err = float((ld32 - lf32).abs().max())
    tf_top = float(lf32.abs().max())
    emit({"phase": "whisper_decode", "arch": cfg.name, "rows": ENCDEC_ROWS,
          "frames": F, "steps": ENCDEC_STEPS, "adapter": "eq7_fused_rank16",
          "prefill_cross_ms_cuda": pre_c * 1e3,
          "prefill_cross_ms_torch": pre_t * 1e3,
          "ms_per_step_cuda": dec_c / ENCDEC_STEPS * 1e3,
          "ms_per_step_torch": dec_t / ENCDEC_STEPS * 1e3,
          "tok_per_s_cuda": ENCDEC_ROWS * ENCDEC_STEPS / dec_c,
          "tok_per_s_torch": ENCDEC_ROWS * ENCDEC_STEPS / dec_t,
          "first_step_max_abs_logit_err": err0, "max_abs_logit": top0,
          "first_step_tol": 0.1 * top0,
          "first_token_agree": int(agree.sum()),
          "decisive_rows": int(decisive.sum()),
          "matched_tokens": matched, "max_abs_logit_err": worst,
          "streams_bitwise": bool(torch.equal(tc, tt)),
          "teacher_forced_steps": ENCDEC_STEPS,
          "teacher_forced_fp32_max_abs_err": tf_err,
          "teacher_forced_tol": 1e-2 * tf_top,
          "launches_cuda": nc, "launches_torch": nt})
    require(bool(torch.isfinite(lc).all()), "whisper decode: cuda logits "
            "not finite")
    require(bool(agree[decisive].all()), "whisper decode: a first greedy "
            "token differs where the margin exceeds twice the error")
    require(tf_err <= 1e-2 * tf_top, f"whisper teacher-forced decode: fp32 "
            f"logit error {tf_err} > {1e-2 * tf_top}")
    require(nc["lora_matmul"] > 0 and nc["flash_attention"] > 0,
            f"whisper decode launched {nc}")
    require(all(n == 0 for n in nt.values()),
            f"whisper decode through torch launched {nt}")
    return {"train": {n: train_counts[n] for n in kernels.TRAINING},
            "decode": {n: nc[n] for n in kernels.TRAINING}}


# ---------------------------------------------------------------------------
# phase 10: training on the MoE, SSM and hybrid bases, beside the dry run
# ---------------------------------------------------------------------------

# (arch, depth): dbrx-132b's is the deepest whose dry-run train-step peak
# fits in PEAK_FIT of the card, at most the moe cell's 8 of its 40
TRAIN_ARCHS = (("dbrx-132b", None), ("mamba2-2.7b", 64),
               ("jamba-v0.1-52b", 8))
TRAIN_ARCH_ROWS = 2          # each 256 SFT tokens
PEAK_FIT = 0.9               # of the card's memory, for the depth choice
PEAK_TOL = 0.25              # measured peak against the dry run's


class RoutingPin:
    """``with pin(backend):`` around a step: a "cuda" step's expert ids
    are kept (``RoutingLog``), and a "torch" step routes to them, as
    ``moe_first_chunk`` pins routing; ``flips`` counts the (token, layer)
    pairs whose own top-k set on "torch" differs from "cuda"'s."""

    def __init__(self):
        self.ids, self.flips = None, None

    @contextlib.contextmanager
    def __call__(self, backend):
        with RoutingLog(pinned=None if backend == "cuda" else self.ids) as log:
            yield
        own = log.ids
        if backend == "cuda":
            self.ids = own
        else:
            self.flips = sum(int(f.sum()) for f in _flips(self.ids, own))


class ScanCount:
    """Counts ``models.mamba2.ssd_chunked`` calls (the SSD chunked scan of
    a forward without a cache: training's path) inside the block."""

    def __enter__(self):
        from repro_torch.models import mamba2
        self.calls, self._orig = 0, mamba2.ssd_chunked

        def counted(*a, **kw):
            self.calls += 1
            return self._orig(*a, **kw)
        mamba2.ssd_chunked = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.models import mamba2
        mamba2.ssd_chunked = self._orig


def tree_nbytes(*trees) -> int:
    from repro_torch.launch.dryrun import iter_tensors
    return sum(t.numel() * t.element_size() for t in iter_tensors(trees))


def predicted_step(cfg, step, args, rows: int, seq: int, dry=None):
    """One train step ``step(*args)`` on the card beside the dry run's
    prediction for the same config and batch (``dry``, or walked here on
    the meta device): the step's seconds, its peak (``max_memory_allocated``
    less what was allocated besides the arguments), the arguments' summed
    bytes, which must equal the dry run's ``argument_bytes`` exactly, the
    measured peak within ``PEAK_TOL`` of the dry run's ``peak_bytes``, and
    mfu (6·N_active·D over the step's seconds at the bf16 peak).  Returns
    (the step's outputs, the fields)."""
    import torch
    from repro_torch.analysis import roofline as rl
    dry = dry or dry_train_step(cfg, rows, seq)
    mem, roof = dry["memory"], dry["roofline"]
    torch.cuda.synchronize()
    arg_bytes = tree_nbytes(*args)
    other = torch.cuda.memory_allocated() - arg_bytes
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = step(*args)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - other
    model_flops = rl.model_flops_train(cfg, rows * seq)
    fields = {"step_s": step_s, "train_tokens_per_s": rows * seq / step_s,
              "measured_argument_bytes": arg_bytes,
              "measured_peak_bytes": peak,
              "dry_argument_bytes": mem["argument_bytes"],
              "dry_argument_bytes_by": mem["argument_bytes_by"],
              "dry_peak_bytes": mem["peak_bytes"],
              "dry_temp_bytes": mem["temp_bytes"],
              "peak_rel_err": peak / mem["peak_bytes"] - 1,
              "peak_tol": PEAK_TOL, "dry_flops": roof["flops"],
              "dry_hbm_bytes": roof["hbm_bytes"],
              "dry_compute_ms": roof["compute_s"] * 1e3,
              "dry_memory_ms": roof["memory_s"] * 1e3,
              "dry_dominant": roof["dominant"],
              "dry_kernel_launches": {k: v["launches"] for k, v in
                                      dry["kernels"].items()},
              "dry_walk_s": dry["walk_s"], "model_flops": model_flops,
              "mfu": model_flops / (step_s * rl.PEAK_FLOPS)}
    require(arg_bytes == mem["argument_bytes"],
            f"{cfg.name}: the step's arguments hold {arg_bytes} bytes, the "
            f"dry run says {mem['argument_bytes']}")
    require(abs(fields["peak_rel_err"]) <= PEAK_TOL,
            f"{cfg.name}: measured peak {peak} bytes is "
            f"{fields['peak_rel_err']:+.1%} off the dry run's "
            f"{mem['peak_bytes']}")
    return out, fields


def dry_train_step(cfg, rows: int, seq: int):
    """The dry run's train step of ``cfg`` at ``rows`` × ``seq`` on the
    meta device, with the seconds the walk took (``walk_s``)."""
    from repro_torch.launch.dryrun import dry_run
    t0 = time.perf_counter()
    dry = dry_run(cfg.with_overrides(paged_backend="cuda"), "train", rows,
                  seq)
    return dict(dry, walk_s=time.perf_counter() - t0)


def _kinds(cfg, i: int):
    mixer, _, mlp = cfg.layer_entry(i).partition("+")
    return {mixer, mlp} & {"attn", "mamba", "moe"}


def reduced_layers(cfg):
    """The first layer of each kind the arch has (attention, mamba, MoE),
    in depth order: the fp32 comparison's cut."""
    keep, seen = [], set()
    for i in range(cfg.n_layers):
        if _kinds(cfg, i) - seen:
            keep.append(i)
            seen |= _kinds(cfg, i)
    return keep


def train_families_phase(device, seed: int, T: int = 256):
    """One LoRA train step of dbrx-132b, mamba2-2.7b (64 of 64 layers) and
    jamba-v0.1-52b (8 of 32) at published width through the kernels,
    beside the dry run's prediction, with "cuda" vs "torch" checks (bf16 at
    the phase depth, fp32 at the first layer of each kind; routing pinned)
    and a stage-3 fused evaluation.  Returns {arch: the measured step's
    launch counts}."""
    import gc

    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.lora import init_adapters
    from repro_torch.models import mamba2
    from repro_torch.models.api import Model
    from repro_torch.training.optimizers import adamw
    from repro_torch.training.train_step import (lora_value_and_grad,
                                                 make_lora_train_step)
    card = torch.cuda.get_device_properties(device).total_memory
    out = {}
    for arch, depth in TRAIN_ARCHS:
        t_arch = time.perf_counter()
        base = get_config(arch).with_overrides(lora_rank=16)
        if depth is None:
            tried = {}
            for depth in range(dict(MOE_FAMILY)[arch], 0, -1):
                dry = dry_train_step(base.with_overrides(n_layers=depth),
                                     TRAIN_ARCH_ROWS, T)
                tried[depth] = dry["memory"]["peak_bytes"]
                if tried[depth] <= PEAK_FIT * card:
                    break
            emit({"phase": "train_families_depth", "arch": arch,
                  "depth": depth, "of": base.n_layers,
                  "card_bytes": card, "fit_bytes": PEAK_FIT * card,
                  "dry_peak_bytes_by_depth": tried,
                  "why": f"the deepest of at most {dict(MOE_FAMILY)[arch]} "
                         "layers whose dry-run train-step peak fits in "
                         f"{PEAK_FIT:.0%} of the card"})
            require(tried[depth] <= PEAK_FIT * card,
                    f"{arch}: no depth fits the card")
        else:
            dry = dry_train_step(base.with_overrides(n_layers=depth),
                                 TRAIN_ARCH_ROWS, T)
        cfg = base.with_overrides(n_layers=depth)
        gc.collect()
        torch.cuda.empty_cache()
        model = Model(cfg, device)
        params = model.init(seed)
        ad = init_adapters(cfg, seed=seed + 100, device=device, b_std=0.02)
        opt = adamw()
        st = opt.init(ad)
        batch = sft_batch(seed, TRAIN_ARCH_ROWS, T, cfg.vocab_size, device)
        step = make_lora_train_step(model, cfg, opt, paged_backend="cuda")
        step(params, ad, st, batch)                 # warm-up
        kernels.reset_launch_counts()
        with ScanCount() as scan:
            _, fields = predicted_step(cfg, step, (params, ad, st, batch),
                                       TRAIN_ARCH_ROWS, T, dry)
        counts, tiles = kernels.launch_counts(), kernels.tile_counts()
        n_mamba = sum("mamba" in _kinds(cfg, i) for i in range(depth))
        n_attn = sum("attn" in _kinds(cfg, i) for i in range(depth))
        needs = ("lora_matmul",) + (("flash_attention",) if n_attn else ())
        emit({"phase": "train_families", "arch": arch, "n_layers": depth,
              "of": base.n_layers, "d_model": cfg.d_model, "rows":
              TRAIN_ARCH_ROWS, "seq": T, "rank": cfg.lora_rank, **fields,
              "ssd_scan_calls": scan.calls, "mamba_layers": n_mamba,
              "remat": cfg.remat, "remat_policy": cfg.remat_policy,
              "launches": {n: counts[n] for n in kernels.TRAINING},
              "tile_launches": {n: tiles[n] for n in
                                ("lora_matmul", "flash_attention")}})
        # one a mamba layer, and one more where recomputation runs the
        # period's forward again in backward (either policy: the scan's
        # products have batch dims)
        require(scan.calls == n_mamba * forwards(cfg),
                f"{arch}: {scan.calls} SSD scans, not {forwards(cfg)} per "
                f"mamba layer ({n_mamba}; remat {cfg.remat}, "
                f"{cfg.remat_policy})")
        for name in needs:
            require(counts[name] > 0, f"{arch}: the train step did not "
                    f"launch {name}")
            require_mma_tile(tiles, name, f"{arch} train step")
        out[arch] = {n: counts[n] for n in kernels.TRAINING}
        if n_mamba == depth:
            # the SSD chunked scan's trace (its forward: the backward's
            # kernels launch from autograd's thread, outside the range)
            with Ranges({(mamba2, "ssd_chunked"): "ssd_scan"}) as rg:
                wall_ms, fam = traced(
                    lambda: step(params, ad, st, batch), TRAIN_FAMILIES,
                    "other device work (torch: the scan's backward, conv, "
                    "gated norm, norms, loss, optimizer)",
                    ranges=(("ssd_scan", "SSD chunked scan, forward "
                             "(torch)"),))
            emit(_profile_line(fam, wall_ms, phase="profile_train_families",
                               arch=arch, rows=TRAIN_ARCH_ROWS * T,
                               scan_host_ms=rg.host_s * 1e3,
                               scan_calls=rg.calls))
        # "cuda" against "torch": bf16 at the phase depth (the train
        # phase's bounds), the stage-3 fused evaluation, then fp32
        # activations at the first layer of each kind
        info = {"arch": arch, "n_layers": depth}
        compare_grads(lambda b: lora_value_and_grad(model, cfg, b)(
            params, ad, batch), batch, "bfloat16", 2e-2, 0.25,
            phase="train_families_compare", needs=needs, pin=RoutingPin(),
            **info)
        ad_s = init_adapters(cfg, seed=seed + 101, device=device, b_std=0.02)
        compare_fused_eval(model, cfg, params, ad, ad_s, batch, "bfloat16",
                           2e-2, pin=RoutingPin(), **info)
        keep = reduced_layers(cfg)
        cut = cfg.with_overrides(
            n_layers=len(keep), dtype="float32",
            layer_pattern=tuple(cfg.layer_entry(i) for i in keep))
        params = dict(params, layers=[params["layers"][i] for i in keep])
        ad = {"layers": [ad["layers"][i] for i in keep]}
        del st, ad_s, step, model
        gc.collect()
        torch.cuda.empty_cache()
        compare_grads(lambda b: lora_value_and_grad(Model(cut, device), cut,
                                                    b)(params, ad, batch),
                      batch, "float32", 1e-3, 1e-2,
                      phase="train_families_compare", needs=needs,
                      pin=RoutingPin(), arch=arch, n_layers=len(keep),
                      layers=keep)
        emit({"phase": "train_families_arch", "arch": arch,
              "seconds": time.perf_counter() - t_arch})
        del params, ad, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


FULL_ARCH = "llama2-7b"
FULL_MAX_LAYERS = 32
FULL_ROWS = 8                # each 256 SFT tokens
FULL_PEAK_TOL = 0.02         # measured peak against the dry run's
FULL_LR = 2e-4
# the weights after one fp32 AdamW step, "cuda" against "torch", per leaf:
# ||Δp|| <= tol·||p_torch - p_0||.  Adam's first step moves an element by
# about lr·sign(g), so an element whose gradient is within the two
# backends' difference of 0 can flip by 2·lr; the fp32 gradient bound
UPDATE_TOL = 1e-2
LORA_KERNELS = ("lora_matmul", "dual_lora_matmul", "batched_lora_matmul",
                "batched_dual_lora_matmul")


def full_depth(base, rows: int, seq: int, fit: float):
    """The deepest depth of at most ``FULL_MAX_LAYERS`` whose dry-run peak
    is at most ``fit`` bytes, by bisection (the peak grows with depth):
    each depth's full step walked on the meta device under
    ``launch/dryrun.measure``, as ``dry_train_step`` walks the LoRA step.
    Returns (depth, {depth tried: its dry run, with the walk's seconds})."""
    from repro_torch.launch.dryrun import META, build_full_train, measure
    from repro_torch.models.api import Model
    tried = {}

    def fits(d):
        if d not in tried:
            cfg = base.with_overrides(n_layers=d, paged_backend="cuda")
            t0 = time.perf_counter()
            dry = measure(*build_full_train(Model(cfg, META), cfg, rows, seq))
            tried[d] = dict(dry, walk_s=time.perf_counter() - t0)
        return tried[d]["memory"]["peak_bytes"] <= fit

    lo, hi = 0, FULL_MAX_LAYERS + 1         # fits(lo) (0: vacuously); not hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid
    require(lo > 0, f"{base.name}: not even one layer's full step fits")
    return lo, tried


def compare_fused_forward(model, cfg, params, state, batch, tol, **extra):
    """``fused_forward`` through "cuda" (the dual-LoRA kernel merges in
    every projection) and "torch" (merge, then the plain forward), held as
    ``compare_fused_eval`` holds the AdaFusion objective: the cross
    entropy of each backend's logits within ``tol`` relative.  Returns the
    "cuda" run's launch counts."""
    import torch
    from repro_torch import kernels
    from repro_torch.core.dual_lora import fused_forward
    from repro_torch.core.lora import lora_scale
    from repro_torch.training.train_step import cross_entropy
    losses, counts, logits = {}, {}, {}
    for backend in ("cuda", "torch"):
        kernels.reset_launch_counts()
        with torch.no_grad():
            logits[backend], _ = fused_forward(model, params, batch, state,
                                               lora_scale(cfg), backend)
            loss, _ = cross_entropy(cfg, logits[backend], batch)
        losses[backend], counts[backend] = float(loss), kernels.launch_counts()
        if backend == "cuda":
            tiles = kernels.tile_counts()
    err = abs(losses["cuda"] - losses["torch"]) / abs(losses["torch"])
    lg = logits["torch"]
    logit_err = float((logits["cuda"] - lg).abs().max() / lg.abs().max())
    nc = counts["cuda"]
    emit({"phase": "full_train_fused_forward", **extra,
          "w": state.fusion_weights.tolist(), "loss_cuda": losses["cuda"],
          "loss_torch": losses["torch"], "loss_rel_err": err, "tol": tol,
          "max_logit_err_rel_to_max": logit_err, "launches_cuda": nc,
          "tiles_cuda": {n: tiles[n] for n in ("dual_lora_matmul",
                                               "flash_attention")}})
    require(bool(torch.isfinite(logits["cuda"]).all()),
            "fused_forward: cuda logits are not finite")
    require(err <= tol, f"fused_forward loss rel err {err} > {tol}")
    for name in ("dual_lora_matmul", "flash_attention"):
        require_mma_tile(tiles, name, "fused_forward")
    require(all(nc[n] == 0 for n in LORA_KERNELS if n != "dual_lora_matmul"),
            f"fused_forward launched another LoRA kernel: {nc}")
    require(all(n == 0 for n in counts["torch"].values()),
            "the torch fused_forward launched a CUDA kernel")
    return nc


def compare_full_update(model, cfg, params, batch, tol, **extra):
    """One full AdamW step (lr ``FULL_LR``) from the same weights and a
    fresh optimizer state through "cuda" and "torch": per leaf,
    ``||p_cuda - p_torch|| <= tol·||p_torch - p_0||``."""
    import torch
    from repro_torch import kernels
    from repro_torch.core.lora import tree_leaves
    from repro_torch.training.optimizers import adamw
    from repro_torch.training.train_step import make_full_train_step
    opt = adamw(lr=FULL_LR)
    new, counts, loss = {}, {}, {}
    for backend in ("cuda", "torch"):
        kernels.reset_launch_counts()
        step = make_full_train_step(model, cfg, opt, paged_backend=backend)
        p, st, metrics = step(params, opt.init(params), batch)
        new[backend], counts[backend] = dict(tree_leaves(p)), \
            kernels.launch_counts()
        loss[backend] = float(metrics["loss"])
        del p, st
    old = dict(tree_leaves(params))
    errs = {k: float(torch.linalg.vector_norm(new["cuda"][k] - t)
                     / torch.linalg.vector_norm(t - old[k]))
            for k, t in new["torch"].items()}
    worst = max(errs, key=errs.get)
    diff_in_lr = max(float((new["cuda"][k] - t).abs().max()) / FULL_LR
                     for k, t in new["torch"].items())
    emit({"phase": "full_train_update", **extra, "lr": FULL_LR,
          "loss_cuda": loss["cuda"], "loss_torch": loss["torch"],
          "leaves": len(errs), "max_update_rel_err": errs[worst],
          "worst_leaf": worst, "median_update_rel_err":
          sorted(errs.values())[len(errs) // 2], "tol": tol,
          "max_abs_diff_in_lr": diff_in_lr,
          "launches_cuda": counts["cuda"]})
    require(all(bool(torch.isfinite(t).all()) for t in new["cuda"].values()),
            "full AdamW step: a cuda weight is not finite")
    require(errs[worst] <= tol, f"full AdamW step: {worst} differs by "
            f"{errs[worst]} of its update > {tol}")
    require(counts["cuda"]["flash_attention"] > 0
            and all(counts["cuda"][n] == 0 for n in LORA_KERNELS),
            f"full AdamW step launches {counts['cuda']}")
    require(all(n == 0 for n in counts["torch"].values()),
            "the torch full step launched a CUDA kernel")


def full_step_trace(model, cfg, opt, params, st, batch):
    """One full step traced by ``traced``, with the AdamW update, the
    global-norm clip and the weights' update each a row of its own; returns
    (wall ms, {family: device ms})."""
    from torch.profiler import record_function
    from repro_torch.training import train_step as ts
    from repro_torch.training.optimizers import Optimizer

    def update(*a, **kw):
        with record_function("adamw"):
            return opt.update(*a, **kw)
    step = ts.make_full_train_step(model, cfg, Optimizer(opt.init, update),
                                   paged_backend="cuda")
    with Ranges({(ts, "clip_by_global_norm"): "clip",
                 (ts, "apply_updates"): "apply"}):
        return traced(lambda: step(params, st, batch), TRAIN_FAMILIES,
                      "other device work (torch: the flash backward, norms, "
                      "RoPE, SwiGLU, embedding, loss)",
                      ranges=(("adamw", "AdamW update (torch)"),
                              ("clip", "global-norm clip (torch)"),
                              ("apply", "new weights, bf16 (torch)")))


def full_train_phase(device, seed: int, T: int = 256):
    """Full fine-tuning of llama2-7b at full width and the deepest depth
    whose dry-run peak fits: the timed step beside its prediction, its
    launches, a traced step, "cuda" vs "torch" (bf16 at depth, fp32 at one layer, the
    fp32 AdamW update) and ``fused_forward``.  Returns the launch counts
    of the timed step and of the "cuda" ``fused_forward``."""
    import gc

    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.dual_lora import DualLoRAState
    from repro_torch.core.lora import init_adapters, tree_map
    from repro_torch.models.api import Model
    from repro_torch.training.optimizers import adamw
    from repro_torch.training.train_step import (full_value_and_grad,
                                                 make_full_train_step)
    gc.collect()
    torch.cuda.empty_cache()
    card = torch.cuda.get_device_properties(device).total_memory
    resident = torch.cuda.memory_allocated(device)
    base = get_config(FULL_ARCH)
    t_walk = time.perf_counter()
    depth, tried = full_depth(base, FULL_ROWS, T, PEAK_FIT * card)
    emit({"phase": "full_train_depth", "arch": FULL_ARCH, "depth": depth,
          "of": base.n_layers, "card_bytes": card,
          "fit_bytes": PEAK_FIT * card, "resident_bytes": resident,
          "dry_peak_bytes_by_depth": {d: r["memory"]["peak_bytes"]
                                      for d, r in sorted(tried.items())},
          "dry_argument_bytes_by_depth": {
              d: r["memory"]["argument_bytes"]
              for d, r in sorted(tried.items())},
          "walks_s": time.perf_counter() - t_walk,
          "why": f"the deepest of at most {FULL_MAX_LAYERS} layers whose "
                 "dry-run full-step peak fits in "
                 f"{PEAK_FIT:.0%} of the card (bisection)"})
    cfg = base.with_overrides(n_layers=depth)
    dry = tried[depth]
    model = Model(cfg, device)
    params = model.init(seed)
    opt = adamw(lr=FULL_LR)
    st = opt.init(params)
    batch = sft_batch(seed, FULL_ROWS, T, cfg.vocab_size, device)
    step = make_full_train_step(model, cfg, opt, paged_backend="cuda")
    step(params, st, batch)                     # warm-up, outputs dropped
    kernels.reset_launch_counts()
    out, fields = predicted_step(cfg, step, (params, st, batch), FULL_ROWS,
                                 T, dry)
    counts, tiles = kernels.launch_counts(), kernels.tile_counts()
    metrics = out[2]
    del out                             # the new weights and state
    # one traced step, the optimizer's passes as rows of their own
    wall_ms, fam = full_step_trace(model, cfg, opt, params, st, batch)
    emit(_profile_line(fam, wall_ms, phase="profile_full_train",
                       arch=FULL_ARCH, n_layers=depth,
                       rows=FULL_ROWS * T))
    del st, step
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "full_train", "arch": FULL_ARCH, "n_layers": depth,
          "of": base.n_layers, "d_model": cfg.d_model, "rows": FULL_ROWS,
          "seq": T, "params": cfg.count_params(),
          "loss": float(metrics["loss"]), **fields,
          "peak_tol_full": FULL_PEAK_TOL, "launches": counts,
          "flash_tiles": tiles["flash_attention"]})
    require(bool(torch.isfinite(metrics["loss"])), "full step: loss is not "
            "finite")
    require(abs(fields["peak_rel_err"]) <= FULL_PEAK_TOL,
            f"full step: measured peak {fields['measured_peak_bytes']} is "
            f"{fields['peak_rel_err']:+.2%} off the dry run's "
            f"{fields['dry_peak_bytes']}")
    require(counts["flash_attention"] == depth * forwards(cfg),
            f"full step: {counts['flash_attention']} flash launches, not "
            f"{forwards(cfg)} per layer ({depth}; remat {cfg.remat})")
    require_mma_tile(tiles, "flash_attention", "full step")
    require(all(counts[n] == 0 for n in LORA_KERNELS),
            f"full step launched a LoRA kernel: {counts}")
    info = {"arch": FULL_ARCH, "method": "full train step"}
    compare_grads(lambda b: full_value_and_grad(model, cfg, b)(
        params, batch), batch, "bfloat16", 2e-2, 0.25,
        phase="full_train_compare", needs=("flash_attention",),
        n_layers=depth, **info)
    state = DualLoRAState(*(init_adapters(cfg, seed=seed + s,
                                          device=device, b_std=0.02)
                            for s in (200, 201)),
                          torch.tensor([0.6, 0.6], device=device))
    fused = compare_fused_forward(model, cfg, params, state, batch, 2e-2,
                                  arch=FULL_ARCH, n_layers=depth,
                                  rank=cfg.lora_rank)
    del state
    # fp32 at one layer: the step's first layer, embeddings and head
    cut = cfg.with_overrides(n_layers=1, dtype="float32",
                             param_dtype="float32")
    p32 = tree_map(lambda t: t.float(),
                   dict(params, layers=params["layers"][:1]))
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    m32 = Model(cut, device)
    compare_grads(lambda b: full_value_and_grad(m32, cut, b)(p32, batch),
                  batch, "float32", 1e-3, 1e-2, phase="full_train_compare",
                  needs=("flash_attention",), n_layers=1, **info)
    compare_full_update(m32, cut, p32, batch, UPDATE_TOL, arch=FULL_ARCH,
                        n_layers=1, activations="float32")
    del p32, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"step": {n: counts[n] for n in kernels.WRAPPERS},
            "fused_forward": {n: fused[n] for n in kernels.WRAPPERS}}


# ---------------------------------------------------------------------------
# phase 13: activation recomputation (ModelConfig.remat, remat_policy)
# ---------------------------------------------------------------------------

REMAT_SETTINGS = {"off": {"remat": False},
                  "full": {"remat": True, "remat_policy": "full"},
                  "dots": {"remat": True, "remat_policy": "dots"}}
REMAT_SEQ = 4096             # SFT tokens a row
REMAT_ROWS = (8, 4, 2)       # (b): the row counts the dry run picks from
# (b): the share of the card a picked step's predicted peak may take.  The
# walk leaves out about 1.14 GB a 4,096-token row (the card's peak sat that
# far above it at each setting) and the allocator's fragmentation: "full" at
# 8 rows, predicted at 88% of the card, ran out of memory on it with 11.4 GB
# reserved and unallocated
REMAT_FIT = 0.6
REMAT_WALKERS = 6            # host processes walking the dry runs


def forwards(cfg, saved: bool = False) -> int:
    """Forwards a train step runs of each period: 2 under recomputation
    (the recomputed one in backward), else 1.  ``saved``: for an op the
    "dots" policy saves (the LoRA kernel's ``repro_torch::lora_matmul``),
    which "dots" does not run again."""
    if not cfg.remat or (saved and cfg.remat_policy == "dots"):
        return 1
    return 2


def model_sums_per_layer(cfg) -> int:
    """A train step's activation sums over "model" a layer: the
    attention's and the MLP's forward, two of gradients backward, and
    under recomputation the attention's again (the recomputed forward
    stops before the MLP's sum, whose output no backward reads)."""
    return 4 + (1 if cfg.remat else 0)


def walk_in_parallel(jobs):
    """``{key: dry_train_step(cfg, rows, seq)}`` for ``jobs`` ``{key:
    (cfg, rows, seq)}``, walked in ``REMAT_WALKERS`` spawned host
    processes (each walk is single-threaded Python over meta tensors);
    returns a future per key, so the card can work meanwhile."""
    import concurrent.futures
    import multiprocessing
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=min(REMAT_WALKERS, len(jobs)),
        mp_context=multiprocessing.get_context("spawn"))
    return pool, {k: pool.submit(dry_train_step, *job)
                  for k, job in jobs.items()}


def remat_phase(device, seed: int, params, base):
    """llama2-7b's LoRA train step (full width, the serve cell's layers,
    bf16, rank 16 on all 7 targets, 4,096-token SFT rows) at remat
    off, "full" and "dots": (a) one row: loss and every gradient of "full"
    and "dots" bitwise off's (when two off runs agree bitwise; else within
    twice their distance), a timed step per setting beside the dry run's
    peak, its launches ("dots" must launch ``lora_matmul`` as often as
    off: the kernel's outputs are saved, not recomputed); (b) the most
    rows in ``REMAT_ROWS`` at which "full" fits ``REMAT_FIT`` of the card
    and off passes 90% of it, one "full" step there, and "dots" at the
    most rows at which it fits ``REMAT_FIT``.  Returns the launches of
    each timed step."""
    import gc

    import torch
    from repro_torch import kernels
    from repro_torch.core.lora import init_adapters, tree_leaves
    from repro_torch.models.api import Model
    from repro_torch.training.optimizers import adamw
    from repro_torch.training.train_step import (lora_value_and_grad,
                                                 make_lora_train_step)
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    card = torch.cuda.get_device_properties(device).total_memory
    fit, off_fit = REMAT_FIT * card, PEAK_FIT * card
    cfgs = {s: base.with_overrides(lora_rank=16, **kw)
            for s, kw in REMAT_SETTINGS.items()}
    T = REMAT_SEQ
    jobs = {(s, 1): (c, 1, T) for s, c in cfgs.items()}
    jobs.update({(s, rows): (cfgs[s], rows, T) for s in cfgs
                 for rows in REMAT_ROWS})
    pool, walks = walk_in_parallel(jobs)
    heads = base.n_heads
    try:
        ad = init_adapters(cfgs["off"], seed=seed + 100, device=device,
                           b_std=0.02)
        batch = sft_batch(seed, 1, T, base.vocab_size, device)
        # (a) the gradients at each setting (off twice: the card's own
        # repeatability), then a warmed, timed step per setting
        grads, losses = {}, {}
        for s, c in (("off", cfgs["off"]), ("full", cfgs["full"]),
                     ("dots", cfgs["dots"]), ("off2", cfgs["off"])):
            loss, _, g = lora_value_and_grad(Model(c, device), c, "cuda")(
                params, ad, batch)
            torch.cuda.synchronize()
            losses[s], grads[s] = loss, dict(tree_leaves(g))
            del g
        repeat = (torch.equal(losses["off"], losses["off2"])
                  and all(torch.equal(grads["off"][p], grads["off2"][p])
                          for p in grads["off"]))

        def dist(s, ref="off"):
            return max([abs(float(losses[s]) - float(losses[ref]))]
                       + [float((grads[s][p] - grads[ref][p]).abs().max())
                          for p in grads[ref]])
        noise = dist("off2")
        match = {s: dist(s) for s in ("full", "dots")}
        del grads
        steps = {}
        for s in ("off", "full", "dots"):
            c = cfgs[s]
            model = Model(c, device)
            opt = adamw()
            st = opt.init(ad)
            step = make_lora_train_step(model, c, opt, paged_backend="cuda")
            step(params, ad, st, batch)                 # warm-up
            dry = walks[s, 1].result()
            kernels.reset_launch_counts()
            _, fields = predicted_step(c, step, (params, ad, st, batch), 1,
                                       T, dry)
            counts = kernels.launch_counts()
            steps[s] = {"launches": {n: counts[n] for n in
                                     ("lora_matmul", "flash_attention")},
                        **fields}
            del st, step, model
            gc.collect()
            torch.cuda.empty_cache()
        emit({"phase": "remat", "run": "a", "arch": base.name,
              "n_layers": base.n_layers, "d_model": base.d_model,
              "rows": 1, "seq": T, "rank": 16,
              "off_repeats_bitwise": repeat, "off_off_max_abs_diff": noise,
              "max_abs_diff_from_off": match,
              "losses": {k: float(v) for k, v in losses.items()},
              "steps": steps,
              "step_s_over_off": {s: steps[s]["step_s"]
                                  / steps["off"]["step_s"]
                                  for s in steps},
              "peak_over_off": {s: steps[s]["measured_peak_bytes"]
                                / steps["off"]["measured_peak_bytes"]
                                for s in steps}})
        for s in ("full", "dots"):
            if repeat:
                require(match[s] == 0, f"remat (a): {s} is {match[s]} off "
                        "the off step's loss and gradients (two off runs "
                        "agree bitwise)")
            else:
                require(match[s] <= 2 * noise, f"remat (a): {s} is "
                        f"{match[s]} off the off step, over twice two off "
                        f"runs' distance {noise}")
        per = {n: steps["off"]["launches"][n] for n in
               ("lora_matmul", "flash_attention")}
        for s, c in cfgs.items():
            got = steps[s]["launches"]
            require(got["lora_matmul"] == per["lora_matmul"]
                    * forwards(c, saved=True)
                    and got["flash_attention"] == per["flash_attention"]
                    * forwards(c), f"remat (a): {s} launches {got}, off's "
                    f"{per}")
        require(steps["dots"]["launches"]["lora_matmul"]
                == per["lora_matmul"], "remat (a): \"dots\" relaunched "
                "lora_matmul: its outputs were not saved")
        del ad, batch
        gc.collect()
        torch.cuda.empty_cache()

        # (b) the most rows at which "full" fits and off does not, and the
        # most at which "dots" fits
        peaks = {k: w.result()["memory"]["peak_bytes"]
                 for k, w in walks.items() if k[1] != 1}
        full_rows = next((r for r in REMAT_ROWS if peaks["full", r] <= fit
                          and peaks["off", r] > off_fit), None)
        dots_rows = next((r for r in REMAT_ROWS if peaks["dots", r] <= fit),
                         None)
        emit({"phase": "remat_rows", "card_bytes": card, "fit_bytes": fit,
              "off_fit_bytes": off_fit,
              "dry_peak_bytes": {f"{s} {r}": v for (s, r), v in
                                 sorted(peaks.items())},
              "full_rows": full_rows, "dots_rows": dots_rows,
              "why": f"the most rows of {list(REMAT_ROWS)} whose dry-run "
                     f"peak fits in {REMAT_FIT:.0%} of the card (\"full\": "
                     f"where off's passes {PEAK_FIT:.0%} of it)"})
        require(full_rows is not None, "remat (b): no row count where "
                "\"full\" fits and off does not")
        for s, rows in (("full", full_rows), ("dots", dots_rows)):
            if rows is None:
                continue
            c = cfgs[s]
            model = Model(c, device)
            ad = init_adapters(c, seed=seed + 100, device=device,
                               b_std=0.02)
            opt = adamw()
            st = opt.init(ad)
            batch = sft_batch(seed, rows, T, base.vocab_size, device)
            step = make_lora_train_step(model, c, opt, paged_backend="cuda")
            kernels.reset_launch_counts()
            out, fields = predicted_step(c, step, (params, ad, st, batch),
                                         rows, T, walks[s, rows].result())
            counts = kernels.launch_counts()
            metrics = out[2]
            probs = rows * heads * T * T * 4
            emit({"phase": "remat", "run": "b", "setting": s,
                  "rows": rows, "seq": T, **fields,
                  "loss": float(metrics["loss"]),
                  "off_dry_peak_bytes": peaks["off", rows],
                  "launches": {n: counts[n] for n in
                               ("lora_matmul", "flash_attention")},
                  "flash_backward_probs_bytes": probs,
                  "flash_backward_probs_over_dry_temp":
                      probs / fields["dry_temp_bytes"]})
            require(bool(torch.isfinite(metrics["loss"])),
                    f"remat (b): {s} loss is not finite")
            del out, metrics, st, ad, batch, step, model
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        pool.shutdown(cancel_futures=True)
    emit({"phase": "remat_seconds", "seconds": time.perf_counter() - t_phase,
          "walks": len(walks), "walkers": REMAT_WALKERS,
          "walks_s": {f"{s} {r}": w.result()["walk_s"]
                      for (s, r), w in sorted(walks.items())}})
    return {s: steps[s]["launches"] for s in steps}


MESH_LAYERS = 4              # of llama2-7b's 32: the script's time limit
MESH_CLIENTS, MESH_K, MESH_ROWS = 2, 2, 8
MESH_ROUNDS = 2              # the first warms cuBLAS and the kernels
MESH_LORA = 4_997_120        # rank-16 adapter parameters at 4 layers
MESH_TRAVEL_TOL = 1e-3       # (c): a leaf's difference over its travel
MESH_LOSS_ULPS = 4           # (c): the loss's distance in fp32 ulps
MESH_TP_LOSS_ULPS = 16       # (e): the loss's distance in fp32 ulps
MESH_TP_LOSS_REL = 0.02      # (d): the loss's relative distance from (a)'s
MESH_TP_LEAF_TOL = 0.25      # (d): a θ_s' leaf's distance over its travel
MESH_TP_SPREAD = 2.0         # (d): either, over the plain path's spread
MESH_TP_PEAK_TOL = 0.25      # (d): the peak against the dry run's
MESH_TP_ACT = 16_777_216     # (d): one (8, 256, 4096) bf16 activation sum
MESH_TP_REPLICATED = 1_835_008   # (d): a client's adapter values every
                                 # rank holds (458,752 a layer)
GLOO_NOTE = ("gloo through the host on one shared card: a host copy, a "
             "loopback ring and a copy back, not a link rate")


def _collective_summary(log):
    """A log by op, group and payload: count and host ms (total, mean,
    max)."""
    out = {}
    for c in log:
        k = f"{c['op']} {c['axis']}({c['group']}) {c['bytes']} B"
        e = out.setdefault(k, {"n": 0, "ms_total": 0.0, "ms_max": 0.0})
        e["n"] += 1
        e["ms_total"] += c["ms"]
        e["ms_max"] = max(e["ms_max"], c["ms"])
    for e in out.values():
        e["ms_mean"] = e["ms_total"] / e["n"]
    return out


def _pod_logs(res):
    return [[c for c in log if c["axis"] == "pod"]
            for log in res["collectives"]]


def _against_single_rank(personalized, theta, loss, ref, theta_s):
    """(c)'s and (e)'s distances of a mesh round's client (its θ_i
    ``personalized`` and θ_s' ``theta``, whole trees) and losses from the
    same client's round on one rank (``ref``: its θ_s', state and losses;
    ``theta_s``, the round's start): each θ_i leaf's distance over its
    travel, the largest element distance in inner lrs, θ_s''s largest
    error over its bound (:func:`mesh_round_phase` derives it) and the
    worst round's loss distance in fp32 ulps."""
    import numpy as np
    import torch
    from repro_torch.core.lora import tree_leaves
    from repro_torch.federated.distributed import client_slice
    from repro_torch.federated.mesh_job import RoundJob
    lr, step_lr = RoundJob.inner_lr, RoundJob.outer_lr * (
        1 + RoundJob.outer_momentum)
    got_i = dict(tree_leaves(personalized))
    want_i = dict(tree_leaves(client_slice(ref["state"]["personalized"], 0)))
    start = dict(tree_leaves(theta_s))
    travel = {k: float(torch.linalg.vector_norm(got_i[k] - want_i[k])
                       / torch.linalg.vector_norm(want_i[k] - start[k]))
              for k in want_i}
    worst = max(travel, key=travel.get)
    in_lr = max(float((got_i[k] - want_i[k]).abs().max()) / lr
                for k in want_i)
    ratio = 0.0
    for (k, g), (_, w) in zip(tree_leaves(theta), tree_leaves(ref["theta"])):
        # two ulps of θ_s' and four of the update (its own roundings,
        # which alone remain where θ_s and the update cancel)
        upd = step_lr * (start[k] - want_i[k]).abs()
        bnd = (step_lr * (got_i[k] - want_i[k]).abs()
               + 2.0 ** -22 * torch.maximum(g.abs(), w.abs())
               + 2.0 ** -21 * upd)
        ratio = max(ratio, float(((g - w).abs() / bnd.clamp(min=1e-30))
                                 .max()))
    # per round, the distance in fp32 ulps of the single rank's loss
    loss_ulps = max(abs(g - w) / float(np.spacing(np.float32(w)))
                    for g, w in zip(loss, ref["loss"]))
    return {"travel": travel, "worst_leaf": worst,
            "max_leaf_diff_over_travel": travel[worst],
            "max_abs_diff_in_lr": in_lr,
            "theta_s_max_err_over_bound": ratio, "loss_ulps": loss_ulps}


def _gather_model(spec_tree, shards):
    """A whole tree from its two model shards (model coordinates 0, 1):
    each leaf split over "model" joined on that dim
    (``tensor_parallel.join_leaf``: a mamba layer's segmented columns by
    heads within each segment); a replicated leaf taken from rank 0.
    Also returns the shapes of the replicated leaves, and of the leaves
    whose columns every rank holds whole (``in_proj``'s B and C), that
    differ between the ranks."""
    import torch
    from repro_torch.core.partition import entry_axes, spec_map
    from repro_torch.models import tensor_parallel as tpl
    differ = []

    def join(spec, *leaves):
        whole = tpl.replicated(spec, len(leaves))
        if isinstance(whole, torch.Tensor):
            whole = whole.to(leaves[0].device)
            if not all(torch.equal(x[..., whole], leaves[0][..., whole])
                       for x in leaves[1:]):
                differ.append(tuple(leaves[0].shape))
        if any("model" in entry_axes(e) for e in spec):
            return tpl.join_leaf(spec, list(leaves))
        if not all(torch.equal(x, leaves[0]) for x in leaves[1:]):
            differ.append(tuple(leaves[0].shape))
        return leaves[0]
    return spec_map(join, spec_tree, *shards), differ


def _by_axis(log):
    """A round's collective log as {(axis, bytes): count}."""
    out = {}
    for c in log:
        key = (c["axis"], c["bytes"])
        out[key] = out.get(key, 0) + 1
    return out


def mesh_round_phase(device, seed: int, T: int = 256):
    """FDLoRA's round over a torch.distributed mesh (launch/mesh.py,
    federated/mesh_job.py): llama2-7b at full width, ``MESH_LAYERS``
    layers, bf16,
    random weights from ``seed``, rank-16 adapters on all 7 targets (B
    non-zero), 2 clients, K 2, 8 x 256 SFT rows a client and step,
    ``MESH_ROUNDS`` rounds:

    (a) world size 1 on NCCL, in this process: the mesh round bitwise the
        meshless round, ``compress_outer`` "none" and "bf16";
    (b) world size 2 on this one card (gloo; each rank builds the weights
        from the seed): pod 2, one client a rank, θ_s', every client's
        state, the outer state and the loss bitwise (a)'s on both ranks,
        both modes, the LoRA and flash kernels on their tensor-core tiles
        on each rank, exactly one pod all-reduce a round of the adapter
        tree's bytes (and the two losses' slots);
    (c) world size 2, data 2: one client's 8 rows split 4 + 4, fp32, one
        layer, one round, against the same client on one rank.  The
        loss is the global token mean, each rank's masked sum over the
        global count, the two added: the same terms as the single rank's
        in another order, so each round's loss is held within
        ``MESH_LOSS_ULPS`` fp32 ulps of the single rank's (a per-rank
        mean, or a sum never divided, is off by about 2x; AdamW's steps
        barely see the gradient's scale, so θ alone cannot show it).  The
        gradients are sums in another order, so each element moves by a
        relative ρ; AdamW's first update lr·g/(|g|+ε) then moves by at
        most lr·ρ/4.  So each θ_i leaf is held within ``MESH_TRAVEL_TOL``
        (ρ up to 0.4%) of its own travel ||θ_i − θ_s||; θ_s' = θ_s −
        lr_o(1 + μ)(θ_s − θ_i) then within lr_o(1 + μ)·|Δθ_i|, two ulps
        of itself and four of the update, element by element; both ranks
        bitwise equal;
    (d) world size 2, model 2: llama2-7b's heads (16 of 32 a rank), ff
        columns (5,504 of 11,008) and vocabulary (16,000 of 32,000) split
        over the two ranks, (a)'s round otherwise (bf16, compress "none"):
        the replicated leaves of θ_s' and the loss bitwise equal on both
        ranks; θ_s' gathered from the two shards held to (a)'s single
        rank: the worst leaf's distance over its travel and the loss's
        relative distance each within ``MESH_TP_SPREAD`` times the same
        distance of (a)'s round on the plain path (``paged_backend``
        "torch", another bf16 ordering of every product), and never
        looser than the train phase's bf16 bounds (``MESH_TP_LEAF_TOL``,
        ``MESH_TP_LOSS_REL``); the LoRA and
        flash kernels on their tensor-core tiles at the local shapes;
        each round's collectives equal in count and bytes to
        ``launch/dryrun.dry_run(..., mesh=(1, 1, 2))``'s walk of the same
        round, and each rank's peak within ``MESH_TP_PEAK_TOL`` of its
        per-rank peak; s a round beside (a)'s, the model all-reduces'
        host ms beside the data sheet's NVLink time;
    (e) (c)'s fp32 one-layer round at model 2 against the single rank:
        the loss within ``MESH_TP_LOSS_ULPS`` fp32 ulps, each θ_i leaf
        within ``MESH_TRAVEL_TOL`` of its travel and θ_s' within (c)'s
        derived bound.

    Returns the launch counts of each run's last round."""
    import gc

    import torch
    import torch.distributed as dist
    from repro_torch.analysis import roofline as rl
    from repro_torch.configs import get_config
    from repro_torch.core.lora import (adapter_specs, init_adapters,
                                       tree_leaves)
    from repro_torch.federated.distributed import client_slice
    from repro_torch.federated.mesh_job import Case, RoundJob, run, run_jobs
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.dryrun import dry_run
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(ARCH).with_overrides(n_layers=MESH_LAYERS)
    lora = cfg.count_lora_params()
    require(lora == MESH_LORA and cfg.lora_rank == 16
            and len(cfg.lora_targets) == 7,
            f"mesh round: {lora} adapter parameters at rank "
            f"{cfg.lora_rank} on {cfg.lora_targets}")
    base = dict(clients=MESH_CLIENTS, inner_steps=MESH_K, rows=MESH_ROWS,
                seq=T, rounds=MESH_ROUNDS, seed=seed, device=str(device))
    modes = ("none", "bf16")
    payload = {"none": lora * 4 + MESH_CLIENTS * 4,
               "bf16": lora * 2 + MESH_CLIENTS * 8}
    counts = {"a": {}, "b": {}}
    info = {"phase": "mesh_round", "arch": ARCH, "n_layers": MESH_LAYERS,
            "clients": MESH_CLIENTS, "inner_steps": MESH_K,
            "rows": MESH_ROWS, "seq": T, "rounds": MESH_ROUNDS,
            "lora_params": lora}

    # -- (a) world size 1, NCCL, in this process ------------------------------
    res = run(RoundJob(cfg, [Case(pod, compress=c, sync=True)
                             for c in modes for pod in (None, 1)],
                       return_trees=False, **base))
    backend = dist.get_backend()
    dist.destroy_process_group()
    a = {}
    for i, c in enumerate(modes):
        ref, got = res[2 * i], res[2 * i + 1]
        a[c] = got
        same = (got["digest"] == ref["digest"]
                and got["client_digests"] == ref["client_digests"]
                and got["outer_digest"] == ref["outer_digest"]
                and got["loss"] == ref["loss"])
        pods = _pod_logs(got)
        emit({**info, "run": "a", "world": 1, "backend": backend,
              "compress_outer": c, "bitwise_equal_meshless": same,
              "s_per_round": got["seconds"],
              "meshless_s_per_round": ref["seconds"], "loss": got["loss"],
              "pod_allreduce_ms": [p[0]["ms"] for p in pods],
              "collectives": [_collective_summary(l)
                              for l in got["collectives"]],
              "peak_bytes": got["peak_bytes"],
              "launches": {k: got["launches"][k]
                           for k in ("lora_matmul", "flash_attention")},
              "tiles": {k: got["tiles"][k]
                        for k in ("lora_matmul", "flash_attention")}})
        require(same, f"mesh round (a, {c}): not bitwise the meshless round")
        require(all(len(l) == 1 and l[0]["axis"] == "pod"
                    and l[0]["bytes"] == payload[c]
                    for l in got["collectives"]),
                f"mesh round (a, {c}): collectives {got['collectives']}")
        for name in ("lora_matmul", "flash_attention"):
            require_mma_tile(got["tiles"], name, f"mesh round (a, {c})")
        counts["a"][c] = got["launches"]
    del res
    # -- (c)'s single-rank run, here ------------------------------------------
    cfg_c = cfg.with_overrides(n_layers=1, dtype="float32",
                               param_dtype="float32")
    base_c = dict(base, clients=1, rounds=1)
    ref_c = run(RoundJob(cfg_c, [Case(None, sync=True)], **base_c))[0]
    theta_s = init_adapters(cfg_c, seed=seed + 120, device="cpu",
                            b_std=0.02)
    ref_c = mesh_lib.to_cpu({k: ref_c[k] for k in ("theta", "state", "loss",
                                                   "seconds")})
    # -- (d)'s single-rank run: (a)'s meshless round, θ_s' kept --------------
    ref_d = run(RoundJob(cfg, [Case(None, sync=True)], **base))[0]
    ref_d = mesh_lib.to_cpu({k: ref_d[k] for k in ("theta", "loss",
                                                   "seconds", "digest")})
    gc.collect()
    torch.cuda.empty_cache()
    # -- the same round on the plain path: (d)'s spread ------------------------
    ref_t = run(RoundJob(cfg.with_overrides(paged_backend="torch"),
                         [Case(None, sync=True)], **base))[0]
    ref_t = mesh_lib.to_cpu({k: ref_t[k] for k in ("theta", "loss",
                                                   "seconds")})
    gc.collect()
    torch.cuda.empty_cache()
    # -- (b)-(e): two ranks on this one card, gloo ------------------------------
    t0 = time.perf_counter()
    ranks = mesh_lib.spawn(
        run_jobs, 2,
        [RoundJob(cfg, [Case(2, compress=c, sync=True) for c in modes],
                  return_trees=False, **base),
         RoundJob(cfg_c, [Case(1, data=2, sync=True)], **base_c),
         RoundJob(cfg, [Case(1, model=2, sync=True)], **base),
         RoundJob(cfg_c, [Case(1, model=2, sync=True)], **base_c)],
        device=device)
    spawn_s = time.perf_counter() - t0
    counts["b"] = {c: [rk[0][i]["launches"] for rk in ranks]
                   for i, c in enumerate(modes)}
    for i, c in enumerate(modes):
        rs = sorted((rk[0][i] for rk in ranks),
                    key=lambda r: r["coord"]["pod"])
        same = all(r["digest"] == a[c]["digest"] and r["loss"] == a[c]["loss"]
                   and r["outer_digest"] == a[c]["outer_digest"]
                   for r in rs)
        clients = [d for r in rs for d in r["client_digests"]] == \
            a[c]["client_digests"]
        pods = [_pod_logs(r) for r in rs]
        sheet = rl.analyze(0.0, 0.0, chips=2, collectives=[
            rl.Collective(**pods[0][-1][0])])
        emit({**info, "run": "b", "world": 2, "backend": "gloo",
              "mesh": {"pod": 2, "data": 1, "model": 1},
              "compress_outer": c, "bitwise_equal_a": same,
              "clients_bitwise_equal_a": clients,
              "s_per_round": [r["seconds"] for r in rs],
              "loss": rs[0]["loss"],
              "pod_allreduce_bytes": pods[0][-1][0]["bytes"],
              "pod_allreduce_bytes_want": payload[c],
              "pod_allreduce_host_ms": [[p[0]["ms"] for p in pr]
                                        for pr in pods],
              "host_ms_note": GLOO_NOTE,
              "pod_allreduce_nvlink_data_sheet_ms":
                  sheet.collective_s * 1e3,
              "gloo_bf16_on_cuda": "accepted (no host staging)",
              "collectives": [[_collective_summary(l)
                               for l in r["collectives"]] for r in rs],
              "peak_bytes_per_rank": [r["peak_bytes"] for r in rs],
              "launches": [{k: r["launches"][k]
                            for k in ("lora_matmul", "flash_attention")}
                           for r in rs],
              "tiles": [{k: r["tiles"][k]
                         for k in ("lora_matmul", "flash_attention")}
                        for r in rs], "spawn_s": spawn_s})
        require(same and clients, f"mesh round (b, {c}): the two ranks' "
                "θ_s', states or losses are not bitwise (a)'s")
        for r in rs:
            require(all(len(l) == 1 and len(p) == 1
                        and p[0]["bytes"] == payload[c]
                        and p[0]["group"] == 2
                        for l, p in zip(r["collectives"], _pod_logs(r))),
                    f"mesh round (b, {c}): collectives {r['collectives']}")
            for name in ("lora_matmul", "flash_attention"):
                require_mma_tile(r["tiles"], name,
                                 f"mesh round (b, {c}) rank {r['coord']}")
    # -- (c): data 2 against the single rank ------------------------------------
    rc = [rk[1][0] for rk in ranks]
    agree = (rc[0]["digest"] == rc[1]["digest"]
             and rc[0]["client_digests"] == rc[1]["client_digests"])
    far = _against_single_rank(
        client_slice(rc[0]["state"]["personalized"], 0), rc[0]["theta"],
        rc[0]["loss"], ref_c, theta_s)
    travel, worst = far["travel"], far["worst_leaf"]
    in_lr, ratio, loss_ulps = (far["max_abs_diff_in_lr"],
                               far["theta_s_max_err_over_bound"],
                               far["loss_ulps"])
    data = [[c for c in log if c["axis"] == "data"]
            for log in rc[0]["collectives"]]
    emit({**info, "run": "c", "world": 2, "backend": "gloo",
          "mesh": {"pod": 1, "data": 2, "model": 1}, "n_layers": 1,
          "lora_params": cfg_c.count_lora_params(),
          "clients": 1, "rounds": 1, "rows_per_rank": MESH_ROWS // 2,
          "activations": "float32", "ranks_bitwise_equal": agree,
          "loss": rc[0]["loss"], "single_rank_loss": ref_c["loss"],
          "max_leaf_diff_over_travel": travel[worst], "worst_leaf": worst,
          "leaf_diff_over_travel_by_leaf": travel,
          "loss_ulps": loss_ulps, "loss_ulps_tol": MESH_LOSS_ULPS,
          "travel_tol": MESH_TRAVEL_TOL, "max_abs_diff_in_lr": in_lr,
          "theta_s_max_err_over_bound": ratio,
          "s_per_round": [r["seconds"] for r in rc],
          "single_rank_s_per_round": ref_c["seconds"],
          "collectives": [_collective_summary(l)
                          for l in rc[0]["collectives"]],
          "host_ms_note": GLOO_NOTE,
          "peak_bytes_per_rank": [r["peak_bytes"] for r in rc],
          "launches": [{k: r["launches"][k]
                        for k in ("lora_matmul", "flash_attention")}
                       for r in rc]})
    require(agree, "mesh round (c): the two ranks' θ differ")
    require(travel[worst] <= MESH_TRAVEL_TOL,
            f"mesh round (c): {worst} is {travel[worst]} of its travel off")
    require(loss_ulps <= MESH_LOSS_ULPS,
            f"mesh round (c): loss {rc[0]['loss']} is {loss_ulps} fp32 ulps "
            f"off the single rank's {ref_c['loss']}")
    require(ratio <= 1.0, f"mesh round (c): θ_s' {ratio} x its bound off")
    require(all(len(d) == MESH_K + 1 for d in data),
            f"mesh round (c): data all-reduces {data}")
    require(all(r["launches"]["lora_matmul"] > 0
                and r["launches"]["flash_attention"] > 0 for r in rc),
            "mesh round (c): a rank launched no LoRA or flash kernel")
    counts["c"] = [r["launches"] for r in rc]
    # -- (d): model 2, llama2-7b's heads, ff columns and vocabulary split ------
    specs = adapter_specs(cfg)
    rd = sorted((rk[2][0] for rk in ranks), key=lambda r: r["coord"]["model"])
    theta_d, differ = _gather_model(specs, [r["theta"] for r in rd])
    start = dict(tree_leaves(init_adapters(cfg, seed=seed + 120,
                                           device="cpu", b_std=0.02)))
    want = dict(tree_leaves(ref_d["theta"]))

    def off_a(theta, loss):
        """Each leaf's distance from (a)'s θ_s' over its travel, and the
        loss's largest relative distance from (a)'s."""
        leaf = {k: float(torch.linalg.vector_norm(g - want[k])
                         / torch.linalg.vector_norm(want[k] - start[k]))
                for k, g in tree_leaves(theta)}
        return leaf, max(abs(g - w) / abs(w)
                         for g, w in zip(loss, ref_d["loss"]))
    leaf, loss_rel = off_a(theta_d, rd[0]["loss"])
    worst_d = max(leaf, key=leaf.get)
    spread, spread_loss = off_a(ref_t["theta"], ref_t["loss"])
    worst_t = max(spread, key=spread.get)
    # the split reorders and re-rounds sums in bf16 (each row-parallel
    # product as two rounded partials and their rounded sum, the
    # vocabulary's max and sum of exps, the column-parallel inputs'
    # gradients): a second bf16 ordering of the same round, as the plain
    # path is of every product.  AdamW's first steps move an element by
    # about lr·sign(g), so a leaf's distance grows as the root of the
    # share of its elements whose sign flips: twice the plain path's
    # spread covers a perturbation four times as large.
    leaf_bound = min(MESH_TP_LEAF_TOL, MESH_TP_SPREAD * spread[worst_t])
    loss_bound = min(MESH_TP_LOSS_REL, MESH_TP_SPREAD * spread_loss)
    t_dry = time.perf_counter()
    dry = dry_run(cfg.with_overrides(paged_backend="cuda"), "fdlora_round",
                  MESH_CLIENTS * MESH_ROWS, T, mesh=(1, 1, 2),
                  n_clients=MESH_CLIENTS, K=MESH_K)
    dry_s = time.perf_counter() - t_dry
    dry_log = _by_axis(dry["collectives"])
    dry_peak = dry["memory"]["peak_bytes"]
    model_logs = [[[c for c in log if c["axis"] == "model"]
                   for log in r["collectives"]] for r in rd]
    sheet = rl.analyze(0.0, 0.0, chips=2, collectives=[
        rl.Collective(**c) for c in model_logs[0][-1]])
    # a round's model all-reduces: per client and step 4 a layer less the
    # first layer's attention input (no gradient flows there), and under
    # recomputation the attention's sum again (model_sums_per_layer), the
    # embedding's and the unembedding's, each one activation; 3 of the
    # cross entropy; per step one of both clients' replicated leaves and
    # their squared norms
    acts = ((model_sums_per_layer(cfg) * MESH_LAYERS + 1) * MESH_CLIENTS
            * MESH_K)
    grad_bytes = 4 * MESH_CLIENTS * (MESH_TP_REPLICATED + 1)
    emit({**info, "run": "d", "world": 2, "backend": "gloo",
          "mesh": {"pod": 1, "data": 1, "model": 2},
          "heads_per_rank": cfg.n_heads // 2,
          "ff_columns_per_rank": cfg.d_ff // 2,
          "vocab_columns_per_rank": cfg.vocab_size // 2,
          "replicated_leaves_differ": differ,
          "loss": rd[0]["loss"], "loss_per_rank": [r["loss"] for r in rd],
          "single_rank_loss": ref_d["loss"],
          "single_rank_bitwise_a": ref_d["digest"] == a["none"]["digest"],
          "max_loss_rel": loss_rel, "loss_rel_bound": loss_bound,
          "max_leaf_diff_over_travel": leaf[worst_d], "worst_leaf": worst_d,
          "leaf_bound": leaf_bound,
          "plain_path_loss": ref_t["loss"],
          "plain_path_max_loss_rel": spread_loss,
          "plain_path_max_leaf_diff_over_travel": spread[worst_t],
          "plain_path_worst_leaf": worst_t,
          "plain_path_s_per_round": ref_t["seconds"],
          "spread_factor": MESH_TP_SPREAD,
          "ceilings": {"loss_rel": MESH_TP_LOSS_REL,
                       "leaf": MESH_TP_LEAF_TOL},
          "leaf_diff_over_travel_by_leaf": leaf,
          "plain_path_by_leaf": spread,
          "s_per_round": [r["seconds"] for r in rd],
          "a_s_per_round": a["none"]["seconds"],
          "s_note": "both ranks share one card: no gain is claimed",
          "model_allreduces_per_round": [len(l) for l in model_logs[0]],
          "model_allreduce_host_ms": [sum(c["ms"] for c in l)
                                      for l in model_logs[0]],
          "model_allreduce_activation_host_ms_mean": [
              sum(c["ms"] for c in l if c["bytes"] == MESH_TP_ACT)
              / max(1, sum(c["bytes"] == MESH_TP_ACT for c in l))
              for l in model_logs[0]],
          "host_ms_note": GLOO_NOTE,
          "model_allreduce_nvlink_data_sheet_ms": sheet.collective_s * 1e3,
          "collectives": [_collective_summary(l)
                          for l in rd[0]["collectives"]],
          "dry_run_collectives": {f"{a_} {b_}": n
                                  for (a_, b_), n in dry_log.items()},
          "dry_run_s": dry_s,
          "peak_bytes_per_rank": [r["peak_bytes"] for r in rd],
          "dry_run_peak_bytes": dry_peak,
          "dry_run_argument_bytes": dry["memory"]["argument_bytes"],
          "launches": [{k: r["launches"][k]
                        for k in ("lora_matmul", "flash_attention")}
                       for r in rd],
          "tiles": [{k: r["tiles"][k]
                     for k in ("lora_matmul", "flash_attention")}
                    for r in rd]})
    require(not differ and rd[0]["loss"] == rd[1]["loss"],
            f"mesh round (d): replicated leaves {differ} or the losses "
            f"{[r['loss'] for r in rd]} differ between the ranks")
    require(loss_rel <= loss_bound,
            f"mesh round (d): loss {rd[0]['loss']} is {loss_rel} off the "
            f"single rank's {ref_d['loss']} (bound {loss_bound})")
    require(leaf[worst_d] <= leaf_bound,
            f"mesh round (d): {worst_d} is {leaf[worst_d]} of its travel "
            f"off the single rank's θ_s' (bound {leaf_bound})")
    for r in rd:
        for name in ("lora_matmul", "flash_attention"):
            require_mma_tile(r["tiles"], name,
                             f"mesh round (d) rank {r['coord']}")
        for log in r["collectives"]:
            got = _by_axis(log)
            require(got == dry_log
                    and got.get(("model", MESH_TP_ACT)) == acts
                    and got.get(("model", grad_bytes)) == MESH_K,
                    f"mesh round (d) rank {r['coord']}: collectives {got}, "
                    f"the dry run's {dry_log}")
        require(abs(r["peak_bytes"] - dry_peak) <= MESH_TP_PEAK_TOL
                * dry_peak, f"mesh round (d) rank {r['coord']}: peak "
                f"{r['peak_bytes']} against the dry run's {dry_peak}")
    counts["d"] = [r["launches"] for r in rd]
    # -- (e): (c)'s round at model 2 against the single rank -------------------
    re_ = sorted((rk[3][0] for rk in ranks),
                 key=lambda r: r["coord"]["model"])
    specs_c = adapter_specs(cfg_c)
    theta_e, differ = _gather_model(specs_c, [r["theta"] for r in re_])
    pers, differ_p = _gather_model(specs_c, [
        client_slice(r["state"]["personalized"], 0) for r in re_])
    far = _against_single_rank(pers, theta_e, re_[0]["loss"], ref_c,
                               theta_s)
    emit({**info, "run": "e", "world": 2, "backend": "gloo",
          "mesh": {"pod": 1, "data": 1, "model": 2}, "n_layers": 1,
          "lora_params": cfg_c.count_lora_params(), "clients": 1,
          "rounds": 1, "activations": "float32",
          "replicated_leaves_differ": differ + differ_p,
          "loss": re_[0]["loss"], "single_rank_loss": ref_c["loss"],
          **{k: v for k, v in far.items() if k != "travel"},
          "leaf_diff_over_travel_by_leaf": far["travel"],
          "loss_ulps_tol": MESH_TP_LOSS_ULPS, "travel_tol": MESH_TRAVEL_TOL,
          "s_per_round": [r["seconds"] for r in re_],
          "single_rank_s_per_round": ref_c["seconds"],
          "collectives": [_collective_summary(l)
                          for l in re_[0]["collectives"]],
          "launches": [{k: r["launches"][k]
                        for k in ("lora_matmul", "flash_attention")}
                       for r in re_]})
    require(not differ and not differ_p
            and re_[0]["loss"] == re_[1]["loss"],
            "mesh round (e): the ranks' replicated leaves or losses differ")
    require(far["max_leaf_diff_over_travel"] <= MESH_TRAVEL_TOL,
            f"mesh round (e): {far['worst_leaf']} is "
            f"{far['max_leaf_diff_over_travel']} of its travel off")
    # the split reorders four sums the loss reads (wo's and w_out's
    # partials, the vocabulary's max and its sum of exps), each able to
    # move the loss as far as (c)'s reordered global mean: 4 x (c)'s bound
    require(far["loss_ulps"] <= MESH_TP_LOSS_ULPS,
            f"mesh round (e): loss {re_[0]['loss']} is {far['loss_ulps']} "
            f"fp32 ulps off the single rank's {ref_c['loss']}")
    require(far["theta_s_max_err_over_bound"] <= 1.0,
            f"mesh round (e): θ_s' {far['theta_s_max_err_over_bound']} x "
            "its bound off")
    require(all(r["launches"]["lora_matmul"] > 0
                and r["launches"]["flash_attention"] > 0 for r in re_),
            "mesh round (e): a rank launched no LoRA or flash kernel")
    counts["e"] = [r["launches"] for r in re_]
    return counts


MESH_SERVE_LAYERS = 4        # of llama2-7b's 32: the script's time limit
#                              (32 took 108.7 s alone, 16 took 40-65 s)
MESH_SERVE_REQUESTS = 8      # 8 slots, 8 tenants
MESH_SERVE_NEW = 16          # new tokens a request
MESH_SERVE_PROMPTS = (128, 512)
MESH_SERVE_REL = 0.1         # (b): first-chunk error over the largest logit


def _serve_summary(res, ref=None):
    """A run's times beside the meshless run's: TTFT p50 and max, decode
    tok/s, total s."""
    import numpy as np
    out = {}
    for tag, r in (("", res),) + ((("meshless_", ref),) if ref else ()):
        ttft = [t for t in r["ttft_s"] if t is not None]
        out.update({
            f"{tag}ttft_ms_p50": float(np.percentile(ttft, 50)) * 1e3,
            f"{tag}ttft_ms_max": max(ttft) * 1e3,
            f"{tag}decode_tok_per_s": (r["decode_tokens"] / r["decode_s"]
                                       if r["decode_s"] > 0 else None),
            f"{tag}total_s": r["total_s"]})
    return out


def _first_chunk_err(got, want, n_new):
    """Max |got - want| over the valid positions, and the largest |want|
    there."""
    import torch
    valid = (torch.arange(want.shape[1])[None, :] < n_new[:, None])
    return (float((got - want).abs()[valid].max()),
            float(want.abs()[valid].max()))


def _stream_walks(cfg, mesh, st, slots, T, span):
    """The collectives a stream of ``st`` (its prefill dispatches and
    decode steps) issues per the dry run's walks of one dispatch of each
    at ``mesh``: {(axis, bytes): count}, and the decode walk."""
    from repro_torch.launch.dryrun import dry_run
    cfg = cfg.with_overrides(paged_backend="cuda")
    pre = dry_run(cfg, "prefill", slots, T, mesh=mesh)
    dec = dry_run(cfg, "decode", slots, span, mesh=mesh)
    want = {}
    for walk, n in ((pre, st["prefill_dispatches"]),
                    (dec, st["decode_steps"])):
        for k, v in _by_axis(walk["collectives"]).items():
            want[k] = want.get(k, 0) + n * v
    return want, dec


def mesh_serve_phase(device, seed: int, T: int = 256):
    """Serving over a torch.distributed mesh (``ServeConfig.mesh``;
    ``launch/serve.ServeJob`` is the rank program): llama2-7b at full
    width, ``MESH_SERVE_LAYERS`` layers, bf16, random weights from
    ``seed``, 8 tenants' rank-16 fused adapters, a closed batch of 8
    requests (prompts 128-512 tokens, 16 new tokens, prefill chunk T)
    through ``MultiTenantEngine.generate`` on "cuda".  The meshless runs
    (num_shards 2 and 1) in this process; then two ranks on this one card
    (gloo, spawned, each building the weights from the seed):

    (a) mesh (1, 2, 1), num_shards 2: each rank serves 4 of the 8 slots
        (its shard's blocks in its own pool) with the whole base; its
        first chunk bitwise the same 4 rows' on one device (the meshless
        engine, here); streams bitwise the meshless num_shards 2 run's
        where the card gives it, else held by the margin rule (a rank's
        projections run on 4 rows where the meshless ones run on 8, and
        a kernel may take another plan at another row count: the 4-row
        chunk on one device differs from the 8-row one as much), the
        error base being the first chunk's;
    (b) mesh (1, 1, 2): each rank its 16 of 32 heads (and kv heads), 5,504
        of 11,008 ff columns, 16,000 of 32,000 vocabulary columns, of the
        base, the bank and the pools (the base freed once (a) is done):
        the first chunk's logits, gathered over the ranks, within
        ``MESH_SERVE_REL`` of the largest logit of the meshless chunk's
        (bf16: each row-parallel product becomes two rounded partials and
        their rounded sum), the streams by the margin rule on that error;
        the ranks' collectives equal to ``dryrun.dry_run``'s ``prefill``
        and ``decode`` walks at (1, 1, 2), dispatch by dispatch; each
        rank's peak beside the dry run's decode peak; the all-reduces'
        host ms beside the data sheet's NVLink time;
    (c) under (b), int8 K/V with the prefix cache: a cold run and a warm
        one (the pool kept), the warm one reusing the pool and hitting,
        its streams held to the cold ones by the margin rule on (b)'s
        error.

    Each rank's paged_attention, paged_prefill_attention and
    batched_lora_matmul launch in every case at the rank's shapes, the
    prefill and LoRA kernels on their tensor-core tiles; decode tok/s and
    TTFT beside the meshless runs' (two ranks share one card through
    gloo: no gain is claimed).  Returns each case's launches on rank 0."""
    import gc

    import torch
    from repro_torch import kernels
    from repro_torch.analysis import roofline as rl
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.serve import (ServeJob, build_engine, mesh_serve,
                                          ragged_requests, serve_runs)
    from repro_torch.serving.engine import ServeConfig
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(ARCH).with_overrides(n_layers=MESH_SERVE_LAYERS,
                                          lora_rank=16)
    reqs = ragged_requests(MESH_SERVE_REQUESTS, 8, cfg.vocab_size,
                           *MESH_SERVE_PROMPTS, seed)
    span = max(len(r.prompt) for r in reqs) + MESH_SERVE_NEW
    width = min(T, span - 1)
    kw = dict(batch_size=MESH_SERVE_REQUESTS, max_new_tokens=MESH_SERVE_NEW,
              prefill_chunk=T, block_size=16, paged_backend="cuda")
    per = -(-span // 16)
    int8 = dict(kw, kv_dtype="int8", prefix_cache=True,
                num_blocks=1 + MESH_SERVE_REQUESTS * per)
    info = {"phase": "mesh_serve", "arch": ARCH,
            "n_layers": MESH_SERVE_LAYERS, "requests": len(reqs),
            "prompt_lens": [len(r.prompt) for r in reqs],
            "new_tokens": MESH_SERVE_NEW, "prefill_chunk": width,
            "tenants": 8, "lora_rank": 16}
    # -- the meshless runs, here ----------------------------------------------
    t_ref = time.perf_counter()
    eng = build_engine(cfg, 8, device, seed)
    job = ServeJob(cfg, reqs, [("ref2", None, dict(kw, num_shards=2)),
                               ("ref1", None, kw)],
                   seed=seed, first_chunk=("ref1",))
    ref = serve_runs(eng, job)
    ref = mesh_lib.to_cpu(ref)
    require(ref["ref1"]["streams"] == ref["ref2"]["streams"],
            "mesh serve: the meshless streams at 1 and 2 shards differ")
    # the first chunk on one device at each data rank's 4 rows: what (a)'s
    # ranks must reproduce bit for bit
    half = MESH_SERVE_REQUESTS // 2
    with torch.no_grad():
        halves = [mesh_lib.to_cpu(first_chunk_logits(
            eng, reqs, ServeConfig(**kw), "cuda",
            rows=(i * half, (i + 1) * half))[0]) for i in (0, 1)]
    eng.release_prefix_cache()
    torch.cuda.empty_cache()
    meshless_s = time.perf_counter() - t_ref
    # -- (a)-(c): two ranks on this card ----------------------------------------
    t0 = time.perf_counter()
    runs = [("a", (1, 2, 1), dict(kw, num_shards=2)), ("b", (1, 1, 2), kw),
            ("c_cold", (1, 1, 2), int8), ("c_warm", (1, 1, 2), int8)]
    ranks = mesh_lib.spawn(
        mesh_serve, 2,
        ServeJob(cfg, reqs, runs, seed=seed, first_chunk=("a", "b")),
        device=device)
    spawn_s = time.perf_counter() - t0
    want_logits, n_new = ref["ref1"]["first_chunk"]
    t_dry = time.perf_counter()
    walk_a, _ = _stream_walks(cfg, (1, 2, 1), ranks[0]["a"]["stats"],
                              MESH_SERVE_REQUESTS, width, span)
    walk_b, dec = _stream_walks(cfg, (1, 1, 2), ranks[0]["b"]["stats"],
                                MESH_SERVE_REQUESTS, width, span)
    dry_s = time.perf_counter() - t_dry
    counts = {}
    for case in ("a", "b", "c_cold", "c_warm"):
        for rk in ranks:
            r = rk[case]
            for name in ("paged_attention", "paged_prefill_attention",
                         "batched_lora_matmul"):
                require(r["launches"][name] > 0,
                        f"mesh serve ({case}) rank {r['coord']}: {name} "
                        "never launched")
            for name in ("paged_prefill_attention", "batched_lora_matmul"):
                require_mma_tile(r["tiles"], name,
                                 f"mesh serve ({case}) rank {r['coord']}")
        counts[case] = {n: ranks[0][case]["launches"][n]
                        for n in kernels.SERVING}
    # -- (a) --------------------------------------------------------------------
    ra = sorted((rk["a"] for rk in ranks), key=lambda r: r["coord"]["data"])
    got_a = torch.cat([r["first_chunk"][0] for r in ra], 0)
    err_a, top = _first_chunk_err(got_a, want_logits, n_new)
    rows_bitwise = all(torch.equal(r["first_chunk"][0], h)
                       for r, h in zip(ra, halves))
    err_half, _ = _first_chunk_err(torch.cat(halves, 0), want_logits, n_new)
    require(rows_bitwise, "mesh serve (a): a data rank's first chunk is not "
            "bitwise the same 4 rows' on one device")
    want_a = ref["ref2"]["streams"]
    same_a = all(r["streams"] == want_a for r in ra)
    matched_a = streams_by_margin(eng, reqs, ServeConfig(**kw),
                                  ra[0]["streams"], want_a, err_a,
                                  "mesh serve (a)")
    require(ra[0]["streams"] == ra[1]["streams"],
            "mesh serve (a): the two ranks' streams differ")
    for r in ra:
        require(_by_axis(r["collectives"]) == walk_a,
                f"mesh serve (a) rank {r['coord']}: collectives "
                f"{_by_axis(r['collectives'])}, the dry run's {walk_a}")
    emit({**info, "run": "a", "world": 2, "backend": "gloo",
          "mesh": {"pod": 1, "data": 2, "model": 1}, "num_shards": 2,
          "slots_per_rank": MESH_SERVE_REQUESTS // 2,
          "streams_bitwise_meshless": same_a,
          "stream_prefix_matched": matched_a,
          "first_chunk_max_abs_err": err_a, "max_abs_logit": top,
          "first_chunk_rows_bitwise_one_device_at_4_rows": rows_bitwise,
          "one_device_4_rows_against_8_rows_max_abs_err": err_half,
          **_serve_summary(ra[0], ref["ref2"]),
          "prefill_dispatches": ra[0]["stats"]["prefill_dispatches"],
          "decode_steps": ra[0]["stats"]["decode_steps"],
          "collectives": _collective_summary(ra[0]["collectives"]),
          "host_ms_note": GLOO_NOTE,
          "peak_bytes_per_rank": [r["peak_bytes"] for r in ra],
          "launches": [{k: r["launches"][k] for k in kernels.SERVING}
                       for r in ra],
          "meshless_s": meshless_s, "spawn_s": spawn_s})
    # -- (b) --------------------------------------------------------------------
    rb = sorted((rk["b"] for rk in ranks), key=lambda r: r["coord"]["model"])
    got_b = torch.cat([r["first_chunk"][0] for r in rb], -1)
    err_b, top = _first_chunk_err(got_b, want_logits, n_new)
    want_b = ref["ref1"]["streams"]
    require(rb[0]["streams"] == rb[1]["streams"],
            "mesh serve (b): the two ranks' streams differ")
    require(err_b <= MESH_SERVE_REL * top,
            f"mesh serve (b): first-chunk error {err_b} over "
            f"{MESH_SERVE_REL} x the largest logit {top}")
    matched_b = streams_by_margin(eng, reqs, ServeConfig(**kw),
                                  rb[0]["streams"], want_b, err_b,
                                  "mesh serve (b)")
    for r in rb:
        require(_by_axis(r["collectives"]) == walk_b,
                f"mesh serve (b) rank {r['coord']}: collectives "
                f"{_by_axis(r['collectives'])}, the dry run's {walk_b}")
    act = MESH_SERVE_REQUESTS * cfg.d_model * 2    # a decode step's sum
    step_log = [c for c in rb[0]["collectives"]
                if c["axis"] == "model" and c["bytes"] == act]
    per_step = 2 * cfg.n_layers + 1
    sheet = rl.analyze(0.0, 0.0, chips=2, collectives=[
        rl.Collective(**c) for c in step_log[:per_step]])
    emit({**info, "run": "b", "world": 2, "backend": "gloo",
          "mesh": {"pod": 1, "data": 1, "model": 2},
          "heads_per_rank": cfg.n_heads // 2,
          "kv_heads_per_rank": cfg.n_kv_heads // 2,
          "ff_columns_per_rank": cfg.d_ff // 2,
          "vocab_columns_per_rank": cfg.vocab_size // 2,
          "first_chunk_max_abs_err": err_b, "max_abs_logit": top,
          "first_chunk_rel_err": err_b / top, "rel_bound": MESH_SERVE_REL,
          "streams_bitwise_meshless": rb[0]["streams"] == want_b,
          "stream_prefix_matched": matched_b,
          **_serve_summary(rb[0], ref["ref1"]),
          "prefill_dispatches": rb[0]["stats"]["prefill_dispatches"],
          "decode_steps": rb[0]["stats"]["decode_steps"],
          "deferred_chunks": rb[0]["stats"]["deferred_chunks"],
          "collectives": _collective_summary(rb[0]["collectives"]),
          "dry_run_collectives": {f"{k[0]} {k[1]} B": n
                                  for k, n in walk_b.items()},
          "allreduces_per_decode_step": per_step + 1,
          "decode_step_allreduce_host_ms_mean": (
              sum(c["ms"] for c in step_log) / max(1, len(step_log))),
          "decode_step_allreduce_host_ms_total_per_step": (
              sum(c["ms"] for c in step_log)
              / max(1, rb[0]["stats"]["decode_steps"])),
          "decode_step_allreduces_nvlink_data_sheet_ms":
              sheet.collective_s * 1e3,
          "host_ms_note": GLOO_NOTE,
          "peak_bytes_per_rank": [r["peak_bytes"] for r in rb],
          "dry_run_decode_peak_bytes": dec["memory"]["peak_bytes"],
          "dry_run_decode_argument_bytes": dec["memory"]["argument_bytes"],
          "dry_runs_s": dry_s,
          "launches": [{k: r["launches"][k] for k in kernels.SERVING}
                       for r in rb]})
    # -- (c) --------------------------------------------------------------------
    rc = [sorted((rk[c] for rk in ranks), key=lambda r: r["coord"]["model"])
          for c in ("c_cold", "c_warm")]
    cold, warm = rc[0][0], rc[1][0]
    require(rc[0][1]["streams"] == cold["streams"]
            and rc[1][1]["streams"] == warm["streams"],
            "mesh serve (c): the two ranks' streams differ")
    require(warm["stats"]["prefix_pool_reused"]
            and warm["stats"]["prefix_hit_tokens"] > 0,
            f"mesh serve (c): the warm run hit "
            f"{warm['stats']['prefix_hit_tokens']} tokens")
    matched_c = streams_by_margin(eng, reqs, ServeConfig(**int8),
                                  warm["streams"], cold["streams"], err_b,
                                  "mesh serve (c) warm vs cold")
    emit({**info, "run": "c", "world": 2, "backend": "gloo",
          "mesh": {"pod": 1, "data": 1, "model": 2}, "kv_dtype": "int8",
          "prefix_cache": True, "warm_bitwise_cold": (warm["streams"]
                                                      == cold["streams"]),
          "stream_prefix_matched": matched_c,
          "prefix_hit_tokens": warm["stats"]["prefix_hit_tokens"],
          "cold": _serve_summary(cold), "warm": _serve_summary(warm),
          "peak_bytes_per_rank": [r["peak_bytes"] for r in rc[1]]})
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 12c: experts over a torch.distributed mesh
# ---------------------------------------------------------------------------

MESH_MOE_ARCH = "dbrx-132b"
MESH_MOE_LAYERS = 2         # of 40: the script's time limit
MESH_MOE_TENANTS = 4
MESH_MOE_REQUESTS = 8       # 8 slots
MESH_MOE_PROMPTS = (128, 512)
MESH_MOE_NEW = 16
MESH_MOE_REL = 0.1          # first chunk, of the largest logit (bf16)
MESH_MOE_ROWS = 4           # a client's rows a step in the round
MESH_MOE_LEAF_TOL = 0.25    # bf16: each θ_s' leaf, of its travel, or
MESH_MOE_SPREAD = 2.0       # this times the same leaf's on the plain path,
MESH_MOE_LEAF_CAP = 0.75    # if larger, but never past this (unmoved: 1)
MESH_MOE_LOSS_REL = 0.02    # bf16: the loss and the aux metric (train's)
MESH_MOE_FP32_LEAF = 1e-3   # fp32, one layer: of the travel
MESH_MOE_LOSS_ULPS = 16     # fp32, one layer
MESH_MOE_AUX_ULPS = 4


def mesh_moe_peaks(cfg, span: int, T: int):
    """A rank's dry-run peaks at data 2 (a decode step of every slot, a
    prefill chunk, the round) at ``cfg``'s depth."""
    from repro_torch.launch.dryrun import dry_run
    c = cfg.with_overrides(paged_backend="cuda")
    return {s: dry_run(c, s, MESH_MOE_REQUESTS, n, mesh=(1, 2, 1),
                       **kw)["memory"]["peak_bytes"]
            for s, n, kw in (("decode", span, {}), ("prefill", T, {}),
                             ("fdlora_round", T, {"n_clients": 2, "K": 1}))}


def mesh_moe_chunk(eng, reqs, sc, recs, got, what):
    """The meshless first chunk ("cuda", this process) with each MoE
    layer's expert ids pinned to the ranks' (``recs``: their routing
    records, in row order), against the ranks' logits ``got``:
    (error, largest logit, flips by layer, dropped copies by layer, the
    largest flipped gap by layer, the error against the unpinned meshless
    chunk).  Held: the error within ``MESH_MOE_REL`` of the largest
    logit, the dropped copies per layer equal, and each flip (a token
    whose experts the ranks and the meshless routing pick differently)
    one the rounding can make: its k-th vs (k+1)-th router-logit gap at
    most twice that layer's router-logit error, ranks against meshless.
    The unpinned error, flips included (a flip moves a token by a whole
    expert's share, PR 22), is the one the streams' margin rule takes."""
    import torch
    ids = [torch.cat(x, 0) for x in zip(*(r["ids"] for r in recs))]
    logits = [torch.cat(x, 0) for x in zip(*(r["logits"] for r in recs))]
    dropped = [r["dropped"] for r in recs]
    require(all(d == dropped[0] for d in dropped),
            f"{what}: the ranks count other dropped copies {dropped}")
    k = eng.cfg.n_experts_per_tok
    with RoutingLog(pinned=[i.to(eng.device) for i in ids]) as rl:
        want, n_new = first_chunk_logits(eng, reqs, sc, "cuda")
    want = want.float().cpu()
    err, top = _first_chunk_err(got.float(), want, n_new)
    free, _ = first_chunk_logits(eng, reqs, sc, "cuda")
    err_free, _ = _first_chunk_err(got.float(), free.float().cpu(), n_new)
    flips = _flips(ids, [i.cpu() for i in rl.ids])
    worst = []
    for lw, lg, flip in zip(rl.logits, logits, flips):
        lw = lw.cpu()
        e = float((lw - lg).abs().max())
        gaps = torch.topk(lw, k + 1, dim=-1).values
        gap = (gaps[:, k - 1] - gaps[:, k])[flip]
        worst.append(float(gap.max()) if gap.numel() else None)
        require(worst[-1] is None or worst[-1] <= 2 * e,
                f"{what}: a routing flip with router-logit gap {worst[-1]} "
                f"> 2 x the router error {e}")
    mine = rl.dropped
    require(mine == dropped[0], f"{what}: dropped copies {dropped[0]}, the "
            f"meshless fused batch's {mine}")
    require(err <= MESH_MOE_REL * top, f"{what}: first-chunk error {err} "
            f"over {MESH_MOE_REL} x the largest logit {top}")
    return err, top, [int(f.sum()) for f in flips], mine, worst, err_free


def _ulps(got: float, want: float) -> float:
    import numpy as np
    return abs(got - want) / float(np.spacing(np.float32(want)))


def mesh_moe_phase(device, seed: int, T: int = 256):
    """Experts over a torch.distributed mesh: dbrx-132b at full width,
    ``MESH_MOE_LAYERS`` of 40 layers (two ranks' dry-run peaks at data 2
    must fit in 90% of the card), bf16, random
    weights from ``seed``, ``MESH_MOE_TENANTS`` tenants' rank-16 fused
    adapters (the router's pair included), 8 requests (prompts 128-512
    tokens, 16 new tokens, prefill chunk T) through
    ``MultiTenantEngine.generate`` on "cuda".  The meshless engine (at 1
    and 2 shards) and rounds run here and are freed; then one spawn of
    two ranks on this card (gloo; ``launch/mesh.run_each`` of the serve
    and round rank programs):

    (a) mesh (1, 1, 2): each rank 24 of 48 heads, 4 of 8 kv heads, 8 of
        16 experts (drawn as they are cut, no whole base held), half the
        vocabulary and half the bank's sharded factors: routing ids
        bitwise equal on the two ranks; the first chunk's logits,
        gathered, against the meshless chunk with each layer's expert ids
        pinned to the ranks' (:func:`mesh_moe_chunk`), the streams by the
        margin rule on the unpinned chunk's error (a routing flip moves a
        token by a whole expert's share); the collectives equal to the dry
        run's ``prefill`` and ``decode`` walks at (1, 1, 2); each rank's peak
        beside the dry run's; decode tok/s beside the rank's expert-read
        byte bound (its 8 experts a layer);
    (b) mesh (1, 2, 1), ``num_shards`` 2: each rank the whole base and 4
        slots, the routing ids gathered over "data" so each expert's
        capacity and slots are the fused batch's (and the scratch block
        synced): the first chunk by (a)'s rule, its dropped copies per
        layer the meshless fused batch's, the streams by the margin rule,
        the collectives equal to the dry run's walks at (1, 2, 1);
    (c) one FDLoRA round (2 clients, K 1, 4 x T SFT rows a client) at
        (1, 1, 2) and (1, 2, 1) against the meshless round: bf16 at
        the phase's depth, the loss and the aux metric within
        ``MESH_MOE_LOSS_REL``, and each θ_s' leaf (its distance over its
        travel) within ``MESH_MOE_LEAF_TOL``, or within
        ``MESH_MOE_SPREAD`` times the same leaf's distance on the
        meshless round's plain path (``paged_backend`` "torch") where
        that is larger, but never past ``MESH_MOE_LEAF_CAP`` (a leaf the
        round left where it was reads 1): AdamW's first step is about
        lr·sign(g), and in bf16 routing flips move many small gradients
        across 0, so two correct paths' θ_s' can sit farther apart than
        0.25; fp32 at one layer, the loss within ``MESH_MOE_LOSS_ULPS``
        ulps, the aux metric within ``MESH_MOE_AUX_ULPS`` and each leaf
        within ``MESH_MOE_FP32_LEAF`` of its travel.  The loss and aux
        metric are the round's own (its clients' mean cross entropy) and
        ``mesh_job.objective``'s evaluation at θ_s' on a client's first
        step batch, through the round's loss function: the cross entropy
        plus the aux term, the data ranks' shares summed, held as the
        loss (counted twice, the aux term is off by its whole value, not
        by ulps).  The bf16 rounds' collectives equal to the dry run's
        walk.

    Each rank's serving kernels launch in (a) and (b), the prefill and
    LoRA kernels on their tensor-core tiles, and the round's lora_matmul
    and flash_attention at the rank's shapes.  Returns the launches of
    each case on rank 0."""
    import gc

    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.lora import (adapter_specs, init_adapters,
                                       tree_leaves)
    from repro_torch.federated.mesh_job import Case, RoundJob, run, run_jobs
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.dryrun import dry_run
    from repro_torch.launch.serve import (ServeJob, build_engine, mesh_serve,
                                          ragged_requests, serve_runs)
    from repro_torch.serving.engine import ServeConfig
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    base_cfg = get_config(MESH_MOE_ARCH).with_overrides(lora_rank=16)
    reqs = ragged_requests(MESH_MOE_REQUESTS, MESH_MOE_TENANTS,
                           base_cfg.vocab_size, *MESH_MOE_PROMPTS, seed)
    span = max(len(r.prompt) for r in reqs) + MESH_MOE_NEW
    width = min(T, span - 1)
    card = torch.cuda.get_device_properties(device).total_memory
    layers = MESH_MOE_LAYERS
    cfg = base_cfg.with_overrides(n_layers=layers)
    dry_peaks = mesh_moe_peaks(cfg, span, T)
    require(2 * max(dry_peaks.values()) <= PEAK_FIT * card,
            f"mesh_moe: two ranks' dry-run peaks {dry_peaks} pass "
            f"{PEAK_FIT:.0%} of the card")
    kw = dict(batch_size=MESH_MOE_REQUESTS, max_new_tokens=MESH_MOE_NEW,
              prefill_chunk=T, block_size=16, paged_backend="cuda")
    info = {"phase": "mesh_moe", "arch": MESH_MOE_ARCH, "n_layers": layers,
            "requests": len(reqs),
            "prompt_lens": [len(r.prompt) for r in reqs],
            "new_tokens": MESH_MOE_NEW, "prefill_chunk": width,
            "tenants": MESH_MOE_TENANTS, "lora_rank": 16}
    emit({**info, "run": "depth", "card_bytes": card,
          "dry_run_peak_bytes_per_rank_at_data_2": dry_peaks,
          "two_ranks_over_card": 2 * max(dry_peaks.values()) / card})
    # -- the meshless engine and rounds, here, then freed ---------------------
    t_ref = time.perf_counter()
    eng = build_engine(cfg, MESH_MOE_TENANTS, device, seed)
    ref = mesh_lib.to_cpu(serve_runs(eng, ServeJob(
        cfg, reqs, [("ref1", None, kw), ("ref2", None,
                                         dict(kw, num_shards=2))],
        tenants=MESH_MOE_TENANTS, seed=seed, device=str(device))))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    rbase = dict(clients=2, inner_steps=1, rows=MESH_MOE_ROWS, seq=T,
                 rounds=1, seed=seed, device=str(device))
    cfg1 = cfg.with_overrides(n_layers=1, dtype="float32",
                              param_dtype="float32")
    round_ref = {}
    for tag, c in (("bf16", cfg), ("fp32", cfg1),
                   ("plain", cfg.with_overrides(paged_backend="torch"))):
        r = run(RoundJob(c, [Case(None, sync=True)], **rbase))[0]
        round_ref[tag] = mesh_lib.to_cpu(
            {k: r[k] for k in ("theta", "loss", "aux_loss", "objective",
                               "seconds", "launches")})
        del r
        gc.collect()
        torch.cuda.empty_cache()
    meshless_s = time.perf_counter() - t_ref
    # -- (a)-(c): two ranks on this card --------------------------------------
    t0 = time.perf_counter()
    rounds = [(c, m) for c in ("bf16", "fp32") for m in ((1, 1, 2),
                                                        (1, 2, 1))]
    job = dict(tenants=MESH_MOE_TENANTS, seed=seed, device=str(device))
    tasks = [(mesh_serve, (ServeJob(cfg, reqs, [("a", (1, 1, 2), kw)],
                                    first_chunk=("a",), **job),)),
             (mesh_serve, (ServeJob(cfg, reqs, [("b", (1, 2, 1),
                                                 dict(kw, num_shards=2))],
                                    first_chunk=("b",), **job),)),
             (run_jobs, ([RoundJob(cfg if c == "bf16" else cfg1,
                                   [Case(1, data=m[1], model=m[2],
                                         sync=True)], **rbase)
                          for c, m in rounds],))]
    ranks = mesh_lib.spawn(mesh_lib.run_each, 2, tasks, device=device)
    spawn_s = time.perf_counter() - t0
    eng = build_engine(cfg, MESH_MOE_TENANTS, device, seed)
    counts = {}
    for case, key in (("a", 0), ("b", 1)):
        for rk in ranks:
            r = rk[key][case]
            for name in ("paged_attention", "paged_prefill_attention",
                         "batched_lora_matmul"):
                require(r["launches"][name] > 0,
                        f"mesh moe ({case}) rank {r['coord']}: {name} "
                        "never launched")
            for name in ("paged_prefill_attention", "batched_lora_matmul"):
                require_mma_tile(r["tiles"], name,
                                 f"mesh moe ({case}) rank {r['coord']}")
        counts[case] = {n: ranks[0][key][case]["launches"][n]
                        for n in kernels.SERVING}
    # -- (a) --------------------------------------------------------------------
    ra = sorted((rk[0]["a"] for rk in ranks),
                key=lambda r: r["coord"]["model"])
    recs = [r["first_chunk_routing"] for r in ra]
    same_ids = all(torch.equal(x, y) for x, y in zip(recs[0]["ids"],
                                                     recs[1]["ids"]))
    require(same_ids and len(recs[0]["ids"]) == layers,
            "mesh moe (a): the two ranks route differently")
    got_a = torch.cat([r["first_chunk"][0] for r in ra], -1)
    err_a, top_a, flips_a, dropped_a, gap_a, free_a = mesh_moe_chunk(
        eng, reqs, ServeConfig(**kw), recs[:1], got_a, "mesh moe (a)")
    require(ra[0]["streams"] == ra[1]["streams"],
            "mesh moe (a): the two ranks' streams differ")
    matched_a = streams_by_margin(eng, reqs, ServeConfig(**kw),
                                  ra[0]["streams"], ref["ref1"]["streams"],
                                  free_a, "mesh moe (a)")
    walk_a, dec_a = _stream_walks(cfg, (1, 1, 2), ra[0]["stats"],
                                  MESH_MOE_REQUESTS, width, span)
    for r in ra:
        require(_by_axis(r["collectives"]) == walk_a,
                f"mesh moe (a) rank {r['coord']}: collectives "
                f"{_by_axis(r['collectives'])}, the dry run's {walk_a}")
    E_rank = cfg.n_experts // 2
    expert_bytes = (layers * E_rank * 3 * cfg.d_model
                    * cfg.resolved_d_ff_moe * 2)
    summary_a = _serve_summary(ra[0], ref["ref1"])
    emit({**info, "run": "a", "world": 2, "backend": "gloo",
          "mesh": {"pod": 1, "data": 1, "model": 2},
          "heads_per_rank": cfg.n_heads // 2,
          "kv_heads_per_rank": cfg.n_kv_heads // 2,
          "experts_per_rank": E_rank,
          "vocab_columns_per_rank": cfg.vocab_size // 2,
          "routing_bitwise_equal_across_ranks": same_ids,
          "first_chunk_max_abs_err": err_a, "max_abs_logit": top_a,
          "first_chunk_rel_err": err_a / top_a, "rel_bound": MESH_MOE_REL,
          "unpinned_first_chunk_max_abs_err": free_a,
          "flips_by_layer": flips_a, "flip_worst_gap_by_layer": gap_a,
          "dropped_copies_by_layer": dropped_a,
          "streams_bitwise_meshless": ra[0]["streams"]
          == ref["ref1"]["streams"], "stream_prefix_matched": matched_a,
          **summary_a,
          "expert_read_bytes_per_step_per_rank": expert_bytes,
          "expert_read_bound_tok_per_s": (MESH_MOE_REQUESTS
                                          / (expert_bytes / 3.35e12)),
          "prefill_dispatches": ra[0]["stats"]["prefill_dispatches"],
          "decode_steps": ra[0]["stats"]["decode_steps"],
          "collectives": _collective_summary(ra[0]["collectives"]),
          "host_ms_note": GLOO_NOTE,
          "peak_bytes_per_rank": [r["peak_bytes"] for r in ra],
          "dry_run_decode_peak_bytes": dec_a["memory"]["peak_bytes"],
          "launches": [{k: r["launches"][k] for k in kernels.SERVING}
                       for r in ra],
          "meshless_s": meshless_s, "spawn_s": spawn_s})
    # -- (b) --------------------------------------------------------------------
    rb = sorted((rk[1]["b"] for rk in ranks),
                key=lambda r: r["coord"]["data"])
    recs = [r["first_chunk_routing"] for r in rb]
    got_b = torch.cat([r["first_chunk"][0] for r in rb], 0)
    err_b, top_b, flips_b, dropped_b, gap_b, free_b = mesh_moe_chunk(
        eng, reqs, ServeConfig(**kw), recs, got_b, "mesh moe (b)")
    require(rb[0]["streams"] == rb[1]["streams"],
            "mesh moe (b): the two ranks' streams differ")
    want_b = ref["ref2"]["streams"]
    matched_b = streams_by_margin(eng, reqs, ServeConfig(**kw),
                                  rb[0]["streams"], want_b, free_b,
                                  "mesh moe (b)")
    walk_b, dec_b = _stream_walks(cfg, (1, 2, 1), rb[0]["stats"],
                                  MESH_MOE_REQUESTS, width, span)
    for r in rb:
        require(_by_axis(r["collectives"]) == walk_b,
                f"mesh moe (b) rank {r['coord']}: collectives "
                f"{_by_axis(r['collectives'])}, the dry run's {walk_b}")
    emit({**info, "run": "b", "world": 2, "backend": "gloo",
          "mesh": {"pod": 1, "data": 2, "model": 1}, "num_shards": 2,
          "slots_per_rank": MESH_MOE_REQUESTS // 2,
          "first_chunk_max_abs_err": err_b, "max_abs_logit": top_b,
          "first_chunk_rel_err": err_b / top_b,
          "unpinned_first_chunk_max_abs_err": free_b,
          "flips_by_layer": flips_b, "flip_worst_gap_by_layer": gap_b,
          "dropped_copies_by_layer": dropped_b,
          "streams_bitwise_meshless": rb[0]["streams"] == want_b,
          "stream_prefix_matched": matched_b,
          **_serve_summary(rb[0], ref["ref2"]),
          "prefill_dispatches": rb[0]["stats"]["prefill_dispatches"],
          "decode_steps": rb[0]["stats"]["decode_steps"],
          "collectives": _collective_summary(rb[0]["collectives"]),
          "host_ms_note": GLOO_NOTE,
          "peak_bytes_per_rank": [r["peak_bytes"] for r in rb],
          "dry_run_decode_peak_bytes": dec_b["memory"]["peak_bytes"],
          "launches": [{k: r["launches"][k] for k in kernels.SERVING}
                       for r in rb]})
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # -- (c) --------------------------------------------------------------------
    def off(theta, want, start):
        """Each leaf's distance from ``want`` over its travel."""
        return {k: float(torch.linalg.vector_norm(g - want[k])
                         / torch.linalg.vector_norm(want[k] - start[k]))
                for k, g in tree_leaves(theta)}
    start = dict(tree_leaves(init_adapters(cfg, seed=seed + 120,
                                           device="cpu", b_std=0.02)))
    spread = off(round_ref["plain"]["theta"],
                 dict(tree_leaves(round_ref["bf16"]["theta"])), start)
    worst_plain = max(spread, key=spread.get)
    leaf_bound = {k: min(MESH_MOE_LEAF_CAP,
                         max(MESH_MOE_LEAF_TOL, MESH_MOE_SPREAD * v))
                  for k, v in spread.items()}
    for i, (tag, mesh) in enumerate(rounds):
        c = cfg if tag == "bf16" else cfg1
        rs = sorted((rk[2][i][0] for rk in ranks),
                    key=lambda r: (r["coord"]["data"], r["coord"]["model"]))
        want = round_ref[tag]
        if mesh[2] > 1:
            theta, differ = _gather_model(adapter_specs(c),
                                          [r["theta"] for r in rs])
            require(not differ, f"mesh moe (c, {tag}, {mesh}): replicated "
                    f"leaves differ across the ranks: {differ}")
        else:
            require(rs[0]["digest"] == rs[1]["digest"],
                    f"mesh moe (c, {tag}, {mesh}): the ranks' θ_s' differ")
            theta = rs[0]["theta"]
        travel = off(theta, dict(tree_leaves(want["theta"])), dict(
            tree_leaves(init_adapters(c, seed=seed + 120, device="cpu",
                                      b_std=0.02))))
        worst = max(travel, key=travel.get)
        loss, aux = rs[0]["loss"][0], rs[0]["aux_loss"]
        obj = rs[0]["objective"]
        require(all(r["loss"] == rs[0]["loss"] and r["aux_loss"] == aux
                    and r["objective"] == obj for r in rs),
                f"mesh moe (c, {tag}, {mesh}): the ranks' losses or aux "
                "metrics differ")
        line = {**info, "run": "c", "world": 2, "backend": "gloo",
                "activations": "bfloat16" if tag == "bf16" else "float32",
                "n_layers": c.n_layers,
                "mesh": dict(zip(("pod", "data", "model"), mesh)),
                "clients": 2, "inner_steps": 1, "rows": MESH_MOE_ROWS,
                "seq": T, "loss": loss, "meshless_loss": want["loss"][0],
                "aux_loss": aux, "meshless_aux_loss": want["aux_loss"],
                "objective": obj, "meshless_objective": want["objective"],
                "max_leaf_diff_over_travel": travel[worst],
                "worst_leaf": worst, "leaf_diff_over_travel_by_leaf": travel,
                "s_per_round": [r["seconds"] for r in rs],
                "meshless_s_per_round": want["seconds"],
                "collectives": _collective_summary(rs[0]["collectives"][0]),
                "host_ms_note": GLOO_NOTE,
                "peak_bytes_per_rank": [r["peak_bytes"] for r in rs],
                "launches": [{k: r["launches"][k]
                              for k in ("lora_matmul", "flash_attention")}
                             for r in rs]}
        if tag == "bf16":
            dry = dry_run(c.with_overrides(paged_backend="cuda"),
                          "fdlora_round", 2 * MESH_MOE_ROWS, T, mesh=mesh,
                          n_clients=2, K=1)
            line.update(loss_rel=abs(loss - want["loss"][0])
                        / abs(want["loss"][0]),
                        aux_rel=abs(aux - want["aux_loss"])
                        / abs(want["aux_loss"]),
                        objective_rel=abs(obj - want["objective"])
                        / abs(want["objective"]),
                        plain_path_worst_leaf=worst_plain,
                        plain_path_max_leaf_diff_over_travel=spread[
                            worst_plain],
                        plain_path_leaf_diff_over_travel_by_leaf=spread,
                        plain_path_loss=round_ref["plain"]["loss"][0],
                        plain_path_aux_loss=round_ref["plain"]["aux_loss"],
                        leaf_bound_by_leaf=leaf_bound,
                        worst_leaf_over_bound=max(
                            travel[k] / leaf_bound[k] for k in travel),
                        dry_run_peak_bytes=dry["memory"]["peak_bytes"])
            emit(line)
            require(max(line["loss_rel"], line["aux_rel"],
                        line["objective_rel"]) <= MESH_MOE_LOSS_REL,
                    f"mesh moe (c, bf16, {mesh}): loss {loss}, aux {aux} "
                    f"or objective {obj} over {MESH_MOE_LOSS_REL} off the "
                    f"meshless {want['loss'][0]}, {want['aux_loss']}, "
                    f"{want['objective']}")
            for k, v in travel.items():
                require(v <= leaf_bound[k],
                        f"mesh moe (c, bf16, {mesh}): {k} is {v} of its "
                        f"travel off, over {leaf_bound[k]}")
            for r in rs:
                require(_by_axis(r["collectives"][0])
                        == _by_axis(dry["collectives"]),
                        f"mesh moe (c, bf16, {mesh}) rank {r['coord']}: "
                        "collectives differ from the dry run's walk")
                for name in ("lora_matmul", "flash_attention"):
                    require_mma_tile(r["tiles"], name, f"mesh moe (c, "
                                     f"{mesh}) rank {r['coord']}")
        else:
            line.update(loss_ulps=_ulps(loss, want["loss"][0]),
                        aux_ulps=_ulps(aux, want["aux_loss"]),
                        objective_ulps=_ulps(obj, want["objective"]))
            emit(line)
            require(line["loss_ulps"] <= MESH_MOE_LOSS_ULPS
                    and line["objective_ulps"] <= MESH_MOE_LOSS_ULPS,
                    f"mesh moe (c, fp32, {mesh}): loss {line['loss_ulps']} "
                    f"or objective {line['objective_ulps']} ulps off")
            require(line["aux_ulps"] <= MESH_MOE_AUX_ULPS,
                    f"mesh moe (c, fp32, {mesh}): aux {line['aux_ulps']} "
                    "ulps off")
            require(travel[worst] <= MESH_MOE_FP32_LEAF,
                    f"mesh moe (c, fp32, {mesh}): {worst} is "
                    f"{travel[worst]} of its travel off")
        counts[f"c_{tag}_{'x'.join(map(str, mesh))}"] = rs[0]["launches"]
    emit({**info, "run": "seconds", "phase_s": time.perf_counter() - t_phase,
          "meshless_s": meshless_s, "spawn_s": spawn_s})
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def mesh_moe_kernels(gen, device, reps, dec_lengths, pre_lengths, T):
    """Phase mesh_moe's per-rank shapes at "model" 2 on dbrx-132b: 24 of
    48 query heads over 4 of 8 kv heads (G 6) in decode and prefill at the
    serve cell's lengths; batched LoRA at each rank's attention
    projections (wq 6144 -> 3072, wk/wv 6144 -> 512, wo 3072 -> 6144) at
    a prefill chunk's 8 x T rows and a decode step's 8, over the phase's
    4 tenants; the round's lora_matmul at a client's 4 x T rows and flash
    attention at B 4, H 24 over Kv 4, S T."""
    path = {"path": "mesh_moe", "model_axis": 2, "arch": MESH_MOE_ARCH}
    emit({**check_decode(gen, device, dec_lengths, 6, False, reps, H=24),
          **path})
    emit({**check_prefill(gen, device, pre_lengths, T, 6, False, reps,
                          H=24), **path})
    B = MESH_MOE_REQUESTS
    shapes = ((6144, 3072), (6144, 512), (3072, 6144))
    for K, N in shapes:
        for M in (B * T, B):
            emit({**check_lora(gen, device, M, K, N, MESH_MOE_TENANTS, 16,
                               "f32_bank", reps), **path})
    for K, N in shapes:
        emit({**check_single_lora(gen, device, MESH_MOE_ROWS * T, K, N, 16,
                                  reps), **path, "step": "round"})
    emit({**check_flash(gen, device, MESH_MOE_ROWS, 24, 4, T, T, 128, 0,
                        reps), **path, "step": "round"})


MESH_SSM_FAMILY = (("mamba2-2.7b", 8), ("jamba-v0.1-52b", 8))  # 8 of 64;
#                             8 of 32, one period (its pattern's least)
MESH_SSM_TENANTS = 4
MESH_SSM_REQUESTS = 8       # 8 slots
MESH_SSM_PROMPTS = (128, 512)
MESH_SSM_NEW = 16
MESH_SSM_REL = 0.1          # first chunk, of the largest logit (bf16)
MESH_SSM_ROWS = 4           # a client's rows a step in the round
MESH_SSM_WALKERS = 4        # host processes walking the dry runs


def mesh_ssm_kernels(gen, device, reps, dec_lengths, pre_lengths, T):
    """Phase mesh_ssm's per-rank shapes at "model" 2: batched LoRA at
    each rank's in_proj shard (mamba2-2.7b 2560 -> 5416: 2560 z + 2560 x
    + 128 B + 128 C + 40 dt; jamba 4096 -> 8288: 4096 + 4096 + 16 + 16 +
    64) at a prefill chunk's 8 x T rows and a decode step's 8 over the
    phase's 4 tenants, lora_matmul at both at a round client's 4 x T
    rows; jamba's 16 of 32 query heads over 4 of 8 kv heads (G 4) in
    decode and prefill at the serve cell's lengths under its 4,096-token
    window, and flash attention at B 4, H 16, Kv 4, S T."""
    path = {"path": "mesh_ssm", "model_axis": 2}
    shapes = (("mamba2-2.7b", 2560, 5416), ("jamba-v0.1-52b", 4096, 8288))
    for arch, K, N in shapes:
        for M in (MESH_SSM_REQUESTS * T, MESH_SSM_REQUESTS):
            emit({**check_lora(gen, device, M, K, N, MESH_SSM_TENANTS, 16,
                               "f32_bank", reps, tail=N % 256 != 0),
                  **path, "arch": arch})
        emit({**check_single_lora(gen, device, MESH_SSM_ROWS * T, K, N, 16,
                                  reps), **path, "arch": arch,
              "step": "round"})
    jamba = {**path, "arch": "jamba-v0.1-52b"}
    emit({**check_decode(gen, device, dec_lengths, 4, False, reps, H=16,
                         window=4096), **jamba})
    emit({**check_prefill(gen, device, pre_lengths, T, 4, False, reps,
                          H=16, window=4096), **jamba})
    emit({**check_flash(gen, device, MESH_SSM_ROWS, 16, 4, T, T, 128, 4096,
                        reps), **jamba, "step": "round"})


def _dry_walk(cfg, step, B, S, mesh, kw):
    """One dry-run walk of ``cfg`` on the card's path at ``mesh``: its
    peak bytes and collectives (run in a spawned host process)."""
    from repro_torch.launch.dryrun import dry_run
    res = dry_run(cfg.with_overrides(paged_backend="cuda"), step, B, S,
                  mesh=mesh, **kw)
    return {"peak_bytes": res["memory"]["peak_bytes"],
            "collectives": res["collectives"]}


def mesh_ssm_walks(cfgs, span, width, T):
    """The phase's dry-run walks, in ``MESH_SSM_WALKERS`` spawned host
    processes while the card works: per arch at (1, 1, 2) a prefill
    chunk (8 x ``width``), a decode step (8 slots, ``span``) and the
    round (2 clients, K 1, 4 x T rows each); mamba2-2.7b's prefill and
    decode at (1, 2, 1) too.  Returns (pool, {(arch, mesh, step):
    future})."""
    import concurrent.futures
    import multiprocessing
    jobs = {}
    for arch, cfg in cfgs.items():
        meshes = [(1, 1, 2)] + ([(1, 2, 1)] if arch == MESH_SSM_FAMILY[0][0]
                                else [])
        for mesh in meshes:
            jobs[arch, mesh, "prefill"] = (cfg, "prefill", MESH_SSM_REQUESTS,
                                           width, mesh, {})
            jobs[arch, mesh, "decode"] = (cfg, "decode", MESH_SSM_REQUESTS,
                                          span, mesh, {})
        jobs[arch, (1, 1, 2), "fdlora_round"] = (
            cfg, "fdlora_round", 2 * MESH_SSM_ROWS, T, (1, 1, 2),
            {"n_clients": 2, "K": 1})
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=MESH_SSM_WALKERS,
        mp_context=multiprocessing.get_context("spawn"))
    return pool, {k: pool.submit(_dry_walk, *job) for k, job in jobs.items()}


def mesh_ssm_serve(job):
    """``launch/serve.mesh_serve`` under a :class:`ResetLog`: each run's
    result also holds every slot reset this rank made (its local rows,
    the warm-up's included) and whether each read zero state after it."""
    from repro_torch.launch.serve import mesh_serve
    with ResetLog() as log:
        out = mesh_serve(job)
    for res in out.values():
        res["resets"] = {"rows": list(log.slots), "zero": log.zeroed()}
    return out


def _walked(dry, st):
    """A stream's collectives as the walks of one prefill dispatch and one
    decode step price them ({(axis, bytes): count})."""
    want = {}
    for walk, n in ((dry["prefill"], st["prefill_dispatches"]),
                    (dry["decode"], st["decode_steps"])):
        for k, v in _by_axis(walk["collectives"]).items():
            want[k] = want.get(k, 0) + n * v
    return want


def mesh_ssm_phase(device, seed: int, T: int = 256):
    """Mamba layers over a torch.distributed mesh: mamba2-2.7b (8 of 64
    layers) and jamba-v0.1-52b (8 of 32, one period) at full width,
    bf16, random weights from ``seed``, ``MESH_SSM_TENANTS`` tenants'
    rank-16 fused adapters (the in_proj/out_proj pairs and jamba's router
    pair), 8 requests (prompts 128-512 tokens, 16 new, chunk T) through
    ``MultiTenantEngine.generate`` on "cuda".  Both ranks' dry-run peaks
    at each mesh must fit in 90% of the card.  The meshless engines and
    rounds run here and are freed; then one spawn of two ranks on this
    card (gloo; ``launch/mesh.run_each``):

    (a) mesh (1, 1, 2), both archs: each rank half the SSM heads (40 of
        80; jamba 64 of 128, and 16 of 32 attention heads over 4 of 8 kv
        heads, 8 of 16 experts), its heads' columns of every in_proj and
        conv segment (B and C whole at one group), half the vocabulary
        and the bank's sharded factors, the shard drawn as it is cut:
        the first chunk's logits, gathered, against the meshless chunk
        within ``MESH_SSM_REL`` of the largest logit (jamba with each
        layer's expert ids pinned to the ranks', ``mesh_moe_chunk``), the
        streams by the margin rule, the collectives equal to the dry
        run's prefill and decode walks at (1, 1, 2), each rank's peak
        beside the dry run's, decode tok/s beside the meshless run's;
    (b) mesh (1, 2, 1), ``num_shards`` 2, mamba2-2.7b: each rank the
        whole base and the state of its 4 slots: the first chunk by
        (a)'s rule, the streams against the meshless 2-shard run's by
        the margin rule, and every slot reset on a rank reading zero
        state there right after it, its row one of the rank's own;
    (c) one FDLoRA round (2 clients, K 1, 4 x T SFT rows a client) at
        model 2 against the meshless round: jamba and mamba2-2.7b in bf16
        at the phase's depth by ``mesh_moe_phase`` (c)'s rules (loss, aux
        and objective within 2%, each θ_s' leaf within 25% of its travel
        or twice the plain path's distance, at most 75%, the collectives
        equal to the walk), mamba2-2.7b in fp32 at one layer (the loss
        within 16 ulps, each leaf within 1e-3 of its travel); in_proj's
        B columns every rank holds (B and C) bitwise equal on the ranks.

    Returns the launches of each case on rank 0."""
    import gc

    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.lora import (adapter_specs, init_adapters,
                                       tree_leaves)
    from repro_torch.federated.mesh_job import Case, RoundJob, run, run_jobs
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.serve import (ServeJob, build_engine,
                                          ragged_requests, serve_runs)
    from repro_torch.models import tensor_parallel as tpl
    from repro_torch.serving.engine import ServeConfig
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    mamba, jamba = (a for a, _ in MESH_SSM_FAMILY)
    cfgs = {a: get_config(a).with_overrides(n_layers=n, lora_rank=16)
            for a, n in MESH_SSM_FAMILY}
    reqs = {a: ragged_requests(MESH_SSM_REQUESTS, MESH_SSM_TENANTS,
                               c.vocab_size, *MESH_SSM_PROMPTS, seed)
            for a, c in cfgs.items()}
    span = max(len(r.prompt) for r in reqs[mamba]) + MESH_SSM_NEW
    width = min(T, span - 1)
    card = torch.cuda.get_device_properties(device).total_memory
    pool, walks = mesh_ssm_walks(cfgs, span, width, T)
    kw = dict(batch_size=MESH_SSM_REQUESTS, max_new_tokens=MESH_SSM_NEW,
              prefill_chunk=T, block_size=16, paged_backend="cuda")
    sc = ServeConfig(**kw)
    info = {"phase": "mesh_ssm", "requests": MESH_SSM_REQUESTS,
            "prompt_lens": [len(r.prompt) for r in reqs[mamba]],
            "new_tokens": MESH_SSM_NEW, "prefill_chunk": width,
            "tenants": MESH_SSM_TENANTS, "lora_rank": 16}
    # -- the meshless engines and rounds, here, then freed -------------------
    t_ref = time.perf_counter()
    ref = {}
    for arch, cfg in cfgs.items():
        runs = [("ref1", None, kw)] + ([("ref2", None,
                                         dict(kw, num_shards=2))]
                                       if arch == mamba else [])
        eng = build_engine(cfg, MESH_SSM_TENANTS, device, seed)
        ref[arch] = mesh_lib.to_cpu(serve_runs(eng, ServeJob(
            cfg, reqs[arch], runs, tenants=MESH_SSM_TENANTS, seed=seed,
            device=str(device))))
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    rbase = dict(clients=2, inner_steps=1, rows=MESH_SSM_ROWS, seq=T,
                 rounds=1, seed=seed, device=str(device))
    rounds = {("bf16", jamba): cfgs[jamba], ("bf16", mamba): cfgs[mamba],
              ("fp32", mamba): cfgs[mamba].with_overrides(
                  n_layers=1, dtype="float32", param_dtype="float32")}
    plain = {("plain", a): cfgs[a].with_overrides(paged_backend="torch")
             for a in cfgs}
    round_ref = {}
    for key, c in {**rounds, **plain}.items():
        r = run(RoundJob(c, [Case(None, sync=True)], **rbase))[0]
        round_ref[key] = mesh_lib.to_cpu(
            {k: r.get(k) for k in ("theta", "loss", "aux_loss", "objective",
                                   "seconds", "launches")})
        del r
        gc.collect()
        torch.cuda.empty_cache()
    meshless_s = time.perf_counter() - t_ref
    dry = {k: f.result() for k, f in walks.items()}
    pool.shutdown()
    peaks = {f"{a} {'x'.join(map(str, m))} {s}": v["peak_bytes"]
             for (a, m, s), v in dry.items()}
    emit({**info, "run": "depth", "card_bytes": card,
          "n_layers": {a: c.n_layers for a, c in cfgs.items()},
          "dry_run_peak_bytes_per_rank": peaks,
          "two_ranks_over_card": 2 * max(peaks.values()) / card})
    require(2 * max(peaks.values()) <= PEAK_FIT * card,
            f"mesh_ssm: two ranks' dry-run peaks {peaks} pass "
            f"{PEAK_FIT:.0%} of the card")
    # -- (a)-(c): two ranks on this card --------------------------------------
    t0 = time.perf_counter()
    job = dict(tenants=MESH_SSM_TENANTS, seed=seed, device=str(device))
    tasks = [(mesh_ssm_serve, (ServeJob(cfgs[a], reqs[a],
                                        [("a", (1, 1, 2), kw)],
                                        first_chunk=("a",), **job),))
             for a in (mamba, jamba)]
    tasks.append((mesh_ssm_serve, (ServeJob(
        cfgs[mamba], reqs[mamba], [("b", (1, 2, 1), dict(kw, num_shards=2))],
        first_chunk=("b",), **job),)))
    tasks.append((run_jobs, ([RoundJob(c, [Case(1, model=2, sync=True)],
                                       **rbase)
                              for c in rounds.values()],)))
    ranks = mesh_lib.spawn(mesh_lib.run_each, 2, tasks, device=device)
    spawn_s = time.perf_counter() - t0
    counts = {}
    # -- (a) --------------------------------------------------------------------
    for i, arch in enumerate((mamba, jamba)):
        cfg, what = cfgs[arch], f"mesh ssm (a, {arch})"
        ra = sorted((rk[i]["a"] for rk in ranks),
                    key=lambda r: r["coord"]["model"])
        needs = (("batched_lora_matmul",) if arch == mamba
                 else ("paged_attention", "paged_prefill_attention",
                       "batched_lora_matmul"))
        for r in ra:
            for name in needs:
                require(r["launches"][name] > 0,
                        f"{what} rank {r['coord']}: {name} never launched")
            for name in needs:
                if name != "paged_attention":
                    require_mma_tile(r["tiles"], name, f"{what} rank "
                                     f"{r['coord']}")
            require(all(r["resets"]["zero"]), f"{what} rank {r['coord']}: "
                    "a reset slot's state is not zero")
        require(ra[0]["streams"] == ra[1]["streams"],
                f"{what}: the two ranks' streams differ")
        got = torch.cat([r["first_chunk"][0] for r in ra], -1)
        eng = build_engine(cfg, MESH_SSM_TENANTS, device, seed)
        extra = {}
        if cfg.has_moe():
            recs = [r["first_chunk_routing"] for r in ra]
            require(all(torch.equal(x, y) for x, y in
                        zip(recs[0]["ids"], recs[1]["ids"])),
                    f"{what}: the two ranks route differently")
            err, top, flips, dropped, gap, free = mesh_moe_chunk(
                eng, reqs[arch], sc, recs[:1], got, what)
            extra = {"routing_bitwise_equal_across_ranks": True,
                     "flips_by_layer": flips, "flip_worst_gap_by_layer": gap,
                     "dropped_copies_by_layer": dropped,
                     "unpinned_first_chunk_max_abs_err": free}
        else:
            want, n_new = first_chunk_logits(eng, reqs[arch], sc, "cuda")
            err, top = _first_chunk_err(got.float(), want.float().cpu(),
                                        n_new)
            free = err
            require(err <= MESH_SSM_REL * top, f"{what}: first-chunk error "
                    f"{err} over {MESH_SSM_REL} x the largest logit {top}")
        matched = streams_by_margin(eng, reqs[arch], sc, ra[0]["streams"],
                                    ref[arch]["ref1"]["streams"], free, what)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        walk = {s: dry[arch, (1, 1, 2), s] for s in ("prefill", "decode")}
        want_c = _walked(walk, ra[0]["stats"])
        for r in ra:
            require(_by_axis(r["collectives"]) == want_c,
                    f"{what} rank {r['coord']}: collectives "
                    f"{_by_axis(r['collectives'])}, the dry run's {want_c}")
        emit({**info, **extra, "run": "a", "arch": arch,
              "n_layers": cfg.n_layers, "world": 2, "backend": "gloo",
              "mesh": {"pod": 1, "data": 1, "model": 2},
              "ssm_heads_per_rank": cfg.ssm_n_heads // 2,
              "in_proj_columns_per_rank": (
                  cfg.ssm_d_inner + 2 * cfg.ssm_n_groups * cfg.ssm_d_state
                  + cfg.ssm_n_heads // 2),
              **({"heads_per_rank": cfg.n_heads // 2,
                  "kv_heads_per_rank": cfg.n_kv_heads // 2,
                  "experts_per_rank": cfg.n_experts // 2}
                 if arch == jamba else {}),
              "vocab_columns_per_rank": cfg.vocab_size // 2,
              "first_chunk_max_abs_err": err, "max_abs_logit": top,
              "first_chunk_rel_err": err / top, "rel_bound": MESH_SSM_REL,
              "streams_bitwise_meshless": ra[0]["streams"]
              == ref[arch]["ref1"]["streams"],
              "stream_prefix_matched": matched,
              **_serve_summary(ra[0], ref[arch]["ref1"]),
              "prefill_dispatches": ra[0]["stats"]["prefill_dispatches"],
              "decode_steps": ra[0]["stats"]["decode_steps"],
              "collectives": _collective_summary(ra[0]["collectives"]),
              "host_ms_note": GLOO_NOTE,
              "peak_bytes_per_rank": [r["peak_bytes"] for r in ra],
              "dry_run_decode_peak_bytes": walk["decode"]["peak_bytes"],
              "dry_run_prefill_peak_bytes": walk["prefill"]["peak_bytes"],
              "slot_resets_per_rank": [len(r["resets"]["rows"]) for r in ra],
              "launches": [{k: r["launches"][k] for k in kernels.SERVING}
                           for r in ra],
              "meshless_s": meshless_s, "spawn_s": spawn_s})
        counts[f"a_{arch}"] = {n: ra[0]["launches"][n]
                               for n in kernels.SERVING}
    # -- (b) --------------------------------------------------------------------
    what = f"mesh ssm (b, {mamba})"
    rb = sorted((rk[2]["b"] for rk in ranks),
                key=lambda r: r["coord"]["data"])
    slots = MESH_SSM_REQUESTS // 2
    for r in rb:
        require(r["launches"]["batched_lora_matmul"] > 0,
                f"{what} rank {r['coord']}: batched_lora_matmul never "
                "launched")
        require_mma_tile(r["tiles"], "batched_lora_matmul",
                         f"{what} rank {r['coord']}")
        res = r["resets"]
        require(res["rows"] and all(res["zero"])
                and all(0 <= s < slots for s in res["rows"]),
                f"{what} rank {r['coord']}: slot resets {res} (rows of its "
                f"{slots} slots, each zero after it)")
    require(rb[0]["streams"] == rb[1]["streams"],
            f"{what}: the two ranks' streams differ")
    eng = build_engine(cfgs[mamba], MESH_SSM_TENANTS, device, seed)
    got_b = torch.cat([r["first_chunk"][0] for r in rb], 0)
    want_b, n_new = first_chunk_logits(eng, reqs[mamba], sc, "cuda")
    err_b, top_b = _first_chunk_err(got_b.float(), want_b.float().cpu(),
                                    n_new)
    require(err_b <= MESH_SSM_REL * top_b, f"{what}: first-chunk error "
            f"{err_b} over {MESH_SSM_REL} x the largest logit {top_b}")
    want_s = ref[mamba]["ref2"]["streams"]
    matched_b = streams_by_margin(eng, reqs[mamba], sc, rb[0]["streams"],
                                  want_s, err_b, what)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    walk = {s: dry[mamba, (1, 2, 1), s] for s in ("prefill", "decode")}
    want_c = _walked(walk, rb[0]["stats"])
    for r in rb:
        require(_by_axis(r["collectives"]) == want_c,
                f"{what} rank {r['coord']}: collectives "
                f"{_by_axis(r['collectives'])}, the dry run's {want_c}")
    emit({**info, "run": "b", "arch": mamba,
          "n_layers": cfgs[mamba].n_layers, "world": 2, "backend": "gloo",
          "mesh": {"pod": 1, "data": 2, "model": 1}, "num_shards": 2,
          "slots_per_rank": slots,
          "first_chunk_max_abs_err": err_b, "max_abs_logit": top_b,
          "first_chunk_rel_err": err_b / top_b,
          "streams_bitwise_meshless": rb[0]["streams"] == want_s,
          "stream_prefix_matched": matched_b,
          "slot_resets_per_rank": [len(r["resets"]["rows"]) for r in rb],
          "slot_resets_zero": True,
          **_serve_summary(rb[0], ref[mamba]["ref2"]),
          "prefill_dispatches": rb[0]["stats"]["prefill_dispatches"],
          "decode_steps": rb[0]["stats"]["decode_steps"],
          "collectives": _collective_summary(rb[0]["collectives"]),
          "host_ms_note": GLOO_NOTE,
          "peak_bytes_per_rank": [r["peak_bytes"] for r in rb],
          "dry_run_decode_peak_bytes": walk["decode"]["peak_bytes"],
          "launches": [{k: r["launches"][k] for k in kernels.SERVING}
                       for r in rb]})
    counts["b"] = {n: rb[0]["launches"][n] for n in kernels.SERVING}
    # -- (c) --------------------------------------------------------------------
    def off(theta, want, start):
        """Each leaf's distance from ``want`` over its travel."""
        return {k: float(torch.linalg.vector_norm(g - want[k])
                         / torch.linalg.vector_norm(want[k] - start[k]))
                for k, g in tree_leaves(theta)}

    for i, ((tag, arch), c) in enumerate(rounds.items()):
        what = f"mesh ssm (c, {tag}, {arch})"
        rs = sorted((rk[3][i][0] for rk in ranks),
                    key=lambda r: r["coord"]["model"])
        want = round_ref[tag, arch]
        specs = adapter_specs(c)
        theta, differ = _gather_model(specs, [r["theta"] for r in rs])
        require(not differ, f"{what}: leaves or columns every rank holds "
                f"differ across the ranks: {differ}")
        start = dict(tree_leaves(init_adapters(c, seed=seed + 120,
                                               device="cpu", b_std=0.02)))
        travel = off(theta, dict(tree_leaves(want["theta"])), start)
        worst = max(travel, key=travel.get)
        loss = rs[0]["loss"][0]
        require(all(r["loss"] == rs[0]["loss"]
                    and r.get("aux_loss") == rs[0].get("aux_loss")
                    and r.get("objective") == rs[0].get("objective")
                    for r in rs),
                f"{what}: the ranks' losses differ")
        line = {**info, "run": "c", "arch": arch, "world": 2,
                "backend": "gloo",
                "activations": "bfloat16" if tag == "bf16" else "float32",
                "n_layers": c.n_layers,
                "mesh": {"pod": 1, "data": 1, "model": 2}, "clients": 2,
                "inner_steps": 1, "rows": MESH_SSM_ROWS, "seq": T,
                "loss": loss, "meshless_loss": want["loss"][0],
                "in_proj_b_leaves_with_whole_columns": sum(
                    isinstance(m, torch.Tensor) for _, m in tree_leaves(
                        tpl.replicated(specs, 2))),
                "max_leaf_diff_over_travel": travel[worst],
                "worst_leaf": worst,
                "s_per_round": [r["seconds"] for r in rs],
                "meshless_s_per_round": want["seconds"],
                "collectives": _collective_summary(rs[0]["collectives"][0]),
                "host_ms_note": GLOO_NOTE,
                "peak_bytes_per_rank": [r["peak_bytes"] for r in rs],
                "launches": [{k: r["launches"][k]
                              for k in ("lora_matmul", "flash_attention")}
                             for r in rs]}
        if c.has_moe():
            line.update(aux_loss=rs[0]["aux_loss"],
                        meshless_aux_loss=want["aux_loss"],
                        objective=rs[0]["objective"],
                        meshless_objective=want["objective"])
        if tag == "bf16":
            spread = off(round_ref["plain", arch]["theta"],
                         dict(tree_leaves(want["theta"])), start)
            bound = {k: min(MESH_MOE_LEAF_CAP,
                            max(MESH_MOE_LEAF_TOL, MESH_MOE_SPREAD * v))
                     for k, v in spread.items()}
            rel = {"loss_rel": abs(loss - want["loss"][0])
                   / abs(want["loss"][0])}
            if c.has_moe():
                rel.update(aux_rel=abs(rs[0]["aux_loss"] - want["aux_loss"])
                           / abs(want["aux_loss"]),
                           objective_rel=abs(rs[0]["objective"]
                                             - want["objective"])
                           / abs(want["objective"]))
            walk = dry[arch, (1, 1, 2), "fdlora_round"]
            line.update(rel, plain_path_max_leaf_diff_over_travel=max(
                spread.values()), worst_leaf_over_bound=max(
                travel[k] / bound[k] for k in travel),
                dry_run_peak_bytes=walk["peak_bytes"])
            emit(line)
            require(max(rel.values()) <= MESH_MOE_LOSS_REL,
                    f"{what}: {rel} over {MESH_MOE_LOSS_REL}")
            for k, v in travel.items():
                require(v <= bound[k], f"{what}: {k} is {v} of its travel "
                        f"off, over {bound[k]}")
            for r in rs:
                require(_by_axis(r["collectives"][0])
                        == _by_axis(walk["collectives"]),
                        f"{what} rank {r['coord']}: collectives differ from "
                        "the dry run's walk")
                require(r["launches"]["lora_matmul"] > 0,
                        f"{what} rank {r['coord']}: lora_matmul never "
                        "launched")
                require_mma_tile(r["tiles"], "lora_matmul",
                                 f"{what} rank {r['coord']}")
                if arch == jamba:
                    require_mma_tile(r["tiles"], "flash_attention",
                                     f"{what} rank {r['coord']}")
        else:
            line.update(loss_ulps=_ulps(loss, want["loss"][0]))
            emit(line)
            require(line["loss_ulps"] <= MESH_MOE_LOSS_ULPS,
                    f"{what}: loss {line['loss_ulps']} ulps off")
            require(travel[worst] <= MESH_MOE_FP32_LEAF,
                    f"{what}: {worst} is {travel[worst]} of its travel off")
        counts[f"c_{tag}_{arch}"] = rs[0]["launches"]
    emit({**info, "run": "seconds", "phase_s": time.perf_counter() - t_phase,
          "meshless_s": meshless_s, "spawn_s": spawn_s})
    gc.collect()
    torch.cuda.empty_cache()
    return counts


MESH_VLM_LAYERS = 4         # of internvl2-26b's 48: the script's time limit
MESH_VLM_TENANTS = 4
MESH_VLM_ROWS = 2           # a round client's rows: 256 patches + T tokens
MESH_WHISPER_TRAIN_ROWS = 8  # the train step's rows: 1,500 frames + T tokens
MESH_WHISPER_ROUND_ROWS = 2  # a round client's rows
MESH_VLM_WALKERS = 4        # host processes walking the dry runs


def mesh_vlm_encdec_kernels(gen, device, reps, T):
    """Phase mesh_vlm_encdec's per-rank shapes at "model" 2 that no
    earlier line holds: batched LoRA at internvl2-26b's w_gate/w_up shard
    (6144 -> 8192) and w_out shard (8192 -> 6144) at a prefill chunk's 8 x
    T rows and a decode step's 8 over the phase's 4 tenants, lora_matmul
    there at a round client's 2 x (256 + T) rows; lora_matmul at
    whisper-small's encoder shards (w_up 768 -> 1536, w_out 1536 -> 768,
    wq/wv 768 -> 384) at the train step's 8 x 1,500 rows, and non-causal
    flash attention at its 6 of 12 heads over the 1,500 frames: the
    encoder's 1500 x 1500 and the training cross-attention's T x 1500.
    internvl2-26b's attention at model 2 (24 query heads over 4 kv heads,
    head dim 128) is dbrx-132b's at model 2, held in mesh_moe_kernels."""
    from repro_torch.configs import get_config
    path = {"path": "mesh_vlm_encdec", "model_axis": 2}
    vlm = {**path, "arch": VLM_ARCH}
    P = get_config(VLM_ARCH).n_patch_tokens
    for K, N in ((6144, 8192), (8192, 6144)):
        for M in (MESH_SSM_REQUESTS * T, MESH_SSM_REQUESTS):
            emit({**check_lora(gen, device, M, K, N, MESH_VLM_TENANTS, 16,
                               "f32_bank", reps), **vlm})
        emit({**check_single_lora(gen, device, MESH_VLM_ROWS * (P + T), K,
                                  N, 16, reps), **vlm, "step": "round"})
    enc_cfg = get_config(ENCDEC_ARCH)
    enc = {**path, "arch": ENCDEC_ARCH, "step": "train"}
    F, hd = enc_cfg.encoder_seq_len, enc_cfg.resolved_head_dim
    H = enc_cfg.n_heads // 2
    for K, N in ((768, 1536), (1536, 768), (768, 384)):
        emit({**check_single_lora(gen, device, MESH_WHISPER_TRAIN_ROWS * F,
                                  K, N, enc_cfg.lora_rank, reps), **enc})
    for Sq in (F, T):
        emit({**check_flash(gen, device, MESH_WHISPER_TRAIN_ROWS, H, H, Sq,
                            F, hd, 0, reps, causal=False), **enc})


def whisper_mesh_inputs(cfg, seed: int, T: int, device):
    """whisper-small's inputs, the same on every rank and in the meshless
    run (seeded generators on the card): the train batch (SFT rows of T
    tokens and 1,500 unit-scale stub frames a row), its adapters, an Eq.
    7-fused rank-16 adapter, 8 rows of decode frames and first tokens."""
    import torch
    from repro_torch.core.dual_lora import merge
    from repro_torch.core.lora import init_adapters
    g = torch.Generator(device=device).manual_seed(seed + 11)
    F, d, V = cfg.encoder_seq_len, cfg.d_model, cfg.vocab_size
    batch = sft_batch(seed, MESH_WHISPER_TRAIN_ROWS, T, V, device)
    batch["enc_embeds"] = torch.randn((MESH_WHISPER_TRAIN_ROWS, F, d),
                                      generator=g, device=device)
    ad = init_adapters(cfg, seed=seed + 100, device=device, b_std=0.02)
    fused = merge(*(init_adapters(cfg, seed=seed + 20 + j, device=device,
                                  b_std=0.02) for j in (0, 1)), [0.6, 0.6])
    enc = torch.randn((ENCDEC_ROWS, F, d), generator=g, device=device)
    first = torch.randint(0, V, (ENCDEC_ROWS, 1), generator=g,
                          device=device, dtype=torch.int32)
    return batch, ad, fused, enc, first


def mesh_whisper(cfg, seed: int, T: int, device: str):
    """One rank's whisper-small at mesh (1, 1, 2) (a spawned rank runs
    it): its shard of the base, drawn as it is cut, and of the adapters;
    one train step's loss and gradient (the model group's sums as the
    train step takes them); then ``prefill_cross`` and ``ENCDEC_STEPS``
    greedy decode steps of the fused adapter (``whisper_decode``), each
    with its launches, tiles, collectives and peak memory.  Rank 1 keeps
    a digest of its decode logits, rank 0 the logits."""
    import dataclasses

    import torch
    from repro_torch import kernels
    from repro_torch.core.lora import adapter_specs
    from repro_torch.federated.distributed import local_shard
    from repro_torch.federated.mesh_job import digest
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import tensor_parallel as tpl
    from repro_torch.models.api import Model
    from repro_torch.training.train_step import (make_lora_loss_fn,
                                                 model_group_grads,
                                                 value_and_grad)
    dev = torch.device(device)
    mesh = mesh_lib.make_mesh(1, 1, 2, device=dev)
    tp = mesh_lib.model_group(mesh)
    model = Model(cfg, dev)
    params = model.init(seed, shard=(2, tp.rank))
    batch, ad, fused, enc, first = whisper_mesh_inputs(cfg, seed, T, dev)
    specs = adapter_specs(cfg)
    ad, fused = (local_shard(t, specs, mesh) for t in (ad, fused))

    def counters():
        torch.cuda.synchronize(dev)
        return {"launches": kernels.launch_counts(),
                "tiles": kernels.tile_counts(),
                "collectives": [dataclasses.asdict(c)
                                for c in mesh_lib.collectives()],
                "peak_bytes": torch.cuda.max_memory_allocated(dev)}

    def reset():
        torch.cuda.synchronize(dev)
        kernels.reset_launch_counts()
        mesh_lib.reset_collectives()
        torch.cuda.reset_peak_memory_stats(dev)

    reset()
    loss, _, grads = value_and_grad(make_lora_loss_fn(model, cfg, tp=tp))(
        ad, params, batch)
    (grads,), _ = model_group_grads([grads], tpl.replicated(specs, 2), tp)
    train = {"loss": float(loss), "grads": mesh_lib.to_cpu(grads),
             **counters()}
    del grads, batch
    reset()
    toks, logits, pre_s, dec_s, _ = whisper_decode(
        model, cfg, params, fused, enc, first, "cuda", mesh=mesh)
    cache = model.init_decode_cache(ENCDEC_ROWS, 1, tp=tp)
    decode = {"tokens": toks.cpu(), "prefill_s": pre_s, "decode_s": dec_s,
              "logits_digest": digest({"l": logits}),
              "cross_bytes": sum(cache[k].numel() * cache[k].element_size()
                                 for k in ("cross_k", "cross_v")),
              **counters()}
    if tp.rank == 0:
        decode["logits"] = logits.cpu()
    return {"coord": {"model": tp.rank}, "train": train, "decode": decode}


def mesh_vlm_walks(cfgs, span, width, T):
    """The phase's dry-run walks at (1, 1, 2), in ``MESH_VLM_WALKERS``
    spawned host processes while the card works: internvl2-26b's
    text-only prefill chunk (8 x ``width``; a VLM forward with no patch
    tokens, as the engine serves the VLM) and decode step (8 slots,
    ``span``), its round (2 clients, K 1, 2 rows of 256 patches + T
    tokens); whisper-small's train step (8 x (1,500 frames + T tokens)),
    decode step (8 rows, its ring of 2 x ``ENCDEC_STEPS``) and round (2
    clients, K 1, 2 rows).  Returns (pool, {(arch, step): future})."""
    import concurrent.futures
    import multiprocessing
    vlm, enc = cfgs[VLM_ARCH], cfgs[ENCDEC_ARCH]
    m = (1, 1, 2)
    rnd = {"n_clients": 2, "K": 1}
    jobs = {
        (VLM_ARCH, "prefill"): (vlm.with_overrides(n_patch_tokens=0),
                                "prefill", MESH_SSM_REQUESTS, width, m, {}),
        (VLM_ARCH, "decode"): (vlm, "decode", MESH_SSM_REQUESTS, span, m,
                               {}),
        (VLM_ARCH, "fdlora_round"): (vlm, "fdlora_round", 2 * MESH_VLM_ROWS,
                                     T, m, rnd),
        (ENCDEC_ARCH, "train"): (enc, "train", MESH_WHISPER_TRAIN_ROWS, T, m,
                                 {}),
        (ENCDEC_ARCH, "decode"): (enc, "decode", ENCDEC_ROWS,
                                  2 * ENCDEC_STEPS, m, {}),
        (ENCDEC_ARCH, "fdlora_round"): (enc, "fdlora_round",
                                        2 * MESH_WHISPER_ROUND_ROWS, T, m,
                                        rnd)}
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=MESH_VLM_WALKERS,
        mp_context=multiprocessing.get_context("spawn"))
    return pool, {k: pool.submit(_dry_walk, *job) for k, job in jobs.items()}


def mesh_vlm_serve(job):
    """``launch/serve.mesh_serve`` keeping the first chunk's whole logits
    on rank 0 only: every rank's digest of them."""
    from repro_torch.federated.mesh_job import digest
    from repro_torch.launch.serve import mesh_serve
    out = mesh_serve(job)
    for res in out.values():
        if "first_chunk" in res:
            logits, n_new = res["first_chunk"]
            res["first_chunk_digest"] = digest({"l": logits})
            if res["coord"]["model"] > 0:
                res["first_chunk"] = (None, n_new)
    return out


def mesh_round_check(what, rs, want, plain, cfg, seed, walk, info, T,
                     rows):
    """(b)'s and (c)'s rules for a round at model 2 (``rs``: each rank's
    result, ``want``: the meshless round's, ``plain``: the meshless
    round's on "torch", bf16 only): θ_s' gathered, each leaf every rank
    holds bitwise equal on the ranks; bf16 by mesh_moe (c)'s rules (the
    loss within 2%, each leaf within 25% of its travel or twice the plain
    path's distance, at most 75%; the collectives equal to the dry run's
    walk; lora_matmul and flash attention on their tensor-core tiles);
    fp32 the loss within 16 ulps and each leaf within 1e-3 of its
    travel.  Returns rank 0's launches."""
    import torch
    from repro_torch.core.lora import adapter_specs, init_adapters
    from repro_torch.core.lora import tree_leaves
    theta, differ = _gather_model(adapter_specs(cfg),
                                  [r["theta"] for r in rs])
    require(not differ, f"{what}: leaves every rank holds differ across the "
            f"ranks: {differ}")
    require(all(r["loss"] == rs[0]["loss"] for r in rs),
            f"{what}: the ranks' losses differ")
    start = dict(tree_leaves(init_adapters(cfg, seed=seed + 120,
                                           device="cpu", b_std=0.02)))
    ref = dict(tree_leaves(want["theta"]))

    def off(tree):
        out = {}
        for k, g in tree_leaves(tree):
            moved = torch.linalg.vector_norm(ref[k] - start[k])
            out[k] = (float(torch.linalg.vector_norm(g - ref[k]) / moved)
                      if moved > 0 else float((g - ref[k]).abs().max()))
        return out
    travel = off(theta)
    worst = max(travel, key=travel.get)
    loss = rs[0]["loss"][0]
    bf16 = plain is not None
    line = {**info, "arch": cfg.name, "world": 2, "backend": "gloo",
            "activations": "bfloat16" if bf16 else "float32",
            "n_layers": cfg.n_layers, "mesh": {"pod": 1, "data": 1,
                                               "model": 2},
            "clients": 2, "inner_steps": 1, "rows": rows, "seq": T,
            "loss": loss, "meshless_loss": want["loss"][0],
            "max_leaf_diff_over_travel": travel[worst], "worst_leaf": worst,
            "s_per_round": [r["seconds"] for r in rs],
            "meshless_s_per_round": want["seconds"],
            "collectives": _collective_summary(rs[0]["collectives"][0]),
            "host_ms_note": GLOO_NOTE,
            "peak_bytes_per_rank": [r["peak_bytes"] for r in rs],
            "launches": [{k: r["launches"][k]
                          for k in ("lora_matmul", "flash_attention")}
                         for r in rs]}
    if bf16:
        spread = off(plain["theta"])
        bound = {k: min(MESH_MOE_LEAF_CAP,
                        max(MESH_MOE_LEAF_TOL, MESH_MOE_SPREAD * v))
                 for k, v in spread.items()}
        rel = abs(loss - want["loss"][0]) / abs(want["loss"][0])
        line.update(loss_rel=rel, plain_path_max_leaf_diff_over_travel=max(
            spread.values()), worst_leaf_over_bound=max(
            travel[k] / bound[k] for k in travel),
            dry_run_peak_bytes=walk["peak_bytes"])
        emit(line)
        require(rel <= MESH_MOE_LOSS_REL, f"{what}: loss {rel} off")
        for k, v in travel.items():
            require(v <= bound[k], f"{what}: {k} is {v} of its travel off, "
                    f"over {bound[k]}")
        for r in rs:
            require(_by_axis(r["collectives"][0])
                    == _by_axis(walk["collectives"]),
                    f"{what} rank {r['coord']}: collectives differ from the "
                    "dry run's walk")
            for name in ("lora_matmul", "flash_attention"):
                require(r["launches"][name] > 0, f"{what} rank "
                        f"{r['coord']}: {name} never launched")
                require_mma_tile(r["tiles"], name, f"{what} rank "
                                 f"{r['coord']}")
    else:
        line.update(loss_ulps=_ulps(loss, want["loss"][0]))
        emit(line)
        require(line["loss_ulps"] <= MESH_MOE_LOSS_ULPS,
                f"{what}: loss {line['loss_ulps']} ulps off")
        require(travel[worst] <= MESH_MOE_FP32_LEAF,
                f"{what}: {worst} is {travel[worst]} of its travel off")
    return rs[0]["launches"]


def mesh_vlm_encdec_phase(device, seed: int, T: int = 256):
    """The VLM and the encoder-decoder over a torch.distributed mesh:
    internvl2-26b (``MESH_VLM_LAYERS`` of its 48 layers) and
    whisper-small (12 + 12 layers) at full width, bf16, random weights
    from ``seed``.  At mesh (1, 1, 2) each rank holds half the heads, kv
    heads and ff columns (internvl2: 24 of 48 heads over 4 of 8 kv heads,
    8,192 of 16,384 ff columns; whisper: 6 of 12 heads, 1,536 of 3,072)
    and the whole vocabulary, which 2 does not divide (92,553 and 51,865
    entries: ``embed`` and internvl2's ``lm_head`` whole on every rank,
    the logits whole, no collective over the vocabulary).  Both ranks'
    dry-run peaks must fit in 90% of the card.  The meshless runs go
    first, here, and are freed; then one spawn of two ranks on this card
    (gloo; ``launch/mesh.run_each``):

    (a) internvl2 serving at model 2: ``MESH_VLM_TENANTS`` tenants'
        rank-16 fused adapters, 8 text-only requests (prompts 128-512
        tokens, 16 new, chunk T): the first chunk's logits (bitwise equal
        on the ranks) within ``MESH_SSM_REL`` of the largest meshless
        logit, the streams by the margin rule, the collectives equal to
        the dry run's prefill and decode walks, each rank's peak beside
        the walks', decode tok/s beside meshless;
    (b) internvl2 rounds at model 2 (2 clients, K 1, 2 rows of 256 stub
        patches + T tokens a client): bf16 at the phase's depth, fp32 at
        one layer (``mesh_round_check``);
    (c) whisper-small at model 2: one train step of 8 x (1,500 frames + T
        tokens) against the meshless step (the loss within 2%, each
        gradient leaf within 25% of its norm: the ``train`` bounds of
        phase vlm_encdec), ``cross_attn.wv``'s gradient exactly 0 on both
        ranks, the collectives equal to the walk; rounds (bf16 at full
        depth, fp32 at 1 + 1 layers); ``prefill_cross`` and 32 greedy
        decode steps of 8 rows: the first step by the first-chunk rule,
        the streams by the margin rule (``decode_margin_rule``), ms a step
        beside meshless, each rank's cross K/V bytes half the meshless
        cache's, the collectives the encoder's sums and each step's the
        decode walk's.

    Returns the launches of each case on rank 0."""
    import gc

    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.lora import adapter_specs, tree_leaves
    from repro_torch.federated.mesh_job import Case, RoundJob, run, run_jobs
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.serve import (ServeJob, build_engine,
                                          ragged_requests, serve_runs)
    from repro_torch.models import tensor_parallel as tpl
    from repro_torch.models.api import Model
    from repro_torch.serving.engine import ServeConfig
    from repro_torch.training.train_step import lora_value_and_grad
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfgs = {VLM_ARCH: get_config(VLM_ARCH).with_overrides(
        n_layers=MESH_VLM_LAYERS, lora_rank=16),
        ENCDEC_ARCH: get_config(ENCDEC_ARCH)}
    vcfg, wcfg = cfgs[VLM_ARCH], cfgs[ENCDEC_ARCH]
    for c in cfgs.values():
        require(not tpl.vocab_split(c, 2), f"{c.name}: vocabulary "
                f"{c.vocab_size} splits over 2; the phase holds it whole")
    reqs = ragged_requests(MESH_SSM_REQUESTS, MESH_VLM_TENANTS,
                           vcfg.vocab_size, *MESH_SSM_PROMPTS, seed)
    span = max(len(r.prompt) for r in reqs) + MESH_SSM_NEW
    width = min(T, span - 1)
    card = torch.cuda.get_device_properties(device).total_memory
    pool, walks = mesh_vlm_walks(cfgs, span, width, T)
    kw = dict(batch_size=MESH_SSM_REQUESTS, max_new_tokens=MESH_SSM_NEW,
              prefill_chunk=T, block_size=16, paged_backend="cuda")
    sc = ServeConfig(**kw)
    info = {"phase": "mesh_vlm_encdec"}
    # -- the meshless runs, here, then freed -----------------------------------
    t_ref = time.perf_counter()
    eng = build_engine(vcfg, MESH_VLM_TENANTS, device, seed)
    serve_ref = mesh_lib.to_cpu(serve_runs(eng, ServeJob(
        vcfg, reqs, [("ref", None, kw)], tenants=MESH_VLM_TENANTS, seed=seed,
        device=str(device))))["ref"]
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    rbase = {VLM_ARCH: dict(clients=2, inner_steps=1, rows=MESH_VLM_ROWS,
                            seq=T, rounds=1, seed=seed, device=str(device)),
             ENCDEC_ARCH: dict(clients=2, inner_steps=1,
                               rows=MESH_WHISPER_ROUND_ROWS, seq=T, rounds=1,
                               seed=seed, device=str(device))}
    fp32 = dict(dtype="float32", param_dtype="float32")
    rounds = {("bf16", VLM_ARCH): vcfg,
              ("fp32", VLM_ARCH): vcfg.with_overrides(n_layers=1, **fp32),
              ("bf16", ENCDEC_ARCH): wcfg,
              ("fp32", ENCDEC_ARCH): wcfg.with_overrides(
                  n_layers=1, n_encoder_layers=1, **fp32)}
    plain = {("plain", a): c.with_overrides(paged_backend="torch")
             for a, c in cfgs.items()}
    round_ref = {}
    for key, c in {**rounds, **plain}.items():
        r = run(RoundJob(c, [Case(None, sync=True)], **rbase[key[1]]))[0]
        round_ref[key] = mesh_lib.to_cpu(
            {k: r.get(k) for k in ("theta", "loss", "seconds", "launches")})
        del r
        gc.collect()
        torch.cuda.empty_cache()
    wmodel = Model(wcfg, device)
    wparams = wmodel.init(seed)
    batch, ad, fused, enc, first = whisper_mesh_inputs(wcfg, seed, T, device)
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(device)
    wloss, _, wgrads = lora_value_and_grad(wmodel, wcfg, "cuda")(
        wparams, ad, batch)
    torch.cuda.synchronize(device)
    train_ref = {"loss": float(wloss), "grads": mesh_lib.to_cpu(wgrads),
                 "launches": kernels.launch_counts(),
                 "peak_bytes": torch.cuda.max_memory_allocated(device)}
    del wgrads, batch, ad
    tt, lt, pre_t, dec_t, _ = whisper_decode(wmodel, wcfg, wparams, fused,
                                             enc, first, "cuda")
    tt, lt = tt.cpu(), lt.cpu()
    cache = wmodel.init_decode_cache(ENCDEC_ROWS, 1)
    cross_bytes = sum(cache[k].numel() * cache[k].element_size()
                      for k in ("cross_k", "cross_v"))
    del wmodel, wparams, fused, enc, first, cache
    gc.collect()
    torch.cuda.empty_cache()
    meshless_s = time.perf_counter() - t_ref
    dry = {k: f.result() for k, f in walks.items()}
    pool.shutdown()
    peaks = {f"{a} {s}": v["peak_bytes"] for (a, s), v in dry.items()}
    emit({**info, "run": "depth", "card_bytes": card,
          "n_layers": {a: c.n_layers for a, c in cfgs.items()},
          "dry_run_peak_bytes_per_rank": peaks,
          "two_ranks_over_card": 2 * max(peaks.values()) / card})
    require(2 * max(peaks.values()) <= PEAK_FIT * card,
            f"mesh_vlm_encdec: two ranks' dry-run peaks {peaks} pass "
            f"{PEAK_FIT:.0%} of the card")
    # -- (a)-(c): two ranks on this card --------------------------------------
    t0 = time.perf_counter()
    tasks = [(mesh_vlm_serve, (ServeJob(vcfg, reqs, [("a", (1, 1, 2), kw)],
                                        tenants=MESH_VLM_TENANTS, seed=seed,
                                        device=str(device),
                                        first_chunk=("a",)),)),
             (run_jobs, ([RoundJob(c, [Case(1, model=2, sync=True)],
                                   **rbase[a]) for (_, a), c
                          in rounds.items()],)),
             (mesh_whisper, (wcfg, seed, T, str(device)))]
    ranks = mesh_lib.spawn(mesh_lib.run_each, 2, tasks, device=device)
    spawn_s = time.perf_counter() - t0
    counts = {}
    # -- (a) --------------------------------------------------------------------
    what = f"mesh vlm_encdec (a, {VLM_ARCH})"
    ra = sorted((rk[0]["a"] for rk in ranks),
                key=lambda r: r["coord"]["model"])
    for r in ra:
        for name in ("paged_attention", "paged_prefill_attention",
                     "batched_lora_matmul"):
            require(r["launches"][name] > 0,
                    f"{what} rank {r['coord']}: {name} never launched")
            if name != "paged_attention":
                require_mma_tile(r["tiles"], name,
                                 f"{what} rank {r['coord']}")
    require(ra[0]["streams"] == ra[1]["streams"],
            f"{what}: the two ranks' streams differ")
    require(ra[0]["first_chunk_digest"] == ra[1]["first_chunk_digest"],
            f"{what}: the ranks' whole first-chunk logits differ")
    got, _ = ra[0]["first_chunk"]
    require(got.shape[-1] == vcfg.vocab_size,
            f"{what}: first-chunk logits {tuple(got.shape)}, not the whole "
            "vocabulary")
    eng = build_engine(vcfg, MESH_VLM_TENANTS, device, seed)
    want, n_new = first_chunk_logits(eng, reqs, sc, "cuda")
    err, top = _first_chunk_err(got.float(), want.float().cpu(), n_new)
    del want
    require(err <= MESH_SSM_REL * top, f"{what}: first-chunk error {err} "
            f"over {MESH_SSM_REL} x the largest logit {top}")
    matched = streams_by_margin(eng, reqs, sc, ra[0]["streams"],
                                serve_ref["streams"], err, what)
    del eng, got
    gc.collect()
    torch.cuda.empty_cache()
    walk = {s: dry[VLM_ARCH, s] for s in ("prefill", "decode")}
    want_c = _walked(walk, ra[0]["stats"])
    for r in ra:
        require(_by_axis(r["collectives"]) == want_c,
                f"{what} rank {r['coord']}: collectives "
                f"{_by_axis(r['collectives'])}, the dry run's {want_c}")
    emit({**info, "run": "a", "arch": VLM_ARCH, "n_layers": vcfg.n_layers,
          "world": 2, "backend": "gloo",
          "mesh": {"pod": 1, "data": 1, "model": 2},
          "requests": MESH_SSM_REQUESTS,
          "prompt_lens": [len(r.prompt) for r in reqs],
          "new_tokens": MESH_SSM_NEW, "prefill_chunk": width,
          "tenants": MESH_VLM_TENANTS, "lora_rank": 16, "text_only": True,
          "heads_per_rank": vcfg.n_heads // 2,
          "kv_heads_per_rank": vcfg.n_kv_heads // 2,
          "ff_columns_per_rank": vcfg.d_ff // 2,
          "vocab_columns_per_rank": vcfg.vocab_size,
          "first_chunk_max_abs_err": err, "max_abs_logit": top,
          "first_chunk_rel_err": err / top, "rel_bound": MESH_SSM_REL,
          "first_chunk_bitwise_across_ranks": True,
          "streams_bitwise_meshless": ra[0]["streams"]
          == serve_ref["streams"],
          "stream_prefix_matched": matched,
          **_serve_summary(ra[0], serve_ref),
          "prefill_dispatches": ra[0]["stats"]["prefill_dispatches"],
          "decode_steps": ra[0]["stats"]["decode_steps"],
          "collectives": _collective_summary(ra[0]["collectives"]),
          "host_ms_note": GLOO_NOTE,
          "peak_bytes_per_rank": [r["peak_bytes"] for r in ra],
          "meshless_peak_bytes": serve_ref["peak_bytes"],
          "dry_run_decode_peak_bytes": walk["decode"]["peak_bytes"],
          "dry_run_prefill_peak_bytes": walk["prefill"]["peak_bytes"],
          "launches": [{k: r["launches"][k] for k in kernels.SERVING}
                       for r in ra],
          "meshless_s": meshless_s, "spawn_s": spawn_s})
    counts["a_serve"] = {n: ra[0]["launches"][n] for n in kernels.SERVING}
    # -- (b) and (c)'s rounds ---------------------------------------------------
    for i, ((tag, arch), c) in enumerate(rounds.items()):
        rs = sorted((rk[1][i][0] for rk in ranks),
                    key=lambda r: r["coord"]["model"])
        counts[f"round_{tag}_{arch}"] = mesh_round_check(
            f"mesh vlm_encdec ({'b' if arch == VLM_ARCH else 'c'}, round "
            f"{tag}, {arch})", rs, round_ref[tag, arch],
            round_ref.get(("plain", arch)) if tag == "bf16" else None, c,
            seed, dry[arch, "fdlora_round"], {**info, "run": (
                "b" if arch == VLM_ARCH else "c_round")}, T,
            rbase[arch]["rows"])
    # -- (c) whisper's train step and decode ----------------------------------
    rw = sorted((rk[2] for rk in ranks), key=lambda r: r["coord"]["model"])
    what = f"mesh vlm_encdec (c, {ENCDEC_ARCH})"
    specs = adapter_specs(wcfg)
    grads, differ = _gather_model(specs, [r["train"]["grads"] for r in rw])
    require(not differ, f"{what}: gradient leaves every rank holds differ "
            f"across the ranks: {differ}")
    want_g = dict(tree_leaves(train_ref["grads"]))
    zero = sorted(p for p in want_g if "['cross_attn']['wv']" in p)
    nonzero = [f"rank {r['coord']['model']} {p}" for r in rw
               for p, g in tree_leaves(r["train"]["grads"])
               if p in zero and bool(g.any())]
    errs = {p: _rel(g, want_g[p]) for p, g in tree_leaves(grads)
            if p not in zero}
    worst = max(errs, key=errs.get)
    loss_rel = abs(rw[0]["train"]["loss"] - train_ref["loss"]) / abs(
        train_ref["loss"])
    walk_t = dry[ENCDEC_ARCH, "train"]
    emit({**info, "run": "c_train", "arch": ENCDEC_ARCH, "world": 2,
          "backend": "gloo", "mesh": {"pod": 1, "data": 1, "model": 2},
          "rows": MESH_WHISPER_TRAIN_ROWS, "frames": wcfg.encoder_seq_len,
          "text_tokens": T, "heads_per_rank": wcfg.n_heads // 2,
          "ff_columns_per_rank": wcfg.d_ff // 2,
          "vocab_columns_per_rank": wcfg.vocab_size,
          "loss": rw[0]["train"]["loss"], "meshless_loss": train_ref["loss"],
          "loss_rel": loss_rel, "max_grad_rel_err": errs[worst],
          "worst_leaf": worst, "median_grad_rel_err": sorted(
              errs.values())[len(errs) // 2],
          "zero_grad_leaves": zero, "nonzero": nonzero,
          "collectives": _collective_summary(rw[0]["train"]["collectives"]),
          "host_ms_note": GLOO_NOTE,
          "peak_bytes_per_rank": [r["train"]["peak_bytes"] for r in rw],
          "meshless_peak_bytes": train_ref["peak_bytes"],
          "dry_run_peak_bytes": walk_t["peak_bytes"],
          "launches": [{k: r["train"]["launches"][k]
                        for k in kernels.TRAINING} for r in rw]})
    require(len(zero) == 2 and not nonzero, f"{what}: gradients that must "
            f"be 0: {zero}, non-zero: {nonzero}")
    require(rw[0]["train"]["loss"] == rw[1]["train"]["loss"],
            f"{what}: the ranks' losses differ")
    require(loss_rel <= 2e-2, f"{what}: loss rel err {loss_rel} > 2e-2")
    require(errs[worst] <= 0.25, f"{what}: gradient {worst} rel err "
            f"{errs[worst]} > 0.25")
    for r in rw:
        require(_by_axis(r["train"]["collectives"])
                == _by_axis(walk_t["collectives"]),
                f"{what} rank {r['coord']}: train collectives differ from "
                "the dry run's walk")
        for name in ("lora_matmul", "flash_attention"):
            require(r["train"]["launches"][name] > 0,
                    f"{what} rank {r['coord']}: {name} never launched")
            require_mma_tile(r["train"]["tiles"], name,
                             f"{what} rank {r['coord']}")
    counts["c_train"] = {n: rw[0]["train"]["launches"][n]
                         for n in kernels.TRAINING}
    dec = [r["decode"] for r in rw]
    require(torch.equal(dec[0]["tokens"], dec[1]["tokens"])
            and dec[0]["logits_digest"] == dec[1]["logits_digest"],
            f"{what}: the ranks' decode streams or logits differ")
    tc, lc = dec[0]["tokens"], dec[0]["logits"]
    err0 = float((lc[:, 0] - lt[:, 0]).abs().max())
    top0 = float(lt[:, 0].abs().max())
    top2 = torch.topk(lt[:, 0], 2, dim=-1).values
    decisive = (top2[:, 0] - top2[:, 1]) > 2 * err0
    agree = lc[:, 0].argmax(-1) == lt[:, 0].argmax(-1)
    require(err0 <= 0.1 * top0, f"{what}: first decode step's error {err0} "
            f"over 0.1 x the largest logit {top0}")
    require(bool(agree[decisive].all()), f"{what}: a first greedy token "
            "differs where the margin exceeds twice the error")
    matched_d, worst_d = decode_margin_rule(tc, lc, tt, lt, 0.1,
                                            f"{what} decode")
    walk_d = dry[ENCDEC_ARCH, "decode"]
    enc_sum = ENCDEC_ROWS * wcfg.encoder_seq_len * wcfg.d_model * 2
    want_d = {("model", enc_sum): 2 * wcfg.n_encoder_layers}
    for k, v in _by_axis(walk_d["collectives"]).items():
        want_d[k] = want_d.get(k, 0) + ENCDEC_STEPS * v
    for r, d in zip(rw, dec):
        require(_by_axis(d["collectives"]) == want_d,
                f"{what} rank {r['coord']}: decode collectives "
                f"{_by_axis(d['collectives'])}, the walks' {want_d}")
        require(2 * d["cross_bytes"] == cross_bytes,
                f"{what} rank {r['coord']}: cross K/V {d['cross_bytes']} "
                f"bytes, not half of {cross_bytes}")
        require(d["launches"]["lora_matmul"] > 0
                and d["launches"]["flash_attention"] > 0,
                f"{what} rank {r['coord']}: decode launched "
                f"{d['launches']}")
    emit({**info, "run": "c_decode", "arch": ENCDEC_ARCH, "world": 2,
          "backend": "gloo", "mesh": {"pod": 1, "data": 1, "model": 2},
          "rows": ENCDEC_ROWS, "steps": ENCDEC_STEPS,
          "adapter": "eq7_fused_rank16",
          "prefill_cross_ms": dec[0]["prefill_s"] * 1e3,
          "meshless_prefill_cross_ms": pre_t * 1e3,
          "ms_per_step": dec[0]["decode_s"] / ENCDEC_STEPS * 1e3,
          "meshless_ms_per_step": dec_t / ENCDEC_STEPS * 1e3,
          "first_step_max_abs_logit_err": err0, "max_abs_logit": top0,
          "first_token_agree": int(agree.sum()),
          "decisive_rows": int(decisive.sum()),
          "matched_tokens": matched_d, "max_abs_logit_err": worst_d,
          "streams_bitwise_meshless": bool(torch.equal(tc, tt)),
          "cross_kv_bytes_per_rank": [d["cross_bytes"] for d in dec],
          "meshless_cross_kv_bytes": cross_bytes,
          "collectives": _collective_summary(dec[0]["collectives"]),
          "host_ms_note": GLOO_NOTE,
          "peak_bytes_per_rank": [d["peak_bytes"] for d in dec],
          "dry_run_decode_peak_bytes": walk_d["peak_bytes"],
          "launches": [{k: d["launches"][k] for k in kernels.TRAINING}
                       for d in dec]})
    counts["c_decode"] = {n: dec[0]["launches"][n] for n in kernels.TRAINING}
    emit({**info, "run": "seconds", "phase_s": time.perf_counter() - t_phase,
          "meshless_s": meshless_s, "spawn_s": spawn_s})
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def vlm_encdec_phase(device, seed: int, T: int = 256, new_tokens: int = 16,
                     rank: int = 16):
    """internvl2-26b, then whisper-small (``vlm_phase``,
    ``whisper_phase``); returns {arch: {run: launch counts}}."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    counts = {VLM_ARCH: vlm_phase(device, seed, T, new_tokens, rank)}
    gc.collect()
    torch.cuda.empty_cache()
    counts[ENCDEC_ARCH] = whisper_phase(device, seed, T, rank)
    return counts


def ptxas_entries(report: str):
    """``{kernel: {registers, spill_stores, spill_loads}}`` from ``nvcc
    -Xptxas=-v`` output.  The tensor-core tiles are named
    ``<kernel><hd or LoRA tile kind[, int8]>`` and the decode kernels
    ``<kernel><pool type, hd, heads>`` from their mangled names; others
    keep theirs."""
    import re
    out, name = {}, None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            t = re.search(r"\d+([a-z][a-z_]*_mma_kernel)ILi(\d+)E(a?)", name)
            u = re.search(r"\d+(lora_mma_[a-z_]+?_kernel)(?:I([af])E)?",
                          name)
            d = re.search(r"\d+(paged_decode_[a-z]+_kernel)"
                          r"(?:ILb([01])ELi(\d+)ELi(\d+)E)?", name)
            if d:
                name = d.group(1) + (
                    f"<{'int8' if d.group(2) == '1' else 'bf16'}, hd "
                    f"{d.group(3)}, heads {d.group(4)}>" if d.group(2)
                    else "")
            elif t:
                name = f"{t.group(1)}<{t.group(2)}" + (
                    ", int8>" if t.group(3) else ">")
            elif u:
                name = u.group(1) + {"a": "<int8>", "f": "<fp32>"}.get(
                    u.group(2), "")
            out[name] = {"registers": None, "spill_stores": 0,
                         "spill_loads": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def card_identity():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


KERNEL_ROWS = {
    "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:87"),
    "paged_prefill_attention": ("src/repro_torch/kernels/csrc/paged_prefill.cu",
                                "src/repro/kernels/paged_prefill.py:166"),
    "batched_lora_matmul": ("src/repro_torch/kernels/csrc/batched_lora.cu",
                            "src/repro/kernels/batched_lora.py:153"),
    "lora_matmul": ("src/repro_torch/kernels/csrc/lora_matmul.cu",
                    "src/repro/kernels/lora_matmul.py:52"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:81"),
    "dual_lora_matmul": ("src/repro_torch/kernels/csrc/dual_lora.cu",
                         "src/repro/kernels/dual_lora.py:51"),
    "batched_dual_lora_matmul": (
        "src/repro_torch/kernels/csrc/batched_dual_lora.cu",
        "src/repro/kernels/batched_lora.py:224"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20,
                    help="timed repetitions per kernel")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found; run "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    reports = build.build()
    ptxas = {n: ptxas_entries(rep) for n, rep in reports.items()}
    mma = {f"{src}: {k}": v for src, ent in ptxas.items()
           for k, v in ent.items() if "_mma_" in k or "lmma" in k}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(reports), "ptxas": ptxas,
          "tensor_core_tiles": mma})
    for src in ("paged_prefill", "flash_attention", "batched_lora",
                "lora_matmul", "dual_lora", "batched_dual_lora"):
        if src in reports:
            require(any("_mma_kernel" in k for k in ptxas[src]),
                    f"no tensor-core tile in the ptxas report of {src}.cu")
    spilled = {k: v for k, v in mma.items()
               if v["spill_stores"] or v["spill_loads"]}
    require(not spilled, f"tensor-core tiles spill registers: {spilled}")
    for src, tile in (("paged_prefill", "paged_prefill_mma_kernel<256>"),
                      ("paged_prefill", "paged_prefill_mma_kernel<256, int8>"),
                      ("flash_attention", "flash_attn_mma_kernel<256>")):
        if src in reports:
            require(tile in ptxas[src], f"no head-dim-256 tile {tile} in the "
                    f"ptxas report of {src}.cu")
    if "paged_attention" in reports:
        dec = ptxas["paged_attention"]
        require(any(k.startswith("paged_decode_split_kernel<") for k in dec)
                and "paged_decode_combine_kernel" in dec,
                "no split-K decode kernels in the ptxas report of "
                "paged_attention.cu")
        spilled = {k: v for k, v in dec.items()
                   if v["spill_stores"] or v["spill_loads"]}
        require(not spilled, f"decode kernels spill registers: {spilled}")

    import numpy as np
    rng = np.random.default_rng(args.seed)
    n_requests, T = 8, 256
    prompt_lens = sorted(int(n) for n in rng.integers(128, 1025, n_requests))
    seconds = {}                       # wall seconds by phase

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - t
        return out

    t_kernels = time.perf_counter()
    main_shapes = kernel_phase(device, args.seed, args.reps, prompt_lens, T)
    main_shapes["batched_dual_lora_matmul"], dual_launches = \
        dual_entry_point(device, args.seed, args.reps, n_requests, T)
    main_shapes.update(training_kernels(
        device, args.seed, args.reps,
        {k: v["registers"] for k, v in ptxas.get("lora_matmul", {}).items()}))
    seconds["kernels"] = time.perf_counter() - t_kernels
    from repro_torch import kernels
    from repro_torch.configs import get_config
    llama = get_config(ARCH).with_overrides(n_layers=LLAMA_LAYERS)
    serve_counts, eng = timed("serve", serve_phase, device, args.seed,
                              n_requests, 32, 128, 1024, T, llama)
    torch.cuda.empty_cache()            # the serving pools are gone
    timed("serve_trace", serve_trace_phase, device, args.seed)
    params = eng.params
    del eng
    torch.cuda.empty_cache()
    timed("serve_options", serve_options_phase, device, args.seed, params,
          llama, T)
    torch.cuda.empty_cache()
    sharded_counts, eng1 = timed("sharded", sharded_phase, device,
                                 args.seed, params, llama, prompt_lens, T)
    fixed_launches = timed("fixed", fixed_phase, eng1, args.seed)
    del eng1
    torch.cuda.empty_cache()
    train_counts, fdlora_accuracy = timed("train", train_phase, device,
                                          args.seed, params, llama)
    timed("baselines", baselines_phase, device, args.seed, params, llama,
          fdlora_accuracy)
    remat_counts = timed("remat", remat_phase, device, args.seed, params,
                         llama)
    del params                          # llama2-7b's weights
    torch.cuda.empty_cache()
    timed("dense_family", dense_family_phase, device, args.seed, T)
    moe_counts = timed("moe", moe_phase, device, args.seed, T)
    ssm_counts = timed("ssm", ssm_phase, device, args.seed, T)
    vlm_encdec_counts = timed("vlm_encdec", vlm_encdec_phase, device,
                              args.seed, T)
    train_families_counts = timed("train_families", train_families_phase,
                                  device, args.seed, T)
    full_train_counts = timed("full_train", full_train_phase, device,
                              args.seed, T)
    mesh_counts = timed("mesh_round", mesh_round_phase, device, args.seed, T)
    mesh_serve_counts = timed("mesh_serve", mesh_serve_phase, device,
                              args.seed, T)
    mesh_moe_counts = timed("mesh_moe", mesh_moe_phase, device, args.seed,
                            T)
    mesh_ssm_counts = timed("mesh_ssm", mesh_ssm_phase, device, args.seed,
                            T)
    mesh_vlm_encdec_counts = timed("mesh_vlm_encdec", mesh_vlm_encdec_phase,
                                   device, args.seed, T)
    # each kernel's launches on its own path's run; the standalone kernel's
    # at its entry point
    counts = {**{n: serve_counts[n] for n in kernels.SERVING},
              **{n: train_counts[n] for n in kernels.TRAINING},
              "batched_dual_lora_matmul": dual_launches}
    # this slice's paths, each read just after its own run
    emit({"phase": "path_launches", "sharded": {
        n: sharded_counts[n] for n in kernels.SERVING},
        "fixed": fixed_launches,
        "moe": {arch: {n: c[n] for n in kernels.SERVING}
                for arch, c in moe_counts.items()},
        "ssm": {arch: {n: c[n] for n in kernels.SERVING}
                for arch, c in ssm_counts.items()},
        "vlm_encdec": vlm_encdec_counts,
        "train_families": train_families_counts,
        "full_train": full_train_counts,
        "mesh_round": mesh_counts,
        "mesh_serve": mesh_serve_counts,
        "mesh_moe": mesh_moe_counts,
        "mesh_ssm": mesh_ssm_counts,
        "mesh_vlm_encdec": mesh_vlm_encdec_counts,
        "remat": remat_counts})
    emit({"phase": "total", "seconds": time.perf_counter() - t0,
          "by_phase": seconds})

    print(card_identity(), flush=True)
    rows = []
    for name, (source, replaces) in KERNEL_ROWS.items():
        res = main_shapes[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": counts[name],
                     "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                     "device_ms": res["device_ms"],
                     "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                     "bound_by": res["bound_by"],
                     "library_ms": res["library_ms"],
                     **({"library_device_ms": res["library_device_ms"]}
                        if "library_device_ms" in res else {})})
    emit({"phase": "device_traces", "retaken": len(DEVICE_TRACE_RETAKES),
          "retakes": DEVICE_TRACE_RETAKES})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
