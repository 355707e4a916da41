#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (deepspeed_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --baseline DIR   # DIR: a checkout of an earlier commit
    python3 chip_smoke.py --bwd-baseline DIR   # the flash backward alone, PR 8's on
    python3 chip_smoke.py --decode-breakdown
    python3 chip_smoke.py --matvec-breakdown
    python3 chip_smoke.py --layernorm-breakdown
    python3 chip_smoke.py --norm-breakdown
    python3 chip_smoke.py --rmsnorm-bwd-breakdown
    python3 chip_smoke.py --bias-grad-breakdown
    python3 chip_smoke.py --io-probe

Run from the root of a checkout on a machine with one CUDA card (Hopper,
sm_90a). With ``--baseline DIR`` it only builds both checkouts' kernels,
checks on the same seeded inputs that the decode kernels agree within 1e-2,
that the Llama (slope-free) and ALiBi forms of the flash forward agree
within 2e-2 (out) and 1e-3 (lse), that the flash backward's dq, dk and dv
agree within 2e-2 of the largest gradient, that the packed matvec agrees
within two bf16 ulps of its largest value, the LayerNorm and RMSNorm
backwards within check_layernorm_bwd's and check_rmsnorm_bwd's tolerances,
the bias gradient within check_bias_grad's 1e-2 of its largest value (at
attention_bias's shape, at head dim 128 with ALiBi slopes and with a bf16
bias) and the RMSNorm and LayerNorm forwards within two bf16 ulps, then
times both checkouts' forward kernel at every PERF.md section 6 forward
shape, backward kernels at every backward shape, decode kernels at every
decode shape and the matvec, the LayerNorm and RMSNorm backwards, the bias
gradient and the norm forwards at their section 6 rows (the forwards also
at the decode steps' rows) in turns and fails if one of this checkout's
times is more than FWD_DEC_TIME_SLACK times the baseline's (a backward
time: BWD_TIME_SLACK; both the spread of identical code), or a row of the
kernels this tree redesigned (FASTER_ROWS: the RMSNorm backward and the
bias gradient) whose baseline reads over twice its bound is no faster; it
also prints the
kernels each decode wrapper call launches in both, each matvec, norm and
bias-gradient wrapper's host time a call, and the worst ratio of this
checkout's time to the baseline's of each kind. ``--matvec-breakdown`` times
copies of the matvec with its arithmetic cut out, with no expert-skip test,
with rings of 2, 4 and 8 stages and with one load path (TMA, or per-thread
cp.async) at every grid at the section 6 matvec shapes and wk/wv;
``--layernorm-breakdown`` the LayerNorm backward with its row loads, its dx
stores or its merge pass cut out at training_bloom's shape;
``--norm-breakdown`` the RMSNorm and LayerNorm forwards with their stores or
their loads cut out, four vectors a lane, no next-row prefetch, no
persistence, the weights loaded a row, and as an empty kernel, at the
prefill, serving_cb, training and decode shapes, beside the library call
and a copy_ of the same bytes; ``--rmsnorm-bwd-breakdown`` the RMSNorm
backward with its row loads, its dx stores, its merge pass or its next-row
prefetch cut out, two rows ahead, three blocks an SM, four blocks an SM of
one vector a lane, one vector a lane, and as empty kernels, at the training
shape, beside a torch.add(x, g) of the same bytes and the library call;
``--bias-grad-breakdown`` the bias-gradient kernel with its products, its
epilogue, its pair loads, all three, its bias tile load or its output
stores cut out, rings of 2 and 1 stages, and as an empty grid, at
attention_bias's shape. ``--io-probe`` times the checkpoint phase's
filesystem and host (np.save and np.load of 4 GiB, pinning 1 GiB, a 1 GiB
copy off the card). ``--bwd-baseline DIR`` times only the flash
backward's dq and dk/dv kernels of both checkouts at every backward shape
(Mixtral's head dim 128 among them) in the same turns, each held to
BWD_TIME_SLACK times the baseline's: its calls are those every checkout
from PR 8's on takes.
``--decode-breakdown``
times copies of the decode kernel with one part cut out (the merge, the tile
arithmetic, the cache reads, all but the bare grid, the third block an SM,
P's second bf16 term) at the decode shapes, and prints the errors that P as
one bf16 term and the flash ALiBi forward on another draw give. Without
arguments, in order, any failure exiting non-zero:

1. device check: CUDA must be available; prints the card's name and power
   limit as nvidia-smi reports them, the host's MemTotal and MemAvailable
   (/proc/meminfo) and the free bytes of the filesystem the checkpoint phase
   writes to, and the host's cores (the driver's H100 box: MemTotal
   108,447,924,224 bytes, 101.0 GiB, of it 96.5 GiB available at the start;
   80,209,420,288 bytes free on its root filesystem, a 9p mount; 8 cores);
2. build: compiles deepspeed_tpu_torch/csrc/*.cu (one nvcc per source, in
   parallel) and prints the build seconds and ptxas register counts, then
   the HGMMA (wgmma) and UTMALDG (TMA load) instructions of each forward,
   backward and bias-gradient flash kernel instantiation and the HMMA (mma.sync)
   instructions of each bf16 decode kernel instantiation and of each packed
   matvec instantiation from cuobjdump, each of which must be non-zero;
3. each kernel against its plain PyTorch version on the card, at the shapes
   each main path gives it (the flash and RMSNorm forwards at the serving
   and at the training shape, the norm forwards also at the decode steps'
   rows, timed with their wrappers' host us a call, every norm case rerun
   bitwise and its first, middle and last rows alone bitwise; the RMSNorm
   backward at the training shape (with its wrapper's host us a call, a
   torch.add(x, g) of the same bytes and the library call in three runs
   with the kernels it launches), at ragged row counts, on teams of one to
   sixteen warps, fp32 and mixed forms and the widest rows the wrapper
   takes (D 16384 bf16, 8192 fp32), each rerun bitwise and its first,
   middle and last rows alone bitwise their dx in the batch; the paged and
   dense decode kernels with 64 rows a slot at the continuous-batching
   step's shape, the paged ones also
   bitwise against the dense ones over the same bytes; the LayerNorm forward
   at bloom-7b1's, gpt2-xl's and bloom-560m's shapes and its backward at
   bloom-560m's, two runs bitwise equal; the ALiBi forms of the flash
   forward at bloom-7b1's prefill, of the flash forward and backward at
   bloom-560m's micro-batch (the forward's output within two bf16 ulps of
   its largest value, and at the micro-batch on eight more draws, each with
   its worst element's error in ulps of that element) and of the decode
   kernel at bloom-7b1's decode step, and the decode and flash forward
   Llama forms with nullptr slopes
   bitwise equal to slopes of zero (the flash backward to rounding); the
   segment-id, bias + segment and block-sparse forms of the
   flash forward, dq and dk/dv kernels at training_packed's,
   training_bloom_packed's and training_sparse's shapes, the dq kernel's
   dbias of the full positions bias, a "bigbird" layout with segments and
   other shapes of each form; the broadcast-bias gradient kernel at
   attention_bias's [1, 16, 2048, 2048] (with its wrapper's host us a
   call) and smaller shapes: every broadcast shape, bf16 and fp32 biases,
   segment ids, ALiBi slopes with a bias, head dim 128, ragged S, each
   dbias two runs bitwise equal; the packed matvec at Llama-3-8B's leaves and a
   Bq = D weight (GPT-2-XL's width), int8 and int4, M in {1, 4, 5, 8, 16},
   each row alone bitwise its row of every multi-row call, and its expert
   form at Mixtral-8x7B's banks and a small Bq = D bank with the same C,
   each expert bitwise the 2-D kernel on it, and a bank with only 2 of 8
   experts routed (the skipped experts equal the plain version, the routed
   ones the full bank's call, bitwise), each timed row with its wrapper's
   host time a call; the offset form of the flash forward, dq and dk/dv
   kernels at training_sp's hop shape on its diagonal, past and future
   hops, with ALiBi and segment ids at bloom-560m's width, the unmasked
   forms at its Ulysses shape, and the ring flash through a one-process
   loopback ring against the flat kernels on the whole 16,384-token
   sequence): max abs error against a stated tolerance, and the
   kernel's, plain version's and library call's times (CUDA events, median
   of single launches with L2 flushed and the card kept busy before each)
   beside the bound, one row
   per kernel and path; then the other shapes and dtypes the wrappers take,
   the forward kernel's tile walk (ragged S at head dims 64 and 128 with
   GQA groups 1, 4 and 8, causal and not, segment boundaries on and inside
   tile edges, diagonal, past and future ring hops with and without segment
   ids, the future hop out exactly 0 and lse exactly -1e30, a dense bias of
   each broadcast shape, the "bigbird" layout with segments) and the
   backward kernels' (ragged S, GQA groups 1, 4 and 8, segment boundaries on
   and inside tile edges, a future ring hop with gradients exactly zero)
   and the decode kernel's split and tile edges (frontiers on and beside
   64-key tiles and 512-key cluster turns, B=1 at 4095, GQA groups 1, 4 and
   8, windows whose rows are bitwise their single-token decode in bf16 and
   int8, dense and paged, a row tile all padding), every case run twice,
   bitwise equal; each decode row also prints its wrapper's host time a
   call; the fp16 forms (the Llama form of the flash forward, dq and dk/dv
   at training_fp16's micro-batch and at Llama-3-8B's heads, the RMSNorm
   forward and backward on its 8192 rows of 2048) within an eighth of the
   bf16 forms' tolerances, timed likewise (SDPA and ``F.rms_norm`` in fp16
   the library calls), and an overflow kept visible (a RMSNorm row and dq
   elements past 65,504 give inf or NaN, never a clamped value);
4. serving reference checks: two-layer full-width Llama-3-8B, BLOOM-7B1 and
   GPT-2-XL, kernel path against plain path, prefill and three cached
   decode steps;
5. training reference checks: two-layer full-width Llama-3.2-1B
   (``llama3-1b``) and BLOOM-560M, the kernel path against the plain path
   (loss, per-leaf gradients, then after three train_batch steps the
   masters' moves, the Adam moments and the grad norm), and ``full`` remat
   against ``none`` (bitwise); then the same kernel-against-plain check for
   llama3-1b on packed batches (segment ids and restarted positions), for
   bloom-560m on packed batches (the positions' dense ALiBi bias) and for
   llama3-1b under the "fixed" sparse_attention section; and the oracle
   packed equals unpacked: on two layers of llama3-1b and bloom-560m each
   document's logits from a packed row equal that document run alone;
6. the training main path: initialize(llama("llama3-1b")) at full depth, bf16
   over fp32 masters, AdamW, ZeRO 0, micro-batch 4 x 2 accumulation steps of
   2048 tokens, 10 steps on one seeded batch; the loss must be finite and fall;
   ms/step, tokens/s, MFU and peak memory; a profiled step (device busy share,
   top kernels); the launch counters, zeroed just before, must show every
   training kernel ran; then 3 steps rerun from the same seed must give
   bitwise-equal losses, and 3 more through DeepSpeed's loop
   (``engine(mb)``, ``engine.backward(loss)``, ``engine.step()``) the same
   losses and, bitwise, the rerun's masters (training_bloom likewise);
6b. ``checkpoint`` (run after the loop over the other main paths, before
   ``serving_mixtral``): 6's model (llama3-1b at full width and depth, its
   config and batch, ``checkpoint: {async_save: true, keep_last: 2}``): 2
   steps, a sync save_checkpoint (bytes, seconds, GB/s), 2 more steps, an
   async save (the fence ms, the writer's seconds); the engine freed, a
   fresh one (other masters) loads the step-2 tag (seconds) and runs steps
   3-4 with the counters zeroed just before: the losses bitwise the
   uninterrupted run's, every training kernel launched, the masters and Adam
   moments bitwise the step-4 tag's leaf by leaf; then ``checkpoint_serving``:
   init_inference(checkpoint=DIR) serves the three requests with the tokens
   of init_inference(params=) on the same masters, bitwise, its counters
   (zeroed before it) showing the serving kernels ran; save_16bit_model (a
   3.0 GB file) read back equal to the masters' bf16 cast under the HF
   names. The tags live under ``ckpts/`` in the checkout and are deleted at
   the end; the phase fails naming the shortfall if the disk or the host
   memory is too small for two tags and a pinned snapshot;
6c. ``offload`` (after ``checkpoint``): 6's model, config and batch (3
   steps) through ``initialize`` in five engines: stage 0 (the reference),
   stage 3, stage 3 + ``offload_optimizer: cpu`` (the layer stream double
   buffered, as always on a card), stage 3 + ``offload_param: cpu`` +
   ``offload_optimizer: cpu``, and stage 2 + ``offload_optimizer: nvme`` under
   ``ckpts/`` (2 steps); each engine's losses bitwise the reference's, its
   masters and every Adam moment byte for byte the reference's after its
   last step (the reference's copies kept on the card; bucketed names
   mapped to the resident ones), its counters (zeroed before its steps)
   showing every training kernel ran and fused Adam once per stacked leaf
   per layer plus once per other leaf a step; per engine step ms, peak and
   resident device memory, host bytes, the stream's bytes and GB/s each way
   and the forward's copy of host masters (NVMe: the disk's read and write
   GB/s). Fails naming the shortfall when
   the box lacks the host memory or the disk;
6d. ``training_8b_offload``: Llama-3-8B's width at 2 layers, stage 0 against
   stage 3 + ``offload_optimizer: cpu``, 2 steps, bitwise as in 6c; then
   ``llama("llama3-8b")`` at full width and depth (OFFLOAD_8B_LAYERS),
   stage 3 + ``offload_optimizer: cpu``, remat
   ``full``, bf16 over fp32 masters, AdamW on fused Adam, micro-batch 1 x 2048
   x 2 accumulation, 3 seeded steps: finite losses, the counters showing the
   flash, RMSNorm and per-slice fused Adam launches; step ms and its split
   (forward+backward, update, the stream's copy-in, update and copy-out
   device ms), tokens/s, MFU, peak device memory, host bytes, a profiled
   step. MemAvailable is checked before anything is pinned;
6e. ``training_fp16`` (after 6): 6's model, masters, batch and 10 steps in
   fp16 with the default dynamic loss scaler: no step skipped, the first
   loss within 2e-4 of 6's (bf16) from the same masters (6 runs first), ms/step and MFU,
   the counters showing the fp16 forms of the flash forward, dq and dk/dv
   and of both RMSNorm kernels and fused Adam ran and plain attention never
   did; then a leg of 3 steps at initial_scale_power 32, where the head's
   fp16 gradient overflows every step: each step skipped, the masters, Adam
   moments and update count hashing as before it, the scale read after
   each step 2**32 (the hysteresis), 2**31, 2**30, the lr unmoved;
7. the serving main path: init_inference(llama("llama3-8b"), bf16, kernel
   injection, max_tokens=1024) with seeded random weights at full depth, and
   generate on three requests; the launch counters, zeroed just before, must
   show every serving kernel ran; a profiled B=1 generate counts its kernel
   launches a forward;
8. the quantized serving reference check: a two-layer full-width Llama-3-8B
   with int8 (then int4) weights and the int8 KV cache, kernel path (the
   quantized matvec, int8 decode attention, flash prefill, RMSNorm) against
   the plain path (the dense product over the dequantized weights, plain
   attention and norm), prefill and three cached decode steps; then
   speculative decode with the main weights as the draft, which must accept
   every proposal;
9. the quantized serving main path: Llama-3-8B at full depth with int8
   weights and the int8 KV cache (the three requests), int4 weights (greedy
   B=1), and speculative decode on the int8 engine with the "ngram" draft
   and a Llama-3.2-1B draft, and on int8 weights with the bf16 cache drafted
   by its own weights (every proposal must be accepted); tokens equal to the
   engine's plain greedy tokens (a mismatch only at a near-tie of the plain
   run's logits); the counters, zeroed just before, must show every kernel of
   the path ran; rerun, identical tokens; a profiled int8 decode;
10. the continuous-batching reference check: a two-layer full-width
   Llama-3-8B through the serving step's forward (per-slot frontiers, padded
   rows, the head on each slot's last real row), kernel path against plain
   path, over a paged pool (bf16 and int8 KV) and a contiguous arena;
11. the continuous-batching main path (``serving_cb``): init_serving on
   Llama-3-8B at full depth, bf16 weights, kernel injection, 8 slots x a
   64-token budget, pages of 16 tokens, max_tokens 1024; a seeded trace of
   24 requests (prompts of 16-700 tokens, 8-32 new tokens, half sampled, six
   sharing a 250-token prefix, two repeating an earlier prompt) through the
   contiguous and the paged arena with bf16 and with int8 KV: outputs equal
   bitwise between the arenas per request, one step shape, the page pool's
   invariants, prefix reuse and copy-on-write, a rerun with identical
   tokens; the counters, zeroed before each run, must show the paged and
   dense decode kernels (bf16 and int8) and RMSNorm ran and the plain
   attention never ran on the card; per run steps, tokens/s, step ms, TTFT,
   TPOT, pool bytes and peak memory; a profiled window of 20 steps;
12. ``serving_bloom``: init_inference(bloom("bloom-7b1")) at full width and
   depth (7.07 B params, ALiBi, embedding LayerNorm, tied head), bf16,
   kernel injection, max_tokens 1024, the three requests of 7; the
   counters, zeroed just before, must show the ALiBi flash and decode forms
   and the LayerNorm kernel ran and the plain attention never ran on the
   card; a rerun gives identical tokens;
13. ``serving_gpt2``: the same for gpt2("gpt2-xl") (learned positions to
   1024, tanh GELU), greedy B=1 and B=4;
14. ``training_bloom``: 6's training path on bloom("bloom-560m") at full
   width and depth: the LayerNorm forward and backward kernels, the ALiBi
   flash forward and backward and fused Adam must have run;
15. ``training_packed``, ``training_bloom_packed``, ``training_sparse``:
   6's path on llama3-1b with packed batches (documents of 128-1536 tokens,
   seeded, the last cut at the row's end), on bloom-560m with the same
   packing, and on llama3-1b with the "fixed" sparse_attention section; 10
   steps each, MFU over the visible attention pairs only; the counters must
   show each path's masked flash forms ran;
16. ``attention_bias``: the attention op with a learned [1, 16, 2048, 2048]
   bias, three forward+backward steps; the bias-gradient kernel must run;
17. the Mixtral reference check: two-layer full-width Mixtral-8x7B with
   int8 (then int4) weights and the int8 KV cache: one MoE layer on a fixed
   input, kernel path against the plain fold (rel 1e-3) and the dequantized
   product (1e-2); then prefill and three cached decode steps, kernel path
   against plain path, where the first routing difference must be a router
   near-tie and the tokens before their row's first difference agree;
18. ``serving_mixtral``: init_inference(mixtral("mixtral-8x7b")) at full
   width and depth (46.70 B params; weights drawn and packed one layer at a
   time), int8 weights and the int8 KV cache on the three requests, the
   resident weights within 2 % of the reckoning (48.42 GB), peak memory, the
   MoE load, a profiled B=1 generate; between its int8 and int4 halves
   ``serving_cb_mixtral``: init_serving on the same int8 weights, bf16 KV,
   the first 2 requests of 11's trace through the contiguous and the paged
   arena (paged == contiguous bitwise, one step shape, the MoE metrics);
   then int4 weights (25.20 GB) on the greedy B=1 request. Each run twice
   with identical tokens, counters zeroed before the second; speculative
   decode is not driven (with 8 experts a verify window can drop tokens);
19. ``training_sp``: sequence-parallel training through initialize on two
   ranks spawned on the one card, joined over gloo (NCCL refuses two ranks
   on one device, so the transport goes through the host; it says so):
   llama3-1b at full width, 4 of its 16 layers, one seeded sequence of
   16,384 tokens a step (8,192 a rank), 2 steps in the ring mode and 2 in
   the Ulysses mode, then sp=1 on this process from the same seed: losses
   and grad norms within the bf16 tolerance of sp=1, ms/step, tokens/s per
   rank, peak memory, the device's share of a step and the gloo transport's
   times; the ranks' counters, zeroed before each mode, must show the offset
   forms (ring) and the unmasked forms (Ulysses) ran and plain attention on
   the card never did; then ``training_zero`` in the same world, at dp=2 and
   sp 1 (a row of 8,192 tokens a rank): ZeRO stages 0, 1, 2 and 3 (the
   default persistence threshold) from one seed, 2 steps each, stage 3 again
   with ``stage3_layer_prefetch``, and stage 0 twice more with its clipping
   norm summed in stage 2's and in stage 3's order (each leaf's two parts'
   squares, then the leaves); stage 1 bitwise stage 0, stage 2 bitwise the
   first witness and both stage-3 legs bitwise the second (losses, grad
   norms and masters, both ranks, stage 3's gathered whole), stages 2 and
   3's first loss bitwise stage 0's and first grad norm within 1e-6, each
   rank's ``state_bytes()`` (read from the live tensors) showing the moments
   split at stage 1, the gradients too at stage 2 and at stage 3 the plan's
   bytes, below stage 2's, beside the gradients' transient bytes, the gather
   counters and ``max_memory_allocated``, fused Adam once a part a step,
   the flash and RMSNorm kernels, no plain attention; ms a step per stage
   and the host-staged reduce-scatter and all-gather (each kernel of the
   path checked and timed at its shapes in 3, fused Adam on the largest
   part; stage 3's rows, ``training_zero3``, with fused Adam on a layer
   part);
20. ``training_mixtral``: initialize(mixtral("mixtral-8x7b", num_layers=2))
   at full width (3.165 B params; two of 32 layers, as the fp32 state takes
   16 B a parameter), bf16 over fp32 masters, AdamW through fused Adam,
   the ``moe`` section at ep 1, the "einsum" dispatch, micro-batch 4 x 2
   accumulation steps of 2048 tokens, 6 steps: the loss finite and falling,
   the aux loss finite; ms/step, tokens/s, MFU over the active parameters
   (attention, router, norms, head, two experts of eight), peak memory, the
   last step's tokens per expert and drop fraction, a profiled step; the
   counters must show the flash forward, dq and dk/dv at head dim 128, both
   RMSNorm kernels and fused Adam ran (each checked and timed at this
   path's shapes in 3, beside the others);
21. the kernels line (one JSON object, one entry per kernel and main path,
   with that path's launches), then the device line (last line).
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from deepspeed_tpu_torch import init_inference, init_serving, initialize
from deepspeed_tpu_torch.models import bloom, gpt2, llama, mixtral
from deepspeed_tpu_torch.models import decoding as dec_mod
from deepspeed_tpu_torch.models.decoding import (_quantize_kv, _window_rows,
                                                 forward_with_cache, init_cache,
                                                 init_paged_cache)
from deepspeed_tpu_torch.config import SparseAttentionConfig
from deepspeed_tpu_torch.models.transformer import (alibi_position_bias, alibi_slopes,
                                                    apply, layer_params, param_specs)
from deepspeed_tpu_torch.moe import sharded_moe as smoe
from deepspeed_tpu_torch.ops import cuda as kernels
from deepspeed_tpu_torch.launcher import launch_local
from deepspeed_tpu_torch.comm.collectives import (all_gather, all_reduce, reduce_scatter,
                                                  ring_shift)
from deepspeed_tpu_torch.ops.attention import attention, attention_impl
from deepspeed_tpu_torch.ops.ring_flash import Ring, ring_flash_attention_local
from deepspeed_tpu_torch.ops.cuda import _build
from deepspeed_tpu_torch.ops.cuda import decode_attention as dec
from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
from deepspeed_tpu_torch.ops.cuda import fused_adam as fad
from deepspeed_tpu_torch.ops.cuda import layernorm as ln
from deepspeed_tpu_torch.ops.cuda import quantized_matmul as qmm
from deepspeed_tpu_torch.ops.cuda import rmsnorm as rn
from deepspeed_tpu_torch.ops.normalization import kernel_rmsnorm_scope
from deepspeed_tpu_torch.ops.quantizer import PackedWeight, pack_quantize_blockwise
from deepspeed_tpu_torch.integrations.hf import export_hf_state_dict, read_safetensors
from deepspeed_tpu_torch.runtime.checkpointing import (_assemble_leaf, _match_leaves,
                                                       _stored_names)
from deepspeed_tpu_torch.runtime.ckpt import reset_preempt_handler
from deepspeed_tpu_torch.runtime.ckpt.manifest import read_manifest
from deepspeed_tpu_torch.runtime.zero import shard_plan, stage3_plan
from deepspeed_tpu_torch.utils.tree import tree_items
from deepspeed_tpu_torch.ops.sparse_attention import (BigBirdSparsityConfig,
                                                      BSLongformerSparsityConfig,
                                                      VariableSparsityConfig,
                                                      from_ds_config, sparse_layout)
from deepspeed_tpu_torch.serving import Request, RequestStatus
from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_map

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and dense bf16
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
BF16 = torch.bfloat16

KERNELS = {
    "flash_attention_fwd": {
        "source": "deepspeed_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:175",
    },
    "decode_attention": {
        "source": "deepspeed_tpu_torch/csrc/decode_attention.cu",
        "replaces": "deepspeed_tpu/ops/pallas/decode_attention.py:76",
    },
    "rmsnorm_fwd": {
        "source": "deepspeed_tpu_torch/csrc/rmsnorm.cu",
        "replaces": "deepspeed_tpu/ops/pallas/rmsnorm.py:23",
    },
    "rmsnorm_bwd": {
        "source": "deepspeed_tpu_torch/csrc/rmsnorm_bwd.cu",
        "replaces": "deepspeed_tpu/ops/pallas/rmsnorm.py:30",
    },
    "flash_attention_bwd_dq": {
        "source": "deepspeed_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:455",
    },
    "flash_attention_bwd_dkv": {
        "source": "deepspeed_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:517",
    },
    "fused_adam": {
        "source": "deepspeed_tpu_torch/csrc/fused_adam.cu",
        "replaces": "deepspeed_tpu/ops/pallas/fused_adam.py:29",
    },
    "quantized_matvec_int8": {
        "source": "deepspeed_tpu_torch/csrc/quantized_matvec.cu",
        "replaces": "deepspeed_tpu/ops/pallas/quantized_matmul.py:38",
    },
    "quantized_matvec_int4": {
        "source": "deepspeed_tpu_torch/csrc/quantized_matvec.cu",
        "replaces": "deepspeed_tpu/ops/pallas/quantized_matmul.py:38",
    },
    # the expert form: the TPU package launches _kernel (:38) once per expert
    # from _packed_expert_matvec_local (:330)
    "quantized_matvec_expert_int8": {
        "source": "deepspeed_tpu_torch/csrc/quantized_matvec.cu",
        "replaces": "deepspeed_tpu/ops/pallas/quantized_matmul.py:330",
    },
    "quantized_matvec_expert_int4": {
        "source": "deepspeed_tpu_torch/csrc/quantized_matvec.cu",
        "replaces": "deepspeed_tpu/ops/pallas/quantized_matmul.py:330",
    },
    "decode_attention_int8": {
        "source": "deepspeed_tpu_torch/csrc/decode_attention.cu",
        "replaces": "deepspeed_tpu/ops/pallas/decode_attention.py:76",
    },
    "paged_decode_attention": {
        "source": "deepspeed_tpu_torch/csrc/decode_attention.cu",
        "replaces": "deepspeed_tpu/ops/pallas/decode_attention.py:111",
    },
    "paged_decode_attention_int8": {
        "source": "deepspeed_tpu_torch/csrc/decode_attention.cu",
        "replaces": "deepspeed_tpu/ops/pallas/decode_attention.py:111",
    },
    "layernorm_fwd": {
        "source": "deepspeed_tpu_torch/csrc/layernorm.cu",
        "replaces": "deepspeed_tpu/ops/pallas/layernorm.py:25",
    },
    "layernorm_bwd": {
        "source": "deepspeed_tpu_torch/csrc/layernorm_bwd.cu",
        "replaces": "deepspeed_tpu/ops/pallas/layernorm.py:37",
    },
    # the segment-id (has_seg), bias + segment (has_bias) and block-sparse
    # (sparse) forms, flash_attention.py:94-175
    **{f"{name}{form}": {"source": f"deepspeed_tpu_torch/csrc/{src}",
                         "replaces": f"deepspeed_tpu/ops/pallas/flash_attention.py:{line}"}
       for name, src, line in (("flash_attention_fwd", "flash_attention_fwd.cu", 175),
                               ("flash_attention_bwd_dq", "flash_attention_bwd.cu", 455),
                               ("flash_attention_bwd_dkv", "flash_attention_bwd.cu", 517))
       for form in ("_seg", "_bias_seg", "_sparse")},
    # the offset form of ring attention's hops (has_offsets, flash_attention.py:
    # 94-113, :334, :719; driven by ring_flash.py:_rf_fwd/:_rf_bwd, lines 83, 120)
    **{f"{name}_offsets": {"source": f"deepspeed_tpu_torch/csrc/{src}",
                           "replaces": f"deepspeed_tpu/ops/pallas/flash_attention.py:{line}"}
       for name, src, line in (("flash_attention_fwd", "flash_attention_fwd.cu", 175),
                               ("flash_attention_bwd_dq", "flash_attention_bwd.cu", 455),
                               ("flash_attention_bwd_dkv", "flash_attention_bwd.cu", 517))},
    # the ALiBi forms (has_alibi, flash_attention.py:94-113)
    "flash_attention_fwd_alibi": {
        "source": "deepspeed_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:175",
    },
    "flash_attention_bwd_dq_alibi": {
        "source": "deepspeed_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:455",
    },
    "flash_attention_bwd_dkv_alibi": {
        "source": "deepspeed_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:517",
    },
    # the bias-gradient kernel of a broadcast dense bias
    "flash_attention_bias_grad": {
        "source": "deepspeed_tpu_torch/csrc/flash_attention_bias_grad.cu",
        "replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:570",
    },
    # the fp16 Llama forms of the flash kernels and the fp16 RMSNorm kernels
    # (fp16 training with the dynamic loss scaler; the Pallas kernels are
    # dtype-generic)
    **{f"{name}_f16": {"source": f"deepspeed_tpu_torch/csrc/{src}",
                       "replaces": f"deepspeed_tpu/ops/pallas/{line}"}
       for name, src, line in (
           ("flash_attention_fwd", "flash_attention_fwd_f16.cu", "flash_attention.py:175"),
           ("flash_attention_bwd_dq", "flash_attention_bwd_f16.cu", "flash_attention.py:455"),
           ("flash_attention_bwd_dkv", "flash_attention_bwd_f16.cu", "flash_attention.py:517"),
           ("rmsnorm_fwd", "rmsnorm_f16.cu", "rmsnorm.py:23"),
           ("rmsnorm_bwd", "rmsnorm_bwd_f16.cu", "rmsnorm.py:30"))},
    # the decode kernel with slopes; the TPU package runs these steps on XLA
    # (models/decoding.py:424-438) since its Pallas kernel takes no slope
    "decode_attention_alibi": {
        "source": "deepspeed_tpu_torch/csrc/decode_attention.cu",
        "replaces": "deepspeed_tpu/ops/pallas/decode_attention.py:76",
    },
}
SERVING_KERNELS = ("flash_attention_fwd", "decode_attention", "rmsnorm_fwd")
QUANT_SERVING_KERNELS = ("quantized_matvec_int8", "quantized_matvec_int4",
                         "decode_attention_int8", "flash_attention_fwd",
                         "rmsnorm_fwd", "decode_attention")
# Llama-3-8B's projection leaves (D, N): wq/wo, wk/wv, wi/wg, the MLP's wo
LLAMA3_8B_LEAVES = (("wq/wo", 4096, 4096), ("wk/wv", 4096, 1024),
                    ("wi/wg", 4096, 14336), ("mlp wo", 14336, 4096))
TRAINING_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                    "flash_attention_bwd_dkv", "rmsnorm_fwd", "rmsnorm_bwd",
                    "fused_adam")
# the training main path: llama3-1b micro-batch 4 x 2048 tokens, 2 micro-batches
TRAIN_B, TRAIN_S, TRAIN_ACCUM, TRAIN_LR = 4, 2048, 2, 1e-4
# training_fp16: the training path in fp16 with the dynamic loss scaler (its
# defaults: 2**16, window 1000, hysteresis 2); the fp16 forms of the flash
# and RMSNorm kernels, fused Adam on the fp32 masters as in bf16
TRAINING_FP16_KERNELS = ("flash_attention_fwd_f16", "flash_attention_bwd_dq_f16",
                         "flash_attention_bwd_dkv_f16", "rmsnorm_fwd_f16",
                         "rmsnorm_bwd_f16", "fused_adam")
FP16_SECTIONS = {"bf16": {"enabled": False}, "fp16": {"enabled": True}}
# the forced-overflow leg: at 2**32 the head's fp16 logits gradient, about the
# scale over a micro-batch's 8,192 tokens (2**19), passes 65,504
FP16_OVERFLOW_POWER, FP16_OVERFLOW_STEPS = 32, 3
# the fp16 forms' tolerances against their plain versions: an eighth of the
# bf16 forms' (fp16 has 3 more mantissa bits): the flash output 2e-2 / 8, the
# flash gradients 2e-2 / 8 of the largest, RMSNorm two fp16 ulps (2 * 2**-10
# relative, atol 1e-3 / 8)
FP16_TOL_OUT, FP16_TOL_BWD = 2.5e-3, 2.5e-3
FP16_NORM_ATOL, FP16_NORM_RTOL = 1.25e-4, 2e-3
# the first loss of training_fp16 against training's (bf16, the same masters):
# about 8x the gap measured on the H100 (2.376e-5: the loss, 0.4 above ln V,
# moves with what the attention computes; bf16's activations round at 2**-8)
FP16_FIRST_LOSS_RTOL = 2e-4
# each main training path's first loss, by path (set as the paths run)
FIRST_LOSS: dict = {}
# the continuous-batching main path: slots x token budget of the one step
CB_SLOTS, CB_BUDGET, CB_PAGE = 8, 64, 16
# a contiguous-arena slot: max_tokens 1024 + the budget, rounded up to 128
CB_CAPACITY = 1152
CB_KERNELS = ("paged_decode_attention", "paged_decode_attention_int8",
              "decode_attention", "decode_attention_int8", "rmsnorm_fwd")
# the LayerNorm families' paths
BLOOM_SERVING_KERNELS = ("flash_attention_fwd_alibi", "decode_attention_alibi",
                         "layernorm_fwd")
GPT2_SERVING_KERNELS = ("flash_attention_fwd", "decode_attention", "layernorm_fwd")
BLOOM_TRAINING_KERNELS = ("flash_attention_fwd_alibi", "flash_attention_bwd_dq_alibi",
                          "flash_attention_bwd_dkv_alibi", "layernorm_fwd",
                          "layernorm_bwd", "fused_adam")
# the packed, positions-bias and block-sparse training paths
PACKED_KERNELS = ("flash_attention_fwd_seg", "flash_attention_bwd_dq_seg",
                  "flash_attention_bwd_dkv_seg", "rmsnorm_fwd", "rmsnorm_bwd", "fused_adam")
BLOOM_PACKED_KERNELS = ("flash_attention_fwd_bias_seg", "flash_attention_bwd_dq_bias_seg",
                        "flash_attention_bwd_dkv_bias_seg", "layernorm_fwd",
                        "layernorm_bwd", "fused_adam")
SPARSE_KERNELS = ("flash_attention_fwd_sparse", "flash_attention_bwd_dq_sparse",
                  "flash_attention_bwd_dkv_sparse", "rmsnorm_fwd", "rmsnorm_bwd",
                  "fused_adam")
# packed documents: lengths uniform in [DOC_MIN, DOC_MAX], seeded
DOC_MIN, DOC_MAX, PACKED_SEED = 128, 1536, 6
# Mixtral-8x7B: the serving_mixtral path's kernels (int8 engine with the int8
# KV cache, int4 engine with the bf16 cache), its expert banks (D, N) at the
# decode step's C = eval_capacity rows an expert, and the serving_cb_mixtral
# path's (bf16 KV; its 512-row steps multiply the dequantized weights)
MIXTRAL_KERNELS = ("quantized_matvec_expert_int8", "quantized_matvec_expert_int4",
                   "quantized_matvec_int8", "quantized_matvec_int4",
                   "decode_attention_int8", "decode_attention", "flash_attention_fwd",
                   "rmsnorm_fwd")
MIXTRAL_BANKS = (("wi/wg", 4096, 14336, 8), ("wo", 14336, 4096, 8))
MIXTRAL_CB_KERNELS = ("paged_decode_attention", "decode_attention", "rmsnorm_fwd")
MIXTRAL_CB_REQUESTS = 2  # the prefix of cb_trace: 537 prompt tokens, 20 new
# the speculative serving runs' new tokens (B=1 greedy, P=100)
SPEC_NEW = 16
# training_sp: llama3-1b at full width, 4 of its 16 layers, one sequence of
# 16,384 tokens over an sp ring of 2 ranks (8,192 tokens each), 2 steps a mode
# and a training_zero leg (the phase's gloo transport takes seconds a step)
SP_SIZE, SP_SEQ, SP_LAYERS, SP_STEPS = 2, 16384, 4, 2
SP_RING_KERNELS = ("flash_attention_fwd_offsets", "flash_attention_bwd_dq_offsets",
                   "flash_attention_bwd_dkv_offsets", "rmsnorm_fwd", "rmsnorm_bwd",
                   "fused_adam")
SP_ULYSSES_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                      "flash_attention_bwd_dkv", "rmsnorm_fwd", "rmsnorm_bwd", "fused_adam")
# training_zero: training_sp's model and step over dp=SP_SIZE ranks (sp 1, one
# row of 8,192 tokens a rank), from the same seed: ZeRO stages 0, 1, 2, 3 (the
# default persistence threshold: the norm scales stay whole), 3 with the layer
# prefetch, and the witnesses "0 parts" and "0 parts3" (stage 0, its norm
# summed in stage 2's and in stage 3's order)
ZERO_LEGS = (0, "0 parts", 1, 2, "0 parts3", 3, "3 prefetch")
ZERO_STAGE = {0: 0, "0 parts": 0, 1: 1, 2: 2, "0 parts3": 0, 3: 3, "3 prefetch": 3}
ZERO3_THRESHOLD = 10**5  # stage3_param_persistence_threshold's default
# the stage-0 legs whose masters each leg is compared with
ZERO_REFS = {1: (0,), 2: (0, "0 parts"), 3: (0, "0 parts3"), "3 prefetch": (0, "0 parts3")}
ZERO_KERNELS = TRAINING_KERNELS
# stage 2's first grad norm (the same gradients, summed in another order)
ZERO_NORM_RTOL = 1e-6
# training_mixtral: Mixtral-8x7B at full width, 2 of its 32 layers, llama3-1b's
# batch (micro-batch 4 x 2048, 2 micro-batches), 6 steps
MIXTRAL_TRAIN_LAYERS, MIXTRAL_TRAIN_STEPS = 2, 6
MIXTRAL_TRAIN_KERNELS = TRAINING_KERNELS
# offload: llama3-1b's training batch through six ZeRO/offload engines;
# training_8b_offload: Llama-3-8B, micro-batch 1 x 2048 x 2 accumulation
OFFLOAD_STEPS, OFFLOAD_NVME_STEPS, OFFLOAD_8B_STEPS = 3, 2, 3
OFFLOAD_8B_LAYERS = 32  # full depth
OFFLOAD_8B_B = 1
# DeepSpeed's default sparsity mode at the flash kernels' 128-token block
SPARSE_SECTION = {"mode": "fixed", "block": 128, "num_local_blocks": 4,
                  "num_global_blocks": 1}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def bound(flops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of the two least times."""
    t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


# GPU clock cycles the card spins before each timed window (about 0.5 ms),
# so that the host's work for the launch (a wrapper's checks, its tensor maps,
# the launch) is done before the window opens and stays out of it: for the
# short kernels it can outlast the flush
TIMER_SPIN_CYCLES = 1_000_000


class Timer:
    """Median device time of single launches, L2 flushed before each and the
    card spinning while the host prepares the launch."""

    def __init__(self):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(TIMER_SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def flash_fwd_case(gen, timer, path, B: int, S: int, H: int, KV: int, D: int,
                   plain_iters: int = 20, dtype=BF16):
    """The flash forward, causal, on one seeded draw against its plain
    version; timed (with SDPA as the library call) when ``path`` names the
    main path whose shape this is (the plain version over ``plain_iters``
    launches). ``dtype`` float16: the fp16 Llama form, its output held to an
    eighth of bf16's tolerance (3 more mantissa bits)."""
    tol_out, tol_lse = (2e-2 if dtype == BF16 else FP16_TOL_OUT), 1e-3
    q = torch.randn(B, S, H, D, generator=gen, device="cuda", dtype=dtype)
    k = torch.randn(B, S, KV, D, generator=gen, device="cuda", dtype=dtype)
    v = torch.randn(B, S, KV, D, generator=gen, device="cuda", dtype=dtype)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=True)
    e_out, e_lse = max_err(out, ref), max_err(lse, ref_lse)
    print(f"flash_attention_fwd {dtype} B={B} S={S} H={H} KV={KV} D={D}: "
          f"max_abs_err out {e_out:.3e} (tol {tol_out}) lse {e_lse:.3e} "
          f"(tol {tol_lse})")
    require(e_out <= tol_out and e_lse <= tol_lse,
            f"flash_attention_fwd disagrees at B={B} S={S} D={D}")
    del out, lse, ref, ref_lse
    if path is None:
        return None
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    pairs = B * H * S * (S + 1) / 2
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel()) + 4 * B * H * S
    b_ms, b_by = bound(4 * D * pairs, nbytes)
    row = {
        "max_abs_err": e_out,
        "ms": timer(lambda: fa.flash_attention_fwd(q, k, v, causal=True)),
        "plain_ms": timer(lambda: fa.flash_attention_plain(q, k, v, causal=True),
                          iters=plain_iters),
        "library_ms": timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        "bound_ms": b_ms, "bound_by": b_by,
        "shape": f"B={B} S={S} H={H} KV={KV} D={D} causal" + ("" if dtype == BF16 else " fp16"),
    }
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return row


def check_flash(gen, timer):
    """The flash forward at the main paths' shapes: serving (Llama-3-8B
    prefill, head_dim 128, S up to the 512 bucket), training (llama3-1b
    micro-batch 4 x 2048, head_dim 64) and serving_gpt2 (GPT-2-XL's B=4 x 512
    prefill, 25 heads of 64). Returns one timed row per path."""
    rows = {}
    for path, B, S, H, KV, D in ((None, 2, 512, 32, 8, 128), (None, 2, 160, 32, 8, 128),
                                 ("serving", 4, 512, 32, 8, 128),
                                 ("training", TRAIN_B, TRAIN_S, 32, 8, 64),
                                 ("serving_gpt2", 4, 512, 25, 25, 64)):
        row = flash_fwd_case(gen, timer, path, B, S, H, KV, D)
        if row is not None:
            rows[path] = row
    return rows


def check_decode(gen, timer, H: int = 32, KV: int = 8, D: int = 128, slopes=None):
    """The dense decode kernel at a serving path's decode step: B=4 rows at
    frontiers [0, 37, 511, 1023] (and a scalar 700) of a 1024-token cache,
    Llama-3-8B's heads by default; ``slopes`` the ALiBi form. Returns the timed
    row at the frontiers."""
    B, Smax = 4, 1024
    tol = 1e-2
    name = "decode_attention" + ("" if slopes is None else "_alibi")
    q = torch.randn(B, 1, H, D, generator=gen, device="cuda", dtype=BF16)
    # one layer of a two-layer cache: the kernel reads the view in place
    cache_k = torch.randn(2, B, Smax, KV, D, generator=gen, device="cuda", dtype=BF16)
    cache_v = torch.randn(2, B, Smax, KV, D, generator=gen, device="cuda", dtype=BF16)
    kc, vc = cache_k[1], cache_v[1]
    frontier = torch.tensor([0, 37, 511, 1023], dtype=torch.int32, device="cuda")
    worst = 0.0
    kw = {} if slopes is None else {"slopes": slopes}
    for cl in (frontier, 700):
        out = dec.decode_attention(q, kc, vc, cl, **kw)
        ref = dec.decode_attention_plain(q, kc, vc, cl, **kw)
        e = max_err(out, ref)
        print(f"{name} B={B} Smax={Smax} H={H} KV={KV} D={D} "
              f"cache_len={cl.tolist() if torch.is_tensor(cl) else cl}: "
              f"max_abs_err {e:.3e} (tol {tol})")
        require(e <= tol, f"{name} disagrees at cache_len={cl}")
        worst = max(worst, e)
    n_keys = sum(min(int(c) + 1, Smax) for c in frontier.tolist())
    nbytes = 2 * 2 * n_keys * KV * D + 2 * 2 * B * H * D + 4 * B \
        + (4 * H if slopes is not None else 0)
    b_ms, b_by = bound(4 * H * D * n_keys, nbytes)
    kt, vt = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    qt = q.transpose(1, 2).contiguous()
    kpos = torch.arange(Smax, device="cuda")[None, :]
    mask = (kpos <= frontier[:, None].long())[:, None, None, :]
    if slopes is not None:  # a float mask: the ALiBi bias, -inf past the frontier
        dist = (frontier[:, None].long() - kpos).float()[:, None, None, :]
        mask = torch.where(mask, -slopes[None, :, None, None] * dist,
                           float("-inf")).to(BF16)
    return {
        "max_abs_err": worst,
        "ms": timer(lambda: dec.decode_attention(q, kc, vc, frontier, **kw)),
        "host_us": host_us(lambda: dec.decode_attention(q, kc, vc, frontier, **kw)),
        "plain_ms": timer(lambda: dec.decode_attention_plain(q, kc, vc, frontier, **kw)),
        "library_ms": timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)),
        "bound_ms": b_ms, "bound_by": b_by,
        "shape": f"B={B} Smax={Smax} H={H} KV={KV} D={D} cache_len={frontier.tolist()}"
                 + ("" if slopes is None else " ALiBi (library: SDPA, float mask)"),
    }


def bf16_ulp(v: float) -> float:
    """One bf16 ulp at magnitude v (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(abs(v), 1e-30))) - 7)


# rows of x (or an expert's rows) every form of the matvec is checked at
MATVEC_ROWS = (1, 4, 5, 8, 16)
# a weight whose contraction is one quantization block (D % 128 != 0):
# GPT-2-XL's width and its MLP's 4x
BQ_D_LEAF = ("Bq=D (GPT-2-XL width)", 1600, 6400)


def matvec_case(label, fn, plain, x, pw, rows_of):
    """One matvec form at every M of MATVEC_ROWS against its plain version
    (two bf16 ulps of the output's largest value), each row alone bitwise
    equal to that row of every multi-row call, and a rerun bitwise equal:
    ``x`` holds MATVEC_ROWS[-1] rows (dim -2); ``rows_of(t, m)`` is row m of
    an output. Returns {M: (max_abs_err, tol)}."""
    single = [fn(x[..., m:m + 1, :].contiguous(), pw) for m in range(x.shape[-2])]
    errs = {}
    for M in MATVEC_ROWS:
        xm = x[..., :M, :].contiguous()
        out = fn(xm, pw)
        ref = plain(xm, pw)
        peak = ref.float().abs().max().item()
        e, tol = max_err(out, ref), 2 * bf16_ulp(peak)
        rows_alone = all(torch.equal(single[m], rows_of(out, m)) for m in range(M))
        again = torch.equal(fn(xm, pw), out)
        print(f"{label} M={M}: max_abs_err {e:.3e} (tol {tol:.3e}, 2 bf16 ulps of "
              f"{peak:.3e}); each row alone bitwise equal: {rows_alone}; rerun bitwise "
              f"equal: {again}")
        require(e <= tol, f"{label} disagrees at M={M}")
        require(rows_alone and again, f"{label} M={M}: a row depends on M, or a rerun differs")
        errs[M] = (e, tol)
    return errs


def check_quantized_matvec(gen, timer):
    """The int8 and int4 matvec at Llama-3-8B's four leaf shapes and a
    Bq = D weight (GPT-2-XL's width, one quantization block), M in
    MATVEC_ROWS, against the plain version (fp32 fold x·(q·s)), tolerance two
    bf16 ulps of the output's largest value; each row of every multi-row call
    must equal that row alone, bitwise, and a rerun the first run. Timed rows,
    each with its wrapper's host us a call: wi/wg at M = 1 per width (the
    JSON line's) and wk/wv, the narrowest leaf, int8."""
    rows = {}
    for bits in (8, 4):
        for leaf, D, N in LLAMA3_8B_LEAVES + (BQ_D_LEAF,):
            w = (0.02 * torch.randn(D, N, generator=gen, device="cuda")).to(BF16)
            pw = pack_quantize_blockwise(w, bits=bits)
            x = torch.randn(MATVEC_ROWS[-1], D, generator=gen, device="cuda", dtype=BF16)
            errs = matvec_case(f"quantized_matvec int{bits} {leaf} D={D} N={N}",
                               qmm.packed_matvec, qmm.packed_matvec_plain, x, pw,
                               lambda t, m: t[m:m + 1])
            if leaf == "wi/wg" or (leaf == "wk/wv" and bits == 8):
                x1 = x[:1].contiguous()
                wd = pw.dequantize()
                nbytes = pw.nbytes + 2 * x1.numel() + 2 * N
                b_ms, b_by = bound(2 * D * N, nbytes)
                rows[(bits, leaf)] = {
                    "max_abs_err": errs[1][0],
                    "ms": timer(lambda: qmm.packed_matvec(x1, pw)),
                    "host_us": host_us(lambda: qmm.packed_matvec(x1, pw)),
                    "plain_ms": timer(lambda: qmm.packed_matvec_plain(x1, pw)),
                    "library_ms": timer(lambda: torch.matmul(x1, wd)),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "shape": f"M=1 D={D} N={N} {leaf} int{bits} (library: "
                             "torch.matmul on the dequantized bf16 weight)",
                }
                del wd
            del w, pw
    torch.cuda.empty_cache()
    r = rows[(8, "wk/wv")]
    print(f"quantized_matvec int8 wk/wv M=1: kernel {r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']}), host {r['host_us']:.1f} us a call")
    return rows[(8, "wi/wg")], rows[(4, "wi/wg")]


def routed_pair(x: torch.Tensor) -> torch.Tensor:
    """``x`` [8, C, D] with only experts 0 and 5 routed: the other six
    experts' rows zero, half of them -0.0 (what the einsum dispatch gives
    an unrouted expert), as a B=1 Mixtral decode step sees its bank."""
    xs = x.clone()
    for e in (1, 2, 3, 4, 6, 7):
        xs[e] = -0.0 if e % 2 else 0.0
    xs[3, :, ::2] = 0.0
    return xs


def check_expert_matvec(gen, timer):
    """The expert form of the int8 and int4 matvec at Mixtral-8x7B's banks
    (8 experts; wi/wg [8, 4096, 14336], wo [8, 14336, 4096]) and a small Bq =
    D bank, with C in MATVEC_ROWS rows an expert (4 is the decode step's eval
    capacity), against the plain version (fp32 fold x·(q·s) per expert),
    tolerance two bf16 ulps of the output's largest value; each row alone
    and each expert alone (the 2-D kernel on it) bitwise equal to the bank's
    call, and a rerun the first run. Then the bank with only 2 of its 8
    experts routed (:func:`routed_pair`): the skipped experts equal the plain
    version, the routed ones the full bank's call, bitwise. Timed at C = 4
    for both banks and for the routed pair; the library call is torch.bmm on
    the bank dequantized to bf16. Returns the wi/wg rows (the JSON line's)
    by width."""
    rows = {}
    for bits in (8, 4):
        for leaf, D, N, E in MIXTRAL_BANKS + (BQ_D_LEAF + (2,),):
            w = (0.02 * torch.randn(E, D, N, generator=gen, device="cuda")).to(BF16)
            pw = pack_quantize_blockwise(w, bits=bits)
            del w
            x = torch.randn(E, MATVEC_ROWS[-1], D, generator=gen, device="cuda", dtype=BF16)
            label = f"quantized_matvec_expert int{bits} {leaf} E={E} D={D} N={N}"
            matvec_case(label, qmm.packed_expert_matvec, qmm.packed_expert_matvec_plain,
                        x, pw, lambda t, m: t[:, m:m + 1])
            for C in MATVEC_ROWS:
                xc = x[:, :C].contiguous()
                out = qmm.packed_expert_matvec(xc, pw)
                alone = all(torch.equal(qmm.packed_matvec(xc[i], pw[i]), out[i])
                            for i in range(E))
                print(f"{label} C={C}: each expert bitwise the 2-D kernel: {alone}")
                require(alone, f"{label} C={C}: an expert differs from the 2-D kernel")
            if E != 8:
                continue
            C = 4
            xc = x[:, :C].contiguous()
            out = qmm.packed_expert_matvec(xc, pw)
            xs = routed_pair(xc)
            pair = qmm.packed_expert_matvec(xs, pw)
            skipped = [e for e in range(E) if e not in (0, 5)]
            skip_ok = torch.equal(pair[skipped], qmm.packed_expert_matvec_plain(xs, pw)[skipped])
            routed_ok = torch.equal(pair[[0, 5]], out[[0, 5]])
            print(f"{label} C={C}, experts 0 and 5 routed: skipped experts equal the plain "
                  f"version: {skip_ok}; routed experts bitwise the full bank's call: "
                  f"{routed_ok}")
            require(skip_ok and routed_ok, f"{label}: expert-skip is not exact")
            wd = pw.dequantize()
            nbytes = pw.nbytes + 2 * xc.numel() + 2 * E * C * N
            b_ms, b_by = bound(2 * E * C * D * N, nbytes)
            ref = qmm.packed_expert_matvec_plain(xc, pw)
            row = {
                "max_abs_err": max_err(out, ref),
                "ms": timer(lambda: qmm.packed_expert_matvec(xc, pw)),
                "host_us": host_us(lambda: qmm.packed_expert_matvec(xc, pw)),
                "plain_ms": timer(lambda: qmm.packed_expert_matvec_plain(xc, pw)),
                "library_ms": timer(lambda: torch.bmm(xc, wd)),
                "bound_ms": b_ms, "bound_by": b_by,
                "shape": f"E=8 C={C} D={D} N={N} int{bits} (library: torch.bmm on "
                         "the bank dequantized to bf16)",
            }
            # the routed pair's bound: their weight bytes, x and y
            pair_bytes = 2 * pw.nbytes // E + 2 * xs.numel() + 2 * E * C * N
            pb_ms, pb_by = bound(2 * 2 * C * D * N, pair_bytes)
            pair_ms = timer(lambda: qmm.packed_expert_matvec(xs, pw))
            pair_plain = timer(lambda: qmm.packed_expert_matvec_plain(xs, pw))
            pair_lib = timer(lambda: torch.bmm(xs, wd))  # the whole bank: bmm skips nothing
            print(f"quantized_matvec_expert int{bits} {leaf} C={C}: kernel "
                  f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library "
                  f"{row['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
                  f"{nbytes / row['ms'] / 1e6:.1f} GB/s; host {row['host_us']:.1f} us a "
                  f"call; 2 of 8 experts routed: {pair_ms:.4f} ms (bound {pb_ms:.4f} ms, "
                  f"{pb_by}: their bytes; plain {pair_plain:.4f} ms, library "
                  f"{pair_lib:.4f} ms)")
            del wd, ref
            if leaf == "wi/wg":
                rows[bits] = row
            del pw
            torch.cuda.empty_cache()
    return rows[8], rows[4]


def int8_cache(gen, B, Smax, KV, D):
    """One layer of a two-layer int8 cache and its scales, filled by
    ``_quantize_kv`` from random bf16 K/V: (k8, v8, k_scale, v_scale)."""
    k8 = torch.zeros(2, B, Smax, KV, D, dtype=torch.int8, device="cuda")
    v8 = torch.zeros_like(k8)
    ks = torch.zeros(2, B, KV, Smax, device="cuda")
    vs = torch.zeros_like(ks)
    for c8, cs in ((k8, ks), (v8, vs)):
        q, sc = _quantize_kv(torch.randn(B, Smax, KV, D, generator=gen,
                                         device="cuda", dtype=BF16))
        c8[1] = q
        cs[1] = sc.transpose(1, 2)
    return k8[1], v8[1], ks[1], vs[1]


def check_decode_int8(gen, timer):
    """The int8 form at B=4, Smax=1024, frontiers [0, 37, 511, 1023] and a
    scalar 700, head_dim 128 (Llama-3-8B) and 64, against its plain version
    (rows dequantized and rounded to bf16 as the kernel does); timed at 128."""
    B, Smax, H, KV = 4, 1024, 32, 8
    tol = 1e-2
    frontier = torch.tensor([0, 37, 511, 1023], dtype=torch.int32, device="cuda")
    row = None
    for D in (128, 64):
        q = torch.randn(B, 1, H, D, generator=gen, device="cuda", dtype=BF16)
        kc, vc, ks, vs = int8_cache(gen, B, Smax, KV, D)
        worst = 0.0
        for cl in (frontier, 700):
            out = dec.decode_attention(q, kc, vc, cl, ks, vs)
            ref = dec.decode_attention_plain(q, kc, vc, cl, ks, vs)
            e = max_err(out, ref)
            print(f"decode_attention_int8 B={B} Smax={Smax} H={H} KV={KV} D={D} "
                  f"cache_len={cl.tolist() if torch.is_tensor(cl) else cl}: "
                  f"max_abs_err {e:.3e} (tol {tol})")
            require(e <= tol, f"decode_attention_int8 disagrees at D={D} cache_len={cl}")
            worst = max(worst, e)
        # a 5-token verify window of one sequence as decode rows over its
        # cache: each row bitwise the single-token decode at its position
        qw = torch.randn(1, 5, H, D, generator=gen, device="cuda", dtype=BF16)
        one = (kc[3:4], vc[3:4])
        sc = (ks[3:4], vs[3:4])
        win = _window_rows(qw, *one, 600, None, None, *sc, kernel=True)
        same = all(torch.equal(win[:, s:s + 1], dec.decode_attention(
            qw[:, s:s + 1], *one, 600 + s, *sc)) for s in range(5))
        e = max_err(win, dec.cached_attention_plain(qw, *one, 600, *sc))
        print(f"decode_attention_int8 window of 5 at cache_len=600 D={D}: max_abs_err "
              f"{e:.3e} against the plain window (tol {tol}); rows bitwise equal to "
              f"single-token decode: {same}")
        require(e <= tol and same, f"decode_attention_int8 window rows at D={D}")
        worst = max(worst, e)
        if D != 128:
            continue
        n_keys = sum(min(int(c) + 1, Smax) for c in frontier.tolist())
        nbytes = 2 * n_keys * KV * (D + 4) + 2 * 2 * B * H * D + 4 * B
        b_ms, b_by = bound(4 * H * D * n_keys, nbytes)
        kt = dec.dequantize_cache(kc, ks).to(BF16).transpose(1, 2).contiguous()
        vt = dec.dequantize_cache(vc, vs).to(BF16).transpose(1, 2).contiguous()
        qt = q.transpose(1, 2).contiguous()
        mask = (torch.arange(Smax, device="cuda")[None, :]
                <= frontier[:, None].long())[:, None, None, :]
        row = {
            "max_abs_err": worst,
            "ms": timer(lambda: dec.decode_attention(q, kc, vc, frontier, ks, vs)),
            "host_us": host_us(lambda: dec.decode_attention(q, kc, vc, frontier, ks, vs)),
            "plain_ms": timer(lambda: dec.decode_attention_plain(q, kc, vc, frontier,
                                                                 ks, vs)),
            "library_ms": timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"B={B} Smax={Smax} H={H} KV={KV} D={D} int8 "
                     f"cache_len={frontier.tolist()} (library: SDPA over the "
                     "dequantized bf16 cache)",
        }
    return row


def paged_pools(gen, P1: int, ps: int, KV: int, D: int, int8: bool):
    """Random K and V page pools [P1, ps, KV, D] in bf16, or int8 filled by
    ``_quantize_kv`` with their scale pools [P1, KV, ps]."""
    pools, scales = [], []
    for _ in range(2):
        x = torch.randn(P1, ps, KV, D, generator=gen, device="cuda", dtype=BF16)
        if int8:
            x, sc = _quantize_kv(x)
            scales.append(sc.transpose(1, 2).contiguous())
        pools.append(x)
    return tuple(pools), tuple(scales)


def paged_case(gen, int8: bool):
    """The serving step's attention at its full shape: N = 8 slots of R = 64
    rows, 68 logical pages of 16 tokens a slot over a pool of 8 * 68 pages
    plus the NULL page, H = 32, KV = 8, hd = 128. Physical pages are
    shuffled; slot 0 is a 64-row prefill chunk at start 448, slots 1-6 one
    decode row each at ragged frontiers (their other rows padded, frontier
    -1), slot 7 idle; logical pages past a slot's frontier name the NULL
    page. The dense operands are layer 1 of a two-layer contiguous arena
    ([2, N, 1152, KV, hd], the serving engine's layout and strides) holding
    the same bytes at every mapped position. Returns (q, pools, scales,
    page_table, frontier, dense layers, dense scale layers)."""
    N, R, mp, ps, H, KV, D = CB_SLOTS, CB_BUDGET, 68, 16, 32, 8, 128
    P = N * mp
    q = torch.randn(N * R, 1, H, D, generator=gen, device="cuda", dtype=BF16)
    (kp, vp), scales = paged_pools(gen, P + 1, ps, KV, D, int8)
    frontier = torch.full((N, R), -1, dtype=torch.int32)
    frontier[0] = 448 + torch.arange(R, dtype=torch.int32)
    frontier[1:7, 0] = torch.tensor([0, 17, 100, 333, 640, 1023], dtype=torch.int32)
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(5)).int()
    table = torch.full((N, mp), P, dtype=torch.int32)
    for n in range(N):
        used = -(-(int(frontier[n].max()) + 1) // ps)
        table[n, :used] = perm[n * mp:n * mp + used]
    table, frontier = table.cuda(), frontier.reshape(-1).cuda()
    arena = init_cache(llama("llama3-8b", num_layers=2).config, N, CB_CAPACITY, BF16,
                       "cuda", quantized=int8)
    span = mp * ps
    arena["k"][1, :, :span] = dec.gather_pages(kp, table)
    arena["v"][1, :, :span] = dec.gather_pages(vp, table)
    dense, dense_scales = (arena["k"][1], arena["v"][1]), ()
    if int8:
        arena["k_scale"][1, :, :, :span] = dec.gather_page_scales(scales[0], table)
        arena["v_scale"][1, :, :, :span] = dec.gather_page_scales(scales[1], table)
        dense_scales = (arena["k_scale"][1], arena["v_scale"][1])
    return q, (kp, vp), scales, table, frontier, dense, dense_scales


def check_paged_decode(gen, timer):
    """The paged decode kernel, bf16 and int8, against its plain version at
    the continuous-batching step's shape (:func:`paged_case`), and equal bit
    for bit to the dense decode kernel (``rows_per_seq`` = 64) over the same
    bytes laid out contiguously. Returns timed rows: the paged kernels, and
    the dense kernels at the contiguous arena's step shape."""
    tol = 1e-2
    R, ps, KV, H, D = CB_BUDGET, 16, 8, 32, 128
    rows = {}
    for int8 in (False, True):
        q, pools, scales, table, frontier, dense, dense_scales = paged_case(gen, int8)
        suffix = "_int8" if int8 else ""
        out = dec.paged_decode_attention(q, *pools, frontier, table, *scales,
                                         rows_per_seq=R)
        ref = dec.paged_decode_attention_plain(q, *pools, frontier, table, *scales,
                                               rows_per_seq=R)
        flat = dec.decode_attention(q, *dense, frontier, *dense_scales, rows_per_seq=R)
        e = max_err(out, ref)
        same = torch.equal(out, flat)
        padded = frontier < 0
        zeros = bool((out[padded] == 0).all())
        print(f"paged_decode_attention{suffix} N={CB_SLOTS} R={R} mp=68 ps={ps} H={H} "
              f"KV={KV} D={D}: max_abs_err {e:.3e} (tol {tol}); bitwise equal to the "
              f"dense kernel over the same bytes: {same}; padded rows zero: {zeros}")
        require(e <= tol and same and zeros, f"paged_decode_attention{suffix} check")
        # bound: each slot's K/V rows up to its furthest frontier, once (and,
        # int8, one fp32 scale per row and head), the q of the real rows (a
        # padded row's output is zero whatever its q), every output row, the
        # frontiers and, paged, the page table
        fr = frontier.reshape(CB_SLOTS, R).cpu()
        n_keys = sum(int(f.max()) + 1 for f in fr)
        per_row = KV * (D + 4) if int8 else KV * D * 2
        pairs = int((fr + 1).clamp_min(0).sum())
        nbytes = 2 * n_keys * per_row + 2 * H * D * int((fr >= 0).sum()) \
            + 2 * q.numel() + 4 * frontier.numel()
        b_ms, b_by = bound(4 * H * D * pairs, nbytes + 4 * table.numel())
        b_dense_ms, b_dense_by = bound(4 * H * D * pairs, nbytes)
        # library: the page gather and SDPA with the frontier mask over the
        # per-slot views (the gather inside the time; int8 dequantized too)
        qt = q.reshape(CB_SLOTS, R, H, D).transpose(1, 2).contiguous()
        masks = {n: (torch.arange(n, device="cuda")[None, None, :]
                     <= frontier.reshape(CB_SLOTS, R)[:, :, None].long())[:, None]
                 for n in (table.shape[1] * ps, CB_CAPACITY)}

        def library(views=None):
            kv = views or (dec.gather_pages(pools[0], table), dec.gather_pages(pools[1], table))
            if int8 and views is None:
                kv = tuple(dec.dequantize_cache(c, dec.gather_page_scales(s, table)).to(BF16)
                           for c, s in zip(kv, scales))
            kt, vt = (c.transpose(1, 2) for c in kv)
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=masks[kt.shape[2]],
                                                  enable_gqa=True)

        shape = (f"N={CB_SLOTS} R={R} mp=68 ps={ps} H={H} KV={KV} D={D}"
                 f"{' int8' if int8 else ''}; slot 0 a 64-row chunk at 448, six "
                 "decode rows at [0, 17, 100, 333, 640, 1023], one idle slot")
        rows[f"paged_decode_attention{suffix}"] = {
            "max_abs_err": e,
            "ms": timer(lambda: dec.paged_decode_attention(
                q, *pools, frontier, table, *scales, rows_per_seq=R)),
            "host_us": host_us(lambda: dec.paged_decode_attention(
                q, *pools, frontier, table, *scales, rows_per_seq=R)),
            "plain_ms": timer(lambda: dec.paged_decode_attention_plain(
                q, *pools, frontier, table, *scales, rows_per_seq=R)),
            "library_ms": timer(library),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": shape + " (library: page gather" + (" and dequantize" if int8 else "")
                     + " inside the time, then masked SDPA)",
        }
        # the contiguous arena's step: the dense kernel with rows_per_seq
        e_dense = max_err(flat, dec.decode_attention_plain(
            q, *dense, frontier, *dense_scales, rows_per_seq=R))
        require(e_dense <= tol, f"decode_attention{suffix} rows_per_seq disagrees")
        lib_views = (tuple(dec.dequantize_cache(c, s).to(BF16)
                           for c, s in zip(dense, dense_scales)) if int8 else dense)
        rows[f"decode_attention{suffix}"] = {
            "max_abs_err": e_dense,
            "ms": timer(lambda: dec.decode_attention(q, *dense, frontier, *dense_scales,
                                                     rows_per_seq=R)),
            "host_us": host_us(lambda: dec.decode_attention(q, *dense, frontier,
                                                            *dense_scales, rows_per_seq=R)),
            "plain_ms": timer(lambda: dec.decode_attention_plain(
                q, *dense, frontier, *dense_scales, rows_per_seq=R)),
            "library_ms": timer(lambda: library(lib_views)),
            "bound_ms": b_dense_ms, "bound_by": b_dense_by,
            "shape": shape.replace("mp=68 ps=16", f"Smax={CB_CAPACITY}, one layer of "
                                   "the contiguous arena")
                     + " (library: masked SDPA" + (" over the dequantized cache"
                                                   if int8 else "") + ")",
        }
        del q, pools, scales, dense, dense_scales
        torch.cuda.empty_cache()
    return rows


def host_us(fn, calls: int = 300) -> float:
    """A wrapper's host time per call, in us: ``calls`` calls back to back
    on the host clock, no synchronize inside (the card runs behind)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    per_call = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return per_call


def check_decode_edges():
    """The decode kernel's split and tile edges (the key tiles of 64 split
    over the 8 blocks of a cluster), each case run twice, bitwise equal, and
    held to its plain version within 1e-2: frontiers on and either side of a
    tile and of a whole turn of the cluster (63, 64, 511, 512, 1023 of a 1024
    cache), B=1 with KV=8 at 4095 of a 4096 cache, GQA groups 1, 4 and 8,
    head dim 64; then windows (rows_per_seq 20: two row tiles of a sequence
    at G = 4, their rows at scattered frontiers, the second row tile of one
    sequence all padding) in bf16 and int8, dense and paged, each row bitwise
    the single-token decode at its frontier and the padded rows zero."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    tol = 1e-2

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=BF16)

    def frontiers(values):
        return torch.tensor(values, dtype=torch.int32, device="cuda")

    for label, H, KV, D, Smax, fr in (
            ("tile and split edges", 32, 8, 128, 1024, [63, 64, 511, 512, 1023]),
            ("B=1 KV=8, 4096 cache", 32, 8, 128, 4096, [4095]),
            ("G=1", 8, 8, 128, 1024, [0, 63, 700]),
            ("G=8", 64, 8, 128, 1024, [64, 512, 1023]),
            ("G=4 D=64", 32, 8, 64, 1024, [511, 512, 1000])):
        B = len(fr)
        q, kc, vc = rand(B, 1, H, D), rand(B, Smax, KV, D), rand(B, Smax, KV, D)
        cl = frontiers(fr)
        out = dec.decode_attention(q, kc, vc, cl)
        same = torch.equal(out, dec.decode_attention(q, kc, vc, cl))
        e = max_err(out, dec.decode_attention_plain(q, kc, vc, cl))
        print(f"decode edges, {label} (H={H} KV={KV} D={D} Smax={Smax} frontiers {fr}): "
              f"max_abs_err {e:.3e} (tol {tol}); rerun bitwise equal: {same}")
        require(e <= tol and same, f"decode edges: {label}")
    N, R, H, KV, D, Smax, ps = 2, 20, 32, 8, 128, 1024, 16
    mp = Smax // ps
    fr = frontiers([63, 64, 0, 511, 512, 1023, -1, 100, 700, 63, 65, 127, 128, 129, 300,
                    511, 512, 513, 1000, 2]
                   + [5, 600, 64, 63, 1023, 0, 17, 511, 512, 900, 128, 127, 40, 41, 42, 43]
                   + [-1] * 4)
    table = torch.randperm(N * mp, generator=torch.Generator().manual_seed(23)).int()
    table = table.reshape(N, mp).cuda()
    q = rand(N * R, 1, H, D)
    for int8 in (False, True):
        pools, scales = paged_pools(gen, N * mp + 1, ps, KV, D, int8)
        dense = tuple(dec.gather_pages(p, table) for p in pools)
        dense_scales = tuple(dec.gather_page_scales(sc, table) for sc in scales)
        for paged in (False, True):
            if paged:
                def run(rows, cl, seq, rps):
                    return dec.paged_decode_attention(rows, *pools, cl, table[seq], *scales,
                                                      rows_per_seq=rps)
            else:
                def run(rows, cl, seq, rps):
                    return dec.decode_attention(rows, *(c[seq] for c in dense), cl,
                                                *(sc[seq] for sc in dense_scales),
                                                rows_per_seq=rps)
            everything = slice(0, N)
            win = run(q, fr, everything, R)
            rerun = torch.equal(win, run(q, fr, everything, R))
            single = all(torch.equal(win[r:r + 1], run(q[r:r + 1], fr[r:r + 1],
                                                        slice(r // R, r // R + 1), 1))
                         for r in range(N * R))
            zeros = bool((win[fr < 0] == 0).all())
            ref = dec.decode_attention_plain(q, *dense, fr, *dense_scales, rows_per_seq=R)
            e = max_err(win, ref)
            label = f"{'paged' if paged else 'dense'} {'int8' if int8 else 'bf16'}"
            print(f"decode edges, window {label} N={N} R={R} H={H} KV={KV} D={D}: max_abs_err "
                  f"{e:.3e} (tol {tol}); rerun bitwise equal: {rerun}; each row bitwise its "
                  f"single-token decode: {single}; padded rows (a whole row tile) zero: "
                  f"{zeros}")
            require(e <= tol and rerun and single and zeros, f"decode edges: window {label}")


def norm_agrees(name: str, fn, plain, x: torch.Tensor, atol: float, rtol: float) -> float:
    """A norm forward against its plain version on x: within atol + rtol *
    |plain| everywhere, a rerun bitwise equal, and the first, middle and last
    rows each run alone bitwise their rows of the batch (the sum order is
    fixed by D). Returns the max abs error."""
    out, ref = fn(x), plain(x)
    e = max_err(out, ref)
    ok = bool(((out.float() - ref.float()).abs() <= atol + rtol * ref.float().abs()).all())
    same = torch.equal(out, fn(x))
    picks = sorted({0, x.shape[0] // 2, x.shape[0] - 1})
    alone = all(torch.equal(out[r:r + 1], fn(x[r:r + 1].clone())) for r in picks)
    print(f"{name} x {x.dtype} rows={x.shape[0]} D={x.shape[1]}: max_abs_err {e:.3e} "
          f"(tol {atol} + {rtol}*|ref|); rerun bitwise equal: {same}; rows {picks} "
          f"alone bitwise: {alone}")
    require(ok and same and alone, f"{name} disagrees at rows={x.shape[0]} D={x.shape[1]}")
    return e


def norm_row(timer, e: float, fn, plain, library, b_ms: float, b_by: str, shape: str,
             host: bool = False) -> dict:
    """One timed row of a norm forward (with host, the wrapper's host us a
    call too)."""
    row = {"max_abs_err": e, "ms": timer(fn), "plain_ms": timer(plain),
           "library_ms": timer(library), "bound_ms": b_ms, "bound_by": b_by, "shape": shape}
    if host:
        row["host_us"] = host_us(fn)
    return row


def check_rmsnorm(gen, timer):
    """The RMSNorm forward at the main paths' shapes: serving (the B=4 x
    512 prefill of hidden 4096), training (the llama3-1b micro-batch's 8192
    rows of hidden 2048), the continuous-batching step (8 slots x 64 rows)
    and the decode steps' 1 and 4 rows (timed with the wrapper's host us a
    call); then the fp32 and mixed forms and rows too wide for registers
    (D = 16384 bf16, 20480 fp32). Returns one timed row per path, and the
    decode rows under "decode rows=N". The main paths' shapes and the 4
    decode rows draw from gen, in the order the later checks' draws follow;
    the rest from a generator of their own."""
    eps = 1e-5
    atol, rtol = 1e-3, 1.6e-2  # two bf16 ulps of the plain result
    own = torch.Generator(device="cuda").manual_seed(47)
    rows = {}
    for path, n, D, g in (("serving", 4 * 512, 4096, gen), ("decode rows=4", 4, 4096, gen),
                          ("training", TRAIN_B * TRAIN_S, 2048, gen),
                          ("serving_cb", CB_SLOTS * CB_BUDGET, 4096, gen),
                          ("decode rows=1", 1, 4096, own)):
        w = (1 + 0.1 * torch.randn(D, generator=g, device="cuda")).to(BF16)
        x = torch.randn(n, D, generator=g, device="cuda", dtype=BF16)
        fn = lambda t: rn.rmsnorm_fwd(t, w, eps)  # noqa: E731
        plain = lambda t: rn.rmsnorm_plain(t, w, eps)  # noqa: E731
        e = norm_agrees("rmsnorm_fwd", fn, plain, x, atol, rtol)
        rows[path] = norm_row(timer, e, lambda: fn(x), lambda: plain(x),
                              lambda: F.rms_norm(x, (D,), w, eps),
                              *bound(4 * x.numel(), 2 * 2 * x.numel() + 2 * D),
                              f"rows={n} D={D} bf16", host=path.startswith("decode"))
    for xd, wd, n, D in ((torch.float32, torch.float32, 5, 4096),
                         (torch.float32, BF16, 300, 2048), (BF16, torch.float32, 4, 4096),
                         (BF16, BF16, 3, 16384), (torch.float32, torch.float32, 2, 20480)):
        w = (1 + 0.1 * torch.randn(D, generator=own, device="cuda")).to(wd)
        x = torch.randn(n, D, generator=own, device="cuda").to(xd)
        norm_agrees(f"rmsnorm_fwd w {wd}", lambda t: rn.rmsnorm_fwd(t, w, eps),
                    lambda t: rn.rmsnorm_plain(t, w, eps), x,
                    *((atol, rtol) if xd == BF16 else (1e-4, 0.0)))
    return rows


def rmsnorm_bwd_agrees(name: str, x, w, g, eps: float, atol: float, rtol: float,
                       ds_rel: float):
    """The RMSNorm backward against its plain version on (x, w, g): dx within
    atol + rtol * |plain| everywhere, dscale within ds_rel of its largest
    value, a rerun bitwise equal, and the first, middle and last rows each
    run alone with dx bitwise its row of the batch (a row's sums run in an
    order fixed by D). Returns (dx, dscale) errors."""
    dx, ds = rn.rmsnorm_bwd(x, w, g, eps)
    rdx, rds = rn.rmsnorm_bwd_plain(x, w, g, eps)
    e_dx, e_ds = max_err(dx, rdx), max_err(ds, rds)
    ok_dx = bool(((dx.float() - rdx.float()).abs() <= atol + rtol * rdx.float().abs()).all())
    tol_ds = ds_rel * rds.abs().max().item()
    again = rn.rmsnorm_bwd(x, w, g, eps)
    same = torch.equal(dx, again[0]) and torch.equal(ds, again[1])
    picks = sorted({0, x.shape[0] // 2, x.shape[0] - 1})
    alone = all(torch.equal(dx[r:r + 1], rn.rmsnorm_bwd(x[r:r + 1].clone(), w,
                                                         g[r:r + 1].clone(), eps)[0])
                for r in picks)
    print(f"{name} x {x.dtype} w {w.dtype} rows={x.shape[0]} D={x.shape[1]}: max_abs_err "
          f"dx {e_dx:.3e} (tol {atol} + {rtol}*|ref|) dscale {e_ds:.3e} (tol {ds_rel}*max|ref| "
          f"= {tol_ds:.3e}); rerun bitwise equal: {same}; rows {picks} alone bitwise: {alone}")
    require(ok_dx and e_ds <= tol_ds and same and alone,
            f"{name} disagrees at rows={x.shape[0]} D={x.shape[1]}")
    return e_dx, e_ds


def library_kernels(fn, label: str) -> None:
    """Print the kernels one call of ``fn`` launches, with their device time
    from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]

    def us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    print(f"{label}: {sum(e.count for e in dev)} kernels, {sum(us(e) for e in dev):.1f} us "
          "of device time (profiler): " + "; ".join(
              f"{e.key[:60]} x{e.count} {us(e):.1f} us" for e in dev))


def check_rmsnorm_bwd(gen, timer):
    """The backward at the training path's shape: the llama3-1b micro-batch's
    8192 rows of hidden 2048, bf16 x, g and scale (timed, beside a
    torch.add(x, g) of the same bytes, the wrapper's host us a call, and the
    library call's time in three runs with the kernels it launches); then,
    from a generator of their own, ragged row counts, the teams of one to
    sixteen warps, fp32 and mixed forms and the widest rows the wrapper
    takes (D 16384 bf16, 8192 fp32). Every case is rerun bitwise and its
    first, middle and last rows alone bitwise their dx in the batch."""
    rows, D, eps = TRAIN_B * TRAIN_S, 2048, 1e-5
    atol, rtol = 1e-3, 1.6e-2  # dx: two bf16 ulps of the plain result
    ds_rel = 1e-5  # dscale: fp32 sums over the rows in another order
    x = torch.randn(rows, D, generator=gen, device="cuda", dtype=BF16)
    w = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(BF16)
    g = torch.randn(rows, D, generator=gen, device="cuda", dtype=BF16)
    e_dx, e_ds = rmsnorm_bwd_agrees("rmsnorm_bwd", x, w, g, eps, atol, rtol, ds_rel)
    own = torch.Generator(device="cuda").manual_seed(61)
    F32 = torch.float32
    for xd, wd, n, Dn in ((BF16, BF16, 1, 2048), (BF16, BF16, 5, 2048), (BF16, BF16, 37, 2048),
                          (BF16, BF16, 300, 2048), (BF16, BF16, 40, 128),
                          (BF16, BF16, 300, 4096), (BF16, F32, 33, 8192),
                          (F32, F32, 300, 1600), (F32, BF16, 7, 4096),
                          (BF16, BF16, 3, 16384), (BF16, BF16, 130, 16384),
                          (F32, F32, 5, 8192), (F32, BF16, 70, 8192)):
        xx = torch.randn(n, Dn, generator=own, device="cuda").to(xd)
        gg = torch.randn(n, Dn, generator=own, device="cuda").to(xd)
        ww = (1 + 0.1 * torch.randn(Dn, generator=own, device="cuda")).to(wd)
        rmsnorm_bwd_agrees("rmsnorm_bwd", xx, ww, gg, eps,
                           *((atol, rtol) if xd == BF16 else (1e-4, 0.0)), ds_rel)
    xr, wr = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
    lib_out = F.rms_norm(xr, (D,), wr, eps)

    def library():
        return torch.autograd.grad(lib_out, (xr, wr), g, retain_graph=True)

    lib_runs = [timer(library) for _ in range(3)]
    print(f"rmsnorm_bwd library (F.rms_norm backward, torch.autograd.grad) rows={rows} D={D}: "
          f"{lib_runs} ms in three runs (Timer)")
    library_kernels(library, "rmsnorm_bwd library call")
    library_kernels(lambda: rn.rmsnorm_bwd(x, w, g, eps), "rmsnorm_bwd wrapper call")
    y = torch.empty_like(x)
    add_ms = timer(lambda: torch.add(x, g, out=y))
    b_ms, b_by = bound(10 * x.numel(), 3 * 2 * x.numel() + 2 * D + 4 * D)
    ms = timer(lambda: rn.rmsnorm_bwd(x, w, g, eps))
    print(f"rmsnorm_bwd rows={rows} D={D}: kernel {ms:.4f} ms, torch.add(x, g) of the same "
          f"bytes {add_ms:.4f} ms ({ms / add_ms:.3f}x)")
    return {
        "max_abs_err": max(e_dx, e_ds),
        "ms": ms,
        "plain_ms": timer(lambda: rn.rmsnorm_bwd_plain(x, w, g, eps)),
        "library_ms": statistics.median(lib_runs),
        "bound_ms": b_ms, "bound_by": b_by,
        "host_us": host_us(lambda: rn.rmsnorm_bwd(x, w, g, eps)),
        "shape": f"rows={rows} D={D} bf16 (library: F.rms_norm backward, median of three "
                 "runs)",
    }


def check_flash_bwd(gen, timer, D: int = 64, B: int = TRAIN_B, S: int = TRAIN_S,
                    plain_iters: int = 20, dtype=BF16):
    """The dq and dk/dv kernels at a training path's shape (micro-batch
    ``B`` x ``S``, 32 query / 8 kv heads: llama3-1b's of 64 by default,
    Mixtral's and Llama-3-8B's of 128 with ``D=128``), causal. The dk/dv
    kernel gets the plain version's delta, so each kernel is held alone;
    the plain versions are timed over ``plain_iters`` launches. ``dtype``
    float16: the fp16 Llama forms, held to an eighth of bf16's tolerance."""
    H, KV = 32, 8
    # of the largest gradient: p and ds round to bf16 (fp16) before the products
    tol = 2e-2 if dtype == BF16 else FP16_TOL_BWD
    tol_delta = 1e-4  # of the largest delta: an fp32 row sum in another order

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)

    q, k, v, do = rand(B, S, H, D), rand(B, S, KV, D), rand(B, S, KV, D), rand(B, S, H, D)
    o, lse = fa.flash_attention_fwd(q, k, v)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do)
    rdq, rdelta = fa.flash_attention_bwd_dq_plain(q, k, v, o, lse, do)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, rdelta, do)
    rdk, rdv = fa.flash_attention_bwd_dkv_plain(q, k, v, lse, rdelta, do)
    errs = {name: (max_err(a, r), r.float().abs().max().item())
            for name, a, r in (("dq", dq, rdq), ("delta", delta, rdelta),
                               ("dk", dk, rdk), ("dv", dv, rdv))}
    print(f"flash_attention_bwd {dtype} B={B} S={S} H={H} KV={KV} D={D} causal: "
          + ", ".join(f"{n} max_abs_err {e:.3e} (max|ref| {m:.3e})"
                      for n, (e, m) in errs.items())
          + f"; tol {tol}*max|ref| ({tol_delta} for delta)")
    for name, (e, m) in errs.items():
        require(e <= (tol_delta if name == "delta" else tol) * m,
                f"flash_attention_bwd {name} disagrees with its plain version")
    del dq, delta, dk, dv, rdq, rdk, rdv
    torch.cuda.empty_cache()
    pairs = B * H * S * (S + 1) / 2
    rows = 4 * B * H * S  # one fp32 [B, H, S] tensor, bytes
    qkvo = 2 * (2 * q.numel() + k.numel() + v.numel())  # q, o (or do), k, v
    b_dq = bound(6 * D * pairs, qkvo + 2 * do.numel() + 2 * q.numel() + 2 * rows)
    b_dkv = bound(8 * D * pairs, 2 * (q.numel() + k.numel() + v.numel() + do.numel())
                  + 2 * (k.numel() + v.numel()) + 2 * rows)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    lib_ms = timer(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                               retain_graph=True))
    shape = f"B={B} S={S} H={H} KV={KV} D={D} causal" + ("" if dtype == BF16 else " fp16")
    dq_r = {
        "max_abs_err": errs["dq"][0],
        "ms": timer(lambda: fa.flash_attention_bwd_dq(q, k, v, o, lse, do)),
        "plain_ms": timer(lambda: fa.flash_attention_bwd_dq_plain(q, k, v, o, lse, do),
                          iters=plain_iters),
        "library_ms": lib_ms, "bound_ms": b_dq[0], "bound_by": b_dq[1],
        "shape": shape + " (library: SDPA backward, dq+dk+dv)",
    }
    dkv_r = {
        "max_abs_err": max(errs["dk"][0], errs["dv"][0]),
        "ms": timer(lambda: fa.flash_attention_bwd_dkv(q, k, v, lse, rdelta, do)),
        "plain_ms": timer(lambda: fa.flash_attention_bwd_dkv_plain(q, k, v, lse,
                                                                   rdelta, do),
                          iters=plain_iters),
        "library_ms": lib_ms, "bound_ms": b_dkv[0], "bound_by": b_dkv[1],
        "shape": shape + " (library: SDPA backward, dq+dk+dv)",
    }
    return dq_r, dkv_r


def object_listing(stem: str, ptx_marks, sass_marks):
    """(text, function header, marks) of the built object ``stem``.o: its
    ``cuobjdump --dump-sass`` with ``sass_marks``, or, without cuobjdump, its
    PTX with ``ptx_marks``."""
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if tool.exists():
        text = subprocess.run([str(tool), "--dump-sass", str(_build.BUILD_DIR / f"{stem}.o")],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        return text, "Function : ", sass_marks
    ptx = _build.BUILD_DIR / f"{stem}.ptx"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS[:4], "-ptx", "-o", str(ptx),
                    str(_build.CSRC / f"{stem}.cu")], check=True, timeout=600)
    return ptx.read_text(), ".entry ", ptx_marks


def count_marks(text: str, head: str, marks, name_of) -> dict:
    """Lines holding each mark, per function whose header ``name_of`` names."""
    counts, fn = {}, None
    for line in text.splitlines():
        if head in line:
            fn = name_of(line)
            if fn:
                counts[fn] = {mark: 0 for mark in marks}
        elif fn:
            for mark in marks:
                counts[fn][mark] += mark in line
    return counts


def flash_instruction_counts() -> dict:
    """HGMMA (wgmma) and UTMALDG (TMA tile load) instructions in each
    instantiation of the flash forward, the two backward kernels and the
    bias-gradient kernel, from ``cuobjdump --dump-sass`` of the built objects
    (or, without cuobjdump, the wgmma and cp.async.bulk.tensor lines of their
    PTX). Keyed "flash_fwd_kernel<64, alibi=0, masked=0>",
    "flash_bwd_dq_kernel<64, masked=0>", "flash_bias_grad_kernel<64>" and so
    on, the fp16 instantiations with ", fp16" at the end."""
    name_re = re.compile(
        r"(flash_(?:fwd|bwd_dq|bwd_dkv|bias_grad)_kernel)ILi(\d+)E(?:(?:Lb([01])E)?Lb([01])E)?"
        r"(6__half)?")

    def name_of(line):
        m = name_re.search(line)
        if not m:
            return None
        if m.group(4) is None:
            return f"{m.group(1)}<{m.group(2)}>"
        alibi = f"alibi={m.group(3)}, " if m.group(3) is not None else ""
        f16 = ", fp16" if m.group(5) else ""
        return f"{m.group(1)}<{m.group(2)}, {alibi}masked={m.group(4)}{f16}>"

    counts = {}
    for stem in ("flash_attention_fwd", "flash_attention_bwd", "flash_attention_bias_grad",
                 "flash_attention_fwd_f16", "flash_attention_bwd_f16"):
        counts.update(count_marks(*object_listing(
            stem, ("wgmma.mma_async", "cp.async.bulk.tensor"), ("HGMMA", "UTMALDG")),
            name_of))
    return counts


def decode_instruction_counts() -> dict:
    """HMMA (mma.sync) instructions in each bf16 instantiation of the decode
    kernel, from cuobjdump (or the mma.sync lines of its PTX). Keyed
    "decode_attention_kernel<bf16, int8=0, hd=128, paged=0>"."""
    name_re = re.compile(r"decode_attention_kernelI13__nv_bfloat16(a|S\d*_)Li(\d+)ELb([01])E")

    def name_of(line):
        m = name_re.search(line)
        if not m:
            return None
        return (f"decode_attention_kernel<bf16, int8={int(m.group(1) == 'a')}, "
                f"hd={m.group(2)}, paged={m.group(3)}>")

    return count_marks(*object_listing("decode_attention", ("mma.sync",), ("HMMA",)), name_of)


def matvec_instruction_counts() -> dict:
    """HMMA (mma.sync) instructions in each instantiation of the packed
    matvec, from cuobjdump (or the mma.sync lines of its PTX). Keyed
    "quantized_matvec_kernel<halves=1, int4=0, tma=1>" (halves: 8-row halves
    of x; tma: the weight streamed by TMA, else by per-thread cp.async)."""
    name_re = re.compile(r"quantized_matvec_kernelILi(\d+)ELb([01])ELb([01])E")

    def name_of(line):
        m = name_re.search(line)
        return m and (f"quantized_matvec_kernel<halves={m.group(1)}, int4={m.group(2)}, "
                      f"tma={m.group(3)}>")

    return count_marks(*object_listing("quantized_matvec", ("mma.sync",), ("HMMA",)), name_of)


def check_matvec_instructions() -> None:
    """Every instantiation of the packed matvec (int8 and int4 bytes, one or
    two 8-row halves of x, TMA or per-thread copies) runs its products on
    the tensor cores."""
    counts = matvec_instruction_counts()
    for fn, c in sorted(counts.items()):
        print(f"{fn}: " + ", ".join(f"{k} {n}" for k, n in c.items()))
    require(len(counts) == 8, f"expected 8 matvec instantiations, found {counts}")
    require(all(n > 0 for c in counts.values() for n in c.values()),
            "a matvec kernel issues no mma.sync")


def check_flash_instructions() -> None:
    """The flash forward (Llama, ALiBi and masked forms), both backward
    kernels and the bias-gradient kernel, in every instantiation at head dims
    64 and 128, and the fp16 Llama forms of the forward and both backward
    kernels, issue wgmma and load their tiles by TMA."""
    counts = flash_instruction_counts()
    for fn, c in sorted(counts.items()):
        print(f"{fn}: " + ", ".join(f"{k} {n}" for k, n in c.items()))
    n_fwd = sum(fn.startswith("flash_fwd") for fn in counts)
    n_bg = sum(fn.startswith("flash_bias_grad") for fn in counts)
    n_f16 = sum(fn.endswith(", fp16>") for fn in counts)
    require(n_fwd == 8 and n_bg == 2 and n_f16 == 6 and len(counts) == 22,
            f"expected 8 forward (2 fp16), 12 backward (4 fp16) and 2 bias-gradient kernel "
            f"instantiations, found {counts}")
    require(all(n > 0 for c in counts.values() for n in c.values()),
            "a flash kernel issues no wgmma or no TMA load")


def check_decode_instructions() -> None:
    """Every bf16 instantiation of the decode kernel (dense and paged, bf16
    and int8 cache, head dims 64 and 128) runs its products on the tensor
    cores (mma.sync)."""
    counts = decode_instruction_counts()
    for fn, c in sorted(counts.items()):
        print(f"{fn}: " + ", ".join(f"{k} {n}" for k, n in c.items()))
    require(len(counts) == 8, f"expected 8 bf16 decode instantiations, found {counts}")
    require(all(n > 0 for c in counts.values() for n in c.values()),
            "a bf16 decode kernel issues no mma.sync")


def check_bwd_tiles(gen):
    """The backward kernels' tile walk on the card, each case against the
    plain version (dq, dk, dv within 2e-2 of the largest gradient, delta
    1e-4): ragged S (300, 130) at head dims 128 and 64 with GQA groups 1, 4
    and 8; packed segments with boundaries on tile edges (64, 128, 448) and
    inside a tile (476), so that tiles are wholly inside one document (full),
    straddle a boundary (partial) or lie wholly across two documents
    (skipped); a future ring hop, whose gradients must be exactly zero; and
    two runs of every case, which must be bitwise equal."""
    tol, tol_delta = 2e-2, 1e-4

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=BF16)

    docs = [64, 64, 320, 28, 36]
    seg = torch.tensor(np.repeat(np.arange(len(docs)), docs)[None].repeat(2, 0),
                       dtype=torch.int32, device="cuda")
    cases = [("ragged", 2, 300, 8, 8, 128, True, {}),
             ("ragged", 1, 130, 16, 4, 128, True, {}),
             ("ragged", 2, 300, 16, 2, 128, False, {}),
             ("ragged", 1, 130, 8, 1, 64, True, {}),
             ("ragged", 2, 300, 32, 8, 64, True, {}),
             ("segments", 2, 512, 8, 2, 64, True, {"segment_ids": seg}),
             ("segments", 2, 512, 8, 8, 128, True, {"segment_ids": seg}),
             ("future hop", 1, 512, 8, 2, 64, True, {"offsets": (0, 512)}),
             ("future hop", 1, 512, 8, 2, 64, True, {"offsets": (0, 512),
                                                     "segment_ids": seg[:1]})]
    for label, B, S, H, KV, D, causal, kw in cases:
        q, k, v, do = rand(B, S, H, D), rand(B, S, KV, D), rand(B, S, KV, D), rand(B, S, H, D)
        o, lse = fa.flash_attention_plain(q, k, v, causal, **kw)
        runs = []
        for _ in range(2):
            dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, causal, **kw)
            runs.append((dq, delta,
                         *fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, causal, **kw)))
        rdq, rdelta = fa.flash_attention_bwd_dq_plain(q, k, v, o, lse, do, causal, **kw)
        rdk, rdv = fa.flash_attention_bwd_dkv_plain(q, k, v, lse, rdelta, do, causal, **kw)
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        errs = []
        for n, a, w in zip(("dq", "delta", "dk", "dv"), runs[0], (rdq, rdelta, rdk, rdv)):
            e, m = max_err(a, w), w.float().abs().max().item()
            errs.append((n, e, (tol_delta if n == "delta" else tol) * m))
        name = f"flash_bwd {label} B={B} S={S} H={H} KV={KV} D={D} causal={causal}" + (
            f" {sorted(kw)}" if kw else "")
        print(f"{name}: " + ", ".join(f"{n} max_abs_err {e:.3e} (tol {t:.3e})"
                                      for n, e, t in errs)
              + f"; two runs bitwise equal: {same}")
        require(same, f"{name}: two runs differ")
        for n, e, t in errs:
            require(e <= t, f"{name}: {n} disagrees with its plain version")
        if label == "future hop":
            zero = all(int(torch.count_nonzero(t)) == 0 for t in (runs[0][0], *runs[0][2:]))
            print(f"{name}: dq, dk, dv exactly zero: {zero}")
            require(zero, f"{name}: a future hop's gradients are not exactly zero")
        del q, k, v, do, o, lse, runs
    torch.cuda.empty_cache()


def check_fwd_tiles(gen):
    """The forward kernel's tile walk on the card, each case against the
    plain version (out within 2e-2, lse 1e-3, as check_flash) and run twice,
    bitwise equal: ragged S (130, 300) at head dims 64 and 128 with GQA
    groups 1, 4 and 8, causal and not; packed segments with boundaries on
    the tile edges (128, 192, 512, 768) and inside a tile (540, 576), so that
    key tiles are full, partial or empty for a 64-row consumer and for the
    whole 128-row block; the diagonal, a past and a future ring hop, with
    and without segment ids (the future hop: out exactly 0, lse exactly
    -1e30); a dense bias of each broadcast shape, fp32 and bf16, and one
    whose rows are not 16-byte multiples (S = 130); and the "bigbird"
    layout with segment ids."""
    tol_out, tol_lse = 2e-2, 1e-3

    def rand(*shape, dtype=BF16):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)

    docs = [128, 64, 320, 28, 36, 192, 256]
    ids = np.repeat(np.arange(len(docs)), docs)
    seg = torch.tensor(ids[None].repeat(2, 0), dtype=torch.int32, device="cuda")
    hop_seg = (seg[:1, :512].contiguous(), seg[1:, 512:].contiguous())
    bigbird = sparse_layout(BigBirdSparsityConfig(block=128), 1024, True)
    cases = [("ragged", 2, 300, 8, 8, 128, True, {}),
             ("ragged", 1, 130, 16, 4, 128, True, {}),
             ("ragged", 2, 300, 16, 2, 128, False, {}),
             ("ragged", 1, 130, 8, 1, 64, True, {}),
             ("ragged", 2, 300, 32, 8, 64, True, {}),
             ("ragged", 1, 130, 8, 8, 64, False, {}),
             ("segments", 2, 1024, 8, 2, 64, True, {"segment_ids": seg}),
             ("segments", 2, 1024, 8, 8, 128, True, {"segment_ids": seg}),
             ("segments", 2, 1024, 8, 1, 64, False, {"segment_ids": seg}),
             ("bigbird + segments", 2, 1024, 8, 2, 64, True,
              {"layout": bigbird, "segment_ids": seg})]
    for hop, off in (("diagonal", (512, 512)), ("past", (512, 0)), ("future", (0, 512))):
        for kw in ({}, {"segment_ids": hop_seg}):
            cases.append((f"{hop} hop", 1, 512, 8, 2, 64, True, {"offsets": off, **kw}))
    for shape in ((1, 8, 384, 384), (2, 1, 384, 384), (2, 8, 384, 384), (1, 1, 384, 384)):
        for dtype in (torch.float32, BF16):
            bias = (0.5 * rand(*shape, dtype=torch.float32)).to(dtype)
            cases.append((f"bias {list(shape)} {dtype}", 2, 384, 8, 8, 128, True,
                          {"bias": bias, "segment_ids": seg[:, :384].contiguous()}))
    cases.append(("bias, rows not 16-byte multiples", 1, 130, 4, 4, 64, True,
                  {"bias": rand(1, 4, 130, 130, dtype=torch.float32)}))
    for label, B, S, H, KV, D, causal, kw in cases:
        q, k, v = rand(B, S, H, D), rand(B, S, KV, D), rand(B, S, KV, D)
        runs = [fa.flash_attention_fwd(q, k, v, causal, **kw) for _ in range(2)]
        ref, ref_lse = fa.flash_attention_plain(q, k, v, causal, **kw)
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        e_out, e_lse = max_err(runs[0][0], ref), max_err(runs[0][1], ref_lse)
        name = (f"flash_fwd {label} B={B} S={S} H={H} KV={KV} D={D} causal={causal}"
                + (f" {sorted(kw)}" if kw else ""))
        print(f"{name}: out max_abs_err {e_out:.3e} (tol {tol_out}), lse {e_lse:.3e} "
              f"(tol {tol_lse}); two runs bitwise equal: {same}")
        require(same, f"{name}: two runs differ")
        require(e_out <= tol_out and e_lse <= tol_lse,
                f"{name}: disagrees with its plain version")
        if label == "future hop":
            empty = not runs[0][0].any() and bool((runs[0][1] == -1e30).all())
            print(f"{name}: out exactly 0 and lse exactly -1e30: {empty}")
            require(empty, f"{name}: a future hop wrote something")
        del q, k, v, runs, ref, ref_lse
    torch.cuda.empty_cache()


def check_fused_adam(gen, timer, n: int = 16 * 2048 * 8192):
    """One update of a training path's largest leaf (llama3-1b: the stacked
    MLP weight, 16 x 2048 x 8192 fp32; bloom-560m: the tied token table,
    250880 x 1024), clip factor 0.5 from the device."""
    tol_p, tol_mv = 1e-6, 1e-6  # p: 1 % of an lr-1e-4 step; m, v: of max|ref|
    kw = dict(lr=TRAIN_LR, b1=0.9, b2=0.999, eps=1e-8, wd=0.01,
              bc1=1 - 0.9 ** 3, bc2=1 - 0.999 ** 3,
              clip=torch.tensor(0.5, device="cuda"))
    p = 0.02 * torch.randn(n, generator=gen, device="cuda")
    g = 1e-3 * torch.randn(n, generator=gen, device="cuda")
    m = 1e-4 * torch.randn(n, generator=gen, device="cuda")
    v = 1e-8 * torch.rand(n, generator=gen, device="cuda")
    p2, m2, v2 = p.clone(), m.clone(), v.clone()
    fad.adam_update(p, g, m, v, **kw)
    fad.adam_update_plain(p2, g, m2, v2, **kw)
    e_p, e_m, e_v = max_err(p, p2), max_err(m, m2), max_err(v, v2)
    print(f"fused_adam n={n}: max_abs_err p {e_p:.3e} (tol {tol_p}) m {e_m:.3e} "
          f"v {e_v:.3e} (tol {tol_mv}*max|ref|)")
    require(e_p <= tol_p and e_m <= tol_mv * m2.abs().max().item()
            and e_v <= tol_mv * v2.abs().max().item(),
            "fused_adam disagrees with its plain version")
    del p2, m2, v2
    lib_p = torch.nn.Parameter(p.clone())
    lib_p.grad = g.clone()
    lib_opt = torch.optim.AdamW([lib_p], lr=TRAIN_LR, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=0.01, foreach=True)
    lib_opt.step()  # state
    b_ms, b_by = bound(15 * n, 28 * n)
    r = {
        "max_abs_err": e_p,
        "ms": timer(lambda: fad.adam_update(p, g, m, v, **kw)),
        "plain_ms": timer(lambda: fad.adam_update_plain(p, g, m, v, **kw)),
        "library_ms": timer(lib_opt.step),
        "bound_ms": b_ms, "bound_by": b_by,
        "shape": f"n={n} fp32 (library: torch.optim.AdamW foreach)",
    }
    return r


def check_other_forms(gen):
    """The other shapes and dtypes the wrappers take (head_dim 64 and 128,
    ragged and short sequences, non-causal, GQA groups 1 to 8, fp32 caches
    and norms, an Adam leaf with a scalar tail), each against its plain
    version on the card."""
    F32 = torch.float32

    def rand(*shape, dtype=BF16):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)

    cases = []
    for B, S, H, KV, D, causal in ((1, 37, 8, 2, 64, True), (3, 200, 4, 4, 128, False),
                                   (1, 1, 32, 8, 128, True)):
        q, k, v = rand(B, S, H, D), rand(B, S, KV, D), rand(B, S, KV, D)
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        ref, ref_lse = fa.flash_attention_plain(q, k, v, causal=causal)
        cases.append((f"flash B={B} S={S} H={H} KV={KV} D={D} causal={causal}",
                      max(max_err(out, ref), max_err(lse, ref_lse)), 2e-2))
    for dtype, D, H, KV, tol in ((F32, 64, 4, 2, 1e-4), (F32, 128, 32, 8, 1e-4),
                                 (BF16, 64, 8, 1, 1e-2)):
        q = rand(2, 1, H, D, dtype=dtype)
        kc, vc = rand(2, 300, KV, D, dtype=dtype), rand(2, 300, KV, D, dtype=dtype)
        for cl in (torch.tensor([299, 64], dtype=torch.int32, device="cuda"), 31):
            err = max_err(dec.decode_attention(q, kc, vc, cl),
                          dec.decode_attention_plain(q, kc, vc, cl))
            cases.append((f"decode {dtype} D={D} H={H} KV={KV} cache_len="
                          f"{cl.tolist() if torch.is_tensor(cl) else cl}", err, tol))
    for xd, wd, tol in ((F32, F32, 1e-4), (F32, BF16, 1e-4), (BF16, F32, 6.25e-2)):
        x, w = rand(5, 4096, dtype=xd), (1 + 0.1 * rand(4096, dtype=F32)).to(wd)
        err = max_err(rn.rmsnorm_fwd(x, w), rn.rmsnorm_plain(x, w))
        cases.append((f"rmsnorm x {xd} w {wd} rows=5 D=4096", err, tol))
    for B, S, H, KV, D, causal in ((1, 200, 8, 2, 128, True), (2, 256, 4, 4, 64, False),
                                   (1, 37, 8, 1, 64, True), (2, 384, 16, 4, 128, True)):
        q, k, v, do = rand(B, S, H, D), rand(B, S, KV, D), rand(B, S, KV, D), rand(B, S, H, D)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            scale = w.float().abs().max().item()
            cases.append((f"flash_bwd {name} B={B} S={S} H={H} KV={KV} D={D} "
                          f"causal={causal}", max_err(a, w), 2e-2 * scale))
    for xd, wd, rows, D, tol in ((F32, F32, 300, 4096, 1e-4), (BF16, F32, 300, 4096, 6.25e-2),
                                 (F32, BF16, 5, 128, 1e-4)):
        x, g = rand(rows, D, dtype=xd), rand(rows, D, dtype=xd)
        w = (1 + 0.1 * rand(D, dtype=F32)).to(wd)
        (dx, ds), (rdx, rds) = rn.rmsnorm_bwd(x, w, g), rn.rmsnorm_bwd_plain(x, w, g)
        cases.append((f"rmsnorm_bwd dx x {xd} w {wd} rows={rows} D={D}",
                      max_err(dx, rdx), tol))
        cases.append((f"rmsnorm_bwd dscale x {xd} w {wd} rows={rows} D={D}",
                      max_err(ds, rds), 1e-5 * rds.abs().max().item()))
    n = 1_000_003  # not a multiple of 4: the scalar tail
    p, g, m = rand(n, dtype=F32), rand(n, dtype=F32), rand(n, dtype=F32)
    v = rand(n, dtype=F32).abs()
    p2, m2, v2 = p.clone(), m.clone(), v.clone()
    kw = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, wd=0.1, bc1=0.1, bc2=0.05)
    fad.adam_update(p, g, m, v, **kw)
    fad.adam_update_plain(p2, g, m2, v2, **kw)
    cases.append((f"fused_adam n={n} no clip", max(max_err(p, p2), max_err(m, m2),
                                                   max_err(v, v2)), 1e-5))
    for name, err, tol in cases:
        print(f"{name}: max_abs_err {err:.3e} (tol {tol:.3e})")
        require(err <= tol, f"{name} disagrees with its plain version")


def check_layernorm(gen, timer):
    """The LayerNorm forward at the new paths' shapes: serving_bloom (the B=4
    x 512 prefill of hidden 4096), serving_gpt2 (the same prefill at hidden
    1600), training_bloom (bloom-560m's micro-batch, 8192 rows of hidden 1024)
    and the decode steps' 4 rows of BLOOM and GPT-2 (timed with the wrapper's
    host us a call); then fp32 rows whose mean is 1000 against their spread
    of 1 (a one-pass E[x^2] - mean^2 would lose the variance), the fp32 and
    mixed forms, and a row too wide for registers (D = 20480 fp32, three
    passes). Returns one timed row per path, and the decode rows under
    "decode rows=4 D=...". All but the 4 x 1600 rows of bf16 and of mean 1000
    draw from gen, in the order the later checks' draws follow; those two
    from a generator of their own."""
    eps = 1e-5
    atol, rtol = 1e-3, 1.6e-2  # bf16: two bf16 ulps of the plain result
    F32 = torch.float32
    own = torch.Generator(device="cuda").manual_seed(53)
    rows = {}
    for path, n, D, g in (("serving_bloom", 4 * 512, 4096, gen),
                          ("decode rows=4 D=4096", 4, 4096, gen),
                          ("serving_gpt2", 4 * 512, 1600, gen),
                          ("training_bloom", TRAIN_B * TRAIN_S, 1024, gen),
                          ("decode rows=4 D=1600", 4, 1600, own)):
        w = (1 + 0.1 * torch.randn(D, generator=g, device="cuda")).to(BF16)
        b = (0.1 * torch.randn(D, generator=g, device="cuda")).to(BF16)
        x = torch.randn(n, D, generator=g, device="cuda", dtype=BF16)
        fn = lambda t: ln.layernorm_fwd(t, w, b, eps)  # noqa: E731
        plain = lambda t: ln.layernorm_plain(t, w, b, eps)  # noqa: E731
        e = norm_agrees("layernorm_fwd", fn, plain, x, atol, rtol)
        rows[path] = norm_row(timer, e, lambda: fn(x), lambda: plain(x),
                              lambda: F.layer_norm(x, (D,), w, b, eps),
                              *bound(8 * x.numel(), 2 * 2 * x.numel() + 2 * 2 * D),
                              f"rows={n} D={D} bf16 (library: F.layer_norm)",
                              host=path.startswith("decode"))
    # mean 1000: 1e-5 + 4e-7 * |mean| (the fp32 mean is summed in another
    # order, one fp32 ulp at 1000 is 6.1e-5); a one-pass E[x^2] - mean^2
    # loses most of the variance's digits there, far outside
    for xd, wd, n, D, shift, tol, g in ((F32, F32, 64, 4096, 1000.0, 4.1e-4, gen),
                                        (F32, BF16, 5, 1600, 0.0, 1e-4, gen),
                                        (BF16, F32, 300, 1024, 0.0, 6.25e-2, gen),
                                        (F32, F32, 3, 20480, 0.0, 1e-4, gen),
                                        (F32, F32, 4, 1600, 1000.0, 4.1e-4, own)):
        x = (shift + torch.randn(n, D, generator=g, device="cuda")).to(xd)
        w = (1 + 0.1 * torch.randn(D, generator=g, device="cuda")).to(wd)
        b = (0.1 * torch.randn(D, generator=g, device="cuda")).to(wd)
        norm_agrees(f"layernorm_fwd w {wd} mean {shift}", lambda t: ln.layernorm_fwd(t, w, b, eps),
                    lambda t: ln.layernorm_plain(t, w, b, eps), x, tol, 0.0)
    return rows


def check_layernorm_bwd(gen, timer):
    """The backward at training_bloom's shape, 8192 rows of hidden 1024, bf16
    x, g, scale; two runs must give the same bits. Then the fp32 and mixed
    forms and D 4096 / 8192 (two and four vectors a thread)."""
    rows, D, eps = TRAIN_B * TRAIN_S, 1024, 1e-5
    atol, rtol = 1e-3, 1.6e-2  # dx: two bf16 ulps of the plain result
    red_rel = 1e-5  # dscale, dbias: fp32 sums over the rows in another order
    F32 = torch.float32
    x = torch.randn(rows, D, generator=gen, device="cuda", dtype=BF16)
    w = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(BF16)
    g = torch.randn(rows, D, generator=gen, device="cuda", dtype=BF16)
    dx, ds, db = ln.layernorm_bwd(x, w, g, eps)
    again = ln.layernorm_bwd(x, w, g, eps)
    same = all(torch.equal(a, b) for a, b in zip((dx, ds, db), again))
    rdx, rds, rdb = ln.layernorm_bwd_plain(x, w, g, eps)
    e_dx, e_ds, e_db = max_err(dx, rdx), max_err(ds, rds), max_err(db, rdb)
    ok_dx = bool(((dx.float() - rdx.float()).abs()
                  <= atol + rtol * rdx.float().abs()).all())
    print(f"layernorm_bwd rows={rows} D={D}: max_abs_err dx {e_dx:.3e} (tol {atol} + "
          f"{rtol}*|ref|) dscale {e_ds:.3e} dbias {e_db:.3e} (tol {red_rel}*max|ref|: "
          f"{red_rel * rds.abs().max().item():.3e}, {red_rel * rdb.abs().max().item():.3e}); "
          f"two runs bitwise equal: {same}")
    require(ok_dx and e_ds <= red_rel * rds.abs().max().item()
            and e_db <= red_rel * rdb.abs().max().item(),
            "layernorm_bwd disagrees with its plain version")
    require(same, "layernorm_bwd: two runs on the same inputs differ")
    cases = []
    for xd, wd, n, Dn, tol in ((F32, F32, 300, 1024, 1e-4), (BF16, F32, 300, 4096, 6.25e-2),
                               (F32, BF16, 5, 1600, 1e-4), (BF16, BF16, 40, 8192, 6.25e-2)):
        xx = torch.randn(n, Dn, generator=gen, device="cuda").to(xd)
        gg = torch.randn(n, Dn, generator=gen, device="cuda").to(xd)
        ww = (1 + 0.1 * torch.randn(Dn, generator=gen, device="cuda")).to(wd)
        got, want = ln.layernorm_bwd(xx, ww, gg, eps), ln.layernorm_bwd_plain(xx, ww, gg, eps)
        cases.append((f"layernorm_bwd dx x {xd} w {wd} rows={n} D={Dn}",
                      max_err(got[0], want[0]), tol))
        for name, a, r in (("dscale", got[1], want[1]), ("dbias", got[2], want[2])):
            cases.append((f"layernorm_bwd {name} x {xd} w {wd} rows={n} D={Dn}",
                          max_err(a, r), red_rel * r.abs().max().item()))
    for name, err, tol in cases:
        print(f"{name}: max_abs_err {err:.3e} (tol {tol:.3e})")
        require(err <= tol, f"{name} disagrees with its plain version")
    xr, wr = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
    br = torch.zeros(D, device="cuda", dtype=BF16, requires_grad=True)
    lib_out = F.layer_norm(xr, (D,), wr, br, eps)
    b_ms, b_by = bound(15 * x.numel(), 3 * 2 * x.numel() + 2 * D + 2 * 4 * D)
    return {
        "max_abs_err": max(e_dx, e_ds, e_db),
        "ms": timer(lambda: ln.layernorm_bwd(x, w, g, eps)),
        "plain_ms": timer(lambda: ln.layernorm_bwd_plain(x, w, g, eps)),
        "library_ms": timer(lambda: torch.autograd.grad(
            lib_out, (xr, wr, br), g, retain_graph=True)),
        "bound_ms": b_ms, "bound_by": b_by,
        "shape": f"rows={rows} D={D} bf16 (library: F.layer_norm backward)",
    }


def alibi_mask(slopes: torch.Tensor, S: int) -> torch.Tensor:
    """[H, S, S] bf16 float mask for SDPA: the ALiBi bias, -inf above the
    diagonal (the library yardstick of the ALiBi flash kernels)."""
    pos = torch.arange(S, device="cuda")
    dist = (pos[:, None] - pos[None, :]).float()
    return torch.where(dist >= 0, -slopes[:, None, None] * dist, float("-inf")).to(BF16)


def alibi_draws(B: int, S: int, H: int, D: int, slopes: torch.Tensor, tol_lse: float,
                draws: int = 8) -> None:
    """The flash ALiBi forward at one shape on ``draws`` draws of their own
    generator (check_alibi's draws are left as they were): each draw's worst
    element error in bf16 ulps of that element, held to two bf16 ulps of the
    output's largest value, lse to ``tol_lse``."""
    gen = torch.Generator(device="cuda").manual_seed(1537)
    for d in range(draws):
        q, k, v = (torch.randn(B, S, H, D, generator=gen, device="cuda", dtype=BF16)
                   for _ in range(3))
        out, lse = fa.flash_attention_fwd(q, k, v, True, slopes)
        ref, ref_lse = fa.flash_attention_plain(q, k, v, True, slopes)
        err = (out.float() - ref.float()).abs()
        worst = int(err.argmax())
        at = ref.float().reshape(-1)[worst].item()
        e, peak = err.max().item(), ref.float().abs().max().item()
        e_lse, tol = max_err(lse, ref_lse), 2 * bf16_ulp(peak)
        print(f"flash_attention_fwd_alibi B={B} S={S} H={H} D={D}, draw {d}: worst element "
              f"error {e:.4e} at {at:.4e}, {e / bf16_ulp(at):.3f} bf16 ulps of that element "
              f"(tol {tol:.3e}: 2 bf16 ulps of the largest value {peak:.3e}); lse "
              f"{e_lse:.3e} (tol {tol_lse})")
        require(e <= tol and e_lse <= tol_lse,
                f"flash_attention_fwd_alibi disagrees on draw {d} at B={B} S={S}")
        del q, k, v, out, lse, ref, ref_lse, err


def check_alibi(gen, timer):
    """The ALiBi forms, each against its plain version: the flash forward at
    serving_bloom's prefill (B=4 S=512 H=32 D=128) and the flash forward and
    backward at training_bloom's micro-batch (B=4 S=2048 H=16 D=64); other
    shapes (12 heads: the slopes' non-power-of-two branch; GQA; ragged S;
    non-causal); the decode kernel with slopes at bloom-7b1's decode step
    (:func:`check_decode`), with rows_per_seq, int8 and paged; and the
    nullptr forms (Llama) against slopes of zero: bitwise in the decode
    kernels (a runtime branch) and in the flash forward (a separate
    instantiation whose score rounds as the ALiBi one's), to rounding in the
    flash backward. The forward's output is held to two bf16 ulps of its
    largest value (a rounding flip of p, rounded to bf16 before P·V, moves an
    element by one ulp of itself), and at training_bloom's shape on eight more
    draws, each printing its worst element's error in ulps of that element.
    Returns timed rows: (fwd serving_bloom, fwd training_bloom, dq, dkv,
    decode)."""
    tol = 2e-2  # of the largest gradient: p and ds round to bf16 before products
    tol_lse = 1e-3
    tol_lse_forms = 2e-2  # the other shapes' lse, absolute

    def tol_out(ref: torch.Tensor) -> float:
        return 2 * bf16_ulp(ref.float().abs().max().item())

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=BF16)

    timed = {}
    for path, B, S, H, KV, D in (("serving_bloom", 4, 512, 32, 32, 128),
                                 ("training_bloom", TRAIN_B, TRAIN_S, 16, 16, 64)):
        sl = alibi_slopes(H).cuda()
        q, k, v = rand(B, S, H, D), rand(B, S, KV, D), rand(B, S, KV, D)
        out, lse = fa.flash_attention_fwd(q, k, v, True, sl)
        ref, ref_lse = fa.flash_attention_plain(q, k, v, True, sl)
        e_out, e_lse = max_err(out, ref), max_err(lse, ref_lse)
        t_out = tol_out(ref)
        print(f"flash_attention_fwd_alibi B={B} S={S} H={H} KV={KV} D={D}: max_abs_err "
              f"out {e_out:.3e} (tol {t_out:.3e}, 2 bf16 ulps of its largest value) lse "
              f"{e_lse:.3e} (tol {tol_lse})")
        require(e_out <= t_out and e_lse <= tol_lse,
                f"flash_attention_fwd_alibi disagrees at B={B} S={S} D={D}")
        del ref, ref_lse
        if path == "training_bloom":
            alibi_draws(B, S, H, D, sl, tol_lse)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = alibi_mask(sl, S)
        pairs = B * H * S * (S + 1) / 2
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * B * H * S + 4 * H
        b_ms, b_by = bound(4 * D * pairs, nbytes)
        timed[("fwd", path)] = {
            "max_abs_err": e_out,
            "ms": timer(lambda: fa.flash_attention_fwd(q, k, v, True, sl)),
            "plain_ms": timer(lambda: fa.flash_attention_plain(q, k, v, True, sl)),
            "library_ms": timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask)),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"B={B} S={S} H={H} KV={KV} D={D} causal ALiBi (library: SDPA, "
                     "float mask)",
        }
        if path == "serving_bloom":
            del q, k, v, qt, kt, vt, out, lse, mask
            torch.cuda.empty_cache()
            continue
        do = rand(B, S, H, D)
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, True, sl)
        rdq, rdelta = fa.flash_attention_bwd_dq_plain(q, k, v, out, lse, do, True, sl)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, rdelta, do, True, sl)
        rdk, rdv = fa.flash_attention_bwd_dkv_plain(q, k, v, lse, rdelta, do, True, sl)
        errs = {n: (max_err(a, r), r.float().abs().max().item())
                for n, a, r in (("dq", dq, rdq), ("delta", delta, rdelta),
                                ("dk", dk, rdk), ("dv", dv, rdv))}
        print(f"flash_attention_bwd_alibi B={B} S={S} H={H} KV={KV} D={D}: "
              + ", ".join(f"{n} max_abs_err {e:.3e} (max|ref| {m:.3e})"
                          for n, (e, m) in errs.items())
              + f"; tol {tol}*max|ref| (1e-4 for delta)")
        for n, (e, m) in errs.items():
            require(e <= (1e-4 if n == "delta" else tol) * m,
                    f"flash_attention_bwd_alibi {n} disagrees with its plain version")
        del dq, delta, dk, dv, rdq, rdk, rdv
        torch.cuda.empty_cache()
        rows_b = 4 * B * H * S
        qkvo = 2 * (2 * q.numel() + k.numel() + v.numel())
        b_dq = bound(6 * D * pairs, qkvo + 2 * do.numel() + 2 * q.numel() + 2 * rows_b)
        b_dkv = bound(8 * D * pairs, 2 * (q.numel() + k.numel() + v.numel() + do.numel())
                      + 2 * (k.numel() + v.numel()) + 2 * rows_b)
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
        lib_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
        dot = do.transpose(1, 2).contiguous()
        lib_ms = timer(lambda: torch.autograd.grad(lib_out, (qg, kg, vg), dot,
                                                   retain_graph=True))
        shape = f"B={B} S={S} H={H} KV={KV} D={D} causal ALiBi"
        timed["dq"] = {
            "max_abs_err": errs["dq"][0],
            "ms": timer(lambda: fa.flash_attention_bwd_dq(q, k, v, out, lse, do, True, sl)),
            "plain_ms": timer(lambda: fa.flash_attention_bwd_dq_plain(
                q, k, v, out, lse, do, True, sl)),
            "library_ms": lib_ms, "bound_ms": b_dq[0], "bound_by": b_dq[1],
            "shape": shape + " (library: SDPA backward with the float mask, dq+dk+dv)",
        }
        timed["dkv"] = {
            "max_abs_err": max(errs["dk"][0], errs["dv"][0]),
            "ms": timer(lambda: fa.flash_attention_bwd_dkv(q, k, v, lse, rdelta, do,
                                                           True, sl)),
            "plain_ms": timer(lambda: fa.flash_attention_bwd_dkv_plain(
                q, k, v, lse, rdelta, do, True, sl)),
            "library_ms": lib_ms, "bound_ms": b_dkv[0], "bound_by": b_dkv[1],
            "shape": shape + " (library: same call)",
        }
        del q, k, v, qt, kt, vt, qg, kg, vg, out, lse, do, dot, lib_out, mask
        torch.cuda.empty_cache()

    cases, same, fwd_same = [], [], []
    for B, S, H, KV, D, causal in ((1, 300, 12, 4, 64, True), (2, 200, 12, 12, 128, True),
                                   (1, 130, 4, 2, 64, False)):
        sl = alibi_slopes(H).cuda()
        q, k, v, do = rand(B, S, H, D), rand(B, S, KV, D), rand(B, S, KV, D), rand(B, S, H, D)
        o, lse = fa.flash_attention_fwd(q, k, v, causal, sl)
        ro, rlse = fa.flash_attention_plain(q, k, v, causal, sl)
        cases.append((f"flash_alibi fwd out B={B} S={S} H={H} KV={KV} D={D} causal={causal}",
                      max_err(o, ro), tol_out(ro)))
        cases.append((f"flash_alibi fwd lse B={B} S={S} H={H} KV={KV} D={D} causal={causal}",
                      max_err(lse, rlse), tol_lse_forms))
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, sl)
        want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal, sl)
        for n, a, w in zip(("dq", "dk", "dv"), got, want):
            cases.append((f"flash_alibi bwd {n} B={B} S={S} H={H} KV={KV} D={D} "
                          f"causal={causal}", max_err(a, w), tol * w.float().abs().max().item()))
        # the Llama form (nullptr) against the ALiBi form with slopes of
        # zero: the forward bitwise (both round the score by the same
        # __fmul_rn before the term, which adds -0); the backward to rounding
        # (its Llama instantiation may fuse the score into the exponent's
        # argument, where the ALiBi form rounds it first)
        zero = torch.zeros(H, device="cuda")
        o0, lse0 = fa.flash_attention_fwd(q, k, v, causal)
        oz, lsez = fa.flash_attention_fwd(q, k, v, causal, zero)
        fwd_same.append(torch.equal(o0, oz) and torch.equal(lse0, lsez))
        g0 = fa.flash_attention_bwd(q, k, v, o0, lse0, do, causal)
        gz = fa.flash_attention_bwd(q, k, v, oz, lsez, do, causal, zero)
        for n, a, z in zip(("dq", "dk", "dv"), g0, gz):
            cases.append((f"flash nullptr vs zero slopes {n} B={B} S={S} H={H} KV={KV} "
                          f"D={D} causal={causal}", max_err(a, z),
                          tol * a.float().abs().max().item()))
    # decode with slopes: rows_per_seq (a 5-token window), int8, paged
    H, KV, D, Smax = 32, 32, 128, 300
    sl, zero = alibi_slopes(H).cuda(), torch.zeros(H, device="cuda")
    q = rand(2 * 5, 1, H, D)
    kc, vc = rand(2, Smax, KV, D), rand(2, Smax, KV, D)
    fr = torch.tensor([120, 121, 122, 123, 124, 0, 299, -1, 7, 250], dtype=torch.int32,
                      device="cuda")
    cases.append(("decode_alibi rows_per_seq=5 ragged frontiers",
                  max_err(dec.decode_attention(q, kc, vc, fr, rows_per_seq=5, slopes=sl),
                          dec.decode_attention_plain(q, kc, vc, fr, rows_per_seq=5,
                                                     slopes=sl)), 1e-2))
    k8, v8, ks8, vs8 = int8_cache(gen, 2, Smax, KV, D)
    q2 = rand(2, 1, H, D)
    fr2 = torch.tensor([17, 299], dtype=torch.int32, device="cuda")
    cases.append(("decode_alibi int8 frontiers [17, 299]",
                  max_err(dec.decode_attention(q2, k8, v8, fr2, ks8, vs8, slopes=sl),
                          dec.decode_attention_plain(q2, k8, v8, fr2, ks8, vs8, slopes=sl)),
                  1e-2))
    ps, mp = 16, 20
    pool_k, pool_v = rand(2 * mp + 1, ps, KV, D), rand(2 * mp + 1, ps, KV, D)
    table = torch.randperm(2 * mp, generator=torch.Generator().manual_seed(9)).int()
    table = table.reshape(2, mp).cuda()
    cases.append(("paged_decode_alibi frontiers [17, 299]",
                  max_err(dec.paged_decode_attention(q2, pool_k, pool_v, fr2, table,
                                                     slopes=sl),
                          dec.paged_decode_attention_plain(q2, pool_k, pool_v, fr2, table,
                                                           slopes=sl)), 1e-2))
    for fn, args in ((dec.decode_attention, (q, kc, vc, fr)),
                     (dec.decode_attention, (q2, k8, v8, fr2, ks8, vs8)),
                     (dec.paged_decode_attention, (q2, pool_k, pool_v, fr2, table))):
        kw = {"rows_per_seq": 5} if args[0] is q else {}
        same.append(torch.equal(fn(*args, **kw), fn(*args, **kw, slopes=zero)))
    for name, err, t in cases:
        print(f"{name}: max_abs_err {err:.3e} (tol {t:.3e})")
        require(err <= t, f"{name} disagrees with its plain version")
    print(f"flash forward Llama form (nullptr slopes) bitwise equal to slopes of zero: "
          f"{fwd_same}")
    require(all(fwd_same), "the nullptr-slopes flash forward differs from slopes of zero")
    print(f"decode Llama forms (nullptr slopes) bitwise equal to slopes of zero: "
          f"dense rows/int8/paged {same}")
    require(all(same), "a nullptr-slopes decode form differs from slopes of zero")
    decode = check_decode(gen, timer, H=32, KV=32, D=128, slopes=alibi_slopes(32).cuda())
    return (timed[("fwd", "serving_bloom")], timed[("fwd", "training_bloom")],
            timed["dq"], timed["dkv"], decode)


# ---------------------------------------------------------------------------
# packed sequences, positions as a dense ALiBi bias, block-sparse attention
# ---------------------------------------------------------------------------
def packed_rows(rows: int, S: int, seed: int):
    """Seeded packed rows: documents of lengths uniform in [DOC_MIN, DOC_MAX]
    concatenated, the last one cut at the row's end. Returns numpy
    (segment_ids [rows, S] counting up from 0, positions [rows, S] restarting
    at every document, each row's document lengths)."""
    rng = np.random.RandomState(seed)
    seg = np.zeros((rows, S), np.int64)
    pos = np.zeros((rows, S), np.int64)
    docs = []
    for r in range(rows):
        lens, at = [], 0
        while at < S:
            n = min(int(rng.randint(DOC_MIN, DOC_MAX + 1)), S - at)
            seg[r, at:at + n] = len(lens)
            pos[r, at:at + n] = np.arange(n)
            lens.append(n)
            at += n
        docs.append(lens)
    return seg, pos, docs


def packed_batch(ids: torch.Tensor, seed: int) -> dict:
    """A packed batch over token rows ``ids`` [rows, S]: segment ids,
    positions, and labels the next token inside each document, -1 on its
    last token (Megatron's reset_position_ids, HF's
    DataCollatorWithFlattening)."""
    seg, pos, _ = packed_rows(*ids.shape, seed)
    seg = torch.from_numpy(seg).to(ids.device)
    last = torch.ones_like(seg, dtype=torch.bool)
    last[:, :-1] = seg[:, 1:] != seg[:, :-1]
    labels = torch.cat([ids[:, 1:], ids[:, :1]], dim=1).masked_fill(last, -1)
    return {"input_ids": ids, "labels": labels, "segment_ids": seg,
            "positions": torch.from_numpy(pos).to(ids.device)}


def packed_pairs(rows: int, S: int, seed: int) -> float:
    """Visible causal (query, key) pairs of ``packed_rows``' rows, per head."""
    return float(sum(n * (n + 1) // 2 for lens in packed_rows(rows, S, seed)[2]
                     for n in lens))


def layout_pairs(layout: np.ndarray, S: int) -> float:
    """Visible causal (query, key) pairs of one sequence under a causally
    trimmed block layout, per head."""
    blk = S // layout.shape[0]
    return float(sum(blk * (blk + 1) // 2 if i == j else blk * blk
                     for i, j in zip(*np.nonzero(layout))))


def sparse_fixed_layout(S: int) -> np.ndarray:
    """training_sparse's layout at S: the "fixed" section, causally trimmed."""
    return sparse_layout(from_ds_config(SparseAttentionConfig(**SPARSE_SECTION)), S, True)


def masked_library_mask(S, causal_seg=None, bias=None, layout=None):
    """The SDPA mask equivalent to a masked form: bool [B|1, 1, S, S] (causal,
    segments, layout), or with a bias the bf16 float mask [B, H, S, S]
    (bias where visible, -inf elsewhere)."""
    vis = torch.ones(S, S, dtype=torch.bool, device="cuda").tril()[None, None]
    if causal_seg is not None:
        vis = vis & (causal_seg[:, None, :, None] == causal_seg[:, None, None, :])
    if layout is not None:
        vis = vis & fa.layout_mask(layout, S, "cuda")
    if bias is None:
        return vis
    return bias.masked_fill(~vis, float("-inf")).to(BF16)


def check_masked_forms(gen, timer):
    """The segment-id, bias + segment and block-sparse forms of the flash
    forward, dq and dk/dv kernels at their paths' shapes (training_packed:
    llama3-1b's B=4 S=2048 H=32 KV=8 D=64 with packed segments;
    training_bloom_packed: bloom-560m's H=KV=16 with the [4, 16, 2048, 2048]
    fp32 positions bias and segments; training_sparse: llama3-1b's shape
    under the "fixed" layout), each against its plain version (the dk/dv
    kernel on the plain delta), with the dq kernel's dbias output of the
    full bias (two runs bitwise equal); then a "bigbird" layout (random
    columns) with segment ids and other shapes. Returns timed rows keyed
    (kernel, path)."""
    tol, tol_lse, tol_delta = 2e-2, 1e-3, 1e-4
    B, S, D = TRAIN_B, TRAIN_S, 64

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=BF16)

    seg_np, pos_np, _ = packed_rows(B, S, PACKED_SEED)
    seg = torch.from_numpy(seg_np).int().cuda()
    pos = torch.from_numpy(pos_np).cuda()
    fixed = sparse_fixed_layout(S)
    seg_pairs = packed_pairs(B, S, PACKED_SEED)
    rows = {}
    for path, H, KV, kw, pairs_bh in (
            ("training_packed", 32, 8, {"segment_ids": seg}, seg_pairs),
            ("training_bloom_packed", 16, 16,
             {"segment_ids": seg,
              "bias": alibi_position_bias(pos, alibi_slopes(16).cuda())}, seg_pairs),
            ("training_sparse", 32, 8, {"layout": fixed}, B * layout_pairs(fixed, S))):
        form = fa.form_suffix(None, kw.get("bias"), kw.get("segment_ids"),
                              kw.get("layout"))
        q, k, v, do = rand(B, S, H, D), rand(B, S, KV, D), rand(B, S, KV, D), rand(B, S, H, D)
        out, lse = fa.flash_attention_fwd(q, k, v, True, **kw)
        ref, ref_lse = fa.flash_attention_plain(q, k, v, True, **kw)
        errs = {"out": (max_err(out, ref), tol), "lse": (max_err(lse, ref_lse), tol_lse)}
        del ref, ref_lse
        emit = "bias" in kw
        got = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, True, **kw, emit_dbias=emit)
        want = fa.flash_attention_bwd_dq_plain(q, k, v, out, lse, do, True, **kw,
                                               emit_dbias=emit)
        rdelta = want[1]
        for n, a, w in zip(("dq", "delta", "dbias"), got, want):
            m = w.float().abs().max().item()
            errs[n] = (max_err(a, w), (tol_delta if n == "delta" else tol) * m)
        if emit:
            again = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, True, **kw,
                                              emit_dbias=True)[2]
            same = torch.equal(got[2], again)
            print(f"flash_attention_bwd_dq{form} dbias [{B}, {H}, {S}, {S}] "
                  f"{got[2].dtype}: two runs bitwise equal: {same}")
            require(same, "the dq kernel's dbias differs between two runs")
            del again
        del got, want
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, rdelta, do, True, **kw)
        rdk, rdv = fa.flash_attention_bwd_dkv_plain(q, k, v, lse, rdelta, do, True, **kw)
        for n, a, w in (("dk", dk, rdk), ("dv", dv, rdv)):
            errs[n] = (max_err(a, w), tol * w.float().abs().max().item())
        del dk, dv, rdk, rdv
        print(f"flash{form} ({path}) B={B} S={S} H={H} KV={KV} D={D} causal: "
              + ", ".join(f"{n} max_abs_err {e:.3e} (tol {t:.3e})" for n, (e, t) in
                          errs.items()))
        for n, (e, t) in errs.items():
            require(e <= t, f"flash{form} {n} disagrees with its plain version")
        torch.cuda.empty_cache()

        # timing at the path's shape; SDPA on heads repeated to H (its
        # memory-efficient kernel takes a mask, not a GQA group)
        mask = masked_library_mask(S, kw.get("segment_ids"), kw.get("bias"),
                                   kw.get("layout"))
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (t.repeat_interleave(H // KV, dim=2).transpose(1, 2).contiguous()
                  for t in (k, v))
        pairs = pairs_bh * H
        bias_bytes = 4 * pairs if emit else 0  # the fp32 bias at the visible pairs
        rows_b = 4 * B * H * S
        b_fwd = bound(4 * D * pairs, 2 * (2 * q.numel() + k.numel() + v.numel()) + rows_b
                      + bias_bytes)
        b_dq = bound(6 * D * pairs, 2 * (3 * q.numel() + k.numel() + v.numel() + q.numel())
                     + 2 * rows_b + bias_bytes)
        b_dkv = bound(8 * D * pairs, 2 * (2 * q.numel() + 2 * k.numel() + 2 * v.numel())
                      + 2 * rows_b + bias_bytes)
        shape = (f"B={B} S={S} H={H} KV={KV} D={D} causal {form[1:]} "
                 f"({pairs_bh:.0f} visible pairs per head)")
        rows[("flash_attention_fwd" + form, path)] = {
            "max_abs_err": errs["out"][0],
            "ms": timer(lambda: fa.flash_attention_fwd(q, k, v, True, **kw)),
            "plain_ms": timer(lambda: fa.flash_attention_plain(q, k, v, True, **kw)),
            "library_ms": timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask)),
            "bound_ms": b_fwd[0], "bound_by": b_fwd[1],
            "shape": shape + " (library: SDPA with the equivalent mask)",
        }
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
        lib_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
        dot = do.transpose(1, 2).contiguous()
        lib_ms = timer(lambda: torch.autograd.grad(lib_out, (qg, kg, vg), dot,
                                                   retain_graph=True))
        rows[("flash_attention_bwd_dq" + form, path)] = {
            "max_abs_err": errs["dq"][0],
            "ms": timer(lambda: fa.flash_attention_bwd_dq(q, k, v, out, lse, do, True,
                                                          **kw)),
            "plain_ms": timer(lambda: fa.flash_attention_bwd_dq_plain(
                q, k, v, out, lse, do, True, **kw)),
            "library_ms": lib_ms, "bound_ms": b_dq[0], "bound_by": b_dq[1],
            "shape": shape + " (library: SDPA backward with the mask, dq+dk+dv)",
        }
        rows[("flash_attention_bwd_dkv" + form, path)] = {
            "max_abs_err": max(errs["dk"][0], errs["dv"][0]),
            "ms": timer(lambda: fa.flash_attention_bwd_dkv(q, k, v, lse, rdelta, do, True,
                                                           **kw)),
            "plain_ms": timer(lambda: fa.flash_attention_bwd_dkv_plain(
                q, k, v, lse, rdelta, do, True, **kw)),
            "library_ms": lib_ms, "bound_ms": b_dkv[0], "bound_by": b_dkv[1],
            "shape": shape + " (library: same call)",
        }
        del q, k, v, do, out, lse, qt, kt, vt, qg, kg, vg, lib_out, dot, mask, kw
        torch.cuda.empty_cache()

    cases = []
    bigbird = sparse_layout(BigBirdSparsityConfig(block=128), S, True)
    for B2, S2, H, KV, D2, causal, kw in (
            (B, S, 32, 8, 64, True, {"layout": bigbird, "segment_ids": seg}),
            (2, 300, 8, 2, 128, True, {"segment_ids": seg[:2, :300].contiguous()}),
            (2, 256, 4, 4, 64, False, {"segment_ids": seg[:2, -256:].contiguous()}),
            (1, 512, 12, 4, 64, True, {"segment_ids": seg[:1, :512].contiguous(),
                                       "slopes": alibi_slopes(12).cuda()}),
            (2, 384, 8, 8, 128, False, {"bias": 0.5 * rand(1, 8, 384, 384).float(),
                                        "segment_ids": seg[:2, 100:484].contiguous()}),
            (2, 512, 8, 2, 128, False, {"layout": sparse_layout(
                BSLongformerSparsityConfig(block=128), 512, False)}),
            (1, 512, 8, 2, 64, True, {"layout": sparse_layout(
                VariableSparsityConfig(block=256, num_random_blocks=1), 512, True),
                "slopes": alibi_slopes(8).cuda()})):
        sl = kw.pop("slopes", None)
        q, k, v, do = (rand(B2, S2, H, D2), rand(B2, S2, KV, D2), rand(B2, S2, KV, D2),
                       rand(B2, S2, H, D2))
        o, lse = fa.flash_attention_fwd(q, k, v, causal, sl, **kw)
        ro, rlse = fa.flash_attention_plain(q, k, v, causal, sl, **kw)
        form = fa.form_suffix(sl, kw.get("bias"), kw.get("segment_ids"), kw.get("layout"))
        name = f"flash{form} B={B2} S={S2} H={H} KV={KV} D={D2} causal={causal}"
        cases.append((name + " out", max_err(o, ro), tol))
        cases.append((name + " lse", max_err(lse, rlse), tol_lse))
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, sl, **kw,
                                     bias_grad="bias" in kw)
        want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal, sl, **kw,
                                            bias_grad="bias" in kw)
        for n, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
            cases.append((f"{name} {n}", max_err(a, w), tol * w.float().abs().max().item()))
        del q, k, v, do, o, lse, ro, rlse, got, want
    for name, err, t in cases:
        print(f"{name}: max_abs_err {err:.3e} (tol {t:.3e})")
        require(err <= t, f"{name} disagrees with its plain version")
    torch.cuda.empty_cache()
    return rows


def plain_by_heads(kind: str, groups: int, q, k, v, *args, causal=True, slopes=None,
                   **kw):
    """The plain version of a flash kernel (``kind`` fwd, dq or dkv; ``args``
    (o, lse, do) for dq, (lse, delta, do) for dkv) over ``groups`` groups of
    kv heads with their query heads, put back together: a hop's or a whole
    sequence's fp32 [B, H, S, S] scores, and the backward's four of them,
    would not fit the card at once."""
    KV, G = k.shape[2], q.shape[2] // k.shape[2]
    n = KV // groups

    def qh(t, j):
        return t[:, :, j * n * G:(j + 1) * n * G]

    def rh(t, j):
        return t[:, j * n * G:(j + 1) * n * G]

    def kh(t, j):
        return t[:, :, j * n:(j + 1) * n]

    parts = []
    for j in range(groups):
        sl = None if slopes is None else slopes[j * n * G:(j + 1) * n * G].contiguous()
        if kind == "fwd":
            parts.append(fa.flash_attention_plain(qh(q, j), kh(k, j), kh(v, j), causal, sl,
                                                  **kw))
        elif kind == "dq":
            o, lse, do = args
            parts.append(fa.flash_attention_bwd_dq_plain(
                qh(q, j), kh(k, j), kh(v, j), qh(o, j), rh(lse, j), qh(do, j), causal, sl,
                **kw))
        else:
            lse, delta, do = args
            parts.append(fa.flash_attention_bwd_dkv_plain(
                qh(q, j), kh(k, j), kh(v, j), rh(lse, j), rh(delta, j), qh(do, j), causal,
                sl, **kw))
    dims = (2, 2) if kind == "dkv" else (2, 1)
    return tuple(torch.cat([p[i] for p in parts], dim=d) for i, d in enumerate(dims))


def check_offset_forms(gen, timer):
    """The offset form of the flash forward, dq and dk/dv kernels (a ring
    hop) at training_sp's hop shape (llama3-1b's 32 query / 8 kv heads of
    64, B=1, a chunk of 8,192 tokens against a visiting chunk of 8,192) on
    the diagonal hop, a past hop and a future (empty) hop, each against its
    plain version (run kv head by kv head) and timed, the past hop as the
    path's row; the unmasked Llama forms at the Ulysses shape (the whole
    16,384 tokens on 16 query / 4 kv heads) timed likewise; the offset form
    with ALiBi and segment ids crossing the chunk edge at bloom-560m's width
    (16 heads); then the ring flash (``ops/ring_flash.py``) through the
    one-process loopback ring of 2 against the flat flash kernels on the
    whole 16,384-token sequence, forward and backward. Returns timed rows
    keyed by kernel; the plain versions' times are medians of 5 launches."""
    tol, tol_lse, tol_delta = 2e-2, 1e-3, 1e-4
    B, S, H, KV, D = 1, SP_SEQ // SP_SIZE, 32, 8, 64

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=BF16)

    def bwd_errs(got, want, names):
        return {n: (max_err(a, w), (tol_delta if n == "delta" else tol)
                    * w.float().abs().max().item()) for n, a, w in zip(names, got, want)}

    def plain_timer(fn):  # the plain versions take 80-170 ms a call here
        return timer(fn, iters=5, warmup=1)

    rows, cases = {}, []
    q, k, v, do = rand(B, S, H, D), rand(B, S, KV, D), rand(B, S, KV, D), rand(B, S, H, D)
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
    for hop, (i, blk) in (("diagonal", (1, 1)), ("past", (1, 0)), ("future", (0, 1))):
        off = (i * S, blk * S)
        out, lse = fa.flash_attention_fwd(q, k, v, True, offsets=off)
        ref, rlse = plain_by_heads("fwd", KV, q, k, v, offsets=off)
        errs = {"out": (max_err(out, ref), tol), "lse": (max_err(lse, rlse), tol_lse)}
        del ref, rlse
        got = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, True, offsets=off)
        want = plain_by_heads("dq", KV, q, k, v, out, lse, do, offsets=off)
        errs.update(bwd_errs(got, want, ("dq", "delta")))
        rdelta = want[1]
        dkv = fa.flash_attention_bwd_dkv(q, k, v, lse, rdelta, do, True, offsets=off)
        errs.update(bwd_errs(dkv, plain_by_heads("dkv", KV, q, k, v, lse, rdelta, do,
                                                 offsets=off), ("dk", "dv")))
        name = f"flash_offsets {hop} hop (qoff, koff) = {off} B={B} S={S} H={H} KV={KV} D={D}"
        cases += [(f"{name} {n}", e, t) for n, (e, t) in errs.items()]
        if hop == "future":  # nothing visible: out 0, lse -1e30, exact zero gradients
            empty = (not out.any() and bool((lse == -1e30).all()) and not got[0].any()
                     and not dkv[0].any() and not dkv[1].any())
            print(f"{name}: out 0, lse -1e30, dq = dk = dv = 0 exactly: {empty}")
            require(empty, "the future hop's offset form wrote something")
        # one ring step's hop of each kind timed; the past hop (every pair
        # visible) is the path's row
        pairs = B * H * S * (S + 1) / 2 if hop == "diagonal" else (
            B * H * S * S if hop == "past" else 0)
        t_fwd = timer(lambda: fa.flash_attention_fwd(q, k, v, True, offsets=off))
        t_dq = timer(lambda: fa.flash_attention_bwd_dq(q, k, v, out, lse, do, True,
                                                       offsets=off))
        t_dkv = timer(lambda: fa.flash_attention_bwd_dkv(q, k, v, lse, rdelta, do, True,
                                                         offsets=off))
        print(f"{name}: kernel fwd {t_fwd:.4f} ms, dq {t_dq:.4f} ms, dk/dv {t_dkv:.4f} ms "
              f"({pairs:.0f} visible pairs)")
        if hop == "past":
            rows_b = 4 * B * H * S
            b_fwd = bound(4 * D * pairs, 2 * (2 * q.numel() + k.numel() + v.numel()) + rows_b)
            b_dq = bound(6 * D * pairs, 2 * (4 * q.numel() + k.numel() + v.numel())
                         + 2 * rows_b)
            b_dkv = bound(8 * D * pairs, 2 * (2 * q.numel() + 2 * k.numel() + 2 * v.numel())
                          + 2 * rows_b)
            shape = (f"B={B} S={S} H={H} KV={KV} D={D} causal, past hop (qoff, koff) = "
                     f"{off}, every pair visible")
            qg, kg, vg = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
            lib_out = F.scaled_dot_product_attention(qg, kg, vg, enable_gqa=True)
            dot = do.transpose(1, 2).contiguous()
            lib_bwd = timer(lambda: torch.autograd.grad(lib_out, (qg, kg, vg), dot,
                                                        retain_graph=True))
            rows["flash_attention_fwd_offsets"] = {
                "max_abs_err": errs["out"][0], "ms": t_fwd,
                "plain_ms": plain_timer(lambda: plain_by_heads("fwd", KV, q, k, v,
                                                               offsets=off)),
                "library_ms": timer(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, enable_gqa=True)),
                "bound_ms": b_fwd[0], "bound_by": b_fwd[1],
                "shape": shape + " (library: SDPA without a mask)"}
            rows["flash_attention_bwd_dq_offsets"] = {
                "max_abs_err": errs["dq"][0], "ms": t_dq,
                "plain_ms": plain_timer(lambda: plain_by_heads("dq", KV, q, k, v, out, lse,
                                                               do, offsets=off)),
                "library_ms": lib_bwd, "bound_ms": b_dq[0], "bound_by": b_dq[1],
                "shape": shape + " (library: SDPA backward, dq+dk+dv)"}
            rows["flash_attention_bwd_dkv_offsets"] = {
                "max_abs_err": max(errs["dk"][0], errs["dv"][0]), "ms": t_dkv,
                "plain_ms": plain_timer(lambda: plain_by_heads("dkv", KV, q, k, v, lse,
                                                               rdelta, do, offsets=off)),
                "library_ms": lib_bwd, "bound_ms": b_dkv[0], "bound_by": b_dkv[1],
                "shape": shape + " (library: same call)"}
            del qg, kg, vg, lib_out, dot
        del out, lse, got, want, rdelta, dkv
        torch.cuda.empty_cache()
    del qt, kt, vt

    # the unmasked forms under Ulysses: the whole sequence on H/sp heads
    Hu, KVu = H // SP_SIZE, KV // SP_SIZE
    uq, uk, uv, udo = (rand(B, SP_SEQ, Hu, D), rand(B, SP_SEQ, KVu, D),
                       rand(B, SP_SEQ, KVu, D), rand(B, SP_SEQ, Hu, D))
    out, lse = fa.flash_attention_fwd(uq, uk, uv)
    ref, rlse = plain_by_heads("fwd", KVu, uq, uk, uv)
    errs = {"out": (max_err(out, ref), tol), "lse": (max_err(lse, rlse), tol_lse)}
    del ref, rlse
    want = plain_by_heads("dq", KVu, uq, uk, uv, out, lse, udo)
    errs.update(bwd_errs(fa.flash_attention_bwd_dq(uq, uk, uv, out, lse, udo), want,
                         ("dq", "delta")))
    rdelta = want[1]
    del want
    errs.update(bwd_errs(fa.flash_attention_bwd_dkv(uq, uk, uv, lse, rdelta, udo),
                         plain_by_heads("dkv", KVu, uq, uk, uv, lse, rdelta, udo),
                         ("dk", "dv")))
    name = f"flash (Ulysses) B={B} S={SP_SEQ} H={Hu} KV={KVu} D={D} causal"
    cases += [(f"{name} {n}", e, t) for n, (e, t) in errs.items()]
    pairs = B * Hu * SP_SEQ * (SP_SEQ + 1) / 2
    rows_b = 4 * B * Hu * SP_SEQ
    ut = [t.transpose(1, 2).contiguous().requires_grad_(True) for t in (uq, uk, uv)]
    lib_out = F.scaled_dot_product_attention(*ut, is_causal=True, enable_gqa=True)
    udot = udo.transpose(1, 2).contiguous()
    lib_bwd = timer(lambda: torch.autograd.grad(lib_out, ut, udot, retain_graph=True))
    shape = f"B={B} S={SP_SEQ} H={Hu} KV={KVu} D={D} causal (Ulysses: H/sp heads)"
    for kname, e, run, plain, nflops, nbytes, lib in (
            ("flash_attention_fwd", errs["out"][0],
             lambda: fa.flash_attention_fwd(uq, uk, uv),
             lambda: plain_by_heads("fwd", KVu, uq, uk, uv), 4,
             2 * (2 * uq.numel() + uk.numel() + uv.numel()) + rows_b,
             timer(lambda: F.scaled_dot_product_attention(
                 *(t.detach() for t in ut), is_causal=True, enable_gqa=True))),
            ("flash_attention_bwd_dq", errs["dq"][0],
             lambda: fa.flash_attention_bwd_dq(uq, uk, uv, out, lse, udo),
             lambda: plain_by_heads("dq", KVu, uq, uk, uv, out, lse, udo), 6,
             2 * (4 * uq.numel() + uk.numel() + uv.numel()) + 2 * rows_b, lib_bwd),
            ("flash_attention_bwd_dkv", max(errs["dk"][0], errs["dv"][0]),
             lambda: fa.flash_attention_bwd_dkv(uq, uk, uv, lse, rdelta, udo),
             lambda: plain_by_heads("dkv", KVu, uq, uk, uv, lse, rdelta, udo), 8,
             2 * (2 * uq.numel() + 2 * uk.numel() + 2 * uv.numel()) + 2 * rows_b,
             lib_bwd)):
        b = bound(nflops * D * pairs, nbytes)
        rows[kname] = {"max_abs_err": e, "ms": timer(run), "plain_ms": plain_timer(plain),
                       "library_ms": lib, "bound_ms": b[0], "bound_by": b[1],
                       "shape": shape + (" (library: SDPA)" if nflops == 4 else
                                         " (library: SDPA backward, dq+dk+dv)")}
    del uq, uk, uv, udo, out, lse, rdelta, ut, lib_out, udot
    torch.cuda.empty_cache()

    # the ALiBi + segment offset form at bloom-560m's width, chunks of 1,024
    Bb, Sb, Hb = 2, 1024, 16
    seg_np, _, _ = packed_rows(Bb, 2 * Sb, PACKED_SEED)
    seg = torch.from_numpy(seg_np).int().cuda()
    sl = alibi_slopes(Hb).cuda()
    q, k, v, do = (rand(Bb, Sb, Hb, D) for _ in range(4))
    for hop, (i, blk) in (("diagonal", (1, 1)), ("past", (1, 0)), ("future", (0, 1))):
        kw = {"segment_ids": (seg[:, i * Sb:(i + 1) * Sb].contiguous(),
                              seg[:, blk * Sb:(blk + 1) * Sb].contiguous()),
              "offsets": (i * Sb, blk * Sb)}
        out, lse = fa.flash_attention_fwd(q, k, v, True, sl, **kw)
        ref, rlse = fa.flash_attention_plain(q, k, v, True, sl, **kw)
        errs = {"out": (max_err(out, ref), tol), "lse": (max_err(lse, rlse), tol_lse)}
        got = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, True, sl, **kw)
        want = fa.flash_attention_bwd_dq_plain(q, k, v, out, lse, do, True, sl, **kw)
        errs.update(bwd_errs(got, want, ("dq", "delta")))
        errs.update(bwd_errs(fa.flash_attention_bwd_dkv(q, k, v, lse, want[1], do, True, sl,
                                                        **kw),
                             fa.flash_attention_bwd_dkv_plain(q, k, v, lse, want[1], do,
                                                              True, sl, **kw), ("dk", "dv")))
        name = f"flash_alibi_seg_offsets {hop} hop B={Bb} S={Sb} H=KV={Hb} D={D}"
        cases += [(f"{name} {n}", e, t) for n, (e, t) in errs.items()]
    for name, err, t in cases:
        print(f"{name}: max_abs_err {err:.3e} (tol {t:.3e})")
        require(err <= t, f"{name} disagrees with its plain version")
    del q, k, v, do, out, lse, ref, rlse, got, want
    torch.cuda.empty_cache()

    # the ring flash through the loopback ring against the flat kernels
    q, k, v, do = (rand(1, SP_SEQ, H, D), rand(1, SP_SEQ, KV, D), rand(1, SP_SEQ, KV, D),
                   rand(1, SP_SEQ, H, D))
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    t0 = time.perf_counter()
    chunks = [list(t.split(S, dim=1)) for t in leaves]
    outs = ring_flash_attention_local(*chunks, causal=True, ring=Ring.loopback(SP_SIZE))
    ring_grads = torch.autograd.grad(outs, leaves, list(do.split(S, dim=1)))
    torch.cuda.synchronize()
    t_ring = (time.perf_counter() - t0) * 1e3
    o, lse = fa.flash_attention_fwd(q, k, v)
    flat = fa.flash_attention_bwd(q, k, v, o, lse, do)
    errs = [("out", max_err(torch.cat(outs, dim=1), o), tol)]
    errs += [(n, max_err(a, w), tol * w.float().abs().max().item())
             for n, a, w in zip(("dq", "dk", "dv"), ring_grads, flat)]
    print(f"ring flash, loopback ring of {SP_SIZE} ({t_ring:.1f} ms forward + backward, "
          f"first call), against the flat kernels on B=1 S={SP_SEQ} H={H} KV={KV} D={D} "
          f"causal: " + ", ".join(f"{n} max_abs_err {e:.3e} (tol {t:.3e})"
                                  for n, e, t in errs))
    for n, e, t in errs:
        require(e <= t, f"the ring flash's {n} disagrees with the flat kernels")

    def ring_step():
        parts = [list(t.split(S, dim=1)) for t in leaves]
        o = ring_flash_attention_local(*parts, causal=True, ring=Ring.loopback(SP_SIZE))
        return torch.autograd.grad(o, leaves, list(do.split(S, dim=1)))

    # the bound: the sum of its hops' (two diagonal, a past and a future hop),
    # forward, dq and dk/dv each
    hop_bytes = (2 * (2 * q.numel() // 2 + k.numel() // 2 + v.numel() // 2) + 4 * H * S,
                 2 * (4 * q.numel() // 2 + k.numel() // 2 + v.numel() // 2) + 8 * H * S,
                 2 * (2 * q.numel() // 2 + 2 * k.numel() // 2 + 2 * v.numel() // 2)
                 + 8 * H * S)
    ring_bound = sum(bound(f * D * pairs, nb)[0]
                     for pairs in (H * S * (S + 1) / 2, H * S * (S + 1) / 2, H * S * S, 0)
                     for f, nb in zip((4, 6, 8), hop_bytes))
    ft = [t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*ft, is_causal=True, enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    lib_ms = (timer(lambda: F.scaled_dot_product_attention(*(t.detach() for t in ft),
                                                           is_causal=True, enable_gqa=True))
              + timer(lambda: torch.autograd.grad(lib_out, ft, dot, retain_graph=True)))
    print(f"ring flash, loopback ring of {SP_SIZE}, B=1 S={SP_SEQ} H={H} KV={KV} D={D} "
          f"causal, forward + backward: {timer(ring_step, iters=5, warmup=1):.4f} ms "
          f"(Timer, median of 5), bound {ring_bound:.4f} ms (the sum of its hops' bounds), "
          f"library {lib_ms:.4f} ms (SDPA forward + backward of the flat sequence)")
    del q, k, v, do, leaves, chunks, outs, ring_grads, o, lse, flat, ft, lib_out, dot
    torch.cuda.empty_cache()
    return rows


def check_bias_grad(gen, timer):
    """The broadcast-bias gradient kernel: [1, 16, 2048, 2048] fp32 at B=4
    D=64 causal (the attention_bias path's shape), timed with the wrapper's
    host us a call; then [4, 1, S, S] and [1, 1, S, S] at S=512 (causal,
    with segment ids; bf16 and fp32), and [1, 8, 384, 384] non-causal; then,
    from a generator of their own, head dim 128 (a ragged S of 320, and a
    bf16 [B, 1, 300, 300] bias with segment ids, non-causal: rows not whole
    16-byte chunks), ALiBi slopes with an fp32 bias, a bf16 [1, 16, 512, 512]
    bias, and ALiBi with segment ids on [1, 1, 320, 320] at a GQA group of
    4; each against its plain version on the same delta, two runs bitwise
    equal. Returns the timed row."""
    tol = 1e-2  # of the largest value: dp and the score from bf16 products

    def one(B, S, H, KV, bias, causal, seg=None, D=64, slopes=None, rng=gen):
        def rand(*shape):
            return torch.randn(*shape, generator=rng, device="cuda", dtype=BF16)

        q, k, v, do = rand(B, S, H, D), rand(B, S, KV, D), rand(B, S, KV, D), rand(B, S, H, D)
        o, lse = fa.flash_attention_fwd(q, k, v, causal, slopes, bias=bias, segment_ids=seg)
        _, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, causal, slopes, bias=bias,
                                             segment_ids=seg)
        db = fa.flash_attention_bias_grad(q, k, v, bias, lse, delta, do, causal, slopes,
                                          segment_ids=seg)
        again = fa.flash_attention_bias_grad(q, k, v, bias, lse, delta, do, causal, slopes,
                                             segment_ids=seg)
        ref = fa.flash_attention_bias_grad_plain(q, k, v, bias, lse, delta, do, causal,
                                                 slopes, segment_ids=seg)
        err, m = max_err(db, ref), ref.float().abs().max().item()
        same = torch.equal(db, again)
        print(f"flash_attention_bias_grad bias {tuple(bias.shape)} {bias.dtype} B={B} "
              f"S={S} H={H} KV={KV} D={D} causal={causal} segments={seg is not None} "
              f"ALiBi={slopes is not None}: max_abs_err {err:.3e} (tol {tol}*{m:.3e}); "
              f"two runs bitwise equal {same}")
        require(err <= tol * m and same, "flash_attention_bias_grad disagrees or is "
                "not deterministic")
        return q, k, v, do, o, lse, delta, err

    def rand(*shape, dtype=BF16, rng=gen):
        return torch.randn(*shape, generator=rng, device="cuda", dtype=dtype)

    seg = torch.from_numpy(packed_rows(4, 512, PACKED_SEED)[0]).int().cuda()
    one(4, 512, 16, 4, 0.3 * rand(4, 1, 512, 512, dtype=torch.float32), True, seg)
    one(4, 512, 16, 16, 0.3 * rand(1, 1, 512, 512), True, seg)
    one(2, 384, 8, 2, 0.3 * rand(1, 8, 384, 384, dtype=torch.float32), False)
    own = torch.Generator(device="cuda").manual_seed(67)
    f32 = torch.float32
    one(2, 320, 8, 2, 0.3 * rand(1, 8, 320, 320, dtype=f32, rng=own), True, D=128, rng=own)
    seg300 = torch.from_numpy(packed_rows(2, 300, PACKED_SEED + 1)[0]).int().cuda()
    one(2, 300, 8, 8, 0.3 * rand(2, 1, 300, 300, rng=own), False, seg300, D=128, rng=own)
    one(2, 512, 16, 4, 0.3 * rand(1, 16, 512, 512, dtype=f32, rng=own), True,
        slopes=alibi_slopes(16).cuda(), rng=own)
    one(4, 512, 16, 16, 0.3 * rand(1, 16, 512, 512, rng=own), True, rng=own)
    seg320 = torch.from_numpy(packed_rows(3, 320, PACKED_SEED + 2)[0]).int().cuda()
    one(3, 320, 4, 1, 0.3 * rand(1, 1, 320, 320, dtype=f32, rng=own), False, seg320,
        slopes=alibi_slopes(4).cuda(), rng=own)
    B, S, H = 4, TRAIN_S, 16
    bias = 0.3 * rand(1, H, S, S, dtype=torch.float32)
    q, k, v, do, o, lse, delta, err = one(B, S, H, H, bias, True)
    pairs = B * H * S * (S + 1) / 2
    nbytes = 2 * 2 * (q.numel() + k.numel()) + 2 * 4 * B * H * S + 4 * H * S * (S + 1) / 2 \
        + 4 * bias.numel()
    b_ms, b_by = bound(4 * 64 * pairs, nbytes)
    from contextlib import nullcontext

    from torch.nn.attention import SDPBackend, sdpa_kernel

    lib_ms, lib_note = None, "none"
    vis = torch.ones(S, S, dtype=torch.bool, device="cuda").tril()
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    lib_mask = bias.masked_fill(~vis, float("-inf")).to(BF16).requires_grad_(True)
    # SDPA's own choice of backend, then its math backend
    for backend, scope in (("", nullcontext), (", math backend",
                                                lambda: sdpa_kernel(SDPBackend.MATH))):
        try:
            with scope():
                lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=lib_mask)
                lib_ms = timer(lambda: torch.autograd.grad(lib_out, (lib_mask,), dot,
                                                           retain_graph=True))
            lib_note = "SDPA backward wrt a bf16 float mask, all gradients" + backend
            break
        except RuntimeError as e:
            print(f"flash_attention_bias_grad library: SDPA backward wrt a broadcast "
                  f"mask refused{backend} ({str(e)[:100]})")
        finally:
            lib_out = None
    row = {
        "max_abs_err": err,
        "ms": timer(lambda: fa.flash_attention_bias_grad(q, k, v, bias, lse, delta, do)),
        "host_us": host_us(lambda: fa.flash_attention_bias_grad(q, k, v, bias, lse, delta,
                                                                do), calls=50),
        "plain_ms": timer(lambda: fa.flash_attention_bias_grad_plain(q, k, v, bias, lse,
                                                                     delta, do)),
        "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
        "shape": f"bias [1, {H}, {S}, {S}] fp32, B={B} H={H} D=64 causal (library: "
                 f"{lib_note})",
    }
    del q, k, v, do, o, lse, delta, bias, qt, kt, vt, lib_mask
    torch.cuda.empty_cache()
    return row


def reference_check(model=None, label: str = "", expect=SERVING_KERNELS):
    """Two-layer full-width ``model`` (Llama-3-8B by default) in bf16: the
    kernel path (flash prefill, decode kernel, RMSNorm or LayerNorm kernel,
    the ALiBi forms for BLOOM) against the plain path on the same weights,
    prefill of 160 tokens then three cached decode steps; every kernel of
    ``expect`` must have run on the kernel path."""
    tol = 2e-2
    model = model or llama("llama3-8b", num_layers=2)
    cfg = model.config
    eng = init_inference(model, dtype=BF16, replace_with_kernel_inject=True,
                         max_tokens=1024,
                         rng=torch.Generator(device="cuda").manual_seed(1))
    ids = torch.randint(0, cfg.vocab_size, (2, 163),
                        generator=torch.Generator().manual_seed(1)).cuda()

    def run():
        cache = init_cache(cfg, 2, 256, BF16, "cuda")
        logits, _ = forward_with_cache(cfg, eng.params, ids[:, :160], cache, 0)
        outs = [logits]
        for pos in range(160, 163):
            logits, _ = forward_with_cache(cfg, eng.params, ids[:, pos:pos + 1],
                                           cache, pos)
            outs.append(logits)
        return torch.cat(outs, dim=1)

    with torch.inference_mode():
        kernels.reset_launch_counts()
        with attention_impl("auto"), kernel_rmsnorm_scope(True):
            got = run()
            fwd = apply(cfg, eng.params, ids[:, :160])
        counts = kernels.launch_counts()
        with attention_impl("plain"), kernel_rmsnorm_scope(False):
            want = run()
    require(bool(torch.isfinite(got).all()), "non-finite logits on the kernel path")
    rel = ((got - want).norm() / want.norm()).item()
    rel_fwd = ((fwd - want[:, :160]).norm() / want[:, :160].norm()).item()
    print(f"reference check {label}({cfg.name}, 2 layers, full width): relative L2 "
          f"error cached {rel:.3e}, no-cache forward {rel_fwd:.3e} (tol {tol}); "
          f"launches { {k: counts[k] for k in expect} }")
    require(rel <= tol and rel_fwd <= tol,
            f"{cfg.name}: kernel path disagrees with the plain path")
    require(all(counts[k] > 0 for k in expect),
            f"{cfg.name} reference check: a kernel of {expect} did not run")
    del eng
    torch.cuda.empty_cache()


def serving_requests(V: int):
    """The three serving requests: (name, prompt, generate arguments)."""
    host = torch.Generator().manual_seed(0)
    return [
        ("greedy B=1 P=100 new=16", torch.randint(0, V, (1, 100), generator=host),
         dict(max_new_tokens=16)),
        ("greedy B=4 P=512 new=32", torch.randint(0, V, (4, 512), generator=host),
         dict(max_new_tokens=32)),
        ("sampled B=2 P=37 new=8 T=0.8 top_k=50 top_p=0.9",
         torch.randint(0, V, (2, 37), generator=host),
         dict(max_new_tokens=8, temperature=0.8, top_k=50, top_p=0.9)),
    ]


def serve(engine, requests, report: bool, label: str = ""):
    """Each request through ``engine.generate`` (a seeded generator each),
    its output checked for shape, prompt echo and token range; with
    ``report`` the engine's prefill and decode times are printed."""
    V = engine.config.vocab_size
    outs = []
    for name, prompt, kw in requests:
        rng = torch.Generator(device="cuda").manual_seed(3)
        t0 = time.perf_counter()
        out = engine.generate(prompt, rng=rng, **kw)
        wall = time.perf_counter() - t0
        B, P = prompt.shape
        require(tuple(out.shape) == (B, P + kw["max_new_tokens"]),
                f"{name}: output shape {tuple(out.shape)}")
        require(bool((out[:, :P] == prompt).all()), f"{name}: prompt not echoed")
        require(bool(((out >= 0) & (out < V)).all()), f"{name}: token out of range")
        st = engine.last_generate_stats
        steps = st["decode_steps"]
        if report:
            tok_s = B * steps / (st["decode_ms"] / 1e3)
            print(f"request {label}{name}: prefill {st['prefill_ms']:.2f} ms "
                  f"(bucket {st['prompt_bucket']}), decode {steps} steps "
                  f"{st['decode_ms']:.2f} ms = {st['decode_ms'] / steps:.3f} "
                  f"ms/step, {tok_s:.1f} tok/s; wall {wall:.2f} s")
        outs.append(out)
    return outs


def main_path():
    """Llama-3-8B at full width and depth, seeded random bf16 weights."""
    model = llama("llama3-8b")
    cfg = model.config
    t0 = time.perf_counter()
    engine = init_inference(model, dtype=BF16, replace_with_kernel_inject=True,
                            max_tokens=1024,
                            rng=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"main path: {cfg.name} L={cfg.num_layers} d={cfg.hidden_size} "
          f"H={cfg.num_heads} KV={cfg.kv_heads} ffn={cfg.ffn} V={cfg.vocab_size}, "
          f"depth not cut; init {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    V = cfg.vocab_size
    requests = serving_requests(V)
    first = serve(engine, requests, report=False)  # first use of every shape
    kernels.reset_launch_counts()
    second = serve(engine, requests, report=True)
    counts = kernels.launch_counts()
    print(f"serving main path launches: { {k: counts[k] for k in SERVING_KERNELS} }")
    for name in SERVING_KERNELS:
        require(counts[name] > 0, f"kernel {name} was not launched on the serving path")
    for (name, _, _), a, b in zip(requests, first, second):
        require(torch.equal(a, b), f"{name}: tokens differ between two runs")
    print("reruns (greedy, and sampled with the same seed): identical tokens")

    # cost of the per-token host sync that an eos id adds (done.all()),
    # in turns: without, with, with, without
    _, prompt, kw = requests[0]
    per_step = {-1: [], V - 1: []}
    for eos in (-1, V - 1, V - 1, -1):
        engine.generate(prompt, eos_token_id=eos, **kw)
        st = engine.last_generate_stats
        per_step[eos].append(st["decode_ms"] / st["decode_steps"])
    print(f"host sync per token (B=1): ms/step with eos "
          f"{per_step[V - 1]} vs without {per_step[-1]}")
    launched = profile_device(lambda: engine.generate(prompt, **kw), "B=1 generate")
    forwards = engine.last_generate_stats["decode_steps"] + 1  # the prefill, then each step
    print(f"B=1 generate: {launched} kernel launches over {forwards} forwards (the "
          f"prefill and {forwards - 1} decode steps), {launched / forwards:.1f} a forward")
    del engine
    torch.cuda.empty_cache()
    return counts


def main_path_family(model, n_requests: int, expect, path: str):
    """A LayerNorm family (bloom-7b1, gpt2-xl) served at full width and depth
    with seeded random bf16 weights, kernel injection, max_tokens 1024: the
    first ``n_requests`` of the three serving requests, twice (the second
    run with the counters zeroed just before it); the tokens of the two runs
    must be equal, every kernel of ``expect`` must have run and the plain
    attention never on the card. Returns the second run's counts."""
    cfg = model.config
    t0 = time.perf_counter()
    engine = init_inference(model, dtype=BF16, replace_with_kernel_inject=True,
                            max_tokens=1024,
                            rng=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"{path}: {cfg.name} L={cfg.num_layers} d={cfg.hidden_size} H={cfg.num_heads} "
          f"hd={cfg.hd} ffn={cfg.ffn} V={cfg.vocab_size} {cfg.norm} {cfg.pos_embedding} "
          f"{cfg.activation} ({cfg.num_params() / 1e9:.3f} B params), depth not cut; "
          f"max_tokens {engine.max_tokens}; init {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    requests = serving_requests(cfg.vocab_size)[:n_requests]
    with torch.inference_mode():
        first = serve(engine, requests, report=False)  # first use of every shape
        kernels.reset_launch_counts()
        second = serve(engine, requests, report=True, label=f"{path} ")
    counts = kernels.launch_counts()
    plain = kernels.plain_attention_on_cuda()
    print(f"{path} main path launches: { {k: counts[k] for k in expect} }; plain "
          f"attention on the card {plain}")
    for name in expect:
        require(counts[name] > 0, f"kernel {name} was not launched on the {path} path")
    require(sum(plain.values()) == 0, f"{path}: plain attention ran on the card {plain}")
    for (name, _, _), a, b in zip(requests, first, second):
        require(torch.equal(a, b), f"{path} {name}: tokens differ between two runs")
    print(f"{path} reruns: identical tokens")
    _, prompt, kw = requests[0]
    profile_device(lambda: engine.generate(prompt, **kw), f"{path} B=1 generate")
    del engine
    torch.cuda.empty_cache()
    return counts


def tree_bytes(tree) -> int:
    """Bytes the parameter tree holds on the device (packed leaves: their
    int8 bytes and fp32 scales)."""
    return sum(t.nbytes if isinstance(t, PackedWeight) else t.numel() * t.element_size()
               for t in tree_leaves(tree))


def first_mismatch_is_near_tie(engine, want, got, P: int, what: str) -> None:
    """Speculative tokens ``got`` against the same engine's plain greedy
    ``want`` [1, P + new]: equal, or the first mismatch falls where the plain
    run's top-2 logits are within two bf16 ulps (printed, not failed); any
    other mismatch fails."""
    if torch.equal(got, want):
        return
    j = int((got != want).int().argmax())
    logits = engine.forward(want[:, :j])[0, -1]
    top2 = logits.topk(2).values.tolist()
    gap, tie = top2[0] - top2[1], 2 * bf16_ulp(top2[0])
    print(f"{what}: first mismatch at position {j} (plain {int(want[0, j])}, "
          f"speculative {int(got[0, j])}); plain top-2 logits {top2}, gap {gap:.3e} "
          f"against two bf16 ulps {tie:.3e}: "
          f"{'near-tie, not a fault' if gap < tie else 'FAULT'}")
    require(gap < tie, f"{what}: speculative tokens differ from plain greedy "
            "away from a near-tie")


def check_spec_full_acceptance(model, params, prompt) -> None:
    """Speculative decode with the packed main weights as the draft, four
    drafts a round (a window of k = 5 with the verifier's own token), 32 new
    tokens: the tokens must be the plain greedy tokens (a mismatch
    only at a near-tie) with the int8 KV cache and with the bf16 one. With
    the bf16 cache the draft (whose cache is in the compute dtype, as in the
    JAX engine) computes what plain decoding computes, so every proposal
    must be accepted: ceil((new - 1) / k) rounds. With the int8 cache the
    draft's bf16 cache differs from the verifier's, and the rounds are
    printed."""
    new, nd = 32, 4
    want_rounds = math.ceil((new - 1) / (nd + 1))
    for kv in ("int8", "auto"):
        kw = dict(dtype="int8", kv_cache_dtype=kv, replace_with_kernel_inject=True,
                  max_tokens=1024, params=params)
        eng = init_inference(model, **kw)
        spec = init_inference(model, draft_model=model, draft_params=params, **kw)
        plain = eng.generate(prompt, max_new_tokens=new)
        got = spec.generate(prompt, max_new_tokens=new, num_draft_tokens=nd)
        rounds = spec.last_spec_rounds
        print(f"speculative reference check (int8 weights, {kv} KV cache, draft = the "
              f"main weights, num_draft_tokens = {nd}, window k = {nd + 1}): "
              f"{rounds} rounds (full acceptance: {want_rounds}), tokens equal to plain greedy: {torch.equal(plain, got)}")
        first_mismatch_is_near_tie(eng, plain, got, prompt.shape[1],
                                   f"speculative reference check ({kv} KV)")
        if kv == "auto":
            require(rounds == want_rounds,
                    f"speculative reference check: {rounds} rounds, want {want_rounds}")
        del eng, spec


def reference_check_quantized():
    """Two-layer full-width Llama-3-8B with int8 (then int4) weights and the
    int8 KV cache: the kernel path (quantized matvec, int8 decode kernel,
    flash prefill, RMSNorm kernel) against the plain path (the dense product
    over the dequantized weights under matvec_max_rows_scope(0), the plain
    attention and norm) on the same weights, prefill of 160 tokens then
    three cached decode steps. Then speculative decode with the int8 main
    weights as the draft (:func:`check_spec_full_acceptance`)."""
    tol = 2e-2
    model = llama("llama3-8b", num_layers=2)
    cfg = model.config
    ids = torch.randint(0, cfg.vocab_size, (2, 163),
                        generator=torch.Generator().manual_seed(1)).cuda()
    for wdtype in ("int8", "int4"):
        eng = init_inference(model, dtype=wdtype, kv_cache_dtype="int8",
                             replace_with_kernel_inject=True, max_tokens=1024,
                             rng=torch.Generator(device="cuda").manual_seed(1))

        def run():
            cache = init_cache(cfg, 2, 256, BF16, "cuda", quantized=True)
            logits, _ = forward_with_cache(cfg, eng.params, ids[:, :160], cache, 0)
            outs = [logits]
            for pos in range(160, 163):
                logits, _ = forward_with_cache(cfg, eng.params, ids[:, pos:pos + 1],
                                               cache, pos)
                outs.append(logits)
            return torch.cat(outs, dim=1)

        with torch.inference_mode():
            kernels.reset_launch_counts()
            with attention_impl("auto"), kernel_rmsnorm_scope(True):
                got = run()
            counts = kernels.launch_counts()
            with attention_impl("plain"), kernel_rmsnorm_scope(False), \
                    qmm.matvec_max_rows_scope(0):
                want = run()
        require(bool(torch.isfinite(got).all()), f"non-finite {wdtype} logits")
        require(counts[f"quantized_matvec_{wdtype}"] > 0
                and counts["decode_attention_int8"] > 0,
                f"{wdtype} reference check: the kernels did not run: {counts}")
        rel = ((got - want).norm() / want.norm()).item()
        print(f"quantized reference check ({wdtype} weights, int8 KV, 2 layers, full "
              f"width): relative L2 error kernel vs plain path {rel:.3e} (tol {tol})")
        require(rel <= tol, f"{wdtype} kernel path disagrees with the plain path")
        if wdtype == "int8":
            check_spec_full_acceptance(model, eng.params, ids[:1, :100].cpu())
        del eng
        torch.cuda.empty_cache()


def main_path_quantized():
    """Llama-3-8B at full width and depth with seeded random weights: an
    int8-weight engine with the int8 KV cache on the three serving requests,
    an int4-weight engine on the greedy B=1 request, and speculative decode
    on the int8 engine with the "ngram" draft (a repetitive prompt) and a
    Llama-3.2-1B draft in bf16, and on the int8 weights with the bf16 cache
    drafted by the same weights, where every proposal must be accepted.
    Returns the launch counts of the second of two identical runs, counters
    zeroed just before it."""
    model = llama("llama3-8b")
    cfg = model.config
    V = cfg.vocab_size
    t0 = time.perf_counter()
    eng8 = init_inference(model, dtype="int8", kv_cache_dtype="int8",
                          replace_with_kernel_inject=True, max_tokens=1024,
                          rng=torch.Generator(device="cuda").manual_seed(0))
    eng4 = init_inference(model, dtype="int4", replace_with_kernel_inject=True,
                          max_tokens=1024,
                          rng=torch.Generator(device="cuda").manual_seed(0))
    ngram = init_inference(model, dtype="int8", kv_cache_dtype="int8",
                           replace_with_kernel_inject=True, max_tokens=1024,
                           params=eng8.params, draft_model="ngram")
    drafted = init_inference(model, dtype="int8", kv_cache_dtype="int8",
                             replace_with_kernel_inject=True, max_tokens=1024,
                             params=eng8.params, draft_model=llama("llama3-1b"))
    # the int8 weights with the bf16 KV cache, plain and drafting with its
    # own weights: every proposal must be accepted at full depth too
    eng8bf = init_inference(model, dtype="int8", replace_with_kernel_inject=True,
                            max_tokens=1024, params=eng8.params)
    selfd = init_inference(model, dtype="int8", replace_with_kernel_inject=True,
                           max_tokens=1024, params=eng8.params, draft_model=model,
                           draft_params=eng8.params)
    torch.cuda.synchronize()
    b8, b4, bd = tree_bytes(eng8.params), tree_bytes(eng4.params), \
        tree_bytes(drafted.draft_params)
    dense = 2 * cfg.num_params()
    print(f"quantized main path: {cfg.name} full depth; init {time.perf_counter() - t0:.1f} s; "
          f"weights resident: int8 {b8 / 1e9:.3f} GB, int4 {b4 / 1e9:.3f} GB, bf16 "
          f"would be {dense / 1e9:.3f} GB; the llama3-1b draft {bd / 1e9:.3f} GB; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    requests = serving_requests(V)
    B, P = requests[1][1].shape
    new = requests[1][2]["max_new_tokens"]
    slots = 2 * cfg.num_layers * B * cfg.kv_heads * (P + new)
    kv8, kv16 = slots * (cfg.hd + 4), slots * cfg.hd * 2
    print(f"KV cache for B={B} P={P} (+{new}): int8 {kv8 / 1e6:.1f} MB (values and one "
          f"fp32 scale per token and head) against bf16 {kv16 / 1e6:.1f} MB, "
          f"{kv8 / kv16:.3f}x")
    greedy = requests[0]
    rep = torch.tensor([[11, 7, 3, 9, 5] * 20])  # a repetitive prompt, 100 tokens
    # (label, speculative engine, plain engine, prompt)
    spec_runs = [("ngram, int8 KV", ngram, eng8, rep),
                 ("llama3-1b draft, int8 KV", drafted, eng8, greedy[1]),
                 ("its own weights as the draft, bf16 KV", selfd, eng8bf, greedy[1])]

    def run_all(report: bool):
        outs = serve(eng8, requests, report, "int8+int8-KV ")
        outs += serve(eng4, requests[:1], report, "int4 ")
        for label, eng, plain_eng, prompt in spec_runs:
            plain = plain_eng.generate(prompt, max_new_tokens=SPEC_NEW)
            plain_ms = plain_eng.last_generate_stats["decode_ms"]
            got = eng.generate(prompt, max_new_tokens=SPEC_NEW, num_draft_tokens=4)
            st = eng.last_generate_stats
            if report:
                print(f"speculative (int8 weights, {label}, num_draft_tokens = 4, "
                      f"window k = 5) B=1 P=100 new={SPEC_NEW}: {eng.last_spec_rounds} "
                      f"rounds for {SPEC_NEW - 1} tokens, "
                      f"{st['decode_ms']:.2f} ms after the prefill (plain greedy "
                      f"{plain_ms:.2f} ms); tokens equal to plain greedy: "
                      f"{torch.equal(plain, got)}")
            first_mismatch_is_near_tie(plain_eng, plain, got, 100,
                                       f"speculative ({label})")
            outs += [plain, got]
        require(selfd.last_spec_rounds == math.ceil((SPEC_NEW - 1) / 5),
                f"self-drafted speculative decode took {selfd.last_spec_rounds} "
                f"rounds, want {math.ceil((SPEC_NEW - 1) / 5)} (every proposal accepted)")
        return outs

    with torch.inference_mode():
        first = run_all(report=False)  # first use of every shape
        kernels.reset_launch_counts()
        second = run_all(report=True)
    counts = kernels.launch_counts()
    print(f"quantized serving main path launches: "
          f"{ {k: counts[k] for k in QUANT_SERVING_KERNELS} }")
    for name in QUANT_SERVING_KERNELS:
        require(counts[name] > 0,
                f"kernel {name} was not launched on the quantized serving path")
    for i, (a, b) in enumerate(zip(first, second)):
        require(torch.equal(a, b), f"quantized main path output {i} differs between runs")
    print(f"reruns: identical tokens ({len(first)} outputs: greedy, speculative, and "
          "sampled with the same seed)")
    _, prompt, kw = greedy
    profile_device(lambda: eng8.generate(prompt, **kw), "int8 B=1 generate")
    del eng8, eng4, ngram, drafted, eng8bf, selfd
    torch.cuda.empty_cache()
    return counts


def reference_check_serving_cb():
    """Two-layer full-width Llama-3-8B: the continuous-batching step's
    forward (per-slot frontiers, padded rows, the head on each slot's last
    real row) on the kernel path (decode kernels with rows_per_seq = 64,
    RMSNorm kernel) against the plain path on the same weights, over a paged
    pool with shuffled pages (bf16 and int8 KV) and a contiguous arena: a
    first step of eight 64-token prompt chunks, then a step of one chunk at
    64, six decode rows at 64 and an idle slot."""
    tol = 2e-2
    N, W, ps = CB_SLOTS, CB_BUDGET, CB_PAGE
    model = llama("llama3-8b", num_layers=2)
    cfg = model.config
    eng = init_inference(model, dtype=BF16, replace_with_kernel_inject=True,
                         max_tokens=1024, rng=torch.Generator(device="cuda").manual_seed(1))
    ids = torch.randint(0, cfg.vocab_size, (N, 2 * W),
                        generator=torch.Generator().manual_seed(2)).cuda()
    mp = 8
    table = torch.randperm(N * mp, generator=torch.Generator().manual_seed(3)).int()
    table = table.reshape(N, mp).cuda()
    n2 = torch.tensor([W] + [1] * 6 + [0], device="cuda")
    steps = [(ids[:, :W], torch.zeros(N, dtype=torch.int32, device="cuda"),
              torch.full((N,), W, device="cuda")),
             (ids[:, W:], torch.full((N,), W, dtype=torch.int32, device="cuda"), n2)]

    def run(paged: bool, int8: bool):
        cache = (init_paged_cache(cfg, N * mp, ps, BF16, "cuda", quantized=int8) if paged
                 else init_cache(cfg, N, 256, BF16, "cuda", quantized=int8))
        outs = []
        for toks, start, n in steps:
            valid = torch.arange(W, device="cuda")[None, :] < n[:, None]
            head = (n - 1).clamp_min(0)[:, None]
            logits, _ = forward_with_cache(cfg, eng.params, toks, cache, start,
                                           page_table=table if paged else None,
                                           token_valid=valid, head_rows=head)
            outs.append(logits[:7])  # the idle slot's row is not read
        return torch.cat(outs, dim=1)

    with torch.inference_mode():
        for paged, int8 in ((True, False), (True, True), (False, False)):
            with attention_impl("auto"), kernel_rmsnorm_scope(True):
                got = run(paged, int8)
            with attention_impl("plain"), kernel_rmsnorm_scope(False):
                want = run(paged, int8)
            require(bool(torch.isfinite(got).all()), "non-finite serving step logits")
            rel = ((got - want).norm() / want.norm()).item()
            print(f"serving_cb reference check (2 layers, full width, "
                  f"{'paged' if paged else 'contiguous'}, {'int8' if int8 else 'bf16'} "
                  f"KV): relative L2 error kernel vs plain path {rel:.3e} (tol {tol})")
            require(rel <= tol, "serving step kernel path disagrees with the plain path")
    del eng
    torch.cuda.empty_cache()


def cb_trace(V: int, seed: int = 7):
    """The serving_cb trace, 24 requests (id, prompt, max_new_tokens,
    sampling arguments, id that must have finished first): prompts of 16-700
    tokens, 8-32 new tokens, odd requests sampled (T 0.8, top-k 50, top-p
    0.9); requests 0, 12, 14, 16, 18 and 20 share a 250-token prefix (not a
    multiple of the 16-token page, so a sharer diverges inside a shared page
    and copies it); requests 22 and 23 repeat the prompts of 1 and 2 once
    those have finished (the prefix cache then covers all but their last
    prompt token)."""
    r = np.random.RandomState(seed)
    prefix = r.randint(0, V, 250)
    sharers = (0, 12, 14, 16, 18, 20)
    out = []
    for i in range(22):
        if i in sharers:
            tail = 16 if i == 0 else r.randint(16, 451)
            prompt = np.concatenate([prefix, r.randint(0, V, tail)])
        else:
            prompt = r.randint(0, V, r.randint(16, 701))
        kw = dict(temperature=0.8, top_k=50, top_p=0.9) if i % 2 else {}
        out.append((f"cb{i}", prompt, 8 if i == 0 else int(r.randint(8, 33)), kw, None))
    for j, i in enumerate((1, 2)):
        _, prompt, new, kw, _ = out[i]
        out.append((f"cb{22 + j}", prompt, new, kw, f"cb{i}"))
    return out


def drive_cb(srv, trace, max_steps=None):
    """8 requests arrive at once, then 2 after every step (a repeat waits for
    the request it repeats to finish); steps until idle, or ``max_steps``.
    Returns ({id: state}, host ms of each step, whether each step fed a
    prompt chunk)."""
    pending, states, step_ms, chunked = list(trace), {}, [], []

    def arrive(n):
        while pending and n > 0:
            rid, prompt, new, kw, after = pending[0]
            if after is not None and not states[after].finished:
                return
            states[rid] = srv.submit(Request(rid, prompt, max_new_tokens=new, **kw))
            pending.pop(0)
            n -= 1

    arrive(8)
    while pending or srv.scheduler.has_work:
        if max_steps is not None and len(step_ms) >= max_steps:
            break
        chunks = srv.metrics.prefill_chunks
        t0 = time.perf_counter()
        srv.step()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        chunked.append(srv.metrics.prefill_chunks > chunks)
        arrive(2)
    return states, step_ms, chunked


def serve_cb(srv, trace, label: str):
    """One serving_cb run through ``srv``, counters zeroed just before:
    every request must finish with its tokens in range; the step shape
    stays one; the page pool's invariants hold at the end (paged); the plain
    attention never runs on the card. Prints the run's numbers and returns
    (outputs by id, launch counts)."""
    V = srv.config.vocab_size
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    states, step_ms, chunked = drive_cb(srv, trace)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    plain = kernels.plain_attention_on_cuda()
    peak = torch.cuda.max_memory_allocated()
    outs = {}
    for rid, prompt, new, _, _ in trace:
        st = states[rid]
        require(st.status is RequestStatus.DONE and len(st.tokens) == new,
                f"{label} {rid}: {st.status.value} with {len(st.tokens)}/{new} tokens")
        out = st.output()
        require(bool(((out >= 0) & (out < V)).all()) and (out[:prompt.size] == prompt).all(),
                f"{label} {rid}: tokens out of range or prompt not echoed")
        outs[rid] = out
    require(srv.step_traces == 1, f"{label}: {srv.step_traces} step shapes, want 1")
    require(sum(plain.values()) == 0, f"{label}: plain attention ran on the card {plain}")
    m = srv.metrics.snapshot()
    gen = sum(len(st.tokens) for st in states.values())

    def pct(xs, p):
        xs = sorted(xs)
        return xs[int(round(p / 100 * (len(xs) - 1)))] if xs else float("nan")

    mixed = [t for t, c in zip(step_ms, chunked) if c]
    decode_only = [t for t, c in zip(step_ms, chunked) if not c]
    print(f"serving_cb {label}: {len(step_ms)} steps, {gen} generated tokens, "
          f"{m['scheduled_tokens']} tokens fed, wall {wall:.3f} s, {gen / wall:.1f} "
          f"generated tok/s, {m['scheduled_tokens'] / wall:.1f} fed tok/s; step ms p50 "
          f"{pct(step_ms, 50):.3f} p95 {pct(step_ms, 95):.3f} (with a prompt chunk: "
          f"{len(mixed)} steps, p50 {pct(mixed, 50):.3f}; decode rows only: "
          f"{len(decode_only)} steps, p50 {pct(decode_only, 50):.3f}); TTFT p50 "
          f"{m['ttft_p50_s'] * 1e3:.1f} ms p95 {m['ttft_p95_s'] * 1e3:.1f} ms; TPOT p50 "
          f"{m['tpot_p50_s'] * 1e3:.2f} ms; prefix hits {m['prefix_hits']} "
          f"({m['cached_prompt_tokens']} tokens), COW copies {m['cow_copies']}, prefill "
          f"chunks {m['prefill_chunks']}; {'pool' if srv.paged else 'arena'} "
          f"{srv.arena_bytes / 1e9:.3f} GB; peak memory {peak / 2**30:.2f} GiB; "
          f"plain attention on the card {plain}")
    if srv.paged:
        sched = srv.scheduler
        sched.assert_page_invariants()
        held = len(sched.prefix_cache.held_pages)
        require(sched.pool.free_count + sched.pool.live_count == sched.num_pages
                and all(s is None for s in sched.slots),
                f"{label}: page pool invariants at the end")
        if "cb22" in states:  # the whole trace, with its repeats and sharers
            for rep in ("cb22", "cb23"):
                st = states[rep]
                require(st.cached_tokens == st.prompt_len - 1,
                        f"{label} {rep}: {st.cached_tokens} cached of {st.prompt_len}, "
                        "the repeated prompt must skip its prefill")
            require(m["cow_copies"] >= 1 and m["prefix_hits"] >= 2,
                    f"{label}: prefix reuse and copy-on-write did not happen")
        print(f"serving_cb {label}: pool invariants hold (free {sched.pool.free_count} + "
              f"live {sched.pool.live_count} = {sched.num_pages}; {held} prefix-cache "
              "references)" + ("; the two repeats fed only their last prompt token"
                               if "cb22" in states else ""))
    return outs, counts


def cb_serving(paged: bool):
    return {"max_slots": CB_SLOTS, "token_budget": CB_BUDGET, "max_tokens": 1024,
            "paged": paged, "page_size": CB_PAGE}


def main_path_serving_cb():
    """Continuous-batching serving of Llama-3-8B at full width and depth:
    init_serving with seeded random bf16 weights and kernel injection, the
    24-request trace (:func:`cb_trace`) through four engines sharing the
    weights: the contiguous and the paged arena, each with bf16 and int8 KV.
    Each request's tokens must be bitwise equal between the two arenas, greedy
    and sampled, in each KV dtype; a rerun gives identical tokens; then a
    profiled window of 20 steps. Returns the launches of the four runs,
    counters zeroed just before each."""
    model = llama("llama3-8b")
    cfg = model.config
    t0 = time.perf_counter()
    first = init_serving(model, serving=cb_serving(False), dtype=BF16,
                         replace_with_kernel_inject=True,
                         rng=torch.Generator(device="cuda").manual_seed(0))
    engine = first.engine
    engine8 = init_inference(model, dtype=BF16, kv_cache_dtype="int8",
                             replace_with_kernel_inject=True, max_tokens=1024,
                             params=engine.params)
    torch.cuda.synchronize()
    print(f"serving_cb: {cfg.name} L={cfg.num_layers} full depth, slots={CB_SLOTS}, "
          f"token_budget={CB_BUDGET}, page_size={CB_PAGE}, max_tokens=1024; init "
          f"{time.perf_counter() - t0:.1f} s; step rows {CB_SLOTS * CB_BUDGET} through "
          f"the projections: {2 * cfg.num_params() * CB_SLOTS * CB_BUDGET / 1e12:.2f} "
          "TFLOP a step")
    trace = cb_trace(cfg.vocab_size)
    totals = {name: 0 for name in kernels.launch_counts()}
    outs = {}
    for kv, eng in (("bf16", engine), ("int8", engine8)):
        for paged in (False, True):
            srv = first if (kv, paged) == ("bf16", False) else \
                init_serving(serving=cb_serving(paged), engine=eng)
            label = f"{'paged' if paged else 'contiguous'} {kv} KV"
            with torch.inference_mode():
                outs[(kv, paged)], counts = serve_cb(srv, trace, label)
            for name in totals:
                totals[name] += counts[name]
            want = ("paged_" if paged else "") + "decode_attention" + \
                ("_int8" if kv == "int8" else "")
            require(counts[want] > 0 and counts["rmsnorm_fwd"] > 0,
                    f"serving_cb {label}: {want} or rmsnorm_fwd not launched: {counts}")
            del srv
            torch.cuda.empty_cache()
        diff = [rid for rid in outs[(kv, False)]
                if not np.array_equal(outs[(kv, False)][rid], outs[(kv, True)][rid])]
        print(f"serving_cb {kv} KV: paged == contiguous bitwise for "
              f"{len(outs[(kv, False)]) - len(diff)}/{len(trace)} requests (12 greedy, "
              f"12 sampled); differ: {diff}")
        require(not diff, f"serving_cb {kv} KV: paged and contiguous outputs differ")
    with torch.inference_mode():
        again, _ = serve_cb(init_serving(serving=cb_serving(True), engine=engine), trace,
                            "paged bf16 KV rerun")
    same = all(np.array_equal(again[rid], outs[("bf16", True)][rid]) for rid in again)
    print(f"serving_cb rerun (paged, bf16 KV): identical tokens: {same}")
    require(same, "serving_cb: the rerun gave other tokens")

    def window():
        srv = init_serving(serving=cb_serving(True), engine=engine)
        with torch.inference_mode():
            drive_cb(srv, trace, max_steps=20)

    profile_device(window, "serving_cb paged bf16 KV, first 20 steps of the trace")
    print(f"serving_cb launches (four runs): { {k: totals[k] for k in CB_KERNELS} }")
    del first, engine, engine8
    torch.cuda.empty_cache()
    return totals


@contextlib.contextmanager
def routing(store: list):
    """Record every routed MLP call's routing into ``store``, in call order:
    (router logits [N, E], the expert each token was kept at in each round
    [N, K] (-1: dropped), the fill of each expert [E], the capacity)."""
    real = smoe.top_k_gating_indices

    def spy(logits, top_k, capacity, *args, **kw):
        out = real(logits, top_k, capacity, *args, **kw)
        kept = torch.where(out[3] > 0, out[2] // capacity, -1)
        store.append((logits.detach().clone(), kept, out[4]["tokens_per_expert"].clone(),
                      capacity))
        return out

    smoe.top_k_gating_indices = spy
    try:
        yield
    finally:
        smoe.top_k_gating_indices = real


def check_moe_layer(cfg, params, wdtype: str) -> None:
    """One MoE layer (layer 0 of ``params``) on a fixed seeded input of the
    decode step's shape (B = 4, S = 1: C = 4 rows an expert, the expert
    kernel's path). The router sees the same input on every path, so all
    route alike: the kernel path against the plain fold
    (packed_expert_matvec_plain) within a relative L2 error of 1e-3 (fp32
    sums in another order, then bf16 roundings), and against the product
    over the bank dequantized to bf16 (matvec_max_rows_scope(0)) within
    1e-2 (the weights rounded to bf16 first)."""
    require(not torch.backends.cuda.matmul.allow_tf32,
            "fp32 matmuls fall to TF32: the router would lose precision")
    lp = layer_params(params["layers"], 0)["mlp"]
    x = torch.randn(4, 1, cfg.hidden_size, generator=torch.Generator(device="cuda")
                    .manual_seed(5), device="cuda", dtype=BF16)
    kernels.reset_launch_counts()
    got, gst = smoe.moe_serving_mlp(cfg, lp, x)
    ran = kernels.launch_counts()[f"quantized_matvec_expert_{wdtype}"]
    real = smoe.packed_expert_proj
    smoe.packed_expert_proj = lambda xe, w: qmm.packed_expert_matvec_plain(xe.contiguous(), w)
    try:
        fold, fst = smoe.moe_serving_mlp(cfg, lp, x)
    finally:
        smoe.packed_expert_proj = real
    with qmm.matvec_max_rows_scope(0):
        deq, dst_ = smoe.moe_serving_mlp(cfg, lp, x)
    same = all(torch.equal(gst["tokens_per_expert"], st["tokens_per_expert"])
               for st in (fst, dst_))
    r_fold, r_deq = rel_l2(got, fold), rel_l2(got, deq)
    print(f"MoE layer ({wdtype} banks, fixed input B=4 S=1, C=4): expert kernel ran "
          f"{ran}x; same routing on every path: {same}; relative L2 error against the "
          f"plain fold {r_fold:.3e} (tol 1e-3), against the dequantized product "
          f"{r_deq:.3e} (tol 1e-2); tokens per expert "
          f"{gst['tokens_per_expert'].tolist()}")
    require(ran == 3 and same, f"MoE layer {wdtype}: the kernel did not run, or routing differs")
    require(r_fold <= 1e-3 and r_deq <= 1e-2, f"MoE layer {wdtype}: kernel path disagrees")


def routing_differences(got, want, B: int, S: int, L: int, tol: float):
    """Where the kernel path routed a token otherwise than the plain path,
    call by call (the prefill, then one call a decode step, each over the L
    layers): its ordered top-2 choice flipped, or capacity kept it at other
    experts. Capacity couples the tokens of a call (Mixtral's 2·2 < 8
    experts: an expert that fills drops the later tokens' assignments), so
    after the first difference anything in that call or later may differ.
    The first call with a difference saw router inputs that differ only by
    the two paths' numerics; each choice flip there must be a near-tie: the
    largest difference of the token's router logits between the paths is
    within ``tol`` of its largest logit (and so the flipped gap, at most
    twice that difference, is small too). Returns ({row: first position with
    a difference in any call}, a printable account of the first call)."""
    first, account = {}, None
    for c, ((lk, kk, fill, cap), (lp, kp, _, _)) in enumerate(zip(got, want)):
        step, layer = divmod(c, L)
        flip = (lk.topk(2, dim=-1).indices != lp.topk(2, dim=-1).indices).any(dim=-1)
        diff = flip | (kk != kp).any(dim=-1)
        if not bool(diff.any()):
            continue
        where = [(t // S, t % S) if step == 0 else (t, S + step - 1)
                 for t in range(diff.numel())]
        if account is None:
            srt = lp.sort(dim=-1, descending=True).values
            gap = torch.minimum(srt[:, 0] - srt[:, 1], srt[:, 1] - srt[:, 2])
            delta, scale = (lk - lp).abs().amax(dim=-1), lp.abs().amax(dim=-1)
            flips = []
            for t in flip.nonzero().flatten().tolist():
                b, pos = where[t]
                g, d, sc = gap[t].item(), delta[t].item(), scale[t].item()
                flips.append((f"row {b} pos {pos}", round(g, 5), round(d, 5), round(sc, 3)))
                require(d <= tol * sc, f"layer {layer} row {b} pos {pos}: routing flipped "
                        f"on router logits {d:.3e} apart (scale {sc:.3e}): not a near-tie")
            require(bool(flip.any()), f"layer {layer}: tokens kept at other experts with "
                    "no choice flip")
            moved = int((diff & ~flip).sum())
            account = (f"first difference in layer {layer} "
                       f"{'prefill' if step == 0 else f'decode step {step}'}: {len(flips)} "
                       f"choice flips, each a near-tie (where, plain top-3 gap, router "
                       f"logit difference, largest logit): {flips[:6]}; {moved} tokens kept "
                       f"elsewhere by capacity ({int((fill >= cap).sum())} experts full at "
                       f"capacity {cap})")
        for t in diff.nonzero().flatten().tolist():
            b, pos = where[t]
            first[b] = min(first.get(b, pos), pos)
    return first, account or "no routing difference"


def reference_check_mixtral():
    """Two-layer full-width Mixtral-8x7B with int8 (then int4) weights and
    the int8 KV cache: first one MoE layer on a fixed input
    (:func:`check_moe_layer`); then the kernel path (the expert and 2-D
    matvecs, int8 decode kernel, flash prefill, RMSNorm kernel) against the
    plain path (the products over the dequantized weights under
    matvec_max_rows_scope(0), the plain attention and norm) on the same
    weights, prefill of 160 tokens then three cached decode steps. A router
    near-tie can flip a token's experts between the paths (one bf16 ulp of
    hidden state is enough), and capacity then moves other tokens' drops:
    the first difference must be a near-tie (:func:`routing_differences`),
    and the logits of the tokens before their row's first routing
    difference must agree within the tolerance (relative L2); with no
    difference, all of them."""
    tol = 2e-2
    model = mixtral("mixtral-8x7b", num_layers=2)
    cfg = model.config
    B, S = 2, 160
    ids = torch.randint(0, cfg.vocab_size, (B, S + 3),
                        generator=torch.Generator().manual_seed(1)).cuda()
    for wdtype in ("int8", "int4"):
        eng = init_inference(model, dtype=wdtype, kv_cache_dtype="int8",
                             replace_with_kernel_inject=True, max_tokens=1024,
                             rng=torch.Generator(device="cuda").manual_seed(1))

        def run():
            cache = init_cache(cfg, B, 256, BF16, "cuda", quantized=True)
            logits, _ = forward_with_cache(cfg, eng.params, ids[:, :S], cache, 0)
            outs = [logits]
            for pos in range(S, S + 3):
                logits, _ = forward_with_cache(cfg, eng.params, ids[:, pos:pos + 1],
                                               cache, pos)
                outs.append(logits)
            return torch.cat(outs, dim=1)

        with torch.inference_mode():
            check_moe_layer(cfg, eng.params, wdtype)
            got_r, want_r = [], []
            kernels.reset_launch_counts()
            with attention_impl("auto"), kernel_rmsnorm_scope(True), routing(got_r):
                got = run()
            counts = kernels.launch_counts()
            with attention_impl("plain"), kernel_rmsnorm_scope(False), \
                    qmm.matvec_max_rows_scope(0), routing(want_r):
                want = run()
        require(bool(torch.isfinite(got).all()), f"non-finite Mixtral {wdtype} logits")
        require(all(counts[k] > 0 for k in (f"quantized_matvec_expert_{wdtype}",
                                            f"quantized_matvec_{wdtype}",
                                            "decode_attention_int8", "flash_attention_fwd",
                                            "rmsnorm_fwd")),
                f"Mixtral {wdtype} reference check: a kernel did not run: {counts}")
        first, account = routing_differences(got_r, want_r, B, S, cfg.num_layers, tol)
        keep = torch.ones(B, S + 3, dtype=torch.bool, device="cuda")
        for b, pos in first.items():
            keep[b, pos:] = False
        clean = rel_l2(got[keep], want[keep]) if bool(keep.any()) else 0.0
        print(f"serving_mixtral reference check ({wdtype} weights, int8 KV, 2 layers, full "
              f"width): relative L2 error kernel vs plain path {rel_l2(got, want):.3e} over "
              f"all {B * (S + 3)} tokens, {clean:.3e} over the {int(keep.sum())} tokens "
              f"before their row's first routing difference (tol {tol}); {account}; "
              f"launches { {k: counts[k] for k in MIXTRAL_KERNELS if counts[k]} }")
        require(clean <= tol, f"Mixtral {wdtype}: kernel path disagrees with the plain path")
        del eng
        torch.cuda.empty_cache()


def resident_reckoning(cfg, bits: int) -> float:
    """Bytes of the packed engine's weights from the config alone: int8 qdata
    (int4: two values a byte where the contraction has an even number of
    128-row blocks) and one fp32 scale per block and column of every
    projection; bf16 embedding, head, router and norms."""
    L, d, E, f = cfg.num_layers, cfg.hidden_size, cfg.num_experts, cfg.ffn
    leaves = [(1, d, cfg.num_heads * cfg.hd), (1, d, cfg.kv_heads * cfg.hd),
              (1, d, cfg.kv_heads * cfg.hd), (1, cfg.num_heads * cfg.hd, d),
              (E, d, f), (E, d, f), (E, f, d)]
    total = 0.0
    for n, i, o in leaves:
        per_byte = 2 if bits == 4 and (i // 128) % 2 == 0 else 1
        total += L * n * (i * o / per_byte + 4 * max(i // 128, 1) * o)
    return total + 2 * (2 * cfg.vocab_size * d + L * (d * E + 2 * d) + d)


def moe_load(stats: list) -> str:
    """The MoE load over a run's routed MLP calls: tokens per expert summed,
    max/mean imbalance, the mean drop fraction."""
    hist = torch.stack([st["tokens_per_expert"] for st in stats]).sum(0).tolist()
    drop = torch.stack([st["drop_fraction"] for st in stats]).mean().item()
    imb = max(hist) / (sum(hist) / len(hist)) if sum(hist) else 0.0
    return (f"tokens per expert {hist} over {len(stats)} layer calls, load imbalance "
            f"{imb:.3f}, mean drop fraction {drop:.4f}")


@contextlib.contextmanager
def moe_stats(store: list):
    """Keep the stats of every routed MLP call of the cached forwards
    (device tensors, no host read until the caller's)."""
    real = dec_mod.moe_serving_mlp

    def spy(*a, **k):
        out, st = real(*a, **k)
        store.append(st)
        return out, st

    dec_mod.moe_serving_mlp = spy
    try:
        yield
    finally:
        dec_mod.moe_serving_mlp = real


def decode_steps(eng, steps: int):
    """A function running ``steps`` single-token cached forwards of one
    sequence after a 128-token prefill made here (the same positions on
    every call: the cache is written in place)."""
    cfg = eng.config
    ids = torch.randint(0, cfg.vocab_size, (1, 128 + steps),
                        generator=torch.Generator().manual_seed(9)).cuda()
    cache = init_cache(cfg, 1, 256, BF16, "cuda", quantized=eng.kv_cache_quantized)
    with eng._impl_ctx(), torch.inference_mode():
        forward_with_cache(cfg, eng.params, ids[:, :128], cache, 0)

    def run():
        with eng._impl_ctx(), torch.inference_mode():
            for i in range(steps):
                forward_with_cache(cfg, eng.params, ids[:, 128 + i:129 + i], cache, 128 + i)

    return run


def main_path_serving_mixtral():
    """Mixtral-8x7B at full width and depth, seeded random weights drawn and
    packed one layer at a time: the int8 engine with the int8 KV cache on the
    three serving requests (twice: the second run with the counters zeroed
    just before it, tokens equal to the first's); the continuous-batching
    path on the same int8 weights (:func:`main_path_serving_cb_mixtral`);
    then, the int8 engine freed, the int4 engine on the greedy B=1 request
    (twice). Speculative decode is not driven: with E = 8 and top-2 a verify
    window can drop tokens, so its tokens are not promised to be plain
    greedy's. Returns (serving_mixtral's launches, the int8 and int4 runs
    summed; serving_cb_mixtral's)."""
    model = mixtral("mixtral-8x7b")
    cfg = model.config
    requests = serving_requests(cfg.vocab_size)
    counts = {}
    cb_counts = None
    for wdtype, reqs in (("int8", requests), ("int4", requests[:1])):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        kv = "int8" if wdtype == "int8" else "auto"
        eng = init_inference(model, dtype=wdtype, kv_cache_dtype=kv,
                             replace_with_kernel_inject=True, max_tokens=1024,
                             rng=torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        got, want = tree_bytes(eng.params), resident_reckoning(cfg, int(wdtype[3:]))
        print(f"serving_mixtral: {cfg.name} L={cfg.num_layers} d={cfg.hidden_size} "
              f"E={cfg.num_experts} top-{cfg.moe_top_k} ffn={cfg.ffn} V={cfg.vocab_size} "
              f"({cfg.num_params() / 1e9:.3f} B params; bf16 would be "
              f"{2 * cfg.num_params() / 1e9:.2f} GB), depth not cut; {wdtype} weights, "
              f"{kv} KV; init and pack {time.perf_counter() - t0:.1f} s; weights resident "
              f"{got / 1e9:.3f} GB against the reckoning {want / 1e9:.3f} GB "
              f"({got / want - 1:+.4%}); init peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        require(abs(got / want - 1) <= 0.02, f"Mixtral {wdtype}: resident weights "
                f"{got} B, reckoning {want} B")
        with torch.inference_mode():
            t1 = time.perf_counter()
            first = serve(eng, reqs, report=False)  # first use of every shape
            print(f"serving_mixtral {wdtype}: first run of the requests "
                  f"{time.perf_counter() - t1:.2f} s")
            torch.cuda.reset_peak_memory_stats()
            stats = []
            kernels.reset_launch_counts()
            with moe_stats(stats):
                second = serve(eng, reqs, report=True, label=f"serving_mixtral {wdtype} ")
            run = kernels.launch_counts()
        plain = kernels.plain_attention_on_cuda()
        print(f"serving_mixtral {wdtype}: peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; MoE load: "
              f"{moe_load(stats)}; launches { {k: run[k] for k in MIXTRAL_KERNELS} }; "
              f"plain attention on the card {plain}")
        require(sum(plain.values()) == 0, f"serving_mixtral: plain attention ran {plain}")
        for (name, _, _), a, b in zip(reqs, first, second):
            require(torch.equal(a, b), f"serving_mixtral {wdtype} {name}: tokens differ "
                    "between two runs")
        print(f"serving_mixtral {wdtype} reruns: identical tokens")
        for k, v in run.items():
            counts[k] = counts.get(k, 0) + v
        profile_device(decode_steps(eng, 8), f"serving_mixtral {wdtype} B=1, 8 decode "
                       "steps after a 128-token prefill")
        if wdtype == "int8":
            cb_counts = main_path_serving_cb_mixtral(model, eng.params)
        del eng, first, second, stats
        gc.collect()
        torch.cuda.empty_cache()
    for name in MIXTRAL_KERNELS:
        require(counts[name] > 0, f"kernel {name} was not launched on serving_mixtral")
    return counts, cb_counts


def main_path_serving_cb_mixtral(model, params):
    """init_serving on Mixtral-8x7B's int8 weights (shared, not copied), bf16
    KV, kernel injection, 8 slots x a 64-token budget, pages of 16 tokens:
    the first MIXTRAL_CB_REQUESTS requests of the serving_cb trace through
    the contiguous and the paged arena, each run with the counters zeroed
    just before it. Each request's tokens must be bitwise equal between the
    arenas (the steps feed the same tokens, so the capacity-coupled routing
    is the same); one step shape. Every step sends 512 rows, 32 an expert,
    through the projections: above the matvec's 8 rows, so each step
    multiplies the dequantized weights, as the JAX package does."""
    trace = cb_trace(model.config.vocab_size)[:MIXTRAL_CB_REQUESTS]
    eng = init_inference(model, dtype="int8", replace_with_kernel_inject=True,
                         max_tokens=1024, params=params)
    outs, totals = {}, {}
    for paged in (False, True):
        srv = init_serving(serving=cb_serving(paged), engine=eng)
        label = f"serving_cb_mixtral {'paged' if paged else 'contiguous'} bf16 KV"
        with torch.inference_mode():
            outs[paged], counts = serve_cb(srv, trace, label)
        moe = [ln.strip() for ln in srv.metrics.summary().splitlines() if "moe" in ln]
        print(f"{label}: step_traces {srv.step_traces}; metrics.summary() {moe} (each "
              "step multiplies the dequantized weights: 512 rows, 32 an expert)")
        want = "paged_decode_attention" if paged else "decode_attention"
        require(counts[want] > 0 and counts["rmsnorm_fwd"] > 0 and srv.metrics.moe_steps > 0,
                f"{label}: {want} or rmsnorm_fwd not launched, or no MoE step: {counts}")
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        del srv
        torch.cuda.empty_cache()
    diff = [rid for rid in outs[False] if not np.array_equal(outs[False][rid], outs[True][rid])]
    print(f"serving_cb_mixtral: paged == contiguous bitwise for "
          f"{len(outs[False]) - len(diff)}/{len(trace)} requests; differ: {diff}")
    require(not diff, "serving_cb_mixtral: paged and contiguous outputs differ")
    del eng
    return totals


def profile_device(run, label: str) -> int:
    """Device busy share of ``run()``: kernel time from torch.profiler over
    the wall time of the same call run without the profiler; and the top
    kernels by device time. Returns the kernels launched."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0)

    # device-side events only: a CPU op's device time repeats its kernels'
    kernels_run = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in kernels_run) / 1e3
    launched = sum(e.count for e in kernels_run)
    print(f"profile {label}: wall {wall_ms:.2f} ms unprofiled, device "
          f"kernels {busy_ms:.2f} ms, busy share {busy_ms / wall_ms:.3f}, "
          f"{launched} kernel launches")
    for e in sorted(kernels_run, key=dev_us, reverse=True)[:10]:
        print(f"  {dev_us(e) / 1e3:9.3f} ms  {e.count:6d}x  {e.key[:90]}")
    return launched


def train_config(kernels: bool, remat: str = "none", batch: int = TRAIN_B * TRAIN_ACCUM,
                 micro: int = TRAIN_B, weight_decay: float = 0.0, bf16: bool = True,
                 chunked_ce: bool = False):
    """bench.py's default training leg (make_ds_config): bf16 over fp32
    masters, AdamW lr 1e-4, clipping 1.0, ZeRO 0; every kernel switch "auto"
    (on for a CUDA device) or off (the plain paths); ``bf16=False``
    computes in fp32 (plain paths only); ``chunked_ce`` keeps the chunked
    CE (torch code, not a kernel) with the kernels off."""
    switch = "auto" if kernels else False
    ce = "auto" if chunked_ce else switch
    return {
        "train_batch_size": batch, "train_micro_batch_size_per_gpu": micro,
        "optimizer": {"type": "adamw", "params": {"lr": TRAIN_LR,
                                                  "weight_decay": weight_decay}},
        "bf16": {"enabled": bf16}, "zero_optimization": {"stage": 0},
        "gradient_clipping": 1.0, "steps_per_print": 1000,
        "activation_checkpointing": {"policy": remat},
        "tpu_kernels": {**{k: switch for k in ("flash_attention", "fused_rmsnorm",
                                               "fused_adam")}, "fused_ce": ce},
    }


def leaf_names(tree, prefix: str = "") -> list:
    """Leaf paths ("layers/attn/wq"), in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in leaf_names(v, f"{prefix}{k}/")]
    return [prefix[:-1]]


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30)).item()


def reference_check_training(model=None, expect=TRAINING_KERNELS, anchored: bool = False,
                             zero_grad_leaves=(), batch_fn=None, extra=None,
                             remat_check: bool = True, label: str = ""):
    """Two-layer full-width ``model`` (llama3-1b by default; bloom-560m for
    training_bloom) in bf16, micro-batch 2 x 2048 tokens, AdamW with weight
    decay 0.1: the kernel path (flash forward and backward, RMSNorm or
    LayerNorm kernels, the ALiBi forms for BLOOM, chunked CE, fused Adam)
    against the plain path from the same masters. One micro-batch's loss and
    every leaf's gradient; then three train_batch steps on three batches,
    after which, leaf by leaf, the masters' moves p - p0 and the Adam moments
    mu and nu (by then no longer a sign per element) and the last step's
    global gradient norm; then ``full`` remat against ``none`` on the kernel
    path, bitwise over the three steps. Every kernel of ``expect`` must have
    run on the kernel path.

    ``anchored`` (BLOOM) runs the chunked CE, which is torch code and no
    kernel, on both paths, and adds a third run, the plain path in fp32, as
    the truth both bf16 paths round away from: a leaf, or the grad norm,
    outside its kernel-vs-plain tolerance passes only if the kernel path is
    no farther from fp32 than the plain bf16 path (within 25 %). A leaf with
    a small gradient made of cancelling terms (BLOOM's final LayerNorm bias,
    whose gradient sums the tied head's rows over every token, a small
    fraction of the global norm) carries bf16 noise that neither path can
    avoid. ``zero_grad_leaves`` have an
    exact gradient of zero (the key bias: softmax is invariant to a shift
    every key of a row shares): each path's must stay under 1e-4 of the
    global gradient norm, and they are left out of the relative comparisons,
    where both paths' rounding noise would be compared with itself.

    ``batch_fn(ids, i)`` makes step i's batch from its token rows (packed
    batches), ``extra`` adds config sections (the sparse_attention section,
    which the plain path runs as plain attention under the layout's mask),
    and ``remat_check=False`` leaves out the remat comparison."""
    tol_loss, tol_grad, steps, wd = 1e-2, 5e-2, 3, 0.1
    # per-leaf relative L2 after three steps, about twice the readings of
    # the H100 run that set them (PERF.md): moves 0.112 (Adam moves an
    # element whose gradient is at the bf16 noise level by a full lr in
    # either path), mu 1.49e-2, nu 1.85e-2; grad norm 9.6e-6
    tol_move, tol_mu, tol_nu, tol_norm = 0.25, 3e-2, 4e-2, 1e-4
    # embedding rows no batch touched: zero gradient, so weight decay alone
    # moves them, p0 * ((1 - lr wd)^3 - 1); fp32 rounding of p is 0.3 % of it
    tol_decay = 1e-2
    model = model or llama("llama3-1b", num_layers=2)
    cfg = model.config
    params0 = model.init(torch.Generator(device="cuda").manual_seed(1),
                         dtype=torch.float32, device="cuda")
    ids = torch.randint(0, model.config.vocab_size, (steps, 2, TRAIN_S),
                        generator=torch.Generator().manual_seed(1)).cuda()
    batches = [batch_fn(ids[i], i) if batch_fn else {"input_ids": ids[i]}
               for i in range(steps)]

    def run(kernels_on: bool, remat: str = "none", bf16: bool = True):
        eng, *_ = initialize(model=model, config={**train_config(
            kernels_on, remat, 2, 2, wd, bf16=bf16, chunked_ce=anchored), **(extra or {})},
            model_parameters=params0)
        mb = {k: t[0] for k, t in eng.prepare_batch(batches[0]).items()}
        with eng._kernel_scope():
            loss, _ = eng.model.loss(eng.params, mb, dtype=BF16 if bf16 else torch.float32,
                                     remat_policy=remat)
            loss.backward()
        grads = tree_map(lambda p: p.grad, eng.params)
        for p in tree_leaves(eng.params):
            p.grad = None
        step_losses = torch.stack([eng.train_batch(batch=batches[i])
                                   for i in range(steps)])
        return {"loss": loss.detach(), "grads": grads, "steps": step_losses,
                "gnorm": eng.get_global_grad_norm(),
                "masters": tree_map(lambda p: p.detach(), eng.params),
                "mu": eng.opt_state["mu"], "nu": eng.opt_state["nu"]}

    kernels.reset_launch_counts()
    k = run(True)
    counts = kernels.launch_counts()
    p = run(False)
    f32 = run(False, bf16=False) if anchored else None
    rel_loss = abs(k["loss"].item() - p["loss"].item()) / abs(p["loss"].item())
    rel_norm = abs(k["gnorm"] - p["gnorm"]) / p["gnorm"]
    names = leaf_names(params0)
    keep = [n not in zero_grad_leaves for n in names]
    gnorm0 = torch.stack([g.float().norm() for g in tree_leaves(p["grads"])]).norm().item()
    zero_grads = {n: [g.float().norm().item() / gnorm0 for r in (k, p) for g, nn in
                      zip(tree_leaves(r["grads"]), names) if nn == n]
                  for n in zero_grad_leaves}

    def leaf_errs(key, fn=lambda t, t0: t, a_run=None, b_run=None):
        a_run, b_run = a_run or k, b_run or p
        return [rel_l2(fn(a, a0), fn(b, a0)) if on else 0.0 for a, b, a0, on in
                zip(tree_leaves(a_run[key]), tree_leaves(b_run[key]),
                    tree_leaves(params0), keep)]

    move = lambda t, t0: t - t0  # noqa: E731
    grad_errs = leaf_errs("grads")
    move_errs = leaf_errs("masters", move)
    mu_errs, nu_errs = leaf_errs("mu"), leaf_errs("nu")
    if anchored:
        # (kernel vs fp32, plain vs fp32) per leaf and metric
        anchor = {key: (leaf_errs(key, fn, k, f32), leaf_errs(key, fn, p, f32))
                  for key, fn in (("grads", lambda t, t0: t), ("masters", move),
                                  ("mu", lambda t, t0: t), ("nu", lambda t, t0: t))}
        norm_k, norm_p = abs(k["gnorm"] - f32["gnorm"]), abs(p["gnorm"] - f32["gnorm"])

    def within(errs, key, tol):
        """Per leaf: inside the kernel-vs-plain tolerance, or (anchored) no
        farther from fp32 than the plain bf16 path."""
        if not anchored:
            return max(errs) <= tol
        ek, ep = anchor[key]
        return all(e <= tol or a <= 1.25 * b for e, a, b in zip(errs, ek, ep))

    untouched = torch.ones(cfg.vocab_size, dtype=torch.bool, device="cuda")
    untouched[ids.flatten()] = False
    e0 = params0["embed"]["tok"][untouched]
    decayed = e0 * ((1 - TRAIN_LR * wd) ** steps - 1)
    # a tied head gives every row of the table a gradient: no row is moved
    # by weight decay alone
    decay_errs = [0.0] * 2 if cfg.tie_embeddings else [
        rel_l2(r["masters"]["embed"]["tok"][untouched] - e0, decayed) for r in (k, p)]

    def worst(errs):
        i = max(range(len(errs)), key=errs.__getitem__)
        return f"{errs[i]:.3e} ({names[i]})"

    print(f"training reference check {label}({cfg.name}, 2 layers, full width, 2 x {TRAIN_S} "
          f"tokens, weight decay {wd}): loss kernel {k['loss'].item():.6f} plain "
          f"{p['loss'].item():.6f} (rel {rel_loss:.3e}, tol {tol_loss}); per-leaf grad "
          f"relative L2 max {worst(grad_errs)} (tol {tol_grad})")
    print(f"training reference check after {steps} steps: step losses kernel "
          f"{k['steps'].tolist()} plain {p['steps'].tolist()}; grad norm kernel "
          f"{k['gnorm']:.6f} plain {p['gnorm']:.6f} (rel {rel_norm:.3e}, tol {tol_norm}); "
          f"per-leaf relative L2 max: masters' move p - p0 {worst(move_errs)} "
          f"(tol {tol_move}), mu {worst(mu_errs)} (tol {tol_mu}), nu "
          f"{worst(nu_errs)} (tol {tol_nu}); {int(untouched.sum())} untouched "
          f"embedding rows against weight decay alone: kernel {decay_errs[0]:.3e} "
          f"plain {decay_errs[1]:.3e} (tol {tol_decay}"
          f"{'; tied head: not applicable' if cfg.tie_embeddings else ''}); launches "
          f"{ {n: counts[n] for n in expect} }")
    for i, (name, e_move, e_mu, e_nu) in enumerate(zip(names, move_errs, mu_errs, nu_errs)):
        line = f"  {name}: grad {grad_errs[i]:.3e} move {e_move:.3e} mu {e_mu:.3e} nu {e_nu:.3e}"
        if anchored:
            line += " | vs fp32, kernel / plain: " + ", ".join(
                f"{key} {anchor[key][0][i]:.3e} / {anchor[key][1][i]:.3e}"
                for key in ("grads", "masters", "mu", "nu"))
        print(line)
    if zero_grad_leaves:
        print(f"leaves whose exact gradient is zero, |grad| over the global norm "
              f"(kernel, plain; tol 1e-4): {zero_grads}")
    if anchored:
        print(f"grad norm against the fp32 run's {f32['gnorm']:.6f}: kernel off by "
              f"{norm_k:.3e}, plain bf16 by {norm_p:.3e}")
    require(bool(torch.isfinite(k["loss"])) and rel_loss <= tol_loss,
            "training loss: kernel path disagrees with the plain path")
    require(within(grad_errs, "grads", tol_grad), "gradients: kernel path disagrees")
    require(all(v <= 1e-4 for vs in zero_grads.values() for v in vs),
            "a gradient that is exactly zero is not at the rounding level")
    require(all(counts[n] > 0 for n in expect),
            f"training reference check: a kernel of {expect} did not run")
    require((rel_norm <= tol_norm or (anchored and norm_k <= 1.25 * norm_p))
            and within(move_errs, "masters", tol_move)
            and within(mu_errs, "mu", tol_mu) and within(nu_errs, "nu", tol_nu)
            and max(decay_errs) <= tol_decay,
            f"after {steps} steps: kernel path disagrees with the plain path")
    del p, f32
    if not remat_check:
        del k, params0
        torch.cuda.empty_cache()
        return
    f = run(True, "full")
    same = torch.equal(f["loss"], k["loss"]) and torch.equal(f["steps"], k["steps"]) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(f["masters"]), tree_leaves(k["masters"])))
    print(f"training reference check: full remat vs none bitwise equal over {steps} "
          f"steps: {same}")
    require(same, "full remat differs from none")
    del f, k, params0
    torch.cuda.empty_cache()


def check_packed_equals_unpacked(model) -> None:
    """The oracle inside the port: two full-width layers of ``model``
    (llama3-1b: RoPE at restarted positions and the segment form; bloom-560m:
    the positions' dense ALiBi bias and the bias + segment form), bf16, kernels
    on: each document's logits taken from one packed row of 2048 tokens equal
    that document run alone from position 0 (Llama form, ALiBi form), to a
    bf16 tolerance, since the rows fall into other tiles."""
    tol = 2e-2  # relative L2 of a document's logits; the serving reference check's
    cfg = model.config
    params = model.init(torch.Generator(device="cuda").manual_seed(2), dtype=BF16,
                        device="cuda")
    ids = torch.randint(0, cfg.vocab_size, (1, TRAIN_S),
                        generator=torch.Generator().manual_seed(2)).cuda()
    batch = packed_batch(ids, PACKED_SEED + 1)
    lens = packed_rows(1, TRAIN_S, PACKED_SEED + 1)[2][0]
    errs = []
    with torch.inference_mode(), attention_impl("auto"), kernel_rmsnorm_scope(True):
        kernels.reset_launch_counts()
        packed = apply(cfg, params, ids, positions=batch["positions"],
                       segment_ids=batch["segment_ids"])
        counts = kernels.launch_counts()
        at = 0
        for n in lens:
            alone = apply(cfg, params, ids[:, at:at + n])
            errs.append(rel_l2(packed[:, at:at + n], alone))
            at += n
    form = "_bias_seg" if cfg.pos_embedding == "alibi" else "_seg"
    print(f"packed equals unpacked ({cfg.name}, 2 layers, full width, bf16): documents "
          f"{lens}, relative L2 of each document's logits {[f'{e:.3e}' for e in errs]} "
          f"(tol {tol}); packed run launches flash_attention_fwd{form} "
          f"{counts['flash_attention_fwd' + form]}")
    require(max(errs) <= tol and counts["flash_attention_fwd" + form] > 0,
            f"{cfg.name}: a packed document's logits differ from the document alone")
    del params, packed
    torch.cuda.empty_cache()


def main_path_attention_bias(steps: int = 3) -> dict:
    """The one entry that reaches the bias-gradient kernel: the attention op
    (``ops.attention.attention``, flash) with a learned [1, 16, 2048, 2048]
    fp32 bias shared by the batch (a T5-style relative bias), B=4 D=64 bf16
    causal, forward and backward ``steps`` times; the counters, zeroed just
    before, must show the kernel ran and the plain attention never did."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    B, S, H, D = TRAIN_B, TRAIN_S, 16, 64
    q, k, v = (torch.randn(B, S, H, D, generator=gen, device="cuda", dtype=BF16)
               .requires_grad_(True) for _ in range(3))
    bias = (0.3 * torch.randn(1, H, S, S, generator=gen, device="cuda")).requires_grad_(True)
    kernels.reset_launch_counts()
    with attention_impl("auto"):
        for _ in range(steps):
            out = attention(q, k, v, causal=True, bias=bias)
            out.float().square().mean().backward()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    plain = kernels.plain_attention_on_cuda()
    ok = bool(torch.isfinite(bias.grad).all()) and bias.grad.abs().max().item() > 0
    print(f"attention_bias path: {steps} forward+backward steps of attention(bias=[1, {H}, "
          f"{S}, {S}] fp32, requires grad) at B={B} D={D}: bias gradient finite and "
          f"non-zero {ok}; launches flash_attention_bias_grad "
          f"{counts['flash_attention_bias_grad']}, flash_attention_fwd_bias "
          f"{counts['flash_attention_fwd_bias']}; plain attention on the card {plain}")
    require(ok and counts["flash_attention_bias_grad"] > 0 and sum(plain.values()) == 0,
            "attention_bias path: the bias-gradient kernel did not run")
    del q, k, v, bias, out
    torch.cuda.empty_cache()
    return counts


def sp_model():
    """training_sp's model: llama3-1b at full width, 4 of its 16 layers, its
    positions taken to the 16,384 tokens of the one sequence."""
    return llama("llama3-1b", num_layers=SP_LAYERS, max_seq_len=SP_SEQ)


def sp_config(mode=None):
    """The training leg (``train_config``) on one global sequence a step
    (B=1, no accumulation), in the sp ``mode`` over SP_SIZE ranks, or on one
    device when ``mode`` is None."""
    cfg = {**train_config(True, batch=1, micro=1)}
    if mode is not None:
        cfg["sequence_parallel"] = {"sp_size": SP_SIZE, "mode": mode}
    return cfg


def sp_steps(engine, batch, steps: int):
    """``steps`` train_batch calls, each timed on the host clock to its end
    (the loss's host read); (losses, grad norms, ms per step)."""
    losses, norms, ms = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(engine.train_batch(batch=batch).item())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        norms.append(engine.get_global_grad_norm())
    return losses, norms, ms


def sp_rank(rank: int, ids: torch.Tensor) -> dict:
    """One rank of training_sp (run by ``launch_local`` on cuda:0, gloo):
    ``initialize`` → SP_STEPS train_batch calls in the ring mode, then in the
    Ulysses mode, each engine from the same seed, the launch counters zeroed
    just before each mode's steps; then, on the Ulysses engine, one profiled
    step (device kernel time against the step's wall time) and the gloo
    transport alone: the gradient all-reduce (the masters' size, fp32) and
    one ring hop's k/v shift (an 8,192-token chunk of 8 kv heads, bf16)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.set_device(0)
    batch = {"input_ids": ids}
    out = {}
    for mode in ("ring", "ulysses"):
        engine, *_ = initialize(model=sp_model(), config=sp_config(mode),
                                rng=torch.Generator(device="cuda").manual_seed(0),
                                device="cuda:0")
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        losses, norms, ms = sp_steps(engine, batch, SP_STEPS)
        out[mode] = {"losses": losses, "grad_norms": norms, "ms": ms,
                     "counts": kernels.launch_counts(),
                     "plain": kernels.plain_attention_on_cuda(),
                     "peak": torch.cuda.max_memory_allocated()}
        if mode == "ulysses":
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                engine.train_batch(batch=batch).item()
            out["device_ms"] = sum(
                getattr(e, "self_device_time_total", None) or
                getattr(e, "self_cuda_time_total", 0) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
            world = engine.topology.world_group()
            # the masters' size: the engine's staging buffer serves it
            flat = torch.zeros(sum(p.numel() for p in tree_leaves(engine.params)),
                               device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            all_reduce(flat, world)
            torch.cuda.synchronize()
            out["allreduce_ms"] = (time.perf_counter() - t0) * 1e3
            kv = [torch.zeros(1, SP_SEQ // SP_SIZE, 8, 64, device="cuda", dtype=BF16)
                  for _ in range(2)]
            group = engine.topology.group("sp")
            ring_shift(kv, group)
            t0 = time.perf_counter()
            ring_shift(kv, group)
            torch.cuda.synchronize()
            out["shift_ms"] = (time.perf_counter() - t0) * 1e3
            del flat, kv
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    out["zero"] = zero_steps(rank, ids.view(SP_SIZE, SP_SEQ // SP_SIZE))
    return out


def zero_config(stage: int, prefetch: bool = False) -> dict:
    """training_zero's leg: training_sp's (bf16 over fp32 masters, AdamW,
    clipping 1.0) with weight decay 0.01, one row a rank over dp=SP_SIZE
    ranks, ZeRO ``stage`` (with ``stage3_layer_prefetch`` when
    ``prefetch``)."""
    cfg = train_config(True, batch=SP_SIZE, micro=1, weight_decay=0.01)
    cfg["zero_optimization"] = {"stage": stage}
    if prefetch:
        cfg["zero_optimization"]["stage3_layer_prefetch"] = True
    return cfg


def zero3_stacked(model) -> list:
    """Each master leaf's membership of the stacked layers group, in
    ``tree_leaves`` order (stage 3's plan cuts those within each layer)."""
    shapes = {n: s for n, (s, _) in tree_items(param_specs(model.config))}
    return [n.startswith("['layers']") for n in shapes]


def parts_norm(leaves, stacked=None):
    """The global norm of the whole gradients ``leaves`` summed as stage 2
    over SP_SIZE ranks sums it (``ZeroPartition.square_sums``): each sharded
    leaf's parts' squares added in rank order (the all-reduce of two terms),
    a replicated leaf's whole, then the [1, leaves] sums and the root. With
    ``stacked``, as stage 3 at ZERO3_THRESHOLD sums it: the leaves held as
    parts split (each part contiguous, as the engine holds it), the
    persistent ones whole."""
    shapes = [t.shape for t in leaves]
    if stacked is None:
        plans = [[(e, e.sharded) for e in shard_plan(shapes, SP_SIZE, r)]
                 for r in range(SP_SIZE)]
    else:
        plans = [stage3_plan(shapes, stacked, SP_SIZE, r, ZERO3_THRESHOLD)
                 for r in range(SP_SIZE)]
    sq = []
    for i, t in enumerate(leaves):
        split = plans[0][i][1]
        s = (plans[0][i][0].part(t).contiguous() if split else t).float().square().sum()
        for plan in plans[1:] if split else ():
            s = s + plan[i][0].part(t).contiguous().float().square().sum()
        sq.append(s)
    return torch.stack([torch.stack(sq)]).sum().sqrt()


def zero_plan_bytes(shapes, stacked, stage: int, rank: int) -> dict:
    """The bytes of this rank's masters, AdamW moments and gradients that
    the stage's plan gives (fp32): at stage 3 the held leaves' parts and the
    persistent leaves whole, their moments split as at stage 1."""
    if stage != 3:
        return {}
    plan = stage3_plan(shapes, stacked, SP_SIZE, rank, ZERO3_THRESHOLD)
    held = sum(4 * (e.size if h else math.prod(e.shape)) for e, h in plan)
    return {"masters": held, "optimizer": 2 * 4 * sum(e.size for e, _ in plan),
            "gradients": held}


def zero_steps(rank: int, ids: torch.Tensor) -> dict:
    """training_zero on this rank of training_sp's world (now dp=SP_SIZE at
    sp 1): per leg of ZERO_LEGS an engine from the same seed, SP_STEPS
    train_batch calls on the same global batch ``ids`` [SP_SIZE, 8192], the
    launch counters zeroed just before them; the losses, grad norms, ms a
    step, counts, peak memory, ``state_bytes()`` and the plan's, the leaves
    and the partition's parts, and at stage 3 the last step's gather
    counters. The "0 parts" and "0 parts3" legs are stage 0 with the
    engine's ``global_norm`` replaced by :func:`parts_norm` in stage 2's and
    stage 3's order. The masters of the stage-0 legs are kept on the host;
    each later leg's (at stage 3 gathered whole) are compared with them on
    the card (the largest gap; bitwise where it is 0: the masters are
    finite). On the stage-2 engine, the gloo transport alone: the
    reduce-scatter of the masters' size and the all-gather of one rank's
    half, each staged through the host."""
    import functools

    from deepspeed_tpu_torch.runtime import engine as engine_module

    batch = {"input_ids": ids}
    out, ref = {}, {}
    stacked = zero3_stacked(sp_model())
    for leg in ZERO_LEGS:
        stage = ZERO_STAGE[leg]
        engine, *_ = initialize(model=sp_model(),
                                config=zero_config(stage, prefetch=leg == "3 prefetch"),
                                rng=torch.Generator(device="cuda").manual_seed(0),
                                device="cuda:0")
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        norm = engine_module.global_norm
        if leg == "0 parts":
            engine_module.global_norm = parts_norm
        elif leg == "0 parts3":
            engine_module.global_norm = functools.partial(parts_norm, stacked=stacked)
        try:
            losses, norms, ms = sp_steps(engine, batch, SP_STEPS)
        finally:
            engine_module.global_norm = norm
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        masters = tree_leaves(engine.whole_params())  # stage 3: gathered for the comparison
        shapes = [p.shape for p in masters]
        if stage == 3:
            plan = [e for e, _ in stage3_plan(shapes, stacked, SP_SIZE, rank, ZERO3_THRESHOLD)]
        else:
            plan = shard_plan(shapes, SP_SIZE if stage else 1, rank)
        run = {"losses": losses, "grad_norms": norms, "ms": ms,
               "counts": counts, "plain": kernels.plain_attention_on_cuda(),
               "peak": peak, "bytes": engine.state_bytes(),
               "plan_bytes": zero_plan_bytes(shapes, stacked, stage, rank),
               "leaves": len(masters), "sharded": sum(e.sharded for e in plan),
               "largest_part": max(e.size for e in plan)}
        g = engine.last_gather
        if g is not None:
            run["gather"] = {"held": len(engine._partition.gathered),
                             "peak_layers": g.peak_layers,
                             "peak_layers_backward": g.peak_layers_backward,
                             "gathers": g.gathers, "gather_ms": g.gather_s * 1e3}
        with torch.no_grad():
            for name in ZERO_REFS.get(leg, ()):  # each host leaf back on the card in turn
                want = ref[name]
                gaps = [(p - r.cuda()).abs().max().item() for p, r in zip(masters, want)]
                run[f"bitwise {name}"] = all(g == 0 for g in gaps)
                run[f"max_gap {name}"] = max(gaps)
        if stage == 0:
            ref[leg] = [p.detach().cpu() for p in masters]
        if stage == 2:
            group = engine.topology.group("dp")
            n = sum(p.numel() for p in masters)
            flat = torch.zeros(n - n % SP_SIZE, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            half = reduce_scatter(flat, group)
            torch.cuda.synchronize()
            run["reduce_scatter_ms"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            all_gather(half, group)
            torch.cuda.synchronize()
            run["all_gather_ms"] = (time.perf_counter() - t0) * 1e3
            del flat, half
        out[leg] = run
        del engine, masters, g  # the gather scope holds the masters' parts
        gc.collect()
        torch.cuda.empty_cache()
    return out


def main_path_training_sp() -> tuple:
    """``training_sp``: sequence-parallel training through ``initialize`` on
    two ranks (``launch_local``) that share cuda:0 over gloo (NCCL refuses two
    ranks on one device, so the transport goes through the host; the
    kernels, the ring schedule, the Ulysses all-to-alls and the gradient
    all-reduce all run), llama3-1b at full width (4 of 16 layers), one seeded
    sequence of 16,384 tokens a step, 8,192 a rank: SP_STEPS steps in the
    ring mode, then in the Ulysses mode, then sp=1 on this process from the
    same seed and batch. The losses and grad norms of every step must agree
    within the bf16 tolerance; the ranks' counters, zeroed just before each
    mode's steps, must show the offset forms (ring) and the unmasked forms
    (Ulysses) ran and plain attention on the card never did. Then
    ``training_zero`` in the same world (``zero_steps``; the counts of its
    stage-2 and stage-3 legs are the second and third returned)."""
    model = sp_model()
    cfg = model.config
    ids = torch.randint(0, cfg.vocab_size, (1, SP_SEQ),
                        generator=torch.Generator().manual_seed(0))
    print(f"training_sp main path: {cfg.name} L={cfg.num_layers} of 16 d={cfg.hidden_size} "
          f"H={cfg.num_heads} KV={cfg.kv_heads} hd={cfg.hd} ffn={cfg.ffn} V={cfg.vocab_size} "
          f"({cfg.num_params() / 1e9:.3f} B params), one sequence of {SP_SEQ} tokens over "
          f"sp={SP_SIZE} ranks; both ranks on cuda:0 ({torch.cuda.get_device_name(0)}), "
          f"transport gloo through the host (NCCL refuses two ranks on one device)")
    t0 = time.perf_counter()
    ranks = launch_local(sp_rank, SP_SIZE, (ids,), backend="gloo")
    print(f"training_sp: two ranks spawned, initialized and stepped in "
          f"{time.perf_counter() - t0:.1f} s")
    engine, *_ = initialize(model=model, config=sp_config(),
                            rng=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.reset_peak_memory_stats()
    single = dict(zip(("losses", "grad_norms", "ms"),
                      sp_steps(engine, {"input_ids": ids.cuda()}, SP_STEPS)))
    single["peak"] = torch.cuda.max_memory_allocated()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    tol = 1e-2  # bf16: the chunked attention rounds its merged outputs once more
    counts = {}
    for mode, expect in (("ring", SP_RING_KERNELS), ("ulysses", SP_ULYSSES_KERNELS)):
        runs = [r[mode] for r in ranks]
        steady = max(statistics.mean(r["ms"][1:]) for r in runs)
        mode_counts = {k: sum(r["counts"][k] for r in runs) for k in runs[0]["counts"]}
        plain = sum(sum(r["plain"].values()) for r in runs)
        print(f"training_sp {mode}: losses {runs[0]['losses']} (sp=1 {single['losses']}), "
              f"grad norms {runs[0]['grad_norms']} (sp=1 {single['grad_norms']}); "
              f"{steady:.2f} ms/step (step 2, the slower rank), "
              f"{SP_SEQ // SP_SIZE / (steady / 1e3):.1f} tokens/s per rank, "
              f"{SP_SEQ / (steady / 1e3):.1f} tokens/s on the card; peak memory per rank "
              + ", ".join(f"{r['peak'] / 2**30:.2f} GiB" for r in runs)
              + f"; launches (both ranks) { {k: mode_counts[k] for k in expect} }; plain "
              f"attention on the card {plain}")
        for r in runs[1:]:
            require(r["losses"] == runs[0]["losses"], f"training_sp {mode}: ranks disagree")
        for what in ("losses", "grad_norms"):
            np.testing.assert_allclose(runs[0][what], single[what], rtol=tol,
                                       err_msg=f"training_sp {mode} {what} against sp=1")
        for name in expect:
            require(mode_counts[name] > 0, f"kernel {name} was not launched on training_sp "
                                           f"{mode}")
        require(plain == 0, f"training_sp {mode}: plain attention ran on the card")
        for k, n in mode_counts.items():
            counts[k] = counts.get(k, 0) + n
    r0 = ranks[0]
    print(f"training_sp sp=1 on one process: {statistics.mean(single['ms'][1:]):.2f} "
          f"ms/step, {SP_SEQ / (statistics.mean(single['ms'][1:]) / 1e3):.1f} tokens/s, "
          f"peak memory {single['peak'] / 2**30:.2f} GiB")
    print(f"training_sp where the step goes (rank 0, Ulysses, one profiled step): device "
          f"kernels {r0['device_ms']:.2f} ms of {statistics.mean(r0['ulysses']['ms'][1:]):.2f}"
          f" ms/step; gloo transport alone: the fp32 gradient all-reduce "
          f"{r0['allreduce_ms']:.2f} ms, one ring hop's k/v shift {r0['shift_ms']:.2f} ms "
          f"({3 * SP_LAYERS * (SP_SIZE - 1) + SP_LAYERS} shifts a ring step: k/v forward, "
          f"k/v and dk/dv backward, dk/dv home)")
    return (counts, *training_zero(ranks))


def training_zero(ranks) -> tuple:
    """``training_zero``: ZeRO stages 0-3 over the two ranks of training_sp's
    world (``zero_steps``), llama3-1b at full width, 4 of 16 layers, a global
    batch of 2 x 8,192 tokens, stage 3 with the layer prefetch, and the
    witnesses "0 parts" and "0 parts3" (stage 0, its clipping norm summed in
    stage 2's and stage 3's order). Stage 1 must be stage 0 bit for bit,
    stage 2 "0 parts" bit for bit, and stage 3 and its prefetch leg "0
    parts3" bit for bit (losses, grad norms and masters, both ranks, the
    stage-3 masters gathered whole), stages 2 and 3's first loss stage 0's
    and their first grad norm within ZERO_NORM_RTOL of stage 0's (before any
    update the runs differ in the norm's order alone); each rank's
    ``state_bytes()``, read from the live tensors, must show the moments
    split at stage 1, the gradients too at stage 2, and at stage 3 the plan's
    bytes, below stage 2's; fused Adam launched once a part a step on each
    rank (every leaf's moments split), the flash and RMSNorm kernels in
    forward and backward, plain attention never. Returns the counts of the
    stage-2 and the stage-3 runs, both ranks."""
    runs = {leg: [r["zero"][leg] for r in ranks] for leg in ZERO_LEGS}
    gb = 1e9
    for leg in ZERO_LEGS:
        rs = runs[leg]
        steady = max(statistics.mean(r["ms"][1:]) for r in rs)
        b = rs[0]["bytes"]
        against = "; ".join(
            f"masters against {k}: bitwise {[r[f'bitwise {k}'] for r in rs]}, max gap "
            f"{max(r[f'max_gap {k}'] for r in rs):.3e}"
            for k in ZERO_REFS.get(leg, ()))
        g = rs[0].get("gather")
        if g is not None:
            against += (
                f"; {g['held']} of {rs[0]['leaves']} masters held as parts; the last step's "
                f"layer gathers {g['gathers']}, host ms waiting on them "
                f"{[round(r['gather']['gather_ms'], 2) for r in rs]}, most layers' slices "
                f"alive {g['peak_layers']} (in backward {g['peak_layers_backward']})")
        print(f"training_zero {'stage ' + str(leg) if isinstance(leg, int) else leg}: losses "
              f"{rs[0]['losses']}, grad norms {rs[0]['grad_norms']}; {steady:.2f} ms/step "
              f"(step 2, the slower rank), {SP_SEQ / (steady / 1e3):.1f} tokens/s "
              f"on the card; per rank state_bytes masters {b['masters'] / gb:.3f} GB, "
              f"optimizer {b['optimizer'] / gb:.3f} GB, gradients {b['gradients'] / gb:.3f} "
              f"GB, total {b['total'] / gb:.3f} GB, gradients alive at the collective "
              f"{b['gradients_transient'] / gb:.3f} GB; max_memory_allocated per rank "
              + ", ".join(f"{r['peak'] / 2**30:.2f} GiB" for r in rs)
              + f"; {rs[0]['sharded']} of {rs[0]['leaves']} leaves sharded, the largest part "
              f"{rs[0]['largest_part']} elements; launches (both ranks) "
              f"{ {k: sum(r['counts'][k] for r in rs) for k in ZERO_KERNELS} }"
              + (f"; {against}" if against else ""))
        for r in rs:
            require(r["losses"] == rs[0]["losses"], f"training_zero {leg}: ranks disagree")
            require(r["bytes"] == b, f"training_zero {leg}: ranks' state bytes differ")
            require(r["counts"]["fused_adam"] == SP_STEPS * r["leaves"],
                    f"training_zero {leg}: fused Adam launched "
                    f"{r['counts']['fused_adam']} times, not once a part a step")
            require(sum(r["plain"].values()) == 0,
                    f"training_zero {leg}: plain attention ran on the card")
            for name in ZERO_KERNELS:
                require(r["counts"][name] > 0, f"kernel {name} was not launched on "
                                               f"training_zero {leg}")
        if leg in (1, 2, 3, "3 prefetch"):
            require(rs[0]["sharded"] == rs[0]["leaves"],
                    f"training_zero stage {leg}: a leaf stayed replicated")
        if ZERO_STAGE[leg] == 3:
            for r in rs:
                require({k: r["bytes"][k] for k in r["plan_bytes"]} == r["plan_bytes"],
                        f"training_zero {leg}: state bytes {r['bytes']} are not the plan's "
                        f"{r['plan_bytes']}")
                most = 3 if leg == "3 prefetch" else 2
                require(r["gather"]["peak_layers"] <= most,
                        f"training_zero {leg}: {r['gather']['peak_layers']} layers' gathered "
                        f"slices alive at once (at most {most})")
    b0, b1, b2 = (runs[s][0]["bytes"] for s in (0, 1, 2))
    half_opt, half_grad = b0["optimizer"] // 2, b0["gradients"] // 2
    require((b1["masters"], b1["optimizer"], b1["gradients"])
            == (b0["masters"], half_opt, b0["gradients"]),
            "training_zero: stage 1's state bytes do not show the moments split")
    require((b2["masters"], b2["optimizer"], b2["gradients"])
            == (b0["masters"], half_opt, half_grad),
            "training_zero: stage 2's state bytes do not show the gradients split")
    for leg in (3, "3 prefetch"):
        b3 = runs[leg][0]["bytes"]
        require(b3["total"] < b2["total"] and b3["masters"] < b2["masters"],
                f"training_zero {leg}: state bytes {b3} not below stage 2's {b2}")
    for name, stage, base in (("stage 1", 1, 0), ("stage 2", 2, "0 parts"),
                              ("stage 3", 3, "0 parts3"),
                              ("stage 3 prefetch", "3 prefetch", "0 parts3")):
        for r, want in zip(runs[stage], runs[base]):
            require(r[f"bitwise {base}"] and r["losses"] == want["losses"]
                    and r["grad_norms"] == want["grad_norms"],
                    f"training_zero: {name} is not {base} bit for bit (max gap "
                    f"{r[f'max_gap {base}']:.3e})")
    s0 = runs[0][0]
    for stage in (2, 3, "3 prefetch"):
        for r in runs[stage]:
            require(r["losses"][0] == s0["losses"][0], f"training_zero: stage {stage}'s "
                                                       f"first loss is not stage 0's")
            require(abs(r["grad_norms"][0] / s0["grad_norms"][0] - 1) <= ZERO_NORM_RTOL,
                    f"training_zero: stage {stage}'s first grad norm {r['grad_norms'][0]} is "
                    f"not stage 0's {s0['grad_norms'][0]} within {ZERO_NORM_RTOL}")
    r2 = runs[2][0]
    print(f"training_zero gloo transport alone (rank 0, staged through the host): the "
          f"reduce-scatter of {r2['bytes']['masters'] / gb:.3f} GB of fp32 "
          f"{r2['reduce_scatter_ms']:.2f} ms, the all-gather of a rank's half "
          f"{r2['all_gather_ms']:.2f} ms")
    return tuple({k: sum(r["counts"][k] for r in runs[leg]) for k in runs[leg][0]["counts"]}
                 for leg in (2, 3))


def train_flops(cfg, tokens: int, pairs: float) -> float:
    """6 N per token (forward + backward of every weight) plus attention
    over the step's ``pairs`` visible (query, key) pairs (causal, inside each
    segment, in active blocks): 4 D flops per pair and head forward, 3x with
    the backward."""
    attn = 12 * cfg.hd * cfg.num_heads * cfg.num_layers * pairs
    return 6 * cfg.num_params() * tokens + attn


def main_path_training(model=None, expect=TRAINING_KERNELS, path: str = "training",
                       packed: bool = False, extra=None, pairs_per_seq=None,
                       rerun: bool = True):
    """``model`` (llama3-1b by default; bloom-560m for training_bloom) at full
    width and depth, seeded random masters, one seeded batch of 8 x 2048
    tokens (micro-batch 4, 2 accumulation steps), 10 steps; then the same 3
    first steps from the same seed (unless ``rerun`` is False). ``packed``
    packs the rows with seeded documents (segment ids, positions, labels
    inside each document); ``extra`` adds config sections; MFU counts the
    visible pairs (``pairs_per_seq`` per row, causal pairs by default, the
    segments' when packed)."""
    model = model or llama("llama3-1b")
    cfg = model.config
    steps, rows, tokens = 10, TRAIN_B * TRAIN_ACCUM, TRAIN_B * TRAIN_ACCUM * TRAIN_S
    ids = torch.randint(0, cfg.vocab_size, (rows, TRAIN_S),
                        generator=torch.Generator().manual_seed(0)).cuda()
    batch = packed_batch(ids, PACKED_SEED) if packed else {"input_ids": ids}
    if packed:
        pairs = packed_pairs(rows, TRAIN_S, PACKED_SEED)
    else:
        pairs = rows * (pairs_per_seq or TRAIN_S * (TRAIN_S + 1) / 2)

    def build():
        eng, *_ = initialize(model=model, config={**train_config(True), **(extra or {})},
                             rng=torch.Generator(device="cuda").manual_seed(0))
        return eng

    t0 = time.perf_counter()
    engine = build()
    torch.cuda.synchronize()
    print(f"{path} main path: {cfg.name} L={cfg.num_layers} d={cfg.hidden_size} "
          f"H={cfg.num_heads} KV={cfg.kv_heads} hd={cfg.hd} ffn={cfg.ffn} "
          f"V={cfg.vocab_size} ({cfg.num_params() / 1e9:.3f} B params), depth not cut; "
          f"init {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i in range(steps):
        losses.append(engine.train_batch(batch=batch))
        if i == 1:  # the first two steps warm up cuBLAS and the allocator
            torch.cuda.synchronize()
            t_warm = time.perf_counter()
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t_warm) * 1e3 / (steps - 2)
    counts = kernels.launch_counts()
    losses = [x.item() for x in losses]
    FIRST_LOSS[path] = losses[0]
    peak = torch.cuda.max_memory_allocated()
    mfu = train_flops(cfg, tokens, pairs) / (ms_step / 1e3) / BF16_FLOPS
    plain = kernels.plain_attention_on_cuda()
    print(f"{path} losses: {losses}")
    print(f"{path}: {ms_step:.2f} ms/step (steps 3-{steps}), "
          f"{tokens / (ms_step / 1e3):.1f} tokens/s, MFU {mfu:.4f} (6 N tokens + "
          f"attention over {pairs:.0f} visible pairs per head and layer, over "
          f"{BF16_FLOPS / 1e12:.0f} TFLOP/s bf16), peak memory "
          f"{peak / 2**30:.2f} GiB")
    print(f"{path} main path launches ({steps} steps): "
          f"{ {k: counts[k] for k in expect} }; plain attention on the card {plain}")
    if engine.fp16_enabled:
        first, bf16 = losses[0], FIRST_LOSS.get("training")
        require(bf16 is not None, f"{path} compares its first loss with the training "
                "path's: run training before it")
        print(f"{path}: loss scale after {steps} steps {engine.loss_scale} (the default "
              f"scaler: 2**16, window 1000, hysteresis 2), skipped steps "
              f"{engine.skipped_steps}; first loss {first} beside the bf16 path's {bf16} "
              f"from the same seeded masters (relative difference "
              f"{abs(first - bf16) / bf16:.3e}, tol {FP16_FIRST_LOSS_RTOL})")
        require(engine.skipped_steps == 0, f"{path}: {engine.skipped_steps} steps overflowed "
                "at the default scale")
        require(abs(first - bf16) <= FP16_FIRST_LOSS_RTOL * bf16,
                f"{path}: first loss {first} far from the bf16 path's {bf16}")
    require(all(math.isfinite(x) for x in losses), f"non-finite {path} loss")
    require(losses[-1] < losses[0], f"{path} loss did not fall: {losses}")
    for name in expect:
        require(counts[name] > 0, f"kernel {name} was not launched on the {path} path")
    require(sum(plain.values()) == 0, f"{path}: plain attention ran on the card {plain}")
    profile_device(lambda: engine.train_batch(batch=batch), f"one {path} step")
    del engine
    torch.cuda.empty_cache()
    if not rerun:
        return counts
    engine = build()
    rerun = [engine.train_batch(batch=batch).item() for _ in range(3)]
    masters = [t.detach().cpu() for t in tree_leaves(engine.params)]
    print(f"determinism: 3 steps rerun from the same seed {rerun}, bitwise equal "
          f"to the first run: {rerun == losses[:3]}")
    require(rerun == losses[:3], "the rerun from the same seed gave other losses")
    del engine
    torch.cuda.empty_cache()
    # the same 3 steps through DeepSpeed's loop: engine(mb), backward, step
    engine = build()
    looped = []
    for _ in range(3):
        for i in range(TRAIN_ACCUM):
            mb = {k: v[i * TRAIN_B:(i + 1) * TRAIN_B] for k, v in batch.items()}
            engine.backward(engine(mb))
        looped.append(engine.step().item())
    same = all(torch.equal(a, b.detach().cpu())
               for a, b in zip(masters, tree_leaves(engine.params)))
    print(f"the loop (engine(mb), engine.backward(loss), engine.step()), 3 steps from the "
          f"same seed: losses {looped}, bitwise equal to train_batch's: "
          f"{looped == losses[:3]}; masters after 3 steps bitwise equal to the "
          f"train_batch rerun's: {same}")
    require(looped == losses[:3] and same,
            "the forward/backward/step loop differs from train_batch")
    del engine, masters
    torch.cuda.empty_cache()
    return counts


def check_fp16_forms(timer) -> tuple:
    """The fp16 forms at their path's shapes, from a generator of their own,
    each against its plain version within an eighth of the bf16 form's
    tolerance and timed as the bf16 rows are (the bound's bytes are bf16's:
    both 2 bytes; fp16's tensor-core rate is bf16's): the flash forward, dq
    and dk/dv in the Llama form at training_fp16's micro-batch (B=4 S=2048,
    32 query / 8 kv heads of 64) and at Llama-3-8B's heads (B=1, hd 128),
    SDPA in fp16 the library call; the RMSNorm forward and backward on
    training_fp16's 8192 rows of 2048, ``F.rms_norm`` in fp16 the library
    call. Returns (the rows of training_fp16, keyed by kernel; the hd-128
    rows, printed beside them)."""
    gen = torch.Generator(device="cuda").manual_seed(89)
    F16 = torch.float16
    main, extra = {}, {}
    for D, B, into in ((64, TRAIN_B, main), (128, 1, extra)):
        into["flash_attention_fwd_f16"] = flash_fwd_case(gen, timer, "training_fp16", B,
                                                         TRAIN_S, 32, 8, D, dtype=F16)
        into["flash_attention_bwd_dq_f16"], into["flash_attention_bwd_dkv_f16"] = \
            check_flash_bwd(gen, timer, D=D, B=B, S=TRAIN_S, dtype=F16)
    n, D, eps = TRAIN_B * TRAIN_S, 2048, 1e-5
    atol, rtol = FP16_NORM_ATOL, FP16_NORM_RTOL
    w = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(F16)
    x = torch.randn(n, D, generator=gen, device="cuda", dtype=F16)
    g = torch.randn(n, D, generator=gen, device="cuda", dtype=F16)
    fn = lambda t: rn.rmsnorm_fwd(t, w, eps)  # noqa: E731
    plain = lambda t: rn.rmsnorm_plain(t, w, eps)  # noqa: E731
    e = norm_agrees("rmsnorm_fwd (fp16)", fn, plain, x, atol, rtol)
    main["rmsnorm_fwd_f16"] = norm_row(timer, e, lambda: fn(x), lambda: plain(x),
                                       lambda: F.rms_norm(x, (D,), w, eps),
                                       *bound(4 * x.numel(), 2 * 2 * x.numel() + 2 * D),
                                       f"rows={n} D={D} fp16")
    e_dx, e_ds = rmsnorm_bwd_agrees("rmsnorm_bwd (fp16)", x, w, g, eps, atol, rtol, 1e-5)
    xr, wr = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
    lib_out = F.rms_norm(xr, (D,), wr, eps)
    b_ms, b_by = bound(10 * x.numel(), 3 * 2 * x.numel() + 2 * D + 4 * D)
    main["rmsnorm_bwd_f16"] = {
        "max_abs_err": max(e_dx, e_ds), "ms": timer(lambda: rn.rmsnorm_bwd(x, w, g, eps)),
        "plain_ms": timer(lambda: rn.rmsnorm_bwd_plain(x, w, g, eps)),
        "library_ms": timer(lambda: torch.autograd.grad(lib_out, (xr, wr), g,
                                                        retain_graph=True)),
        "bound_ms": b_ms, "bound_by": b_by,
        "shape": f"rows={n} D={D} fp16 (library: F.rms_norm backward)"}
    del x, g, xr, wr, lib_out
    torch.cuda.empty_cache()
    return main, extra


def check_fp16_overflow() -> None:
    """The fp16 forms round to nearest, never clamping (the .satfinite
    forms), so an overflow reaches the loss scaler as inf or NaN: a RMSNorm
    row whose result passes 65,504 (one non-zero element: xhat = sqrt(D) =
    45.25, times a scale of 2,000) gives inf; the dq kernel on gradients
    large enough that the fp32 plain result passes 65,504 gives a non-finite
    value at each of those elements (dst, rounded to fp16 before dS K as the
    Pallas kernel rounds it, may overflow first: inf, or inf * 0 = NaN)."""
    F16 = torch.float16
    gen = torch.Generator(device="cuda").manual_seed(91)
    D = 2048
    x = torch.zeros(1, D, device="cuda", dtype=F16)
    x[0, 0] = 1.0
    out = rn.rmsnorm_fwd(x, torch.full((D,), 2000.0, device="cuda", dtype=F16))
    print(f"rmsnorm_fwd (fp16), one element of 1 in a row of {D}, scale 2000 (fp32 result "
          f"{math.sqrt(D) * 2000:.1f}): {out[0, :2].tolist()}")
    require(bool(torch.isinf(out[0, 0])) and out[0, 1].item() == 0.0,
            "rmsnorm_fwd (fp16) does not give inf past 65,504")
    B, S, H, KV, Dh = 1, 256, 8, 2, 64
    q = torch.randn(B, S, H, Dh, generator=gen, device="cuda", dtype=F16)
    k = 4 * torch.randn(B, S, KV, Dh, generator=gen, device="cuda", dtype=F16)
    v = torch.randn(B, S, KV, Dh, generator=gen, device="cuda", dtype=F16)
    do = (2e4 * torch.randn(B, S, H, Dh, generator=gen, device="cuda").clamp(-3, 3)).to(F16)
    o, lse = fa.flash_attention_fwd(q, k, v)
    dq, _ = fa.flash_attention_bwd_dq(q, k, v, o, lse, do)
    ref, _ = fa.flash_attention_bwd_dq_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                             do.float())
    over = ref.abs() > 65504 * 1.01
    print(f"flash_attention_bwd_dq (fp16), do of up to 6e4: {int(over.sum())} elements of "
          f"the fp32 plain dq past 65,504 (largest {ref.abs().max().item():.1f}); the "
          f"kernel's dq non-finite at {int((~torch.isfinite(dq[over])).sum())} of them, "
          f"{int((~torch.isfinite(dq)).sum())} of {dq.numel()} in all")
    require(bool(over.any()) and not bool(torch.isfinite(dq[over]).any()),
            "flash_attention_bwd_dq (fp16) hides an overflow")


HASH_CHUNK = 1 << 24  # elements a hashing pass takes


def state_hash(engine) -> str:
    """A hash of the engine's masters, optimizer state and update count,
    computed on the card: each fp32 leaf's bits as int32, times a fixed
    random odd int64 weight per position (in chunks of HASH_CHUNK), summed
    with int64 wraparound; the per-leaf sums then through sha256 on the
    host. Any flipped bit changes its leaf's sum."""
    import hashlib
    w = torch.randint(-2**62, 2**62, (HASH_CHUNK,), device="cuda", dtype=torch.int64,
                      generator=torch.Generator(device="cuda").manual_seed(97)) | 1
    sums = []
    for t in tree_leaves(engine.params) + tree_leaves(engine.opt_state):
        flat = t.detach().reshape(-1).view(torch.int32)
        acc = torch.zeros((), dtype=torch.int64, device="cuda")
        for s in range(0, flat.numel(), HASH_CHUNK):
            c = flat[s:s + HASH_CHUNK]
            acc += (c.long() * w[:c.numel()]).sum()
        sums.append(acc)
    h = hashlib.sha256(torch.stack(sums).cpu().numpy().tobytes())
    h.update(str(engine.update_count).encode())
    return h.hexdigest()


def fp16_overflow_leg() -> None:
    """training_fp16's forced-overflow leg: llama3-1b at full width and
    depth from training's seeded masters and batch, fp16 with the scaler at
    2**FP16_OVERFLOW_POWER, FP16_OVERFLOW_STEPS steps. The head's fp16
    logits gradient (about the scale over a micro-batch's 8,192 tokens,
    2**19) overflows every step, so each step is skipped: the masters, the
    Adam moments and the update count hash as before the step; the scale
    read after each step is 2**32 (the hysteresis absorbs the first), then
    2**31, 2**30; the lr does not move."""
    model = llama("llama3-1b")
    ids = torch.randint(0, model.config.vocab_size, (TRAIN_B * TRAIN_ACCUM, TRAIN_S),
                        generator=torch.Generator().manual_seed(0)).cuda()
    config = {**train_config(True), **FP16_SECTIONS,
              "fp16": {"enabled": True, "initial_scale_power": FP16_OVERFLOW_POWER}}
    engine, *_ = initialize(model=model, config=config,
                            rng=torch.Generator(device="cuda").manual_seed(0))
    h0, lr0 = state_hash(engine), engine.lr
    scales, flags, lrs, same = [], [], [], []
    for _ in range(FP16_OVERFLOW_STEPS):
        loss = engine.train_batch(batch={"input_ids": ids}).item()
        scales.append(engine.loss_scale)
        flags.append(engine._metrics["overflow"])
        lrs.append(engine._metrics["lr"])
        same.append(state_hash(engine) == h0)
        require(math.isfinite(loss), "the overflow leg's loss (forward only) is not finite")
    want = [2.0 ** (FP16_OVERFLOW_POWER - i) for i in range(FP16_OVERFLOW_STEPS)]
    print(f"training_fp16 overflow leg (initial_scale_power {FP16_OVERFLOW_POWER}, "
          f"{FP16_OVERFLOW_STEPS} steps): overflow {flags}, scale read after each step "
          f"{scales} (expected {want}), skipped_steps {engine.skipped_steps}, global_steps "
          f"{engine.global_steps}, lr {lrs} (before: {lr0}, after: {engine.lr}); masters, "
          f"Adam moments and update count hash as before each step: {same} ({h0[:16]})")
    require(all(flags) and scales == want and engine.skipped_steps == FP16_OVERFLOW_STEPS,
            f"the overflow leg: overflow {flags}, scales {scales}, expected {want}")
    require(all(same), "a skipped fp16 step changed the masters or the optimizer state")
    require(all(x == lrs[0] for x in lrs) and engine.lr == lr0,
            "the lr moved over skipped steps")
    del engine
    gc.collect()
    torch.cuda.empty_cache()


def main_path_training_fp16() -> dict:
    """training_fp16: the training main path (llama3-1b at full width and
    depth, training's seeded masters and batch, 10 steps, ms a step and MFU)
    in fp16 with the default dynamic loss scaler, no step skipped; then
    :func:`fp16_overflow_leg`. Returns the main run's counts."""
    counts = main_path_training(None, TRAINING_FP16_KERNELS, "training_fp16",
                                extra=FP16_SECTIONS, rerun=False)
    fp16_overflow_leg()
    return counts


def mixtral_active_params(cfg) -> int:
    """The parameters a token's forward runs through: all but the token table
    and the experts it is not routed to (E - top_k of each layer's E)."""
    bank = (3 if cfg.activation == "swiglu" else 2) * cfg.hidden_size * cfg.ffn
    return (cfg.num_params() - cfg.vocab_size * cfg.hidden_size
            - cfg.num_layers * (cfg.num_experts - cfg.moe_top_k) * bank)


@contextlib.contextmanager
def moe_gating_stats(store: list):
    """Keep every one-hot gating call's tokens per expert and drop fraction
    (device tensors, no host read until the caller's)."""
    real = smoe.top_k_gating

    def spy(*a, **k):
        out = real(*a, **k)
        store.append({n: out[2][n] for n in ("tokens_per_expert", "drop_fraction")})
        return out

    smoe.top_k_gating = spy
    try:
        yield
    finally:
        smoe.top_k_gating = real


def check_mixtral_training_shapes(timer) -> dict:
    """The kernels of training_mixtral at its shapes, from a generator of
    their own: the flash forward, dq and dk/dv at the micro-batch (4 x 2048,
    32 query / 8 kv heads of 128, causal), the RMSNorm forward and backward
    on its 8192 rows of 4096, and fused Adam on its largest leaf (the stacked
    expert bank, 2 x 8 x 4096 x 14336 fp32). Returns a timed row per kernel."""
    return check_training_shapes(timer, "training_mixtral", TRAIN_B, 2 * 8 * 4096 * 14336, 73)


def check_zero_shapes(timer) -> dict:
    """The kernels of training_zero at its shapes: a rank's micro-batch of
    1 x 8,192 tokens (llama3-1b's 32 query / 8 kv heads of 64), its 8,192
    rows of 2,048, and fused Adam on the largest part a rank updates (half
    the token table, 128,256 x 2,048 / 2 fp32), from a generator of their
    own; the flash plain versions, 80-170 ms a call at 8,192 tokens, timed over
    5 launches, as check_offset_forms times them."""
    return check_training_shapes(timer, "training_zero", 1, 128256 * 2048 // SP_SIZE, 83,
                                 hd=64, S=SP_SEQ // SP_SIZE, D=2048, plain_iters=5)


def check_8b_offload_shapes(timer) -> dict:
    """The kernels of training_8b_offload at its shapes: Llama-3-8B's
    micro-batch of 1 x 2048 (32 query / 8 kv heads of 128), its 2048 rows of
    4096, and fused Adam on a layer slot's largest slice (the MLP's
    4096 x 14336 fp32), from a generator of their own."""
    return check_training_shapes(timer, "training_8b_offload", OFFLOAD_8B_B, 4096 * 14336, 79)


def check_training_shapes(timer, path: str, B: int, adam_n: int, seed: int,
                          hd: int = 128, S: int = TRAIN_S, D: int = 4096,
                          plain_iters: int = 20) -> dict:
    """A training path's kernels at micro-batch ``B`` x ``S`` (32 query / 8
    kv heads of ``hd``; Llama-3-8B's and Mixtral's of 128 by default): the
    flash forward, dq and dk/dv, the RMSNorm forward and backward on its
    rows of ``D``, fused Adam on ``adam_n`` fp32 elements. A timed row each
    (the flash plain versions over ``plain_iters`` launches)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = {"flash_attention_fwd": flash_fwd_case(gen, timer, path, B, S, 32, 8, hd,
                                                  plain_iters)}
    rows["flash_attention_bwd_dq"], rows["flash_attention_bwd_dkv"] = check_flash_bwd(
        gen, timer, D=hd, B=B, S=S, plain_iters=plain_iters)
    n, eps = B * S, 1e-5
    atol, rtol = 1e-3, 1.6e-2  # two bf16 ulps of the plain result
    w = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(BF16)
    x = torch.randn(n, D, generator=gen, device="cuda", dtype=BF16)
    g = torch.randn(n, D, generator=gen, device="cuda", dtype=BF16)
    fn = lambda t: rn.rmsnorm_fwd(t, w, eps)  # noqa: E731
    plain = lambda t: rn.rmsnorm_plain(t, w, eps)  # noqa: E731
    e = norm_agrees("rmsnorm_fwd", fn, plain, x, atol, rtol)
    rows["rmsnorm_fwd"] = norm_row(timer, e, lambda: fn(x), lambda: plain(x),
                                   lambda: F.rms_norm(x, (D,), w, eps),
                                   *bound(4 * x.numel(), 2 * 2 * x.numel() + 2 * D),
                                   f"rows={n} D={D} bf16")
    e_dx, e_ds = rmsnorm_bwd_agrees("rmsnorm_bwd", x, w, g, eps, atol, rtol, 1e-5)
    xr, wr = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
    lib_out = F.rms_norm(xr, (D,), wr, eps)
    b_ms, b_by = bound(10 * x.numel(), 3 * 2 * x.numel() + 2 * D + 4 * D)
    rows["rmsnorm_bwd"] = {
        "max_abs_err": max(e_dx, e_ds), "ms": timer(lambda: rn.rmsnorm_bwd(x, w, g, eps)),
        "plain_ms": timer(lambda: rn.rmsnorm_bwd_plain(x, w, g, eps)),
        "library_ms": timer(lambda: torch.autograd.grad(lib_out, (xr, wr), g,
                                                        retain_graph=True)),
        "bound_ms": b_ms, "bound_by": b_by,
        "shape": f"rows={n} D={D} bf16 (library: F.rms_norm backward)"}
    del x, g, xr, wr, lib_out
    torch.cuda.empty_cache()
    rows["fused_adam"] = check_fused_adam(gen, timer, n=adam_n)
    torch.cuda.empty_cache()
    return rows


def main_path_training_mixtral() -> dict:
    """``initialize(mixtral("mixtral-8x7b", num_layers=2))`` at full width
    (depth cut from 32: the fp32 masters, gradients and Adam moments take 16
    bytes a parameter, 50.6 GB at two layers, 97 GB at four), seeded random
    masters, bf16 over fp32 masters, AdamW through fused Adam, ZeRO 0, the
    ``moe`` section at ep 1, the model's default "einsum" dispatch; one seeded
    batch of 8 x 2048 tokens (micro-batch 4, 2 accumulation steps), 6 steps.
    The loss must be finite and fall, the aux loss finite, and every training
    kernel launched; prints ms/step, tokens/s, MFU over the active
    parameters, peak memory, the last step's tokens per expert and drop
    fraction, and a profiled step."""
    model = mixtral("mixtral-8x7b", num_layers=MIXTRAL_TRAIN_LAYERS)
    cfg = model.config
    steps, rows, tokens = MIXTRAL_TRAIN_STEPS, TRAIN_B * TRAIN_ACCUM, TRAIN_B * TRAIN_ACCUM * TRAIN_S
    ids = torch.randint(0, cfg.vocab_size, (rows, TRAIN_S),
                        generator=torch.Generator().manual_seed(0)).cuda()
    batch = {"input_ids": ids}
    active = mixtral_active_params(cfg)
    t0 = time.perf_counter()
    engine, *_ = initialize(model=model,
                            config={**train_config(True), "moe": {"enabled": True, "ep_size": 1}},
                            rng=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    capacity = smoe.train_capacity(cfg, TRAIN_B * TRAIN_S)
    print(f"training_mixtral main path: {cfg.name} L={cfg.num_layers} (cut from 32: fp32 "
          f"masters, gradients and Adam moments at 16 B a parameter take "
          f"{16 * cfg.num_params() / 1e9:.1f} GB at two layers) d={cfg.hidden_size} "
          f"H={cfg.num_heads} KV={cfg.kv_heads} hd={cfg.hd} ffn={cfg.ffn} "
          f"E={cfg.num_experts} top-{cfg.moe_top_k} V={cfg.vocab_size} "
          f"({cfg.num_params() / 1e9:.3f} B params, {active / 1e9:.3f} B active a token), "
          f"dispatch {cfg.moe_dispatch}, training capacity {capacity} an expert "
          f"({cfg.num_experts * capacity} expert rows a micro-batch for "
          f"{cfg.moe_top_k * TRAIN_B * TRAIN_S} assignments); init "
          f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.1f} GiB "
          f"allocated")
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, aux, stats = [], [], []
    with moe_gating_stats(stats):
        for i in range(steps):
            losses.append(engine.train_batch(batch=batch))
            aux.append(engine._metrics["moe_aux_loss"])
            if i == 0:
                torch.cuda.synchronize()
                peak_first = torch.cuda.max_memory_allocated()
            if i == 1:  # the first two steps warm up cuBLAS and the allocator
                torch.cuda.synchronize()
                t_warm = time.perf_counter()
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t_warm) * 1e3 / (steps - 2)
    counts = kernels.launch_counts()
    losses, aux = [x.item() for x in losses], [x.item() for x in aux]
    peak = torch.cuda.max_memory_allocated()
    pairs = rows * TRAIN_S * (TRAIN_S + 1) / 2
    flops = 6 * active * tokens + 12 * cfg.hd * cfg.num_heads * cfg.num_layers * pairs
    mfu = flops / (ms_step / 1e3) / BF16_FLOPS
    # dispatch and combine products a layer and micro-batch: 2 N E C D each,
    # forward 2, backward 3 (tokens' and combine's and expert outputs' gradients)
    onehot = 5 * 2 * TRAIN_B * TRAIN_S * cfg.num_experts * capacity * cfg.hidden_size \
        * cfg.num_layers * TRAIN_ACCUM
    last = stats[-cfg.num_layers * TRAIN_ACCUM:]  # the last step's gating calls
    per_expert = torch.stack([m["tokens_per_expert"] for m in last]).sum(0).tolist()
    drop = torch.stack([m["drop_fraction"] for m in last]).mean().item()
    plain = kernels.plain_attention_on_cuda()
    print(f"training_mixtral losses: {losses}")
    print(f"training_mixtral aux losses (summed over the layers, before the 0.01 "
          f"coefficient): {aux}")
    print(f"training_mixtral: {ms_step:.2f} ms/step (steps 3-{steps}), "
          f"{tokens / (ms_step / 1e3):.1f} tokens/s, MFU {mfu:.4f} (6 x {active / 1e9:.3f} B "
          f"active params x tokens + attention over the causal pairs, over "
          f"{BF16_FLOPS / 1e12:.0f} TFLOP/s bf16; not counted as model flops: the one-hot "
          f"dispatch/combine products, {onehot / 1e12:.1f} TFLOP a step, and the expert "
          f"rows past the routed ones at capacity), peak memory {peak / 2**30:.2f} GiB "
          f"({peak_first / 2**30:.2f} GiB after the first step)")
    print(f"training_mixtral last step: tokens per expert {per_expert} (both layers and "
          f"micro-batches), drop fraction {drop:.4f}")
    print(f"training_mixtral main path launches ({steps} steps): "
          f"{ {k: counts[k] for k in MIXTRAL_TRAIN_KERNELS} }; plain attention on the card "
          f"{plain}")
    require(all(math.isfinite(x) for x in losses), "non-finite training_mixtral loss")
    require(all(math.isfinite(x) for x in aux), "non-finite training_mixtral aux loss")
    require(losses[-1] < losses[0], f"training_mixtral loss did not fall: {losses}")
    for name in MIXTRAL_TRAIN_KERNELS:
        require(counts[name] > 0, f"kernel {name} was not launched on the training_mixtral path")
    require(sum(plain.values()) == 0, f"training_mixtral: plain attention ran on the card {plain}")
    profile_device(lambda: engine.train_batch(batch=batch), "one training_mixtral step")
    del engine, stats, last
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# the checkpoint phase: llama3-1b's tags go under the checkout (ckpts/ is
# git-ignored) and are deleted at the phase's end
CKPT_DIR = Path(__file__).resolve().parent / "ckpts" / "chip_smoke_checkpoint"


def host_memory() -> dict:
    """MemTotal and MemAvailable from /proc/meminfo, in bytes."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, value = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable"):
                out[key] = int(value.split()[0]) * 1024
    return out


def filesystem_type(path: Path) -> str:
    """The type of the mount that holds ``path`` (from /proc/mounts)."""
    target, best, kind = str(path.resolve()), "", "unknown"
    with open("/proc/mounts") as f:
        for line in f:
            point, fstype = line.split()[1:3]
            inside = target == point or target.startswith(point.rstrip("/") + "/")
            if inside and len(point) > len(best):
                best, kind = point, fstype
    return kind


def disk_free(path: Path) -> int:
    """Free bytes of the filesystem that holds ``path`` (or its nearest
    existing parent)."""
    while not path.exists():
        path = path.parent
    return shutil.disk_usage(path).free


def io_probe() -> None:
    """``--io-probe``: the rates the checkpoint phase stands on, on its
    filesystem and host: 4 GiB written with ``np.save`` (into the page
    cache), then ``os.sync``, then read back with ``np.load``; 1 GiB of pinned
    host memory allocated; 1 GiB copied off the card into it."""
    a = np.random.default_rng(0).random(1 << 28, dtype=np.float32)  # 1 GiB
    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    try:
        t0 = time.perf_counter()
        for i in range(4):
            np.save(CKPT_DIR / f"probe{i}.npy", a)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        os.sync()
        sync_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(4):
            np.load(CKPT_DIR / f"probe{i}.npy")
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    pinned = torch.empty(1 << 28, dtype=torch.float32, pin_memory=True)
    pin_s = time.perf_counter() - t0
    src = torch.randn(1 << 28, device="cuda")
    torch.cuda.synchronize()
    copies = []
    for _ in range(3):
        t0 = time.perf_counter()
        pinned.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        copies.append(time.perf_counter() - t0)
    print(f"io probe under {CKPT_DIR.parent}: np.save 4 GiB {save_s:.2f} s, then os.sync "
          f"{sync_s:.2f} s; np.load 4 GiB {load_s:.2f} s; pinning 1 GiB {pin_s:.2f} s; "
          f"1 GiB off the card into it {[round(c, 4) for c in copies]} s")


def check_checkpoint_serving_shapes(timer) -> dict:
    """The serving kernels at llama3-1b's shapes (the checkpoint phase serves
    its checkpoint): the flash forward on the B=4 x 512 prefill (32 query and
    8 kv heads of 64), the decode kernel at the B=4 decode step over a
    1024-token cache, the RMSNorm forward on the prefill's 2048 rows of 2048;
    from a generator of their own. Returns a timed row per kernel."""
    gen = torch.Generator(device="cuda").manual_seed(53)
    rows = {"flash_attention_fwd": flash_fwd_case(gen, timer, "checkpoint_serving", 4, 512,
                                                  32, 8, 64),
            "decode_attention": check_decode(gen, timer, H=32, KV=8, D=64)}
    n, D, eps = 4 * 512, 2048, 1e-5
    w = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(BF16)
    x = torch.randn(n, D, generator=gen, device="cuda", dtype=BF16)
    fn = lambda t: rn.rmsnorm_fwd(t, w, eps)  # noqa: E731
    plain = lambda t: rn.rmsnorm_plain(t, w, eps)  # noqa: E731
    e = norm_agrees("rmsnorm_fwd", fn, plain, x, 1e-3, 1.6e-2)
    rows["rmsnorm_fwd"] = norm_row(timer, e, lambda: fn(x), lambda: plain(x),
                                   lambda: F.rms_norm(x, (D,), w, eps),
                                   *bound(4 * x.numel(), 2 * 2 * x.numel() + 2 * D),
                                   f"rows={n} D={D} bf16")
    return rows


def tag_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def state_differs_from_tag(engine, tag_dir: Path) -> tuple:
    """Each tensor of the engine's masters and optimizer state against the
    leaf of the same name in ``tag_dir`` (``torch.equal`` on the host), and
    each update count against the tag's. Returns ({name: max abs difference}
    of the leaves that differ, the number of leaves)."""
    meta = read_manifest(str(tag_dir.parent), tag_dir.name)
    differ, total = {}, 0
    for comp in ("params", "opt_state"):
        named = engine.checkpoint_components()[comp]
        for name, leaf, entries in _match_leaves(named, str(tag_dir / comp), True,
                                                 _stored_names(meta, comp)):
            stored = torch.from_numpy(np.asarray(_assemble_leaf(entries), order="C"))
            mine = leaf.detach().cpu() if torch.is_tensor(leaf) else torch.from_numpy(leaf)
            if not torch.equal(mine, stored):
                differ[comp + name] = (mine.double() - stored.double()).abs().max().item()
            total += 1
    return differ, total


def main_path_checkpoint() -> tuple:
    """Checkpointing on one device at full width and depth: ``llama3-1b``
    with ``training``'s config (bf16 over fp32 masters, AdamW through fused
    Adam, micro-batch 4 x 2 accumulation steps of 2048 tokens, the seeded
    batch) and ``checkpoint: {async_save: true, keep_last: 2}``. Two steps,
    a sync save (its bytes, seconds, GB/s), two more steps, an async save
    (the fence the loop waits for, then the writer's seconds); the engine
    freed, a fresh one (other random masters) loads the step-2 tag and runs
    steps 3-4 with the counters zeroed just before: the losses bitwise the
    uninterrupted run's, every training kernel launched, and its masters and
    Adam moments bitwise the async step-4 tag's, leaf by leaf. Then
    ``init_inference(checkpoint=DIR)`` (the step-4 tag) against
    ``init_inference(params=)`` of the same masters, bf16, kernel injection:
    the three serving requests' tokens bitwise equal, the serving kernels
    launched (counters zeroed before the checkpoint engine's run); and
    ``save_16bit_model``, every tensor read back equal to the masters' bf16
    cast under its HF name. Fails naming the shortfall when the box lacks the
    disk or host memory. The directory is deleted at the end. Returns the
    counts of the resumed steps and of the checkpoint engine's serving."""
    model = llama("llama3-1b")
    cfg = model.config
    n = cfg.num_params()
    state = 3 * 4 * n  # a tag: the fp32 masters and two Adam moments
    need_disk = 2 * state + 2 * n + (1 << 30)
    # the pinned snapshot generation, one leaf assembled by the loader, and
    # the process around them
    need_host = state + (16 << 30)
    free, mem = disk_free(CKPT_DIR), host_memory()
    print(f"checkpoint phase: {cfg.name} ({n / 1e9:.3f} B params), a tag "
          f"{state / 1e9:.2f} GB; needs {need_disk / 1e9:.2f} GB of disk ({free / 1e9:.2f} GB "
          f"free under {CKPT_DIR.parent}) and {need_host / 2**30:.1f} GiB of host memory "
          f"({mem['MemAvailable'] / 2**30:.1f} GiB available)")
    require(free >= need_disk, f"checkpoint phase: {free / 1e9:.2f} GB of disk free under "
            f"{CKPT_DIR.parent}, {need_disk / 1e9:.2f} GB needed (two llama3-1b tags and "
            f"the 16-bit export)")
    require(mem["MemAvailable"] >= need_host, f"checkpoint phase: "
            f"{mem['MemAvailable'] / 2**30:.1f} GiB of host memory available, "
            f"{need_host / 2**30:.1f} GiB needed (a pinned snapshot of the whole state)")
    ids = torch.randint(0, cfg.vocab_size, (TRAIN_B * TRAIN_ACCUM, TRAIN_S),
                        generator=torch.Generator().manual_seed(0)).cuda()
    batch = {"input_ids": ids}
    config = {**train_config(True), "checkpoint": {"async_save": True, "keep_last": 2}}

    def build(seed: int):
        eng, *_ = initialize(model=model, config=config,
                             rng=torch.Generator(device="cuda").manual_seed(seed))
        return eng

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    try:
        engine = build(0)
        losses = [engine.train_batch(batch=batch).item() for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path2 = Path(engine.save_checkpoint(str(CKPT_DIR), async_save=False))
        sync_s = time.perf_counter() - t0
        guard = engine._ckpt_guard()
        nbytes = tag_bytes(path2)
        print(f"checkpoint sync save (step 2): {nbytes} bytes in {sync_s:.2f} s, "
              f"{nbytes / sync_s / 1e9:.3f} GB/s (of it the files and the commit "
              f"{guard.last_write_s:.2f} s; the rest the snapshot into newly pinned "
              f"host buffers)")
        losses += [engine.train_batch(batch=batch).item() for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path4 = Path(engine.save_checkpoint(str(CKPT_DIR)))  # async: the config's
        fence_ms = (time.perf_counter() - t0) * 1e3
        guard.fence()
        print(f"checkpoint async save (step 4): the fence {fence_ms:.1f} ms (the snapshot "
              f"into the sync save's pinned buffers, reused), the writer "
              f"{guard.last_write_s:.2f} s ({tag_bytes(path4) / guard.last_write_s / 1e9:.3f} "
              f"GB/s) behind it")
        require(path4.name == "global_step4" and path2.exists(),
                f"checkpoint tags: {sorted(p.name for p in CKPT_DIR.iterdir())}")
        engine.destroy()
        del engine, guard
        gc.collect()
        torch.cuda.empty_cache()

        resumed = build(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resumed.load_checkpoint(str(CKPT_DIR), tag="global_step2")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        print(f"checkpoint load (step 2) into a fresh engine: {load_s:.2f} s, "
              f"{nbytes / load_s / 1e9:.3f} GB/s")
        require(resumed.global_steps == 2, f"resumed at step {resumed.global_steps}")
        kernels.reset_launch_counts()
        again = [resumed.train_batch(batch=batch).item() for _ in range(2)]
        counts = kernels.launch_counts()
        plain = kernels.plain_attention_on_cuda()
        differ, total = state_differs_from_tag(resumed, path4)
        print(f"checkpoint resume: steps 3-4 losses {again}, the uninterrupted run's "
              f"{losses[2:]}, bitwise equal: {again == losses[2:]}; masters and Adam state "
              f"bitwise the async step-4 tag's in {total - len(differ)} of {total} leaves "
              f"(differing: {differ}); launches "
              f"{ {k: counts[k] for k in TRAINING_KERNELS} }")
        require(all(math.isfinite(x) for x in losses), "non-finite checkpoint-phase loss")
        require(again == losses[2:], "the resumed steps' losses differ from the run's")
        require(not differ, "the resumed state differs from the step-4 tag")
        for name in TRAINING_KERNELS:
            require(counts[name] > 0, f"kernel {name} was not launched on the resumed steps")
        require(sum(plain.values()) == 0, f"checkpoint: plain attention on the card {plain}")

        requests = serving_requests(cfg.vocab_size)
        kw = dict(dtype=BF16, replace_with_kernel_inject=True, max_tokens=1024)
        direct = init_inference(model, params=tree_map(lambda t: t.detach(), resumed.params),
                                **kw)
        want = serve(direct, requests, report=False)
        del direct
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served = init_inference(model, checkpoint=str(CKPT_DIR), **kw)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        kernels.reset_launch_counts()
        got = serve(served, requests, report=True, label="checkpoint ")
        serving_counts = kernels.launch_counts()
        del served
        same_tokens = [torch.equal(a, b) for a, b in zip(got, want)]
        print(f"init_inference(checkpoint=) {init_s:.2f} s (the step-4 masters from disk, "
              f"cast to bf16); tokens bitwise those of init_inference(params=) on the same "
              f"masters: {same_tokens}; launches "
              f"{ {k: serving_counts[k] for k in SERVING_KERNELS} }")
        require(all(same_tokens), "init_inference(checkpoint=) serves other tokens")
        for name in SERVING_KERNELS:
            require(serving_counts[name] > 0,
                    f"kernel {name} was not launched serving the checkpoint")

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exported = Path(resumed.save_16bit_model(str(CKPT_DIR / "export")))
        export_s = time.perf_counter() - t0
        back = read_safetensors(str(exported))
        flat = export_hf_state_dict(resumed.params, cfg, "llama")
        equal = [k for k, t in flat.items()
                 if torch.equal(torch.from_numpy(back[k]), t.detach().to(BF16).float().cpu())]
        print(f"save_16bit_model: {exported.stat().st_size} bytes in {export_s:.2f} s, "
              f"{len(equal)} of {len(flat)} tensors read back equal to the masters' bf16 "
              f"cast under their HF names (names equal: {list(back) == list(flat)})")
        require(list(back) == list(flat) and len(equal) == len(flat),
                "the 16-bit export differs from the masters' bf16 cast")
        del back, flat, resumed
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
        reset_preempt_handler()  # restore the SIGTERM handler the saves chained
        gc.collect()
        torch.cuda.empty_cache()
        if hasattr(torch._C, "_host_emptyCache"):  # the snapshot's pinned blocks
            torch._C._host_emptyCache()
    return counts, serving_counts


# ------------------------------------------------ offload (ZeRO at world 1)
def offload_config(zero: dict, remat: str = "none", micro: int = TRAIN_B) -> dict:
    """training's config (bf16 over fp32 masters, AdamW on fused Adam) with
    ``zero`` as its ZeRO section and the step's breakdown on (the offloaded
    step's halves and its layer stream's device ms)."""
    return {**train_config(True, remat=remat, batch=micro * TRAIN_ACCUM, micro=micro),
            "zero_optimization": zero, "wall_clock_breakdown": True}


def resident_name(name: str) -> str:
    """A bucketed optimizer leaf's name in the resident layout
    (``['layers'][0][0].mu['attn']['wq']`` → ``[0][0].mu['layers']['attn']['wq']``)."""
    for group, prefix in (("['layers']", "['layers']"), ("['rest']", "")):
        if name.startswith(group):
            rest = name[len(group):]
            at = rest.find("['")
            return rest if at < 0 else rest[:at] + prefix + rest[at:]
    return name


def engine_state(engine) -> dict:
    """{resident name: tensor} of an engine's masters and optimizer tensors
    (its own storage: the card, pinned host memory, or swapped in)."""
    comps = engine.checkpoint_components()
    out = {f"params{n}": t for n, t in comps["params"]}
    out.update({resident_name(n): t for n, t in comps["opt_state"] if torch.is_tensor(t)})
    return out


def state_differs(engine, reference: dict) -> list:
    """The leaves whose bytes differ from ``reference`` (copies on the card
    or the host), each compared byte for byte on the card; an NVMe engine's
    state is swapped in for the comparison and out again."""
    engine._swap_in_opt()
    try:
        got = engine_state(engine)
        require(set(got) == set(reference), f"state names differ: {sorted(set(got) ^ set(reference))[:4]}")
        differ = []
        for name, ref in reference.items():
            t = got[name].to("cuda", non_blocking=True)
            r = ref.to("cuda", non_blocking=True)
            if not torch.equal(t.view(torch.int32), r.view(torch.int32)):
                differ.append(name)
            del t, r
        return differ
    finally:
        engine._swap_out_opt()


def adam_launches_a_step(engine) -> int:
    """Fused Adam launches an update takes: one per leaf resident, one per
    stacked leaf per layer plus one per other leaf when bucketed."""
    layers = tree_leaves(engine.params["layers"])
    rest = len(tree_leaves(engine.params)) - len(layers)
    if engine._bucketed is None:
        return len(layers) + rest
    return len(layers) * int(layers[0].shape[0]) + rest


def run_offload_form(label: str, model, zero: dict, batch: dict, steps: int,
                     reference=None, remat: str = "none", micro: int = TRAIN_B,
                     snapshot_at=None) -> tuple:
    """One engine of the offload phases: ``steps`` seeded steps with the
    counters zeroed before them; prints its numbers; holds its losses and
    state to ``reference`` (losses, {steps: state}) when given; with
    ``snapshot_at`` keeps a host copy of its state after that step. Returns
    (losses, counts, engine, info)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, *_ = initialize(model=model, config=offload_config(zero, remat, micro),
                            rng=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    kernels.reset_launch_counts()
    losses, ms, timings, snapshot = [], [], [], None
    for i in range(steps):
        t0 = time.perf_counter()
        losses.append(engine.train_batch(batch=batch))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        timings.append(dict(engine._timings))
        if snapshot_at == i + 1:  # outside the timed steps' numbers
            snapshot = {k: t.detach().cpu() for k, t in engine_state(engine).items()}
    counts = kernels.launch_counts()
    losses = [x.item() for x in losses]
    resident = torch.cuda.memory_allocated()
    peak = torch.cuda.max_memory_allocated()
    stream = engine.offload_stream
    last = timings[-1]
    line = (f"{label}: init {init_s:.1f} s; step ms {[round(x, 1) for x in ms]}; peak "
            f"{peak} bytes ({peak / 2**30:.2f} GiB), resident between steps {resident} bytes "
            f"({resident / 2**30:.2f} GiB); host bytes {engine.host_state_bytes()}")
    if stream is not None:
        line += (f"; the update's stream {stream['bytes_in']} bytes in, {stream['bytes_out']} "
                 f"out a step ({stream['device']}, slots {stream['slots']}, slot "
                 f"{stream['slot_bytes']} bytes); the forward's copy of host masters "
                 f"{stream['forward_bytes_in']} bytes in")
    if "stream_copy_in" in last:
        gbs_in = stream["bytes_in"] / last["stream_copy_in"] / 1e6
        gbs_out = stream["bytes_out"] / last["stream_copy_out"] / 1e6
        line += (f"; last step: fwd+bwd {last['fwd_bwd']:.1f} ms, update {last['update']:.1f} "
                 f"ms, the stream's device ms copy in {last['stream_copy_in']:.1f} "
                 f"({gbs_in:.2f} GB/s), update {last['stream_update']:.1f}, copy out "
                 f"{last['stream_copy_out']:.1f} ({gbs_out:.2f} GB/s)")
    print(line)
    expect = {name: counts[name] for name in TRAINING_KERNELS}
    print(f"{label} losses {losses}; launches {expect}; fused Adam "
          f"{adam_launches_a_step(engine)} a step expected")
    require(all(math.isfinite(x) for x in losses), f"{label}: non-finite loss")
    for name in TRAINING_KERNELS:
        require(counts[name] > 0, f"{label}: kernel {name} was not launched")
    require(counts["fused_adam"] == steps * adam_launches_a_step(engine),
            f"{label}: fused Adam launched {counts['fused_adam']} times, "
            f"{steps * adam_launches_a_step(engine)} expected")
    require(sum(kernels.plain_attention_on_cuda().values()) == 0,
            f"{label}: plain attention ran on the card")
    if reference is not None:
        want, states = reference
        state = states[steps]
        differ = state_differs(engine, state)
        print(f"{label}: losses bitwise the reference's: {losses == want[:steps]}; masters and "
              f"optimizer state byte for byte the reference's in {len(state) - len(differ)} "
              f"of {len(state)} leaves (differing: {differ[:4]})")
        require(losses == want[:steps], f"{label}: losses differ from the resident run's")
        require(not differ, f"{label}: state differs from the resident run's")
    return losses, counts, engine, {"ms": ms, "timings": timings, "peak": peak,
                                    "resident": resident, "snapshot": snapshot}


def free_engine(engine, label: str = "") -> None:
    """Destroy ``engine`` and print the host memory left: its pinned state
    goes back to the box."""
    engine.destroy()
    gc.collect()
    torch.cuda.empty_cache()
    rss = next(int(line.split()[1]) * 1024 for line in open("/proc/self/status")
               if line.startswith("VmRSS"))
    print(f"{label} freed: MemAvailable {host_memory()['MemAvailable'] / 2**30:.1f} GiB, "
          f"this process's resident set {rss / 2**30:.1f} GiB")


def require_host(label: str, need: int, wait_s: float = 60.0) -> None:
    """Fail unless MemAvailable covers ``need``. Page-locked memory freed a
    moment ago comes back to MemAvailable over seconds (the driver unpins
    it behind the free: 4 GiB freed read 3.9 GB short at once, H100 box), so
    a shortfall is polled for up to ``wait_s`` first."""
    t0 = time.perf_counter()
    mem = host_memory()["MemAvailable"]
    while mem < need and time.perf_counter() - t0 < wait_s:
        time.sleep(1.0)
        mem = host_memory()["MemAvailable"]
    print(f"{label}: needs {need / 2**30:.1f} GiB of host memory, "
          f"{mem / 2**30:.1f} GiB available (after {time.perf_counter() - t0:.1f} s)")
    require(mem >= need, f"{label}: {mem / 2**30:.1f} GiB of host memory available, "
            f"{need / 2**30:.1f} GiB needed")


def main_path_offload() -> dict:
    """ZeRO stages and offload at world 1 on llama3-1b at full width and
    depth, training's config and batch: the five engines of 6c. Returns the
    counts of the optimizer-offload engine's run (the path the kernels line
    reads)."""
    model = llama("llama3-1b")
    cfg = model.config
    n = cfg.num_params()
    swap = CKPT_DIR.parent / "chip_smoke_offload"
    need_disk = 2 * 4 * n + (1 << 30)  # the Adam moments' files
    free = disk_free(swap)
    print(f"offload phase: {cfg.name} ({n / 1e9:.3f} B params); the NVMe engine's files "
          f"{2 * 4 * n / 1e9:.2f} GB, {free / 1e9:.2f} GB free under {swap.parent}")
    require(free >= need_disk, f"offload phase: {free / 1e9:.2f} GB of disk free under "
            f"{swap.parent}, {need_disk / 1e9:.2f} GB needed")
    # the largest engine's host state: two generations of the NVMe engine's moments
    require_host("offload phase", 2 * 2 * 4 * n + (8 << 30))
    ids = torch.randint(0, cfg.vocab_size, (TRAIN_B * TRAIN_ACCUM, TRAIN_S),
                        generator=torch.Generator().manual_seed(0)).cuda()
    batch = {"input_ids": ids}
    cpu = {"device": "cpu"}
    forms = [
        ("stage 3", {"stage": 3}, OFFLOAD_STEPS),
        ("stage 3 + offload_optimizer cpu", {"stage": 3, "offload_optimizer": cpu},
         OFFLOAD_STEPS),
        ("stage 3 + offload_param cpu + offload_optimizer cpu",
         {"stage": 3, "offload_param": cpu, "offload_optimizer": cpu}, OFFLOAD_STEPS),
        ("stage 2 + offload_optimizer nvme",
         {"stage": 2, "offload_optimizer": {"device": "nvme", "nvme_path": str(swap)}},
         OFFLOAD_NVME_STEPS),
    ]
    counts = None
    engine = None
    shutil.rmtree(swap, ignore_errors=True)
    try:
        # the reference's state after the NVMe engine's last step, on the host,
        # and after its own, on the card
        losses, _, engine, info = run_offload_form(
            "offload stage 0 (reference)", model, {"stage": 0}, batch, OFFLOAD_STEPS,
            snapshot_at=OFFLOAD_NVME_STEPS)
        reference = (losses, {OFFLOAD_NVME_STEPS: info["snapshot"], OFFLOAD_STEPS: {
            k: t.detach().clone() for k, t in engine_state(engine).items()}})
        del info
        free_engine(engine, "offload stage 0 (reference)")
        for label, zero, steps in forms:
            _, c, engine, _ = run_offload_form(f"offload {label}", model, zero, batch, steps,
                                               reference)
            if engine._swapper is not None:
                sw = engine._swapper
                sw.wait_pending("opt_state")
                print(f"offload {label}: the disk (a {filesystem_type(swap.parent)} mount) "
                      f"read {sw.bytes_read} bytes in {sw.read_s:.2f} s "
                      f"({sw.bytes_read / sw.read_s / 1e9:.3f} GB/s, from submit to landing, "
                      f"partly under forward and backward) and wrote {sw.bytes_written} bytes "
                      f"in {sw.write_s:.2f} s ({sw.bytes_written / sw.write_s / 1e9:.3f} GB/s, "
                      f"the submits and the waits)")
                files = sorted(p.name for p in (swap / "zero_opt_swap").glob("*.bin"))
                require(engine.opt_state is None and files,
                        "offload: the NVMe engine's state is not on disk between steps")
                del sw  # its pool's pinned buffers go with the engine
            if label == "stage 3 + offload_optimizer cpu":
                counts = c
            free_engine(engine, f"offload {label}")
            engine = None
        del reference
    finally:
        if engine is not None:
            engine.destroy()
        shutil.rmtree(swap, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return counts


def main_path_training_8b_offload() -> dict:
    """6d: Llama-3-8B's width at 2 layers, resident against the
    double-buffered cpu offload (bitwise), then Llama-3-8B at
    OFFLOAD_8B_LAYERS layers on the double-buffered cpu offload. Returns
    the full-depth run's counts."""
    micro = OFFLOAD_8B_B
    rows, tokens = micro * TRAIN_ACCUM, micro * TRAIN_ACCUM * TRAIN_S
    zero = {"stage": 3, "offload_optimizer": {"device": "cpu"}}
    two = llama("llama3-8b", num_layers=2)
    ids = torch.randint(0, two.config.vocab_size, (rows, TRAIN_S),
                        generator=torch.Generator().manual_seed(0)).cuda()
    batch = {"input_ids": ids}
    engine = None
    try:
        require_host("training_8b_offload (2 layers)", 2 * 4 * two.config.num_params() + (8 << 30))
        losses, _, engine, _ = run_offload_form(
            "training_8b_offload 2 layers, stage 0 (reference)", two, {"stage": 0}, batch, 2,
            remat="full", micro=micro)
        reference = (losses, {2: {k: t.detach().clone()
                                  for k, t in engine_state(engine).items()}})
        free_engine(engine, "training_8b_offload 2 layers, stage 0")
        _, _, engine, _ = run_offload_form(
            "training_8b_offload 2 layers, stage 3 + offload_optimizer cpu",
            two, zero, batch, 2, reference, remat="full", micro=micro)
        free_engine(engine, "training_8b_offload 2 layers, offloaded")
        engine = None
        del reference

        model = llama("llama3-8b", num_layers=OFFLOAD_8B_LAYERS)
        cfg = model.config
        n = cfg.num_params()
        moments = 2 * 4 * n
        print(f"training_8b_offload: {cfg.name} L={cfg.num_layers} (of 32) d={cfg.hidden_size} "
              f"H={cfg.num_heads} KV={cfg.kv_heads} hd={cfg.hd} ffn={cfg.ffn} "
              f"V={cfg.vocab_size} ({n / 1e9:.3f} B params); fp32 masters {4 * n / 1e9:.1f} GB "
              f"and gradients {4 * n / 1e9:.1f} GB on the card, Adam moments "
              f"{moments / 1e9:.1f} GB pinned on the host")
        require_host("training_8b_offload", moments + (8 << 30))
        _, counts, engine, info = run_offload_form(
            "training_8b_offload", model, zero, batch, OFFLOAD_8B_STEPS, remat="full",
            micro=micro)
        steady = info["ms"][1:]
        ms_step = statistics.mean(steady)
        pairs = rows * TRAIN_S * (TRAIN_S + 1) / 2
        mfu = train_flops(cfg, tokens, pairs) / (ms_step / 1e3) / BF16_FLOPS
        last = info["timings"][-1]
        print(f"training_8b_offload: {ms_step:.1f} ms/step (steps 2-{OFFLOAD_8B_STEPS}), "
              f"{tokens / (ms_step / 1e3):.1f} tokens/s, MFU {mfu:.4f}; split of the last step: "
              f"forward+backward {last['fwd_bwd']:.1f} ms, update {last['update']:.1f} ms "
              f"(device: copy in {last['stream_copy_in']:.1f}, Adam {last['stream_update']:.1f}, "
              f"copy out {last['stream_copy_out']:.1f} ms, on three streams); peak "
              f"{info['peak'] / 2**30:.2f} GiB, resident {info['resident'] / 2**30:.2f} GiB, "
              f"host {engine.host_state_bytes()} bytes")
        for name in TRAINING_KERNELS:
            require(counts[name] > 0, f"training_8b_offload: {name} was not launched")
        profile_device(lambda: engine.train_batch(batch=batch), "one training_8b_offload step")
        free_engine(engine, "training_8b_offload")
        engine = None
    finally:
        if engine is not None:
            engine.destroy()
        gc.collect()
        torch.cuda.empty_cache()
    return counts


# The Llama (slope-free) forms of the attention kernels and the ALiBi forms of
# the flash kernels on seeded inputs, run by ``--baseline`` in this checkout
# and in an earlier one, each in its own process with its own build: only
# calls both checkouts' wrappers take. Each entry is (forward outputs held
# within check_flash's tolerances, or decode outputs within DEC_TOL; backward
# outputs held within BWD_TOL of the largest).
LLAMA_FORMS_SCRIPT = r"""
import sys
import torch
from deepspeed_tpu_torch.ops.cuda import decode_attention as dec
from deepspeed_tpu_torch.ops.cuda import flash_attention as fa

g = torch.Generator(device="cuda").manual_seed(11)


def r(*shape, dtype=torch.bfloat16):
    return torch.randn(*shape, generator=g, device="cuda", dtype=dtype)


outs = {}
for B, S, H, KV, D in ((2, 300, 32, 8, 128), (2, 512, 32, 8, 64), (1, 130, 12, 12, 64)):
    q, k, v, do = r(B, S, H, D), r(B, S, KV, D), r(B, S, KV, D), r(B, S, H, D)
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    outs[f"flash fwd+bwd B={B} S={S} H={H} KV={KV} D={D}"] = (
        [o, lse], list(fa.flash_attention_bwd(q, k, v, o, lse, do, True)))
    sl = torch.tensor([2.0 ** (-8 * (i + 1) / H) for i in range(H)], device="cuda")
    o, lse = fa.flash_attention_fwd(q, k, v, True, sl)
    outs[f"flash ALiBi fwd+bwd B={B} S={S} H={H} KV={KV} D={D}"] = (
        [o, lse], list(fa.flash_attention_bwd(q, k, v, o, lse, do, True, sl)))
q = r(4, 1, 32, 128)
kc, vc = r(4, 1024, 8, 128), r(4, 1024, 8, 128)
fr = torch.tensor([0, 37, 511, 1023], dtype=torch.int32, device="cuda")
outs["decode B=4 frontiers"] = (
    [dec.decode_attention(q, kc, vc, fr), dec.decode_attention(q, kc, vc, 700)], [])
k8 = torch.randint(-127, 128, (4, 1024, 8, 128), generator=g, device="cuda").to(torch.int8)
v8 = torch.randint(-127, 128, (4, 1024, 8, 128), generator=g, device="cuda").to(torch.int8)
ks, vs = r(4, 8, 1024, dtype=torch.float32).abs() / 100, r(4, 8, 1024, dtype=torch.float32).abs() / 100
outs["decode int8"] = ([dec.decode_attention(q, k8, v8, fr, ks, vs)], [])
table = torch.randperm(256, generator=torch.Generator().manual_seed(5)).int().reshape(4, 64).cuda()
pool_k, pool_v = r(257, 16, 8, 128), r(257, 16, 8, 128)
rows = r(4 * 8, 1, 32, 128)
fr8 = torch.arange(32, dtype=torch.int32, device="cuda") * 31
outs["paged rows_per_seq=8"] = ([dec.paged_decode_attention(rows, pool_k, pool_v, fr8, table,
                                                            rows_per_seq=8)], [])
torch.cuda.synchronize()
torch.save({name: ([t.cpu() for t in ex], [t.cpu() for t in bw])
            for name, (ex, bw) in outs.items()}, sys.argv[1])
"""
BWD_TOL = 2e-2  # check_flash_bwd's: of the largest gradient
DEC_TOL = 1e-2  # check_decode's: the decode kernels were redesigned, their sums run in another order
FWD_TOL_OUT, FWD_TOL_LSE = 2e-2, 1e-3  # check_flash's
# How far an unchanged kernel's time may read from the baseline's: the
# spread of identical code. Three runs of --baseline against an identical
# copy of the checkout (one call on an H100 80GB HBM3, 700.00 W) read these
# worst ratios of the checkout's mean time to the copy's over every row of a
# kind: forward 1.0054 / 1.0036 / 1.0015, decode 1.0096 / 1.0050 / 1.0163
# (the int8-cache B=4 row), matvec, LayerNorm backward and norm forwards
# 1.0009 / 1.0072 / 1.0068; backward 1.0157 / 1.0238 / 1.0081. So every
# forward, decode, matvec, LayerNorm backward and norm forward time may read
# up to the worst of the first three kinds, and a backward time up to
# BWD_TIME_SLACK, which covers both its 1.0238 and the 4.7 % an earlier pair
# of runs read apart.
BWD_TIME_SLACK = 1.05
FWD_DEC_TIME_SLACK = 1.0163
# The redesigned kernels' outputs against the baseline's: the matvec within
# two bf16 ulps of the largest value (check_quantized_matvec's), the LayerNorm
# backward within check_layernorm_bwd's tolerances
LN_DX_ATOL, LN_DX_RTOL, LN_RED_REL = 1e-3, 1.6e-2, 1e-5
# The norm forwards' (redesigned: a team of warps a row) against the baseline's:
# check_rmsnorm's and check_layernorm's two bf16 ulps
NORM_ATOL, NORM_RTOL = 1e-3, 1.6e-2
# The RMSNorm backward and the bias gradient (redesigned: their sums run in
# another order) against the baseline's: check_rmsnorm_bwd's dx tolerance
# (the LayerNorm backward's, LN_DX_*) and dscale within LN_RED_REL of its
# largest value; check_bias_grad's 1e-2 of the largest dbias
BIAS_GRAD_TOL = 1e-2
# The rows of the kernels this tree redesigned last: where the baseline's
# time reads over twice the row's bound, this tree's must be faster; every
# other row (kernels the baseline already had in this form) is held to
# FWD_DEC_TIME_SLACK, the spread of identical code
FASTER_ROWS = ("rmsnorm_bwd", "flash_attention_bias_grad")

# The matvec, norm forward and backward and bias-gradient outputs at the
# PERF.md section 6 shapes (the forwards also at the decode steps' rows) and
# other forms (M = 5 and 16, Bq = D; the RMSNorm backward at ragged rows and
# its widest D; the bias gradient at head dim 128 with ALiBi slopes and with
# a bf16 bias), run in each checkout by ``--baseline``: saves
# {form: [outputs]}.
KERNEL_FORMS_SCRIPT = r"""
import sys
import torch
from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
from deepspeed_tpu_torch.ops.cuda import layernorm as ln
from deepspeed_tpu_torch.ops.cuda import quantized_matmul as qmm
from deepspeed_tpu_torch.ops.cuda import rmsnorm as rn
from deepspeed_tpu_torch.ops.quantizer import pack_quantize_blockwise

g = torch.Generator(device="cuda").manual_seed(17)
bf = torch.bfloat16
outs = {}
for bits in (8, 4):
    for name, D, N, E, M in (("wi/wg", 4096, 14336, 1, 1), ("wk/wv", 4096, 1024, 1, 1),
                             ("wo", 14336, 4096, 1, 5), ("Bq=D", 1600, 6400, 1, 16),
                             ("expert wi/wg", 4096, 14336, 8, 4),
                             ("expert wo", 14336, 4096, 8, 4)):
        lead = (E,) if E > 1 else ()
        w = (0.02 * torch.randn(*lead, D, N, generator=g, device="cuda")).to(bf)
        pw = pack_quantize_blockwise(w, bits=bits)
        del w
        x = torch.randn(*lead, M, D, generator=g, device="cuda", dtype=bf)
        fn = qmm.packed_expert_matvec if E > 1 else qmm.packed_matvec
        outs[f"matvec int{bits} {name} M={M}"] = [fn(x, pw)]
        del pw
x = torch.randn(8192, 1024, generator=g, device="cuda", dtype=bf)
w = (1 + 0.1 * torch.randn(1024, generator=g, device="cuda")).to(bf)
gg = torch.randn(8192, 1024, generator=g, device="cuda", dtype=bf)
outs["layernorm_bwd rows=8192 D=1024"] = list(ln.layernorm_bwd(x, w, gg, 1e-5))
for kind, shapes in (("rmsnorm_fwd", ((2048, 4096), (512, 4096), (8192, 2048), (1, 4096),
                                      (4, 4096))),
                     ("layernorm_fwd", ((2048, 4096), (2048, 1600), (8192, 1024), (4, 4096),
                                        (4, 1600)))):
    for rows, D in shapes:
        x = torch.randn(rows, D, generator=g, device="cuda", dtype=bf)
        w = (1 + 0.1 * torch.randn(D, generator=g, device="cuda")).to(bf)
        b = (0.1 * torch.randn(D, generator=g, device="cuda")).to(bf)
        outs[f"{kind} rows={rows} D={D}"] = [
            rn.rmsnorm_fwd(x, w, 1e-5) if kind == "rmsnorm_fwd" else ln.layernorm_fwd(x, w, b, 1e-5)]
for rows, D in ((8192, 2048), (37, 2048), (3, 16384)):
    x = torch.randn(rows, D, generator=g, device="cuda", dtype=bf)
    w = (1 + 0.1 * torch.randn(D, generator=g, device="cuda")).to(bf)
    gg = torch.randn(rows, D, generator=g, device="cuda", dtype=bf)
    outs[f"rmsnorm_bwd rows={rows} D={D}"] = list(rn.rmsnorm_bwd(x, w, gg, 1e-5))
for B, S, H, KV, D, shape, dt, causal, alibi in (
        (4, 2048, 16, 16, 64, (1, 16), torch.float32, True, False),
        (2, 320, 8, 2, 128, (1, 8), torch.float32, True, True),
        (4, 512, 16, 16, 64, (1, 16), bf, True, False)):
    q, k, v, do = (torch.randn(B, S, h, D, generator=g, device="cuda", dtype=bf)
                   for h in (H, KV, KV, H))
    bias = (0.3 * torch.randn(*shape, S, S, generator=g, device="cuda")).to(dt)
    sl = torch.tensor([2.0 ** (-8 * (i + 1) / H) for i in range(H)], device="cuda") if alibi else None
    o, lse = fa.flash_attention_fwd(q, k, v, causal, sl, bias=bias)
    _, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, causal, sl, bias=bias)
    outs[f"flash_attention_bias_grad bias {list(bias.shape)} {dt} B={B} D={D} ALiBi={alibi}"] = [
        fa.flash_attention_bias_grad(q, k, v, bias, lse, delta, do, causal, sl)]
    del q, k, v, do, bias, o, lse, delta
torch.cuda.synchronize()
torch.save({name: [t.cpu() for t in ts] for name, ts in outs.items()}, sys.argv[1])
"""

# What the timing scripts share: the timer (median of 20 single launches, L2
# flushed and the card kept busy before each, as Timer), a wrapper's host
# time a call (as host_us) and training_packed's
# segments and positions and
# training_sparse's layout at B=4 S=2048, made from the paths' seeds.
TIMES_PRELUDE = r"""
import json
import statistics
import sys
import time
import numpy as np
import torch
from deepspeed_tpu_torch.config import SparseAttentionConfig
from deepspeed_tpu_torch.models.transformer import alibi_position_bias, alibi_slopes
from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
from deepspeed_tpu_torch.ops.sparse_attention import from_ds_config, sparse_layout

g = torch.Generator(device="cuda").manual_seed(13)
flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")


def r(*shape):
    return torch.randn(*shape, generator=g, device="cuda", dtype=torch.bfloat16)


def timer(fn, iters=20):
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)  # chip_smoke.TIMER_SPIN_CYCLES: the host's work stays out
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def host_us(fn, calls=300):  # as chip_smoke.host_us
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    per_call = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return per_call


B, S = 4, 2048
rng = np.random.RandomState(6)  # packed documents of 128-1536 tokens
seg, pos = np.zeros((B, S), np.int64), np.zeros((B, S), np.int64)
for row in range(B):
    at, doc = 0, 0
    while at < S:
        n = min(int(rng.randint(128, 1537)), S - at)
        seg[row, at:at + n], pos[row, at:at + n] = doc, np.arange(n)
        at, doc = at + n, doc + 1
seg = torch.from_numpy(seg).int().cuda()
pos = torch.from_numpy(pos).cuda()
fixed = sparse_layout(from_ds_config(SparseAttentionConfig(
    mode="fixed", block=128, num_local_blocks=4, num_global_blocks=1)), S, True)
"""

# The backward kernels timed at the shape of each PERF.md section 6 backward
# row, on inputs made from one seed, run by ``--baseline`` and
# ``--bwd-baseline`` in each checkout: prints one JSON object {form: [dq ms,
# dk/dv ms]}.
BWD_TIMES_SCRIPT = TIMES_PRELUDE + r"""
forms = {
    "training": (B, S, 32, 8, 64, {}),
    "training_bloom (ALiBi)": (B, S, 16, 16, 64, {"slopes": alibi_slopes(16).cuda()}),
    "training_packed (segment ids)": (B, S, 32, 8, 64, {"segment_ids": seg}),
    "training_bloom_packed (bias + segment ids)": (
        B, S, 16, 16, 64, {"segment_ids": seg,
                           "bias": alibi_position_bias(pos, alibi_slopes(16).cuda())}),
    "training_sparse (block-sparse)": (B, S, 32, 8, 64, {"layout": fixed}),
    "training_sp ring past hop (offsets)": (1, 8192, 32, 8, 64, {"offsets": (8192, 0)}),
    "training_sp Ulysses": (1, 16384, 16, 4, 64, {}),
    "training_mixtral (head dim 128)": (B, S, 32, 8, 128, {}),
}
times = {}
for name, (b, s, h, kv, d, kw) in forms.items():
    q, k, v, do = r(b, s, h, d), r(b, s, kv, d), r(b, s, kv, d), r(b, s, h, d)
    o, lse = fa.flash_attention_fwd(q, k, v, True, **kw)
    _, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, True, **kw)
    times[name] = [timer(lambda: fa.flash_attention_bwd_dq(q, k, v, o, lse, do, True, **kw)),
                   timer(lambda: fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, True,
                                                            **kw))]
    del q, k, v, do, o, lse, delta
    torch.cuda.empty_cache()
print(json.dumps(times))
"""

# The decode kernels timed at the shape of each PERF.md section 6 decode row,
# likewise, with each wrapper's host time a call (as host_us), and the kernels
# each wrapper call launches (frontiers as int64, as the decode path passes
# them, and int32): prints one JSON object {"times": {row: ms}, "host_us":
# {row: us}, "launches": {call: kernels}}.
DEC_TIMES_SCRIPT = TIMES_PRELUDE + r"""
from torch.profiler import ProfilerActivity, profile
from deepspeed_tpu_torch.ops.cuda import decode_attention as dec

bf = torch.bfloat16


def i8(*shape):
    return torch.randint(-127, 128, shape, generator=g, device="cuda").to(torch.int8)


def scale(*shape):
    return torch.rand(*shape, generator=g, device="cuda") / 50 + 1e-3


fr4 = torch.tensor([0, 37, 511, 1023], dtype=torch.int32, device="cuda")
q4 = r(4, 1, 32, 128)
kc, vc = r(2, 4, 1024, 8, 128)[1], r(2, 4, 1024, 8, 128)[1]  # a layer of a 2-layer cache
k8, v8 = i8(4, 1024, 8, 128), i8(4, 1024, 8, 128)
ks8, vs8 = scale(4, 8, 1024), scale(4, 8, 1024)
kb, vb = r(4, 1024, 32, 128), r(4, 1024, 32, 128)
qb = r(4, 1, 32, 128)
slopes = alibi_slopes(32).cuda()
kg, vg = r(4, 1024, 25, 64), r(4, 1024, 25, 64)
qg = r(4, 1, 25, 64)
# the continuous-batching step: 8 slots x 64 rows, pages of 16, a 64-row chunk
# at 448, six decode rows, an idle slot; the contiguous arena a layer of
# [2, 8, 1152, KV, hd]
N, R, mp, ps = 8, 64, 68, 16
fr = torch.full((N, R), -1, dtype=torch.int32)
fr[0] = 448 + torch.arange(R, dtype=torch.int32)
fr[1:7, 0] = torch.tensor([0, 17, 100, 333, 640, 1023], dtype=torch.int32)
perm = torch.randperm(N * mp, generator=torch.Generator().manual_seed(5)).int()
table = torch.full((N, mp), N * mp, dtype=torch.int32)
for n in range(N):
    used = -(-(int(fr[n].max()) + 1) // ps)
    table[n, :used] = perm[n * mp:n * mp + used]
table, fr = table.cuda(), fr.reshape(-1).cuda()
qcb = r(N * R, 1, 32, 128)
pk, pv = r(N * mp + 1, ps, 8, 128), r(N * mp + 1, ps, 8, 128)
pk8, pv8 = i8(N * mp + 1, ps, 8, 128), i8(N * mp + 1, ps, 8, 128)
pks, pvs = scale(N * mp + 1, 8, ps), scale(N * mp + 1, 8, ps)
arena = torch.zeros(2, 2, N, 1152, 8, 128, dtype=bf, device="cuda")
arena8 = torch.zeros(2, 2, N, 1152, 8, 128, dtype=torch.int8, device="cuda")
arena_s = torch.zeros(2, 2, N, 8, 1152, device="cuda")
for c, pool in enumerate((pk, pv)):
    arena[c, 1, :, :mp * ps] = dec.gather_pages(pool, table)
for c, (pool, sc) in enumerate(((pk8, pks), (pv8, pvs))):
    arena8[c, 1, :, :mp * ps] = dec.gather_pages(pool, table)
    arena_s[c, 1, :, :, :mp * ps] = dec.gather_page_scales(sc, table)
rows = {
    "dense B=4 Smax=1024 H=32 KV=8 D=128": lambda: dec.decode_attention(q4, kc, vc, fr4),
    "dense rows_per_seq (N=8 R=64, serving_cb step)": lambda: dec.decode_attention(
        qcb, arena[0, 1], arena[1, 1], fr, rows_per_seq=R),
    "int8 rows_per_seq": lambda: dec.decode_attention(
        qcb, arena8[0, 1], arena8[1, 1], fr, arena_s[0, 1], arena_s[1, 1], rows_per_seq=R),
    "ALiBi (bloom-7b1, H=KV=32)": lambda: dec.decode_attention(qb, kb, vb, fr4, slopes=slopes),
    "GPT-2 (H=KV=25, D=64)": lambda: dec.decode_attention(qg, kg, vg, fr4),
    "int8 cache B=4": lambda: dec.decode_attention(q4, k8, v8, fr4, ks8, vs8),
    "paged bf16 (serving_cb step)": lambda: dec.paged_decode_attention(
        qcb, pk, pv, fr, table, rows_per_seq=R),
    "paged int8": lambda: dec.paged_decode_attention(
        qcb, pk8, pv8, fr, table, pks, pvs, rows_per_seq=R),
}
times = {name: timer(fn) for name, fn in rows.items()}



hosts = {name: host_us(fn) for name, fn in rows.items()}
fr4_long = fr4.long()
calls = {
    "decode_attention, int64 frontiers": lambda: dec.decode_attention(q4, kc, vc, fr4_long),
    "decode_attention, int32 frontiers": lambda: dec.decode_attention(q4, kc, vc, fr4),
    "paged_decode_attention, int32 frontiers": lambda: dec.paged_decode_attention(
        qcb, pk, pv, fr, table, rows_per_seq=R),
}
launches = {}
for name, fn in calls.items():
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    launches[name] = sum(e.count for e in prof.key_averages()
                         if e.device_type == torch.autograd.DeviceType.CUDA)
print(json.dumps({"times": times, "host_us": hosts, "launches": launches}))
"""

# The forward kernel timed at the shape of each PERF.md section 6 forward row,
# likewise: prints one JSON object {form: ms}.
FWD_TIMES_SCRIPT = TIMES_PRELUDE + r"""
forms = {
    "serving (D=128)": (4, 512, 32, 8, 128, {}),
    "training": (B, S, 32, 8, 64, {}),
    "serving_gpt2": (4, 512, 25, 25, 64, {}),
    "serving_bloom (ALiBi, D=128)": (4, 512, 32, 32, 128, {"slopes": alibi_slopes(32).cuda()}),
    "training_bloom (ALiBi)": (B, S, 16, 16, 64, {"slopes": alibi_slopes(16).cuda()}),
    "training_packed (segment ids)": (B, S, 32, 8, 64, {"segment_ids": seg}),
    "training_bloom_packed (bias + segment ids)": (
        B, S, 16, 16, 64, {"segment_ids": seg,
                           "bias": alibi_position_bias(pos, alibi_slopes(16).cuda())}),
    "training_sparse (block-sparse)": (B, S, 32, 8, 64, {"layout": fixed}),
    "training_sp ring past hop (offsets)": (1, 8192, 32, 8, 64, {"offsets": (8192, 0)}),
    "training_sp Ulysses": (1, 16384, 16, 4, 64, {}),
}
times = {}
for name, (b, s, h, kv, d, kw) in forms.items():
    q, k, v = r(b, s, h, d), r(b, s, kv, d), r(b, s, kv, d)
    times[name] = timer(lambda: fa.flash_attention_fwd(q, k, v, True, **kw))
    del q, k, v
    torch.cuda.empty_cache()
print(json.dumps(times))
"""


# The matvec, the LayerNorm and RMSNorm backwards, the bias gradient and the
# norm forwards timed at every PERF.md section 6 row of theirs (and wk/wv,
# the narrowest leaf; the forwards also at the decode steps' rows), likewise,
# with each wrapper's host time a call and the byte bound of each norm row
# and of the bias gradient: prints one JSON object {"times": {row: ms},
# "host_us": {row: us}, "bounds": {row: ms}}.
KERNEL_TIMES_SCRIPT = TIMES_PRELUDE + r"""
from deepspeed_tpu_torch.ops.cuda import layernorm as ln
from deepspeed_tpu_torch.ops.cuda import quantized_matmul as qmm
from deepspeed_tpu_torch.ops.cuda import rmsnorm as rn
from deepspeed_tpu_torch.ops.quantizer import pack_quantize_blockwise



rows = {}
for bits in (8, 4):
    for name, D, N, E, M in (("wi/wg M=1", 4096, 14336, 1, 1), ("wk/wv M=1", 4096, 1024, 1, 1),
                             ("expert wi/wg E=8 C=4", 4096, 14336, 8, 4),
                             ("expert wo E=8 C=4", 14336, 4096, 8, 4)):
        if bits == 4 and name.startswith("wk"):
            continue
        lead = (E,) if E > 1 else ()
        w = (0.02 * torch.randn(*lead, D, N, generator=g, device="cuda")).to(torch.bfloat16)
        pw = pack_quantize_blockwise(w, bits=bits)
        del w
        x = r(*lead, M, D)
        fn = qmm.packed_expert_matvec if E > 1 else qmm.packed_matvec
        rows[f"matvec int{bits} {name}"] = (lambda fn=fn, x=x, pw=pw: fn(x, pw))
        if bits == 8 and name.startswith("expert wi"):
            xs = x.clone()  # only experts 0 and 5 routed, as chip_smoke.routed_pair
            for e in (1, 2, 3, 4, 6, 7):
                xs[e] = -0.0 if e % 2 else 0.0
            rows["matvec int8 expert wi/wg E=8 C=4, 2 of 8 routed"] = (
                lambda xs=xs, pw=pw: qmm.packed_expert_matvec(xs, pw))
x, gg = r(8192, 1024), r(8192, 1024)
w = (1 + 0.1 * torch.randn(1024, generator=g, device="cuda")).to(torch.bfloat16)
rows["layernorm_bwd rows=8192 D=1024"] = lambda: ln.layernorm_bwd(x, w, gg, 1e-5)
bounds = {}  # bytes: x read, out written, the weights read (bf16), over 3.35 TB/s
for kind, shapes, weights in (
        ("rmsnorm_fwd", ((2048, 4096), (512, 4096), (8192, 2048), (1, 4096), (4, 4096)), 1),
        ("layernorm_fwd", ((2048, 4096), (2048, 1600), (8192, 1024), (4, 4096), (4, 1600)), 2)):
    for n, D in shapes:
        xn = r(n, D)
        wn = (1 + 0.1 * torch.randn(D, generator=g, device="cuda")).to(torch.bfloat16)
        bn = (0.1 * torch.randn(D, generator=g, device="cuda")).to(torch.bfloat16)
        name = f"{kind} rows={n} D={D}"
        rows[name] = ((lambda xn=xn, wn=wn: rn.rmsnorm_fwd(xn, wn, 1e-5)) if weights == 1 else
                      (lambda xn=xn, wn=wn, bn=bn: ln.layernorm_fwd(xn, wn, bn, 1e-5)))
        bounds[name] = (2 * 2 * n * D + weights * 2 * D) / 3.35e12 * 1e3
xb, gb = r(8192, 2048), r(8192, 2048)
wb = (1 + 0.1 * torch.randn(2048, generator=g, device="cuda")).to(torch.bfloat16)
name = "rmsnorm_bwd rows=8192 D=2048"
rows[name] = lambda: rn.rmsnorm_bwd(xb, wb, gb, 1e-5)
bounds[name] = (3 * 2 * 8192 * 2048 + 2 * 2048 + 4 * 2048) / 3.35e12 * 1e3
qa, ka, va, doa = r(B, S, 16, 64), r(B, S, 16, 64), r(B, S, 16, 64), r(B, S, 16, 64)
bias_a = 0.3 * torch.randn(1, 16, S, S, generator=g, device="cuda")
oa, lse_a = fa.flash_attention_fwd(qa, ka, va, True, bias=bias_a)
_, delta_a = fa.flash_attention_bwd_dq(qa, ka, va, oa, lse_a, doa, True, bias=bias_a)
name = "flash_attention_bias_grad bias [1, 16, 2048, 2048] fp32 B=4 D=64 causal"
rows[name] = lambda: fa.flash_attention_bias_grad(qa, ka, va, bias_a, lse_a, delta_a, doa)
# bytes: the four [B, S, H, D] bf16 tensors, lse and delta, the visible half of
# dbias written and the bias read whole (chip_smoke.check_bias_grad's count)
bounds[name] = (2 * 4 * qa.numel() + 2 * 4 * B * 16 * S + 4 * 16 * S * (S + 1) / 2
                + 4 * bias_a.numel()) / 3.35e12 * 1e3
times = {name: timer(fn) for name, fn in rows.items()}
hosts = {name: host_us(fn) for name, fn in rows.items()}
print(json.dumps({"times": times, "host_us": hosts, "bounds": bounds}))
"""


# The decode steps the matvec serves, run by ``--baseline`` once in each
# checkout: Llama-3-8B and Mixtral-8x7B at full depth with int8 weights and
# the int8 KV cache, B=1, 8 single-token forwards after a 128-token prefill
# (chip_smoke.decode_steps): per step the wall ms without the profiler, the
# device ms of every kernel and of the matvec's, and the kernels launched.
# Prints one JSON object {engine: {...}}.
SERVING_STEPS_SCRIPT = r"""
import gc
import json
import time
import torch
from torch.profiler import ProfilerActivity, profile
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.models import llama, mixtral
from deepspeed_tpu_torch.models.decoding import forward_with_cache, init_cache

STEPS = 8
out = {}
for name, model in (("llama3-8b", llama("llama3-8b")), ("mixtral-8x7b", mixtral("mixtral-8x7b"))):
    eng = init_inference(model, dtype="int8", kv_cache_dtype="int8",
                         replace_with_kernel_inject=True, max_tokens=1024,
                         rng=torch.Generator(device="cuda").manual_seed(0))
    cfg = eng.config
    ids = torch.randint(0, cfg.vocab_size, (1, 128 + STEPS),
                        generator=torch.Generator().manual_seed(9)).cuda()
    cache = init_cache(cfg, 1, 256, torch.bfloat16, "cuda", quantized=eng.kv_cache_quantized)

    def run():
        with eng._impl_ctx(), torch.inference_mode():
            for i in range(STEPS):
                forward_with_cache(cfg, eng.params, ids[:, 128 + i:129 + i], cache, 128 + i)

    with eng._impl_ctx(), torch.inference_mode():
        forward_with_cache(cfg, eng.params, ids[:, :128], cache, 0)
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]

    def us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    out[name] = {"wall_ms": wall / STEPS, "device_ms": sum(us(e) for e in dev) / 1e3 / STEPS,
                 "matvec_ms": sum(us(e) for e in dev if "quantized_matvec" in e.key) / 1e3 / STEPS,
                 "launches": sum(e.count for e in dev) / STEPS}
    del eng, cache
    gc.collect()
    torch.cuda.empty_cache()
print(json.dumps(out))
"""


def run_in(tree: Path, script: str, *args: str) -> subprocess.CompletedProcess:
    """Run ``script`` against the package of checkout ``tree`` (its own build)."""
    env = {**os.environ, "PYTHONPATH": str(tree)}
    return subprocess.run([sys.executable, "-c", script, *args], cwd=tree, env=env,
                          check=True, timeout=900, capture_output=True, text=True)


def compare_to_baseline(baseline: str) -> None:
    """This checkout's attention kernels against ``baseline``'s (a checkout
    of an earlier commit, built in its own tree), on the same seeded inputs:
    the decode kernels within DEC_TOL, the flash forward's out and lse within
    check_flash's tolerances and the flash backward's dq, dk and dv within
    BWD_TOL of the largest gradient (all three were redesigned: their sums
    run in another order). Then both checkouts' forward kernel at every
    PERF.md section 6 forward shape, backward kernels at every backward shape
    and decode kernels at every decode shape, timed in turns on this card
    (baseline, this, this, baseline): each forward and decode time of this
    checkout's must be at most FWD_DEC_TIME_SLACK times the baseline's (the
    spread of identical code), each backward at most BWD_TIME_SLACK times.
    The packed matvec and the LayerNorm backward (redesigned: the matvec
    folds (x·q)·s on the tensor cores) are held to the baseline's outputs
    within two bf16 ulps of the largest value and check_layernorm_bwd's
    tolerances, the RMSNorm and LayerNorm forwards (redesigned: a team of
    warps a row) within two bf16 ulps (check_rmsnorm's), the RMSNorm backward
    (redesigned: a team of warps a row) within check_rmsnorm_bwd's
    tolerances and the bias gradient (redesigned: wgmma, output tile
    stationary) within BIAS_GRAD_TOL of its largest value, and each of their
    PERF.md section 6 rows (and wk/wv, and the forwards' decode rows)
    is timed in the same turns: a row of FASTER_ROWS whose baseline reads
    over twice its bound must be faster than the baseline's, every other
    row within FWD_DEC_TIME_SLACK. Last, the worst ratio of this checkout's time to the
    baseline's over each kind's rows is printed: against an identical copy,
    the spread the slacks are set from."""
    trees = {"this checkout": Path(__file__).resolve().parent,
             "baseline": Path(baseline).resolve()}
    results, kernel_outs = {}, {}
    for label, tree in trees.items():
        out = tree / "build" / "llama_forms.pt"
        out.parent.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        run_in(tree, LLAMA_FORMS_SCRIPT, str(out))
        print(f"Llama forms in {label} ({tree}): build and run "
              f"{time.perf_counter() - t0:.1f} s")
        results[label] = torch.load(out)
        out = tree / "build" / "kernel_forms.pt"
        run_in(tree, KERNEL_FORMS_SCRIPT, str(out))
        kernel_outs[label] = torch.load(out)
    mine, base = kernel_outs["this checkout"], kernel_outs["baseline"]
    require(set(mine) == set(base), "the two checkouts ran other matvec / norm / bias-gradient "
            "forms")
    for name in mine:
        if name.startswith("flash_attention_bias_grad"):
            (a,), (b,) = mine[name], base[name]
            e, m = max_err(a, b), b.float().abs().max().item()
            print(f"{name}: max_abs_err against the baseline {e:.3e} (tol {BIAS_GRAD_TOL}*"
                  f"{m:.3e})")
            require(e <= BIAS_GRAD_TOL * m, f"{name} moved beyond tolerance")
            continue
        if name.startswith("rmsnorm_bwd"):
            (dx, ds), (bdx, bds) = mine[name], base[name]
            ok_dx = bool(((dx.float() - bdx.float()).abs()
                          <= LN_DX_ATOL + LN_DX_RTOL * bdx.float().abs()).all())
            e_ds, t_ds = max_err(ds, bds), LN_RED_REL * bds.abs().max().item()
            print(f"{name}: dx max_abs_err against the baseline {max_err(dx, bdx):.3e} (tol "
                  f"{LN_DX_ATOL} + {LN_DX_RTOL}*|baseline|: {ok_dx}); dscale {e_ds:.3e} (tol "
                  f"{t_ds:.3e})")
            require(ok_dx and e_ds <= t_ds, f"{name} moved beyond tolerance")
            continue
        if name.startswith("matvec"):
            (a,), (b,) = mine[name], base[name]
            e, tol = max_err(a, b), 2 * bf16_ulp(b.float().abs().max().item())
            print(f"{name}: max_abs_err against the baseline {e:.3e} (tol {tol:.3e}, "
                  "2 bf16 ulps of its largest value)")
            require(e <= tol, f"{name} moved beyond tolerance")
            continue
        if name.startswith(("rmsnorm_fwd", "layernorm_fwd")):
            (a,), (b,) = mine[name], base[name]
            ok = bool(((a.float() - b.float()).abs()
                       <= NORM_ATOL + NORM_RTOL * b.float().abs()).all())
            print(f"{name}: max_abs_err against the baseline {max_err(a, b):.3e} (tol "
                  f"{NORM_ATOL} + {NORM_RTOL}*|baseline|: {ok})")
            require(ok, f"{name} moved beyond tolerance")
            continue
        (dx, ds, db), (bdx, bds, bdb) = mine[name], base[name]
        ok_dx = bool(((dx.float() - bdx.float()).abs()
                      <= LN_DX_ATOL + LN_DX_RTOL * bdx.float().abs()).all())
        errs = [(n, max_err(a, b), LN_RED_REL * b.abs().max().item())
                for n, a, b in (("dscale", ds, bds), ("dbias", db, bdb))]
        print(f"{name}: dx max_abs_err against the baseline {max_err(dx, bdx):.3e} (tol "
              f"{LN_DX_ATOL} + {LN_DX_RTOL}*|baseline|: {ok_dx}); "
              + "; ".join(f"{n} {e:.3e} (tol {t:.3e})" for n, e, t in errs))
        require(ok_dx and all(e <= t for _, e, t in errs), f"{name} moved beyond tolerance")
    mine, base = results["this checkout"], results["baseline"]
    require(set(mine) == set(base), "the two checkouts ran other forms")
    for name in mine:
        (ex, bw), (bex, bbw) = mine[name], base[name]
        if name.startswith("flash"):
            for n, a, b, tol in zip(("out", "lse"), ex, bex, (FWD_TOL_OUT, FWD_TOL_LSE)):
                e = max_err(a, b)
                print(f"{name}: forward {n} max_abs_err against the baseline {e:.3e} "
                      f"(tol {tol})")
                require(e <= tol, f"{name}: forward {n} moved beyond tolerance")
        else:
            for i, (a, b) in enumerate(zip(ex, bex)):
                e = max_err(a, b)
                print(f"{name} [{i}]: decode max_abs_err against the baseline {e:.3e} "
                      f"(tol {DEC_TOL})")
                require(e <= DEC_TOL, f"{name}: decode moved beyond tolerance")
        for n, a, b in zip(("dq", "dk", "dv"), bw, bbw):
            e, m = max_err(a, b), b.float().abs().max().item()
            print(f"{name}: {n} max_abs_err against the baseline {e:.3e} "
                  f"(tol {BWD_TOL}*{m:.3e})")
            require(e <= BWD_TOL * m, f"{name}: {n} moved beyond tolerance")
    runs = {(kind, label): [] for kind in ("fwd", "bwd", "dec", "kernels") for label in trees}
    for label in ("baseline", "this checkout", "this checkout", "baseline"):
        for kind, script in (("fwd", FWD_TIMES_SCRIPT), ("bwd", BWD_TIMES_SCRIPT),
                             ("dec", DEC_TIMES_SCRIPT), ("kernels", KERNEL_TIMES_SCRIPT)):
            proc = run_in(trees[label], script)
            runs[(kind, label)].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    slower = []  # every turn is printed before any failure is raised
    print(f"forward kernel, ms (median of 20 launches, L2 flushed; each checkout "
          f"twice, in turns; {smi}; held to {FWD_DEC_TIME_SLACK}x the baseline's):")
    for form in runs[("fwd", "baseline")][0]:
        new, old = ([run[form] for run in runs[("fwd", label)]]
                    for label in ("this checkout", "baseline"))
        print(f"  {form}: {statistics.mean(new):.4f} (baseline {statistics.mean(old):.4f}, "
              f"{statistics.mean(old) / statistics.mean(new):.2f}x; runs {old} / {new})")
        if statistics.mean(new) > FWD_DEC_TIME_SLACK * statistics.mean(old):
            slower.append(f"{form}: the forward kernel is slower than {FWD_DEC_TIME_SLACK}x "
                          "the baseline's")
    print(f"backward kernels, ms (median of 20 launches, L2 flushed; each checkout "
          f"twice, in turns; {smi}; held to {BWD_TIME_SLACK}x the baseline's):")
    for form in runs[("bwd", "baseline")][0]:
        new, old = ([statistics.mean(run[form][i] for run in runs[("bwd", label)])
                     for i in (0, 1)] for label in ("this checkout", "baseline"))
        print(f"  {form}: dq {new[0]:.4f} (baseline {old[0]:.4f}, runs "
              f"{[run[form][0] for run in runs[('bwd', 'baseline')]]} / "
              f"{[run[form][0] for run in runs[('bwd', 'this checkout')]]}), dk/dv "
              f"{new[1]:.4f} (baseline {old[1]:.4f}, runs "
              f"{[run[form][1] for run in runs[('bwd', 'baseline')]]} / "
              f"{[run[form][1] for run in runs[('bwd', 'this checkout')]]})")
        if new[0] > BWD_TIME_SLACK * old[0] or new[1] > BWD_TIME_SLACK * old[1]:
            slower.append(f"{form}: a backward kernel is slower than {BWD_TIME_SLACK}x "
                          "the baseline's")
    print(f"decode kernels, ms (median of 20 launches, L2 flushed; each checkout "
          f"twice, in turns; {smi}; held to {FWD_DEC_TIME_SLACK}x the baseline's):")
    for form in runs[("dec", "baseline")][0]["times"]:
        new, old = ([run["times"][form] for run in runs[("dec", label)]]
                    for label in ("this checkout", "baseline"))
        host_new, host_old = (statistics.mean(run["host_us"][form] for run in runs[("dec", label)])
                              for label in ("this checkout", "baseline"))
        print(f"  {form}: {statistics.mean(new):.4f} (baseline {statistics.mean(old):.4f}, "
              f"{statistics.mean(old) / statistics.mean(new):.2f}x; runs {old} / {new}); "
              f"host {host_new:.1f} us a call (baseline {host_old:.1f})")
        if statistics.mean(new) > FWD_DEC_TIME_SLACK * statistics.mean(old):
            slower.append(f"{form}: the decode kernel is slower than {FWD_DEC_TIME_SLACK}x "
                          "the baseline's")
    for call, n in runs[("dec", "this checkout")][0]["launches"].items():
        print(f"  kernels a call, {call}: {n} (baseline "
              f"{runs[('dec', 'baseline')][0]['launches'][call]})")
    print(f"matvec, norm forwards and backwards and the bias gradient, ms (median of 20 "
          f"launches, L2 flushed; each checkout twice, in turns; {smi}; a row of "
          f"{', '.join(FASTER_ROWS)} whose baseline reads over twice its bound must be "
          f"faster than the baseline's, every other row within {FWD_DEC_TIME_SLACK}x):")
    bounds = runs[("kernels", "this checkout")][0]["bounds"]
    for form in runs[("kernels", "baseline")][0]["times"]:
        new, old = ([run["times"][form] for run in runs[("kernels", label)]]
                    for label in ("this checkout", "baseline"))
        host_new, host_old = (statistics.mean(run["host_us"][form]
                                              for run in runs[("kernels", label)])
                              for label in ("this checkout", "baseline"))
        faster = form.startswith(FASTER_ROWS) and statistics.mean(old) > 2 * bounds[form]
        print(f"  {form}: {statistics.mean(new):.4f} (baseline {statistics.mean(old):.4f}, "
              f"{statistics.mean(old) / statistics.mean(new):.2f}x; runs {old} / {new}); "
              f"host {host_new:.1f} us a call (baseline {host_old:.1f})"
              + (f"; bound {bounds[form]:.4f}, held to: "
                 f"{'faster' if faster else f'{FWD_DEC_TIME_SLACK}x'}" if form in bounds else ""))
        if faster and statistics.mean(new) >= statistics.mean(old):
            slower.append(f"{form}: no faster than the baseline's")
        elif statistics.mean(new) > FWD_DEC_TIME_SLACK * statistics.mean(old):
            slower.append(f"{form}: slower than {FWD_DEC_TIME_SLACK}x the baseline's")
    def series(kind: str, label: str) -> dict:
        """{row: [ms a turn]} of one kind in one checkout (dq and dk/dv apart)."""
        out = {}
        for run in runs[(kind, label)]:
            for form, v in (run["times"] if kind in ("dec", "kernels") else run).items():
                for part, t in (((" dq", v[0]), (" dk/dv", v[1])) if kind == "bwd"
                                else (("", v),)):
                    out.setdefault(form + part, []).append(t)
        return out

    worst = {}  # kind: (this checkout's mean / the baseline's, row)
    for kind in ("fwd", "bwd", "dec", "kernels"):
        new, old = series(kind, "this checkout"), series(kind, "baseline")
        worst[kind] = max((statistics.mean(new[f]) / statistics.mean(old[f]), f) for f in old)
    print("worst this checkout / baseline time: " + "; ".join(
        f"{kind} {r:.4f} ({row})" for kind, (r, row) in worst.items()))
    steps = {label: json.loads(run_in(trees[label], SERVING_STEPS_SCRIPT).stdout.strip()
                               .splitlines()[-1])
             for label in ("baseline", "this checkout")}
    print(f"int8 + int8-KV decode steps, B=1, per step (8 steps after a 128-token prefill; "
          f"baseline then this checkout, once each; {smi}):")
    for engine, new in steps["this checkout"].items():
        old = steps["baseline"][engine]
        print(f"  {engine}: wall {new['wall_ms']:.3f} ms (baseline {old['wall_ms']:.3f}); "
              f"device {new['device_ms']:.3f} ms (baseline {old['device_ms']:.3f}), of it the "
              f"matvec {new['matvec_ms']:.3f} ms (baseline {old['matvec_ms']:.3f}); "
              f"{new['launches']:.1f} launches (baseline {old['launches']:.1f})")
    require(not slower, "; ".join(slower))


def compare_bwd_to_baseline(baseline: str) -> None:
    """Both checkouts' flash backward kernels, dq and dk/dv, at every PERF.md
    section 6 backward shape (head dim 128 at training_mixtral's among them),
    timed in turns on this card (baseline, this, this, baseline); each of
    this checkout's times must be at most BWD_TIME_SLACK times the
    baseline's. Only calls every checkout since the offset form took
    (PR 8's on) are made, so an older checkout's backward can be timed
    beside this one's."""
    trees = {"this checkout": Path(__file__).resolve().parent,
             "baseline": Path(baseline).resolve()}
    runs = {label: [] for label in trees}
    for label in ("baseline", "this checkout", "this checkout", "baseline"):
        t0 = time.perf_counter()
        proc = run_in(trees[label], BWD_TIMES_SCRIPT)
        runs[label].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"backward times in {label} ({trees[label]}): {time.perf_counter() - t0:.1f} s "
              "with its build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"backward kernels, ms (median of 20 launches, L2 flushed; each checkout twice, "
          f"in turns; {smi}; held to {BWD_TIME_SLACK}x the baseline's):")
    slower = []
    for form in runs["baseline"][0]:
        new, old = ([statistics.mean(run[form][i] for run in runs[label]) for i in (0, 1)]
                    for label in ("this checkout", "baseline"))
        print(f"  {form}: dq {new[0]:.4f} (baseline {old[0]:.4f}, {old[0] / new[0]:.2f}x), "
              f"dk/dv {new[1]:.4f} (baseline {old[1]:.4f}, {old[1] / new[1]:.2f}x); runs "
              f"{[run[form] for run in runs['baseline']]} / "
              f"{[run[form] for run in runs['this checkout']]}")
        if new[0] > BWD_TIME_SLACK * old[0] or new[1] > BWD_TIME_SLACK * old[1]:
            slower.append(f"{form}: a backward kernel is slower than {BWD_TIME_SLACK}x the "
                          "baseline's")
    require(not slower, "; ".join(slower))


def _replace_once(old: str, new: str):
    def patch(text: str) -> str:
        require(text.count(old) == 1, f"decode variant: {old[:40]!r} does not match once")
        return text.replace(old, new)
    return patch


def _cut_merge(text: str) -> str:
    a = text.index("  cluster.sync();\n  if (tid < nq) {")
    b = text.index("  cluster.sync();  // no block leaves")
    return text[:a] + "  cluster.sync();\n" + text[b:]


# Copies of csrc/decode_attention.cu with one part cut out, for
# ``--decode-breakdown``: {name: patch of the source text, or None}. Cutting a
# part breaks the kernel's output; only the times are read.
DECODE_VARIANTS = {
    "as built": None,
    "no merge (partials left in place)": _cut_merge,
    "no tile arithmetic": _replace_once(
        "rows.update(kt, vt, t, a.scale, a.slopes != nullptr, lane);", ""),
    "no cache reads (tiles zero-filled)": _replace_once(
        "      const bool valid = pos < n_max;\n      const TC* ksrc",
        "      const bool valid = false;\n      const TC* ksrc"),
    "every row padded (the bare grid)": _replace_once("if (n_max == 0) {", "if (true) {"),
    "two blocks an SM": _replace_once("__launch_bounds__(kThreads, 3)",
                                      "__launch_bounds__(kThreads)"),
    "P as one bf16 term": _replace_once(
        "        dst::flash::mma_16816(o[2 * nd], lo, b[0], b[1]);\n"
        "        dst::flash::mma_16816(o[2 * nd + 1], lo, b[2], b[3]);\n", ""),
}


def variant_libraries(stem: str, variants: dict, entry: str, patched: str = "") -> dict:
    """{variant: ctypes library} of ``variants`` ({name: patch of the text of
    csrc/<patched> (default csrc/<stem>.cu), or None}), each built by nvcc
    from csrc/<stem>.cu (and csrc/<stem>_f16.cu, its fp16 entry, where there
    is one) beside its patched copy (a header is found there first) and
    status.cu into build/<stem>_variants/v<i>/, all compiles in flight at
    once; the entry points whose names hold ``entry`` get their argtypes."""
    import ctypes
    patched = patched or f"{stem}.cu"
    src = (_build.CSRC / patched).read_text()
    out = _build.BUILD_DIR.parent / f"{stem}_variants"
    procs = {}
    for i, (name, patch) in enumerate(variants.items()):
        vdir = out / f"v{i}"
        vdir.mkdir(parents=True, exist_ok=True)
        units = [f"{stem}.cu"] + [f"{stem}_f16.cu"] * (_build.CSRC / f"{stem}_f16.cu").exists()
        for unit in units:
            shutil.copy(_build.CSRC / unit, vdir / unit)
        (vdir / patched).write_text(src if patch is None else patch(src))
        procs[name] = (i, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared", "-o",
             str(vdir / "variant.so"), *(str(vdir / u) for u in units),
             str(_build.CSRC / "status.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (i, proc) in procs.items():
        log, _ = proc.communicate()
        require(proc.returncode == 0, f"{stem} variant {name} did not build:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(out / f"v{i}" / "variant.so"))
        for fn, argtypes in _build.SIGNATURES.items():
            if entry in fn:
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        lib.dst_error_string.argtypes = [ctypes.c_int]
        lib.dst_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def decode_variant_libraries() -> dict:
    """{variant: ctypes library} of ``DECODE_VARIANTS``."""
    return variant_libraries("decode_attention", DECODE_VARIANTS, "decode_attention")


# Copies of csrc/quantized_matvec.cu with one part changed, for
# ``--matvec-breakdown``: {name: patch of the source text, or None}. Cutting
# the arithmetic breaks the output; only the times are read.
MATVEC_VARIANTS = {
    "as built": None,
    "arithmetic cut out (the load path alone)": _replace_once(
        "    for (int T = 0; T < kTiles; ++T) {\n      const int wi = T >> 1;",
        "    acc[0][0][0][0] += __uint_as_float((w[0].x ^ w[0].y ^ w[0].z ^ w[0].w ^ w[1].x ^ "
        "w[1].y ^ w[1].z ^ w[1].w ^ w[2].x ^ w[2].y ^ w[2].z ^ w[2].w ^ w[3].x ^ w[3].y ^ "
        "w[3].z ^ w[3].w ^ xb[0][0][0]) & 0x0fffffffu);\n"
        "    for (int T = 0; T < 0; ++T) {\n      const int wi = T >> 1;"),
    "no expert-skip test": lambda text: _replace_once(
        "const bool any = __syncthreads_or(nonzero);",
        "__syncthreads();\n  const bool any = true;")(_replace_once(
            "for (int i = tid; i < M * kSub * chunks; i += kThreads) {",
            "for (int i = tid; i < 0; i += kThreads) {")(text)),
    "ring of 2 stages": _replace_once("constexpr int kRing = 3; ", "constexpr int kRing = 2; "),
    "ring of 4 stages": _replace_once("constexpr int kRing = 3; ", "constexpr int kRing = 4; "),
    "ring of 8 stages": _replace_once("constexpr int kRing = 3; ", "constexpr int kRing = 8; "),
    "TMA at every grid": _replace_once("const bool tma = (long long)", "const bool tma = true || (long long)"),
    "per-thread cp.async at every grid": _replace_once(
        "const bool tma = (long long)", "const bool tma = false && (long long)"),
}


# Copies of csrc/layernorm_bwd.cu with one part cut out, for
# ``--layernorm-breakdown``; only the times are read.
LAYERNORM_VARIANTS = {
    "as built": None,
    "row loads cut out (x, g as zeros)": _replace_once(
        "      if (vi < nvec) {\n        ax[i] = xr[vi];\n        ag[i] = gr[vi];\n      }",
        "      ax[i] = Pack<T>{};\n      ag[i] = Pack<T>{};\n      (void)xr;\n      (void)gr;"),
    "dx stores cut out": _replace_once(
        "      dxr[vi] = o;",
        "      if (o.v[0] == dst::from_float<T>(12345.f)) dxr[vi] = o;"),
    "merge pass cut out": _replace_once("  merge_partials_kernel<<<",
                                        "  if (D < 0) merge_partials_kernel<<<"),
}


def _chain(*patches):
    def patch(text: str) -> str:
        for p in patches:
            text = p(text)
        return text
    return patch


# Copies of csrc/norm_fwd.cuh (the RMSNorm and LayerNorm forwards' shared
# header) with one part changed, for ``--norm-breakdown``. Cutting a part
# breaks the output; only the times are read.
NORM_VARIANTS = {
    "as built": None,
    "stores cut out": _replace_once(
        "        orow[vi] = o;\n      }\n#pragma unroll",
        "        if (to_float(o.v[0]) != to_float(o.v[0])) orow[vi] = o;\n      }\n#pragma unroll"),
    "loads cut out (x from the row and lane)": _replace_once(
        "        if (vi < nvec) px[i] = xr[vi];",
        "        for (int j = 0; j < N; ++j) px[i].v[j] = from_float<T>(static_cast<float>("
        "row + vi + j));\n        (void)xr;"),
    "four vectors a lane (half the warps a row)": _chain(
        _replace_once("constexpr int kVecs = 2;", "constexpr int kVecs = 4;"),
        _replace_once("return nvec <= 64 ? 1 : nvec <= 128 ? 2 : nvec <= 256 ? 4 : nvec <= 512 ? 8",
                      "return nvec <= 128 ? 1 : nvec <= 256 ? 2 : nvec <= 512 ? 4 : nvec <= 1024 ? 8"),
        _replace_once("         : nvec <= 1024 ? 16 : 0;", "         : 0;")),
    "no next-row prefetch": _chain(
        _replace_once("      if (r + stride < rows) load(r + stride, nx);\n", ""),
        _replace_once("#pragma unroll\n      for (int i = 0; i < kVec; ++i) px[i] = nx[i];",
                      "      if (r + stride < rows) load(r + stride, px);")),
    "not persistent (every team's block launched)": _replace_once(
        "<<<want < resident ? want : resident,", "<<<want,"),
    "weights loaded a row (not held)": _replace_once(
        "        XV o;\n#pragma unroll\n        for (int j = 0; j < N; ++j) {\n"
        "          const float f = to_float(px[i].v[j]);",
        "        XV o;\n        wv[i] = wr[vi];\n        if constexpr (kLN) bv[i] = br[vi];\n"
        "#pragma unroll\n        for (int j = 0; j < N; ++j) {\n"
        "          const float f = to_float(px[i].v[j]);"),
    "empty kernel (the launch floor)": _replace_once(
        "  using P = Plan<kRowWarps, kVec>;\n  constexpr int N = 16 / sizeof(T);",
        "  if (rows > 0) return;\n  using P = Plan<kRowWarps, kVec>;\n"
        "  constexpr int N = 16 / sizeof(T);"),
}


# Copies of csrc/rmsnorm_bwd.cu with one part cut out or one choice changed,
# for ``--rmsnorm-bwd-breakdown``. Cutting a part breaks the output; only the
# times are read.
RMSNORM_BWD_VARIANTS = {
    "as built": None,
    "row loads cut out (x, g from the row and lane)": _replace_once(
        "      if (vi < nvec) {\n        ax[i] = xr[vi];\n        ag[i] = gr[vi];\n      }",
        "      for (int j = 0; j < N; ++j) {\n"
        "        ax[i].v[j] = dst::from_float<T>(static_cast<float>(row + vi + j));\n"
        "        ag[i].v[j] = dst::from_float<T>(static_cast<float>(row - vi - j));\n"
        "      }\n      (void)xr;\n      (void)gr;"),
    "dx stores cut out": _replace_once(
        "      dxr[vi] = o;", "      if (dst::to_float(o.v[0]) == 12345.f) dxr[vi] = o;"),
    "merge pass cut out": _replace_once("  merge_partials_kernel<<<",
                                        "  if (D < 0) merge_partials_kernel<<<"),
    "no next-row prefetch": _replace_once("constexpr int kRowsAhead = 1;",
                                          "constexpr int kRowsAhead = 0;"),
    "two rows ahead": _replace_once("constexpr int kRowsAhead = 1;",
                                    "constexpr int kRowsAhead = 2;"),
    "three blocks an SM (grid cap 396)": _replace_once("kThreads <= 256 ? 2 : 1",
                                                       "kThreads <= 256 ? 3 : 1"),
    "four blocks an SM, one vector a lane": _chain(
        _replace_once("kThreads <= 256 ? 2 : 1", "kThreads <= 256 ? 4 : 1"),
        _replace_once("constexpr int kLaneVecs = 2;", "constexpr int kLaneVecs = 1;")),
    "one vector a lane (twice the warps a row)": _replace_once(
        "constexpr int kLaneVecs = 2;", "constexpr int kLaneVecs = 1;"),
    "empty kernels (the launch floor)": _chain(
        _replace_once("  using P = Plan<kRowWarps, kVec>;\n  constexpr int N = 16 / sizeof(T);",
                      "  if (rows > 0) return;\n  using P = Plan<kRowWarps, kVec>;\n"
                      "  constexpr int N = 16 / sizeof(T);"),
        _replace_once("  __shared__ float lanes[kMergeLanes][kMergeCols];",
                      "  if (nblocks >= 0) return;\n"
                      "  __shared__ float lanes[kMergeLanes][kMergeCols];")),
}

# Copies of csrc/flash_attention_bias_grad.cu with one part cut out or the
# ring's depth changed, for ``--bias-grad-breakdown``; only the times are read.
_BG_PRODUCTS = _replace_once(
    "        wgmma_fence();\n"
    "        ss_product<HD, BN>(s, st, kRows, r_lo, st + 2 * L::kQ);          // S = Q K^T\n"
    "        wgmma_commit();\n"
    "        ss_product<HD, BN>(dp, st + L::kQ, kRows, r_lo, st + 2 * L::kQ + L::kKV);"
    "  // dP = dO V^T\n"
    "        wgmma_commit();\n",
    "        for (int e = 0; e < BN / 2; ++e) s[e] = dp[e] = static_cast<float>(e);\n")
_BG_EPILOGUE = _replace_once(
    "        if (cls == kFull) {\n          pass_p(std::false_type{});\n        } else {\n"
    "          pass_p(std::true_type{});\n        }\n",
    "        (void)pass_p;\n")
_BG_PAIR_LOADS = _replace_once(
    "            mbar_arrive_expect_tx(fb, pair_bytes);\n"
    "            tma_rows<HD, kRows>(st, &p.q, fb, row_base, h, b);\n"
    "            tma_rows<HD, kRows>(st + L::kQ, &p.dout, fb, row_base, h, b);\n"
    "            tma_rows<HD, BN>(st + 2 * L::kQ, &p.k, fb, k0, kvh, b);\n"
    "            tma_rows<HD, BN>(st + 2 * L::kQ + L::kKV, &p.v, fb, k0, kvh, b);\n",
    "            mbar_arrive(fb);\n            (void)st;\n            (void)kvh;\n"
    "            (void)pair_bytes;\n")
BIAS_GRAD_VARIANTS = {
    "as built": None,
    "products cut out (no wgmma)": _BG_PRODUCTS,
    "epilogue cut out (p not formed: acc += s (dp - delta))": _BG_EPILOGUE,
    "pair loads cut out (q, do, k, v not loaded)": _BG_PAIR_LOADS,
    "the walk alone (pair loads, products and epilogue cut out)": _chain(
        _BG_PAIR_LOADS, _BG_PRODUCTS, _BG_EPILOGUE),
    "bias tile load cut out": _chain(
        _replace_once("        mbar_arrive_expect_tx(fb, bias_bytes);\n",
                      "        mbar_arrive(fb);\n"),
        _replace_once("        for (int c = 0; c < BN; c += box_keys) {",
                      "        for (int c = 0; c < 0; c += box_keys) {")),
    "output stores cut out": _replace_once(
        "        *reinterpret_cast<uint4*>(at) = v;",
        "        if (v.x == 0x12345678u) *reinterpret_cast<uint4*>(at) = v;"),
    "ring of 2 stages": _replace_once("kStages = HD == 64 ? 3 : 2;", "kStages = HD == 64 ? 2 : 2;"),
    "ring of 1 stage": _replace_once("kStages = HD == 64 ? 3 : 2;", "kStages = HD == 64 ? 1 : 2;"),
    "empty grid (the launch floor)": _replace_once(
        "  using L = BgSmem<HD>;\n  constexpr int BN = L::kBN;",
        "  if (p.n_tiles >= 0) return;\n  using L = BgSmem<HD>;\n  constexpr int BN = L::kBN;"),
}


def rmsnorm_bwd_breakdown() -> None:
    """Where the RMSNorm backward's time goes: each of
    ``RMSNORM_BWD_VARIANTS`` timed by ``Timer`` at the training path's shape
    (8192 rows of 2048, bf16), in one process on this card, beside a
    torch.add(x, g) of the same bytes (x and g read, one tensor of x's size
    written) and the library call."""
    _build.library()
    libs = variant_libraries("rmsnorm_bwd", RMSNORM_BWD_VARIANTS, "rmsnorm_bwd",
                             patched="rmsnorm_bwd.cuh")
    gen = torch.Generator(device="cuda").manual_seed(71)
    timer = Timer()
    rows, D = TRAIN_B * TRAIN_S, 2048
    x = torch.randn(rows, D, generator=gen, device="cuda", dtype=BF16)
    g = torch.randn(rows, D, generator=gen, device="cuda", dtype=BF16)
    w = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(BF16)
    y = torch.empty_like(x)
    xr, wr = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
    lib_out = F.rms_norm(xr, (D,), wr, 1e-5)
    built = _build._lib
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"rmsnorm_bwd breakdown, rows={rows} D={D} bf16, ms (Timer: median of 20 launches, "
          f"L2 flushed; {smi}):")
    try:
        for name, lib in libs.items():
            _build._lib = lib
            print(f"  {name}: {timer(lambda: rn.rmsnorm_bwd(x, w, g)):.4f}")
    finally:
        _build._lib = built
    print(f"  torch.add(x, g) of the same bytes: {timer(lambda: torch.add(x, g, out=y)):.4f}")
    print(f"  library (F.rms_norm backward): "
          f"{timer(lambda: torch.autograd.grad(lib_out, (xr, wr), g, retain_graph=True)):.4f}")


def bias_grad_breakdown() -> None:
    """Where the bias-gradient kernel's time goes: each of
    ``BIAS_GRAD_VARIANTS`` timed by ``Timer`` at the attention_bias path's
    shape ([1, 16, 2048, 2048] fp32 bias, B=4 D=64 causal), in one process
    on this card."""
    _build.library()
    libs = variant_libraries("flash_attention_bias_grad", BIAS_GRAD_VARIANTS,
                             "flash_attention_bias_grad")
    gen = torch.Generator(device="cuda").manual_seed(73)
    timer = Timer()
    B, S, H, D = TRAIN_B, TRAIN_S, 16, 64

    def rand(*shape, dtype=BF16):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)

    q, k, v, do = rand(B, S, H, D), rand(B, S, H, D), rand(B, S, H, D), rand(B, S, H, D)
    bias = 0.3 * rand(1, H, S, S, dtype=torch.float32)
    o, lse = fa.flash_attention_fwd(q, k, v, True, bias=bias)
    _, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, True, bias=bias)
    built = _build._lib
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"flash_attention_bias_grad breakdown, bias [1, {H}, {S}, {S}] fp32, B={B} D={D} "
          f"causal, ms (Timer: median of 20 launches, L2 flushed; {smi}):")
    try:
        for name, lib in libs.items():
            _build._lib = lib
            print(f"  {name}: "
                  f"{timer(lambda: fa.flash_attention_bias_grad(q, k, v, bias, lse, delta, do)):.4f}")
    finally:
        _build._lib = built


def norm_breakdown() -> None:
    """Where the norm forwards' time goes: each of ``NORM_VARIANTS`` timed by
    ``Timer`` at the main paths' shapes (the serving_cb step, the prefills,
    training, the decode steps' rows; bf16), in one process on this card,
    beside the library call and a ``copy_`` of the same bytes (a plain
    streaming kernel: what reading x and writing out alone costs here)."""
    _build.library()
    libs = {"rmsnorm": variant_libraries("rmsnorm", NORM_VARIANTS, "rmsnorm_fwd",
                                         "norm_fwd.cuh"),
            "layernorm": variant_libraries("layernorm", NORM_VARIANTS, "layernorm_fwd",
                                           "norm_fwd.cuh")}
    gen = torch.Generator(device="cuda").manual_seed(59)
    timer = Timer()
    built = _build._lib
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"norm forward breakdown, ms (Timer: median of 20 launches, L2 flushed; {smi}):")
    for kind, shapes in (("rmsnorm", (("serving_cb", 512, 4096), ("serving prefill", 2048, 4096),
                                      ("training", 8192, 2048), ("decode", 1, 4096),
                                      ("decode", 4, 4096))),
                         ("layernorm", (("serving_bloom prefill", 2048, 4096),
                                        ("serving_gpt2 prefill", 2048, 1600),
                                        ("training_bloom", 8192, 1024), ("decode", 4, 4096),
                                        ("decode", 4, 1600)))):
        for label, n, D in shapes:
            x = torch.randn(n, D, generator=gen, device="cuda", dtype=BF16)
            y = torch.empty_like(x)
            w = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(BF16)
            b = (0.1 * torch.randn(D, generator=gen, device="cuda")).to(BF16)
            if kind == "rmsnorm":
                fn, lib_fn = (lambda: rn.rmsnorm_fwd(x, w)), (lambda: F.rms_norm(x, (D,), w, 1e-5))
            else:
                fn = lambda: ln.layernorm_fwd(x, w, b)  # noqa: E731
                lib_fn = lambda: F.layer_norm(x, (D,), w, b, 1e-5)  # noqa: E731
            cells = []
            try:
                for name, lib in libs[kind].items():
                    _build._lib = lib
                    cells.append(f"{name} {timer(fn):.4f}")
            finally:
                _build._lib = built
            cells += [f"library {timer(lib_fn):.4f}", f"copy_ {timer(lambda: y.copy_(x)):.4f}"]
            print(f"  {kind}_fwd {label} rows={n} D={D}: " + ", ".join(cells))


def layernorm_breakdown() -> None:
    """Where the LayerNorm backward's time goes: each of
    ``LAYERNORM_VARIANTS`` timed by ``Timer`` at training_bloom's shape (8192
    rows of 1024, bf16), in one process on this card."""
    _build.library()
    libs = variant_libraries("layernorm_bwd", LAYERNORM_VARIANTS, "layernorm_bwd")
    gen = torch.Generator(device="cuda").manual_seed(43)
    timer = Timer()
    x = torch.randn(TRAIN_B * TRAIN_S, 1024, generator=gen, device="cuda", dtype=BF16)
    g = torch.randn(TRAIN_B * TRAIN_S, 1024, generator=gen, device="cuda", dtype=BF16)
    w = (1 + 0.1 * torch.randn(1024, generator=gen, device="cuda")).to(BF16)
    built = _build._lib
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"layernorm_bwd breakdown, rows={TRAIN_B * TRAIN_S} D=1024 bf16, ms (Timer: median "
          f"of 20 launches, L2 flushed; {smi}):")
    try:
        for name, lib in libs.items():
            _build._lib = lib
            print(f"  {name}: {timer(lambda: ln.layernorm_bwd(x, w, g)):.4f}")
    finally:
        _build._lib = built


def matvec_breakdown() -> None:
    """Where the packed matvec's time goes: each of ``MATVEC_VARIANTS`` timed
    by ``Timer`` at the PERF.md section 6 matvec shapes, in one process on
    this card, with the bytes a row streams over its time."""
    _build.library()
    libs = variant_libraries("quantized_matvec", MATVEC_VARIANTS, "quantized_expert_matvec")
    gen = torch.Generator(device="cuda").manual_seed(41)
    timer = Timer()
    shapes = {}
    for bits, leaf, D, N, E, C in ((8, "wi/wg", 4096, 14336, 1, 1), (4, "wi/wg", 4096, 14336, 1, 1),
                                   (8, "wk/wv", 4096, 1024, 1, 1),
                                   (8, "expert wi/wg", 4096, 14336, 8, 4),
                                   (4, "expert wo", 14336, 4096, 8, 4)):
        lead = (E,) if E > 1 else ()
        pw = pack_quantize_blockwise(
            (0.02 * torch.randn(*lead, D, N, generator=gen, device="cuda")).to(BF16), bits=bits)
        x = torch.randn(*lead, C, D, generator=gen, device="cuda", dtype=BF16)
        fn = qmm.packed_expert_matvec if E > 1 else qmm.packed_matvec
        shapes[f"int{bits} {leaf} M={C}"] = (lambda fn=fn, x=x, pw=pw: fn(x, pw), pw.nbytes)
    built = _build._lib
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"matvec breakdown, ms and GB/s of the weight's bytes (Timer: median of 20 "
          f"launches, L2 flushed; {smi}):")
    try:
        for name, lib in libs.items():
            _build._lib = lib
            cells = []
            for shape, (fn, nbytes) in shapes.items():
                ms = timer(fn)
                cells.append(f"{shape} {ms:.4f} ({nbytes / ms / 1e6:.0f})")
            print(f"  {name}: " + ", ".join(cells))
    finally:
        _build._lib = built


def decode_breakdown() -> None:
    """Where the decode kernel's time goes: each of ``DECODE_VARIANTS`` timed
    by ``Timer`` at the PERF.md section 6 decode shapes, in one process on
    this card; the worst error against the plain version of the as-built
    kernel and of P as one bf16 term on ALiBi windows (check_alibi's window
    shape, four draws); then, on the draw that follows the dense, int8 and
    paged decode checks (no other check between), the flash ALiBi forward at
    training_bloom's shape against its plain version and check_alibi's
    tolerance, printed, not required."""
    _build.library()
    libs = decode_variant_libraries()
    gen = torch.Generator(device="cuda").manual_seed(31)
    timer = Timer()

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=BF16)

    fr4 = torch.tensor([0, 37, 511, 1023], dtype=torch.int32, device="cuda")
    q4, kc, vc = rand(4, 1, 32, 128), rand(4, 1024, 8, 128), rand(4, 1024, 8, 128)
    k8, v8, ks8, vs8 = int8_cache(gen, 4, 1024, 8, 128)
    qb, kb, vb = rand(4, 1, 32, 128), rand(4, 1024, 32, 128), rand(4, 1024, 32, 128)
    qg, kg, vg = rand(4, 1, 25, 64), rand(4, 1024, 25, 64), rand(4, 1024, 25, 64)
    slopes = alibi_slopes(32).cuda()
    cb, cb8 = paged_case(gen, False), paged_case(gen, True)
    shapes = {
        "dense B=4": lambda: dec.decode_attention(q4, kc, vc, fr4),
        "int8 B=4": lambda: dec.decode_attention(q4, k8, v8, fr4, ks8, vs8),
        "ALiBi H=KV=32": lambda: dec.decode_attention(qb, kb, vb, fr4, slopes=slopes),
        "GPT-2 H=KV=25 D=64": lambda: dec.decode_attention(qg, kg, vg, fr4),
        "serving_cb dense rows": lambda: dec.decode_attention(cb[0], *cb[5], cb[4],
                                                              rows_per_seq=CB_BUDGET),
        "serving_cb paged": lambda: dec.paged_decode_attention(cb[0], *cb[1], cb[4], cb[3],
                                                               rows_per_seq=CB_BUDGET),
        "serving_cb paged int8": lambda: dec.paged_decode_attention(
            cb8[0], *cb8[1], cb8[4], cb8[3], *cb8[2], rows_per_seq=CB_BUDGET),
    }
    windows = []
    for _ in range(4):  # check_alibi's window: 2 sequences x 5 rows, H=KV=32, Smax 300
        fr = torch.tensor([120, 121, 122, 123, 124, 0, 299, -1, 7, 250], dtype=torch.int32,
                          device="cuda")
        windows.append((rand(10, 1, 32, 128), rand(2, 300, 32, 128), rand(2, 300, 32, 128),
                        fr))
    built = _build._lib
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"decode breakdown, ms (Timer: median of 20 launches, L2 flushed; {smi}):")
    try:
        for name, lib in libs.items():
            _build._lib = lib
            print(f"  {name}: " + ", ".join(f"{k} {timer(fn):.4f}" for k, fn in shapes.items()))
            if name in ("as built", "P as one bf16 term"):
                err = max(max_err(dec.decode_attention(q, k, v, fr, rows_per_seq=5, slopes=slopes),
                                  dec.decode_attention_plain(q, k, v, fr, rows_per_seq=5,
                                                             slopes=slopes))
                          for q, k, v, fr in windows)
                print(f"  {name}: ALiBi windows, worst max_abs_err against plain {err:.3e} "
                      "(check_alibi's tol 1e-2)")
    finally:
        _build._lib = built
    gen.manual_seed(0)
    check_decode(gen, timer)
    check_decode_int8(gen, timer)
    check_paged_decode(gen, timer)
    rand(4, 512, 32, 128), rand(4, 512, 32, 128), rand(4, 512, 32, 128)  # serving_bloom's draw
    q, k, v = rand(4, 2048, 16, 64), rand(4, 2048, 16, 64), rand(4, 2048, 16, 64)
    sl = alibi_slopes(16).cuda()
    out, _ = fa.flash_attention_fwd(q, k, v, True, sl)
    ref, _ = fa.flash_attention_plain(q, k, v, True, sl)
    print(f"flash_attention_fwd_alibi B=4 S=2048 H=KV=16 D=64 on the draw after the decode "
          f"checks: max_abs_err {max_err(out, ref):.3e} (check_alibi's tol: 2 bf16 ulps of "
          f"the largest value, {2 * bf16_ulp(ref.float().abs().max().item()):.3e})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing run", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    mem = host_memory()
    print(f"host memory: MemTotal {mem['MemTotal']} bytes ({mem['MemTotal'] / 2**30:.1f} GiB), "
          f"MemAvailable {mem['MemAvailable']} bytes ({mem['MemAvailable'] / 2**30:.1f} GiB); "
          f"disk: {disk_free(CKPT_DIR)} bytes free under {CKPT_DIR.parent} (the checkpoint "
          f"phase's filesystem, {filesystem_type(CKPT_DIR.parent)}); {os.cpu_count()} cores")
    if sys.argv[1:] == ["--decode-breakdown"]:
        decode_breakdown()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}))
        return 0
    breakdowns = {"--io-probe": io_probe,
                  "--matvec-breakdown": matvec_breakdown,
                  "--layernorm-breakdown": layernorm_breakdown,
                  "--norm-breakdown": norm_breakdown,
                  "--rmsnorm-bwd-breakdown": rmsnorm_bwd_breakdown,
                  "--bias-grad-breakdown": bias_grad_breakdown}
    if len(sys.argv) == 2 and sys.argv[1] in breakdowns:
        breakdowns[sys.argv[1]]()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}))
        return 0
    if len(sys.argv) == 3 and sys.argv[1] in ("--baseline", "--bwd-baseline"):
        (compare_to_baseline if sys.argv[1] == "--baseline"
         else compare_bwd_to_baseline)(sys.argv[2])
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}))
        return 0

    last = [time.perf_counter()]

    def lap(label: str) -> None:  # the seconds since the previous lap
        now = time.perf_counter()
        print(f"phase {label}: {now - last[0]:.1f} s")
        last[0] = now

    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for line in _build.ptxas_log().splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")
    check_flash_instructions()
    check_decode_instructions()
    check_matvec_instructions()
    lap("build and instruction counts")

    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = Timer()
    # one timed row per (kernel, main path) at that path's shape
    flash, norm = check_flash(gen, timer), check_rmsnorm(gen, timer)
    dq, dkv = check_flash_bwd(gen, timer)
    qmv8, qmv4 = check_quantized_matvec(gen, timer)
    xmv8, xmv4 = check_expert_matvec(gen, timer)
    decode = check_decode(gen, timer)
    cb = check_paged_decode(gen, timer)
    lnorm = check_layernorm(gen, timer)
    fwd_bloom, fwd_bloom_train, dq_bloom, dkv_bloom, decode_bloom = check_alibi(gen, timer)
    masked = check_masked_forms(gen, timer)
    bias_grad = check_bias_grad(gen, timer)
    offsets = check_offset_forms(gen, timer)
    rms_bwd, adam = check_rmsnorm_bwd(gen, timer), check_fused_adam(gen, timer)
    ln_bwd = check_layernorm_bwd(gen, timer)
    adam_bloom = check_fused_adam(gen, timer, n=250880 * 1024)
    mix = check_mixtral_training_shapes(timer)
    ckpt_serving = check_checkpoint_serving_shapes(timer)
    # the offloaded update's launches: a layer slot's largest slice (llama3-1b's
    # MLP, 2048 x 8192; Llama-3-8B's, 4096 x 14336, with that path's shapes)
    adam_slice = check_fused_adam(gen, timer, n=2048 * 8192)
    o8 = check_8b_offload_shapes(timer)
    zero = check_zero_shapes(timer)
    # training_zero's stage 3: fused Adam on a stacked layer part, each of 4
    # layers' run of the MLP weight (4 x 2048 x 8192 / 2 fp32)
    adam_zero3 = check_fused_adam(gen, timer, n=SP_LAYERS * 2048 * 8192 // SP_SIZE)
    # training_fp16: the fp16 forms at its shapes (and the flash forms at
    # Llama-3-8B's heads, printed beside them), overflows visible
    f16, f16_hd128 = check_fp16_forms(timer)
    check_fp16_overflow()
    # the quantized serving path runs the bf16 path's requests: its flash,
    # RMSNorm and (int4 engine, draft) dense decode shapes are the same
    rows = [
        ("flash_attention_fwd", "serving", flash["serving"]),
        ("flash_attention_fwd", "training", flash["training"]),
        ("flash_attention_fwd", "serving_quantized", flash["serving"]),
        ("decode_attention", "serving", decode),
        ("decode_attention", "serving_quantized", decode),
        ("rmsnorm_fwd", "serving", norm["serving"]),
        ("rmsnorm_fwd", "training", norm["training"]),
        ("rmsnorm_fwd", "serving_quantized", norm["serving"]),
        ("rmsnorm_bwd", "training", rms_bwd),
        ("flash_attention_bwd_dq", "training", dq),
        ("flash_attention_bwd_dkv", "training", dkv),
        ("fused_adam", "training", adam),
        ("quantized_matvec_int8", "serving_quantized", qmv8),
        ("quantized_matvec_int4", "serving_quantized", qmv4),
        ("decode_attention_int8", "serving_quantized", dec8 := check_decode_int8(gen, timer)),
        ("paged_decode_attention", "serving_cb", cb["paged_decode_attention"]),
        ("paged_decode_attention_int8", "serving_cb", cb["paged_decode_attention_int8"]),
        ("decode_attention", "serving_cb", cb["decode_attention"]),
        ("decode_attention_int8", "serving_cb", cb["decode_attention_int8"]),
        ("rmsnorm_fwd", "serving_cb", norm["serving_cb"]),
        ("layernorm_fwd", "serving_bloom", lnorm["serving_bloom"]),
        ("flash_attention_fwd_alibi", "serving_bloom", fwd_bloom),
        ("decode_attention_alibi", "serving_bloom", decode_bloom),
        ("layernorm_fwd", "serving_gpt2", lnorm["serving_gpt2"]),
        ("flash_attention_fwd", "serving_gpt2", flash["serving_gpt2"]),
        ("decode_attention", "serving_gpt2", check_decode(gen, timer, H=25, KV=25, D=64)),
        ("layernorm_fwd", "training_bloom", lnorm["training_bloom"]),
        ("layernorm_bwd", "training_bloom", ln_bwd),
        ("flash_attention_fwd_alibi", "training_bloom", fwd_bloom_train),
        ("flash_attention_bwd_dq_alibi", "training_bloom", dq_bloom),
        ("flash_attention_bwd_dkv_alibi", "training_bloom", dkv_bloom),
        ("fused_adam", "training_bloom", adam_bloom),
        *((name, path, r) for (name, path), r in masked.items()),
        ("rmsnorm_fwd", "training_packed", norm["training"]),
        ("rmsnorm_bwd", "training_packed", rms_bwd),
        ("fused_adam", "training_packed", adam),
        ("layernorm_fwd", "training_bloom_packed", lnorm["training_bloom"]),
        ("layernorm_bwd", "training_bloom_packed", ln_bwd),
        ("fused_adam", "training_bloom_packed", adam_bloom),
        ("rmsnorm_fwd", "training_sparse", norm["training"]),
        ("rmsnorm_bwd", "training_sparse", rms_bwd),
        ("fused_adam", "training_sparse", adam),
        ("flash_attention_bias_grad", "attention_bias", bias_grad),
        # Mixtral-8x7B's attention, norm and head shapes are Llama-3-8B's: its
        # flash, decode, RMSNorm and 2-D matvec rows are the serving paths'
        ("quantized_matvec_expert_int8", "serving_mixtral", xmv8),
        ("quantized_matvec_expert_int4", "serving_mixtral", xmv4),
        ("quantized_matvec_int8", "serving_mixtral", qmv8),
        ("quantized_matvec_int4", "serving_mixtral", qmv4),
        ("decode_attention_int8", "serving_mixtral", dec8),
        ("decode_attention", "serving_mixtral", decode),
        ("flash_attention_fwd", "serving_mixtral", flash["serving"]),
        ("rmsnorm_fwd", "serving_mixtral", norm["serving"]),
        ("paged_decode_attention", "serving_cb_mixtral", cb["paged_decode_attention"]),
        ("decode_attention", "serving_cb_mixtral", cb["decode_attention"]),
        ("rmsnorm_fwd", "serving_cb_mixtral", norm["serving_cb"]),
        # training_sp: the offset forms (ring mode's hops; the past hop
        # timed), the unmasked forms at the Ulysses shape, and llama3-1b's
        # RMSNorm (8,192 rows a rank of 2,048) and Adam rows
        *((name, "training_sp", r) for name, r in offsets.items()),
        ("rmsnorm_fwd", "training_sp", norm["training"]),
        ("rmsnorm_bwd", "training_sp", rms_bwd),
        ("fused_adam", "training_sp", adam),
        # training_mixtral: Mixtral-8x7B's micro-batch (head dim 128), its
        # 8192 x 4096 norm rows and its largest leaf
        *((name, "training_mixtral", r) for name, r in mix.items()),
        # checkpoint: the resumed llama3-1b steps (training's shapes), and the
        # serving of its checkpoint (llama3-1b's serving shapes)
        ("flash_attention_fwd", "checkpoint", flash["training"]),
        ("flash_attention_bwd_dq", "checkpoint", dq),
        ("flash_attention_bwd_dkv", "checkpoint", dkv),
        ("rmsnorm_fwd", "checkpoint", norm["training"]),
        ("rmsnorm_bwd", "checkpoint", rms_bwd),
        ("fused_adam", "checkpoint", adam),
        *((name, "checkpoint_serving", r) for name, r in ckpt_serving.items()),
        # offload: llama3-1b's training shapes, fused Adam on layer slices
        ("flash_attention_fwd", "offload", flash["training"]),
        ("flash_attention_bwd_dq", "offload", dq),
        ("flash_attention_bwd_dkv", "offload", dkv),
        ("rmsnorm_fwd", "offload", norm["training"]),
        ("rmsnorm_bwd", "offload", rms_bwd),
        ("fused_adam", "offload", adam_slice),
        *((name, "training_8b_offload", r) for name, r in o8.items()),
        # training_zero: a rank's row of 8,192 tokens; fused Adam on its
        # largest part
        *((name, "training_zero", r) for name, r in zero.items()),
        # training_zero's stage 3: the same shapes; fused Adam on a layer part
        *((name, "training_zero3", r if name != "fused_adam" else adam_zero3)
          for name, r in zero.items()),
        # training_fp16: the fp16 forms at the training shapes; fused Adam on
        # the fp32 masters from fp32 gradients, as in bf16
        *((name, "training_fp16", r) for name, r in f16.items()),
        ("fused_adam", "training_fp16", adam),
    ]
    # the norms' decode rows are printed beside the main paths' rows; the
    # kernels line keeps one row per main path
    decode_rows = [(name, key, r) for name, table in (("rmsnorm_fwd", norm),
                                                       ("layernorm_fwd", lnorm))
                   for key, r in table.items() if key.startswith("decode")]
    decode_rows += [(name, "Llama-3-8B's heads, fp16", r) for name, r in f16_hd128.items()]
    for name, path, r in rows + decode_rows:
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        host = f", host {r['host_us']:.1f} us a call" if "host_us" in r else ""
        b_ms = f"{r['bound_ms']:.4f}" if r["bound_ms"] >= 1e-3 else f"{r['bound_ms']:.2e}"
        print(f"{name} ({path}) [{r['shape']}]: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {lib}, bound {b_ms} ms ({r['bound_by']}){host}")
    del timer
    torch.cuda.empty_cache()
    lap("kernel checks at the main paths' shapes")

    check_other_forms(gen)
    check_fwd_tiles(gen)
    check_bwd_tiles(gen)
    check_decode_edges()
    reference_check()
    reference_check(bloom("bloom-7b1", num_layers=2), "serving_bloom ",
                    BLOOM_SERVING_KERNELS)
    reference_check(gpt2("gpt2-xl", num_layers=2), "serving_gpt2 ", GPT2_SERVING_KERNELS)
    reference_check_training()
    reference_check_training(bloom("bloom-560m", num_layers=2), BLOOM_TRAINING_KERNELS,
                             anchored=True, zero_grad_leaves=("layers/attn/bk",))
    # the new paths' checks run the chunked CE on both paths, anchored to an
    # fp32 run, as BLOOM's: on packed llama3-1b with the dense CE on the plain
    # path the two grad norms read 1.058e-4 apart (tol 1e-4), 5.9e-6 with the
    # chunked CE on both (H100 80GB HBM3, 700.00 W)
    packed_llama = llama("llama3-1b", num_layers=2)
    reference_check_training(packed_llama, PACKED_KERNELS, anchored=True,
                             remat_check=False,
                             batch_fn=lambda ids, i: packed_batch(ids, PACKED_SEED + 10 + i),
                             label="training_packed ")
    reference_check_training(bloom("bloom-560m", num_layers=2), BLOOM_PACKED_KERNELS,
                             anchored=True, zero_grad_leaves=("layers/attn/bk",),
                             batch_fn=lambda ids, i: packed_batch(ids, PACKED_SEED + 10 + i),
                             remat_check=False, label="training_bloom_packed ")
    reference_check_training(packed_llama, SPARSE_KERNELS, anchored=True,
                             remat_check=False, extra={"sparse_attention": SPARSE_SECTION},
                             label="training_sparse ")
    check_packed_equals_unpacked(packed_llama)
    check_packed_equals_unpacked(bloom("bloom-560m", num_layers=2))
    reference_check_quantized()
    reference_check_serving_cb()
    reference_check_mixtral()
    lap("other forms, tile edges and reference checks")
    paths = {
        "training": main_path_training, "training_fp16": main_path_training_fp16,
        "serving": main_path,
        "serving_quantized": main_path_quantized, "serving_cb": main_path_serving_cb,
        "serving_bloom": lambda: main_path_family(bloom("bloom-7b1"), 3,
                                                  BLOOM_SERVING_KERNELS, "serving_bloom"),
        "serving_gpt2": lambda: main_path_family(gpt2("gpt2-xl"), 2, GPT2_SERVING_KERNELS,
                                                 "serving_gpt2"),
        "training_bloom": lambda: main_path_training(bloom("bloom-560m"),
                                                     BLOOM_TRAINING_KERNELS, "training_bloom"),
        "training_packed": lambda: main_path_training(None, PACKED_KERNELS, "training_packed",
                                                      packed=True, rerun=False),
        "training_bloom_packed": lambda: main_path_training(
            bloom("bloom-560m"), BLOOM_PACKED_KERNELS, "training_bloom_packed",
            packed=True, rerun=False),
        "training_sparse": lambda: main_path_training(
            None, SPARSE_KERNELS, "training_sparse",
            extra={"sparse_attention": SPARSE_SECTION}, rerun=False,
            pairs_per_seq=layout_pairs(sparse_fixed_layout(TRAIN_S), TRAIN_S)),
        "attention_bias": main_path_attention_bias,
    }
    counts = {}
    for path, run in paths.items():
        counts[path] = run()
        lap(path)
    # training_zero runs in training_sp's world; both before training_mixtral,
    # whose blocks this process's allocator keeps cached beside the two ranks
    counts["training_sp"], counts["training_zero"], counts["training_zero3"] = \
        main_path_training_sp()
    lap("training_sp and training_zero")
    counts["training_mixtral"] = main_path_training_mixtral()
    lap("training_mixtral")
    counts["checkpoint"], counts["checkpoint_serving"] = main_path_checkpoint()
    lap("checkpoint")
    counts["offload"] = main_path_offload()
    lap("offload")
    counts["training_8b_offload"] = main_path_training_8b_offload()
    lap("training_8b_offload")
    counts["serving_mixtral"], counts["serving_cb_mixtral"] = main_path_serving_mixtral()
    lap("serving_mixtral and serving_cb_mixtral")

    # launches: the row's main path's run, counters zeroed just before it
    line = {"kernels": [
        {"name": name, "path": path, "route": "cuda", **KERNELS[name],
         "launches": counts[path][name],
         **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms")}}
        for name, path, r in rows
    ]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
