#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # needs one GPU; takes no arguments

It builds the port's kernels from the sources in this checkout (one
``nvcc`` per library, all started together), holds each one against its
plain PyTorch version at the shapes of the paths below, checks the
serving engines (unified, legacy, draft-model speculation) end to end on
a small config against the same engines on the CPU, then drives gemma-2b
at full width (18 layers, random weights from a seed) through both of
the port's gemma paths, rwkv6-1.6b at full width and depth (24 layers)
through its prefill and decode path, and jamba-1.5-large at full width,
cut to its first 5 layers (every kind of block; 48.1 GB at bf16),
through the same step builders, then the seven other architectures of
the configs registry at full width (gemma3-1b, qwen2-moe-a2.7b,
minicpm3-4b, llava-next-mistral-7b, hubert-xlarge, yi-34b, and
arctic-480b cut to 2 of its 35 layers), trains ResNet-50 and GNMT at
full width through the port's eager runtime, and runs its compiled
path:

  * paged continuous-batching serving through
    ``repro_torch.serving.ServingEngine`` (paged attention, Gumbel);
  * the gathered-cache path on a live serving engine's pool
    (``PagedKVCache.gather``, then ``models.attention.mixed_attention``,
    the mixed-attention kernel) against the paged kernel on the same
    pool, and the serving front door on the same model: the legacy
    engine (flash and decode attention) beside the unified one,
    draft-model speculation (``DraftModelProposer``: flash attention in
    every draft forward), ``AsyncFrontend`` streams under arrival
    traffic, and ``launch/server.py``'s HTTP/SSE server over a loopback
    socket;
  * the dense-cache path: prefill through
    ``repro_torch.launch.train.make_prefill_step`` (``lm.forward``, the
    flash kernel) and greedy decode through ``make_serve_step``
    (``lm.decode_step``, the decode kernel), then a prefill == decode
    parity check at fp32 weights;
  * the rwkv6 path: the same step builders over rwkv blocks (the WKV6
    kernel in prefill and, from the cached state, in every decode step),
    then the same parity check;
  * the jamba path: mamba blocks (the Mamba scan kernel in prefill and,
    from the cached state, in every decode step), the GShard MoE and
    attention without RoPE (flash in prefill, decode attention in
    decode), then the parity check at fp32 on two layers of its 8-layer
    period, mamba/moe and attn/dense (47.6 GB), with a dropless capacity
    factor;
  * the seven architectures: each through ``make_prefill_step`` on 4 x
    1024 tokens (embeddings for llava and hubert) and, but for hubert
    (an encoder), ``make_serve_step`` at B = 8 for 16 greedy steps past
    a 1024-position cache (flash and decode attention at the shapes no
    earlier path gives them: gemma3's window 512 and rings, G = 7 and
    G = 1, hubert's bidirectional heads of 80 and MLA's 96 / 64 padded
    to 128); then the fp32 parity check of gemma3 (8 layers, the window
    cut to 64 so that the rollout wraps its rings) and of minicpm3 (2
    layers, MLA at S = 160), and the padding's cost (``head_padding``);
  * the eager runtime: ResNet-50 (224 x 224 RGB, batch 64, fp32, train
    mode, SGD with momentum) through ``repro_torch``'s Tensor, tape,
    dispatch cache and fusion queue, every flushed elementwise chain a
    launch of the Triton kernel generated from it;
  * the rest of the eager runtime: GNMT (vocab 32000, hidden 1024, 4
    layers, batch 64 x 50/51 tokens, fp32, Adafactor) through
    ``nn.LSTM`` and the fusion queue (Bahdanau attention's add -> tanh
    chain, one fused launch a step); the jit bridge
    (``repro_torch.compile``: ResNet-50's eval forward, an NCF
    ``value_and_grad`` step, SDPA through the flash kernel's custom op,
    a fused chain bypassed, and each other kernel launch called inside
    a compiled function: one custom op, one launch, the eager bits);
    masked SDPA on the card;
  * the distributed slice: the paged kernel's log-sum-exp output
    (``paged_attention_lse`` rows); gemma-2b with ``n_replicas=2`` on
    the card (``replica_serving``); sharded serving on meshes of ranks
    that the script starts itself (``run_ranks``: NCCL with a card a
    rank where there are enough, else gloo with the ranks sharing
    ``cuda:0``): fp32 gemma-2b cut to 2 layers on (2,1), (1,2), (2,2),
    greedy and sampled, equal to the no-mesh engine, and bf16 gemma-2b
    at full depth on (1,2) (its one KV head context-parallel) and (2,2)
    (``sharded_serving``); DDP's synced gradients against one process's
    full batch (``ddp``) and a 4-stage pipeline against the sequential
    composition (``pipeline``);
  * meshed training and decode (``launch.train``'s steps with
    ``mesh=``; jobs of the same two rank groups): the decode kernel's
    log-sum-exp output (``decode_attention_lse`` rows at gemma-2b's
    decode shape and at a rank's half of its slots, bf16 and fp32, with
    and without lse: the output's bits unchanged); ``sharded_train``:
    fp32 gemma-2b at full width cut to 2 layers on (2,1), (1,2), (2,2),
    2 AdamW steps on a global 4 x 256 batch, each against the
    one-process step on the card from the same state (loss, grad norm,
    the assembled gradients, moments and parameters), and bf16 gemma-2b
    at full width and depth (remat "full", 4 x 1024) on (2,2) and (1,2):
    tokens/s, GB a rank, collectives and staged bytes a step, and a
    checkpoint save's device peak (``save_peak``: the largest leaf
    gathered as a save gathers it, one leaf at a time);
    ``sharded_decode``: the fp32 2-layer model through the meshed
    prefill and serve steps on (1,2) and (2,2) (gemma's one KV head:
    the cache's slots split over ``model``, the ranks' partial attention
    merged by the decode kernel's lse), greedy tokens equal to no mesh,
    and gemma3-1b at full width cut to 2 layers on (1,2): its sliding
    layers' 512-slot rings split over ``model`` and wrapped by 520
    steps fed the no-mesh run's tokens, each step's logits ranking that
    token first (within ``SLIDING_TOL`` of their RMS) and the logits of
    three steps equal to no mesh's; ``elastic_restore``: gemma-2b's SMOKE config saved on (2,2) after
    step 1, restored onto (1,2) and onto no mesh (the parameters and
    both AdamW moments bit for bit the saved ones), step 2 against the
    uninterrupted run's by ``sharded_train``'s parameter rule;
    ``meshed_training_seconds``;
  * MoE, mamba and rwkv blocks on a model axis of 2 (jobs of the same
    two rank groups; the experts, mamba's channels and rwkv's heads
    over ``model``): ``meshed_blocks_parity``: the fp32 train step, 2
    AdamW steps, on (1,2) and (2,2) against the one-process step on the
    card, on jamba's SMOKE config, qwen2-moe-a2.7b (1 layer) and
    rwkv6-1.6b (2 layers) at full width; ``meshed_blocks_decode``: the
    fp32 meshed prefill and decode of jamba (one period's mamba/dense
    and attn/dense layers), qwen2-moe and rwkv6 at full width, fed the
    no-mesh run's tokens (each ranked first; recorded logits against
    no mesh's); ``meshed_blocks_bf16``: jamba-1.5-large's first 5
    layers on (1,2) (the rank's pieces drawn leaf by leaf) and
    rwkv6-1.6b at full width and depth on (1,2) and (2,2): prefill
    tokens/s, decode ms a step, GB held and peak, collectives and staged
    GB, each rank's Mamba, WKV6, flash and decode launches;
    ``meshed_blocks_seconds``;
  * the dry run (``repro_torch.launch.dryrun``, on the host's CPU, each
    trace in a process of its own on a fake process group, on ``meta``):
    ``dryrun_check``: the exact configuration ``sharded_train``'s bf16
    run trained on the card (gemma-2b, 18 layers, remat "full", AdamW,
    4 x 1024 tokens, (2,2) and (1,2)), predicted against what rank 0
    measured: bytes held before the step within ``DRYRUN_HELD_TOL`` of
    ``held_gb``, the step's peak within ``DRYRUN_PEAK_TOL`` of
    ``step_peak_gb``, collective calls a step equal; ``dryrun_cell``:
    gemma-2b's train_4k, prefill_32k and decode_32k on the (16, 16)
    production mesh, each record's line and trace seconds;
    ``dryrun_seconds`` (under ``DRYRUN_SECONDS``);
  * LM training: ``data.DataLoader`` over ``SyntheticLMDataset`` with
    and without pinned staging on its copy stream; gemma-2b (bf16,
    remat "full", AdamW, 4 x 1024 tokens) through ``train_loop`` (the
    flash kernel in every layer's forward and again in its recompute);
    fp32 SMOKE gemma, jamba and rwkv6 training steps on the card
    against the CPU (flash, Mamba and WKV6 kernels); a restart through
    ``checkpoint.CheckpointManager``.

Each run shows that it went through its kernels: the launch counts are
zeroed just before it and read just after, and must equal what the
model's layers launch, kernel by kernel.  Each model is freed before the
next one is made; the profiled runs at the end make theirs again from
the same seeds.

Output, one line each:
  * the card's name and power limit, as ``nvidia-smi`` gives them;
  * one JSON line per kernel phase: paged attention for every (q dtype,
    pool dtype) pair the serving runs launch, plus fp8 (max abs error
    against the plain version beside the reference's RMS, kernel / plain
    / library ms by CUDA events, the bound; the main kernel's variant,
    "mma" for bf16 q on the tensor cores and "simt" for fp32 q on the
    CUDA cores, the device launches and thread blocks of a call as the
    kernel's C entry reports them, the work list of query tiles and key
    splits, which the device pre-pass must build exactly as
    ``paged_tiles_plain`` does; registers, spill bytes, shared memory and
    blocks per SM); the Gumbel kernels at serving's 48 x 256000 (the
    keyed kernel the serving path runs, its uniforms drawn in registers:
    error, same argmax in every row, ragged shapes, single-call ms, host
    us a call, its two-pass bound, the plain version's ms and the
    parent's path's, ``position_uniforms`` then the uniform kernel; and
    the uniform kernel against its three-pass bound); flash
    attention (gemma-2b prefill, an offset+window row, an fp32 row, and
    the fp32 prefills of dense_parity and jamba_parity; each with its
    kernel's variant, "mma" for bf16 and "tf32x3" for fp32, both on the
    tensor cores, registers, spill bytes, shared memory and blocks per
    SM, and its bound's rule: fp32 rows take 3xTF32's, three TF32
    products at the TF32 rate, beside the fp32 CUDA-core bound);
    decode attention (gemma-2b decode at ragged lengths, fp32, window,
    and the fp32 decode steps of dense_parity and jamba_parity; each with
    its variant, "mma" for bf16 on the tensor cores and "simt" for fp32
    on the CUDA cores, both split-KV, its kernel's resources and the
    device launches and thread blocks of a call as the C entry reports
    them);
    WKV6 (rwkv6-1.6b prefill, decode from a state, an fp32 row with a
    state; each with its kernel's registers, spill bytes, threads, shared
    memory, blocks per SM, the state columns a thread holds and the parts
    a column group is spread over); flash and decode attention at jamba's
    shapes; mixed attention
    (the paged row's inputs gathered into per-slot caches at bf16, fp32,
    with a window and bf16 q over fp32 caches, and the reference's small
    serving preset's head_dim 32; each with its variant, "mma" for bf16
    q over bf16 caches on the bf16 tensor cores and "tf32x3" for the
    fp32-cache pairs in 3xTF32, the device launches and thread blocks of
    a call, its kernel's resources, the work list, which the device
    pre-pass must build as the plain one does, and its bound's rule, the
    fp32-cache rows' beside the CUDA-core bound); the Mamba scan
    (jamba prefill, decode from a state, a ragged fp32 row with a state,
    B and C as strided column views; each with its kernel's registers,
    spill bytes, threads, shared memory, blocks per SM, channels a block,
    lanes a channel, the waves its grid runs in and the exponential its
    dtype uses); the fused-elementwise kernel
    (ResNet-50's add+relu and relu at their batch-64 shapes, fp32 and
    bf16, a long chain with a 0-d and a broadcast operand, and every op
    of the fusion queue in each dtype it takes, merged into a few
    chains; each timed row with its device ms of 20 calls queued, a
    single call's ms and the host us a call; the relu row also against
    ``torch.relu`` in alternating turns, every reading printed);
  * one JSON line per serving run (tokens/s, steps, buckets, and that
    run's own kernel launches: every run must launch both kernels; the
    paged variant its q dtype runs; fp32 greedy with speculation must
    equal it without, token for token);
  * ``paged_vs_gathered`` (the two kernels on a live pool with shared
    prefix pages and ragged tables, every layer), ``legacy_serving``
    (tokens/s, exact flash and decode launches, the unified engine's
    tokens/s on the same requests and the ratio), ``draft_spec`` (bf16
    and fp32; acceptance, tokens/s, the draft's flash launches; fp32
    output equal to spec_k=0), ``frontend_serving`` (p50/p99 TTFT and
    inter-token latency, zero dropped tokens and leaked pages, one
    terminal event per stream) and ``http_server``;
  * ``dense_prefill``, ``dense_decode`` and ``dense_parity`` lines,
    ``rwkv_prefill``, ``rwkv_decode`` and ``rwkv_parity`` lines,
    ``jamba_prefill``, ``jamba_decode`` and ``jamba_parity`` lines,
    ``<arch>_prefill`` for gemma3, qwen2_moe, minicpm3, llava, hubert, yi
    and arctic (its cut printed) and ``<arch>_decode`` for all but
    hubert, ``gemma3_parity`` and ``minicpm3_parity``, each with its own
    launch counts and peak device memory; ``head_padding`` (the padded
    call, the kernel alone and the pads alone, by CUDA events, at
    hubert's prefill and minicpm3's prefill and decode);
  * ``eager_train`` (images/s, ms a step, fused launches a step against
    the count derived from the model, dispatch-cache totals, the
    accounting allocator's peak beside PyTorch's, the first and last
    loss) and ``eager_parity`` (fusion off against on; a small ResNet-50
    on the card against the CPU);
  * ``data_loader`` (pinned batches equal to unpinned ones, batches/s
    of both, staged bytes, the copy stream), ``lm_train`` (ms a step,
    the median after step 2; target tokens/s; peak memory; every loss
    and grad norm; 36 flash launches a step), ``lm_train_parity`` (per
    model: loss, gradients and 3 SGD steps card against CPU, the fall
    over 20 steps), ``lm_restart`` (3 steps after a restart, a bit-exact
    restore, the async save's stall);
  * ``gnmt_train`` (target tokens/s, ms a step, fused launches a step,
    peak memory, the loss at steps 1 and 10), ``gnmt_parity`` (a GNMT of
    hidden 256 on the card against the CPU), ``compiled_path`` (compiled
    ResNet-50 and NCF against eager: compile seconds, graph breaks,
    eager and compiled ms; one flash launch a compiled SDPA call with the
    eager bits; no fused launch inside ``compile``) and ``masked_sdpa``
    (fp32 and bf16, the card against the CPU, with ms);
  * the profiled runs (``serving_profile``, the ``*_prefill_profile``
    and ``*_decode_profile`` of the three step-builder paths and
    ``eager_train_profile``: device time and kernel calls by kernel group
    or eager op, idle share; ``serving_profile`` also the sampling tail,
    the kernels under the executor's ``sampling`` range: device ms,
    launches and Gumbel launches a step; ``paged_attention_profile``:
    every paged row's device us a call of its pre-pass, main kernel and
    combine, and device launches a call; ``gumbel_perturb_profile``: the
    keyed and uniform kernels' device us a call and the parent's path's
    (every kernel it launches);
    ``flash_attention_profile``: every flash row's device us a call, and
    SDPA's on the same inputs, by kernel name;
    ``decode_attention_profile``: every decode row's device us a call of
    its main kernel and combine, and SDPA's; ``mixed_attention_profile``:
    mixed rows (a), (b) and (e), pre-pass, main kernel and combine;
    ``rwkv6_scan_profile``: the WKV6 rows' device us a call;
    ``mamba_scan_profile``: the Mamba rows' device us a launch, device
    launches a call and waves; ``fused_elementwise_profile``: the fused
    rows' device us a call), ``lm_train_profile`` (one gemma-2b train
    step: device ms of matmul, flash forward, flash backward, loss,
    optimizer and the rest; idle share, peak memory; the flash
    backward's ms and memory alone) and ``gnmt_train_profile`` (one GNMT step:
    device time by kernel group, idle share), last,
    because a profiler session slows the host for the timed runs after
    it;
  * ``{"kernels": [...]}``: every ported kernel with its launches in its
    path's main run (wrapper calls; the paged, decode and mixed entries
    add their variant, and those, the Gumbel (keyed) and the WKV6 entry
    the device launches and device us of one call of the reported row, as
    ``paged_attention_profile``, ``gumbel_perturb_profile``,
    ``flash_attention_profile``, ``decode_attention_profile``,
    ``mixed_attention_profile``, ``rwkv6_scan_profile``,
    ``mamba_scan_profile`` and ``fused_elementwise_profile`` counted
    them; bf16 serving for paged
    attention and Gumbel, dense
    prefill for flash, dense decode for decode attention, rwkv prefill
    for WKV6, jamba prefill for the Mamba scan, eager_train for the
    fused-elementwise kernel, paged_vs_gathered for mixed attention;
    the flash entry adds ``lm_train``'s launches and each meshed train
    rank's (``sharded_train_launches``), the decode entry each meshed
    decode rank's (``sharded_decode_launches``) and the lse rows, the
    flash and decode entries each new arch's run's, ``arch_launches``)
    and its numbers at that path's shapes;
  * last, ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no
last line.  Without CUDA, or without the repository beside it, it exits
non-zero at once.  It imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import bisect
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
# dense peaks (H100 SXM data sheet): bf16 tensor cores, fp32 CUDA cores,
# and fp32 in 3xTF32 on the tensor cores (three TF32 products at 494.7
# TFLOP/s for each fp32 product: the fp32 flash kernel's work)
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12, "tf32x3": 494.7e12 / 3}
# paged attention: max abs error by q dtype.  bf16 q: the plain version
# rounds dequantized pages and probabilities to bf16 while the kernel
# stays in fp32, so the two differ by bf16 rounding of O(1) outputs.
PAGED_TOL = {"bfloat16": 1e-2, "float32": 1e-5}
# (q dtype, pool dtype): the first three are what the serving runs launch
# (bf16 weights with a bf16 or an int8 pool, fp32 weights with an fp32
# pool); the first is the main path's.
PAGED_CASES = (("bfloat16", "bfloat16"), ("bfloat16", "int8"),
               ("float32", "float32"), ("float32", "int8"),
               ("float32", "fp8_e4m3"))
GUMBEL_TOL = 1e-4                  # fp32 logs of values up to ~20 in size
# the Gumbel rows: serving's sampling step (MAX_BATCH x (SPEC_K + 1) rows
# of gemma-2b's 256000 logits), and ragged (R, V) for the keyed kernel's
# masked tile edges
GUMBEL_SHAPE = (48, 256000)
GUMBEL_RAGGED = ((1, 1000), (1, 256001), (3, 1000), (3, 256001))
# flash / decode attention against their plain versions, elementwise
# |out - ref| <= tol + rtol * |ref|.  bf16: tol = rtol = 1e-2 (what
# torch.testing.assert_close(rtol=1e-2, atol=1e-2) checks).  The kernel
# rounds the unnormalised probabilities to bf16 and the plain version
# the normalised ones, as the Pallas kernel and the jnp oracle do, so
# the two differ by about one bf16 rounding of the output: up to 0.0156
# for causal rows that average a few N(0, 1) values of magnitude 2-4.
# fp32: tol 1e-5, or 2e-3 for the long reductions (Skv >= 1024), rtol 0:
# the reference's tiers (docs/kernels.md).
ATTN_BF16_TOL = 1e-2
# (label, dtype, B, Hq, Hkv, Sq, Skv, D, window); causal but for the
# rows of FLASH_BIDIRECTIONAL.  The first row is gemma-2b prefill of (4,
# 1024) tokens, the dense_prefill shape; "jamba" is jamba's attention
# layer in jamba_prefill (64 query heads over 8 KV heads of 128);
# "parity" and "jamba_parity" are the fp32 prefills of dense_parity and
# jamba_parity (PARITY_SHAPE).  The rest are the layers of the seven
# architectures' prefills: gemma3's sliding layers (window 512), hubert's
# bidirectional 16 heads of 80 and minicpm3's MLA (q/k 96, v 64), both
# run padded to 128 (models.attention.padded_call, so the kernel sees
# 128), yi / arctic's 56 heads over 8 (G = 7), qwen2-moe's 16 over 16,
# and the fp32 prefills of gemma3_parity (window GEMMA3_PARITY_WINDOW)
# and minicpm3_parity.
FLASH_ROWS = (("prefill", "bfloat16", 4, 8, 1, 1024, 1024, 256, None),
              ("offset_window", "bfloat16", 4, 8, 1, 384, 1024, 256, 256),
              ("fp32", "float32", 4, 8, 1, 256, 256, 256, None),
              ("jamba", "bfloat16", 4, 64, 8, 1024, 1024, 128, None),
              ("parity", "float32", 2, 8, 1, 160, 160, 256, None),
              ("jamba_parity", "float32", 2, 64, 8, 160, 160, 128, None),
              ("gemma3_sliding", "bfloat16", 4, 4, 1, 1024, 1024, 256,
               512),
              ("hubert_padded", "bfloat16", 4, 16, 16, 1024, 1024, 128,
               None),
              ("minicpm3_mla_padded", "bfloat16", 4, 40, 40, 1024, 1024,
               128, None),
              ("yi_g7", "bfloat16", 4, 56, 8, 1024, 1024, 128, None),
              ("qwen2_moe_g1", "bfloat16", 4, 16, 16, 1024, 1024, 128,
               None),
              ("gemma3_parity", "float32", 2, 4, 1, 160, 160, 256, 64),
              ("minicpm3_parity", "float32", 2, 40, 40, 160, 160, 128,
               None))
FLASH_BIDIRECTIONAL = frozenset({"hubert_padded"})
# (label, dtype, B, Hkv, G, D, Smax, window); lengths ragged in 1..Smax.
# The first row is gemma-2b decode at B = 8, "jamba" jamba's attention
# layer at B = 8; "parity" and "jamba_parity" are the fp32 decode steps
# of dense_parity and jamba_parity (B = 2, caches of PARITY_SHAPE's 160
# keys).  The rest are the decode layers of the seven architectures'
# ARCH_DECODE runs: a gemma3 ring of 512 slots (no window: the ring is
# the window), yi / arctic's G = 7, qwen2-moe's G = 1 and minicpm3's MLA
# after expansion (G = 1, padded to 128) over ARCH_DECODE_MAX_SEQ keys,
# and the fp32 decode steps of gemma3_parity (a ring of
# GEMMA3_PARITY_WINDOW slots) and minicpm3_parity.
DECODE_ROWS = (("decode", "bfloat16", 8, 1, 8, 256, 2048, None),
               ("fp32", "float32", 8, 1, 8, 256, 2048, None),
               ("window", "bfloat16", 8, 1, 8, 256, 2048, 256),
               ("jamba", "bfloat16", 8, 8, 8, 128, 2048, None),
               ("parity", "float32", 2, 1, 8, 256, 160, None),
               ("jamba_parity", "float32", 2, 8, 8, 128, 160, None),
               ("gemma3_ring", "bfloat16", 8, 1, 4, 256, 512, None),
               ("yi_g7", "bfloat16", 8, 8, 7, 128, 1040, None),
               ("qwen2_moe_g1", "bfloat16", 8, 16, 1, 128, 1040, None),
               ("minicpm3_mla_padded", "bfloat16", 8, 40, 1, 128, 1040,
                None),
               ("gemma3_parity", "float32", 2, 1, 4, 256, 64, None),
               ("minicpm3_parity", "float32", 2, 40, 1, 128, 160, None))
# dense path: prefill (4, 1024); decode B = 8, 128-token prompts fed one
# token a step, then 64 greedy tokens; parity on (2, 160) at fp32
PREFILL_SHAPE = (4, 1024)
DECODE_BATCH, DECODE_MAX_SEQ, DECODE_PROMPT, DECODE_NEW = 8, 1024, 128, 64
PARITY_SHAPE = (2, 160)
PARITY_RTOL = 5e-3                 # of the logits' RMS (rollout_parity)
# WKV6 against its plain version: (label, dtype, B, H, S, D, with a
# state0, decays).  The first row is the rwkv_prefill shape (rwkv6-1.6b,
# 4 x 1024 tokens) with the model's decays: exp(-exp(-6 + N(0, 0.5^2)))
# rounded to bf16, many exactly 1.0, so the state grows over the sweep;
# the others take the reference tests' decays sigmoid(N(0, 1)) * 0.5 +
# 0.45.  Tolerances: kernel_tol (fp32 1e-5, 2e-3 for S >= 1024; bf16
# 1e-2 + 1e-2 |ref|: both round one fp32 sum, a tie can fall one bf16
# step apart).
RWKV6_ROWS = (("prefill", "bfloat16", 4, 32, 1024, 64, False, "model"),
              ("decode", "bfloat16", 8, 32, 1, 64, True, "test"),
              ("fp32_state", "float32", 4, 32, 256, 64, True, "test"))
# fp32 operations per state element a step: r*S, k*v and the decay FMA
# (the bonus term is a per-step scalar, v_j * sum_i r_i u_i k_i)
WKV6_OPS = 5
# The Mamba scan against its plain version: (label, dtype, B, S, Di, N,
# with an h0, B/C as column views of a (B, S, R + 2N) projection).  The
# first row is the jamba_prefill shape (jamba-1.5-large, 4 x 1024 tokens,
# d_inner 16384, d_state 16), the second a jamba_decode step from the
# cached state, the third an fp32 row whose S is not a multiple of the
# kernel's 16-step chunk, the fourth the prefill shape with B and C read
# through the layer's strides (R = dt_rank = 512).  Inputs follow the
# reference tests: x, B, C ~ N(0, 0.5^2), dt = softplus(N(0, 1)) * 0.1,
# A = -exp(N(0, 1)), D = 1.  Tolerances: kernel_tol.
MAMBA_ROWS = (("prefill", "bfloat16", 4, 1024, 16384, 16, False, False),
              ("decode", "bfloat16", 8, 1, 16384, 16, True, False),
              ("fp32_state_ragged", "float32", 2, 200, 16384, 16, True,
               False),
              ("strided_bc", "bfloat16", 4, 1024, 16384, 16, False, True))
MAMBA_DT_RANK = 512
# fp32 operations per state element a step: dt*A, exp, the state FMA
# (2), B*(dt*x), the C FMA (2)
MAMBA_OPS = 7
# exp evaluations a second on the SFUs: 132 SMs x 16 a clock x 1.98 GHz
# (H100 SXM data sheet boost clock), the floor of one exp per state
# element per step
SFU_EXP_PER_S = 132 * 16 * 1.98e9
# jamba-1.5-large: the first 5 layers at bf16 (48.1 GB) for prefill and
# decode; for the fp32 parity check two layers of its 8-layer period,
# mamba/moe and attn/dense (47.6 GB), so that the check holds the Mamba
# scan, the MoE and the attention in prefill against decode
JAMBA_LAYERS = 5
JAMBA_PARITY_PATTERN = (("mamba", "moe"), ("attn", "dense"))
# the seven architectures of the configs registry that have no path
# above: (phase prefix, arch, layers run or None for all).  Each at full
# width, made at bf16 from seed 0 on the card, freed before the next;
# arctic-480b is cut to 2 of its 35 layers (27.3 GB a layer, 128 experts
# of 3 x 7168 x 4864).  <prefix>_prefill: make_prefill_step on
# PREFILL_SHAPE tokens (hubert and llava: embeddings); <prefix>_decode
# (not hubert, an encoder): make_serve_step at B = ARCH_DECODE_BATCH,
# ARCH_DECODE_STEPS greedy steps past a cache of ARCH_DECODE_PAST
# positions filled with N(0, 1) values from a seed
ARCH_PHASES = (("gemma3", "gemma3-1b", None),
               ("qwen2_moe", "qwen2-moe-a2.7b", None),
               ("minicpm3", "minicpm3-4b", None),
               ("llava", "llava-next-mistral-7b", None),
               ("hubert", "hubert-xlarge", None),
               ("yi", "yi-34b", None),
               ("arctic", "arctic-480b", 2))
ARCH_DECODE_BATCH, ARCH_DECODE_PAST, ARCH_DECODE_STEPS = 8, 1024, 16
ARCH_DECODE_MAX_SEQ = ARCH_DECODE_PAST + ARCH_DECODE_STEPS
# gemma3_parity: full width, one 6-layer group and the 2-layer tail, the
# window cut to 64 so that the 160-step rollout wraps each ring twice;
# minicpm3_parity: full width, 2 layers (S = 160, where the reference's
# own MLA prefill raises under "auto")
GEMMA3_PARITY_LAYERS, GEMMA3_PARITY_WINDOW = 8, 64
MINICPM3_PARITY_LAYERS = 2
# head-width padding (models.attention.padded_call), each case at its
# main-path shape: (label, dtype, B, Hq, Hkv, Sq, Skv, D_qk, D_v, causal)
PADDING_ROWS = (("hubert_prefill", "bfloat16", 4, 16, 16, 1024, 1024, 80,
                 80, False),
                ("minicpm3_prefill", "bfloat16", 4, 40, 40, 1024, 1024, 96,
                 64, True),
                ("minicpm3_decode", "bfloat16", 8, 40, 40, 1, 1040, 96, 64,
                 True))
# LM training.  lm_train: gemma-2b CONFIG at full width and depth (bf16,
# remat "full") through train_loop, AdamW at the reference's lr and clip,
# 10 steps of 4 x 1024 tokens; data_loader stages LOADER_BATCHES batches
# of that shape
LM_TRAIN_SHAPE = (4, 1024)
LM_TRAIN_STEPS = 10
LM_TRAIN_LR = 3e-4
LOADER_BATCHES = 32
# lm_train_parity: fp32 SMOKE models (remat "full") on the card against
# the same code on the CPU: one loss and its gradients, then SGD steps on
# one repeated (4, 64) batch
LM_PARITY_SHAPE = (4, 64)
LM_PARITY_LR = 0.1
LM_PARITY_TOL = {"loss": 1e-5, "grads": 1e-4, "steps": 1e-4}
LM_PARITY_STEPS = 20
# the least fall of the loss over LM_PARITY_STEPS SGD steps: half of the
# fall the same steps give on the CPU (gemma 0.5942, jamba 2.6145, rwkv6
# 3.1302, from 5.5542 / 5.4101 / 5.3061; PERF.md §5)
LM_PARITY_FALL = {"gemma": 0.2971, "jamba": 1.3072, "rwkv6": 1.5651}

# gemma-2b serving shapes
PAGE_SIZE = 16
MAX_BATCH = 16
SPEC_K = 2
NEW_TOKENS = 32
TOKEN_BUDGET = 512
CHUNK = 256


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` single-call CUDA-event timings."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def time_ms_stream(torch, fn, calls: int = 20, warmup: int = 3) -> float:
    """Mean device ms of one call over ``calls`` calls queued back to
    back between two CUDA events: with the queue kept full the host's
    launch overhead is hidden, which single-call events (``time_ms``)
    include when a kernel is shorter than its launch."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def peak_gb(torch) -> float:
    """Peak device memory allocated since the last reset, in GB."""
    return torch.cuda.max_memory_allocated() / 1e9


# ----------------------------------------------------------------------
# kernel phases
# ----------------------------------------------------------------------

def paged_inputs(torch, gen, dev, t_bucket: int = 256):
    """A mixed prefill/decode flat batch at gemma-2b attention shapes:
    Hkv=1, G=8, D=256, ps=16, 16 slots whose sequences hold 128-1024
    tokens; two slots run a prefill chunk, the rest one decode token
    each, and the bucket tail is padding."""
    hkv, g, d, ps, s = 1, 8, 256, PAGE_SIZE, MAX_BATCH
    lens = torch.randint(128, 1025, (s,), generator=gen).tolist()
    p = 64                                      # pages bucket (1024/16)
    n_pages = s * p + 8
    perm = torch.randperm(n_pages, generator=gen)[: s * p].reshape(s, p)
    tables = perm.to(torch.int32)
    seg, pos = [], []
    for slot in range(s):
        if slot < 2:
            chunk = 100
            seg += [slot] * chunk
            pos += list(range(lens[slot] - chunk, lens[slot]))
        else:
            seg.append(slot)
            pos.append(lens[slot] - 1)
    n_live = len(seg)
    seg += [-1] * (t_bucket - n_live)
    pos += [0] * (t_bucket - n_live)
    k32 = torch.randn((n_pages, ps, hkv, d), generator=gen)
    v32 = torch.randn((n_pages, ps, hkv, d), generator=gen)
    q32 = torch.randn((t_bucket, hkv, g, d), generator=gen)
    return dict(q32=q32.to(dev), k32=k32.to(dev), v32=v32.to(dev),
                tables=tables.to(dev),
                seg=torch.tensor(seg, dtype=torch.int32, device=dev),
                pos=torch.tensor(pos, dtype=torch.int32, device=dev),
                n_live=n_live, ps=ps, p=p)


def paged_bound(x, q, pool_itemsize: int, quantized: bool,
                peak: float) -> tuple:
    """Least time for this call: every input byte read once (live pages
    only: the work depends on the positions), the output written once;
    operations 4*G*D per live (token, key) pair."""
    ps = x["ps"]
    tables = x["tables"].cpu()
    seg = x["seg"].cpu().tolist()
    pos = x["pos"].cpu().tolist()
    t, hkv, g, d = q.shape
    live_pages, keys = set(), 0
    for slot, p_t in zip(seg, pos):
        slot = min(max(slot, 0), tables.shape[0] - 1)
        for pi in range(min(p_t // ps, tables.shape[1] - 1) + 1):
            live_pages.add(int(tables[slot, pi]))
        keys += p_t + 1
    page_bytes = ps * hkv * d * pool_itemsize * 2
    if quantized:
        page_bytes += ps * hkv * 4 * 2
    nbytes = (2 * q.numel() * q.element_size() + len(live_pages) * page_bytes
              + tables.numel() * 4 + 2 * t * 4)
    ops = 4 * keys * hkv * g * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def sdpa_library_ms(torch, x, q, kp, vp, scale) -> float:
    """One PyTorch call computing the same attention on the same inputs:
    SDPA over the per-token gathered contiguous cache (gathered outside
    the timed call).  A yardstick only; the port never calls it."""
    import torch.nn.functional as F
    ps, p = x["ps"], x["p"]
    t, hkv, g, d = q.shape
    s = x["tables"].shape[0]
    slot = x["seg"].long().clamp(0, s - 1)
    gidx = (x["tables"].long()[:, :, None] * ps
            + torch.arange(ps, device=q.device)).reshape(s, p * ps)[slot]
    kc = kp.reshape(-1, hkv, d)[gidx].permute(0, 2, 1, 3).contiguous()
    vc = vp.reshape(-1, hkv, d)[gidx].permute(0, 2, 1, 3).contiguous()
    k_pos = torch.arange(p * ps, device=q.device)
    mask = (k_pos[None, :] <= x["pos"].long()[:, None])[:, None, None, :]
    qq = q.reshape(t, hkv * g, 1, d)
    return time_ms(torch, lambda: F.scaled_dot_product_attention(
        qq, kc, vc, attn_mask=mask, scale=scale, enable_gqa=True))


def paged_plan(torch, DA, x, q, pool_dtype) -> dict:
    """What the paged kernel launched for the row's inputs (call it just
    after a call): its main kernel's variant and resources
    (``DA.kernel_attributes``), the device launches and thread blocks of
    that call as the C entry reports them (``DA.last_launch``), and the
    work list (tiles, splits) of the device pre-pass, which must equal
    ``paged_tiles_plain``'s."""
    t, hkv, g, d = q.shape
    ps, p = x["ps"], x["p"]
    plan = {**DA.kernel_attributes(q.dtype, pool_dtype, d),
            **DA.last_launch()}
    tiling = DA.tiling(g, p, ps)
    want = DA.paged_tiles_plain(x["seg"].cpu(), x["pos"].cpu(),
                                x["tables"].shape, ps,
                                tiling["tile_tokens"], tiling["split_keys"])
    got = DA.paged_tiles(x["seg"], x["pos"], x["tables"].shape, ps, g)
    return {**plan, **worklist_check(torch, "paged_attention", tiling, want,
                                     got)}


def worklist_check(torch, name: str, tiling: dict, want, got) -> dict:
    """The device pre-pass's work list ``got`` must equal the plain one,
    ``want``; returns the tiling and the list's tiles and splits."""
    if not torch.equal(got.cpu(), want):
        raise AssertionError(f"{name}: the device pre-pass's work list "
                             f"differs from the plain one")
    return {"tile_tokens": tiling["tile_tokens"],
            "split_keys": tiling["split_keys"], "tiles": len(want),
            "splits": int(want[:, 5].sum()),
            "max_splits": int(want[:, 5].max()),
            "worklist_equals_plain": True}


def paged_case_tensors(torch, x, q_dtype, pool):
    """q and the pool (with scales for int8 / fp8) of one PAGED_CASES
    row."""
    from repro_torch.serving import quant
    q = x["q32"].to(getattr(torch, q_dtype))
    if pool in ("bfloat16", "float32"):
        return (q, x["k32"].to(getattr(torch, pool)),
                x["v32"].to(getattr(torch, pool)), None, None)
    kp, ksc = quant.quantize(x["k32"], pool)
    vp, vsc = quant.quantize(x["v32"], pool)
    return q, kp, vp, ksc, vsc


def phase_paged_attention(torch, dev) -> dict:
    """The paged kernel against its plain version for every PAGED_CASES
    row; the first (bf16 q over a bf16 pool) is the one reported in the
    kernel table.  Each row carries its main kernel's variant ("mma":
    bf16 q on the tensor cores; "simt": fp32 q on the CUDA cores), its
    work list (tiles, splits), the device launches and thread blocks of a
    call and its main kernel's resources; ``ms`` is a single call by CUDA events (the
    wrapper's host time included), ``queued_ms`` the time of one call
    among 20 queued back to back (the host's time still counts where it
    exceeds the device's; ``profile_paged`` gives the device's alone)."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.serving import quant

    gen = torch.Generator().manual_seed(11)
    x = paged_inputs(torch, gen, dev)
    scale = 256 ** -0.5
    live = x["seg"] >= 0
    result = None
    for q_dtype, pool in PAGED_CASES:
        q, kp, vp, ksc, vsc = paged_case_tensors(torch, x, q_dtype, pool)

        def kern():
            return DA.paged_attention_fwd(
                q, kp, vp, x["tables"], x["seg"], x["pos"], scale=scale,
                k_scale=ksc, v_scale=vsc)

        def plain():
            return DA.paged_attention_plain(
                q, kp, vp, x["tables"], x["seg"], x["pos"], scale=scale,
                k_scale=ksc, v_scale=vsc)

        out = kern()
        torch.cuda.synchronize()
        ref = plain()
        err = (out[live].float() - ref[live].float()).abs().max().item()
        ref_rms = ref[live].float().pow(2).mean().sqrt().item()
        finite = bool(torch.isfinite(out[live].float()).all())
        tol = PAGED_TOL[q_dtype]
        ms = time_ms(torch, kern)
        queued_ms = time_ms_stream(torch, kern)
        plain_ms = time_ms(torch, plain, reps=5)
        peak = PEAK_OPS["bfloat16" if q.dtype == torch.bfloat16
                        else "float32"]
        bound_ms, bound_by = paged_bound(x, q, kp.element_size(),
                                         ksc is not None, peak)
        lib_ms = sdpa_library_ms(
            torch, x, q, kp if ksc is None else
            quant.dequantize(kp, ksc).to(q.dtype),
            vp if vsc is None else quant.dequantize(vp, vsc).to(q.dtype),
            scale)
        row = {"phase": "kernel", "name": "paged_attention", "pool": pool,
               "q_dtype": str(q.dtype).split(".")[-1],
               "T": int(q.shape[0]), "live_tokens": x["n_live"],
               "max_abs_err": err, "tol": tol, "ref_rms": ref_rms,
               "max_err_over_ref_rms": err / ref_rms, "ms": ms,
               "queued_ms": queued_ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": lib_ms}
        kern()
        row.update(paged_plan(torch, DA, x, q, kp.dtype))
        emit(row)
        if not finite or not err <= tol:
            raise AssertionError(f"paged_attention[q {q_dtype}, pool {pool}]"
                                 f" disagrees with its plain version: {err}")
        if result is None:
            result = row
    return result


def window_pad(session: int) -> float:
    """Seconds of host idle time on each side of a profiler cycle's
    window in session ``session`` (0, 1, ...): 0.05 s, growing fourfold
    a session up to 2 s."""
    return min(2.0, 0.05 * 4 ** session)


def profile_kernels(torch, kern, counter, group, want,
                    part=lambda name: name, calls: int = 20,
                    tries: int = 4) -> dict:
    """``calls`` counted calls of ``kern`` under ``torch.profiler``: the
    device us a call and device launches a call of each kernel of
    ``group`` (every kernel when it is None; keyed by ``part(name)``) and
    in all, as the profiler counted them.  The counted calls are the
    profiler's second cycle: the first, a warm-up, is dropped (a
    session's first kernels can go unrecorded).

    The profiler keeps a device record only where its timestamp, mapped
    onto the host's clock, falls inside the counted cycle's window, the
    host time between the two ``prof.step()`` calls that open and close
    it.  Where the device's clock has drifted from the host's, records
    fall out of the window (none, or fewer than were launched) or the
    warm-up's fall into it (more).  So the host idles ``window_pad``
    seconds after the warm-up's kernels end and before the window
    opens, after it opens and before the counted calls, and after their
    kernels end and before it closes: a drift smaller than the pad
    leaves every counted record inside and every warm-up record outside.

    A session that counted other than ``want`` device launches a call
    (the C entry's record; None asks for at least one launch) is run
    again with a wider pad, up to ``tries`` sessions.  Every session's
    pad, launches and device us a call are kept in ``sessions`` beside
    the last one's, which is reported; ``first_session_agrees`` flags a
    first session that differed.  Raises when no session agrees with the
    C record."""
    from torch.profiler import ProfilerActivity, profile, schedule
    sessions = []
    for session in range(tries):
        pad = window_pad(session)
        cycles = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1),
                     on_trace_ready=lambda p: cycles.append(
                         device_time(p)[1])) as prof:
            for cycle in range(2):
                if cycle:
                    time.sleep(pad)
                before = counter.launches
                for _ in range(calls):
                    kern()
                torch.cuda.synchronize()
                time.sleep(pad)
                prof.step()
        n = counter.launches - before
        (top,) = cycles
        kernels = {}
        for ms, name, c in top:
            if group is None or _kernel_group(name) == group:
                k = kernels.setdefault(part(name), {"device_us_per_call": 0.0,
                                                    "launches_per_call": 0.0})
                k["device_us_per_call"] += ms * 1e3 / n
                k["launches_per_call"] += c / n
        sessions.append({
            "window_pad_s": pad,
            "device_launches_per_call": sum(
                k["launches_per_call"] for k in kernels.values()),
            "device_us_per_call": sum(
                k["device_us_per_call"] for k in kernels.values())})
        launches = sessions[-1]["device_launches_per_call"]
        if (launches > 0 if want is None else abs(launches - want) < 1e-9):
            break
    else:
        raise AssertionError(
            f"{group}: no profiler session counted the C entry's "
            f"{'one or more' if want is None else want} device launches a "
            f"call: {sessions}")
    return {"calls": n, "c_record_launches_per_call": want,
            "sessions": sessions,
            "first_session_agrees": len(sessions) == 1,
            **sessions[-1], "kernels": kernels}


def profile_paged(torch, dev) -> dict:
    """Every PAGED_CASES row (``paged_inputs``, seed 11) under
    ``profile_kernels``: the device us a call of its pre-pass, main
    kernel and combine and in all, and the device launches a call.  Run
    with the profiled runs, last.  Returns the bf16 x bf16 line."""
    from repro_torch.kernels import decode_attention as DA

    x = paged_inputs(torch, torch.Generator().manual_seed(11), dev)
    result = None
    for q_dtype, pool in PAGED_CASES:
        q, kp, vp, ksc, vsc = paged_case_tensors(torch, x, q_dtype, pool)

        def kern():
            return DA.paged_attention_fwd(
                q, kp, vp, x["tables"], x["seg"], x["pos"],
                scale=256 ** -0.5, k_scale=ksc, v_scale=vsc)
        kern()
        torch.cuda.synchronize()
        row = {"phase": "paged_attention_profile", "pool": pool,
               "q_dtype": q_dtype, "variant": DA.variant(q.dtype),
               **profile_kernels(torch, kern, DA.counter, "paged_attention",
                                 DA.last_launch()["device_launches"],
                                 part=kernel_part)}
        emit(row)
        if result is None:
            result = row
    return result


def gumbel_inputs(torch, dev, rows: int, vocab: int, seed: int = 12):
    """Logits ~ N(0, 3^2) of (rows, vocab) and (rows,) seeds and
    positions, as the serving executor keys a step's rows."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    logits = torch.randn((rows, vocab), generator=gen, device=dev) * 3.0
    seeds = torch.arange(rows, device=dev)
    return logits, seeds, seeds + 100


def gumbel_bound(rows: int, vocab: int, keyed: bool) -> float:
    """ms to move a Gumbel call's bytes once: the keyed kernel reads the
    fp32 (rows, vocab) logits and (rows,) int64 seeds and positions and
    writes the result; the uniform kernel reads the uniforms too."""
    nbytes = (2 * rows * vocab * 4 + 2 * rows * 8 if keyed
              else 3 * rows * vocab * 4)
    return nbytes / HBM_BYTES_PER_S * 1e3


def gumbel_check(torch, name: str, out, ref) -> float:
    """The max abs error of a Gumbel kernel against its plain version;
    raises past GUMBEL_TOL, on a non-finite value, or where a row's
    argmax (the sampled token) differs."""
    err = (out - ref).abs().max().item()
    if not err <= GUMBEL_TOL or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{err}")
    if not torch.equal(out.argmax(-1), ref.argmax(-1)):
        raise AssertionError(f"{name}: a row's argmax differs from the "
                             f"plain version's")
    return err


def phase_gumbel(torch, dev) -> dict:
    """The Gumbel kernels against their plain versions at serving's
    sampling shape (GUMBEL_SHAPE): the keyed kernel, which the serving
    path runs (its ``plain_ms`` is ``gumbel_perturb_keyed_plain``, the
    position-keyed uniforms then the perturbation in torch ops;
    ``composition_ms`` the parent's serving path, the uniforms in torch
    ops then the uniform kernel), and the uniform kernel; each with its
    bytes bound, and the keyed kernel at ragged shapes
    (GUMBEL_RAGGED).  Returns the keyed row, the kernel table's."""
    from repro_torch.kernels import ops
    from repro_torch.serving.sampling import position_uniforms

    rows, vocab = GUMBEL_SHAPE
    logits, seeds, pos = gumbel_inputs(torch, dev, rows, vocab)
    u = position_uniforms(seeds, pos, vocab)
    out = ops.gumbel_perturb(logits, u)
    torch.cuda.synchronize()
    err = gumbel_check(torch, "gumbel_perturb", out,
                       ops.gumbel_perturb_plain(logits, u))
    emit({"phase": "kernel", "name": "gumbel_perturb", "entry": "uniform",
          "R": rows, "V": vocab, "max_abs_err": err, "tol": GUMBEL_TOL,
          "ms": time_ms(torch, lambda: ops.gumbel_perturb(logits, u)),
          "plain_ms": time_ms(
              torch, lambda: ops.gumbel_perturb_plain(logits, u)),
          "bound_ms": gumbel_bound(rows, vocab, keyed=False),
          "bound_by": "bytes",
          "library_ms": None})
    del u

    ragged = []
    for r, v in GUMBEL_RAGGED:
        x, sd, ps = gumbel_inputs(torch, dev, r, v, seed=13)
        got = ops.gumbel_perturb_keyed(x, sd, ps)
        torch.cuda.synchronize()
        ragged.append({"R": r, "V": v, "max_abs_err": gumbel_check(
            torch, f"gumbel_perturb_keyed[{r}x{v}]", got,
            ops.gumbel_perturb_keyed_plain(x, sd, ps))})

    def keyed():
        return ops.gumbel_perturb_keyed(logits, seeds, pos)

    out = keyed()
    torch.cuda.synchronize()
    err = gumbel_check(torch, "gumbel_perturb_keyed", out,
                       ops.gumbel_perturb_keyed_plain(logits, seeds, pos))
    row = {"phase": "kernel", "name": "gumbel_perturb", "entry": "keyed",
           "R": rows, "V": vocab, "max_abs_err": err, "tol": GUMBEL_TOL,
           "argmax_equal": True, "ragged": ragged,
           "ms": time_ms(torch, keyed), "host_us": host_us(torch, keyed),
           "plain_ms": time_ms(torch, lambda: ops.gumbel_perturb_keyed_plain(
               logits, seeds, pos)),
           "composition_ms": time_ms(torch, lambda: ops.gumbel_perturb(
               logits, position_uniforms(seeds, pos, vocab))),
           "bound_ms": gumbel_bound(rows, vocab, keyed=True),
           "bound_by": "bytes",
           "library_ms": None}
    emit(row)
    return row


def profile_gumbel(torch, dev) -> dict:
    """At GUMBEL_SHAPE, under ``profile_kernels``: the keyed kernel and
    the uniform kernel (one launch a call each), and the parent's serving
    path, ``position_uniforms`` then the uniform kernel (every kernel it
    launches).  Run with the profiled runs, last.  Returns the keyed
    kernel's line."""
    from repro_torch.kernels import ops
    from repro_torch.serving.sampling import position_uniforms

    rows, vocab = GUMBEL_SHAPE
    logits, seeds, pos = gumbel_inputs(torch, dev, rows, vocab)
    u = position_uniforms(seeds, pos, vocab)
    result = None
    for entry, fn, group, want in (
            ("keyed", lambda: ops.gumbel_perturb_keyed(logits, seeds, pos),
             "gumbel_perturb", 1),
            ("uniform", lambda: ops.gumbel_perturb(logits, u),
             "gumbel_perturb", 1),
            ("composition", lambda: ops.gumbel_perturb(
                logits, position_uniforms(seeds, pos, vocab)), None, None)):
        fn()
        torch.cuda.synchronize()
        row = {"phase": "gumbel_perturb_profile", "entry": entry, "R": rows,
               "V": vocab, **profile_kernels(torch, fn, ops.gumbel_counter,
                                             group, want)}
        emit(row)
        if result is None:
            result = row
    return result


def kernel_bound(nbytes: int, ops: int, rule: str) -> tuple:
    """(ms, "bytes" or "operations"): the larger of ``nbytes`` at the
    memory rate and ``ops`` at ``PEAK_OPS[rule]``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[rule]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_tol(dtype: str, skv: int) -> tuple:
    """(tol, rtol) of a flash, decode or WKV6 row; ``skv`` is the length
    of the reduction (keys, or steps of the recurrence)."""
    if dtype == "bfloat16":
        return ATTN_BF16_TOL, ATTN_BF16_TOL
    return (2e-3 if skv >= 1024 else 1e-5), 0.0


def check_row(torch, name: str, out, ref, tol: tuple) -> dict:
    atol, rtol = tol
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    worst = (diff / (atol + rtol * ref.float().abs())).max().item()
    ref_rms = ref.float().pow(2).mean().sqrt().item()
    if not bool(torch.isfinite(out.float()).all()) or not worst <= 1.0:
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"max abs error {err}, {worst} x its limit "
                             f"(tol {atol}, rtol {rtol})")
    return {"max_abs_err": err, "tol": atol, "rtol": rtol,
            "err_over_limit": worst, "ref_rms": ref_rms,
            "max_err_over_ref_rms": err / ref_rms}


def phase_flash(torch, dev) -> dict:
    """The flash kernel against its plain version; the first row is the
    dense_prefill shape and is the one reported in the kernel table.
    Each row carries the resources of the kernel it ran (variant "mma"
    for bf16, "tf32x3" for fp32 in three TF32 products, both on the
    tensor cores; registers, spill bytes, shared memory, blocks per SM)
    and its bound's rule (``bound_rule``, a ``PEAK_OPS`` key); fp32 rows
    also carry the bound at the fp32 CUDA-core rate
    (``bound_ms_float32``), the parent kernel's.  ``profile_flash`` gives
    the device us of each row and of SDPA."""
    from repro_torch.kernels import flash_attention as FA

    result = None
    for row_spec in FLASH_ROWS:
        label, dt, b, hq, hkv, sq, skv, d, window = row_spec
        dtype = getattr(torch, dt)
        q, k, v, kw = flash_inputs(torch, dev, row_spec)
        out = FA.flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        ref = FA.flash_attention_plain(q, k, v, **kw)
        row = {"phase": "kernel", "name": "flash_attention", "row": label,
               "dtype": dt, "B": b, "Hq": hq, "Hkv": hkv, "Sq": sq,
               "Skv": skv, "D": d, "window": window, "causal": kw["causal"]}
        row.update(check_row(torch, f"flash_attention[{label}]", out, ref,
                             kernel_tol(dt, skv)))
        row.update(FA.kernel_attributes(dtype, d))
        row["ms"] = time_ms(torch, lambda: FA.flash_attention_fwd(q, k, v,
                                                                  **kw))
        row["plain_ms"] = time_ms(
            torch, lambda: FA.flash_attention_plain(q, k, v, **kw), reps=5)
        mask = FA.visible_mask(sq, skv, kw["causal"], window, dev)
        pairs = int(mask.sum().item())
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        ops = 4 * pairs * d * b * hq
        row["bound_rule"] = "tf32x3" if dt == "float32" else dt
        row["bound_ms"], row["bound_by"] = kernel_bound(nbytes, ops,
                                                        row["bound_rule"])
        if dt == "float32":
            row["bound_ms_float32"] = kernel_bound(nbytes, ops, dt)[0]
        row["library_ms"] = time_ms(torch, flash_library(
            torch, q, k, v, (b, hq, hkv, sq, skv, d), window, mask,
            kw["causal"]))
        emit(row)
        if result is None:
            result = row
    return result


def flash_library(torch, q, k, v, shape, window, mask, causal=True):
    """The yardstick of a FLASH_ROWS row: one SDPA call over K/V expanded
    to Hq (expanded here, outside any timed call); the port never calls
    it."""
    import torch.nn.functional as F
    b, hq, hkv, sq, skv, d = shape
    q4 = q.reshape(b, hq, sq, d)
    k4 = k.reshape(b, hkv, 1, skv, d).expand(b, hkv, hq // hkv, skv,
                                             d).reshape(b, hq, skv, d)
    v4 = v.reshape(b, hkv, 1, skv, d).expand(b, hkv, hq // hkv, skv,
                                             d).reshape(b, hq, skv, d)
    if sq == skv and window is None:
        return lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal, scale=d ** -0.5)
    return lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask, scale=d ** -0.5)


def flash_inputs(torch, dev, row):
    """q, k, v and the keyword arguments of a FLASH_ROWS row (seed 13)."""
    label, dt, b, hq, hkv, sq, skv, d, window = row
    dtype = getattr(torch, dt)
    gen = torch.Generator(device=dev).manual_seed(13)
    q = torch.randn((b * hq, sq, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b * hkv, skv, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b * hkv, skv, d), generator=gen, device=dev).to(dtype)
    return q, k, v, dict(causal=label not in FLASH_BIDIRECTIONAL,
                         scale=d ** -0.5, window=window)


class CallCount:
    """A launch count for a library call, as ``profile_kernels`` reads a
    kernel wrapper's."""

    def __init__(self):
        self.launches = 0


def profile_library(torch, fn) -> dict:
    """``profile_kernels`` of one PyTorch call: the device us a call of
    each kernel it launches (by name) and in all."""
    calls = CallCount()

    def kern():
        calls.launches += 1
        return fn()
    kern()
    torch.cuda.synchronize()
    prof = profile_kernels(torch, kern, calls, None, None)
    return {"device_us_per_call": prof["device_us_per_call"],
            "device_launches_per_call": prof["device_launches_per_call"],
            "kernels": prof["kernels"]}


def profile_flash(torch, dev) -> dict:
    """Every FLASH_ROWS row under ``profile_kernels``: the kernel's device
    us and device launches a call, and SDPA's (``library``: each of its
    kernels by name) on the same inputs.  Run with the profiled runs,
    last.  Returns the first row's line."""
    from repro_torch.kernels import flash_attention as FA

    result = None
    for row_spec in FLASH_ROWS:
        label, dt, b, hq, hkv, sq, skv, d, window = row_spec
        q, k, v, kw = flash_inputs(torch, dev, row_spec)

        def kern():
            return FA.flash_attention_fwd(q, k, v, **kw)
        kern()
        torch.cuda.synchronize()
        mask = FA.visible_mask(sq, skv, kw["causal"], window, dev)
        row = {"phase": "flash_attention_profile", "row": label,
               "dtype": dt, "variant": FA.variant(q.dtype),
               **profile_kernels(torch, kern, FA.counter, "flash_attention",
                                 1),
               "library": profile_library(torch, flash_library(
                   torch, q, k, v, (b, hq, hkv, sq, skv, d), window, mask,
                   kw["causal"]))}
        emit(row)
        if result is None:
            result = row
    return result


def decode_inputs(torch, dev, row):
    """q, caches, lengths (ragged in 1..Smax, the first 1 and the last
    Smax; on the host and on the card) and the keyword arguments of a
    DECODE_ROWS row."""
    label, dt, b, hkv, g, d, smax, window = row
    dtype = getattr(torch, dt)
    gen = torch.Generator(device=dev).manual_seed(14)
    q = torch.randn((b, hkv, g, d), generator=gen, device=dev).to(dtype)
    kc = torch.randn((b, hkv, smax, d), generator=gen, device=dev).to(dtype)
    vc = torch.randn((b, hkv, smax, d), generator=gen, device=dev).to(dtype)
    lens_h = torch.randint(1, smax + 1, (b,),
                           generator=torch.Generator().manual_seed(15))
    lens_h[0], lens_h[-1] = 1, smax
    lens = lens_h.to(torch.int32).to(dev)
    return q, kc, vc, lens_h, lens, dict(scale=d ** -0.5, window=window)


def phase_decode(torch, dev) -> dict:
    """The decode kernel against its plain version at ragged lengths;
    the first row is the dense_decode shape (the table's row).  Each row
    carries its variant ("mma": bf16 on the tensor cores; "simt": fp32 on
    the CUDA cores; both split-KV), its kernel's resources and the device
    launches and thread blocks of a call as the C entry reports them;
    ``ms`` is a single call by CUDA events (the wrapper's host time
    included; ``profile_decode`` gives the device's alone)."""
    from repro_torch.kernels import decode_attention as DA

    result = None
    for row_spec in DECODE_ROWS:
        label, dt, b, hkv, g, d, smax, window = row_spec
        q, kc, vc, lens_h, lens, kw = decode_inputs(torch, dev, row_spec)
        out = DA.decode_attention_fwd(q, kc, vc, lens, **kw)
        torch.cuda.synchronize()
        row = {"phase": "kernel", "name": "decode_attention", "row": label,
               "dtype": dt, "B": b, "Hkv": hkv, "G": g, "D": d,
               "Smax": smax, "window": window, "lens": lens_h.tolist(),
               **DA.decode_kernel_attributes(q.dtype, d),
               **DA.decode_last_launch()}
        ref = DA.decode_attention_plain(q, kc, vc, lens, **kw)
        row.update(check_row(torch, f"decode_attention[{label}]", out, ref,
                             kernel_tol(dt, smax)))
        row["ms"] = time_ms(torch, lambda: DA.decode_attention_fwd(
            q, kc, vc, lens, **kw))
        row["plain_ms"] = time_ms(torch, lambda: DA.decode_attention_plain(
            q, kc, vc, lens, **kw), reps=5)
        live = sum(min(n, window) if window else n for n in lens_h.tolist())
        nbytes = ((2 * q.numel()) * q.element_size() + 4 * b
                  + 2 * live * hkv * d * kc.element_size())
        row["bound_ms"], row["bound_by"] = kernel_bound(
            nbytes, 4 * live * hkv * g * d, dt)
        row["library_ms"] = time_ms(torch, decode_library(
            torch, q, kc, vc, lens, window))
        emit(row)
        if result is None:
            result = row
    return result


def decode_library(torch, q, kc, vc, lens, window):
    """The yardstick of a DECODE_ROWS row: one SDPA call over the caches
    expanded to every query head and the live keys as a mask (both made
    here, outside any timed call); the port never calls it."""
    import torch.nn.functional as F
    b, hkv, g, d = q.shape
    smax = kc.shape[2]
    pos = torch.arange(smax, device=q.device)[None, :]
    ok = pos < lens.long()[:, None]
    if window:
        ok = ok & (pos >= lens.long()[:, None] - window)
    mask = ok[:, None, None, :]
    q4 = q.reshape(b, hkv * g, 1, d)
    k4 = kc[:, :, None].expand(b, hkv, g, smax, d).reshape(
        b, hkv * g, smax, d)
    v4 = vc[:, :, None].expand(b, hkv, g, smax, d).reshape(
        b, hkv * g, smax, d)
    return lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask, scale=d ** -0.5)


def profile_decode(torch, dev) -> dict:
    """Every DECODE_ROWS row under ``profile_kernels``: the device us a
    call of the main kernel and of the combine and in all, the device
    launches a call, and SDPA's device us on the same inputs
    (``library``).  Run with the profiled runs, last.  Returns the first
    (gemma) line."""
    from repro_torch.kernels import decode_attention as DA

    result = None
    for row_spec in DECODE_ROWS:
        q, kc, vc, _, lens, kw = decode_inputs(torch, dev, row_spec)

        def kern():
            return DA.decode_attention_fwd(q, kc, vc, lens, **kw)
        kern()
        torch.cuda.synchronize()
        row = {"phase": "decode_attention_profile", "row": row_spec[0],
               "dtype": row_spec[1], "variant": DA.decode_variant(q.dtype),
               **profile_kernels(
                   torch, kern, DA.decode_counter, "decode_attention",
                   DA.decode_last_launch()["device_launches"],
                   part=decode_part),
               "library": profile_library(torch, decode_library(
                   torch, q, kc, vc, lens, kw["window"]))}
        emit(row)
        if result is None:
            result = row
    return result


def decode_part(name: str) -> str:
    """The part of a call a decode kernel's name is: main or combine."""
    return "combine" if "combine" in name else "main"


def rwkv6_inputs(torch, dev, dt, b, h, s, d, state, decays):
    gen = torch.Generator(device=dev).manual_seed(16)
    dtype = getattr(torch, dt)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    r, k, v = (randn(b, s, h, d) * 0.5 for _ in range(3))
    if decays == "model":
        w = torch.exp(-torch.exp(-6.0 + 0.5 * randn(b, s, h, d)))
    else:
        w = torch.sigmoid(randn(b, s, h, d)) * 0.5 + 0.45
    u = randn(h, d) * 0.1
    s0 = randn(b, h, d, d) * 0.5 if state else None
    # (B, H, S, D) views of (B, S, H*D) rows, as the layer passes them
    return [x.to(dtype).transpose(1, 2) for x in (r, k, v, w)] + [u, s0]


def phase_rwkv6(torch, dev) -> dict:
    """The WKV6 kernel against its plain version; the first row is the
    rwkv_prefill shape (the table's row).  Each row carries its kernel's
    resources, the state columns a thread holds and the parts a column
    group is spread over (``rwkv6_kernel_attributes``).  No single
    PyTorch call computes WKV6, so there is no library time."""
    from repro_torch.kernels import rwkv6 as RW

    result = None
    for label, dt, b, h, s, d, state, decays in RWKV6_ROWS:
        args = rwkv6_inputs(torch, dev, dt, b, h, s, d, state, decays)
        out, st = RW.rwkv6_scan_fwd(*args)
        torch.cuda.synchronize()
        ref, ref_st = RW.rwkv6_scan_plain(*args)
        row = {"phase": "kernel", "name": "rwkv6_scan", "row": label,
               "dtype": dt, "B": b, "H": h, "S": s, "D": d,
               "state0": state, "decays": decays,
               **RW.rwkv6_kernel_attributes(args[0].dtype, d)}
        row.update(check_row(torch, f"rwkv6_scan[{label}]", out, ref,
                             kernel_tol(dt, s)))
        st_err = (st - ref_st).abs().max().item()
        st_tol = kernel_tol("float32", s)[0]
        row.update(state_max_abs_err=st_err, state_tol=st_tol,
                   state_ref_rms=ref_st.pow(2).mean().sqrt().item())
        if not bool(torch.isfinite(st).all()) or not st_err <= st_tol:
            raise AssertionError(f"rwkv6_scan[{label}] final state "
                                 f"disagrees with the plain version: "
                                 f"{st_err}")
        row["ms"] = time_ms(torch, lambda: RW.rwkv6_scan_fwd(*args))
        row["plain_ms"] = time_ms(torch, lambda: RW.rwkv6_scan_plain(*args),
                                  reps=5)
        item = args[0].element_size()
        nbytes = (5 * b * h * s * d * item + h * d * 4
                  + (2 if state else 1) * b * h * d * d * 4)
        # the state math is fp32 whatever the input type: the fp32 peak
        row["bound_ms"], row["bound_by"] = kernel_bound(
            nbytes, WKV6_OPS * b * h * s * d * d, "float32")
        row["library_ms"] = None
        emit(row)
        if result is None:
            result = row
    return result


def profile_rwkv6(torch, dev) -> dict:
    """The RWKV6_ROWS under ``profile_kernels``: the device us a call of
    the WKV6 kernel (one device launch a call).  Run with the profiled
    runs, last.  Returns the prefill line."""
    from repro_torch.kernels import rwkv6 as RW

    result = None
    for label, dt, b, h, s, d, state, decays in RWKV6_ROWS:
        args = rwkv6_inputs(torch, dev, dt, b, h, s, d, state, decays)
        row = {"phase": "rwkv6_scan_profile", "row": label, "dtype": dt,
               **profile_kernels(torch, lambda: RW.rwkv6_scan_fwd(*args),
                                 RW.counter, "rwkv6_scan", 1)}
        emit(row)
        if result is None:
            result = row
    return result


def profile_fused(torch, dev) -> dict:
    """Rows (a)-(d) of the fused kernel under ``profile_kernels``: the
    device us a call and a launch (the wrapper launches its kernel once a
    call).  Run with the profiled runs, last.  Returns the add+relu
    line."""
    from repro_torch.kernels import fused_elementwise as FE

    result = None
    for label, dtype, _, chain, ext in fused_rows(torch, dev):
        kern = FE.make_fused_elementwise(chain)
        row = {"phase": "fused_elementwise_profile", "row": label,
               "dtype": dtype,
               **profile_kernels(torch, lambda: kern(*ext),
                                 FE.fused_counter, "fused_elementwise", 1)}
        emit(row)
        result = result or row
        del ext
    free(torch)
    return result


def profile_mamba(torch, dev) -> dict:
    """The MAMBA_ROWS under ``profile_kernels``: the device us a launch of
    the Mamba kernel (one device launch a call) and the waves its grid
    runs in.  Run with the profiled runs, last.  Returns the prefill
    line."""
    from repro_torch.kernels import mamba as MB

    result = None
    for label, dt, b, s, di, n, state, strided in MAMBA_ROWS:
        args = mamba_inputs(torch, dev, dt, b, s, di, n, state, strided)
        attrs = MB.mamba_kernel_attributes(args[0].dtype, n)
        row = {"phase": "mamba_scan_profile", "row": label, "dtype": dt,
               "waves": MB.waves(attrs, b, di),
               **profile_kernels(torch, lambda: MB.mamba_scan_fwd(*args),
                                 MB.counter, "mamba_scan", 1)}
        emit(row)
        result = result or row
        del args
    return result


def mamba_inputs(torch, dev, dt, b, s, di, n, state, strided):
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(17)
    dtype = getattr(torch, dt)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = (randn(b, s, di) * 0.5).to(dtype)
    dtv = (F.softplus(randn(b, s, di)) * 0.1).to(dtype)
    if strided:
        r = MAMBA_DT_RANK
        proj = (randn(b, s, r + 2 * n) * 0.5).to(dtype)
        bm, cm = proj[..., r:r + n], proj[..., r + n:]
    else:
        bm, cm = ((randn(b, s, n) * 0.5).to(dtype) for _ in range(2))
    a = -torch.exp(randn(di, n))
    d = torch.ones(di, device=dev)
    h0 = randn(b, di, n) * 0.5 if state else None
    return x, dtv, bm, cm, a, d, h0


def phase_mamba(torch, dev) -> dict:
    """The Mamba scan kernel against its plain version; the first row is
    the jamba_prefill shape (the table's row).  Each row carries its
    kernel's resources (``mamba_kernel_attributes``), the waves its grid
    runs in and the exponential its dtype uses.  No single PyTorch call
    computes the selective scan, so there is no library time."""
    from repro_torch.kernels import mamba as MB

    result = None
    for label, dt, b, s, di, n, state, strided in MAMBA_ROWS:
        args = mamba_inputs(torch, dev, dt, b, s, di, n, state, strided)
        y, h = MB.mamba_scan_fwd(*args)
        torch.cuda.synchronize()
        ref_y, ref_h = MB.mamba_scan_plain(*args)
        attrs = MB.mamba_kernel_attributes(args[0].dtype, n)
        row = {"phase": "kernel", "name": "mamba_scan", "row": label,
               "dtype": dt, "B": b, "S": s, "Di": di, "N": n, "h0": state,
               "strided_bc": strided, **attrs,
               "waves": MB.waves(attrs, b, di),
               "exp": MB.EXP[args[0].dtype]}
        row.update(check_row(torch, f"mamba_scan[{label}]", y, ref_y,
                             kernel_tol(dt, s)))
        st_err = (h - ref_h).abs().max().item()
        st_tol = kernel_tol("float32", s)[0]
        row.update(state_max_abs_err=st_err, state_tol=st_tol,
                   state_ref_rms=ref_h.pow(2).mean().sqrt().item())
        if not bool(torch.isfinite(h).all()) or not st_err <= st_tol:
            raise AssertionError(f"mamba_scan[{label}] final state "
                                 f"disagrees with the plain version: "
                                 f"{st_err}")
        row["ms"] = time_ms(torch, lambda: MB.mamba_scan_fwd(*args))
        row["plain_ms"] = time_ms(torch, lambda: MB.mamba_scan_plain(*args),
                                  reps=5)
        # x and dt in, y out; B, C; A and D; the final state out (and h0)
        nbytes = ((3 * b * s * di + 2 * b * s * n) * args[0].element_size()
                  + (di * n + di) * 4 + (2 if state else 1) * b * di * n * 4)
        # the state math is fp32 whatever the input type: the fp32 peak
        row["bound_ms"], row["bound_by"] = kernel_bound(
            nbytes, MAMBA_OPS * b * s * di * n, "float32")
        row["exp_floor_ms"] = b * s * di * n / SFU_EXP_PER_S * 1e3
        row["library_ms"] = None
        emit(row)
        if result is None:
            result = row
    return result


# ----------------------------------------------------------------------
# serving phases
# ----------------------------------------------------------------------

def serving_engine(cfg, params, dev, **kw):
    """The gemma-2b serving engine every serving phase drives."""
    from repro_torch.serving.engine import ServingEngine
    return ServingEngine(cfg, params, page_size=PAGE_SIZE, num_pages=1280,
                         max_batch=MAX_BATCH, token_budget=TOKEN_BUDGET,
                         chunk_size=CHUNK, max_pages_per_seq=128,
                         device=dev, **kw)


def run_engine(torch, cfg, params, requests, dev, **kw):
    eng = serving_engine(cfg, params, dev, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = [eng.submit(p, max_new_tokens=n, sampling=sp)
           for p, n, sp in requests]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    outs = []
    for i, (_, n, _) in zip(ids, requests):
        req = eng.result(i)
        if req is None or len(req.out_tokens) != n:
            raise AssertionError(f"request {i} did not finish with {n} "
                                 f"tokens")
        if not all(0 <= tok < cfg.vocab_size for tok in req.out_tokens):
            raise AssertionError(f"request {i} emitted a token out of "
                                 f"range")
        outs.append(list(req.out_tokens))
    m = eng.metrics
    if m["failed_requests"] or m["watchdog_trips"] or \
            m["executor_failures"]:
        raise AssertionError(f"serving faults: {m}")
    if m["bucket_compiles"] > eng.bucket_count:
        raise AssertionError("more step buckets than the bucket count")
    m["bucket_count"] = eng.bucket_count
    return outs, wall, m


def _kernel_group(name: str) -> str:
    n = name.lower()
    if "paged_attention" in n:
        return "paged_attention"
    if "gumbel" in n:
        return "gumbel_perturb"
    if "flash_attention" in n:
        return "flash_attention"
    if "decode_attention" in n:
        return "decode_attention"
    if "mixed_attention" in n:
        return "mixed_attention"
    if "rwkv6" in n:
        return "rwkv6_scan"
    if "mamba" in n:
        return "mamba_scan"
    if "fused_chain_kernel" in n:
        return "fused_elementwise"
    if any(s in n for s in ("gemm", "nvjet", "cutlass", "xmma", "matmul")):
        return "matmul"
    if "sort" in n or "radix" in n or "cumsum" in n or "scan" in n:
        return "sampling_sort_scan"
    return "other"


SERVING_KERNELS = ("paged_attention", "gumbel_perturb")


def counted(torch, what: str, fn, required=SERVING_KERNELS):
    """Run ``fn`` with every kernel launch count zeroed just before it;
    read the counts just after and fail unless every ``required`` kernel
    launched."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    result = fn()
    torch.cuda.synchronize()
    counts = launch_counts()
    for name in required:
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"{name} was never launched in {what}")
    return result, counts


MOE_RANGE = "moe_dispatch_combine"
# the serving executor's sampling tail (``serving/executor.py``): filter,
# perturb, argmax
SAMPLING_RANGE = "sampling"
# the eager runtime's per-op profiler ranges (``core.autograd.op_range``)
EAGER_RANGE = "repro_torch::"


def _kernels_under(ev):
    """(name, device us) of every kernel launched under a profiled CPU op
    and its children."""
    for k in ev.kernels:
        yield k.name, k.duration
    for child in ev.cpu_children:
        yield from _kernels_under(child)


def range_kernels(prof, name: str) -> list:
    """(name, device us) of every kernel launched under the CPU ranges
    called ``name``."""
    return [k for ev in prof.events()
            if ev.name == name and "CPU" in str(ev.device_type)
            for k in _kernels_under(ev)]


def device_time(prof) -> tuple:
    """Device ms by kernel group, and (ms, name, calls) of each kernel
    sorted by time, from a ``torch.profiler`` run.  The kernels launched
    inside the MoE layer's ``moe_dispatch_combine`` range (its dispatch of
    tokens to expert slots and its combine back, ``models/layers.py::
    moe``) are moved to a group of that name; the range itself, which the
    profiler may also report as a device annotation, is no kernel, and
    neither are the sampling range nor the eager runtime's
    ``repro_torch::`` op ranges."""
    groups, top = {}, []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if not us or ev.device_type is None or \
                "CUDA" not in str(ev.device_type) or \
                ev.key in (MOE_RANGE, SAMPLING_RANGE) or \
                ev.key.startswith(EAGER_RANGE):
            continue
        g = _kernel_group(ev.key)
        groups[g] = groups.get(g, 0.0) + us / 1e3
        top.append((us / 1e3, ev.key[:60], ev.count))
    top.sort(reverse=True)
    for name, us in range_kernels(prof, MOE_RANGE):
        g = _kernel_group(name)
        groups[g] -= us / 1e3
        groups[MOE_RANGE] = groups.get(MOE_RANGE, 0.0) + us / 1e3
    return groups, top


def profile_window(torch, phase: str, fn, **fields) -> None:
    """Run ``fn`` under ``torch.profiler`` and emit a ``phase`` line:
    device time and kernel calls by kernel group, busy ms and the idle
    share of the wall clock (``fn`` ends in a synchronise), and the peak
    device memory."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    groups, top = device_time(prof)
    calls = {}
    for _, name, n in top:
        calls[_kernel_group(name)] = calls.get(_kernel_group(name), 0) + n
    busy = sum(groups.values())
    emit({"phase": phase, **fields, "wall_ms": wall * 1e3,
          "device_ms_by_group": groups, "device_calls_by_group": calls,
          "device_busy_ms": busy,
          "device_idle_share": max(0.0, 1.0 - busy / (wall * 1e3)),
          "peak_mem_gb": peak_gb(torch)})


def profile_serving(torch, cfg, params, requests, dev) -> dict:
    """One serving run under ``torch.profiler``: device time by kernel
    group, the busy share of the wall clock, the top kernels, and the
    sampling tail (the kernels under the executor's ``sampling`` range:
    device ms, launches and Gumbel launches a step, its kernels by
    name)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        (_, wall, m), counts = counted(
            torch, "the profiled run",
            lambda: run_engine(torch, cfg, params, requests, dev))
    groups, top = device_time(prof)
    busy = sum(groups.values())
    calls = {}
    for _, name, n in top:
        calls[_kernel_group(name)] = calls.get(_kernel_group(name), 0) + n
    tail, by_name = range_kernels(prof, SAMPLING_RANGE), {}
    for name, us in tail:
        k = by_name.setdefault(name[:60], [0.0, 0])
        k[0] += us / 1e3
        k[1] += 1
    steps = m["steps"]
    return {"wall_ms": wall * 1e3, "device_ms_by_group": groups,
            "device_calls_by_group": calls, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / (wall * 1e3)),
            "steps": steps, "launches": counts,
            "sampling": {
                "device_ms": sum(us for _, us in tail) / 1e3,
                "launches": len(tail),
                "launches_per_step": len(tail) / steps,
                "gumbel_launches_per_step": counts["gumbel_perturb"] / steps,
                "kernels": sorted(([ms, c, n] for n, (ms, c) in
                                   by_name.items()), reverse=True)},
            "top_kernels": [{"ms": t, "name": n, "calls": c}
                            for t, n, c in top[:8]]}


def phase_small_e2e(torch) -> None:
    """Three engines on a small config (gemma-smoke, fp32, through the
    kernels) agree token for token with the same engines on the CPU
    (plain versions): the unified engine, the legacy engine, and the
    unified engine with a 1-layer draft model proposing 2 tokens."""
    from repro_torch.configs import gemma_2b
    from repro_torch.models import lm as LM
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.legacy import LegacyServingEngine
    from repro_torch.serving.sampling import SamplingParams
    from repro_torch.serving.spec import DraftModelProposer

    cfg = gemma_2b.SMOKE
    params = LM.init_params(cfg, seed=3, device="cpu")
    dcfg = dataclasses.replace(cfg, n_layers=1)
    dparams = LM.init_params(dcfg, seed=4, device="cpu")
    gen = torch.Generator().manual_seed(5)
    reqs = [(torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist(),
             12, SamplingParams()) for n in (5, 17, 30, 9)]

    def serve(dev):
        eng = ServingEngine(cfg, params, page_size=4, num_pages=64,
                            max_batch=4, device=dev)
        ids = [eng.submit(p, max_new_tokens=n, sampling=sp)
               for p, n, sp in reqs]
        eng.run()
        return [eng.result(i).out_tokens for i in ids]

    def serve_legacy(dev):
        eng = LegacyServingEngine(cfg, params, page_size=4, num_pages=64,
                                  max_batch=4, device=dev)
        ids = [eng.submit(p, max_new_tokens=n) for p, n, _ in reqs]
        done = {r.req_id: r.out_tokens for r in eng.run()}
        return [done.get(i) for i in ids]

    def serve_draft(dev):
        draft = DraftModelProposer(dcfg, LM.params_to(dparams, dev),
                                   window=16)
        eng = ServingEngine(cfg, params, page_size=4, num_pages=64,
                            max_batch=4, spec_k=SPEC_K, proposer=draft,
                            device=dev)
        ids = [eng.submit(p, max_new_tokens=n, sampling=sp)
               for p, n, sp in reqs]
        eng.run()
        return [eng.result(i).out_tokens for i in ids]

    for engine, fn, required in (
            ("unified", serve, SERVING_KERNELS),
            ("legacy", serve_legacy, ("flash_attention",
                                      "decode_attention")),
            ("draft_spec", serve_draft,
             SERVING_KERNELS + ("flash_attention",))):
        on_cpu = fn("cpu")
        on_cuda, counts = counted(torch, f"the small CUDA {engine} run",
                                  lambda: fn("cuda"), required=required)
        emit({"phase": "small_e2e", "engine": engine, "config": cfg.name,
              "equal": on_cpu == on_cuda, "launches": counts})
        if on_cpu != on_cuda:
            raise AssertionError(f"small config, {engine} engine: CUDA "
                                 f"{on_cuda} != CPU {on_cpu}")


# ----------------------------------------------------------------------
# the eager runtime: the fused-elementwise kernel and ResNet-50 training
# ----------------------------------------------------------------------

# fused_elementwise against its plain version, |out - ref| <= atol +
# rtol |ref| by output dtype: fp32 1e-5 and 1e-5 (libdevice's and
# PyTorch's CUDA math may differ by an ulp; values reach ~20), bf16 1e-2
# and 1e-2 (both round one fp32 result to bf16, a tie can fall one step
# apart); integer and bool outputs exact.
FUSED_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-2)}
# turns of the relu row against torch.relu (``relu_turns``): the two
# differ by a few percent, less than one reading's spread
RELU_TURNS = 6
# rows (a)-(d): (label, dtype, shape); (a) and (c) are ResNet-50's
# relu(out + identity) at layer1's shape, batch 64 (two inputs, two
# outputs), (b) the stem's relu, (d) a long chain with a 0-d and a
# broadcast operand and transcendental ops
FUSED_ROWS = (("add_relu", "float32", (64, 256, 56, 56)),
              ("relu", "float32", (64, 64, 112, 112)),
              ("add_relu_bf16", "bfloat16", (64, 256, 56, 56)),
              ("long_chain", "float32", (4096, 4096)))
FUSED_CASE_SHAPE = (1000, 37)      # row (e): a ragged last block

# the eager_train cell: ResNet-50 at full width, 224 x 224 RGB, batch 64,
# fp32, train mode, SGD(momentum 0.9, foreach), fusion on, one batch for
# every step.  lr 0.025 is the usual 0.1 per 256 images scaled to 64
# (Goyal et al.): at lr 0.1 the 12th step's loss on this batch landed
# below the first step's in one run and above it in the next (5.646 and
# 8.133 from 7.212 on an NVIDIA H100): it does not fall reliably.
EAGER_BATCH, EAGER_IMAGE, EAGER_CLASSES = 64, 224, 1000
EAGER_WARMUP, EAGER_STEPS, EAGER_PROFILE_STEPS = 2, 10, 2
EAGER_LR, EAGER_MOMENTUM = 0.025, 0.9
# eager_parity: fusion off vs on on the card (deterministic cuDNN): loss
# to 1e-5 relative, each gradient to 1e-4 of its RMS.  Card vs CPU on
# ResNet50(10): 128 x 128, batch 2 (at 32 x 32 layer4 normalizes 2 values
# a channel, which makes fp32 results chaotic in either package): loss
# 1e-5 relative, logits 1e-4 of their RMS, running stats 1e-4 relative
# L2, gradients 5e-2 relative L2 over the model (ReLU and max-pool kinks
# make them ill-conditioned).
EAGER_PARITY_TOL = (1e-5, 1e-4)
EAGER_SMALL = (2, 128, 10)
EAGER_SMALL_TOL = {"loss": 1e-5, "logits": 1e-4, "stats": 1e-4,
                   "grads": 5e-2}


def fused_check(torch, label: str, outs, refs) -> float:
    """Max abs error of every output against the plain version's, held
    to ``FUSED_TOL`` (exact for integer and bool outputs); dtypes and
    shapes must agree."""
    worst = 0.0
    for o, r in zip(outs, refs):
        if o.dtype != r.dtype or o.shape != r.shape:
            raise AssertionError(f"fused_elementwise {label}: {o.dtype} "
                                 f"{tuple(o.shape)} vs plain {r.dtype} "
                                 f"{tuple(r.shape)}")
        if not r.dtype.is_floating_point:
            if not torch.equal(o, r):
                raise AssertionError(f"fused_elementwise {label}: "
                                     f"{r.dtype} outputs differ")
            continue
        atol, rtol = FUSED_TOL[str(r.dtype).split(".")[1]]
        diff = (o.float() - r.float()).abs()
        bad = diff > atol + rtol * r.float().abs()
        same_nan = torch.isnan(o.float()) & torch.isnan(r.float())
        if bool((bad & ~same_nan).any()):
            raise AssertionError(f"fused_elementwise {label} disagrees "
                                 f"with its plain version: "
                                 f"{diff[~same_nan].max().item()}")
        if diff[~same_nan].numel():
            worst = max(worst, diff[~same_nan].max().item())
    return worst


def fused_op_cases(torch, dev):
    """Row (e): (label, fn, args) for every op of ``ELEMENTWISE_OPS``
    through its public function, in each dtype it takes (fp32, bf16;
    int32 and bool where the op takes them), plus Python-scalar,
    broadcast and non-contiguous operands."""
    import repro_torch as rt
    import repro_torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(16)
    shape = FUSED_CASE_SHAPE

    def t(x):
        return rt.Tensor(x)

    def randn(dt, s=shape):
        return t(torch.randn(s, generator=gen, device=dev).to(dt))

    def pos(dt):
        return t((torch.rand(shape, generator=gen, device=dev) * 2 + 0.25
                  ).to(dt))

    def nonzero(dt):
        r = torch.rand(shape, generator=gen, device=dev) + 0.5
        sign = torch.randint(0, 2, shape, generator=gen, device=dev) * 2 - 1
        return t((r * sign).to(dt))

    def ints(lo, hi, s=shape):
        return t(torch.randint(lo, hi, s, generator=gen, device=dev,
                               dtype=torch.int32))

    def bools():
        return t(torch.rand(shape, generator=gen, device=dev) < 0.5)

    unary = {
        "neg": lambda a: -a, "abs": lambda a: a.abs(),
        "clone": lambda a: a.clone(), "exp": lambda a: a.exp(),
        "sin": lambda a: a.sin(), "cos": lambda a: a.cos(),
        "tanh": lambda a: a.tanh(), "sigmoid": lambda a: a.sigmoid(),
        "relu": lambda a: a.relu(), "erf": lambda a: a.erf(),
        "relu6": F.relu6, "gelu_tanh": F.gelu,
        "gelu_none": lambda a: F.gelu(a, "none"), "silu": F.silu,
        "softplus": F.softplus, "hardswish": F.hardswish,
        "leaky_relu": lambda a: F.leaky_relu(a, 0.2),
        "elu": lambda a: F.elu(a, 1.5),
        "clamp": lambda a: a.clamp(-0.5, 0.5),
        "clamp_hi": lambda a: a.clamp(None, 0.3),
        "dropout": lambda a: F.dropout(a, 0.25),
    }
    positive = {"log": lambda a: a.log(), "sqrt": lambda a: a.sqrt(),
                "rsqrt": lambda a: a.rsqrt()}
    binary = {"add": lambda a, b: a + b, "sub": lambda a, b: a - b,
              "mul": lambda a, b: a * b,
              "maximum": rt.maximum, "minimum": rt.minimum}
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        for op, fn in unary.items():
            cases.append((f"{op}/{name}", fn, (randn(dt),)))
        for op, fn in positive.items():
            cases.append((f"{op}/{name}", fn, (pos(dt),)))
        for op, fn in binary.items():
            cases.append((f"{op}/{name}", fn, (randn(dt), randn(dt))))
        cases += [
            (f"div/{name}", lambda a, b: a / b, (randn(dt), nonzero(dt))),
            (f"mod/{name}", lambda a, b: a % b, (randn(dt) * 3.0,
                                                 nonzero(dt))),
            (f"pow/{name}", lambda a, b: a ** b, (pos(dt), randn(dt))),
            (f"where/{name}", rt.where, (bools(), randn(dt), randn(dt))),
            (f"masked_fill/{name}", lambda a, m: a.masked_fill(m, -1.5),
             (randn(dt), bools())),
            (f"scalar/{name}", lambda a: a * 2.5 + 1.0, (randn(dt),)),
            (f"broadcast/{name}", lambda a, b: a + b,
             (randn(dt), randn(dt, (shape[1],)))),
            (f"transposed/{name}", lambda a, b: a * b,
             (t(randn(dt, shape[::-1]).data.t()), randn(dt)))]
        for to in ("float32", "bfloat16", "int32", "bool"):
            cases.append((f"astype_{to}/{name}",
                          lambda a, to=to: a.astype(to), (randn(dt) * 4,)))
    iops = {"add": lambda a, b: a + b, "sub": lambda a, b: a - b,
            "mul": lambda a, b: a * b, "maximum": rt.maximum,
            "minimum": rt.minimum}
    for op, fn in iops.items():
        cases.append((f"{op}/int32", fn, (ints(-20, 20), ints(-20, 20))))
    nz = ints(1, 10)
    nz = t(nz.data * (torch.randint(0, 2, shape, generator=gen, device=dev,
                                    dtype=torch.int32) * 2 - 1))
    cases += [
        ("div/int32", lambda a, b: a / b, (ints(-20, 20), nz)),
        ("mod/int32", lambda a, b: a % b, (ints(-20, 20), nz)),
        ("pow/int32", lambda a, b: a ** b, (ints(-3, 4), ints(-2, 6))),
        ("neg/int32", lambda a: -a, (ints(-20, 20),)),
        ("abs/int32", lambda a: a.abs(), (ints(-20, 20),)),
        ("clone/int32", lambda a: a.clone(), (ints(-20, 20),)),
        ("relu/int32", lambda a: a.relu(), (ints(-20, 20),)),
        ("clamp/int32", lambda a: a.clamp(-3, 5), (ints(-20, 20),)),
        ("clamp_float/int32", lambda a: a.clamp(0.0, 1.5),
         (ints(-3, 3),)),
        ("where/int32", rt.where, (bools(), ints(-9, 9), ints(-9, 9))),
        ("masked_fill/int32", lambda a, m: a.masked_fill(m, 7),
         (ints(-9, 9), bools())),
        ("exp/int32", lambda a: a.exp(), (ints(-5, 5),)),
        ("sqrt/int32", lambda a: a.sqrt(), (ints(0, 50),)),
        ("sigmoid/int32", lambda a: a.sigmoid(), (ints(-5, 5),)),
        ("scalar/int32", lambda a: a * 3 + 2.5, (ints(-9, 9),)),
        ("clone/bool", lambda a: a.clone(), (bools(),)),
        ("where/bool", rt.where, (bools(), bools(), bools())),
        ("maximum/bool", rt.maximum, (bools(), bools())),
        ("minimum/bool", rt.minimum, (bools(), bools())),
        ("add/bool", lambda a, b: a + b, (bools(), bools())),
        ("mul/bool", lambda a, b: a * b, (bools(), bools()))]
    for to in ("float32", "bfloat16", "bool"):
        cases.append((f"astype_{to}/int32", lambda a, to=to: a.astype(to),
                      (ints(-3, 3),)))
    for to in ("float32", "int32"):
        cases.append((f"astype_{to}/bool", lambda a, to=to: a.astype(to),
                      (bools(),)))
    return cases


def relu_turns(torch, kern, library, turns: int = RELU_TURNS) -> dict:
    """``time_ms_stream`` readings of ``kern`` and ``library`` taken in
    alternating turns (kernel first in even turns, the library call in
    odd ones), every reading kept, with each one's min and median."""
    got = {"kernel": [], "library": []}
    for i in range(turns):
        order = ("kernel", "library") if i % 2 == 0 else \
            ("library", "kernel")
        for who in order:
            got[who].append(time_ms_stream(
                torch, kern if who == "kernel" else library))
    for who in ("kernel", "library"):
        xs = sorted(got[who])
        got[f"{who}_min"] = xs[0]
        got[f"{who}_median"] = (xs[(len(xs) - 1) // 2]
                                + xs[len(xs) // 2]) / 2
    return got


def fused_rows(torch, dev):
    """Rows (a)-(d) of ``FUSED_ROWS``: (label, dtype, shape, chain,
    external inputs), the inputs made from seed 15 in row order."""
    import repro_torch as rt
    import repro_torch.nn.functional as F
    from repro_torch.core.fuse import capture_chain

    gen = torch.Generator(device=dev).manual_seed(15)
    fns = {"add_relu": (lambda x, y: F.relu(x + y), 2),
           "relu": (F.relu, 1),
           "add_relu_bf16": (lambda x, y: F.relu(x + y), 2),
           "long_chain": (lambda x, b: ((((x * 0.5 + b).tanh() * x).exp()
                                         .sigmoid() - 0.25).erf()), 2)}
    for label, dtype, shape in FUSED_ROWS:
        fn, n_in = fns[label]
        dt = getattr(torch, dtype)
        xs = [rt.Tensor(torch.randn(shape, generator=gen, device=dev)
                        .to(dt))]
        if n_in == 2:
            second = shape if label != "long_chain" else shape[-1:]
            xs.append(rt.Tensor(torch.randn(second, generator=gen,
                                            device=dev).to(dt)))
        chain, ext = capture_chain(fn, *xs)
        del xs
        yield label, dtype, shape, chain, ext


def host_us(torch, fn, calls: int = 50) -> float:
    """Host us a call of ``fn``, enqueued ``calls`` times back to back
    without waiting: the wrapper's and the launcher's share of a call,
    while the device is busier than the host."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    spent = time.perf_counter() - t
    torch.cuda.synchronize()
    return spent / calls * 1e6


def phase_fused_elementwise(torch, dev) -> dict:
    """Kernel B9 against its plain version: rows (a)-(d) timed, row (e)
    (every op, every dtype it takes) for correctness; and a chain with an
    op that has no emitter raises without launching."""
    from repro_torch.core.fuse import ELEMENTWISE_OPS, capture_chain
    from repro_torch.kernels import fused_elementwise as FE
    from repro_torch.kernels import launch_counts

    main = None
    for label, dtype, shape, chain, ext in fused_rows(torch, dev):
        # the launcher a dispatch-cache entry of the eager runtime keeps
        kern = FE.make_fused_elementwise(chain)
        out = kern(*ext)
        torch.cuda.synchronize()
        ref = FE.fused_elementwise_plain(chain, *ext)
        err = fused_check(torch, label, out, ref)
        nbytes = sum(x.numel() * x.element_size() for x in ext) + \
            sum(o.numel() * o.element_size() for o in out)
        ops = sum(o.numel() for o in out)    # one operation a step output
        bound_ms, bound_by = kernel_bound(nbytes, ops, "float32")
        # device time with the queue kept full (time_ms_stream): the
        # Triton launcher's host time exceeds the smaller rows' kernels
        ms = time_ms_stream(torch, lambda: kern(*ext))
        plain_ms = time_ms_stream(
            torch, lambda: FE.fused_elementwise_plain(chain, *ext))
        library_ms = turns = None
        if label == "relu":
            library_ms = time_ms_stream(torch, lambda: torch.relu(ext[0]))
            turns = relu_turns(torch, lambda: kern(*ext),
                               lambda: torch.relu(ext[0]))
        single_ms = time_ms(torch, lambda: kern(*ext))
        row = {"phase": "kernel", "name": "fused_elementwise",
               "row": label, "dtype": dtype, "shape": list(shape),
               "chain": [s[0] for s in chain.steps],
               "inputs": [list(x.shape) for x in ext],
               "max_abs_err": err, "tol": FUSED_TOL[dtype], "ms": ms,
               "single_call_ms": single_ms,
               "host_us_per_call": host_us(torch, lambda: kern(*ext)),
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "bound_share": bound_ms / ms,
               "bytes": nbytes, "library_ms": library_ms}
        if turns is not None:
            row["turns_vs_library"] = turns
        emit(row)
        main = main or row
        del ext, out, ref
    free(torch)

    # row (e): the cases' chains merged 16 at a time, so that a handful
    # of generated kernels (one Triton compile each) check them all
    worst, seen = {}, set()
    cases = fused_op_cases(torch, dev)
    captured = []
    for label, fn, args in cases:
        chain, ext = capture_chain(fn, *args)
        seen.update(s[0] for s in chain.steps)
        captured.append((label, chain, ext))
    for i in range(0, len(captured), 16):
        group = captured[i:i + 16]
        chain, ext = FE.merge_chains([(c, e) for _, c, e in group])
        out = FE.fused_elementwise(chain, *ext)
        ref = FE.fused_elementwise_plain(chain, *ext)
        j = 0
        for label, c, _ in group:
            n = len(c.steps)
            err = fused_check(torch, label, out[j:j + n], ref[j:j + n])
            kind = label.split("/")[1]
            worst[kind] = max(worst.get(kind, 0.0), err)
            j += n
    missing = ELEMENTWISE_OPS - seen
    if missing:
        raise AssertionError(f"row (e) never ran {sorted(missing)}")
    x = torch.randn(FUSED_CASE_SHAPE, device=dev)
    bogus = FE.FusedChain(steps=(("no_such_op", (), (("e", 0),)),),
                          fns=(torch.neg,), dtypes=(torch.float32,))
    before = launch_counts()["fused_elementwise"]
    try:
        FE.fused_elementwise(bogus, x)
    except NotImplementedError:
        raised = True
    else:
        raised = False
    if not raised or launch_counts()["fused_elementwise"] != before:
        raise AssertionError("a chain with an op that has no emitter "
                             "did not raise, or launched")
    emit({"phase": "kernel", "name": "fused_elementwise", "row": "every_op",
          "cases": len(cases), "ops": len(seen),
          "max_abs_err_by_dtype": worst, "no_emitter_raises": raised})
    return main


def resnet_chains_per_step(model) -> int:
    """Fused launches of one ResNet-50 training step with the fusion
    queue on, derived from the model's code: the stem's
    ``relu(bn1(conv1(x)))``, and per Bottleneck ``relu(bn1(...))``,
    ``relu(bn2(...))`` and ``relu(out + identity)`` (one two-step chain),
    each flushed by the convolution, pooling or next block that reads it
    (``models/paper_models.py``).  ``cross_entropy`` is one op, the
    backward of a chain is its plain version's VJP, and the optimizer
    works on raw data, so none of them adds a chain."""
    from repro_torch.models.paper_models import Bottleneck
    blocks = sum(isinstance(m, Bottleneck) for m in model.modules())
    return 1 + 3 * blocks


def eager_batch(torch, b: int, size: int, classes: int, seed: int):
    """Images (b, 3, size, size) ~ N(0, 1) and labels, from numpy."""
    import numpy as np
    import repro_torch as rt

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 3, size, size), dtype=np.float32)
    y = rng.integers(0, classes, b).astype(np.int32)
    return rt.tensor(x), rt.tensor(y)


def train_step(model, opt, x, y, fused: bool = True):
    """The user's step: forward, ``loss.backward()`` on the tape,
    ``optimizer.step()``, inside ``repro_torch.fuse.fusion()``."""
    import repro_torch as rt
    import repro_torch.nn.functional as F

    opt.zero_grad()
    with rt.fuse.fusion(fused):
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
    return loss


def resnet(torch, classes: int):
    """ResNet-50 in train mode, weights from ``manual_seed(0)``, with its
    SGD optimizer (``EAGER_LR``, momentum 0.9, foreach)."""
    import repro_torch as rt
    import repro_torch.optim as optim
    from repro_torch.models.paper_models import ResNet50

    rt.manual_seed(0)
    model = ResNet50(classes)
    model.train()
    opt = optim.SGD(list(model.parameters()), lr=EAGER_LR,
                    momentum=EAGER_MOMENTUM)
    return model, opt


def eager_device_time(prof) -> dict:
    """Device ms by group from a profiled eager run, and the largest
    kernels linked to no host op.  The eager runtime
    opens a ``repro_torch::<op>`` range around every op's forward and a
    ``<op>.bwd`` one around its VJP (``core.autograd.op_range``); a
    kernel belongs to the innermost range whose host interval holds the
    start of the op that launched it (the VJP's ops run on PyTorch's
    autograd device thread, which the range's thread waits for).  The
    generated Triton kernel is grouped by its name wherever it runs."""
    ranges = sorted(((ev.time_range.start, ev.time_range.end,
                      ev.name[len(EAGER_RANGE):])
                     for ev in prof.events()
                     if ev.name.startswith(EAGER_RANGE)),
                    key=lambda r: (r[0], -r[1]))
    starts = [r[0] for r in ranges]
    groups = {}

    def group_of(t0, kernel):
        if "fused_chain_kernel" in kernel:
            return "fused_elementwise"
        i = bisect.bisect_right(starts, t0) - 1
        name = None
        while i >= 0:
            if ranges[i][1] >= t0:
                name = ranges[i][2]
                break
            i -= 1
        if name is None:
            return "outside_ops"
        bwd = name.endswith(".bwd")
        op = name[:-4] if bwd else name
        if op.startswith("fused["):
            return "fused_backward"
        return {"conv2d": "conv", "batch_norm": "batch_norm",
                "linear": "matmul", "max_pool2d": "pool",
                "adaptive_avg_pool2d": "pool", "cross_entropy": "loss",
                "optimizer.step": "optimizer"}.get(op, "other")

    linked = {}
    for ev in prof.events():
        for k in ev.kernels:
            g = group_of(ev.time_range.start, k.name)
            groups[g] = groups.get(g, 0.0) + k.duration / 1e3
            linked[k.name] = linked.get(k.name, 0.0) + k.duration / 1e3
    # kernels the profiler links to no host op (the Triton launcher's,
    # and any other) are grouped by name
    unlinked = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if not us or "CUDA" not in str(ev.device_type) or \
                ev.key.startswith(EAGER_RANGE):
            continue     # no kernel: a range the profiler also annotates
        rest = us / 1e3 - linked.get(ev.key, 0.0)
        if rest > 1e-3:
            g = "unlinked:" + eager_kernel_group(ev.key)
            groups[g] = groups.get(g, 0.0) + rest
            unlinked.append((rest, ev.key[:60]))
    unlinked.sort(reverse=True)
    return groups, unlinked[:6]


def eager_kernel_group(name: str) -> str:
    n = name.lower()
    if "fused_chain_kernel" in n:
        return "fused_elementwise"
    if any(s in n for s in ("conv", "xmma", "cudnn", "implicit", "fprop",
                            "dgrad", "wgrad", "winograd")):
        return "conv"
    if any(s in n for s in ("gemm", "nvjet", "cutlass")):
        return "matmul"
    if "reduce" in n:
        return "reduction"
    return "elementwise"


def phase_eager_train(torch, dev) -> tuple:
    """ResNet-50 training at full width through the eager runtime with
    the fusion queue on: ``EAGER_WARMUP`` + ``EAGER_STEPS`` steps on one
    batch.  Every flushed chain must launch the generated kernel, exactly
    ``resnet_chains_per_step`` times a step, and no other kernel of the
    port; the loss must fall.  Returns the launch counts and a function
    that profiles ``EAGER_PROFILE_STEPS`` more steps of a model made
    again from the seed."""
    import repro_torch as rt

    model, opt = resnet(torch, EAGER_CLASSES)
    x, y = eager_batch(torch, EAGER_BATCH, EAGER_IMAGE, EAGER_CLASSES, 51)
    per_step = resnet_chains_per_step(model)
    rt.reset_dispatch_cache()
    torch.cuda.reset_peak_memory_stats()
    rt.allocator.device_allocator().reset_peak_stats()
    t0 = time.perf_counter()
    first = train_step(model, opt, x, y)
    for _ in range(EAGER_WARMUP - 1):
        train_step(model, opt, x, y)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    def run():
        t = time.perf_counter()
        losses = [train_step(model, opt, x, y) for _ in range(EAGER_STEPS)]
        torch.cuda.synchronize()
        return losses, time.perf_counter() - t

    (losses, wall), counts = check_launches(
        torch, "the eager_train run", run,
        {"fused_elementwise": per_step * EAGER_STEPS})
    loss_first, loss_last = first.item(), losses[-1].item()
    fused_bytes = fused_bytes_of_step(torch, model, opt, x, y)
    stats = rt.dispatch_cache_stats()
    acct = rt.allocator.memory_stats()
    emit({"phase": "eager_train", "model": "resnet50", "batch": EAGER_BATCH,
          "image": EAGER_IMAGE, "dtype": "float32", "steps": EAGER_STEPS,
          "warmup_s": warm_s, "ms_per_step": wall / EAGER_STEPS * 1e3,
          "images_per_s": EAGER_BATCH * EAGER_STEPS / wall,
          "fused_launches_per_step": counts["fused_elementwise"]
          / EAGER_STEPS, "derived_per_step": per_step, "launches": counts,
          "dispatch": {k: v for k, v in stats.items() if k != "per_op"},
          "fused_entries": stats["per_op"].get("__fused__"),
          "fused_bytes_per_step": fused_bytes,
          "fused_bound_ms_per_step": fused_bytes / HBM_BYTES_PER_S * 1e3,
          "accounting_peak_gb": acct["peak_bytes_active"] / 1e9,
          "accounting_reserved_gb": acct["peak_bytes_reserved"] / 1e9,
          "peak_mem_gb": peak_gb(torch),
          "loss_first": loss_first, "loss_last": loss_last})
    if not (math.isfinite(loss_last) and loss_last < loss_first):
        raise AssertionError(f"eager_train: the loss did not fall "
                             f"({loss_first} -> {loss_last})")
    del model, opt
    free(torch)

    def profiled():
        model, opt = resnet(torch, EAGER_CLASSES)
        for _ in range(EAGER_WARMUP):
            train_step(model, opt, x, y)

        def steps():
            for _ in range(EAGER_PROFILE_STEPS):
                train_step(model, opt, x, y)
            torch.cuda.synchronize()

        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            steps()
            wall = time.perf_counter() - t
        groups, _ = device_time(prof)
        busy = sum(groups.values())
        by_op, unlinked = eager_device_time(prof)
        emit({"phase": "eager_train_profile", "steps": EAGER_PROFILE_STEPS,
              "wall_ms": wall * 1e3, "device_busy_ms": busy,
              "device_ms_by_group": by_op,
              "top_unlinked": [{"ms": t, "name": n} for t, n in unlinked],
              "device_ms_by_kernel_group": groups,
              "device_idle_share": max(0.0, 1.0 - busy / (wall * 1e3))})
    return counts, profiled


def fused_bytes_of_step(torch, model, opt, x, y) -> int:
    """Bytes the fused kernel must move in one training step: each
    chain's inputs read once and its step outputs written once, summed
    over the step's chains (one more step, after steps that built every
    chain's module, run with a tally around each generated module's
    ``launch``).  Raises unless every fused launch of the step was
    tallied."""
    from repro_torch.kernels import fused_elementwise as FE

    mods = list(FE._modules.values())
    saved = [mod.launch for mod in mods]
    total, tallied = [0], [0]

    def tally(launch):
        def run(ins, outs, *args):
            total[0] += sum(t.numel() * t.element_size()
                            for t in (*ins, *outs))
            tallied[0] += 1
            return launch(ins, outs, *args)
        return run

    for mod, launch in zip(mods, saved):
        mod.launch = tally(launch)
    before = FE.fused_counter.launches
    try:
        train_step(model, opt, x, y)
    finally:
        for mod, launch in zip(mods, saved):
            mod.launch = launch
    torch.cuda.synchronize()
    launched = FE.fused_counter.launches - before
    if not launched or tallied[0] != launched:
        raise AssertionError(f"fused_bytes_of_step: {tallied[0]} of "
                             f"{launched} fused launches tallied")
    return total[0]


def grads_of(model) -> list:
    return [p.grad.data.float() for p in model.parameters()]


def phase_eager_parity(torch, dev) -> None:
    """One ResNet-50 step (full width, the eager_train batch) with the
    fusion queue off (no fused launch) and one with it on, from the same
    weights: loss and gradients agree (deterministic cuDNN).  Then
    ResNet50(10) at 128 x 128, batch 2, on the card against the same
    model on the CPU: loss, logits, gradients and running stats after one
    SGD step."""
    import repro_torch as rt
    import repro_torch.nn.functional as F

    x, y = eager_batch(torch, EAGER_BATCH, EAGER_IMAGE, EAGER_CLASSES, 52)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for fused in (False, True):
            model, opt = resnet(torch, EAGER_CLASSES)
            want = ({"fused_elementwise": resnet_chains_per_step(model)}
                    if fused else {})
            loss, counts = check_launches(
                torch, f"the eager_parity run (fusion {fused})",
                lambda: train_step(model, opt, x, y, fused), want)
            runs[fused] = (loss.item(), grads_of(model), counts)
            del model, opt
    finally:
        torch.backends.cudnn.deterministic = prev
    (l0, g0, _), (l1, g1, c1) = runs[False], runs[True]
    loss_rel = abs(l1 - l0) / abs(l0)
    grad_err = max(((a - b).abs().max() / a.pow(2).mean().sqrt()).item()
                   for a, b in zip(g0, g1))
    del runs, g0, g1
    free(torch)

    b, size, classes = EAGER_SMALL
    xs, ys = eager_batch(torch, b, size, classes, 53)

    def small_step(device):
        with rt.default_device(device):
            model, opt = resnet(torch, classes)
            xd = rt.Tensor(xs.data.to(device))
            yd = rt.Tensor(ys.data.to(device))
            opt.zero_grad()
            with rt.fuse.fusion():
                logits = model(xd)
                loss = F.cross_entropy(logits, yd)
                loss.backward()
                grads = [g.cpu() for g in grads_of(model)]
                opt.step()
            stats = [s.data.float().cpu() for s in model.buffers()]
            return (loss.item(), logits.data.float().cpu(), grads, stats,
                    resnet_chains_per_step(model))

    cpu = small_step("cpu")
    cuda, counts = check_launches(
        torch, "the small CUDA ResNet-50 step", lambda: small_step(dev),
        {"fused_elementwise": cpu[4]})

    def rel_l2(a, b):
        num = sum(float((x - y).pow(2).sum()) for x, y in zip(a, b))
        return (num / sum(float(x.pow(2).sum()) for x in a)) ** 0.5

    small = {"loss": abs(cuda[0] - cpu[0]) / abs(cpu[0]),
             "logits": ((cuda[1] - cpu[1]).abs().max()
                        / cpu[1].pow(2).mean().sqrt()).item(),
             "grads": rel_l2(cpu[2], cuda[2]),
             "stats": max(rel_l2([a], [b]) for a, b in zip(cpu[3], cuda[3]))}
    emit({"phase": "eager_parity", "loss_fused_off": l0, "loss_fused_on": l1,
          "loss_rel": loss_rel, "grad_max_err_over_rms": grad_err,
          "tol": EAGER_PARITY_TOL, "launches_fused_on": c1,
          "small_cuda_vs_cpu": small, "small_tol": EAGER_SMALL_TOL,
          "small_shape": EAGER_SMALL, "small_launches": counts})
    if not (loss_rel <= EAGER_PARITY_TOL[0]
            and grad_err <= EAGER_PARITY_TOL[1]):
        raise AssertionError(f"eager_parity: fusion on and off disagree: "
                             f"loss {loss_rel}, grads {grad_err}")
    if any(not small[k] <= EAGER_SMALL_TOL[k] for k in small):
        raise AssertionError(f"eager_parity: ResNet-50 on the card and on "
                             f"the CPU disagree: {small}")
    free(torch)


# ----------------------------------------------------------------------
# the rest of the eager runtime: GNMT training, the compiled path and
# masked attention
# ----------------------------------------------------------------------

# GNMTv2 at its published widths (the reference class's defaults): vocab
# 32000, hidden 1024, 4 layers, a bidirectional first encoder layer and
# a 4-layer decoder with Bahdanau attention; 64 pairs of 50 source and
# 51 target tokens (the decoder reads the first 50 and predicts the last
# 50), fp32, Adafactor (foreach) with the fusion queue on
GNMT_WIDTHS = dict(vocab=32000, hidden=1024, layers=4)
GNMT_BATCH, GNMT_SRC, GNMT_TGT = 64, 50, 51
GNMT_STEPS = 10                    # step 1 counts, builds and warms
# lr 1e-2 (the class's default) raised the loss over 10 steps (10.37 ->
# 10.89); 3e-3 fell unevenly, 1e-3 to 8.03 (PERF.md §5)
GNMT_LR = 1e-3
# gnmt_parity: one step on the card against the same step on the CPU
GNMT_PARITY_WIDTHS = dict(vocab=4000, hidden=256, layers=2)
GNMT_PARITY_BATCH = (8, 20, 21)
GNMT_PARITY_TOL = {"loss": 1e-4, "grads": 1e-3}
# compiled_path: ResNet-50's eval forward, an NCF train step at its
# published size, SDPA at gemma-2b's prefill shape
COMPILED_RESNET = (64, 224, 1000)
COMPILED_RESNET_TOL = 1e-3         # of the eager logits' RMS
NCF_SIZE = dict(n_users=138_000, n_items=27_000)
NCF_BATCH = 2048
COMPILED_NCF_TOL = {"loss": 1e-5, "grads": 1e-4}
COMPILED_SDPA_SHAPE = (1, 8, 1024, 256)
# masked_sdpa: 4 x (8 query heads over 1 KV head) x 1024 x 256, an
# explicit bool mask; PERF.md's tiers
MASKED_SDPA_SHAPE = (4, 8, 1, 1024, 256)
MASKED_SDPA_TOL = {"float32": (2e-3, 0.0), "bfloat16": (1e-2, 1e-2)}


def gnmt_batch(torch, b: int, s_src: int, s_tgt: int, vocab: int,
               seed: int):
    """Source and target token ids (int32) from numpy."""
    import numpy as np
    import repro_torch as rt

    rng = np.random.default_rng(seed)
    src = rng.integers(0, vocab, (b, s_src)).astype(np.int32)
    tgt = rng.integers(0, vocab, (b, s_tgt)).astype(np.int32)
    return rt.tensor(src), rt.tensor(tgt)


def gnmt(torch, widths: dict):
    """GNMT with weights from ``manual_seed(0)`` and its Adafactor."""
    import repro_torch as rt
    import repro_torch.optim as optim
    from repro_torch.models.paper_models import GNMT

    rt.manual_seed(0)
    model = GNMT(**widths)
    return model, optim.Adafactor(list(model.parameters()), lr=GNMT_LR)


def gnmt_step(model, opt, src, tgt):
    """The user's step: teacher-forced logits of ``tgt[:, :-1]``,
    cross-entropy against ``tgt[:, 1:]``, ``loss.backward()`` on the
    tape, ``optimizer.step()``, inside ``repro_torch.fuse.fusion()``.
    Returns (loss, logits)."""
    import repro_torch as rt
    import repro_torch.nn.functional as F

    opt.zero_grad()
    with rt.fuse.fusion():
        logits = model(src, tgt[:, :-1])
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               tgt[:, 1:].reshape(-1))
        loss.backward()
        opt.step()
    return loss, logits


def phase_gnmt_train(torch, dev):
    """GNMT at full width trained eagerly for ``GNMT_STEPS`` steps on one
    batch: the first step alone (it builds the fused chain's kernel and
    gives the fused launches a step, which must be at least one), then
    the rest timed, each launching exactly as many fused kernels and no
    other kernel of the port; the loss must fall.  Returns the launch
    counts and a function that profiles one more step of a model made
    again from the seed."""
    import repro_torch as rt

    model, opt = gnmt(torch, GNMT_WIDTHS)
    src, tgt = gnmt_batch(torch, GNMT_BATCH, GNMT_SRC, GNMT_TGT,
                          GNMT_WIDTHS["vocab"], 61)
    rt.reset_dispatch_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (first, _), counts1 = counted(
        torch, "the first gnmt_train step",
        lambda: gnmt_step(model, opt, src, tgt), ("fused_elementwise",))
    loss_first = first.item()
    first_s = time.perf_counter() - t0
    per_step = counts1["fused_elementwise"]
    steps = GNMT_STEPS - 1

    def run():
        t = time.perf_counter()
        out = [gnmt_step(model, opt, src, tgt)[0] for _ in range(steps)]
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    (losses, wall), counts = check_launches(
        torch, "the gnmt_train run", run,
        {"fused_elementwise": per_step * steps})
    loss_last = losses[-1].item()
    tokens = GNMT_BATCH * (GNMT_TGT - 1)
    stats = rt.dispatch_cache_stats()
    emit({"phase": "gnmt_train", "model": "gnmt", **GNMT_WIDTHS,
          "batch": GNMT_BATCH, "src_len": GNMT_SRC, "tgt_len": GNMT_TGT,
          "dtype": "float32", "optimizer": "Adafactor", "lr": GNMT_LR,
          "steps": GNMT_STEPS, "timed_steps": steps,
          "first_step_s": first_s, "ms_per_step": wall / steps * 1e3,
          "target_tokens_per_s": tokens * steps / wall,
          "fused_launches_per_step": per_step, "launches": counts,
          "dispatch": {k: v for k, v in stats.items() if k != "per_op"},
          "params": model.num_parameters(), "peak_mem_gb": peak_gb(torch),
          "loss_step1": loss_first, "loss_step10": loss_last})
    if not (math.isfinite(loss_last) and loss_last < loss_first):
        raise AssertionError(f"gnmt_train: the loss did not fall "
                             f"({loss_first} -> {loss_last})")
    del model, opt, losses
    free(torch)

    def profiled():
        model, opt = gnmt(torch, GNMT_WIDTHS)
        gnmt_step(model, opt, src, tgt)

        def one():
            gnmt_step(model, opt, src, tgt)
            torch.cuda.synchronize()

        profile_window(torch, "gnmt_train_profile", one, steps=1)
        del model, opt
        free(torch)

    return counts, profiled


def phase_gnmt_parity(torch, dev) -> None:
    """One step of a GNMT of hidden 256, vocab 4000 and 2 layers on the
    card against the same step on the CPU (the plain path): loss within
    1e-4 relative, gradients within 1e-3 relative L2 over the model; the
    card's step launches the fused kernel."""
    import repro_torch as rt

    b, s_src, s_tgt = GNMT_PARITY_BATCH
    src, tgt = gnmt_batch(torch, b, s_src, s_tgt,
                          GNMT_PARITY_WIDTHS["vocab"], 62)

    def one(device):
        with rt.default_device(device):
            model, opt = gnmt(torch, GNMT_PARITY_WIDTHS)
            loss, _ = gnmt_step(model, opt, rt.Tensor(src.data.to(device)),
                                rt.Tensor(tgt.data.to(device)))
            return loss.item(), [g.cpu() for g in grads_of(model)]

    cpu = one("cpu")
    cuda, counts = counted(torch, "the gnmt_parity CUDA step",
                           lambda: one(dev), ("fused_elementwise",))
    num = sum(float((a - c).pow(2).sum()) for a, c in zip(cpu[1], cuda[1]))
    grads = (num / sum(float(a.pow(2).sum()) for a in cpu[1])) ** 0.5
    res = {"loss": abs(cuda[0] - cpu[0]) / abs(cpu[0]), "grads": grads}
    emit({"phase": "gnmt_parity", **GNMT_PARITY_WIDTHS,
          "batch": GNMT_PARITY_BATCH, "loss_cpu": cpu[0],
          "loss_cuda": cuda[0], "cuda_vs_cpu": res, "tol": GNMT_PARITY_TOL,
          "launches": counts})
    if any(not res[k] <= GNMT_PARITY_TOL[k] for k in res):
        raise AssertionError(f"gnmt_parity: the card and the CPU "
                             f"disagree: {res}")


def graph_breaks(torch) -> int:
    from torch._dynamo.utils import counters
    return sum(counters["graph_break"].values())


def compiled_call(torch, fn, *args) -> tuple:
    """The first call of a ``repro_torch.compile`` function (trace,
    Inductor's compile and one run): (result, seconds, graph breaks it
    added)."""
    breaks = graph_breaks(torch)
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, graph_breaks(torch) - breaks


def compiled_resnet(torch, dev) -> dict:
    """ResNet-50's eval forward at 64 x 224 x 224 fp32, compiled against
    eager: logits within ``COMPILED_RESNET_TOL`` of their RMS."""
    import repro_torch as rt

    b, size, classes = COMPILED_RESNET
    model, _ = resnet(torch, classes)
    model.eval()
    x, _ = eager_batch(torch, b, size, classes, 71)
    with rt.no_grad():
        eager = model(x).data
        cf = rt.compile(lambda t: model(t))
        out, seconds, breaks = compiled_call(torch, cf, x)
        err = ((out.data - eager).abs().max()
               / eager.pow(2).mean().sqrt()).item()
        eager_ms = time_ms(torch, lambda: model(x).data, reps=5)
        compiled_ms = time_ms(torch, lambda: cf(x).data, reps=5)
    (entry,) = cf._compiled.values()
    res = {"model": "resnet50", "batch": b, "image": size,
           "dtype": "float32", "compile_s": seconds,
           "trace_s": entry.seconds, "graph_breaks": breaks,
           "graph_ops": sum(n.op == "call_function"
                            for n in entry.graph.graph.nodes),
           "eager_ms": eager_ms, "compiled_ms": compiled_ms,
           "logits_err_over_rms": err, "tol": COMPILED_RESNET_TOL}
    if not err <= COMPILED_RESNET_TOL:
        raise AssertionError(f"compiled_path: compiled ResNet-50 logits "
                             f"differ from eager: {res}")
    return res


def compiled_ncf(torch, dev) -> dict:
    """``compile(value_and_grad(loss))`` of an NCF train step at its
    published size (138,000 users, 27,000 items, batch 2048) against the
    eager tape's loss and gradients."""
    import numpy as np
    import repro_torch as rt
    import repro_torch.nn as nn
    import repro_torch.nn.functional as F
    from repro_torch.models.paper_models import NCF

    rt.manual_seed(0)
    model = NCF(**NCF_SIZE)
    rng = np.random.default_rng(72)
    users = rt.tensor(rng.integers(0, NCF_SIZE["n_users"], NCF_BATCH)
                      .astype(np.int32))
    items = rt.tensor(rng.integers(0, NCF_SIZE["n_items"], NCF_BATCH)
                      .astype(np.int32))
    labels = rt.tensor(rng.integers(0, 2, NCF_BATCH).astype(np.float32))

    def loss_fn(params, u, i, y):
        return F.binary_cross_entropy_with_logits(
            nn.functional_call(model, params, u, i), y)

    def eager_step():
        model.zero_grad()
        loss = loss_fn(dict(model.named_parameters()), users, items, labels)
        loss.backward()
        return loss

    params = {k: p.detach() for k, p in model.named_parameters()}
    step = rt.compile(rt.value_and_grad(loss_fn))
    (value, grads), seconds, breaks = compiled_call(
        torch, step, params, users, items, labels)
    loss = eager_step().item()
    num = sum(float((grads[k].data - p.grad.data).pow(2).sum())
              for k, p in model.named_parameters())
    den = sum(float(p.grad.data.pow(2).sum()) for p in model.parameters())
    res = {"model": "ncf", **NCF_SIZE, "batch": NCF_BATCH,
           "compile_s": seconds, "graph_breaks": breaks,
           "eager_ms": time_ms(torch, eager_step, reps=5),
           "compiled_ms": time_ms(
               torch, lambda: step(params, users, items, labels), reps=5),
           "loss_eager": loss, "loss_compiled": float(value),
           "loss_rel": abs(float(value) - loss) / abs(loss),
           "grads_rel_l2": (num / den) ** 0.5, "tol": COMPILED_NCF_TOL}
    if not (res["loss_rel"] <= COMPILED_NCF_TOL["loss"]
            and res["grads_rel_l2"] <= COMPILED_NCF_TOL["grads"]):
        raise AssertionError(f"compiled_path: the compiled NCF step "
                             f"differs from the eager tape: {res}")
    return res


def compiled_kernels(torch, dev) -> dict:
    """Inside ``repro_torch.compile``: an unmasked
    ``F.scaled_dot_product_attention`` at gemma-2b's prefill shape (bf16,
    causal) launches the flash kernel exactly once a call and gives the
    eager call's bits; an elementwise chain under ``fusion()`` launches
    no fused kernel (the queue is bypassed) and agrees with the eager
    fused result; and every other kernel launch, called directly inside a
    compiled function, is one operator launched once a call with the
    eager bits (``compiled_launches``)."""
    import repro_torch as rt
    import repro_torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(73)
    q, k, v = (rt.Tensor(torch.randn(COMPILED_SDPA_SHAPE, generator=gen,
                                     device=dev, dtype=torch.bfloat16))
               for _ in range(3))

    def attend(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    eager = attend(q, k, v).data
    cf = rt.compile(attend)
    _, seconds, breaks = compiled_call(torch, cf, q, k, v)
    out, counts = check_launches(torch, "a compiled SDPA call",
                                 lambda: cf(q, k, v).data,
                                 {"flash_attention": 1})
    if not torch.equal(out, eager):
        raise AssertionError("compiled_path: the compiled SDPA call does "
                             "not give the eager call's bits")

    def chain(t):
        with rt.fuse.fusion():
            return ((t * 2.0 + 1.0).tanh() * t).data

    x = rt.Tensor(torch.randn(4096, 1024, generator=gen, device=dev))
    fused_eager = chain(x)
    cchain = rt.compile(chain)
    cchain(x)
    chained, chain_counts = counted(torch, "a compiled fused chain",
                                    lambda: cchain(x), ())
    chain_err = (chained - fused_eager).abs().max().item()
    atol, rtol = FUSED_TOL["float32"]
    res = {"sdpa_shape": COMPILED_SDPA_SHAPE, "sdpa_compile_s": seconds,
           "sdpa_graph_breaks": breaks, "sdpa_launches": counts,
           "sdpa_bits_equal": True, "chain_launches": chain_counts,
           "chain_max_abs_err": chain_err, "chain_tol": FUSED_TOL["float32"],
           "launch_ops": compiled_launches(torch, dev)}
    if any(chain_counts.values()) or not bool(
            ((chained - fused_eager).abs()
             <= atol + rtol * fused_eager.abs()).all()):
        raise AssertionError(f"compiled_path: the fused chain inside "
                             f"compile: {res}")
    return res


def phase_compiled_path(torch, dev) -> None:
    """The jit bridge on the card: compiled ResNet-50 and NCF against
    eager, and the kernels inside a compiled function."""
    resnet_res = compiled_resnet(torch, dev)
    free(torch)
    ncf_res = compiled_ncf(torch, dev)
    free(torch)
    emit({"phase": "compiled_path", "resnet50_forward": resnet_res,
          "ncf_value_and_grad": ncf_res,
          "kernels": compiled_kernels(torch, dev),
          "peak_mem_gb": peak_gb(torch)})
    free(torch)


def phase_masked_sdpa(torch, dev) -> None:
    """``models.attention.sdpa`` with an explicit bool mask (random, every
    row seeing its last key) at 4 x (8 query heads over 1) x 1024 x 256,
    fp32 and bf16, on the card against the CPU, within PERF.md's tiers;
    with the card's ms and that of ``torch``'s SDPA on the same mask."""
    from repro_torch.models import attention as TA

    b, hq, hkv, s, d = MASKED_SDPA_SHAPE
    gen = torch.Generator().manual_seed(74)
    mask = torch.rand((b, 1, s, s), generator=gen) > 0.5
    mask[..., -1] = True
    rows = []
    for name, (atol, rtol) in MASKED_SDPA_TOL.items():
        dt = getattr(torch, name)
        q = torch.randn(b, hq, s, d, generator=gen).to(dt)
        k, v = (torch.randn(b, hkv, s, d, generator=gen).to(dt)
                for _ in range(2))
        ref = TA.sdpa(q, k, v, mask=mask).float()
        qc, kc, vc, mc = (x.to(dev) for x in (q, k, v, mask))
        out = TA.sdpa(qc, kc, vc, mask=mc)
        err = (out.float().cpu() - ref).abs()
        ok = bool((err <= atol + rtol * ref.abs()).all())
        library = torch.nn.functional.scaled_dot_product_attention
        rows.append({"dtype": name, "max_abs_err": err.max().item(),
                     "tol": (atol, rtol), "ok": ok,
                     "ms": time_ms(torch, lambda: TA.sdpa(
                         qc, kc, vc, mask=mc), reps=10),
                     "library_ms": time_ms(torch, lambda: library(
                         qc, kc.expand(b, hq, s, d),
                         vc.expand(b, hq, s, d), attn_mask=mc), reps=10)})
    emit({"phase": "masked_sdpa", "shape": MASKED_SDPA_SHAPE,
          "rows": rows})
    if not all(r["ok"] for r in rows):
        raise AssertionError(f"masked_sdpa: the card and the CPU "
                             f"disagree: {rows}")
    free(torch)


def gemma_models(torch, dev):
    """gemma-2b at full width and depth, random weights from a seeded
    generator on the card: (fp32 config, fp32 params, bf16 config, bf16
    params).  Every gemma-2b phase uses these two copies."""
    from repro_torch.configs import gemma_2b
    from repro_torch.models import lm as LM

    cfg32 = dataclasses.replace(gemma_2b.CONFIG, param_dtype=torch.float32)
    cfg = dataclasses.replace(cfg32, param_dtype=torch.bfloat16)
    params32 = LM.init_params(cfg32, seed=0, device=dev)
    params = LM.cast_params(params32, torch.bfloat16)
    return cfg32, params32, cfg, params


def serving_requests(torch, cfg) -> list:
    """The gemma-2b serving workload: 16 requests, prompts of 128-1024
    tokens, 32 new tokens each; even requests greedy, odd ones
    top-k/top-p sampled from their own seeds."""
    from repro_torch.serving.sampling import SamplingParams

    gen = torch.Generator().manual_seed(1)
    requests = []
    for i in range(MAX_BATCH):
        n = int(torch.randint(128, 1025, (1,), generator=gen))
        prompt = torch.randint(0, cfg.vocab_size, (n,), generator=gen)
        sp = SamplingParams() if i % 2 == 0 else SamplingParams(
            temperature=0.8, top_k=50, top_p=0.95, seed=i)
        requests.append((prompt.tolist(), NEW_TOKENS, sp))
    return requests


def phase_serving(torch, dev, models) -> tuple:
    """gemma-2b serving runs.  Returns the main (bf16) run's launch
    counts, a function that runs it again under the profiler on the bf16
    params it is given, and each run's output tokens by run name."""
    from repro_torch.kernels import decode_attention as DA

    cfg32, params32, cfg, params = models
    requests = serving_requests(torch, cfg)

    runs, main_counts = {}, None
    for name, c, p, reqs, kw in (
            ("bf16", cfg, params, requests, {}),
            ("bf16_int8kv", cfg, params, requests, {"kv_dtype": "int8"}),
            ("fp32_greedy", cfg32, params32,
             [r for r in requests if r[2].greedy], {}),
            ("fp32_greedy_spec2", cfg32, params32,
             [r for r in requests if r[2].greedy], {"spec_k": SPEC_K})):
        (outs, wall, m), counts = counted(
            torch, f"serving run {name}",
            lambda: run_engine(torch, c, p, reqs, dev, **kw))
        runs[name] = outs
        if main_counts is None:
            main_counts = counts
        emit({"phase": "serving", "run": name, "model": c.name,
              "layers": c.n_layers, "requests": len(reqs),
              "new_tokens": sum(n for _, n, _ in reqs),
              "prompt_tokens": sum(len(q) for q, _, _ in reqs),
              "wall_s": wall,
              "tokens_per_s": sum(n for _, n, _ in reqs) / wall,
              "steps": m["steps"], "buckets": m["bucket_compiles"],
              "bucket_count": m["bucket_count"],
              "spec_acceptance_rate": m["spec_acceptance_rate"],
              "kv_dtype": m["kv_dtype"], "launches": counts,
              "paged_variant": DA.variant(c.param_dtype)})
    if runs["fp32_greedy"] != runs["fp32_greedy_spec2"]:
        raise AssertionError("spec_k=2 greedy output differs from "
                             "spec_k=0")
    emit({"phase": "serving_checks", "spec2_equals_spec0": True})

    def profiled(bf16_params):
        emit({"phase": "serving_profile", "run": "bf16",
              **profile_serving(torch, cfg, bf16_params, requests, dev)})
    return main_counts, profiled, runs


# ----------------------------------------------------------------------
# the gathered-cache path (mixed attention, kernel B2) and the serving
# front door: the legacy engine, draft-model speculation, the async
# frontend and the HTTP/SSE server, all over the bf16 gemma-2b model of
# the serving phase
# ----------------------------------------------------------------------

# mixed attention against its plain version: (label, q dtype, cache
# dtype, Hkv, G, D, window).  Rows (a)-(c) and (e) take the paged row's
# own inputs (``paged_inputs``: 16 slots of 128-1024 tokens, T = 256 of
# which 214 live, the rest padding), the pool gathered through its tables
# into (16, 1, 1024, 256) per-slot caches, so row (a) compares directly
# with the paged row; (e) is bf16 q over the fp32 caches that ``gather``
# gives from an int8/fp8 pool.  Row (d) is the reference's ``small``
# serving preset's attention (4 KV heads of 32, G = 2, same slots and
# positions), which the reference itself routes through this kernel
# (head_dim 32 is not lane-aligned).  Every row holds padding tokens.
# Tolerances: kernel_tol (bf16 1e-2 + 1e-2 |ref|; fp32 2e-3, L = 1024).
MIXED_ROWS = (("bf16", "bfloat16", "bfloat16", 1, 8, 256, None),
              ("fp32", "float32", "float32", 1, 8, 256, None),
              ("bf16_window", "bfloat16", "bfloat16", 1, 8, 256, 256),
              ("small_preset", "bfloat16", "bfloat16", 4, 2, 32, None),
              ("bf16_q_fp32_cache", "bfloat16", "float32", 1, 8, 256,
               None))
# paged_vs_gathered: the paged kernel over a live pool against the mixed
# kernel over the same pool gathered, bf16 (the paged check's limit)
PAGED_VS_GATHERED_TOL = 1e-2
SHARED_PREFIX = 512                # tokens the sharing requests have in common
# frontend_serving: 16 streams arriving with seeded exponential gaps of
# mean 20 ms; stream 3 is cancelled by the server after 8 tokens
ARRIVAL_MEAN_S = 0.020
CANCEL_STREAM, CANCEL_AFTER = 3, 8
HTTP_STREAMS, HTTP_NEW_TOKENS = 4, 8


def gathered_caches(torch, x):
    """The paged row's fp32 pool gathered through its tables into
    per-slot contiguous (S, Hkv, P*ps, D) caches."""
    s, p = x["tables"].shape
    ps = x["ps"]
    n, _, hkv, d = x["k32"].shape
    gidx = (x["tables"].long()[:, :, None] * ps
            + torch.arange(ps, device=x["k32"].device)).reshape(s, p * ps)
    return [c.reshape(n * ps, hkv, d)[gidx].transpose(1, 2).contiguous()
            for c in (x["k32"], x["v32"])]


def mixed_bound(seg, pos, window, q, kc, rule=None) -> tuple:
    """Least time for one mixed-attention call: q read once and the
    output written once, seg and pos; every cache key that some token of
    its slot sees, read once (the work depends on the positions);
    operations 4*G*D per visible (token, key) pair and KV head, at the
    ``PEAK_OPS`` rate of ``rule`` (default: bf16 for bf16 q over bf16
    caches, the CUDA cores' fp32 otherwise)."""
    t, hkv, g, d = q.shape
    s, _, l, _ = kc.shape
    spans, pairs = {}, 0
    for sl, p in zip(seg, pos):
        hi = min(p, l - 1)
        lo = max(0, p - window + 1) if window else 0
        if hi >= lo:
            spans.setdefault(min(max(sl, 0), s - 1), []).append((lo, hi))
            pairs += hi - lo + 1
    keys = 0
    for ivs in spans.values():
        end = -1
        for lo, hi in sorted(ivs):
            keys += max(0, hi - max(lo, end + 1) + 1)
            end = max(end, hi)
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * keys * hkv * d * kc.element_size() + 2 * t * 4)
    if rule is None:
        rule = ("bfloat16" if q.element_size() == kc.element_size() == 2
                else "float32")
    return kernel_bound(nbytes, 4 * pairs * hkv * g * d, rule)


def mixed_library_ms(torch, q, kc, vc, seg, pos, window, scale) -> float:
    """One PyTorch call computing the same attention on the same inputs:
    SDPA over the per-token gathered contiguous caches (gathered, and q
    cast to the caches' dtype, outside the timed call), as
    ``sdpa_library_ms``.  A yardstick only; the port never calls it."""
    import torch.nn.functional as F
    t, hkv, g, d = q.shape
    s, _, l, _ = kc.shape
    slot = seg.long().clamp(0, s - 1)
    kt, vt = kc[slot], vc[slot]
    k_pos = torch.arange(l, device=q.device)[None, :]
    p = pos.long()[:, None]
    ok = k_pos <= p
    if window:
        ok = ok & (k_pos > p - window)
    q4 = q.reshape(t, hkv * g, 1, d).to(kc.dtype)
    return time_ms(torch, lambda: F.scaled_dot_product_attention(
        q4, kt, vt, attn_mask=ok[:, None, None, :], scale=scale,
        enable_gqa=True))


def mixed_inputs(torch, dev):
    """The inputs every MIXED_ROWS row shares: the paged row's (seed 11)
    and its pool gathered into per-slot caches."""
    x = paged_inputs(torch, torch.Generator().manual_seed(11), dev)
    return x, gathered_caches(torch, x)


def mixed_row_tensors(torch, dev, x, caches, row) -> tuple:
    """q, k and v of one MIXED_ROWS row: the gathered caches at Hkv = 1,
    seeded random ones (seed 18) otherwise."""
    _, qdt, cdt, hkv, g, d, _ = row
    qdtype, cdtype = getattr(torch, qdt), getattr(torch, cdt)
    kc32, vc32 = caches
    if hkv == 1:
        return (x["q32"].to(qdtype), kc32.to(cdtype), vc32.to(cdtype))
    rg = torch.Generator(device=dev).manual_seed(18)
    s, _, l, _ = kc32.shape
    q = torch.randn((x["seg"].shape[0], hkv, g, d), generator=rg,
                    device=dev).to(qdtype)
    kc, vc = (torch.randn((s, hkv, l, d), generator=rg,
                          device=dev).to(cdtype) for _ in range(2))
    return q, kc, vc


def mixed_plan(torch, DA, x, q, kc, window) -> dict:
    """What the mixed kernel launched for a row (call it just after a
    call): its variant and resources (``DA.mixed_kernel_attributes``),
    the device launches and thread blocks of that call as the C entry
    reports them (``DA.mixed_last_launch``), and the work list (tiles,
    splits) of the device pre-pass, which every variant runs and which
    must equal the plain one (``paged_tiles_plain`` over a table of one
    page of L keys a slot)."""
    t, hkv, g, d = q.shape
    s, _, l, _ = kc.shape
    plan = {**DA.mixed_kernel_attributes(q.dtype, kc.dtype, d),
            **DA.mixed_last_launch()}
    tiling = DA.mixed_tiling(g, l)
    want = DA.paged_tiles_plain(x["seg"].cpu(), x["pos"].cpu(), (s, 1), l,
                                tiling["tile_tokens"], tiling["split_keys"],
                                window)
    got = DA.mixed_tiles(x["seg"], x["pos"], s, l, g, window)
    return {**plan, **worklist_check(torch, "mixed_attention", tiling, want,
                                     got)}


def phase_mixed_attention(torch, dev) -> dict:
    """The mixed-attention kernel against its plain version (rows
    ``MIXED_ROWS``); the first row is the table's.  Each row carries its
    variant ("mma": bf16 q over bf16 caches on the bf16 tensor cores;
    "tf32x3": the fp32-cache pairs on the tensor cores in 3xTF32), the
    device launches and thread blocks of a call, its kernel's resources
    and its work list (``mixed_plan``), and its bound's rule
    (``bound_rule``, a ``PEAK_OPS`` key: "tf32x3" for the fp32-cache
    rows, which also carry the bound at the fp32 CUDA-core rate,
    ``bound_ms_float32``, the parent kernel's); ``ms`` is a single call
    by CUDA events (the wrapper's host time included; ``profile_mixed``
    gives the device's alone)."""
    from repro_torch.kernels import decode_attention as DA

    x, caches = mixed_inputs(torch, dev)
    seg, pos = x["seg"], x["pos"]
    seg_h, pos_h = seg.cpu().tolist(), pos.cpu().tolist()
    result = None
    for spec in MIXED_ROWS:
        label, qdt, cdt, hkv, g, d, window = spec
        q, kc, vc = mixed_row_tensors(torch, dev, x, caches, spec)
        kw = dict(scale=d ** -0.5, window=window)

        def kern():
            return DA.mixed_attention_fwd(q, kc, vc, seg, pos, **kw)

        def plain():
            return DA.mixed_attention_plain(q, kc, vc, seg, pos, **kw)

        out = kern()
        torch.cuda.synchronize()
        ref = plain()
        row = {"phase": "kernel", "name": "mixed_attention", "row": label,
               "q_dtype": qdt, "cache_dtype": cdt, "T": len(seg_h),
               "live_tokens": x["n_live"], "S": int(kc.shape[0]),
               "Hkv": hkv, "G": g, "D": d, "L": int(kc.shape[2]),
               "window": window}
        row.update(check_row(torch, f"mixed_attention[{label}]", out, ref,
                             kernel_tol(qdt, int(kc.shape[2]))))
        row["ms"] = time_ms(torch, kern)
        row["plain_ms"] = time_ms(torch, plain, reps=5)
        row["bound_rule"] = "tf32x3" if cdt == "float32" else "bfloat16"
        row["bound_ms"], row["bound_by"] = mixed_bound(
            seg_h, pos_h, window, q, kc, row["bound_rule"])
        if cdt == "float32":
            row["bound_ms_float32"] = mixed_bound(seg_h, pos_h, window, q,
                                                  kc, "float32")[0]
        row["library_ms"] = mixed_library_ms(torch, q, kc, vc, seg, pos,
                                             window, kw["scale"])
        kern()
        row.update(mixed_plan(torch, DA, x, q, kc, window))
        emit(row)
        if result is None:
            result = row
    return result


def kernel_part(name: str) -> str:
    """A paged or mixed attention kernel's part, by its name."""
    if "tiles" in name:
        return "prepass"
    return "combine" if "combine" in name else "main"


# the MIXED_ROWS rows ``profile_mixed`` reads: (a), the table's, and the
# two fp32-cache rows (b) and (e)
MIXED_PROFILED = ("bf16", "fp32", "bf16_q_fp32_cache")


def profile_mixed(torch, dev) -> dict:
    """Rows ``MIXED_PROFILED`` of MIXED_ROWS under ``profile_kernels``,
    one line each: the device us a call of the pre-pass, the main kernel
    and the combine and in all, and the device launches a call.  Returns
    row (a)'s, the table's.  Run with the profiled runs, last."""
    from repro_torch.kernels import decode_attention as DA

    x, caches = mixed_inputs(torch, dev)
    result = None
    for spec in MIXED_ROWS:
        if spec[0] not in MIXED_PROFILED:
            continue
        q, kc, vc = mixed_row_tensors(torch, dev, x, caches, spec)

        def kern(q=q, kc=kc, vc=vc, spec=spec):
            return DA.mixed_attention_fwd(q, kc, vc, x["seg"], x["pos"],
                                          scale=spec[5] ** -0.5,
                                          window=spec[6])
        kern()
        torch.cuda.synchronize()
        row = {"phase": "mixed_attention_profile", "row": spec[0],
               "variant": DA.mixed_variant(q.dtype, kc.dtype),
               **profile_kernels(torch, kern, DA.mixed_counter,
                                 "mixed_attention",
                                 DA.mixed_last_launch()["device_launches"],
                                 part=kernel_part)}
        emit(row)
        if result is None:
            result = row
    return result


def phase_paged_vs_gathered(torch, dev, cfg, params) -> dict:
    """The gathered-cache path over a live gemma-2b engine's pool: 16
    requests, 8 of them sharing a 512-token prefix (shared pages) with
    ragged tails, stepped until all 16 decode.  For every layer,
    ``kv.gather`` of every live slot, then the mixed kernel over the
    gathered caches (``models.attention.mixed_attention``) and the paged
    kernel over the pool in place, with the same q, segments and
    positions (each slot's last position, a 64-token chunk for two
    slots, padding to 256): they agree within 1e-2.  The run launches
    exactly one mixed and one paged kernel a layer.  Returns its launch
    counts."""
    from repro_torch.models import attention as TA

    base = serving_requests(torch, cfg)
    shared = base[0][0][:SHARED_PREFIX]
    reqs = [(shared + p[:16 + 37 * i % 400], 64, sp) if i % 2 else
            (p, 64, sp) for i, (p, _, sp) in enumerate(base)]
    eng = serving_engine(cfg, params, dev)
    ids = [eng.submit(p, max_new_tokens=n, sampling=sp)
           for p, n, sp in reqs]
    for _ in range(200):
        if all(i in eng.running and eng.running[i].out_tokens
               for i in ids):
            break
        eng.step()
    else:
        raise AssertionError("paged_vs_gathered: the requests never all "
                             "reached decode")
    kv = eng.kv
    seqs = sorted(eng.running)
    lens = [kv.lengths[s] for s in seqs]
    seg, pos = [], []
    for i, n in enumerate(lens):
        first = n - 64 if i < 2 else n - 1
        seg += [i] * (n - first)
        pos += list(range(first, n))
    n_live = len(seg)
    t = 256
    seg += [-1] * (t - n_live)
    pos += [0] * (t - n_live)
    seg_t = torch.tensor(seg, dtype=torch.int32, device=dev)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    width = max(len(kv.tables[s]) for s in seqs)
    tables = torch.zeros((len(seqs), width), dtype=torch.int32)
    for i, s in enumerate(seqs):
        tables[i, :len(kv.tables[s])] = torch.tensor(kv.tables[s])
    tables = tables.to(dev)
    gen = torch.Generator(device=dev).manual_seed(19)
    q = torch.randn((t, cfg.n_heads, cfg.hd), generator=gen,
                    device=dev).to(kv.dtype)
    scale = cfg.query_scale or cfg.hd ** -0.5
    live = seg_t >= 0

    def run():
        errs = []
        for layer in range(cfg.n_layers):
            kc, vc, _ = kv.gather(seqs, layer)
            gathered = TA.mixed_attention(q, kc, vc, seg_t, pos_t,
                                          scale=scale)
            paged = TA.paged_attention(q, kv.k[layer], kv.v[layer], tables,
                                       seg_t, pos_t, scale=scale)
            errs.append((gathered[live].float()
                         - paged[live].float()).abs().max().item())
        return errs

    errs, counts = check_launches(
        torch, "the paged_vs_gathered run", run,
        {"mixed_attention": cfg.n_layers, "paged_attention": cfg.n_layers})
    shared_pages = sum(1 for r in kv.pool.refs.values() if r > 1)
    emit({"phase": "paged_vs_gathered", "model": cfg.name,
          "layers": cfg.n_layers, "sequences": len(seqs),
          "lengths": [min(lens), max(lens)], "T": t, "live_tokens": n_live,
          "prefix_hits": kv.pool.stats.prefix_hits,
          "shared_pages": shared_pages,
          "max_abs_err_first_layer": errs[0],
          "max_abs_err_last_layer": errs[-1], "max_abs_err": max(errs),
          "tol": PAGED_VS_GATHERED_TOL, "launches": counts})
    eng.drain()
    if kv.pool.num_free != kv.pool.num_pages:
        raise AssertionError("paged_vs_gathered: pages leaked")
    if not shared_pages or len(set(lens)) < 2:
        raise AssertionError("paged_vs_gathered: the pool holds no shared "
                             "pages or no ragged tables")
    if not max(errs) <= PAGED_VS_GATHERED_TOL:
        raise AssertionError(f"paged_vs_gathered: the kernels disagree by "
                             f"{max(errs)}")
    return counts


def phase_legacy_serving(torch, dev, cfg, params) -> list:
    """The greedy requests of the serving run through
    ``LegacyServingEngine`` (bf16 gemma-2b, full width and depth): one
    flash launch a layer per prefill (re-prefills included) and one
    decode launch a layer per step, exactly, as its ``prefills`` and
    ``steps`` count them; then the unified engine on the same requests,
    and the ratio of their tokens/s (the reference's gate is unified >=
    1.5x legacy; the ratio is printed, not enforced).  Returns the
    unified run's outputs."""
    from repro_torch.serving.legacy import LegacyServingEngine

    greedy = [r for r in serving_requests(torch, cfg) if r[2].greedy]
    new_tokens = sum(n for _, n, _ in greedy)
    eng = LegacyServingEngine(cfg, params, page_size=PAGE_SIZE,
                              num_pages=1280, max_batch=MAX_BATCH,
                              device=dev)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = [eng.submit(p, max_new_tokens=n) for p, n, _ in greedy]
        done = {r.req_id: r for r in eng.run()}
        torch.cuda.synchronize()
        return [done[i].out_tokens if i in done else None for i in ids], \
            time.perf_counter() - t0

    (outs, wall), counts = counted(
        torch, "the legacy run", run,
        required=("flash_attention", "decode_attention"))
    m = eng.metrics
    want = {"flash_attention": cfg.n_layers * m["prefills"],
            "decode_attention": cfg.n_layers * m["steps"]}
    if any(counts.get(k, 0) != want.get(k, 0)
           for k in set(counts) | set(want)):
        raise AssertionError(f"the legacy run launched {counts}, not {want}")
    for (_, n, _), toks in zip(greedy, outs):
        if toks is None or len(toks) != n or \
                not all(0 <= tok < cfg.vocab_size for tok in toks):
            raise AssertionError("the legacy run did not finish every "
                                 "request in range")
    (u_outs, u_wall, u_m), u_counts = counted(
        torch, "the unified run on the legacy requests",
        lambda: run_engine(torch, cfg, params, greedy, dev))
    tps, u_tps = new_tokens / wall, new_tokens / u_wall
    agree = sum(a == b for x, y in zip(outs, u_outs) for a, b in zip(x, y))
    emit({"phase": "legacy_serving", "model": cfg.name,
          "layers": cfg.n_layers, "requests": len(greedy),
          "new_tokens": new_tokens, "wall_s": wall, "tokens_per_s": tps,
          "prefills": m["prefills"], "steps": m["steps"], "launches": counts,
          "unified_wall_s": u_wall, "unified_tokens_per_s": u_tps,
          "unified_steps": u_m["steps"], "unified_launches": u_counts,
          "unified_over_legacy": u_tps / tps, "reference_gate": 1.5,
          "tokens_equal_to_unified": agree / new_tokens})
    return u_outs


def phase_draft_spec(torch, dev, models, bf16_greedy, fp32_greedy) -> None:
    """``ServingEngine(spec_k=2, proposer=DraftModelProposer(...))`` on
    the serving run's greedy requests; the draft is gemma-2b cut to 2
    layers, from its own seed, window 64.  Every draft token is one
    ``lm.forward`` of the draft, 2 flash launches; the run launches
    exactly that many.  At fp32 weights the output must equal spec_k=0's
    (the ``fp32_greedy`` serving run) token for token; at bf16 the
    agreement with the bf16 spec_k=0 run is printed (bf16 GEMM rounding
    depends on the batch shape, which speculation changes)."""
    from repro_torch.models import lm as LM
    from repro_torch.serving.spec import DraftModelProposer

    class CountingDraft(DraftModelProposer):
        forwards = 0

        def propose(self, history, k):
            out = super().propose(history, k)
            self.forwards += len(out)
            return out

    cfg32, params32, cfg, params = models
    greedy = [r for r in serving_requests(torch, cfg) if r[2].greedy]
    dcfg32 = dataclasses.replace(cfg32, n_layers=2)
    dparams32 = LM.init_params(dcfg32, seed=7, device=dev)
    dcfg = dataclasses.replace(dcfg32, param_dtype=torch.bfloat16)
    for label, c, p, dc, dp, want in (
            ("bf16", cfg, params, dcfg,
             LM.cast_params(dparams32, torch.bfloat16), bf16_greedy),
            ("fp32", cfg32, params32, dcfg32, dparams32, fp32_greedy)):
        draft = CountingDraft(dc, dp, window=64)
        (outs, wall, m), counts = counted(
            torch, f"the draft_spec run {label}",
            lambda: run_engine(torch, c, p, greedy, dev, spec_k=SPEC_K,
                               proposer=draft),
            required=SERVING_KERNELS + ("flash_attention",))
        flash = dcfg.n_layers * draft.forwards
        if counts["flash_attention"] != flash or any(
                counts.get(k, 0) for k in ("decode_attention",
                                           "mixed_attention")):
            raise AssertionError(f"draft_spec {label} launched {counts}, "
                                 f"not {flash} flash")
        n = sum(len(t) for t in outs)
        agree = sum(a == b for x, y in zip(outs, want) for a, b in zip(x, y))
        # greedy tokens that repeat the token before them
        repeats = sum(tok == (req[0] + out)[len(req[0]) + j - 1]
                      for req, out in zip(greedy, outs)
                      for j, tok in enumerate(out))
        emit({"phase": "draft_spec", "run": label, "model": c.name,
              "layers": c.n_layers, "draft_layers": dc.n_layers,
              "window": 64, "spec_k": SPEC_K, "requests": len(greedy),
              "wall_s": wall, "tokens_per_s": n / wall, "steps": m["steps"],
              "proposed_tokens": m["proposed_tokens"],
              "accepted_tokens": m["accepted_tokens"],
              "spec_acceptance_rate": m["spec_acceptance_rate"],
              "draft_forwards": draft.forwards,
              "tokens_repeating_previous": repeats / n,
              "equal_to_spec0": outs == want,
              "tokens_equal_to_spec0": agree / n, "launches": counts})
        if label == "fp32" and outs != want:
            raise AssertionError("draft_spec: spec_k=2 greedy output "
                                 "differs from spec_k=0 at fp32")


def percentile(xs, q: float) -> float:
    """Nearest-rank percentile of a non-empty list."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, math.ceil(q / 100 * len(xs)) - 1))]


def phase_frontend_serving(torch, dev, cfg, params):
    """``AsyncFrontend`` over a bf16 gemma-2b engine, fed the serving
    run's 16 requests as streams that arrive with seeded exponential gaps
    (mean 20 ms); stream 3 is cancelled by the server after 8 tokens.  The
    consumers timestamp the events (the frontend reads no clock).  Fails
    unless every stream ends with exactly one terminal event (the
    cancelled one ``cancelled``, the others ``finished`` with all their
    tokens), no token is dropped, the cancelled request's pages are free
    in the same tick, and ``pool.num_free`` is back at its start after
    ``close()``.  Returns the frontend, for the HTTP phase."""
    import asyncio
    import random
    from repro_torch.serving.frontend import AsyncFrontend

    requests = serving_requests(torch, cfg)
    eng = serving_engine(cfg, params, dev)
    fe = AsyncFrontend(eng, hwm_frac=1.0, low_priority_hwm_frac=1.0)
    pool = eng.kv.pool
    free0 = pool.num_free
    rng = random.Random(20)
    arrivals, t_arr = [], 0.0
    for _ in requests:
        arrivals.append(t_arr)
        t_arr += rng.expovariate(1.0 / ARRIVAL_MEAN_S)
    streams = {}

    async def client(i, delay):
        await asyncio.sleep(delay)
        prompt, n, sp = requests[i]
        rec = streams[i] = {"open": time.perf_counter(), "tokens": [],
                            "terminal": []}
        async for ev in fe.stream(prompt, n, sampling=sp):
            now = time.perf_counter()
            if ev.terminal:
                rec["terminal"].append(ev.kind)
                continue
            rec["tokens"].append(now)
            if i == CANCEL_STREAM and len(rec["tokens"]) == CANCEL_AFTER:
                pages = list(eng.kv.tables[ev.req_id])
                eng.cancel(ev.req_id)          # no await: the same tick
                rec["freed_same_tick"] = (
                    ev.req_id not in eng.kv.tables
                    and all(p not in pool.refs for p in pages))

    async def main():
        runner = asyncio.ensure_future(fe.run())
        t0 = time.perf_counter()
        await asyncio.gather(*(client(i, d) for i, d in enumerate(arrivals)))
        wall = time.perf_counter() - t0
        fe.close()
        await runner
        return wall

    wall, counts = counted(torch, "the frontend run",
                           lambda: asyncio.run(main()))
    ttft = [r["tokens"][0] - r["open"] for r in streams.values()]
    itl = [b - a for r in streams.values()
           for a, b in zip(r["tokens"], r["tokens"][1:])]
    ok_terminals = all(
        r["terminal"] == (["cancelled"] if i == CANCEL_STREAM
                          else ["finished"])
        for i, r in streams.items())
    full = all(len(streams[i]["tokens"]) == requests[i][1]
               for i in streams if i != CANCEL_STREAM)
    row = {"phase": "frontend_serving", "model": cfg.name,
           "layers": cfg.n_layers, "streams": len(streams),
           "arrival_mean_ms": ARRIVAL_MEAN_S * 1e3,
           "arrival_span_ms": arrivals[-1] * 1e3, "wall_s": wall,
           "tokens_streamed": fe.metrics["tokens_streamed"],
           "tokens_per_s": fe.metrics["tokens_streamed"] / wall,
           "ttft_p50_ms": percentile(ttft, 50) * 1e3,
           "ttft_p99_ms": percentile(ttft, 99) * 1e3,
           "itl_p50_ms": percentile(itl, 50) * 1e3,
           "itl_p99_ms": percentile(itl, 99) * 1e3,
           "one_terminal_each": ok_terminals, "full_streams": full,
           "tokens_dropped": fe.metrics["tokens_dropped"],
           "cancelled_freed_same_tick":
               streams[CANCEL_STREAM].get("freed_same_tick", False),
           "pages_leaked": free0 - pool.num_free,
           "steps": eng.metrics["steps"], "launches": counts}
    emit(row)
    if not (ok_terminals and full and row["cancelled_freed_same_tick"]) \
            or row["tokens_dropped"] or row["pages_leaked"]:
        raise AssertionError(f"frontend_serving failed its checks: {row}")
    return fe


def phase_http_server(torch, fe) -> None:
    """``HttpFrontendServer`` on 127.0.0.1, an ephemeral port, over the
    frontend of ``frontend_serving``: 4 concurrent streams through
    ``sse_client`` (a real loopback socket), each must end ``finished``
    with its tokens."""
    import asyncio
    from repro_torch.launch.server import HttpFrontendServer, sse_client

    requests = serving_requests(torch, fe.engine.cfg)

    async def one(server, i):
        toks, terminal = [], []
        async for ev, data in sse_client(
                server.host, server.port,
                {"prompt": requests[i][0][:256],
                 "max_new_tokens": HTTP_NEW_TOKENS}):
            if ev == "token":
                toks.append(data["token"])
            else:
                terminal.append(ev)
        return toks, terminal

    async def main():
        server = HttpFrontendServer(fe, "127.0.0.1", 0)
        await server.start()
        try:
            t0 = time.perf_counter()
            res = await asyncio.gather(*(one(server, i)
                                         for i in range(HTTP_STREAMS)))
            return server.port, res, time.perf_counter() - t0
        finally:
            await server.stop()

    (port, res, wall), counts = counted(torch, "the http_server run",
                                        lambda: asyncio.run(main()))
    ok = [t == ["finished"] and len(toks) == HTTP_NEW_TOKENS
          for toks, t in res]
    emit({"phase": "http_server", "host": "127.0.0.1", "port": port,
          "streams": HTTP_STREAMS, "wall_s": wall,
          "tokens": [len(toks) for toks, _ in res],
          "terminals": [t for _, t in res], "finished": ok,
          "launches": counts})
    if not all(ok):
        raise AssertionError(f"http_server: streams did not finish: {res}")


# ----------------------------------------------------------------------
# step-builder phases (lm.forward / lm.decode_step): the dense-cache
# path of gemma-2b, the rwkv6 path of rwkv6-1.6b and the jamba path
# ----------------------------------------------------------------------

# the kernel each mixer launches in (prefill, decode)
MIXER_KERNELS = {"attn": ("flash_attention", "decode_attention"),
                 "sliding": ("flash_attention", "decode_attention"),
                 "mla": ("flash_attention", "decode_attention"),
                 "rwkv": ("rwkv6_scan", "rwkv6_scan"),
                 "mamba": ("mamba_scan", "mamba_scan")}


def launches_per_pass(cfg, decode: bool) -> dict:
    """Kernel launches of one ``forward`` (or one ``decode_step``): one
    per layer, of its mixer's kernel."""
    want = {}
    for spec in cfg.layer_specs():
        k = MIXER_KERNELS[spec.mixer][decode]
        want[k] = want.get(k, 0) + 1
    return want


def check_launches(torch, what: str, fn, want: dict):
    """``counted`` with exact counts: every kernel of ``want`` launched
    exactly that often in ``fn``, and no other kernel at all."""
    result, counts = counted(torch, what, fn, required=tuple(want))
    if any(counts.get(k, 0) != want.get(k, 0)
           for k in set(counts) | set(want)):
        raise AssertionError(f"{what} launched {counts}, not {want}")
    return result, counts


def head_width(cfg) -> int:
    """The last dim of ``forward``'s output: the vocab, an encoder's
    classes, or d_model for a bare encoder."""
    if cfg.lm_head:
        return cfg.vocab_size
    return cfg.n_classes or cfg.d_model


def phase_prefill(torch, dev, cfg, params, phase: str, seed: int,
                  **fields) -> tuple:
    """bf16 prefill of (4, 1024) tokens through ``make_prefill_step``
    (bf16 N(0, 1) embeddings for an embeddings-mode config): exactly one
    launch of each layer's mixer kernel (flash attention for attn,
    sliding and mla layers, WKV6 for rwkv, the Mamba scan for mamba).
    ``fields`` go into the line.  Returns the run's launch counts, and a
    function that profiles one more prefill on the params it is given."""
    from repro_torch.launch.train import make_prefill_step

    prefill = make_prefill_step(cfg, device=dev)
    b, s = PREFILL_SHAPE
    gen = torch.Generator().manual_seed(seed)
    if cfg.input_mode == "embeddings":
        batch = {"embeds": torch.randn((b, s, cfg.d_model), generator=gen
                                       ).to(dev, torch.bfloat16)}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                         generator=gen).to(dev)}
    torch.cuda.reset_peak_memory_stats()
    prefill(params, batch)                       # warm-up, not counted
    torch.cuda.synchronize()

    def run():
        t0 = time.perf_counter()
        logits = prefill(params, batch)
        torch.cuda.synchronize()
        return logits, time.perf_counter() - t0

    (logits, wall), counts = check_launches(
        torch, f"the {phase} run", run, launches_per_pass(cfg, False))
    if tuple(logits.shape) != (b, s, head_width(cfg)) or \
            not bool(torch.isfinite(logits[:, -1].float()).all()):
        raise AssertionError(f"{phase} logits {tuple(logits.shape)} are "
                             f"not finite (B, S, V)")
    emit({"phase": phase, "model": cfg.name, "layers": cfg.n_layers,
          **fields, "batch": b, "seq": s, "input": next(iter(batch)),
          "wall_ms": wall * 1e3, "tokens_per_s": b * s / wall,
          "launches": counts, "peak_mem_gb": peak_gb(torch)})

    def profiled(params):
        def once():
            prefill(params, batch)
            torch.cuda.synchronize()
        profile_window(torch, f"{phase}_profile", once, batch=b, seq=s)
    return counts, profiled


def phase_decode_steps(torch, dev, cfg, params, phase: str,
                       seed: int) -> tuple:
    """bf16 greedy decode through ``make_serve_step``: 8 rows, 128-token
    prompts fed one token a step, then 64 greedy tokens; exactly one
    launch of each layer's mixer kernel per step (decode attention for
    attn layers, WKV6 or the Mamba scan from the cached state).  Returns
    the run's launch counts, and a function that profiles a window of
    further steps on the params it is given."""
    from repro_torch.launch.train import make_serve_step
    from repro_torch.models import lm as LM

    b = DECODE_BATCH
    serve = make_serve_step(cfg, batch=b, max_seq=DECODE_MAX_SEQ,
                            cache_dtype=torch.bfloat16, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (b, DECODE_PROMPT),
                            generator=torch.Generator().manual_seed(seed))
    prompts = prompts.to(dev)
    torch.cuda.reset_peak_memory_stats()
    warm = LM.init_cache(cfg, b, DECODE_MAX_SEQ, torch.bfloat16, dev)
    serve(params, warm, prompts[:, :1], 0)       # warm-up, not counted
    del warm
    cache = LM.init_cache(cfg, b, DECODE_MAX_SEQ, torch.bfloat16, dev)
    torch.cuda.synchronize()

    def run():
        t0 = time.perf_counter()
        for t in range(DECODE_PROMPT):
            logits, _ = serve(params, cache, prompts[:, t:t + 1], t)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tok = logits[:, -1].argmax(-1, keepdim=True)
        out = [tok]
        for i in range(DECODE_NEW - 1):
            logits, _ = serve(params, cache, tok, DECODE_PROMPT + i)
            tok = logits[:, -1].argmax(-1, keepdim=True)
            out.append(tok)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return torch.cat(out, dim=1), t1 - t0, t2 - t1

    steps = DECODE_PROMPT + DECODE_NEW - 1
    want = {k: n * steps for k, n in launches_per_pass(cfg, True).items()}
    (gen, feed_s, gen_s), counts = check_launches(
        torch, f"the {phase} run", run, want)
    if tuple(gen.shape) != (b, DECODE_NEW) or \
            not bool(((gen >= 0) & (gen < cfg.vocab_size)).all()):
        raise AssertionError(f"{phase} emitted tokens out of range")
    wall = feed_s + gen_s
    emit({"phase": phase, "model": cfg.name, "layers": cfg.n_layers,
          "batch": b, "prompt": DECODE_PROMPT, "new_tokens": DECODE_NEW,
          "steps": steps, "wall_s": wall,
          "decode_tokens_per_s": b * steps / wall,
          "generated_tokens_per_s": b * (DECODE_NEW - 1) / gen_s,
          "ms_per_step": wall * 1e3 / steps, "launches": counts,
          "peak_mem_gb": peak_gb(torch)})

    def profiled(params, window: int = 16):
        def window_steps():
            tok = gen[:, -1:]
            for i in range(window):
                logits, _ = serve(params, cache, tok, steps + i)
                tok = logits[:, -1].argmax(-1, keepdim=True)
            torch.cuda.synchronize()
        profile_window(torch, f"{phase}_profile", window_steps,
                       steps=window)
    return counts, profiled


def phase_parity(torch, dev, cfg32, params32, phase: str, seed: int) -> None:
    """fp32 weights: the last-position logits of ``forward`` on (2, 160)
    tokens against a ``decode_step`` rollout over the same tokens, within
    5e-3 of the logits' RMS (``rollout_parity``'s rtol, stated relative
    because full-width logits are not O(1)), argmax equal on every row.
    The run launches exactly one forward's and 160 decode steps' mixer
    kernels; its line has the run's wall seconds."""
    from repro_torch.models import lm as LM

    b, s = PARITY_SHAPE
    tokens = torch.randint(0, cfg32.vocab_size, (b, s),
                           generator=torch.Generator().manual_seed(seed))
    tokens = tokens.to(dev)
    torch.cuda.reset_peak_memory_stats()

    def run():
        with torch.no_grad():
            full, _ = LM.forward(cfg32, params32, tokens)
            cache = LM.init_cache(cfg32, b, s, torch.float32, dev)
            for t in range(s):
                step, _ = LM.decode_step(cfg32, params32, cache,
                                         tokens[:, t:t + 1], t)
        return full[:, -1].float(), step[:, 0].float()

    want = launches_per_pass(cfg32, False)
    for k, n in launches_per_pass(cfg32, True).items():
        want[k] = want.get(k, 0) + n * s
    t0 = time.perf_counter()
    (pre, dec), counts = check_launches(torch, f"the {phase} run", run,
                                        want)
    wall = time.perf_counter() - t0
    err = (pre - dec).abs().max().item()
    rms = pre.pow(2).mean().sqrt().item()
    agree = (pre.argmax(-1) == dec.argmax(-1)).tolist()
    emit({"phase": phase, "model": cfg32.name, "layers": cfg32.n_layers,
          "dtype": "float32", "batch": b, "seq": s, "wall_s": wall,
          "max_abs_err": err,
          "logits_rms": rms, "err_over_rms": err / rms, "rtol": PARITY_RTOL,
          "argmax_agree": agree, "launches": counts,
          "peak_mem_gb": peak_gb(torch)})
    if not bool(torch.isfinite(pre).all() & torch.isfinite(dec).all()) or \
            not err <= PARITY_RTOL * rms or not all(agree):
        raise AssertionError(f"{phase}: prefill and decode disagree: {err}"
                             f" vs {PARITY_RTOL} x {rms}, argmax {agree}")


def phase_decode_past(torch, dev, cfg, params, phase: str, seed: int,
                      **fields) -> dict:
    """bf16 greedy decode through ``make_serve_step``: ARCH_DECODE_BATCH
    rows, ARCH_DECODE_STEPS steps at positions ARCH_DECODE_PAST onward,
    over a cache whose first ARCH_DECODE_PAST positions hold N(0, 1)
    values from ``seed`` (every entry of every layer: K/V, a sliding
    layer's ring, MLA's latent and roped key), so that each step attends
    a 1024-position past.  Exactly one decode-kernel launch per layer a
    step; the tokens must lie in the vocab.  ``fields`` go into the
    line.  Returns the run's launch counts."""
    from repro_torch.launch.train import make_serve_step
    from repro_torch.models import lm as LM

    b, past, n = ARCH_DECODE_BATCH, ARCH_DECODE_PAST, ARCH_DECODE_STEPS
    serve = make_serve_step(cfg, batch=b, max_seq=ARCH_DECODE_MAX_SEQ,
                            cache_dtype=torch.bfloat16, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.reset_peak_memory_stats()
    cache = LM.init_cache(cfg, b, ARCH_DECODE_MAX_SEQ, torch.bfloat16, dev)
    for entry in cache:
        for t in entry.values():
            # the position axis: 2 of (B, Hkv, S, D) and (B, 1, S, r),
            # 1 of MLA's (B, S, rank); a ring is filled whole
            axis = 1 if t.dim() == 3 else 2
            live = t.narrow(axis, 0, min(past, t.shape[axis]))
            live.copy_(torch.randn(live.shape, generator=gen, device=dev))
    tok = torch.randint(0, cfg.vocab_size, (b, 1),
                        generator=torch.Generator().manual_seed(seed)
                        ).to(dev)
    serve(params, cache, tok, past)              # warm-up, not counted
    torch.cuda.synchronize()

    def run():
        t0 = time.perf_counter()
        cur, out = tok, []
        for i in range(n):
            logits, _ = serve(params, cache, cur, past + i)
            cur = logits[:, -1].argmax(-1, keepdim=True)
            out.append(cur)
        torch.cuda.synchronize()
        return torch.cat(out, dim=1), time.perf_counter() - t0

    want = {k: c * n for k, c in launches_per_pass(cfg, True).items()}
    (gen_tokens, wall), counts = check_launches(
        torch, f"the {phase} run", run, want)
    if tuple(gen_tokens.shape) != (b, n) or \
            not bool(((gen_tokens >= 0) &
                      (gen_tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"{phase} emitted tokens out of range")
    emit({"phase": phase, "model": cfg.name, "layers": cfg.n_layers,
          **fields, "batch": b, "past": past, "steps": n, "wall_s": wall,
          "ms_per_step": wall * 1e3 / n,
          "decode_tokens_per_s": b * n / wall, "launches": counts,
          "peak_mem_gb": peak_gb(torch)})
    return counts


def arch_model(torch, dev, arch: str, n_layers=None, dtype=None,
               **fields):
    """An arch of the configs registry at full width, made at ``dtype``
    (default its own, bf16) directly from seed 0 on the card, optionally
    cut to its first ``n_layers`` layers.  Returns (config, params)."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm as LM

    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers,
                              param_dtype=dtype or cfg.param_dtype,
                              **fields)
    return cfg, LM.init_params(cfg, seed=0, device=dev)


def phase_archs(torch, dev) -> dict:
    """Every ARCH_PHASES arch through its prefill and (for a decoder) its
    decode phase, each model freed before the next; then the fp32 parity
    checks of gemma3 (its rings wrapped) and minicpm3 (MLA at S = 160).
    Returns each arch's prefill and decode launch counts."""
    from repro_torch.configs import get_config

    counts = {}
    for i, (prefix, arch, n_layers) in enumerate(ARCH_PHASES):
        cfg, params = arch_model(torch, dev, arch, n_layers)
        cut = {}
        if n_layers:
            cut = {"cut": f"first {n_layers} of "
                          f"{get_config(arch).n_layers} layers"}
        counts[f"{prefix}_prefill"], _ = phase_prefill(
            torch, dev, cfg, params, f"{prefix}_prefill", 50 + 2 * i, **cut)
        if cfg.lm_head:
            counts[f"{prefix}_decode"] = phase_decode_past(
                torch, dev, cfg, params, f"{prefix}_decode", 51 + 2 * i,
                **cut)
        del params
        free(torch)
    cfg32, params32 = arch_model(torch, dev, "gemma3-1b",
                                 GEMMA3_PARITY_LAYERS, torch.float32,
                                 window=GEMMA3_PARITY_WINDOW)
    phase_parity(torch, dev, cfg32, params32, "gemma3_parity", 70)
    del params32
    free(torch)
    cfg32, params32 = arch_model(torch, dev, "minicpm3-4b",
                                 MINICPM3_PARITY_LAYERS, torch.float32)
    phase_parity(torch, dev, cfg32, params32, "minicpm3_parity", 71)
    del params32
    free(torch)
    return counts


def phase_head_padding(torch, dev) -> None:
    """The cost of padding head widths the kernels lack
    (``models.attention.padded_call``) at the main paths' shapes: each
    PADDING_ROWS case's padded call (the pads, the kernel at 128, the
    cut) against the plain version at the caller's width, then by CUDA
    events the whole call, the kernel alone on already padded operands
    and the three pads alone."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops as kops
    from repro_torch.models import attention as TA

    for label, dt, b, hq, hkv, sq, skv, dqk, dv, causal in PADDING_ROWS:
        dtype = getattr(torch, dt)
        gen = torch.Generator(device=dev).manual_seed(16)
        q = torch.randn((b, hq, sq, dqk), generator=gen, device=dev
                        ).to(dtype)
        k = torch.randn((b, hkv, skv, dqk), generator=gen, device=dev
                        ).to(dtype)
        v = torch.randn((b, hkv, skv, dv), generator=gen, device=dev
                        ).to(dtype)
        width = TA.padded_width(dqk, dv)
        scale = dqk ** -0.5
        if sq == 1:
            lens = torch.full((b,), skv, dtype=torch.int32, device=dev)

            def call():
                return TA.decode_attention(q, k, v, lens)

            def kernel(qp, kp, vp):
                return kops.decode_attention(qp, kp, vp, lens, scale=scale)

            def plain():
                return TA.sdpa_ref(q, k, v, scale=scale)
        else:
            def call():
                return TA.sdpa(q, k, v, is_causal=causal)

            def kernel(qp, kp, vp):
                return kops.flash_attention(qp, kp, vp, causal=causal,
                                            scale=scale)

            def plain():
                return TA.sdpa_ref(q, k, v, is_causal=causal, scale=scale)

        def pads():
            return [F.pad(x, (0, width - x.shape[-1])) for x in (q, k, v)]
        qp, kp, vp = pads()
        out = call()
        torch.cuda.synchronize()
        row = {"phase": "head_padding", "row": label, "dtype": dt, "B": b,
               "Hq": hq, "Hkv": hkv, "Sq": sq, "Skv": skv, "D_qk": dqk,
               "D_v": dv, "padded_to": width, "causal": causal}
        row.update(check_row(torch, f"head_padding[{label}]", out, plain(),
                             kernel_tol(dt, skv)))
        row["call_ms"] = time_ms(torch, call)
        row["kernel_ms"] = time_ms(torch, lambda: kernel(qp, kp, vp))
        row["pad_ms"] = time_ms(torch, pads)
        row["pad_share"] = row["pad_ms"] / row["call_ms"]
        emit(row)


def rwkv_models(torch, dev):
    """rwkv6-1.6b at full width and depth (24 layers), random weights
    from a seeded generator on the card: (fp32 config, fp32 params, bf16
    config, bf16 params), the bf16 copy made by ``cast_params``."""
    from repro_torch.configs import rwkv6_1_6b
    from repro_torch.models import lm as LM

    cfg32 = dataclasses.replace(rwkv6_1_6b.CONFIG, param_dtype=torch.float32)
    cfg = dataclasses.replace(cfg32, param_dtype=torch.bfloat16)
    params32 = LM.init_params(cfg32, seed=0, device=dev)
    params = LM.cast_params(params32, torch.bfloat16)
    return cfg32, params32, cfg, params


def jamba_model(torch, dev, dtype, n_layers: int, **fields):
    """jamba-1.5-large at full width, cut to its first ``n_layers``
    layers (of its own pattern, or of a ``pattern`` in ``fields``), made
    at ``dtype`` directly from a seeded generator on the card (5 layers
    at bf16 are 48.1 GB; the fp32 model of 5 would be 96 GB, so the bf16
    one is never a cast of it).  Returns (config, params)."""
    from repro_torch.configs import jamba_1_5_large_398b as jamba
    from repro_torch.models import lm as LM

    cfg = dataclasses.replace(jamba.CONFIG, n_layers=n_layers,
                              param_dtype=dtype, **fields)
    return cfg, LM.init_params(cfg, seed=0, device=dev)


def free(torch) -> None:
    """Return the memory of dropped models to the card."""
    gc.collect()
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# LM training: the data loader, train_loop at full width, the profiled
# step, parity against the CPU, restart
# ----------------------------------------------------------------------

def phase_data_loader(torch, dev) -> None:
    """``SyntheticLMDataset(256000, 1024)`` through ``DataLoader`` (batch
    4, 2 workers, shuffled with seed 0) onto the card, with and without
    pinned staging, two passes of ``LOADER_BATCHES`` batches each (the
    second timed): the batches equal bit for bit; every staging buffer
    was page-locked and every copy was issued on the loader's copy
    stream, not the default one."""
    from repro_torch.core import allocator
    from repro_torch.data import DataLoader, SyntheticLMDataset

    b, s = LM_TRAIN_SHAPE
    ds = SyntheticLMDataset(256000, s, seed=0)

    def run(pin: bool):
        # two passes over the same batches: the second is timed (the
        # first starts the worker threads and fills the pinned pool)
        dl = DataLoader(ds, batch_size=b, shuffle=True, seed=0,
                        num_workers=2, pin_memory=pin)
        for _ in range(2):
            it, out = iter(dl), []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(LOADER_BATCHES):
                tokens, labels = next(it)
                out.append((tokens.data, labels.data))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            it.close()
        return dl, out, wall

    host0 = allocator.host_allocator().memory_stats()
    _, plain, plain_s = run(False)
    dl, pinned, pinned_s = run(True)
    host1 = allocator.host_allocator().memory_stats()
    equal = all(torch.equal(a, c) and torch.equal(b_, d)
                for (a, b_), (c, d) in zip(plain, pinned))
    st = dl.staging
    copy_id = dl._copy_stream.cuda_stream().stream_id
    default_id = torch.cuda.default_stream().stream_id
    emit({"phase": "data_loader", "dataset": "SyntheticLMDataset",
          "vocab": 256000, "batch": b, "seq": s, "workers": 2,
          "batches": LOADER_BATCHES,
          "unpinned_batches_per_s": LOADER_BATCHES / plain_s,
          "pinned_batches_per_s": LOADER_BATCHES / pinned_s,
          "staged_copies": st.copies, "staged_bytes": st.bytes,
          "all_pinned": st.all_pinned, "copy_streams": sorted(st.streams),
          "copy_stream": copy_id, "default_stream": default_id,
          "host_allocator_blocks": host1["num_cache_hits"]
          - host0["num_cache_hits"] + host1["num_cache_misses"]
          - host0["num_cache_misses"],
          "host_allocator_peak_bytes_active": host1["peak_bytes_active"],
          "pinned_equal_unpinned": equal})
    if not equal or len(pinned) != LOADER_BATCHES:
        raise AssertionError("data_loader: pinned batches differ from the "
                             "unpinned ones")
    if st.copies != 4 * LOADER_BATCHES or \
            st.bytes != 4 * LOADER_BATCHES * b * s * 4 or \
            not st.all_pinned or st.streams != {copy_id} or \
            copy_id == default_id:
        raise AssertionError(f"data_loader: the staging path did not run "
                             f"as designed: {st}, copy stream {copy_id}, "
                             f"default {default_id}")


def lm_param_count(cfg) -> int:
    """Parameters of an attn/dense LM config (embedding included)."""
    d, hd = cfg.d_model, cfg.hd
    attn = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + cfg.n_heads * hd * d
    mlp = (3 if cfg.gated_mlp else 2) * d * cfg.d_ff
    head = 0 if cfg.tie_embeddings else d * cfg.vocab_size
    return cfg.vocab_size * d + cfg.n_layers * (attn + mlp + 2 * d) + d + \
        head


def phase_lm_train(torch, dev) -> dict:
    """gemma-2b at full width and depth (bf16, remat "full") trained for
    ``LM_TRAIN_STEPS`` steps through ``train_loop`` (AdamW, lr 3e-4,
    clip 1.0, batches of 4 x 1024 from the data loader): every loss and
    grad norm finite, and exactly 2 x 18 flash launches a step (the
    forward, then the remat recompute in the backward pass), no other
    kernel.  Returns the run's launch counts."""
    from repro_torch.configs import gemma_2b
    from repro_torch.launch.train import train_loop

    cfg = gemma_2b.CONFIG
    b, s = LM_TRAIN_SHAPE
    per_step = {k: 2 * n for k, n in launches_per_pass(cfg, False).items()}
    want = {k: n * LM_TRAIN_STEPS for k, n in per_step.items()}
    torch.cuda.reset_peak_memory_stats()
    res, counts = check_launches(
        torch, "the lm_train run",
        lambda: train_loop(cfg, steps=LM_TRAIN_STEPS, batch_size=b,
                           seq_len=s, optimizer="adamw", lr=LM_TRAIN_LR,
                           log_every=LM_TRAIN_STEPS, seed=0, device=dev),
        want)
    times = res["step_times_s"]
    ms = sorted(times[2:])[len(times[2:]) // 2] * 1e3
    finite = all(math.isfinite(x) for x in res["losses"] + res["grad_norms"])
    params = lm_param_count(cfg)
    emit({"phase": "lm_train", "model": cfg.name, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "heads": f"{cfg.n_heads}x{cfg.hd}",
          "kv_heads": cfg.n_kv_heads, "vocab": cfg.vocab_size,
          "dtype": "bfloat16", "remat": cfg.remat, "params": params,
          "batch": b, "seq": s, "optimizer": "adamw", "lr": LM_TRAIN_LR,
          "grad_clip": 1.0, "steps": res["steps"],
          "first_step_s": times[0], "ms_per_step": ms,
          "step_ms": [t * 1e3 for t in times],
          "target_tokens_per_s": b * s / (ms / 1e3),
          "model_tflops_per_s": 8 * params * b * s / (ms / 1e3) / 1e12,
          "peak_mem_gb": peak_gb(torch), "losses": res["losses"],
          "grad_norms": res["grad_norms"], "launches": counts,
          "flash_launches_per_step": counts["flash_attention"]
          / LM_TRAIN_STEPS})
    if res["steps"] != LM_TRAIN_STEPS or not finite:
        raise AssertionError(f"lm_train: {res['steps']} steps, losses "
                             f"{res['losses']}, norms {res['grad_norms']}")
    free(torch)
    return counts


LOSS_GROUP, OPT_GROUP = "loss_and_log_softmax", "optimizer"
BACKWARD_EVENT = "autograd::engine::evaluate_function: "


def lm_train_device_time(prof) -> dict:
    """Device ms of one profiled train step by group: the flash kernel
    (forward and remat recompute) by its name; the kernels under a
    ``_FlashAttentionBackward`` autograd node (the plain version's ops
    the backward differentiates); the loss's own ops (inside
    ``lm.LOSS_RANGE``) and their backward nodes, matched by sequence
    number; the clip and the optimizer update (``train.OPT_RANGE``);
    then matmuls by kernel name and everything else.  Kernels the
    profiler links to no host op are ``unlinked``."""
    from repro_torch.launch.train import OPT_RANGE
    from repro_torch.models.lm import LOSS_RANGE

    events = prof.events()
    loss_ops = set()

    def mark(ev, inside: bool) -> None:
        inside = inside or ev.name == LOSS_RANGE
        if inside and ev.sequence_nr >= 0:
            loss_ops.add((ev.thread, ev.sequence_nr))
        for child in ev.cpu_children:
            mark(child, inside)

    for ev in events:
        if ev.cpu_parent is None:
            mark(ev, False)

    def context(ev):
        up = ev
        while up is not None:          # ranges first, then loss nodes
            if up.name == OPT_RANGE:
                return OPT_GROUP
            if up.name == LOSS_RANGE:
                return LOSS_GROUP
            if up.name.startswith(BACKWARD_EVENT) and \
                    "_FlashAttentionBackward" in up.name:
                return "flash_backward"
            up = up.cpu_parent
        up = ev
        while up is not None:
            if up.name.startswith(BACKWARD_EVENT) and (
                    getattr(up, "fwd_thread", up.thread),
                    up.sequence_nr) in loss_ops:
                return LOSS_GROUP
            up = up.cpu_parent
        return None

    groups, calls, linked = {}, {}, {}
    for ev in events:
        if not ev.kernels:
            continue
        ctx = context(ev)
        for k in ev.kernels:
            g = "flash_forward" if "flash_attention" in k.name else \
                ctx or _kernel_group(k.name)
            if g not in ("flash_forward", "flash_backward", LOSS_GROUP,
                         OPT_GROUP, "matmul"):
                g = "other"
            groups[g] = groups.get(g, 0.0) + k.duration / 1e3
            calls[g] = calls.get(g, 0) + 1
            linked[k.name] = linked.get(k.name, 0.0) + k.duration / 1e3
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if not us or "CUDA" not in str(ev.device_type) or \
                ev.key in (LOSS_RANGE, OPT_RANGE, MOE_RANGE):
            continue
        rest = us / 1e3 - linked.get(ev.key, 0.0)
        if rest > 1e-3:
            groups["unlinked"] = groups.get("unlinked", 0.0) + rest
    return {"ms": groups, "calls": calls}


def profile_lm_train(torch, dev) -> None:
    """One lm_train step (gemma-2b, full width and depth, the same
    batch shape) under ``torch.profiler``: device ms by group, the idle
    share of the step's wall clock and the peak memory; then the flash
    backward alone at the step's shapes: its device ms a call and the
    memory it adds above its inputs (the plain version's score
    tensors)."""
    from repro_torch.configs import gemma_2b
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.train import init_train_state, make_train_step
    from torch.profiler import ProfilerActivity, profile

    cfg = gemma_2b.CONFIG
    b, s = LM_TRAIN_SHAPE
    ds = SyntheticLMDataset(cfg.vocab_size, s, seed=0)
    import numpy as np
    items = [ds[i] for i in range(b)]
    batch = {"tokens": torch.from_numpy(np.stack([t for t, _ in items])),
             "labels": torch.from_numpy(np.stack([l for _, l in items]))}
    state = init_train_state(cfg, optimizer="adamw", lr=LM_TRAIN_LR,
                             device=dev)
    step = make_train_step(cfg, optimizer="adamw", lr=LM_TRAIN_LR,
                           device=dev)
    step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, m = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = peak_gb(torch)
    loss = float(m["loss"])
    by = lm_train_device_time(prof)
    busy = sum(by["ms"].values())
    del state, step, m, prof
    free(torch)

    # the flash backward alone: q (4, 8, 1024, 256), k/v (4, 1, 1024, 256)
    gen = torch.Generator(device=dev).manual_seed(71)
    q = torch.randn(b, cfg.n_heads, s, cfg.hd, device=dev, generator=gen,
                    dtype=torch.bfloat16).requires_grad_()
    k, v = (torch.randn(b, cfg.n_kv_heads, s, cfg.hd, device=dev,
                        generator=gen, dtype=torch.bfloat16
                        ).requires_grad_() for _ in range(2))
    out = kops.flash_attention(q, k, v, causal=True)
    grad = torch.randn_like(out)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.autograd.grad(out, (q, k, v), grad, retain_graph=True)
    torch.cuda.synchronize()
    bwd_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
        out, (q, k, v), grad, retain_graph=True), reps=10, warmup=2)
    emit({"phase": "lm_train_profile", "model": cfg.name,
          "layers": cfg.n_layers, "batch": b, "seq": s, "steps": 1,
          "wall_ms": wall * 1e3, "device_ms_by_group": by["ms"],
          "device_calls_by_group": by["calls"], "device_busy_ms": busy,
          "device_idle_share": max(0.0, 1.0 - busy / (wall * 1e3)),
          "flash_backward_share_of_busy":
              by["ms"].get("flash_backward", 0.0) / busy,
          "peak_mem_gb": peak, "loss": loss,
          "flash_backward_call_ms": bwd_ms,
          "flash_backward_transient_gb": bwd_gb,
          "flash_backward_share_of_peak": bwd_gb / peak})
    del q, k, v, out, grad
    free(torch)


def parity_models(torch):
    """The three SMOKE configs at fp32 with remat "full"."""
    from repro_torch.configs import gemma_2b, jamba_1_5_large_398b, \
        rwkv6_1_6b

    return (("gemma", gemma_2b.SMOKE), ("jamba", jamba_1_5_large_398b.SMOKE),
            ("rwkv6", rwkv6_1_6b.SMOKE))


def phase_lm_train_parity(torch, dev) -> None:
    """fp32 gemma (2 layers), jamba (mamba, MoE with its aux loss,
    attention) and rwkv6 SMOKE models, remat "full", the same weights and
    (4, 64) batch on the card and on the CPU: ``lm_loss`` within 1e-5
    relative and its gradients within 1e-4 relative L2; then 3 SGD steps
    of ``make_train_step`` within 1e-4 relative, and 20 on the card on
    the repeated batch, whose loss must fall by ``LM_PARITY_FALL``.  Each
    card run launches its mixer kernels exactly twice a layer a pass
    (forward and recompute) and no other kernel (decode, paged and mixed
    attention 0)."""
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import lm as LM
    from repro_torch.optim.functional import (make_optimizer, tree_leaves,
                                              tree_map)

    b, s = LM_PARITY_SHAPE
    for name, smoke in parity_models(torch):
        cfg = dataclasses.replace(smoke, remat="full")
        params = LM.init_params(cfg, seed=0, device="cpu")
        toks = torch.randint(0, cfg.vocab_size, (b, s + 1),
                             generator=torch.Generator().manual_seed(5))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        per_pass = {k: 2 * n for k, n in launches_per_pass(cfg, False).items()}

        def grads(device):
            tree = tree_map(lambda x: x.detach().to(device)
                            .requires_grad_(), params)
            leaves = tree_leaves(tree)
            loss = LM.lm_loss(cfg, tree, {k: v.to(device)
                                          for k, v in batch.items()})
            g = torch.autograd.grad(loss, leaves)
            return loss.item(), [x.cpu() for x in g]

        def steps(device, n):
            # a copy: the step updates it in place
            p = tree_map(lambda x: x.to(device, copy=True), params)
            state = {"params": p,
                     "opt": make_optimizer("sgd", lr=LM_PARITY_LR)[0](p),
                     "step": torch.zeros((), dtype=torch.int32,
                                         device=device)}
            step = make_train_step(cfg, optimizer="sgd", lr=LM_PARITY_LR,
                                   device=device)
            return [float(step(state, batch)[1]["loss"]) for _ in range(n)]

        cpu_loss, cpu_g = grads("cpu")
        (card_loss, card_g), c1 = check_launches(
            torch, f"the lm_train_parity {name} gradients",
            lambda: grads(dev), per_pass)
        cpu_steps = steps("cpu", 3)
        card_steps, c2 = check_launches(
            torch, f"the lm_train_parity {name} steps",
            lambda: steps(dev, LM_PARITY_STEPS),
            {k: n * LM_PARITY_STEPS for k, n in per_pass.items()})
        loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
        num = sum(float((x - y).double().pow(2).sum())
                  for x, y in zip(card_g, cpu_g))
        den = sum(float(y.double().pow(2).sum()) for y in cpu_g)
        grad_rel = (num / den) ** 0.5
        step_rel = max(abs(a - c) / abs(c)
                       for a, c in zip(card_steps, cpu_steps))
        fall = card_steps[0] - card_steps[-1]
        emit({"phase": "lm_train_parity", "model": cfg.name,
              "layers": cfg.n_layers, "dtype": "float32",
              "remat": cfg.remat, "batch": b, "seq": s,
              "loss_cpu": cpu_loss, "loss_card": card_loss,
              "loss_rel": loss_rel, "grads_rel_l2": grad_rel,
              "sgd_lr": LM_PARITY_LR, "cpu_losses": cpu_steps,
              "card_losses": card_steps, "steps_rel": step_rel,
              "fall": fall, "least_fall": LM_PARITY_FALL[name],
              "tol": LM_PARITY_TOL, "launches_per_step": c1})
        if not loss_rel <= LM_PARITY_TOL["loss"] or \
                not grad_rel <= LM_PARITY_TOL["grads"] or \
                not step_rel <= LM_PARITY_TOL["steps"] or \
                not fall >= LM_PARITY_FALL[name]:
            raise AssertionError(
                f"lm_train_parity {name}: loss {loss_rel}, grads "
                f"{grad_rel}, steps {step_rel}, fall {fall} (tolerances "
                f"{LM_PARITY_TOL}, least fall {LM_PARITY_FALL[name]})")


def phase_lm_restart(torch, dev) -> None:
    """gemma SMOKE at bf16 (its norms fp32) on the card: ``train_loop``
    with a checkpoint directory for 7 steps, then called again with
    ``steps=10``, must report 3 steps; a state after 2 steps saved with
    ``save_async`` and restored into another state equals it bit for
    bit, every bf16 leaf included.  The line has the save's stall on the
    step loop (the call's host time, the host copy of every leaf), the
    step's time beside it, and the background write's time."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import gemma_2b
    from repro_torch.launch.train import (init_train_state, make_train_step,
                                          train_loop)
    from repro_torch.optim.functional import tree_leaves

    cfg = dataclasses.replace(gemma_2b.SMOKE, param_dtype=torch.bfloat16,
                              remat="full")
    b, s = LM_PARITY_SHAPE
    with tempfile.TemporaryDirectory() as d:
        kw = dict(batch_size=b, seq_len=s, optimizer="adamw", lr=1e-3,
                  checkpoint_dir=os.path.join(d, "loop"),
                  checkpoint_every=3, log_every=100, device=dev)
        first = train_loop(cfg, steps=7, **kw)
        second = train_loop(cfg, steps=10, **kw)

        state = init_train_state(cfg, optimizer="adamw", lr=1e-3, seed=1,
                                 device=dev)
        step = make_train_step(cfg, lr=1e-3, device=dev)
        toks = torch.randint(0, cfg.vocab_size, (b, s + 1),
                             generator=torch.Generator().manual_seed(6))
        batch = {"tokens": toks[:, :-1].to(dev),
                 "labels": toks[:, 1:].to(dev)}
        for _ in range(2):
            step(state, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        mgr = CheckpointManager(os.path.join(d, "state"))
        t0 = time.perf_counter()
        mgr.save_async(state, 3)
        stall_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        mgr.wait()
        write_ms = (time.perf_counter() - t0) * 1e3
        like = init_train_state(cfg, optimizer="adamw", lr=1e-3, seed=2,
                                device=dev)
        restored = mgr.restore(3, like)
    saved, back = tree_leaves(state), tree_leaves(restored)
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32,
            torch.int32: torch.int32}
    exact = len(saved) == len(back) and all(
        x.dtype == y.dtype and x.device == y.device and
        torch.equal(x.view(bits[x.dtype]), y.view(bits[y.dtype]))
        for x, y in zip(saved, back))
    n_bf16 = sum(x.dtype == torch.bfloat16 for x in saved)
    emit({"phase": "lm_restart", "model": cfg.name, "dtype": "bfloat16",
          "batch": b, "seq": s, "first_call_steps": first["steps"],
          "second_call_steps": second["steps"], "restored_bits_equal": exact,
          "leaves": len(saved), "bf16_leaves": n_bf16,
          "state_bytes": sum(x.numel() * x.element_size() for x in saved),
          "step_ms": step_ms, "save_async_stall_ms": stall_ms,
          "background_write_ms": write_ms})
    if first["steps"] != 7 or second["steps"] != 3 or not exact or \
            not n_bf16:
        raise AssertionError(f"lm_restart: steps {first['steps']} then "
                             f"{second['steps']}, bits equal {exact}")


# ----------------------------------------------------------------------
# the distributed slice: the paged kernel's lse, every launch under
# compile, data replicas on one card, sharded serving on a mesh of ranks,
# DDP and the pipeline
# ----------------------------------------------------------------------

# the paged kernel's log-sum-exp output against the plain version's
LSE_RTOL = 1e-5
LSE_CASES = (("bfloat16", "bfloat16"), ("float32", "float32"))
# replicas on one card: turns of the 16 serving requests at n_replicas=2
REPLICA_TURNS = 2
# sharded serving: the fp32 parity meshes (gemma-2b at full width cut to
# 2 layers, greedy and sampled), the bf16 full-depth meshes
SHARDED_MESHES = ((2, 1), (1, 2), (2, 2))
SHARDED_BF16_MESHES = ((1, 2), (2, 2))
SHARDED_PARITY_LAYERS = 2
SHARDED_SEED = 5
SHARDED_SAMPLED = dict(temperature=0.8, top_k=20, seed=42)
# DDP: Linear(16, W) -> ReLU -> Linear(W, 4), 2 ranks each on half of the
# batch; buckets of 0.05 MB give two (the second layer, the first)
DDP_WIDTH = 4096
DDP_BATCH = 64
DDP_BUCKET_MB = 0.05
DDP_TOL = 1e-5                     # of the full-batch gradient's max
# the pipeline: 4 stages of tanh(x @ w), 4 microbatches, fp32
PIPE_WIDTH, PIPE_BATCH, PIPE_MICRO, PIPE_STAGES = 2048, 256, 4, 4
PIPE_TOL = (2e-4, 2e-5)            # the reference test's rtol, atol
RANK_TIMEOUT = 900                 # seconds a group of ranks may take
# meshed training (sharded_train): fp32 parity on the sharded serving
# model (gemma-2b at full width cut to 2 layers), a global 4 x 256 batch,
# 2 AdamW steps, each against the one-process step on the card from the
# same state (rank 0 runs it); bf16 throughput on gemma-2b at full width,
# remat "full", a global 4 x 1024 batch, 1 warm-up and 3 timed steps
SHARDED_TRAIN_BATCH = (4, 256)
SHARDED_TRAIN_LR = 1e-3
# loss and grad norm relative; gradients of each leaf's largest; AdamW's
# moments relative to each leaf's largest.  The parameters: AdamW moves
# an element by lr * g / (|g| + eps) at step 1, so a gradient element
# near eps moves by up to 2 lr more or less in the other run; all but 1
# in 100 of a leaf's elements within 1e-5 of its largest.
SHARDED_TRAIN_TOL = {"loss": 1e-5, "grads": 1e-5, "moments": 1e-5,
                     "params": 1e-5, "params_beyond_frac": 1e-2}
SHARDED_TRAIN_BF16_MESHES = ((2, 2), (1, 2))
SHARDED_TRAIN_BF16_BATCH = (4, 1024)
SHARDED_TRAIN_BF16_LAYERS = 18     # gemma-2b's depth
SHARDED_TRAIN_BF16_STEPS = (1, 3)  # warm-up, timed
# the dry run's predictions of the bf16 run against rank 0's measurements
# (relative), the production cells it traces, and its time limit
DRYRUN_HELD_TOL, DRYRUN_PEAK_TOL = 0.05, 0.15
DRYRUN_CELLS = ("train_4k", "prefill_32k", "decode_32k")
DRYRUN_SECONDS = 60.0
# sharded_decode: the sharded serving model at fp32 through the meshed
# prefill and serve steps, 8 rows, 8-token prompts fed one token a step,
# then 16 greedy steps
SHARDED_DECODE_MESHES = ((1, 2), (2, 2))
SHARDED_DECODE_ROWS, SHARDED_DECODE_PROMPT = 8, 8
SHARDED_DECODE_STEPS = 16
# sharded_decode's sliding run: gemma3-1b at full width cut to its
# first 2 layers (both sliding) at fp32 on (1,2): its one KV head
# splits each sliding layer's 512-slot ring over model, and 520 steps
# after the 8-token prompt wrap the ring.  The meshed run is fed the
# no-mesh run's greedy tokens; each of its steps' logits must rank that
# token first within SLIDING_TOL of the logits' RMS (a near-tie may go
# either way at fp32 over 4160 choices), and its whole logits at
# SLIDING_RECORD (before the ring's half, past it, past the wrap) must
# equal the no-mesh run's within SLIDING_TOL of their RMS
SLIDING_DECODE_LAYERS, SLIDING_DECODE_STEPS = 2, 520
SLIDING_DECODE_MESH = (1, 2)
SLIDING_RECORD = (100, 300, 515)
SLIDING_TOL = 1e-3
# elastic_restore: gemma-2b's SMOKE config at fp32, a global 4 x 64 batch
ELASTIC_BATCH = (4, 64)
# meshed_blocks: MoE, mamba and rwkv blocks on a model axis of 2, in
# phase_sharded's rank groups ((1,2) in the 2-rank group, (2,2) in the
# 4-rank one).  meshed_blocks_parity (fp32): the train step, 2 AdamW
# steps on a global 4 x 64 batch, against the one-process step rank 0
# runs on the card (every rank waiting with its cache emptied), on
# jamba's SMOKE config and on qwen2-moe-a2.7b and rwkv6-1.6b at full
# width cut to BLOCKS_LAYERS; the MoE groups a data rank's rows at (2,2).
# meshed_blocks_decode (fp32): the meshed prefill, then 8 rows of
# 8-token prompts fed one token a step and 16 steps fed the no-mesh
# run's tokens, on jamba at full width cut to one period's mamba/dense
# and attn/dense layers, qwen2-moe and rwkv6-1.6b at full width cut to
# BLOCKS_LAYERS.  meshed_blocks_bf16: jamba-1.5-large's first JAMBA_LAYERS
# layers on (1,2), rwkv6-1.6b at full width and depth on (1,2) and
# (2,2): the prefill step on PREFILL_SHAPE tokens, then the serve step
# at B = 8 for 16 steps (one warm-up call of each first)
BLOCKS_MESHES = ((1, 2), (2, 2))
BLOCKS_MODELS = ("jamba", "qwen2-moe", "rwkv6")
# layers of the fp32 models: qwen2-moe's parity at 2 layers took 80 s on
# (1,2) and 168 on (2,2) (7.3 GB at fp32; measured on one H100),
# so its depth is cut to 1 of 24, in decode too
BLOCKS_LAYERS = {"jamba": 2, "qwen2-moe": 1, "rwkv6": 2}
BLOCKS_TRAIN_BATCH = (4, 64)
BLOCKS_GROUP_TOKENS = 128          # 4 x 64 tokens over 2 data ranks
# SHARDED_TRAIN_TOL's limits (the loss and grad norm within 1e-6)
# but where a model's fp32 step is worse conditioned, as the CPU tests'
# CASE_LIMITS state (tests/test_torch_mesh_train.py): jamba's SMOKE
# gradients and moments within 3e-5 and its loss within 3e-6; the
# parameter count beyond 1e-5 leaves out elements whose one-process
# sqrt(v) (at step 1 |g| / sqrt(1000)) is below 1e-3 of the leaf's
# largest, and allows 5 in 100 of a leaf's elements: the zero-initialised
# leaves (qwen2-moe's bk, jamba's conv_b) have a largest of ~2 lr after
# two steps, so their limit is ~2e-8 (every element within 2 lr).  AdamW's
# v (0.001 g^2 at step 1) takes twice the moments' limit: its error is
# twice the gradient's, relative (qwen2-moe's v 1.21e-5 beside gradients
# 7.90e-6 at (2,2); measured on one H100)
BLOCKS_TOL = {"jamba": {"loss": 3e-6, "grads": 3e-5, "moments": 3e-5,
                        "small_grads": 1e-3, "params_beyond_frac": 5e-2},
              "qwen2-moe": {"small_grads": 1e-3, "params_beyond_frac": 5e-2}}
BLOCKS_DECODE_STEPS = 16
BLOCKS_DECODE_RECORD = (-1, 7, 15)  # -1: the prefill's last position
# a no-mesh token another ranks first by no more than BLOCKS_DECODE_TOL
# of the logits' RMS is a near-tie; the recorded logits within
# BLOCKS_RECORD_TOL of their RMS: fp32 sums over 2048-16384 terms in
# another order leave 1.0e-5 to 2.7e-5 (measured on one H100)
BLOCKS_DECODE_TOL = 1e-5
BLOCKS_RECORD_TOL = 1e-4
BLOCKS_DECODE_GROUP_TOKENS = 32     # the prefill's 8 x 8 over 2 data ranks
BLOCKS_BF16 = (("jamba", ((1, 2),)), ("rwkv6", ((1, 2), (2, 2))))
BLOCKS_BF16_DECODE = (8, 16)        # rows, steps
# meshed_seq_shard: REPRO_SEQ_SHARD=1 (a sequence-sharded residual
# stream) on (1,2), in phase_sharded's 2-rank group.  yi-34b at full
# width (56 heads, 8 KV heads, head_dim 128, d_ff 20480, vocab 64000),
# the config the switch was made for, cut to SEQ_LAYERS of its 60
# layers: bf16, remat "full", AdamW, SEQ_TRAIN_STEPS steps at 1 x 4096
# (train_4k's length) from the seed's state; a prefill of 1 x 32768
# (prefill_32k's length) that fills the cache, then SEQ_DECODE_STEPS
# greedy steps (the tokens of every turn must be equal).  Each runs in
# the turns of SEQ_TURNS, the switch on and off, after one untimed
# warm-up (the first call of a process pays for its pinned host buffers
# and library handles); PERF.md's turns on, off, off, on came from the
# phase alone.  fp32 parity: one AdamW step of yi's
# SMOKE config (7 heads) and of SEQ_ODD (3 heads: neither divides
# model = 2, so every head runs on the rank's rows) with the switch on,
# against the one-process step, at the CPU tests' limits
# (tests/test_torch_mesh_train.py: the loss and grad norm within 1e-6
# relative, the gradients within 1e-5 of each leaf's largest)
SEQ_MESH = (1, 2)
SEQ_LAYERS = 2
SEQ_TRAIN_BATCH = (1, 4096)
SEQ_TRAIN_STEPS = 2
SEQ_PREFILL = (1, 32768)
SEQ_DECODE_STEPS = 8
SEQ_TURNS = (True, False)
SEQ_WARM = (1, 512)                 # the warm-up prefill's tokens
SEQ_PARITY_TOL = {**SHARDED_TRAIN_TOL, "loss": 1e-6, "small_grads": 0.0}
# meshed_a7c: Adafactor on a mesh and MLA decode on a model axis > 1, in
# phase_sharded's rank groups (A7C_MESH in the 2-rank group; jamba's
# fp32 Adafactor parity on (2,2) in the 4-rank one).  Adafactor bf16, remat
# "full": A7C_TRAIN_STEPS steps at 1 x 4096 (train_4k's length) from the
# seed's state, on jamba-1.5-large-398b cut to its first layer (a mamba
# mixer and a dense FFN, as a one-layer pattern so that remat
# checkpoints it; its second layer holds the 16 experts, which two ranks
# on one card cannot train) and qwen2-moe-a2.7b cut to 2 of its 24
# layers (its 60 experts over model).  Adafactor fp32 parity
# (A7C_PARITY): jamba's and qwen2-moe's SMOKE configs on (1,2), jamba's
# on (2,2), 2 steps on BLOCKS_TRAIN_BATCH against the one-process step
# on the card, at BLOCKS_TOL's limits: the factors at
# twice the moments' limit (as AdamW's v: squared gradients), and the
# parameter count leaving out elements whose one-process sqrt(v_hat) is
# below A7C_SMALL of the leaf's largest (a 1-D leaf's v is each element's
# own, and moves it by about lr * g / |g|; the CPU tests' ADAFACTOR_LIMITS
# leave out gradients below 1e-2 of the largest).  MLA decode bf16:
# minicpm3-4b at full width and A7C_MLA_LAYERS of its 62 layers, a
# prefill of A7C_MLA_PREFILL filling a cache of 1040 slots (520 a rank),
# then A7C_MLA_STEPS greedy steps (the archs' decode shape), against the
# no-mesh run on the same card (first_divergence).  MLA fp32 parity:
# minicpm3-4b at full width, 2 of 62 layers, prompts of A7C_MLA_PARITY
# rows x positions filling the cache, then greedy steps: the tokens
# equal to the no-mesh run's, each step's logits within A7C_MLA_TOL of
# their largest
A7C_MESH = (1, 2)
A7C_TRAIN_BATCH = (1, 4096)
A7C_TRAIN_STEPS = 2
A7C_TRAIN_MODELS = ("jamba", "qwen2-moe")
A7C_PARITY = (((1, 2), ("jamba", "qwen2-moe")), ((2, 2), ("jamba",)))
A7C_SMALL = 1e-2
A7C_MLA_LAYERS = 62
A7C_MLA_PREFILL = (8, 1024)
A7C_MLA_STEPS = 16
A7C_MLA_PARITY = (2, 160)
A7C_MLA_PARITY_LAYERS, A7C_MLA_PARITY_STEPS = 2, 8
A7C_MLA_TOL = 1e-5


def phase_paged_lse(torch, dev) -> list:
    """The paged kernel's optional lse output at the paged row's inputs
    (bf16 q over a bf16 pool: "mma"; fp32 over fp32: "simt"): the output
    within the row's limit and bit for bit a call without lse; the lse
    within ``LSE_RTOL`` relative of ``paged_attention_plain``'s; the ms of
    a call with and without it."""
    from repro_torch.kernels import decode_attention as DA

    gen = torch.Generator().manual_seed(11)
    x = paged_inputs(torch, gen, dev)
    scale = 256 ** -0.5
    live = x["seg"] >= 0
    rows = []
    for q_dtype, pool in LSE_CASES:
        q, kp, vp, _, _ = paged_case_tensors(torch, x, q_dtype, pool)

        def kern(lse=True):
            return DA.paged_attention_fwd(q, kp, vp, x["tables"], x["seg"],
                                          x["pos"], scale=scale,
                                          return_lse=lse)

        out, lse = kern()
        bare = kern(False)
        torch.cuda.synchronize()
        ref, ref_lse = DA.paged_attention_plain(
            q, kp, vp, x["tables"], x["seg"], x["pos"], scale=scale,
            return_lse=True)
        err = (out[live].float() - ref[live].float()).abs().max().item()
        lse_err = ((lse[live] - ref_lse[live]).abs()
                   / ref_lse[live].abs().clamp_min(1.0)).max().item()
        peak = PEAK_OPS[q_dtype]
        bound_ms, bound_by = paged_bound(x, q, kp.element_size(), False,
                                         peak)
        bound_ms += lse.numel() * 4 / HBM_BYTES_PER_S * 1e3
        row = {"phase": "kernel", "name": "paged_attention_lse",
               "q_dtype": q_dtype, "pool": pool,
               "variant": DA.variant(q.dtype), "T": int(q.shape[0]),
               "live_tokens": x["n_live"], "max_abs_err": err,
               "tol": PAGED_TOL[q_dtype], "lse_max_rel_err": lse_err,
               "lse_rtol": LSE_RTOL,
               "bits_equal_without_lse": bool(torch.equal(out, bare)),
               "ms": time_ms(torch, kern),
               "ms_without_lse": time_ms(torch, lambda: kern(False)),
               "plain_ms": time_ms(torch, lambda: DA.paged_attention_plain(
                   q, kp, vp, x["tables"], x["seg"], x["pos"], scale=scale,
                   return_lse=True), reps=5),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None}
        emit(row)
        if not (err <= PAGED_TOL[q_dtype] and lse_err <= LSE_RTOL
                and row["bits_equal_without_lse"]):
            raise AssertionError(f"paged_attention lse[{q_dtype}]: {row}")
        rows.append(row)
    return rows


def phase_decode_lse(torch, dev) -> list:
    """The decode kernel's optional lse output at gemma-2b's decode shape
    (the first two DECODE_ROWS rows: B = 8, G = 8, D = 256, 2048 slots at
    ragged lengths; bf16 "mma" and fp32 "simt"), and at the sharded
    decode's shape on a rank (the same rows over half the slots, one row
    of them empty: -inf): the output within the row's limit and bit for
    bit a call without lse; the lse within ``LSE_RTOL`` relative of
    ``decode_attention_plain``'s; the ms of a call with and without it."""
    from repro_torch.kernels import decode_attention as DA

    t0 = time.perf_counter()
    rows = []
    for row_spec in DECODE_ROWS[:2]:
        label, dt, b, hkv, g, d, smax, window = row_spec
        q, kc, vc, lens_h, lens, kw = decode_inputs(torch, dev, row_spec)
        for half in (False, True):
            if half:
                # the second of two ranks' slots, [Smax/2, Smax)
                smax //= 2
                kc, vc = kc[:, :, smax:].contiguous(), \
                    vc[:, :, smax:].contiguous()
                lens_h = (lens_h - smax).clamp(0, smax)
                lens = lens_h.to(torch.int32).to(dev)

            def kern(lse=True):
                return DA.decode_attention_fwd(q, kc, vc, lens,
                                               return_lse=lse, **kw)

            out, lse = kern()
            bare = kern(False)
            torch.cuda.synchronize()
            ref, ref_lse = DA.decode_attention_plain(q, kc, vc, lens,
                                                     return_lse=True, **kw)
            live = lens > 0
            lse_err = ((lse[live] - ref_lse[live]).abs()
                       / ref_lse[live].abs().clamp_min(1.0)).max().item()
            empty_ok = bool(torch.isneginf(lse[~live]).all())
            n_live = int(lens_h.sum())
            nbytes = (2 * q.numel() * q.element_size() + 4 * b
                      + 2 * n_live * hkv * d * kc.element_size()
                      + lse.numel() * 4)
            bound_ms, bound_by = kernel_bound(nbytes,
                                              4 * n_live * hkv * g * d, dt)
            row = {"phase": "kernel", "name": "decode_attention_lse",
                   "row": label + ("_rank_half" if half else ""),
                   "dtype": dt, "variant": DA.decode_variant(q.dtype),
                   "B": b, "G": g, "D": d, "Smax": smax,
                   "lens": lens_h.tolist(),
                   **check_row(torch, f"decode_attention_lse[{label}]",
                               out[live], ref[live], kernel_tol(dt, smax)),
                   "lse_max_rel_err": lse_err, "lse_rtol": LSE_RTOL,
                   "empty_rows_neg_inf": empty_ok,
                   "bits_equal_without_lse": bool(torch.equal(out, bare)),
                   "ms": time_ms(torch, kern),
                   "ms_without_lse": time_ms(torch, lambda: kern(False)),
                   "plain_ms": time_ms(torch, lambda: DA.
                                       decode_attention_plain(
                                           q, kc, vc, lens, return_lse=True,
                                           **kw), reps=5),
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": None}
            emit(row)
            if not (lse_err <= LSE_RTOL and empty_ok
                    and row["bits_equal_without_lse"]):
                raise AssertionError(f"decode_attention lse[{label}]: {row}")
            rows.append(row)
    emit({"phase": "decode_attention_lse",
          "seconds": time.perf_counter() - t0})
    return rows


def launch_cases(torch, dev) -> dict:
    """A small call of each kernel launch of step 0 but flash (kernels 1-4
    and 6-8 of the table), as (function, its tensors, its counter)."""
    import repro_torch as rt
    from repro_torch.core import fuse
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import fused_elementwise as FE
    from repro_torch.kernels import ops as kops

    gen = torch.Generator().manual_seed(75)

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    i32 = dict(dtype=torch.int32, device=dev)
    seg = torch.tensor([0, 0, 0, 1, 1, -1], **i32)
    pos = torch.tensor([3, 4, 5, 9, 10, 0], **i32)
    tables = torch.arange(8, **i32).reshape(2, 4)
    pool, cache = rnd(8, 4, 2, 32), rnd(2, 2, 16, 32)
    x = rnd(64, 33)
    with rt.default_device(dev):
        chain, ext = fuse.capture_chain(
            lambda t: (t * 2.0 + 1.0).tanh() * t, rt.Tensor(x))
    fused = FE.make_fused_elementwise(chain)
    return {
        "paged_attention": (
            lambda q, kp, vp: DA.paged_attention_fwd(
                q, kp, vp, tables, seg, pos, scale=0.2, return_lse=True),
            [rnd(6, 2, 2, 32), pool, pool.flip(0).contiguous()],
            "paged_attention"),
        "mixed_attention": (
            lambda q, k, v: DA.mixed_attention_fwd(
                q, k, v, seg[1:], pos[1:], scale=0.2),
            [rnd(5, 2, 2, 32), cache, cache.flip(2).contiguous()],
            "mixed_attention"),
        "decode_attention": (
            lambda q, k, v: DA.decode_attention_fwd(
                q, k, v, torch.tensor([5, 16], **i32), scale=0.2),
            [rnd(2, 2, 4, 32), cache, cache.flip(2).contiguous()],
            "decode_attention"),
        "gumbel_perturb": (
            lambda lg, u: kops.gumbel_perturb(lg, u),
            [rnd(4, 300), torch.rand((4, 300), generator=gen).clamp(
                1e-6, 1 - 1e-6).to(dev)], "gumbel_perturb"),
        "gumbel_perturb_keyed": (
            lambda lg, s, p: kops.gumbel_perturb_keyed(lg, s, p),
            [rnd(4, 300), torch.arange(1, 5, device=dev),
             torch.arange(10, 14, device=dev)], "gumbel_perturb"),
        "fused_elementwise": (lambda *xs: fused(*xs), list(ext),
                              "fused_elementwise"),
        "rwkv6_scan": (
            lambda r, k, v, w, u: kops.rwkv6_scan(r, k, v, w, u),
            [rnd(1, 2, 8, 64), rnd(1, 2, 8, 64), rnd(1, 2, 8, 64),
             (torch.rand((1, 2, 8, 64), generator=gen) * 0.5 + 0.4).to(dev),
             rnd(2, 64)], "rwkv6_scan"),
        "mamba_scan": (
            lambda xx, dt, B, C, A, D: kops.mamba_scan(xx, dt, B, C, A, D),
            [rnd(1, 8, 32), (torch.rand((1, 8, 32), generator=gen)
                             * 0.1).to(dev), rnd(1, 8, 16), rnd(1, 8, 16),
             (-torch.rand((32, 16), generator=gen) - 0.5).to(dev),
             rnd(32)], "mamba_scan"),
    }


def compiled_launches(torch, dev) -> dict:
    """``repro_torch.compile`` of each launch of ``launch_cases``: no graph
    break, exactly one launch of its kernel a compiled call (counted
    inside the compiled call), and the eager call's bits."""
    import repro_torch as rt

    res = {}
    for name, (fn, args, counter) in launch_cases(torch, dev).items():
        def flat(out):
            return list(out) if isinstance(out, (tuple, list)) else [out]
        with rt.default_device(dev):
            eager = flat(fn(*args))
            cf = rt.compile(fn)
            _, seconds, breaks = compiled_call(torch, cf, *args)
            out, counts = check_launches(
                torch, f"compiled {name}", lambda: flat(cf(*args)),
                {counter: 1})
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(out, eager))
        same = all(torch.equal(a, b) for a, b in zip(out, eager))
        res[name] = {"graph_breaks": breaks, "compile_s": seconds,
                     "launches": counts[counter], "max_abs_err": err,
                     "bits_equal": same}
        if breaks or not same:
            raise AssertionError(f"compiled {name}: {res[name]}")
    return res


def phase_replica_serving(torch, dev, models) -> dict:
    """gemma-2b (bf16, full width and depth) with ``n_replicas=2`` on one
    card: the 16 serving requests over ``REPLICA_TURNS`` turns, one
    paged-kernel launch a layer serving both replicas; then fp32 gemma-2b
    cut to 2 of 18 layers at full width: greedy tokens at R = 2 equal
    R = 1's."""
    cfg32, params32, cfg, params = models
    requests = serving_requests(torch, cfg)
    tps, counts, m = [], None, None
    for _ in range(REPLICA_TURNS):
        (outs, wall, m), counts = counted(
            torch, "replica_serving", lambda: run_engine(
                torch, cfg, params, requests, dev, n_replicas=2))
        tps.append(sum(n for _, n, _ in requests) / wall)
    line = {"phase": "replica_serving", "model": cfg.name,
            "layers": cfg.n_layers, "n_replicas": m["n_replicas"],
            "requests": len(requests), "turns": REPLICA_TURNS,
            "tokens_per_s": tps, "tokens_per_s_spread":
                (max(tps) - min(tps)) / (sum(tps) / len(tps)),
            "steps": m["steps"], "launches": counts,
            "page_hwm_per_replica": m["page_hwm_per_replica"],
            "kv_bytes": m["kv_bytes"], "peak_mem_gb": peak_gb(torch)}
    cfg2 = dataclasses.replace(cfg32, n_layers=SHARDED_PARITY_LAYERS)
    params2 = {**params32, "layers": params32["layers"][
        :SHARDED_PARITY_LAYERS]}
    greedy = [r for r in requests if r[2].greedy]
    one, _, _ = run_engine(torch, cfg2, params2, greedy, dev)
    two, _, m2 = run_engine(torch, cfg2, params2, greedy, dev,
                            n_replicas=2)
    line["fp32_greedy_r2_equals_r1"] = one == two
    line["fp32_page_hwm_per_replica"] = m2["page_hwm_per_replica"]
    line["fp32_first_divergence"] = first_divergence(one, two)
    emit(line)
    if one != two:
        raise AssertionError(f"replica_serving: fp32 greedy R=2 differs "
                             f"from R=1 at {line['fp32_first_divergence']}")
    return counts


def first_divergence(a, b):
    """(request, token index) of the first token two runs' outputs differ
    in, or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        for j, (s, t) in enumerate(zip(x, y)):
            if s != t:
                return [i, j]
        if len(x) != len(y):
            return [i, min(len(x), len(y))]
    return None


def sharded_parity_model(torch, dev):
    """fp32 gemma-2b at full width cut to ``SHARDED_PARITY_LAYERS`` layers,
    made from ``SHARDED_SEED`` (the same tensors in every process)."""
    from repro_torch.configs import gemma_2b
    from repro_torch.models import lm as LM
    cfg = dataclasses.replace(gemma_2b.CONFIG, param_dtype=torch.float32,
                              n_layers=SHARDED_PARITY_LAYERS)
    return cfg, LM.init_params(cfg, seed=SHARDED_SEED, device=dev)


def sharded_requests(torch, cfg, sampled: bool) -> list:
    """The 16 serving prompts, every one greedy or every one sampled
    (temperature 0.8, top_k 20, seed 42)."""
    from repro_torch.serving.sampling import SamplingParams
    sp = SamplingParams(**SHARDED_SAMPLED) if sampled else SamplingParams()
    return [(p, n, sp) for p, n, _ in serving_requests(torch, cfg)]


def rank_sharded_parity(torch, dev, rank, world, shapes) -> dict:
    """This rank's finished outputs on each mesh of ``shapes``, greedy and
    sampled, with its kernel launches and merges."""
    from repro_torch.launch.mesh import make_mesh
    cfg, params = sharded_parity_model(torch, dev)
    res = {}
    for shape in shapes:
        mesh = make_mesh(tuple(shape), ("data", "model"))
        for sampled in (False, True):
            reqs = sharded_requests(torch, cfg, sampled)
            (outs, wall, m), counts = counted(
                torch, f"sharded parity {shape}", lambda: run_engine(
                    torch, cfg, params, reqs, dev, mesh=mesh))
            res[(tuple(shape), sampled)] = {
                "outs": outs, "launches": counts, "wall_s": wall,
                "lse_merges": m["lse_merges"], "kv_bytes": m["kv_bytes"]}
    return res


def rank_sharded_bf16(torch, dev, rank, world, shapes) -> dict:
    """bf16 gemma-2b at full width and depth on each mesh of ``shapes``:
    the 16 serving requests, this rank's tokens/s, launches, merges and
    peak GB (while the engine shards the weights, and while it serves)."""
    from repro_torch.configs import gemma_2b
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm as LM
    cfg = dataclasses.replace(gemma_2b.CONFIG, param_dtype=torch.bfloat16)
    requests = serving_requests(torch, cfg)
    res = {}
    for shape in shapes:
        mesh = make_mesh(tuple(shape), ("data", "model"))
        free(torch)
        torch.cuda.reset_peak_memory_stats()
        params = LM.init_params(cfg, seed=0, device=dev)
        eng = serving_engine(cfg, params, dev, mesh=mesh)
        del params
        free(torch)
        build_gb = peak_gb(torch)
        held_gb = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()

        def serve():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids = [eng.submit(p, max_new_tokens=n, sampling=sp)
                   for p, n, sp in requests]
            eng.run()
            torch.cuda.synchronize()
            return ids, time.perf_counter() - t0

        (ids, wall), counts = counted(torch, f"sharded bf16 {shape}", serve)
        done = [eng.result(i) for i in ids]
        if any(r is None or len(r.out_tokens) != NEW_TOKENS for r in done):
            raise AssertionError(f"sharded bf16 {shape}: a request did not "
                                 f"finish")
        m = eng.metrics
        res[tuple(shape)] = {
            "tokens_per_s": NEW_TOKENS * len(requests) / wall,
            "wall_s": wall, "steps": m["steps"], "launches": counts,
            "lse_merges": m["lse_merges"],
            "collectives": m["collectives"],
            "page_hwm_per_replica": m["page_hwm_per_replica"],
            "kv_bytes": m["kv_bytes"], "build_peak_gb": build_gb,
            "held_gb": held_gb, "serve_peak_gb": peak_gb(torch),
            "tokens": [list(r.out_tokens) for r in done]}
        del eng
        free(torch)
    return res


def ddp_net(torch, dev):
    """The DDP model and batch, the same in every process."""
    import repro_torch as rt
    from repro_torch import nn
    gen = torch.Generator().manual_seed(81)
    with rt.default_device(dev):
        model = nn.Sequential(nn.Linear(16, DDP_WIDTH), nn.ReLU(),
                              nn.Linear(DDP_WIDTH, 4))
    for p in model.parameters():
        p.data.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    x = torch.randn(DDP_BATCH, 16, generator=gen).to(dev)
    y = torch.randn(DDP_BATCH, 4, generator=gen).to(dev)
    return model, x, y


def ddp_grads(model, x, y) -> dict:
    import repro_torch as rt
    model.zero_grad()
    loss = ((model(rt.Tensor(x)) - rt.Tensor(y)) ** 2).mean()
    loss.backward()
    return {k: p.grad.data.clone() for k, p in model.named_parameters()}


def rank_ddp(torch, dev, rank, world) -> dict:
    """Each rank's half of the batch through DDP over the ``data`` axis,
    plain and int8-compressed, two steps each."""
    import repro_torch as rt
    from repro_torch.distributed.ddp import DistributedDataParallel
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((world,), ("data",))
    res = {}
    for compress in (None, "int8"):
        model, x, y = ddp_net(torch, dev)
        n = DDP_BATCH // world
        xs, ys = x[rank * n:(rank + 1) * n], y[rank * n:(rank + 1) * n]
        ddp = DistributedDataParallel(model, mesh=mesh,
                                      bucket_mb=DDP_BUCKET_MB,
                                      compress=compress)
        steps = []
        with rt.default_device(dev):
            for _ in range(2):
                ddp_grads(ddp, xs, ys)
                t0 = time.perf_counter()
                ddp.sync_gradients()
                torch.cuda.synchronize()
                steps.append(({k: p.grad.data.cpu() for k, p in
                               model.named_parameters()},
                              (time.perf_counter() - t0) * 1e3))
        res[compress] = {"grads": [g for g, _ in steps],
                         "sync_ms": [t for _, t in steps],
                         "stats": dict(ddp.stats),
                         "n_buckets": len(ddp.buckets),
                         "residual_max": [float(r.abs().max()) for r in
                                          ddp._residuals.values()]}
    return res


def pipe_inputs(torch):
    gen = torch.Generator().manual_seed(82)
    w = torch.randn(PIPE_STAGES, PIPE_WIDTH, PIPE_WIDTH,
                    generator=gen) / PIPE_WIDTH ** 0.5
    return w, torch.randn(PIPE_BATCH, PIPE_WIDTH, generator=gen)


def tanh_stage(w, x):
    import torch
    return torch.tanh(x @ w)


def rank_pipeline(torch, dev, rank, world) -> dict:
    """``pipeline_apply`` over the ``pod`` axis of ``world`` ranks: the
    output (rank 0) and the ms of a call after a warm-up."""
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((world,), ("pod",))
    w, x = pipe_inputs(torch)
    w, x = w.to(dev), x.to(dev)

    def run():
        return pipeline_apply(tanh_stage, w, x, mesh=mesh,
                              n_microbatches=PIPE_MICRO)
    out = run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return {"out": out.cpu() if rank == 0 else None,
            "ms": (time.perf_counter() - t0) * 1e3}


def train_batches(torch, cfg, shape, seed: int, n: int = 2) -> list:
    """``n`` global batches of random tokens and labels (the same in
    every process)."""
    gen = torch.Generator().manual_seed(seed)
    return [{"tokens": torch.randint(0, cfg.vocab_size, shape,
                                     generator=gen),
             "labels": torch.randint(0, cfg.vocab_size, shape,
                                     generator=gen)} for _ in range(n)]


def meshed_run(torch, fn, tally: dict):
    """``fn()`` with the launch counts and collective stats zeroed just
    before it; adds its launches, collectives, staged bytes and seconds
    to ``tally``."""
    from repro_torch.distributed import collectives as C
    from repro_torch.kernels import launch_counts, reset_launch_counts
    torch.cuda.synchronize()
    reset_launch_counts()
    C.reset_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    tally["seconds"] = tally.get("seconds", 0.0) + time.perf_counter() - t0
    for k, n in launch_counts().items():
        tally.setdefault("launches", {})
        tally["launches"][k] = tally["launches"].get(k, 0) + n
    tally["collectives"] = tally.get("collectives", 0) + C.stats["calls"]
    tally["staged_bytes"] = (tally.get("staged_bytes", 0)
                             + C.stats["staged_bytes"])
    return out


def scatter_pieces(torch, full, spec, mesh, like):
    """This rank's piece (``local_shard`` under ``spec``) of the tensor
    ``full`` that the first rank holds (None elsewhere), shaped as
    ``like``: the first rank cuts every rank's piece and scatters them
    (gloo, through pinned host memory).  The mesh's positions are the
    group's ranks in order."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding as S
    recv = torch.empty(like.shape, dtype=like.dtype,
                       pin_memory=like.is_cuda)
    sends = None
    if full is not None:
        sends = [S.local_shard(full, spec, mesh, c).to(
            "cpu", copy=True).contiguous()
            for c in S.all_coords(mesh)]
    dist.scatter(recv, sends, src=0)
    return recv.to(like.device)


def leaf_errors(torch, pieces, specs, mesh, refs, kind: str,
                scale=None, small: float = 0.0):
    """Each leaf's one-process value (``refs``, on the first rank) against
    the ranks' ``pieces`` (every rank calls): the first rank scatters each
    rank its piece of the reference, each rank compares its own, and the
    largest errors are reduced over the ranks: the largest error of a
    leaf relative to that leaf's largest, the largest absolute error, and
    for ``kind`` "params" the most elements of a leaf beyond 1e-5 of its
    largest and whether every leaf's error is within 2 lr plus that
    (``SHARDED_TRAIN_TOL``).  Each rank's piece is then set to the
    reference's, so that the next step starts both runs from one state.
    ``scale`` (a one-process tensor of each leaf's shape, on the first
    rank: AdamW's sqrt(v)) with ``small`` > 0 leaves out of the "params"
    count the elements where it is below ``small`` of the leaf's
    largest.  Returns the dict
    on every rank."""
    import torch.distributed as dist
    out = {"rel": 0.0, "abs": 0.0, "beyond": 0, "elements": 0,
           "within_2lr": True}
    none = [None] * len(pieces)
    for x, spec, ref, big in zip(pieces, specs, refs or none,
                                 scale or none):
        mine = scatter_pieces(torch, ref, spec, mesh, x)
        err = (x.float() - mine.float()).abs()
        vals = torch.tensor([mine.abs().max().item(), err.max().item()])
        dist.all_reduce(vals, op=dist.ReduceOp.MAX)
        top, worst = max(vals[0].item(), 1e-30), vals[1].item()
        tight = SHARDED_TRAIN_TOL["params"] * top
        beyond = err > tight
        if small > 0 and kind == "params":
            g = scatter_pieces(torch, big, spec, mesh, x).float().abs()
            g_top = torch.tensor([g.max().item()])
            dist.all_reduce(g_top, op=dist.ReduceOp.MAX)
            beyond &= g >= small * g_top.item()
            del g
        count = torch.tensor([int(beyond.sum()), err.numel()])
        dist.all_reduce(count)
        out["rel"] = max(out["rel"], worst / top)
        out["abs"] = max(out["abs"], worst)
        if kind == "params":
            n, total = int(count[0]), int(count[1])
            if n * max(out["elements"], 1) >= out["beyond"] * total:
                out["beyond"], out["elements"] = n, total
            out["within_2lr"] &= worst <= 2 * SHARDED_TRAIN_LR + tight
        x.copy_(mine)
        del mine, err
    return out


def rank_sharded_train(torch, dev, rank, world, shapes) -> dict:
    """fp32 parity of the meshed train step on each mesh of ``shapes``:
    this rank's losses, grad norms, launches, collectives and seconds of
    the meshed calls, and the errors of ``leaf_errors``: rank 0 also runs
    the one-process step on the card, and every rank's pieces of the
    gradients (step 1), AdamW moments and parameters (after each step)
    are held to the matching pieces of it."""
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.functional import tree_leaves, tree_map
    res = {}
    for shape in shapes:
        t_all = time.perf_counter()
        mesh = make_mesh(tuple(shape), ("data", "model"))
        cfg, full = sharded_parity_model(torch, dev)
        specs = T.state_specs(cfg, mesh, lr=SHARDED_TRAIN_LR)
        leaf_specs = T.spec_leaves(specs["params"], full)
        first = rank == 0
        ref = ref_step = None
        if first:
            ref = T.init_train_state(cfg, lr=SHARDED_TRAIN_LR, device=dev,
                                     params=tree_map(torch.clone, full))
            ref_step = T.make_train_step(cfg, lr=SHARDED_TRAIN_LR,
                                         device=dev)
        state = T.init_train_state(cfg, lr=SHARDED_TRAIN_LR, device=dev,
                                   mesh=mesh, params=full)
        del full
        free(torch)
        step = T.make_train_step(cfg, lr=SHARDED_TRAIN_LR, device=dev,
                                 mesh=mesh)
        batches = train_batches(torch, cfg, SHARDED_TRAIN_BATCH, 91)
        tally, out = {}, {"loss": [], "grad_norm": [], "ref_loss": [],
                          "ref_grad_norm": [], "errors": {}}
        ref_grads = ref_step.compute(ref["params"], batches[0])[1] \
            if first else None
        _, grads = meshed_run(torch, lambda: step.compute(
            state["params"], batches[0]), tally)
        out["errors"]["grads"] = leaf_errors(torch, grads, leaf_specs, mesh,
                                             ref_grads, "grads")
        del grads, ref_grads
        free(torch)
        for i, batch in enumerate(batches):
            if first:
                ref, m = ref_step(ref, batch)
                out["ref_loss"].append(float(m["loss"]))
                out["ref_grad_norm"].append(float(m["grad_norm"]))
            state, m = meshed_run(torch, lambda: step(state, batch), tally)
            out["loss"].append(float(m["loss"]))
            out["grad_norm"].append(float(m["grad_norm"]))
            for key in ("m", "v", "params"):
                tree = state["params"] if key == "params" else \
                    state["opt"][key]
                refs = None if not first else tree_leaves(
                    ref["params"] if key == "params" else ref["opt"][key])
                out["errors"][f"{key}_step{i + 1}"] = leaf_errors(
                    torch, tree_leaves(tree), leaf_specs, mesh, refs, key)
        del state, ref
        free(torch)
        out.update(tally)
        out["phase_seconds"] = time.perf_counter() - t_all
        res[tuple(shape)] = out
    return res


def rank_sharded_train_bf16(torch, dev, rank, world, shapes) -> dict:
    """bf16 gemma-2b at full width (``SHARDED_TRAIN_BF16_LAYERS``), remat
    "full", AdamW on each mesh of ``shapes``: 1 warm-up step, then 3
    timed; this rank's tokens/s (global tokens over the timed steps'
    seconds), GB held after the build and peak while stepping, launches,
    collectives and staged bytes a step."""
    from repro_torch.configs import gemma_2b
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm as LM
    cfg = dataclasses.replace(gemma_2b.CONFIG, param_dtype=torch.bfloat16,
                              n_layers=SHARDED_TRAIN_BF16_LAYERS)
    warm, timed = SHARDED_TRAIN_BF16_STEPS
    res = {}
    for shape in shapes:
        t_all = time.perf_counter()
        mesh = make_mesh(tuple(shape), ("data", "model"))
        free(torch)
        torch.cuda.reset_peak_memory_stats()
        state = T.init_train_state(
            cfg, device=dev, mesh=mesh,
            params=LM.init_params(cfg, seed=0, device=dev))
        free(torch)
        build_gb = peak_gb(torch)
        held_gb = torch.cuda.memory_allocated() / 1e9
        step = T.make_train_step(cfg, device=dev, mesh=mesh)
        batches = train_batches(torch, cfg, SHARDED_TRAIN_BF16_BATCH, 92,
                                warm + timed)
        for batch in batches[:warm]:
            state, m = step(state, batch)
        torch.cuda.reset_peak_memory_stats()
        tally, losses = {}, []
        for batch in batches[warm:]:
            state, m = meshed_run(torch, lambda: step(state, batch), tally)
            losses.append(float(m["loss"]))
        step_gb = peak_gb(torch)
        tokens = timed * math.prod(SHARDED_TRAIN_BF16_BATCH)
        res[tuple(shape)] = {
            "tokens_per_s": tokens / tally["seconds"],
            "s_per_step": tally["seconds"] / timed, "losses": losses,
            "build_peak_gb": build_gb, "held_gb": held_gb,
            "step_peak_gb": step_gb,
            **save_peak(torch, cfg, mesh, state),
            "launches_per_step": {k: n / timed for k, n in
                                  tally["launches"].items()},
            "collectives_per_step": tally["collectives"] / timed,
            "staged_gb_per_step": tally["staged_bytes"] / timed / 1e9,
            "phase_seconds": time.perf_counter() - t_all}
        del state
        free(torch)
    return res


def save_peak(torch, cfg, mesh, state) -> dict:
    """A checkpoint save's device memory on ``mesh``, its write left
    out: a save gathers one whole leaf at a time, the first rank copies
    it to host memory, and every rank drops it before the next
    (``checkpoint._host_state``), so a rank's peak is its held state
    plus the largest leaf's gather, which is made here as a save makes
    it.  Returns that peak, the leaf's GB and the state's whole GB (what
    the writing rank holds in host memory during a save)."""
    from repro_torch.checkpoint import _first_rank, _host_state
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import axis_sizes
    from repro_torch.optim.functional import tree_leaves
    sizes = axis_sizes(mesh)
    specs = T.spec_leaves(T.state_specs(cfg, mesh), state)
    whole = [x.numel() * x.element_size() * math.prod(
        sizes[a] for e in spec if e is not None
        for a in (e if isinstance(e, tuple) else (e,)))
        for x, spec in zip(tree_leaves(state), specs)]
    i = max(range(len(whole)), key=whole.__getitem__)
    free(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _host_state({"leaf": tree_leaves(state)[i]}, mesh, {"leaf": specs[i]},
                _first_rank(mesh))
    torch.cuda.synchronize()
    return {"save_peak_gb": peak_gb(torch), "save_leaf_gb": whole[i] / 1e9,
            "save_leaf_seconds": time.perf_counter() - t0,
            "state_gb": sum(whole) / 1e9}


def greedy_decode(torch, dev, cfg, params, mesh=None) -> dict:
    """The meshed (or one-process) prefill's greedy token after
    ``SHARDED_DECODE_ROWS`` prompts, then the prompts fed through the
    serve step one token a step and ``SHARDED_DECODE_STEPS`` greedy
    tokens; with the launches, the serve step's lse merges and the
    seconds."""
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import train as T
    from repro_torch.models import lm as LM
    b, p, n = (SHARDED_DECODE_ROWS, SHARDED_DECODE_PROMPT,
               SHARDED_DECODE_STEPS)
    prompts = torch.randint(0, cfg.vocab_size, (b, p),
                            generator=torch.Generator().manual_seed(93))
    max_seq = p + n
    prefill = T.make_prefill_step(cfg, device=dev, mesh=mesh)
    serve = T.make_serve_step(cfg, batch=b, max_seq=max_seq,
                              cache_dtype=torch.float32, device=dev,
                              mesh=mesh)
    cache = LM.init_cache(cfg, b, max_seq, torch.float32, dev)
    if mesh is not None:
        cache = T.shard_tree(mesh, S.cache_specs(cfg, cache, mesh), cache)
    tally = {}

    def run():
        first = T.greedy_tokens(prefill(params, {"tokens": prompts})[:, -1],
                                mesh, cfg.vocab_size)
        for t in range(p):
            logits, _ = serve(params, cache, prompts[:, t:t + 1], t)
        out = [T.greedy_tokens(logits[:, -1], mesh, cfg.vocab_size)]
        for i in range(n - 1):
            logits, _ = serve(params, cache, out[-1][:, None].cpu(), p + i)
            out.append(T.greedy_tokens(logits[:, -1], mesh, cfg.vocab_size))
        return first.cpu(), torch.stack(out, 1).cpu()

    first, tokens = meshed_run(torch, run, tally)
    return {"first": first.tolist(), "tokens": tokens.tolist(),
            "lse_merges": getattr(serve, "lse_merges", 0), **tally}


def rank_sharded_decode(torch, dev, rank, world, shapes) -> dict:
    """``greedy_decode`` of the sharded serving model (fp32) on each mesh
    of ``shapes``, the parameters and the cache this rank's pieces."""
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh
    res = {}
    for shape in shapes:
        mesh = make_mesh(tuple(shape), ("data", "model"))
        cfg, full = sharded_parity_model(torch, dev)
        params = T.shard_tree(mesh, S.param_specs(cfg, full, mesh), full)
        del full
        free(torch)
        res[tuple(shape)] = greedy_decode(torch, dev, cfg, params, mesh)
        del params
        free(torch)
    return res


def sliding_model(torch, dev):
    """fp32 gemma3-1b at full width cut to ``SLIDING_DECODE_LAYERS``
    layers, made from ``SHARDED_SEED``."""
    from repro_torch.configs import gemma3_1b
    from repro_torch.models import lm as LM
    cfg = dataclasses.replace(gemma3_1b.CONFIG, param_dtype=torch.float32,
                              n_layers=SLIDING_DECODE_LAYERS)
    return cfg, LM.init_params(cfg, seed=SHARDED_SEED, device=dev)


def sliding_decode(torch, dev, cfg, params, follow=None, mesh=None
                   ) -> dict:
    """``follow_decode`` of ``SLIDING_DECODE_STEPS`` steps, the whole
    logits recorded at ``SLIDING_RECORD``."""
    return follow_decode(torch, dev, cfg, params, follow, mesh,
                         steps=SLIDING_DECODE_STEPS, record=SLIDING_RECORD,
                         seed=95)


def follow_decode(torch, dev, cfg, params, follow=None, mesh=None, *,
                  steps: int, record, seed: int, prefill: bool = False
                  ) -> dict:
    """``SHARDED_DECODE_ROWS`` 8-token prompts (from ``seed``) through the
    serve step one token a step, then ``steps`` steps, each fed the
    previous step's greedy token, or ``follow``'s (the no-mesh run's
    tokens) where given.  Returns the greedy tokens (without
    ``follow``), or with it the count of steps and rows whose logits
    rank ``follow``'s token first and the largest amount by which a
    step's best logit passes that token's, relative to the logits' RMS
    (from each rank's vocabulary slice, reduced over ``model``); the
    whole logits at the steps of ``record``; the launches, merges and
    seconds.  With ``prefill`` the prefill step's logits at the prompt's
    last position come first, as step -1 (held to ``follow`` likewise,
    recorded)."""
    from repro_torch.distributed import collectives as C
    from repro_torch.launch import train as T
    from repro_torch.models import lm as LM
    b, p, n = SHARDED_DECODE_ROWS, SHARDED_DECODE_PROMPT, steps
    prompts = torch.randint(0, cfg.vocab_size, (b, p),
                            generator=torch.Generator().manual_seed(seed))
    max_seq = p + n
    serve = T.make_serve_step(cfg, batch=b, max_seq=max_seq,
                              cache_dtype=torch.float32, device=dev,
                              mesh=mesh)
    prefill_step = (T.make_prefill_step(cfg, device=dev, mesh=mesh)
                    if prefill else None)
    cache = LM.init_cache(cfg, b, max_seq, torch.float32, dev, mesh)
    group = None if mesh is None else mesh.get_group("model")
    tally = {}

    def gap_to(x, want):
        """Per row: the best logit less ``want``'s, and the logits' RMS,
        over the whole vocabulary."""
        split = x.shape[-1] != cfg.vocab_size
        lo = mesh.get_local_rank("model") * x.shape[-1] if split else 0
        idx = want - lo
        mine = (idx >= 0) & (idx < x.shape[-1])
        at = torch.where(mine, x.gather(-1, idx.clamp(0, x.shape[-1] - 1)
                                        [:, None])[:, 0], 0.0)
        top, sums = x.max(-1).values, torch.stack([at, x.pow(2).sum(-1)])
        if split:
            C.all_reduce_max(top, group)
            C.all_reduce_sum(sums, group)
        return top - sums[0], (sums[1].sum()
                               / (x.shape[0] * cfg.vocab_size)).sqrt()

    # the rank's rows of the global batch (a data axis splits them)
    row0 = 0 if mesh is None or "data" not in mesh.mesh_dim_names else \
        mesh.get_local_rank("data") * (b // mesh.size(
            mesh.mesh_dim_names.index("data")))

    def run():
        tokens, first, gap, recorded = [], 0, 0.0, {}

        def hold(i, x):
            nonlocal first, gap
            if follow is None:
                nxt = greedy(x)
                tokens.append(nxt)
            else:
                nxt = torch.tensor(follow[i + int(prefill)])
                d, rms = gap_to(x, nxt[row0:row0 + len(x)].to(x.device))
                first += int((d <= 0).sum())
                gap = max(gap, float(d.max() / rms))
            if i in record:
                recorded[i] = (x if x.shape[-1] == cfg.vocab_size else
                               C.all_gather_cat(x.contiguous(), group, -1)
                               ).cpu()
            return nxt.cpu()

        if prefill:
            hold(-1, prefill_step(params, {"tokens": prompts})[:, -1]
                 .float())
        for t in range(p):
            logits, _ = serve(params, cache, prompts[:, t:t + 1], t)
        for i in range(n):
            nxt = hold(i, logits[:, -1].float())
            if i + 1 < n:
                logits, _ = serve(params, cache, nxt[:, None], p + i)
        return tokens, first, gap, recorded

    def greedy(x):
        return T.greedy_tokens(x, mesh, cfg.vocab_size)

    tokens, first, gap, record = meshed_run(torch, run, tally)
    return {"tokens": torch.stack(tokens, 0).tolist() if tokens else None,
            "ranked_first": first, "gap": gap, "record": record,
            "row0": row0, "lse_merges": getattr(serve, "lse_merges", 0),
            **tally}


def rank_sliding_decode(torch, dev, rank, world, follow) -> dict:
    """``sliding_decode`` of the sliding model on ``SLIDING_DECODE_MESH``
    fed ``follow``, the parameters and the cache (rings included) this
    rank's pieces."""
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(SLIDING_DECODE_MESH, ("data", "model"))
    cfg, full = sliding_model(torch, dev)
    params = T.shard_tree(mesh, S.param_specs(cfg, full, mesh), full)
    del full
    free(torch)
    out = sliding_decode(torch, dev, cfg, params, follow, mesh)
    del params
    free(torch)
    return out


@contextmanager
def moe_group_tokens(n: int):
    """``REPRO_MOE_GROUP_TOKENS`` set to ``n`` inside, so that a meshed
    run, each data rank routing its own rows, and the one-process run
    group the same rows."""
    old = os.environ.get("REPRO_MOE_GROUP_TOKENS")
    os.environ["REPRO_MOE_GROUP_TOKENS"] = str(n)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("REPRO_MOE_GROUP_TOKENS", None)
        else:
            os.environ["REPRO_MOE_GROUP_TOKENS"] = old


def blocks_cfg(torch, name: str, run: str):
    """The meshed-blocks config of ``name`` for ``run`` ("parity",
    "decode" at fp32; "bf16")."""
    from repro_torch.configs import (jamba_1_5_large_398b, qwen2_moe_a2_7b,
                                     rwkv6_1_6b)
    from repro_torch.models.lm import BlockSpec
    if run == "bf16":
        if name == "jamba":
            return dataclasses.replace(jamba_1_5_large_398b.CONFIG,
                                       n_layers=JAMBA_LAYERS)
        return rwkv6_1_6b.CONFIG
    if name == "jamba" and run == "parity":
        return jamba_1_5_large_398b.SMOKE
    full = {"jamba": jamba_1_5_large_398b, "qwen2-moe": qwen2_moe_a2_7b,
            "rwkv6": rwkv6_1_6b}[name].CONFIG
    cfg = dataclasses.replace(full, param_dtype=torch.float32,
                              n_layers=BLOCKS_LAYERS[name])
    if name == "jamba":                # one period's mamba/dense, attn/dense
        cfg = dataclasses.replace(cfg, pattern=(
            BlockSpec("mamba", "dense"), BlockSpec("attn", "dense")))
    return cfg


def blocks_parity_run(torch, dev, rank, mesh, cfg, small: float,
                      steps: int = 2, optimizer: str = "adamw") -> dict:
    """``steps`` steps of ``optimizer`` (AdamW or Adafactor) of the meshed
    train step on ``mesh`` against the one-process step.  Before each
    meshed step rank 0 runs the one-process step while every rank waits
    with its cache emptied (the first from ``SHARDED_SEED``; its state
    stays on the card, the first step's gradients go to host memory);
    each rank's pieces of the gradients (step 1), the optimizer state
    (AdamW's moments, Adafactor's factors) and the parameters (after
    each step) are held to them (``leaf_errors``; the parameter count
    leaves out elements whose one-process sqrt(v) is below ``small`` of
    the leaf's largest, Adafactor's v_hat).  Returns the losses, grad
    norms, errors and the meshed calls' launches, collectives and
    seconds (Adafactor's own reductions as ``update_reductions``)."""
    import torch.distributed as dist
    from repro_torch.launch import train as T
    from repro_torch.models import lm as LM
    from repro_torch.optim.functional import tree_leaves
    lr = SHARDED_TRAIN_LR
    kw = dict(lr=lr, optimizer=optimizer)
    specs = T.state_specs(cfg, mesh, **kw)
    leaf_specs = T.spec_leaves(specs["params"], LM.abstract_params(cfg))
    keys = ("fac",) if optimizer == "adafactor" else ("m", "v")
    first = rank == 0
    batches = train_batches(torch, cfg, BLOCKS_TRAIN_BATCH, 96, steps)
    held = {}

    def ref_run(batch, with_grads: bool):
        """The one-process step on the card, from ``SHARDED_SEED`` or its
        state of the step before (updated in place): its gradients (where
        asked, in host memory), loss and grad norm."""
        if not held:
            held["step"] = T.make_train_step(cfg, device=dev, **kw)
            held["state"] = T.init_train_state(cfg, seed=SHARDED_SEED,
                                               device=dev, **kw)
        state = held["state"]
        grads = None if not with_grads else [
            g.cpu() for g in held["step"].compute(state["params"],
                                                  batch)[1]]
        _, m = held["step"](state, batch)
        out = (grads, float(m["loss"]), float(m["grad_norm"]))
        del m
        free(torch)
        return out

    state = step = None
    tally, out = {}, {"loss": [], "grad_norm": [], "ref_loss": [],
                      "ref_grad_norm": [], "errors": {}}
    for i, batch in enumerate(batches):
        free(torch)
        dist.barrier()
        ref_grads = None
        if first:
            ref_grads, loss, gnorm = ref_run(batch, i == 0)
            out["ref_loss"].append(loss)
            out["ref_grad_norm"].append(gnorm)
        dist.barrier()
        if state is None:
            state = T.init_train_state(cfg, seed=SHARDED_SEED, device=dev,
                                       mesh=mesh, **kw)
            step = T.make_train_step(cfg, device=dev, mesh=mesh, **kw)
            free(torch)
            _, grads = meshed_run(torch, lambda: step.compute(
                state["params"], batch), tally)
            out["errors"]["grads"] = leaf_errors(
                torch, grads, leaf_specs, mesh, ref_grads, "grads")
            del grads
            free(torch)
        state, m = meshed_run(torch, lambda: step(state, batch), tally)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        ref = held.get("state")
        # the step divides by sqrt(v) (AdamW's, Adafactor's v_hat): where
        # the one-process v is small an element's move is least
        # determined (``small``)
        rms = None if not first else (
            adafactor_scale(T.spec_leaves(ref["opt"]["fac"],
                                          ref["params"]))
            if optimizer == "adafactor" else
            [x.sqrt() for x in tree_leaves(ref["opt"]["v"])])
        for key in keys + ("params",):
            tree = state["params"] if key == "params" else \
                state["opt"][key]
            refs = None if not first else tree_leaves(
                ref["params"] if key == "params" else ref["opt"][key])
            out["errors"][f"{key}_step{i + 1}"] = leaf_errors(
                torch, tree_leaves(tree),
                leaf_specs if key != "fac" else T.spec_leaves(
                    specs["opt"]["fac"], state["opt"]["fac"]),
                mesh, refs, key, scale=rms if key == "params" else None,
                small=small)
        del ref, ref_grads, rms
    out["update_reductions"] = dict(step.update_reductions)
    del state, held
    free(torch)
    return {**out, **tally}


def adafactor_scale(facs) -> list:
    """sqrt(v_hat) of each leaf from its Adafactor factors (``{"row",
    "col"}``, or ``{"v"}`` for a 1-D leaf), as the update divides by it."""
    out = []
    for f in facs:
        if "v" in f:
            out.append(f["v"].sqrt())
            continue
        row, col = f["row"], f["col"]
        mean = row.mean(dim=-1, keepdim=True).clamp(min=1e-30)
        out.append((row[..., :, None] / mean[..., None]
                    * col[..., None, :]).sqrt())
    return out


def rank_blocks_parity(torch, dev, rank, world, shapes) -> dict:
    """``blocks_parity_run`` of each of ``BLOCKS_MODELS`` on each mesh of
    ``shapes``, the MoE groups ``BLOCKS_GROUP_TOKENS`` tokens."""
    from repro_torch.launch.mesh import make_mesh
    res = {}
    for shape in shapes:
        mesh = make_mesh(tuple(shape), ("data", "model"))
        for name in BLOCKS_MODELS:
            t0 = time.perf_counter()
            tol = {**SHARDED_TRAIN_TOL, "loss": 1e-6, "small_grads": 0.0,
                   **BLOCKS_TOL.get(name, {})}
            with moe_group_tokens(BLOCKS_GROUP_TOKENS):
                out = blocks_parity_run(torch, dev, rank, mesh,
                                        blocks_cfg(torch, name, "parity"),
                                        tol["small_grads"])
            res[(tuple(shape), name)] = dict(
                out, tol=tol, phase_seconds=time.perf_counter() - t0)
    return res


def blocks_decode(torch, dev, name, follow=None, mesh=None) -> dict:
    """``follow_decode`` (prefill first, ``BLOCKS_DECODE_STEPS`` steps) of
    the meshed-blocks decode model ``name`` from ``SHARDED_SEED``: the
    rank's pieces (drawn leaf by leaf) on ``mesh``, else the whole model;
    the prefill's MoE groups ``BLOCKS_DECODE_GROUP_TOKENS`` tokens."""
    from repro_torch.launch import train as T
    from repro_torch.models import lm as LM
    t0 = time.perf_counter()
    cfg = blocks_cfg(torch, name, "decode")
    params = (LM.init_params(cfg, seed=SHARDED_SEED, device=dev)
              if mesh is None else
              T.init_pieces(cfg, mesh, seed=SHARDED_SEED, device=dev))
    with moe_group_tokens(BLOCKS_DECODE_GROUP_TOKENS):
        out = follow_decode(torch, dev, cfg, params, follow, mesh,
                            steps=BLOCKS_DECODE_STEPS,
                            record=BLOCKS_DECODE_RECORD, seed=97,
                            prefill=True)
    del params
    free(torch)
    out["phase_seconds"] = time.perf_counter() - t0
    return out


def rank_blocks_decode(torch, dev, rank, world, shapes, follow) -> dict:
    """``blocks_decode`` of each of ``BLOCKS_MODELS`` on each mesh of
    ``shapes``, fed ``follow[name]`` (the no-mesh run's tokens)."""
    from repro_torch.launch.mesh import make_mesh
    res = {}
    for shape in shapes:
        mesh = make_mesh(tuple(shape), ("data", "model"))
        for name in BLOCKS_MODELS:
            res[(tuple(shape), name)] = blocks_decode(
                torch, dev, name, follow[name], mesh)
    return res


def rank_blocks_bf16(torch, dev, rank, world, runs) -> dict:
    """bf16 throughput of each (model, mesh) of ``runs``: the rank's pieces
    drawn leaf by leaf (GB held, peak while drawing), the prefill step on
    ``PREFILL_SHAPE`` tokens (tokens/s of the global batch) and the serve
    step at B = 8 for 16 steps (ms a step), each after one warm-up call;
    peak GB, launches, collectives and staged GB of each."""
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm as LM
    res = {}
    for name, shape in runs:
        t0 = time.perf_counter()
        mesh = make_mesh(tuple(shape), ("data", "model"))
        cfg = blocks_cfg(torch, name, "bf16")
        free(torch)
        torch.cuda.reset_peak_memory_stats()
        params = T.init_pieces(cfg, mesh, seed=0, device=dev)
        build_gb = peak_gb(torch)
        held_gb = torch.cuda.memory_allocated() / 1e9
        gen = torch.Generator().manual_seed(98)
        tokens = torch.randint(0, cfg.vocab_size, PREFILL_SHAPE,
                               generator=gen)
        prefill = T.make_prefill_step(cfg, device=dev, mesh=mesh)
        prefill(params, {"tokens": tokens})
        free(torch)
        torch.cuda.reset_peak_memory_stats()
        pre = {}
        meshed_run(torch, lambda: prefill(params, {"tokens": tokens}), pre)
        prefill_gb = peak_gb(torch)
        free(torch)
        rows, steps = BLOCKS_BF16_DECODE
        serve = T.make_serve_step(cfg, batch=rows, max_seq=steps + 1,
                                  device=dev, mesh=mesh)
        cache = LM.init_cache(cfg, rows, steps + 1, torch.bfloat16, dev,
                              mesh)
        step_tokens = torch.randint(0, cfg.vocab_size, (steps + 1, rows, 1),
                                    generator=gen)
        serve(params, cache, step_tokens[0], 0)        # warm-up
        torch.cuda.reset_peak_memory_stats()
        dec = {}

        def decode():
            for t in range(1, steps + 1):
                logits, _ = serve(params, cache, step_tokens[t], t)
            return logits

        logits = meshed_run(torch, decode, dec)
        res[(name, tuple(shape))] = {
            "layers": cfg.n_layers,
            "prefill_tokens_per_s": math.prod(PREFILL_SHAPE)
            / pre["seconds"],
            "prefill_s": pre["seconds"],
            "decode_ms_per_step": dec["seconds"] / steps * 1e3,
            "build_peak_gb": build_gb, "held_gb": held_gb,
            "prefill_peak_gb": prefill_gb, "decode_peak_gb": peak_gb(torch),
            "prefill_launches": pre["launches"],
            "decode_launches_per_step": {k: n / steps for k, n in
                                         dec["launches"].items()},
            "prefill_collectives": pre["collectives"],
            "prefill_staged_gb": pre["staged_bytes"] / 1e9,
            "decode_collectives_per_step": dec["collectives"] / steps,
            "decode_staged_gb_per_step": dec["staged_bytes"] / steps / 1e9,
            "finite": bool(torch.isfinite(logits.float()).all()),
            "phase_seconds": time.perf_counter() - t0}
        # the serve step holds the leaves it used (the pieces themselves
        # where nothing was gathered): dropped with it
        del params, cache, logits, serve, prefill
        free(torch)
    return res


def seq_model(torch):
    """yi-34b at full width cut to ``SEQ_LAYERS`` layers, bf16, remat
    "full"."""
    from repro_torch.configs import yi_34b
    return dataclasses.replace(yi_34b.CONFIG, n_layers=SEQ_LAYERS,
                               remat="full")


def seq_parity_cfgs(torch) -> dict:
    """The fp32 parity configs: yi's SMOKE, and ``odd`` (3 heads and KV
    heads, 2 layers)."""
    from repro_torch.configs import yi_34b
    from repro_torch.models.lm import LMConfig
    return {"yi-smoke": yi_34b.SMOKE,
            "odd": LMConfig(name="odd", n_layers=2, d_model=48, n_heads=3,
                            n_kv_heads=3, head_dim=16, d_ff=128,
                            vocab_size=96, param_dtype=torch.float32,
                            remat="none")}


def rank_seq_shard(torch, dev, rank, world) -> dict:
    """The meshed_seq_shard runs on ``SEQ_MESH`` (constants above), each
    turn of ``SEQ_TURNS`` with the switch on or off: the serve run
    (prefill filling the cache, then the greedy steps: seconds, tokens,
    launches, collectives, staged bytes, peak GB, the rows each prefill
    block took) and the train run (each step's seconds and loss, GB held
    and peak, launches, collectives and staged bytes, the rows each block
    took); then the fp32 parity runs with the switch on."""
    from repro_torch.distributed import act_sharding as AS
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm as LM
    t_all = time.perf_counter()
    mesh = make_mesh(SEQ_MESH, ("data", "model"))
    cfg = seq_model(torch)
    res = {"serve": [], "train": [], "parity": {}}
    gen = torch.Generator().manual_seed(99)
    prompt = torch.randint(0, cfg.vocab_size, SEQ_PREFILL, generator=gen)
    rows, steps = SEQ_PREFILL[0], SEQ_DECODE_STEPS
    max_seq = SEQ_PREFILL[1] + steps
    free(torch)
    params = T.init_pieces(cfg, mesh, seed=SHARDED_SEED, device=dev)
    res["pieces_gb"] = torch.cuda.memory_allocated() / 1e9

    def serve_run(tokens, max_seq, counted: bool):
        prefill = T.make_prefill_step(cfg, device=dev, mesh=mesh,
                                      max_seq=max_seq)
        serve = T.make_serve_step(cfg, batch=rows, max_seq=max_seq,
                                  device=dev, mesh=mesh)
        cache = LM.init_cache(cfg, rows, max_seq, torch.bfloat16, dev,
                              mesh)
        free(torch)
        torch.cuda.reset_peak_memory_stats()
        pre, dec, block_rows = {}, {}, []
        with AS.record_rows(block_rows):
            logits = meshed_run(torch, lambda: prefill(
                params, {"tokens": tokens}, cache), pre)
        prefill_gb = peak_gb(torch)
        tok = T.greedy_tokens(logits[:, -1], mesh, cfg.vocab_size)
        finite = bool(torch.isfinite(logits[:, -1].float()).all())
        del logits
        free(torch)
        torch.cuda.reset_peak_memory_stats()
        n = steps if counted else 2

        def decode():
            out = [tok]
            for i in range(n - 1):
                logits, _ = serve(params, cache, out[-1][:, None],
                                  tokens.shape[1] + i)
                out.append(T.greedy_tokens(logits[:, -1], mesh,
                                           cfg.vocab_size))
            return torch.stack(out, 1)

        out = meshed_run(torch, decode, dec)
        return {"tokens": out.cpu().tolist(), "finite": finite,
                "prefill_s": pre["seconds"],
                "prefill_tokens_per_s": tokens.numel() / pre["seconds"],
                "prefill_peak_gb": prefill_gb,
                "prefill_launches": pre["launches"],
                "prefill_collectives": pre["collectives"],
                "prefill_staged_gb": pre["staged_bytes"] / 1e9,
                "prefill_block_rows": sorted(set(block_rows)),
                "decode_ms_per_step": dec["seconds"] / (n - 1) * 1e3,
                "decode_peak_gb": peak_gb(torch),
                "decode_launches": dec["launches"],
                "decode_collectives_per_step": dec["collectives"] / (n - 1)}

    with AS.sequence_sharding(False):                         # the warm-up
        serve_run(prompt[:, :SEQ_WARM[1]], SEQ_WARM[1] + 2, False)
    for on in SEQ_TURNS:
        with AS.sequence_sharding(on):
            res["serve"].append((on, serve_run(prompt, max_seq, True)))
        free(torch)
    del params
    free(torch)

    def train_run(n_steps: int):
        torch.cuda.reset_peak_memory_stats()
        state = T.init_train_state(cfg, device=dev, mesh=mesh,
                                   seed=SHARDED_SEED)
        free(torch)
        state_gb = torch.cuda.memory_allocated() / 1e9
        step = T.make_train_step(cfg, device=dev, mesh=mesh)
        batches = train_batches(torch, cfg, SEQ_TRAIN_BATCH, 100, n_steps)
        torch.cuda.reset_peak_memory_stats()
        seconds, losses, block_rows = [], [], []
        tally = {}
        with AS.record_rows(block_rows):
            for batch in batches:
                t0 = tally.get("seconds", 0.0)
                state, m = meshed_run(torch, lambda: step(state, batch),
                                      tally)
                seconds.append(tally["seconds"] - t0)
                losses.append(float(m["loss"]))
        del state, step
        free(torch)
        return {"s_per_step": seconds,
                "tokens_per_s": [math.prod(SEQ_TRAIN_BATCH) / t
                                 for t in seconds],
                "losses": losses, "held_gb": state_gb,
                "step_peak_gb": peak_gb(torch),
                "launches_per_step": {k: c / n_steps for k, c in
                                      tally["launches"].items()},
                "launches": tally["launches"],
                "collectives_per_step": tally["collectives"] / n_steps,
                "staged_gb_per_step": tally["staged_bytes"] / n_steps
                / 1e9,
                "block_rows": sorted(set(block_rows))}

    with AS.sequence_sharding(False):                         # the warm-up
        train_run(1)
    for on in SEQ_TURNS:
        with AS.sequence_sharding(on):
            res["train"].append((on, train_run(SEQ_TRAIN_STEPS)))
    with AS.sequence_sharding(True):
        for name, pcfg in seq_parity_cfgs(torch).items():
            t0 = time.perf_counter()
            out = blocks_parity_run(torch, dev, rank, mesh, pcfg,
                                    SEQ_PARITY_TOL["small_grads"], steps=1)
            res["parity"][name] = dict(
                out, phase_seconds=time.perf_counter() - t0)
    res["phase_seconds"] = time.perf_counter() - t_all
    return res


def a7c_train_cfg(torch, name: str):
    """The meshed_a7c Adafactor bf16 config of ``name`` (constants
    above)."""
    from repro_torch.configs import jamba_1_5_large_398b, qwen2_moe_a2_7b
    if name == "jamba":
        full = jamba_1_5_large_398b.CONFIG
        return dataclasses.replace(full, n_layers=1,
                                   pattern=full.pattern[:1], remat="full")
    return dataclasses.replace(qwen2_moe_a2_7b.CONFIG, n_layers=2,
                               remat="full")


def a7c_mla_cfg(torch, layers: int, dtype):
    """minicpm3-4b at full width cut to ``layers``, at ``dtype``."""
    from repro_torch.configs import minicpm3_4b
    return dataclasses.replace(minicpm3_4b.CONFIG, n_layers=layers,
                               param_dtype=dtype)


def tree_gb(tree) -> float:
    from repro_torch.optim.functional import tree_leaves
    return sum(x.numel() * x.element_size()
               for x in tree_leaves(tree)) / 1e9


def param_count(cfg) -> int:
    from repro_torch.models import lm as LM
    from repro_torch.optim.functional import tree_leaves
    return sum(x.numel() for x in tree_leaves(LM.abstract_params(cfg)))


def a7c_train_run(torch, dev, mesh, name: str) -> dict:
    """``A7C_TRAIN_STEPS`` Adafactor steps of ``name``'s bf16 config on
    ``mesh`` from the rank's pieces of ``SHARDED_SEED``'s state: each
    step's seconds, tokens/s and loss; GB held (the state; its optimizer
    part beside the moments AdamW would hold for the same pieces) and
    the steps' peak; launches, collectives and staged GB a step, and the
    update's own reductions (calls and fp32 bytes) each step."""
    from repro_torch.launch import train as T
    from repro_torch.optim.functional import make_optimizer, tree_map
    cfg = a7c_train_cfg(torch, name)
    kw = dict(optimizer="adafactor", lr=SHARDED_TRAIN_LR)
    free(torch)
    state = T.init_train_state(cfg, seed=SHARDED_SEED, device=dev,
                               mesh=mesh, **kw)
    free(torch)
    held_gb = torch.cuda.memory_allocated() / 1e9
    meta = tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                          device="meta"), state["params"])
    adamw = make_optimizer("adamw", lr=SHARDED_TRAIN_LR)[0](meta)
    step = T.make_train_step(cfg, device=dev, mesh=mesh, **kw)
    batches = train_batches(torch, cfg, A7C_TRAIN_BATCH, 101,
                            A7C_TRAIN_STEPS)
    torch.cuda.reset_peak_memory_stats()
    tally, seconds, losses, reductions = {}, [], [], []
    for batch in batches:
        t0, r0 = tally.get("seconds", 0.0), dict(step.update_reductions)
        state, m = meshed_run(torch, lambda: step(state, batch), tally)
        seconds.append(tally["seconds"] - t0)
        losses.append(float(m["loss"]))
        reductions.append({k: n - r0[k]
                           for k, n in step.update_reductions.items()})
    n = len(batches)
    out = {"layers": cfg.n_layers, "params": param_count(cfg),
           "s_per_step": seconds,
           "tokens_per_s": [math.prod(A7C_TRAIN_BATCH) / t
                            for t in seconds],
           "losses": losses, "held_gb": held_gb,
           "opt_gb": tree_gb(state["opt"]),
           "adamw_opt_gb": tree_gb([adamw["m"], adamw["v"]]),
           "step_peak_gb": peak_gb(torch),
           "launches": tally["launches"],
           "launches_per_step": {k: c / n for k, c in
                                 tally["launches"].items()},
           "collectives_per_step": tally["collectives"] / n,
           "staged_gb_per_step": tally["staged_bytes"] / n / 1e9,
           "update_reductions": reductions}
    del state, step
    free(torch)
    return out


def mla_decode_run(torch, dev, cfg, prompt_shape, steps: int, mesh=None,
                   keep_logits: bool = False) -> dict:
    """minicpm3 ``cfg`` from ``SHARDED_SEED`` (the rank's pieces on
    ``mesh``): the prefill of ``prompt_shape`` (rows, positions) tokens
    filling a cache of positions + ``steps`` slots in the model's dtype
    (its slots split over model on ``mesh``), then ``steps`` greedy
    serve steps, the first untimed (the meshed step gathers its weights
    there).  Returns the greedy tokens (the prefill's and the steps'), GB
    held (the weights, the cache) and peak, the prefill's seconds,
    launches and collectives, and ms, launches, collectives, staged GB
    and log-sum-exp merges a timed step; with ``keep_logits`` each
    greedy token's logits whole (fp32, in host memory)."""
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import train as T
    from repro_torch.models import lm as LM
    rows, length = prompt_shape
    max_seq = length + steps
    free(torch)
    params = (LM.init_params(cfg, seed=SHARDED_SEED, device=dev)
              if mesh is None else
              T.init_pieces(cfg, mesh, seed=SHARDED_SEED, device=dev))
    prompt = torch.randint(0, cfg.vocab_size, prompt_shape,
                           generator=torch.Generator().manual_seed(102))
    prefill = T.make_prefill_step(cfg, device=dev, mesh=mesh,
                                  max_seq=max_seq)
    serve = T.make_serve_step(cfg, batch=rows, max_seq=max_seq,
                              cache_dtype=cfg.param_dtype, device=dev,
                              mesh=mesh)
    cache = LM.init_cache(cfg, rows, max_seq, cfg.param_dtype, dev, mesh)
    free(torch)
    held_gb = torch.cuda.memory_allocated() / 1e9
    kept = []

    def greedy(logits):
        if keep_logits:
            whole = logits if mesh is None or \
                logits.shape[-1] == cfg.vocab_size else S.gather_leaf(
                    mesh, S.P(None, "model"), logits.contiguous())
            kept.append(whole.float().cpu())
        return T.greedy_tokens(logits, mesh, cfg.vocab_size)

    torch.cuda.reset_peak_memory_stats()
    pre, dec = {}, {}
    logits = meshed_run(torch, lambda: prefill(
        params, {"tokens": prompt}, cache), pre)
    finite = bool(torch.isfinite(logits[:, -1].float()).all())
    out = [greedy(logits[:, -1])]
    del logits
    logits, _ = serve(params, cache, out[-1][:, None], length)
    out.append(greedy(logits[:, -1]))
    merges = serve.lse_merges

    def decode():
        for i in range(1, steps):
            logits, _ = serve(params, cache, out[-1][:, None], length + i)
            out.append(greedy(logits[:, -1]))
        return logits

    logits = meshed_run(torch, decode, dec)
    finite = finite and bool(torch.isfinite(logits.float()).all())
    timed = steps - 1
    res = {"tokens": torch.stack(out, 1).cpu().tolist(), "finite": finite,
           "held_gb": held_gb, "cache_gb": tree_gb(cache),
           "peak_gb": peak_gb(torch), "prefill_s": pre["seconds"],
           "prefill_launches": pre["launches"],
           "prefill_collectives": pre["collectives"],
           "decode_ms_per_step": dec["seconds"] / timed * 1e3,
           "decode_launches_per_step": {k: n / timed for k, n in
                                        dec["launches"].items()},
           "decode_collectives_per_step": dec["collectives"] / timed,
           "decode_staged_gb_per_step": dec["staged_bytes"] / timed / 1e9,
           "lse_merges_per_step": (serve.lse_merges - merges) / timed,
           "logits": kept}
    del params, cache, serve, prefill, logits
    free(torch)
    return res


def a7c_mla_runs(torch, dev, mesh=None) -> dict:
    """The bf16 MLA decode run and the fp32 parity run (its logits kept)
    on ``mesh``, or without one."""
    t0 = time.perf_counter()
    bf16 = mla_decode_run(
        torch, dev, a7c_mla_cfg(torch, A7C_MLA_LAYERS, torch.bfloat16),
        A7C_MLA_PREFILL, A7C_MLA_STEPS, mesh)
    fp32 = mla_decode_run(
        torch, dev, a7c_mla_cfg(torch, A7C_MLA_PARITY_LAYERS,
                                torch.float32),
        A7C_MLA_PARITY, A7C_MLA_PARITY_STEPS, mesh, keep_logits=True)
    return {"bf16": bf16, "fp32": fp32,
            "seconds": time.perf_counter() - t0}


def a7c_parity_tol(name: str) -> dict:
    return {**SHARDED_TRAIN_TOL, "loss": 1e-6, **BLOCKS_TOL.get(name, {}),
            "small_grads": A7C_SMALL}


def rank_a7c_parity(torch, dev, rank, world, runs) -> dict:
    """The Adafactor fp32 parity (``blocks_parity_run``) of the SMOKE
    configs of each (mesh, models) of ``runs``, the MoE groups
    ``BLOCKS_GROUP_TOKENS`` tokens."""
    from repro_torch.configs import jamba_1_5_large_398b, qwen2_moe_a2_7b
    from repro_torch.launch.mesh import make_mesh
    mods = {"jamba": jamba_1_5_large_398b, "qwen2-moe": qwen2_moe_a2_7b}
    res = {}
    for shape, names in runs:
        mesh = make_mesh(tuple(shape), ("data", "model"))
        for name in names:
            mod = mods[name]
            t0 = time.perf_counter()
            with moe_group_tokens(BLOCKS_GROUP_TOKENS):
                out = blocks_parity_run(torch, dev, rank, mesh, mod.SMOKE,
                                        A7C_SMALL, optimizer="adafactor")
            res[(tuple(shape), name)] = dict(
                out, tol=a7c_parity_tol(name),
                phase_seconds=time.perf_counter() - t0)
    return res


def rank_a7c(torch, dev, rank, world) -> dict:
    """The meshed_a7c runs on ``A7C_MESH`` (constants above): the
    Adafactor bf16 steps of each of ``A7C_TRAIN_MODELS``
    (``a7c_train_run``) and the MLA runs (``a7c_mla_runs``)."""
    from repro_torch.launch.mesh import make_mesh
    t0 = time.perf_counter()
    mesh = make_mesh(A7C_MESH, ("data", "model"))
    res = {"train": {name: a7c_train_run(torch, dev, mesh, name)
                     for name in A7C_TRAIN_MODELS}}
    res["mla"] = a7c_mla_runs(torch, dev, mesh)
    res["phase_seconds"] = time.perf_counter() - t0
    return res


def elastic_model(torch):
    from repro_torch.configs import gemma_2b
    return gemma_2b.SMOKE


def rank_elastic_save(torch, dev, rank, world, directory) -> dict:
    """(2,2): step 1, a save of the state (assembled, the first rank
    writes), step 2: the step-2 loss and the parameters after it."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh
    t0 = time.perf_counter()
    mesh = make_mesh((2, 2), ("data", "model"))
    cfg = elastic_model(torch)
    specs = T.state_specs(cfg, mesh, lr=SHARDED_TRAIN_LR)
    state = T.init_train_state(cfg, lr=SHARDED_TRAIN_LR, device=dev,
                               mesh=mesh)
    step = T.make_train_step(cfg, lr=SHARDED_TRAIN_LR, device=dev,
                             mesh=mesh)
    b1, b2 = train_batches(torch, cfg, ELASTIC_BATCH, 94)
    state, _ = step(state, b1)
    CheckpointManager(directory).save(state, 1, mesh, specs)
    saved = tree_cpu(gather_tree(mesh, specs, state))
    state, m = step(state, b2)
    whole = gather_tree(mesh, specs["params"], state["params"])
    return {"loss": float(m["loss"]), "params": tree_cpu(whole),
            "saved": saved, "seconds": time.perf_counter() - t0}


def rank_elastic_restore(torch, dev, rank, world, directory) -> dict:
    """Restore step 1 onto (1,2), then step 2: the restored state
    (assembled), the loss and the parameters."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_mesh
    t0 = time.perf_counter()
    mesh = make_mesh((1, 2), ("data", "model"))
    cfg = elastic_model(torch)
    specs = T.state_specs(cfg, mesh, lr=SHARDED_TRAIN_LR)
    like = T.init_train_state(cfg, lr=SHARDED_TRAIN_LR, device=dev,
                              mesh=mesh)
    state = CheckpointManager(directory).restore(1, like, mesh, specs)
    restored = tree_cpu(gather_tree(mesh, specs, state))
    step = T.make_train_step(cfg, lr=SHARDED_TRAIN_LR, device=dev,
                             mesh=mesh)
    state, m = step(state, train_batches(torch, cfg, ELASTIC_BATCH, 94)[1])
    whole = gather_tree(mesh, specs["params"], state["params"])
    return {"loss": float(m["loss"]), "step": int(state["step"]),
            "params": tree_cpu(whole), "restored": restored,
            "seconds": time.perf_counter() - t0}


def tree_cpu(tree):
    """A host copy of every leaf (never the leaf itself: a state is
    updated in place)."""
    from repro_torch.optim.functional import tree_map
    return tree_map(lambda x: x.detach().to("cpu", copy=True), tree)


def rank_jobs(rank, world, jobs, dev="cuda") -> dict:
    """The rank functions ``jobs`` ([(name, args), ...]) of this script in
    one process group, in order (a group's start-up is paid once)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev == "cpu":
        cpu_stand_ins(torch)
    return {name: globals()[name](torch, dev, rank, world, *args)
            for name, args in jobs}


def cpu_stand_ins(torch) -> None:
    """No-op stand-ins for the ``torch.cuda`` timing and memory calls, so
    that a phase can be rehearsed on a CPU-only torch (``dev="cpu"``; the
    kernels' plain versions run).  ``main`` never installs them."""
    class Event:
        def __init__(self, **_):
            self.t = 0.0

        def record(self):
            self.t = time.perf_counter()

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return (other.t - self.t) * 1e3

    for name, fn in (("synchronize", lambda *a: None),
                     ("reset_peak_memory_stats", lambda *a: None),
                     ("max_memory_allocated", lambda *a: 0),
                     ("memory_allocated", lambda *a: 0),
                     ("empty_cache", lambda *a: None),
                     ("device_count", lambda *a: 0)):
        setattr(torch.cuda, name, fn)
    torch.cuda.Event = Event


def phase_sharded(torch, dev) -> dict:
    """Sharded serving on meshes of ranks, DDP and the pipeline, and
    meshed training and decode: a group of 4 ranks ((2,2) serving parity
    and bf16, the pipeline; sharded_train's (2,2) parity and bf16,
    sharded_decode's (2,2), elastic_restore's save on (2,2)) and then one
    of 2 ((2,1) and (1,2) serving parity, (1,2) bf16, DDP;
    sharded_train's (2,1) and (1,2) parity and (1,2) bf16,
    sharded_decode's (1,2), elastic_restore onto (1,2)), NCCL with a card
    a rank where there are enough, else gloo with every rank on
    ``cuda:0`` (the kernels on the card, the collectives staged through
    host memory).  The meshed-blocks jobs and the Adafactor parity
    (``rank_a7c_parity``) run in both groups, and the sequence-sharded
    (``rank_seq_shard``) and meshed_a7c (``rank_a7c``) ones last in the
    2-rank group.
    Returns the paged-kernel launches of each bf16 serving rank, and the
    flash and decode launches of each meshed training and decode rank."""
    from repro_torch.launch.mesh import default_backend, run_ranks

    cfg, params = sharded_parity_model(torch, dev)
    base = {}
    for sampled in (False, True):
        reqs = sharded_requests(torch, cfg, sampled)
        base[sampled] = run_engine(torch, cfg, params, reqs, dev)[0]
    decode_base = greedy_decode(torch, dev, cfg, params)
    del params
    free(torch)
    cfg3, params = sliding_model(torch, dev)
    decode_base["sliding"] = sliding_decode(torch, dev, cfg3, params)
    del params
    free(torch)
    blocks_base = {name: blocks_decode(torch, dev, name)
                   for name in BLOCKS_MODELS}
    a7c_base = a7c_mla_runs(torch, dev)

    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_elastic_")
    groups = {}
    for world in (PIPE_STAGES, 2):
        jobs = [(name, ([m for m in meshes if m[0] * m[1] == world],))
                for name, meshes in (
                    ("rank_sharded_parity", SHARDED_MESHES),
                    ("rank_sharded_bf16", SHARDED_BF16_MESHES),
                    ("rank_sharded_train", SHARDED_MESHES),
                    ("rank_sharded_train_bf16", SHARDED_TRAIN_BF16_MESHES),
                    ("rank_sharded_decode", SHARDED_DECODE_MESHES))]
        jobs += ([("rank_ddp", ()), ("rank_elastic_restore", (ckpt_dir,)),
                  ("rank_sliding_decode",
                   (decode_base["sliding"]["tokens"],))]
                 if world == 2 else
                 [("rank_pipeline", ()), ("rank_elastic_save", (ckpt_dir,))])
        blocks = [m for m in BLOCKS_MESHES if m[0] * m[1] == world]
        jobs += [("rank_blocks_parity", (blocks,)),
                 ("rank_blocks_decode", (blocks, {
                     n: b["tokens"] for n, b in blocks_base.items()})),
                 ("rank_blocks_bf16", ([(n, m) for n, ms in BLOCKS_BF16
                                        for m in ms
                                        if m[0] * m[1] == world],))]
        jobs.append(("rank_a7c_parity", ([r for r in A7C_PARITY
                                           if math.prod(r[0]) == world],)))
        if world == 2:
            jobs += [("rank_seq_shard", ()), ("rank_a7c", ())]
        t0 = time.perf_counter()
        groups[world] = run_ranks(rank_jobs, world, (jobs, dev),
                                  timeout=RANK_TIMEOUT)
        emit({"phase": "rank_group", "ranks": world,
              "backend": default_backend(world),
              "cards": torch.cuda.device_count(),
              "seconds": time.perf_counter() - t0})

    ok, lines = True, []
    for shape in SHARDED_MESHES:
        world = shape[0] * shape[1]
        for sampled in (False, True):
            ranks = [g["rank_sharded_parity"][(shape, sampled)]
                     for g in groups[world]]
            equal = [r["outs"] == base[sampled] for r in ranks]
            line = {"phase": "sharded_serving", "run": "fp32_parity",
                    "mesh": list(shape), "ranks": world,
                    "backend": default_backend(world),
                    "layers": cfg.n_layers, "sampled": sampled,
                    "equals_no_mesh": equal,
                    "first_divergence": [first_divergence(
                        base[sampled], r["outs"]) for r in ranks],
                    "launches": [r["launches"] for r in ranks],
                    "lse_merges": [r["lse_merges"] for r in ranks],
                    "kv_bytes": [r["kv_bytes"] for r in ranks],
                    "wall_s": [r["wall_s"] for r in ranks]}
            emit(line)
            ok = ok and all(equal) and all(
                r["launches"]["paged_attention"] > 0 for r in ranks)
    bf16 = {}
    for shape in SHARDED_BF16_MESHES:
        world = shape[0] * shape[1]
        ranks = [g["rank_sharded_bf16"][shape] for g in groups[world]]
        same = all(r["tokens"] == ranks[0]["tokens"] for r in ranks)
        line = {"phase": "sharded_serving", "run": "bf16",
                "mesh": list(shape), "ranks": world,
                "backend": default_backend(world), "layers": 18,
                "requests": MAX_BATCH,
                "tokens_per_s": [r["tokens_per_s"] for r in ranks],
                "steps": ranks[0]["steps"],
                "ranks_commit_the_same_tokens": same,
                **{k: [r[k] for r in ranks] for k in (
                    "launches", "lse_merges", "collectives",
                    "page_hwm_per_replica", "kv_bytes", "build_peak_gb",
                    "held_gb", "serve_peak_gb")}}
        emit(line)
        bf16[shape] = [r["launches"]["paged_attention"] for r in ranks]
        ok = ok and same and all(
            r["launches"]["paged_attention"] > 0 for r in ranks)
        if shape[1] > 1 and not all(r["lse_merges"] > 0 for r in ranks):
            ok = False        # gemma's one KV head: context parallel

    phase_ddp(torch, dev, [g["rank_ddp"] for g in groups[2]])
    phase_pipeline(torch, dev, [g["rank_pipeline"] for g in groups[4]])
    if not ok:
        raise AssertionError("sharded_serving: a mesh diverged or a rank "
                             "launched no paged kernel (lines above)")
    meshed = phase_meshed_training(torch, dev, groups, decode_base,
                                   ckpt_dir)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    blocks = phase_meshed_blocks(torch, dev, groups, blocks_base)
    seq = phase_meshed_seq_shard(torch, dev, groups)
    a7c = phase_meshed_a7c(torch, dev, groups, a7c_base)
    return {"paged_attention": bf16, **meshed, "meshed_blocks": blocks,
            "meshed_seq_shard": seq, "meshed_a7c": a7c,
            "train_bf16": {shape: [g["rank_sharded_train_bf16"][shape]
                                   for g in groups[shape[0] * shape[1]]]
                           for shape in SHARDED_TRAIN_BF16_MESHES}}


def phase_dryrun(torch, dev, train_bf16) -> dict:
    """The dry run on this host's CPU (each trace in a process of its own,
    rank 0 of a fake process group, on ``meta``; nothing on the card).
    (a) ``dryrun_check``: the bf16 gemma-2b train step that
    ``sharded_train`` ran on the card, on each of its meshes, predicted
    against what rank 0 measured there (``train_bf16``: each mesh's rank
    results): the bytes live before the step against ``held_gb``, the
    step's peak against ``step_peak_gb``, its collective calls against
    ``collectives_per_step``.  (b) ``dryrun_cell``: gemma-2b's
    ``DRYRUN_CELLS`` on the (16, 16) production mesh.  The traces run
    side by side; fails on a prediction out of its limit, a cell that is
    not ``ok`` or a phase over ``DRYRUN_SECONDS``."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.configs import ShapeSpec, gemma_2b
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    cfg = dataclasses.replace(gemma_2b.CONFIG, param_dtype=torch.bfloat16,
                              n_layers=SHARDED_TRAIN_BF16_LAYERS)
    b, s = SHARDED_TRAIN_BF16_BATCH
    spec = ShapeSpec("train", s, b)
    with ThreadPoolExecutor(len(train_bf16) + len(DRYRUN_CELLS)) as pool:
        preds = {shape: pool.submit(dryrun.trace_cell, cfg, spec,
                                    (shape, ("data", "model")),
                                    optimizer="adamw", skip_cost=True)
                 for shape in train_bf16}
        cells = {name: pool.submit(dryrun.run_cell, "gemma-2b", name,
                                   "single") for name in DRYRUN_CELLS}
        preds = {k: f.result() for k, f in preds.items()}
        cells = {k: f.result() for k, f in cells.items()}
    ok = True
    for shape, ranks in train_bf16.items():
        pred, r0 = preds[shape], ranks[0]
        mem = pred["memory"]
        held = mem["argument_bytes"] / 1e9
        peak = mem["bytes"] / 1e9
        calls = pred["collectives"]["calls"]
        line = {"phase": "dryrun_check", "mesh": list(shape),
                "model": "gemma-2b", "layers": SHARDED_TRAIN_BF16_LAYERS,
                "batch": [b, s], "remat": cfg.remat, "optimizer": "adamw",
                "held_gb": {"predicted": held, "measured": r0["held_gb"],
                            "ratio": held / r0["held_gb"],
                            "tol": DRYRUN_HELD_TOL},
                "peak_gb": {"predicted": peak,
                            "measured": r0["step_peak_gb"],
                            "ratio": peak / r0["step_peak_gb"],
                            "tol": DRYRUN_PEAK_TOL},
                "collective_calls": {
                    "predicted": calls,
                    "measured": r0["collectives_per_step"],
                    "ratio": calls / r0["collectives_per_step"]},
                "measured_ranks": {k: [r[k] for r in ranks] for k in (
                    "held_gb", "step_peak_gb", "collectives_per_step")},
                "predicted_collectives": pred["collectives"],
                "trace_s": pred["trace_s"]}
        emit(line)
        ok = ok and abs(line["held_gb"]["ratio"] - 1) <= DRYRUN_HELD_TOL \
            and abs(line["peak_gb"]["ratio"] - 1) <= DRYRUN_PEAK_TOL \
            and calls == r0["collectives_per_step"]
    for name, rec in cells.items():
        rl = rec["roofline"]
        emit({"phase": "dryrun_cell", "arch": rec["arch"],
              "shape": rec["shape"], "mesh": rec["mesh"],
              "status": rec["status"], "n_devices": rec["n_devices"],
              "trace_s": rec["trace_s"], "memory": rec["memory"],
              "fits_80gb": rec["fits_80gb"], "cost": rec["cost"],
              "collective_calls": rec["collectives"]["calls"],
              "dominant": rl["dominant"], "compute_s": rl["compute_s"],
              "memory_s": rl["memory_s"],
              "collective_s": rl["collective_s"],
              "useful_ratio": rl["useful_ratio"]})
        ok = ok and rec["status"] == "ok"
    seconds = time.perf_counter() - t0
    emit({"phase": "dryrun_seconds", "phase_seconds": seconds,
          "limit": DRYRUN_SECONDS})
    if not ok or seconds > DRYRUN_SECONDS:
        raise AssertionError("dryrun: a prediction out of its limit, a "
                             "cell not ok or the phase over its time "
                             "(lines above)")
    return {"check": preds, "cells": cells, "phase_seconds": seconds}


def phase_meshed_blocks(torch, dev, groups, base) -> dict:
    """The lines of the meshed-blocks jobs the rank groups ran
    (``meshed_blocks_parity``, ``meshed_blocks_decode``,
    ``meshed_blocks_bf16``), each checked: parity within its model's
    limits, every no-mesh token ranked first and the recorded logits
    within ``BLOCKS_DECODE_TOL`` of their RMS, finite bf16 logits, and on
    every rank the launches of the mixer kernels of each model's layers
    (the Mamba scan and flash or decode for jamba, WKV6 for rwkv6, flash
    or decode for qwen2-moe).  Returns each kernel's launches a rank, by
    run."""
    from repro_torch.launch.mesh import default_backend
    mixers = {"jamba": ("mamba_scan", "flash_attention",
                        "decode_attention"),
              "qwen2-moe": ("flash_attention", "decode_attention"),
              "rwkv6": ("rwkv6_scan",)}
    t0 = time.perf_counter()
    ok, counts, seconds = True, {}, {}
    for shape in BLOCKS_MESHES:
        world = shape[0] * shape[1]
        mesh = "x".join(map(str, shape))
        for name in BLOCKS_MODELS:
            ranks = [g["rank_blocks_parity"][(shape, name)]
                     for g in groups[world]]
            r0 = ranks[0]
            tol, errs = r0["tol"], r0["errors"]
            loss_rel = max(abs(a - b) / abs(b) for a, b in
                           zip(r0["loss"], r0["ref_loss"]))
            gnorm_rel = max(abs(a - b) / abs(b) for a, b in
                            zip(r0["grad_norm"], r0["ref_grad_norm"]))
            cfg = blocks_cfg(torch, name, "parity")
            line = {"phase": "meshed_blocks_parity", "mesh": list(shape),
                    "ranks": world, "backend": default_backend(world),
                    "model": cfg.name, "layers": cfg.n_layers,
                    "d_model": cfg.d_model, "dtype": "float32",
                    "batch": list(BLOCKS_TRAIN_BATCH), "optimizer": "adamw",
                    "steps": 2,
                    "lr": SHARDED_TRAIN_LR,
                    "loss": [r["loss"] for r in ranks],
                    "one_process_loss": r0["ref_loss"],
                    "loss_max_rel_err": loss_rel,
                    "grad_norm_max_rel_err": gnorm_rel,
                    "errors": errs, "tol": tol,
                    "launches": [r["launches"] for r in ranks],
                    "collectives": [r["collectives"] for r in ranks],
                    "staged_gb": [r["staged_bytes"] / 1e9 for r in ranks],
                    "meshed_seconds": [r["seconds"] for r in ranks],
                    "seconds": max(r["phase_seconds"] for r in ranks)}
            emit(line)
            seconds[f"parity_{name}_{mesh}"] = line["seconds"]
            kernels = mixers[name][:-1] if name != "rwkv6" else \
                mixers[name]
            good = parity_within(errs, loss_rel, gnorm_rel, tol) and all(
                r["launches"].get(k, 0) > 0 for r in ranks
                for k in kernels)
            ok = ok and good
            counts[f"parity_{name}_{mesh}"] = {
                k: [r["launches"].get(k, 0) for r in ranks]
                for k in kernels}

    for shape in BLOCKS_MESHES:
        world = shape[0] * shape[1]
        mesh = "x".join(map(str, shape))
        for name in BLOCKS_MODELS:
            want = base[name]
            ranks = [g["rank_blocks_decode"][(shape, name)]
                     for g in groups[world]]
            rec_err = []
            for r in ranks:
                errs = []
                for i in BLOCKS_DECODE_RECORD:
                    x, y = r["record"][i], want["record"][i]
                    y = y[r["row0"]:r["row0"] + len(x)]
                    errs.append(float((x - y).abs().max()
                                      / y.pow(2).mean().sqrt()))
                rec_err.append(max(errs))
            cfg = blocks_cfg(torch, name, "decode")
            choices = SHARDED_DECODE_ROWS * (BLOCKS_DECODE_STEPS + 1)
            first = sum(r["ranked_first"] for r in ranks) // shape[1]
            line = {"phase": "meshed_blocks_decode", "mesh": list(shape),
                    "ranks": world, "model": cfg.name,
                    "layers": cfg.n_layers,
                    "pattern": [[b.mixer, b.ffn] for b in cfg.pattern],
                    "dtype": "float32", "rows": SHARDED_DECODE_ROWS,
                    "prompt": SHARDED_DECODE_PROMPT,
                    "steps": BLOCKS_DECODE_STEPS,
                    "no_mesh_tokens_ranked_first": [first, choices],
                    "max_gap_over_rms": [r["gap"] for r in ranks],
                    "recorded_steps": list(BLOCKS_DECODE_RECORD),
                    "recorded_max_err_over_rms": rec_err,
                    "tol": {"gap": BLOCKS_DECODE_TOL,
                            "recorded": BLOCKS_RECORD_TOL},
                    "lse_merges": [r["lse_merges"] for r in ranks],
                    "launches": [r["launches"] for r in ranks],
                    "collectives": [r["collectives"] for r in ranks],
                    "staged_gb": [r["staged_bytes"] / 1e9 for r in ranks],
                    "seconds": max(r["phase_seconds"] for r in ranks),
                    "no_mesh_seconds": want["phase_seconds"]}
            emit(line)
            seconds[f"decode_{name}_{mesh}"] = line["seconds"]
            kernels = mixers[name]
            # a token another ranks first by no more than the limit is a
            # near-tie at fp32
            ok = ok and all(
                r["gap"] <= BLOCKS_DECODE_TOL for r in ranks) and all(
                e <= BLOCKS_RECORD_TOL for e in rec_err) and all(
                r["launches"].get(k, 0) > 0 for r in ranks
                for k in kernels)
            counts[f"decode_{name}_{mesh}"] = {
                k: [r["launches"].get(k, 0) for r in ranks]
                for k in kernels}

    for name, shapes in BLOCKS_BF16:
        for shape in shapes:
            world = shape[0] * shape[1]
            mesh = "x".join(map(str, shape))
            ranks = [g["rank_blocks_bf16"][(name, shape)]
                     for g in groups[world]]
            cfg = blocks_cfg(torch, name, "bf16")
            line = {"phase": "meshed_blocks_bf16", "mesh": list(shape),
                    "ranks": world, "backend": default_backend(world),
                    "model": cfg.name, "layers": cfg.n_layers,
                    "prefill_shape": list(PREFILL_SHAPE),
                    "decode": {"rows": BLOCKS_BF16_DECODE[0],
                               "steps": BLOCKS_BF16_DECODE[1]},
                    **{k: [r[k] for r in ranks] for k in (
                        "prefill_tokens_per_s", "prefill_s",
                        "decode_ms_per_step", "build_peak_gb", "held_gb",
                        "prefill_peak_gb", "decode_peak_gb",
                        "prefill_launches", "decode_launches_per_step",
                        "prefill_collectives", "prefill_staged_gb",
                        "decode_collectives_per_step",
                        "decode_staged_gb_per_step", "finite")},
                    "seconds": max(r["phase_seconds"] for r in ranks)}
            emit(line)
            seconds[f"bf16_{name}_{mesh}"] = line["seconds"]
            pre_k = [k for k in mixers[name] if k != "decode_attention"]
            dec_k = [k for k in mixers[name] if k != "flash_attention"]
            ok = ok and all(r["finite"] for r in ranks) and all(
                r["prefill_launches"].get(k, 0) > 0 for r in ranks
                for k in pre_k) and all(
                r["decode_launches_per_step"].get(k, 0) > 0
                for r in ranks for k in dec_k)
            counts[f"bf16_{name}_{mesh}_prefill"] = {
                k: [r["prefill_launches"].get(k, 0) for r in ranks]
                for k in pre_k}
            counts[f"bf16_{name}_{mesh}_decode_per_step"] = {
                k: [r["decode_launches_per_step"].get(k, 0)
                    for r in ranks] for k in dec_k}
    emit({"phase": "meshed_blocks_seconds", "by_run": seconds,
          "total": sum(seconds.values()),
          "check_seconds": time.perf_counter() - t0})
    if not ok:
        raise AssertionError("meshed_blocks: a check failed (lines above)")
    return counts


def parity_within(errs: dict, loss_rel: float, gnorm_rel: float,
                  tol: dict) -> bool:
    """Whether a ``blocks_parity_run``'s errors are within ``tol``: the
    loss and grad norm, the gradients, AdamW's m (and v, and Adafactor's
    factors, at twice the moments' limit), the parameters within 2 lr
    and all but ``params_beyond_frac`` of a leaf's elements within 1e-5
    of its largest."""
    params_ok = all(
        e["within_2lr"] and e["beyond"] <= max(
            1, tol["params_beyond_frac"] * e["elements"])
        for k, e in errs.items() if k.startswith("params"))
    return params_ok and loss_rel <= tol["loss"] and \
        gnorm_rel <= tol["loss"] and \
        errs["grads"]["rel"] <= tol["grads"] and all(
            e["rel"] <= tol["moments"] * (1 if k[0] == "m" else 2)
            for k, e in errs.items() if k[0] in "mv"
            or k.startswith("fac"))


def phase_meshed_seq_shard(torch, dev, groups) -> dict:
    """The lines of the 2-rank group's ``rank_seq_shard`` job
    (``meshed_seq_shard_model``, ``meshed_seq_shard_serve``,
    ``meshed_seq_shard_train``, ``meshed_seq_shard_parity``,
    ``meshed_seq_shard_seconds``), each checked: the decode tokens with
    the switch on equal to those with it off, finite logits, the flash
    kernel launched in every prefill and train run and the decode kernel
    in every decode run on every rank, each switch-on block given the
    rank's S/m rows, finite losses, the fp32 parity within
    ``SEQ_PARITY_TOL``.  Returns each rank's launches by run."""
    from repro_torch.launch.mesh import default_backend
    t0 = time.perf_counter()
    ranks = [g["rank_seq_shard"] for g in groups[2]]
    cfg = seq_model(torch)
    m = SEQ_MESH[1]
    base = {"mesh": list(SEQ_MESH), "ranks": 2,
            "backend": default_backend(2), "model": cfg.name}
    emit({"phase": "meshed_seq_shard_model", **base,
          "d_model": cfg.d_model, "n_heads": cfg.n_heads,
          "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.hd,
          "d_ff": cfg.d_ff, "vocab_size": cfg.vocab_size,
          "layers": cfg.n_layers, "layers_of": 60,
          "params": lm_param_count(cfg), "dtype": "bfloat16",
          "pieces_gb": [r["pieces_gb"] for r in ranks]})
    ok, counts = True, {}
    first = ranks[0]["serve"][0][1]["tokens"]
    for turn, on in enumerate(SEQ_TURNS):
        runs = [r["serve"][turn][1] for r in ranks]
        line = {"phase": "meshed_seq_shard_serve", **base, "turn": turn,
                "seq_shard": on, "prefill": list(SEQ_PREFILL),
                "decode_steps": SEQ_DECODE_STEPS,
                **{k: [x[k] for x in runs] for k in (
                    "prefill_s", "prefill_tokens_per_s", "prefill_peak_gb",
                    "prefill_launches", "prefill_collectives",
                    "prefill_staged_gb", "prefill_block_rows",
                    "decode_ms_per_step", "decode_peak_gb",
                    "decode_launches", "decode_collectives_per_step",
                    "finite")},
                "tokens": runs[0]["tokens"],
                "tokens_equal_first_turn": all(x["tokens"] == first
                                               for x in runs)}
        emit(line)
        rows = SEQ_PREFILL[1] // (m if on else 1)
        ok = ok and line["tokens_equal_first_turn"] and all(
            x["finite"] and x["prefill_block_rows"] == [rows]
            and x["prefill_launches"].get("flash_attention", 0) > 0
            and x["decode_launches"].get("decode_attention", 0) > 0
            for x in runs)
        tag = f"turn{turn}_{'on' if on else 'off'}"
        counts[f"prefill_{tag}"] = {"flash_attention": [
            x["prefill_launches"].get("flash_attention", 0) for x in runs]}
        counts[f"decode_{tag}"] = {"decode_attention": [
            x["decode_launches"].get("decode_attention", 0) for x in runs]}
    for turn, on in enumerate(SEQ_TURNS):
        runs = [r["train"][turn][1] for r in ranks]
        line = {"phase": "meshed_seq_shard_train", **base, "turn": turn,
                "seq_shard": on, "batch": list(SEQ_TRAIN_BATCH),
                "steps": SEQ_TRAIN_STEPS, "optimizer": "adamw",
                "remat": cfg.remat,
                **{k: [x[k] for x in runs] for k in (
                    "tokens_per_s", "s_per_step", "losses", "held_gb",
                    "step_peak_gb", "launches_per_step",
                    "collectives_per_step", "staged_gb_per_step",
                    "block_rows")}}
        emit(line)
        rows = SEQ_TRAIN_BATCH[1] // (m if on else 1)
        ok = ok and all(
            x["block_rows"] == [rows] and all(
                math.isfinite(v) for v in x["losses"])
            and x["launches"].get("flash_attention", 0) > 0 for x in runs)
        counts[f"train_turn{turn}_{'on' if on else 'off'}"] = {
            "flash_attention": [x["launches"].get("flash_attention", 0)
                                for x in runs]}
    tol = SEQ_PARITY_TOL
    for name, pcfg in seq_parity_cfgs(torch).items():
        runs = [r["parity"][name] for r in ranks]
        r0 = runs[0]
        loss_rel = max(abs(a - b) / abs(b) for a, b in
                       zip(r0["loss"], r0["ref_loss"]))
        gnorm_rel = max(abs(a - b) / abs(b) for a, b in
                        zip(r0["grad_norm"], r0["ref_grad_norm"]))
        good = parity_within(r0["errors"], loss_rel, gnorm_rel, tol) and \
            all(x["launches"].get("flash_attention", 0) > 0 for x in runs)
        emit({"phase": "meshed_seq_shard_parity", **base, "model": name,
              "n_heads": pcfg.n_heads, "n_kv_heads": pcfg.n_kv_heads,
              "seq_shard": True, "dtype": "float32",
              "batch": list(BLOCKS_TRAIN_BATCH), "steps": 1,
              "loss": [x["loss"] for x in runs],
              "one_process_loss": r0["ref_loss"],
              "loss_max_rel_err": loss_rel,
              "grad_norm_max_rel_err": gnorm_rel, "errors": r0["errors"],
              "tol": tol, "within": good,
              "launches": [x["launches"] for x in runs],
              "collectives": [x["collectives"] for x in runs],
              "seconds": max(x["phase_seconds"] for x in runs)})
        ok = ok and good
    emit({"phase": "meshed_seq_shard_seconds",
          "rank_seconds": [r["phase_seconds"] for r in ranks],
          "check_seconds": time.perf_counter() - t0})
    if not ok:
        raise AssertionError("meshed_seq_shard: a check failed (lines "
                             "above)")
    return counts


def phase_meshed_a7c(torch, dev, groups, base) -> dict:
    """The lines of the meshed_a7c jobs (``meshed_a7c_models``,
    ``meshed_a7c_adafactor``, ``meshed_a7c_parity``,
    ``meshed_a7c_mla_decode``, ``meshed_a7c_mla_parity``,
    ``meshed_a7c_seconds``), each checked: finite Adafactor losses with
    the Mamba (jamba) or flash (qwen2-moe) kernel launched on every
    rank, the fp32 parity within ``a7c_parity_tol``, finite MLA logits
    with the flash kernel in every prefill and the decode kernel in every
    step on every rank, the fp32 MLA tokens equal to the no-mesh run's
    and each step's logits within ``A7C_MLA_TOL`` of their largest.
    ``base``: ``a7c_mla_runs`` without a mesh.  Returns each rank's
    launches by run."""
    from repro_torch.launch.mesh import default_backend
    t0 = time.perf_counter()
    ranks = [g["rank_a7c"] for g in groups[2]]
    mesh = {"mesh": list(A7C_MESH), "ranks": 2,
            "backend": default_backend(2)}
    mla = a7c_mla_cfg(torch, A7C_MLA_LAYERS, torch.bfloat16)
    emit({"phase": "meshed_a7c_models", **mesh, "adafactor": {
        name: {"d_model": c.d_model, "layers": c.n_layers,
               "cut": f"first {c.n_layers} of {n} layers",
               "params": param_count(c), "remat": c.remat,
               "batch": list(A7C_TRAIN_BATCH)}
        for name, n in (("jamba", 72), ("qwen2-moe", 24))
        for c in [a7c_train_cfg(torch, name)]},
        "mla": {"model": mla.name, "d_model": mla.d_model,
                "n_heads": mla.n_heads, "q_lora_rank": mla.q_lora_rank,
                "kv_lora_rank": mla.kv_lora_rank,
                "nope": mla.mla_nope_dim, "rope": mla.mla_rope_dim,
                "v": mla.mla_v_dim, "vocab_size": mla.vocab_size,
                "layers": mla.n_layers, "layers_of": 62,
                "params": param_count(mla),
                "prefill": list(A7C_MLA_PREFILL), "steps": A7C_MLA_STEPS,
                "max_seq": A7C_MLA_PREFILL[1] + A7C_MLA_STEPS}})
    ok, counts = True, {}
    kernel = {"jamba": "mamba_scan", "qwen2-moe": "flash_attention"}
    for name in A7C_TRAIN_MODELS:
        runs = [r["train"][name] for r in ranks]
        emit({"phase": "meshed_a7c_adafactor", **mesh, "model": name,
              "dtype": "bfloat16", "steps": A7C_TRAIN_STEPS,
              **{k: [x[k] for x in runs] for k in (
                  "losses", "tokens_per_s", "s_per_step", "held_gb",
                  "opt_gb", "adamw_opt_gb", "step_peak_gb",
                  "launches_per_step", "collectives_per_step",
                  "staged_gb_per_step", "update_reductions")}})
        ok = ok and all(all(math.isfinite(v) for v in x["losses"])
                        and x["launches"].get(kernel[name], 0) > 0
                        for x in runs)
        counts[f"adafactor_{name}"] = {k: [x["launches"].get(k, 0)
                                           for x in runs]
                                       for k in ("flash_attention",
                                                 "mamba_scan")}
    for shape, names in A7C_PARITY:
        world = shape[0] * shape[1]
        for name in names:
            runs = [g["rank_a7c_parity"][(shape, name)]
                    for g in groups[world]]
            r0 = runs[0]
            loss_rel = max(abs(a - b) / abs(b) for a, b in
                           zip(r0["loss"], r0["ref_loss"]))
            gnorm_rel = max(abs(a - b) / abs(b) for a, b in
                            zip(r0["grad_norm"], r0["ref_grad_norm"]))
            good = parity_within(r0["errors"], loss_rel, gnorm_rel,
                                 r0["tol"])
            emit({"phase": "meshed_a7c_parity", "mesh": list(shape),
                  "ranks": world, "backend": default_backend(world),
                  "model": f"{name} SMOKE", "optimizer": "adafactor",
                  "dtype": "float32", "batch": list(BLOCKS_TRAIN_BATCH),
                  "steps": len(r0["loss"]),
                  "loss": [x["loss"] for x in runs],
                  "one_process_loss": r0["ref_loss"],
                  "loss_max_rel_err": loss_rel,
                  "grad_norm_max_rel_err": gnorm_rel,
                  "errors": r0["errors"], "tol": r0["tol"], "within": good,
                  "update_reductions": [x["update_reductions"]
                                        for x in runs],
                  "launches": [x["launches"] for x in runs],
                  "seconds": max(x["phase_seconds"] for x in runs)})
            ok = ok and good
    runs = [r["mla"]["bf16"] for r in ranks]
    want = base["bf16"]["tokens"]
    line = {"phase": "meshed_a7c_mla_decode", **mesh, "model": mla.name,
            "dtype": "bfloat16", "layers": mla.n_layers,
            "no_mesh": {k: base["bf16"][k] for k in (
                "decode_ms_per_step", "prefill_s", "held_gb", "cache_gb",
                "peak_gb", "decode_launches_per_step")},
            **{k: [x[k] for x in runs] for k in (
                "decode_ms_per_step", "decode_collectives_per_step",
                "decode_staged_gb_per_step", "lse_merges_per_step",
                "held_gb", "peak_gb", "cache_gb",
                "decode_launches_per_step", "prefill_s",
                "prefill_launches", "prefill_collectives", "finite")},
            "first_divergence": [first_divergence(want, x["tokens"])
                                 for x in runs]}
    emit(line)
    ok = ok and all(
        x["finite"] and x["prefill_launches"].get("flash_attention", 0) > 0
        and x["decode_launches_per_step"].get("decode_attention", 0) > 0
        for x in runs)
    counts["mla_prefill"] = {"flash_attention": [
        x["prefill_launches"].get("flash_attention", 0) for x in runs]}
    counts["mla_decode_per_step"] = {"decode_attention": [
        x["decode_launches_per_step"].get("decode_attention", 0)
        for x in runs]}
    runs = [r["mla"]["fp32"] for r in ranks]
    ref = base["fp32"]
    errs = [max(float((a - b).abs().max() / b.abs().max())
                for a, b in zip(x["logits"], ref["logits"])) for x in runs]
    equal = [x["tokens"] == ref["tokens"] for x in runs]
    emit({"phase": "meshed_a7c_mla_parity", **mesh, "model": mla.name,
          "dtype": "float32", "layers": A7C_MLA_PARITY_LAYERS,
          "prompt": list(A7C_MLA_PARITY), "steps": A7C_MLA_PARITY_STEPS,
          "tokens_equal_no_mesh": equal, "logits_max_rel_err": errs,
          "tol": A7C_MLA_TOL,
          "lse_merges_per_step": [x["lse_merges_per_step"] for x in runs],
          "decode_launches_per_step": [x["decode_launches_per_step"]
                                       for x in runs]})
    ok = ok and all(equal) and max(errs) <= A7C_MLA_TOL and all(
        x["decode_launches_per_step"].get("decode_attention", 0) > 0
        for x in runs)
    emit({"phase": "meshed_a7c_seconds",
          "no_mesh_seconds": base["seconds"],
          "rank_seconds": [r["phase_seconds"] for r in ranks],
          "parity_seconds": {f"{x}x{y}": max(
              g["rank_a7c_parity"][((x, y), n)]["phase_seconds"]
              for g in groups[x * y] for n in names)
              for (x, y), names in A7C_PARITY},
          "check_seconds": time.perf_counter() - t0})
    if not ok:
        raise AssertionError("meshed_a7c: a check failed (lines above)")
    return counts


def phase_meshed_training(torch, dev, groups, decode_base, ckpt_dir
                          ) -> dict:
    """The lines of the meshed training and decode jobs the rank groups
    ran (``sharded_train`` fp32 parity and bf16, ``sharded_decode``,
    ``elastic_restore``, with the restore onto no mesh made here), each
    checked; returns each rank's flash launches of the train runs and
    decode launches of the decode runs, by mesh."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train as T
    from repro_torch.optim.functional import tree_leaves

    tol = SHARDED_TRAIN_TOL
    ok, flash, decode, seconds = True, {}, {}, {}
    for shape in SHARDED_MESHES:
        world = shape[0] * shape[1]
        ranks = [g["rank_sharded_train"][shape] for g in groups[world]]
        r0 = ranks[0]
        errs = r0["errors"]
        loss_rel = max(abs(a - b) / abs(b) for a, b in
                       zip(r0["loss"], r0["ref_loss"]))
        gnorm_rel = max(abs(a - b) / abs(b) for a, b in
                        zip(r0["grad_norm"], r0["ref_grad_norm"]))
        line = {"phase": "sharded_train", "run": "fp32_parity",
                "mesh": list(shape), "ranks": world, "model": "gemma-2b",
                "layers": SHARDED_PARITY_LAYERS,
                "batch": list(SHARDED_TRAIN_BATCH), "optimizer": "adamw",
                "steps": 2,
                "lr": SHARDED_TRAIN_LR,
                "loss": [r["loss"] for r in ranks],
                "one_process_loss": r0["ref_loss"],
                "grad_norm": [r["grad_norm"] for r in ranks],
                "one_process_grad_norm": r0["ref_grad_norm"],
                "loss_max_rel_err": loss_rel,
                "grad_norm_max_rel_err": gnorm_rel,
                "errors": errs, "tol": tol,
                "flash_launches": [r["launches"].get("flash_attention", 0)
                                   for r in ranks],
                "launches": [r["launches"] for r in ranks],
                "collectives": [r["collectives"] for r in ranks],
                "staged_gb": [r["staged_bytes"] / 1e9 for r in ranks],
                "meshed_seconds": [r["seconds"] for r in ranks],
                "seconds": max(r["phase_seconds"] for r in ranks)}
        emit(line)
        seconds[f"train_fp32_{shape}"] = line["seconds"]
        flash["x".join(map(str, shape))] = line["flash_launches"]
        params_ok = all(
            e["within_2lr"] and e["beyond"] <= max(
                1, tol["params_beyond_frac"] * e["elements"])
            for k, e in errs.items() if k.startswith("params"))
        ok = ok and params_ok and loss_rel <= tol["loss"] and \
            gnorm_rel <= tol["loss"] and \
            errs["grads"]["rel"] <= tol["grads"] and all(
                e["rel"] <= tol["moments"] for k, e in errs.items()
                if k[0] in "mv") and all(
                n > 0 for n in line["flash_launches"])
    for shape in SHARDED_TRAIN_BF16_MESHES:
        world = shape[0] * shape[1]
        ranks = [g["rank_sharded_train_bf16"][shape] for g in groups[world]]
        line = {"phase": "sharded_train", "run": "bf16", "mesh": list(shape),
                "ranks": world, "model": "gemma-2b",
                "layers": SHARDED_TRAIN_BF16_LAYERS, "layers_of": 18,
                "batch": list(SHARDED_TRAIN_BF16_BATCH), "remat": "full",
                "steps": {"warmup": SHARDED_TRAIN_BF16_STEPS[0],
                          "timed": SHARDED_TRAIN_BF16_STEPS[1]},
                **{k: [r[k] for r in ranks] for k in (
                    "tokens_per_s", "s_per_step", "losses", "build_peak_gb",
                    "held_gb", "step_peak_gb", "save_peak_gb",
                    "save_leaf_gb", "save_leaf_seconds", "state_gb",
                    "launches_per_step",
                    "collectives_per_step", "staged_gb_per_step")},
                "seconds": max(r["phase_seconds"] for r in ranks)}
        emit(line)
        seconds[f"train_bf16_{shape}"] = line["seconds"]
        flash["bf16_" + "x".join(map(str, shape))] = [
            r["launches_per_step"].get("flash_attention", 0) for r in ranks]
        ok = ok and all(r["launches_per_step"].get("flash_attention", 0) > 0
                        and all(math.isfinite(x) for x in r["losses"])
                        for r in ranks)
    for shape in SHARDED_DECODE_MESHES:
        world = shape[0] * shape[1]
        ranks = [g["rank_sharded_decode"][shape] for g in groups[world]]
        equal = [r["first"] == decode_base["first"]
                 and r["tokens"] == decode_base["tokens"] for r in ranks]
        line = {"phase": "sharded_decode", "mesh": list(shape),
                "ranks": world, "model": "gemma-2b",
                "layers": SHARDED_PARITY_LAYERS, "dtype": "float32",
                "rows": SHARDED_DECODE_ROWS,
                "prompt": SHARDED_DECODE_PROMPT,
                "steps": SHARDED_DECODE_STEPS, "equals_no_mesh": equal,
                "lse_merges": [r["lse_merges"] for r in ranks],
                "launches": [r["launches"] for r in ranks],
                "collectives": [r["collectives"] for r in ranks],
                "staged_gb": [r["staged_bytes"] / 1e9 for r in ranks],
                "seconds": max(r["seconds"] for r in ranks),
                "no_mesh_seconds": decode_base["seconds"]}
        emit(line)
        seconds[f"decode_{shape}"] = line["seconds"]
        decode["x".join(map(str, shape))] = [
            r["launches"].get("decode_attention", 0) for r in ranks]
        ok = ok and all(equal) and all(
            r["lse_merges"] > 0 and r["launches"].get("decode_attention", 0)
            > 0 and r["launches"].get("flash_attention", 0) > 0
            for r in ranks)

    # the sliding rings split over model, wrapped
    base = decode_base["sliding"]
    ranks = [g["rank_sliding_decode"] for g in groups[2]]
    equal = [r["ranked_first"] for r in ranks]
    rec_err = [max(float((r["record"][i] - base["record"][i]).abs().max()
                         / base["record"][i].pow(2).mean().sqrt())
                   for i in SLIDING_RECORD) for r in ranks]
    line = {"phase": "sharded_decode", "run": "sliding",
            "mesh": list(SLIDING_DECODE_MESH), "ranks": 2,
            "model": "gemma3-1b", "layers": SLIDING_DECODE_LAYERS,
            "layers_of": 26, "dtype": "float32", "ring": 512,
            "rows": SHARDED_DECODE_ROWS, "prompt": SHARDED_DECODE_PROMPT,
            "steps": SLIDING_DECODE_STEPS,
            "no_mesh_token_ranked_first": equal,
            "tokens": SHARDED_DECODE_ROWS * SLIDING_DECODE_STEPS,
            "max_gap_over_rms": [r["gap"] for r in ranks],
            "recorded_steps": list(SLIDING_RECORD),
            "recorded_max_err_over_rms": rec_err, "tol": SLIDING_TOL,
            "lse_merges": [r["lse_merges"] for r in ranks],
            "launches": [r["launches"] for r in ranks],
            "collectives": [r["collectives"] for r in ranks],
            "seconds": max(r["seconds"] for r in ranks),
            "no_mesh_seconds": base["seconds"]}
    emit(line)
    seconds["decode_sliding"] = line["seconds"]
    decode["sliding_" + "x".join(map(str, SLIDING_DECODE_MESH))] = [
        r["launches"].get("decode_attention", 0) for r in ranks]
    ok = ok and all(
        r["gap"] <= SLIDING_TOL and e <= SLIDING_TOL and r["lse_merges"] > 0
        and r["launches"].get("decode_attention", 0) > 0
        for r, e in zip(ranks, rec_err))

    # elastic restore: saved on (2,2) after step 1; onto (1,2) in the
    # 2-rank group, and onto no mesh here
    t0 = time.perf_counter()
    saved = groups[4][0]["rank_elastic_save"]
    cfg = elastic_model(torch)
    like = T.init_train_state(cfg, lr=SHARDED_TRAIN_LR, device=dev)
    state = CheckpointManager(ckpt_dir).restore(1, like)
    restored = tree_cpu(state)
    step = T.make_train_step(cfg, lr=SHARDED_TRAIN_LR, device=dev)
    state, m = step(state, train_batches(torch, cfg, ELASTIC_BATCH, 94)[1])
    runs = {"1x2": [(r["loss"], r["params"], r["restored"]) for r in
                    (g["rank_elastic_restore"] for g in groups[2])],
            "none": [(float(m["loss"]), tree_cpu(state["params"]),
                      restored)]}
    # the restored state (parameters and both AdamW moments) bit for bit
    # the saved one; step 2 against the uninterrupted run's by
    # sharded_train's rule: every leaf within 2 lr plus the tight limit,
    # and no more than max(1, 1%) of a leaf's elements beyond the tight
    # limit (1e-5 of the leaf's largest)
    errs = {}
    for name, got in runs.items():
        worst = {"loss": 0.0, "abs": 0.0, "beyond": 0, "elements": 0,
                 "params_ok": True, "restore_exact": True}
        for loss, params, back in got:
            worst["loss"] = max(worst["loss"], abs(loss - saved["loss"])
                                / abs(saved["loss"]))
            worst["restore_exact"] &= all(
                x.dtype == y.dtype and torch.equal(x, y)
                for part in ("params", "opt", "step")
                for x, y in zip(tree_leaves(back[part]),
                                tree_leaves(saved["saved"][part])))
            for x, y in zip(tree_leaves(params),
                            tree_leaves(saved["params"])):
                err = (x - y).abs()
                tight = tol["params"] * max(y.abs().max().item(), 1e-30)
                n = int((err > tight).sum())
                worst["abs"] = max(worst["abs"], err.max().item())
                if n * max(worst["elements"], 1) >= \
                        worst["beyond"] * err.numel():
                    worst["beyond"], worst["elements"] = n, err.numel()
                worst["params_ok"] &= (
                    err.max().item() <= 2 * SHARDED_TRAIN_LR + tight
                    and n <= max(1, tol["params_beyond_frac"]
                                 * err.numel()))
        errs[name] = worst
    line = {"phase": "elastic_restore", "model": "gemma-smoke",
            "dtype": "float32", "saved_on": [2, 2],
            "restored_on": ["1x2", "none"],
            "restore_exact": {k: v["restore_exact"]
                              for k, v in errs.items()},
            "loss_rel_err": {k: v["loss"] for k, v in errs.items()},
            "params_max_abs_err": {k: v["abs"] for k, v in errs.items()},
            "params_beyond": {k: [v["beyond"], v["elements"]]
                              for k, v in errs.items()},
            "params_ok": {k: v["params_ok"] for k, v in errs.items()},
            "save_seconds": saved["seconds"],
            "restore_seconds": [g["rank_elastic_restore"]["seconds"]
                                for g in groups[2]],
            "seconds": saved["seconds"] + max(
                g["rank_elastic_restore"]["seconds"] for g in groups[2])
            + time.perf_counter() - t0}
    emit(line)
    seconds["elastic"] = line["seconds"]
    ok = ok and all(v["restore_exact"] and v["params_ok"]
                    and v["loss"] <= tol["loss"]
                    for v in errs.values()) and all(
        g["rank_elastic_restore"]["step"] == 2 for g in groups[2])
    emit({"phase": "meshed_training_seconds", "by_run": seconds,
          "total": sum(seconds.values())})
    if not ok:
        raise AssertionError("sharded_train / sharded_decode / "
                             "elastic_restore: a check failed (lines "
                             "above)")
    return {"flash_attention_train": flash,
            "decode_attention_sharded": decode}


def phase_ddp(torch, dev, ranks) -> None:
    """DDP's synced gradients against the full batch's in this process
    (within ``DDP_TOL`` of its largest), and the int8 path against the
    reference's arithmetic on each rank's bucket."""
    from repro_torch.distributed.ddp import (DistributedDataParallel,
                                             _compress_int8)
    from repro_torch.launch.mesh import default_backend
    model, x, y = ddp_net(torch, dev)
    import repro_torch as rt
    with rt.default_device(dev):
        full = ddp_grads(model, x, y)
        n = DDP_BATCH // 2
        local = [ddp_grads(model, x[r * n:(r + 1) * n], y[r * n:(r + 1) * n])
                 for r in range(2)]
    scale = max(float(g.abs().max()) for g in full.values())
    err = max(float((step[k] - full[k].cpu()).abs().max())
              for r in ranks for step in r[None]["grads"] for k in full)
    # int8: every rank's codes summed, times the rank's own scale
    names = {id(p): k for k, p in model.named_parameters()}
    buckets = DistributedDataParallel(model, bucket_mb=DDP_BUCKET_MB).buckets
    int8_err = 0.0
    for bucket in buckets:
        keys = [names[id(p)] for p in bucket]
        parts = [_compress_int8(torch.cat([g[k].reshape(-1) for k in keys])
                                / 2, None) for g in local]
        codes = sum(q.float() for q, _, _ in parts)
        for r, res in enumerate(ranks):
            got = torch.cat([res["int8"]["grads"][0][k].reshape(-1)
                             for k in keys])
            int8_err = max(int8_err, float(
                (got - (codes * parts[r][1]).cpu()).abs().max()))
    line = {"phase": "ddp", "ranks": 2, "backend": default_backend(2),
            "cards": torch.cuda.device_count(), "width": DDP_WIDTH,
            "batch": DDP_BATCH, "buckets": ranks[0][None]["n_buckets"],
            "max_abs_err": err, "grad_max": scale, "tol": DDP_TOL,
            "sync_ms": [r[None]["sync_ms"] for r in ranks],
            "stats": [r[None]["stats"] for r in ranks],
            "int8_stats": [r["int8"]["stats"] for r in ranks],
            "int8_residual_max": [r["int8"]["residual_max"] for r in ranks],
            "int8_max_abs_err_vs_reference_arithmetic": int8_err}
    emit(line)
    if not err <= DDP_TOL * scale or int8_err > 1e-6 * scale or \
            line["buckets"] < 2:
        raise AssertionError(f"ddp: {line}")


def phase_pipeline(torch, dev, ranks) -> None:
    """The pipeline's output (4 ranks) against the sequential composition
    in this process, within ``PIPE_TOL``."""
    from repro_torch.launch.mesh import default_backend
    w, x = pipe_inputs(torch)
    w, x = w.to(dev), x.to(dev)
    ref = x
    for i in range(PIPE_STAGES):
        ref = tanh_stage(w[i], ref)
    seq_ms = time_ms(torch, lambda: [tanh_stage(w[i], x)
                                     for i in range(PIPE_STAGES)], reps=5)
    out = ranks[0]["out"].to(dev)
    rtol, atol = PIPE_TOL
    err = (out - ref).abs().max().item()
    ok = bool(((out - ref).abs() <= atol + rtol * ref.abs()).all())
    emit({"phase": "pipeline", "stages": PIPE_STAGES,
          "backend": default_backend(PIPE_STAGES),
          "cards": torch.cuda.device_count(),
          "microbatches": PIPE_MICRO, "width": PIPE_WIDTH,
          "batch": PIPE_BATCH, "max_abs_err": err, "tol": PIPE_TOL,
          "ms": [r["ms"] for r in ranks], "sequential_ms": seq_ms})
    if not ok:
        raise AssertionError(f"pipeline: {err} outside {PIPE_TOL}")


def run_phases(torch, dev) -> list:
    """Every phase in order; returns the rows of the kernel table."""
    from repro_torch.models.lm import BlockSpec

    rows = {"paged_attention": phase_paged_attention(torch, dev),
            "paged_attention_lse": phase_paged_lse(torch, dev),
            "gumbel_perturb": phase_gumbel(torch, dev),
            "flash_attention": phase_flash(torch, dev),
            "decode_attention": phase_decode(torch, dev),
            "decode_attention_lse": phase_decode_lse(torch, dev),
            "rwkv6_scan": phase_rwkv6(torch, dev),
            "mamba_scan": phase_mamba(torch, dev),
            "mixed_attention": phase_mixed_attention(torch, dev),
            "fused_elementwise": phase_fused_elementwise(torch, dev)}
    phase_small_e2e(torch)

    # the eager runtime: ResNet-50 training (each model freed at the end
    # of its phase)
    eager, profile_eager_train = phase_eager_train(torch, dev)
    counts_eager = eager["fused_elementwise"]
    phase_eager_parity(torch, dev)
    # the rest of the eager runtime: GNMT, the jit bridge, masked SDPA
    _, profile_gnmt_train = phase_gnmt_train(torch, dev)
    phase_gnmt_parity(torch, dev)
    phase_compiled_path(torch, dev)
    phase_masked_sdpa(torch, dev)

    # each model is freed before the next is made: jamba's 48 GB do not
    # fit beside gemma's 15 and rwkv's 9.6
    gemma = gemma_models(torch, dev)
    counts, profile_serving_run, serving_runs = phase_serving(
        torch, dev, gemma)
    counts["paged_attention_replicas"] = phase_replica_serving(
        torch, dev, gemma)["paged_attention"]
    cfg32, params32, cfg, params = gemma
    # the gathered-cache path and the front door, on the same bf16 model
    counts["mixed_attention"] = phase_paged_vs_gathered(
        torch, dev, cfg, params)["mixed_attention"]
    unified_greedy = phase_legacy_serving(torch, dev, cfg, params)
    phase_draft_spec(torch, dev, gemma, unified_greedy,
                     serving_runs["fp32_greedy"])
    frontend = phase_frontend_serving(torch, dev, cfg, params)
    phase_http_server(torch, frontend)
    del gemma, frontend
    free(torch)
    dense, profile_dense_prefill = phase_prefill(
        torch, dev, cfg, params, "dense_prefill", 21)
    counts["flash_attention"] = dense["flash_attention"]
    dense, profile_dense_decode = phase_decode_steps(
        torch, dev, cfg, params, "dense_decode", 22)
    counts["decode_attention"] = dense["decode_attention"]
    counts["fused_elementwise"] = counts_eager
    phase_parity(torch, dev, cfg32, params32, "dense_parity", 23)
    del params32, params
    free(torch)
    # sharded serving on meshes of ranks, DDP and the pipeline, meshed
    # training and decode: each rank makes its own model, so nothing is
    # held here meanwhile
    sharded = phase_sharded(torch, dev)
    counts["paged_attention_sharded"] = sharded["paged_attention"]
    phase_dryrun(torch, dev, sharded["train_bf16"])

    cfg32, params32, cfg, params = rwkv_models(torch, dev)
    rwkv, profile_rwkv_prefill = phase_prefill(
        torch, dev, cfg, params, "rwkv_prefill", 31)
    counts["rwkv6_scan"] = rwkv["rwkv6_scan"]
    _, profile_rwkv_decode = phase_decode_steps(
        torch, dev, cfg, params, "rwkv_decode", 32)
    phase_parity(torch, dev, cfg32, params32, "rwkv_parity", 33)
    del params32, params
    free(torch)

    cfg, params = jamba_model(torch, dev, torch.bfloat16, JAMBA_LAYERS)
    jamba, profile_jamba_prefill = phase_prefill(
        torch, dev, cfg, params, "jamba_prefill", 41)
    counts["mamba_scan"] = jamba["mamba_scan"]
    _, profile_jamba_decode = phase_decode_steps(
        torch, dev, cfg, params, "jamba_decode", 42)
    del params
    free(torch)
    # dropless prefill (capacity factor E / k), as decode always is, so
    # that the two compute the same function
    cfg32, params32 = jamba_model(
        torch, dev, torch.float32, len(JAMBA_PARITY_PATTERN),
        capacity_factor=cfg.n_experts / cfg.top_k,
        pattern=tuple(BlockSpec(*b) for b in JAMBA_PARITY_PATTERN))
    phase_parity(torch, dev, cfg32, params32, "jamba_parity", 43)
    del params32
    free(torch)

    # the seven architectures that came with the configs registry, each
    # at full width (arctic cut to 2 of 35 layers); the padding's cost
    arch_counts = phase_archs(torch, dev)
    counts["flash_attention_archs"] = {
        k: v.get("flash_attention", 0) for k, v in arch_counts.items()
        if k.endswith("_prefill")}
    counts["decode_attention_archs"] = {
        k: v.get("decode_attention", 0) for k, v in arch_counts.items()
        if k.endswith("_decode")}
    phase_head_padding(torch, dev)

    # LM training: the data loader, gemma-2b through train_loop, parity
    # against the CPU, restart
    phase_data_loader(torch, dev)
    counts_train = phase_lm_train(torch, dev)
    phase_lm_train_parity(torch, dev)
    phase_lm_restart(torch, dev)
    free(torch)

    # the profiled runs come last: a torch.profiler session leaves host
    # overhead behind it that slowed the timed runs made after it.  Each
    # model is made again from its seed, for the runs that profile it.
    for make, profiles in (
            (lambda: gemma_models(torch, dev)[3],
             (profile_serving_run, profile_dense_prefill,
              profile_dense_decode)),
            (lambda: rwkv_models(torch, dev)[3],
             (profile_rwkv_prefill, profile_rwkv_decode)),
            (lambda: jamba_model(torch, dev, torch.bfloat16,
                                 JAMBA_LAYERS)[1],
             (profile_jamba_prefill, profile_jamba_decode))):
        params = make()
        for profiled in profiles:
            profiled(params)
        del params
        free(torch)
    profile_lm_train(torch, dev)
    profile_eager_train()
    free(torch)
    profile_gnmt_train()
    paged_profile = profile_paged(torch, dev)
    gumbel_profile = profile_gumbel(torch, dev)
    flash_profile = profile_flash(torch, dev)
    decode_profile = profile_decode(torch, dev)
    mixed_profile = profile_mixed(torch, dev)
    rwkv6_profile = profile_rwkv6(torch, dev)
    mamba_profile = profile_mamba(torch, dev)
    fused_profile = profile_fused(torch, dev)

    table = []
    for name, route, source, replaces in (
            ("paged_attention", "cuda",
             "src/repro_torch/kernels/csrc/paged_attention.cu",
             "src/repro/kernels/decode_attention.py:322"),
            ("gumbel_perturb", "triton",
             "src/repro_torch/kernels/_gumbel_triton.py",
             "src/repro/kernels/ops.py:336"),
            ("flash_attention", "cuda",
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:99"),
            ("decode_attention", "cuda",
             "src/repro_torch/kernels/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention.py:90"),
            ("rwkv6_scan", "cuda", "src/repro_torch/kernels/csrc/rwkv6.cu",
             "src/repro/kernels/rwkv6.py:64"),
            ("mamba_scan", "cuda", "src/repro_torch/kernels/csrc/mamba.cu",
             "src/repro/kernels/mamba.py:55"),
            ("fused_elementwise", "triton",
             "src/repro_torch/kernels/fused_elementwise.py",
             "src/repro/kernels/ops.py:277"),
            ("mixed_attention", "cuda",
             "src/repro_torch/kernels/csrc/mixed_attention.cu",
             "src/repro/kernels/decode_attention.py:186")):
        r = rows[name]
        entry = {"name": name, "route": route, "source": source,
                 "replaces": replaces, "launches": counts[name],
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        # the variant of the reported row (flash, paged, decode, mixed)
        if "variant" in r:
            entry["variant"] = r["variant"]
        if name == "paged_attention":
            # the lse output's rows; the replicated run's launches (one a
            # layer for both replicas) and each bf16 mesh rank's
            entry["lse_rows"] = [
                {k: lse[k] for k in ("q_dtype", "lse_max_rel_err", "ms",
                                     "ms_without_lse", "max_abs_err")}
                for lse in rows["paged_attention_lse"]]
            entry["replica_launches"] = counts["paged_attention_replicas"]
            entry["sharded_launches"] = {
                "x".join(map(str, shape)): n for shape, n in
                counts["paged_attention_sharded"].items()}
        if name == "flash_attention":
            # lm_train's run: the forward and the remat recompute; the
            # meshed train step's, each rank's by mesh
            entry["lm_train_launches"] = counts_train[name]
            entry["sharded_train_launches"] = sharded[
                "flash_attention_train"]
        if name == "decode_attention":
            # the meshed decode's, each rank's by mesh; the lse output's
            # rows
            entry["sharded_decode_launches"] = sharded[
                "decode_attention_sharded"]
            entry["lse_rows"] = [
                {k: lse[k] for k in ("row", "dtype", "lse_max_rel_err",
                                     "ms", "ms_without_lse", "max_abs_err",
                                     "bits_equal_without_lse")}
                for lse in rows["decode_attention_lse"]]
        if name in ("flash_attention", "decode_attention"):
            # each new arch's prefill (flash) or decode run (decode)
            entry["arch_launches"] = counts[f"{name}_archs"]
        if name in ("flash_attention", "decode_attention", "mamba_scan",
                    "rwkv6_scan"):
            # the meshed MoE, mamba and rwkv runs': each rank's, by run
            entry["meshed_blocks_launches"] = {
                run: n[name] for run, n in sharded["meshed_blocks"].items()
                if name in n}
        if name in ("flash_attention", "decode_attention"):
            # yi-34b's runs with REPRO_SEQ_SHARD=1 and without: each
            # rank's, by run
            entry["meshed_seq_shard_launches"] = {
                run: n[name] for run, n in
                sharded["meshed_seq_shard"].items() if name in n}
        if name in ("flash_attention", "decode_attention", "mamba_scan"):
            # the Adafactor steps and minicpm3's MLA decode on (1,2):
            # each rank's, by run
            entry["meshed_a7c_launches"] = {
                run: n[name] for run, n in sharded["meshed_a7c"].items()
                if name in n}
        profiled = {"paged_attention": paged_profile,
                    "gumbel_perturb": gumbel_profile,
                    "flash_attention": flash_profile,
                    "decode_attention": decode_profile,
                    "mixed_attention": mixed_profile,
                    "rwkv6_scan": rwkv6_profile,
                    "mamba_scan": mamba_profile,
                    "fused_elementwise": fused_profile}.get(name)
        if profiled is not None:
            # as the profiler counted and timed them
            entry["device_launches_per_call"] = profiled[
                "device_launches_per_call"]
            entry["device_us_per_call"] = profiled["device_us_per_call"]
            entry["profiler_sessions"] = profiled["sessions"]
        table.append(entry)
    return table


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print(smi_line(), flush=True)
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    emit({"phase": "build", "libraries": sorted(_build.LIBRARIES),
          "seconds": time.perf_counter() - t0})
    table = run_phases(torch, "cuda")
    # the compile workers Inductor started for compiled_path
    from torch._inductor import async_compile
    async_compile.shutdown_compile_workers()
    print(smi_line(), flush=True)
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
