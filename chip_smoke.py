#!/usr/bin/env python3
"""Chip smoke test of paddle_tpu_torch on one NVIDIA GPU (written for H100).

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --phases device,build,kernels

Phases:
  1. device       — the card's name and power limit (nvidia-smi); TF32 off.
  2. build        — nvcc builds every kernel under paddle_tpu_torch/csrc/
                    (one process per source, all at once) into
                    paddle_tpu_torch/build/kernels/, with ptxas's report
                    and the flash, encoder, decode and paged libraries'
                    HGMMA (wgmma) and UTMALDG (TMA load) counts from
                    cuobjdump -sass; a spill in one of those six libraries
                    fails the phase.
  3. kernels      — each kernel, forward and backward, against its plain
                    PyTorch version at the main paths' shapes, with its
                    time, the plain version's time, a PyTorch library
                    call's time as a yardstick, and the bound; planted
                    faults of the plain version must fail the same gate.
                    The dropout kernels (fused LN, encoder attention at
                    rate 0.1) see the same seed tensor as their plain
                    versions, record their keep fraction and state the
                    bytes and Philox floors; the Philox function gives its
                    known answers on the card.  The fused conv + BN
                    kernels run at ResNet-50's four stage shapes (forward
                    with the fold, backward with and without it, and at
                    conv1's 4w -> w shapes, and at small M for 64 -> 192
                    and 192 -> 64, admitted shapes that take the two
                    passes), hold their raw per-block partials against
                    _fwd_partials_dense and _bwd_partials_dense and give
                    the same bits twice, as does every flash forward (D 64,
                    128 and 256), dq and dkv case and every encoder forward
                    (with its lse) and backward case, and every decode
                    and paged case (head dims 64, 128 and 256, page sizes
                    16, 24 and 128, lengths on split and page edges; the
                    speculative verify's S = 5 at 8 ragged offsets and
                    256-token chunks starting off the page grid, over
                    stale rows past each length; the kernels and SDPA
                    timed from CUDA-graph replays); one
                    of the seven wgmma libraries (with fused_conv_bn)
                    without HGMMA or UTMALDG fails the phase, naming it.  The
                    encoder cases include q, k, v as the three strided
                    slices of one packed [B, S, 3, H, D] tensor, fed to both
                    kernels with no copy, and time the kernels and their
                    SDPA yardsticks from CUDA-graph replays (device time).
                    Decode and paged at float32 and float16 (the
                    ``_f32`` and ``_f16`` rows, by q's type: the
                    kv_attention.cuh kernels' float32 and float16
                    instantiations on the tensor cores, float32 as
                    split-bf16 products): S = 1 and S = 5 over ragged,
                    stale slots, 256-token chunks off the page grid, pages
                    of 16 and 128, GQA 64/8, head dims 64 and 256, int8
                    caches under float32 and float16 q, and float16 q
                    against float32 pools (a float16 model's engines),
                    with a "lo plane dropped" fault among the planted ones
                    where a cache is float32 and launches counted around
                    each call.  The flash and
                    encoder forwards at float32 (the ``_f32`` and
                    ``_d256_f32`` rows: the wgmma kernels' float32
                    instantiations, split-bf16 products, the planes made
                    in shared memory): flash at generate()'s
                    [4, 1024, 32, 128], the no-cache forward's
                    [1, 2048, 32, 128] and the training shape
                    [8, 2048, 16, 128] causal, head dim 64, Sq < Sk and a
                    ragged length, and the D = 256 LLaMA's
                    [8, 2048, 8, 256] causal and a full D = 256 case; the
                    encoder at ERNIE's shape at rate 0 and 0.1, as packed
                    views, the no-cache forward's [4, 512, 32, 128] and
                    the b32_s512 microbatch causal, and each other float32
                    regime (one head resident at S = 128, D 128 and at
                    S = 256, D 64 with dropout; streamed at S = 512, D 64
                    with dropout and at S = 256, D 128 with dropout as
                    packed views), with a "lo plane dropped" fault among
                    the planted ones and launches counted around each
                    call.  float32 within F32_RTOL, float16 within
                    F16_RTOL, int8 within KERNEL_RTOL["int8"]; planted
                    faults outside; the same bits twice; SDPA as the
                    yardstick at the same dtype (at float32 with q upcast
                    where a cache is float32).
                    The encoder backward at float32 (the ``_f32`` row: the
                    wgmma kernels' float32 instantiations, split-bf16
                    products, the planes made in shared memory): ERNIE's
                    shape with dropout 0.1 (and as packed views), the
                    LLaMA b32_s512 microbatch, S = 128 causal at head dim
                    128, S = 512 at head dim 64 with dropout, and S = 256
                    at head dim 128 with dropout as packed views; within
                    F32_RTOL, a "lo plane dropped" fault among the planted
                    ones; launches counted around each call; SDPA's
                    backward as the yardstick.  The flash backward at float32 (the
                    ``_f32`` rows): the wgmma kernels' float32
                    instantiations, split-bf16 products, and their split
                    pass (``flash_attention_bwd_split``, held bit-equal to
                    _split_planes_dense) at [8, 2048, 16, 128] causal,
                    Sq < Sk, the lse cotangent, head dim 64, a ragged
                    length, and (``_d256_f32``) [8, 2048, 8, 256] causal and
                    a full Sq < Sk case, within F32_RTOL, a "lo plane
                    dropped" fault among the planted ones, each timed
                    beside its bf16 twin and SDPA's backward at float32.
                    Head dim 256 in the flash backward (the ``_d256``
                    rows): the bf16 statistics pass, dq and dkv at the
                    D = 256 LLaMA's [8, 2048, 8, 256] causal, a full
                    Sq < Sk case and a ragged one with the lse cotangent;
                    the fused LN at float16 (the ``_f16`` rows) at ERNIE's
                    shape at rate 0 and 0.1 and at h 4096, within
                    F16_LN_RTOL.  The flash forward, statistics pass, dq
                    and dkv at float16 (the ``_f16`` rows): the wgmma
                    kernels' float16 instantiations at head dims 64, 128
                    and 256, at the shapes and seeds of the CUDA-core
                    float16 cases they replace, within F16_RTOL, each timed
                    beside its bf16 twin of the same shape and SDPA at
                    float16.  The encoder forward and backward at float16
                    (the ``_f16`` rows): the wgmma kernels' float16
                    instantiations at ERNIE's shape at rate 0 and 0.1 and
                    as BERT's packed views, the LLaMA no-cache forward's
                    [4, 512, 32, 128] causal, the b32_s512 microbatch,
                    S = 128 causal at head dim 128 and [8, 512, 12, 64]
                    with dropout, within F16_RTOL with their planted
                    faults, each beside its bf16 twin (run here where the
                    bf16 rows lack the shape) and SDPA at float16.  The
                    build phase logs HGMMA per instantiation of the flash
                    and encoder libraries, and the kernels phase fails
                    where one (the float32 backward kernels included) has
                    none or float16 has another count than bf16.
  4. generate     — model.generate() at LLaMA-2-7B widths (16 layers, bf16,
                    random weights from a seed): ids [4, 1024] (flash
                    prefill) on a bf16 and an int8 cache, and ids [8, 256]
                    (encoder prefill), 32 new tokens each, every decode
                    step through the static decode kernel.
  5. dense_engine — the dense LLMEngine on the same model: 12 requests
                    with prompts in the buckets 64, 128, 256 and 2048,
                    then 4 on an int8 cache at decode_chunk=4.
  6. paged_engine — the paged LLMEngine on the same model: 12 requests,
                    then 4 on an int8 pool.
In phases 4-6 and 8-17 the launch counters are zeroed just before each run
and must match the work the run did.  For the greedy outputs, each path's logits
(teacher-forced) must stay within LOGIT_TOL (INT8_LOGIT_TOL on an int8
cache) of the no-cache forward's with dense-math attention, and each token
must be the forward's argmax but at near-ties.  Each engine phase ends with
a few decode ticks of 8 busy slots under torch.profiler: where a tick's
time goes.
Every engine tick, verify and prefill and generate()'s decode steps run
as replayed CUDA graphs (paddle_tpu_torch/jit/graphs.py); each replay
adds its kernels' launches to their counters.
  7. ticks        — both engines' decode ticks, 8 busy slots, in turns
                    (dense, paged, paged, dense), unprofiled.
  8. prefix       — the paged engine with its default prefix cache on the
                    same model: a 1,000-token system prompt, then 16
                    requests on it (tails of 64-300 tokens) in two waves of
                    8, each hitting 1,000 tokens off the page grid; the
                    same traffic with prefix_cache=False; 4 requests on an
                    int8 pool; a 9-page pool where a prefill takes a cached
                    page back (steal-back) and an admission evicts.  Page
                    refcounts must equal their holders after every tick
                    and the pool drain to the cached pages.
  9. spec         — spec_k=4 with the n-gram drafter: the paged engine on 8
                    extractive requests and 4 random ones, each against
                    spec_k=0 on the same traffic; the dense engine on a
                    bf16 and an int8 cache; generate(spec_k=4) on ids
                    [4, 512]; a verify tick and a decode tick of 8 busy
                    slots under torch.profiler.  Launches equal the
                    chunks, ticks and verify calls times the layers.
 10. tenants      — multi-tenant serving on the same model through the
                    paged engine: an AdapterRegistry on all 7 LLaMA sites,
                    4 random adapters of rank 16 in a pool of 3 usable
                    pages (admissions wait for a page, LRU eviction runs);
                    12 requests mixing the base model, the adapters, a
                    phone-number regex and a JSON schema over a
                    deterministic 32,000-entry vocabulary (``</s>`` the
                    eos).  Adapter and page refcounts balance after every
                    tick; every constrained output is accepted by its
                    automaton and ends in eos (the regex matches, the JSON
                    parses with the schema's keys); every second request's
                    logits (the paged path, teacher-forced, under its
                    adapter's page) lie within LOGIT_TOL of the dense-math
                    forward's and its tokens equal solo
                    generate(adapter_id=, adapters=, token_mask_fn=)'s up
                    to a divergence at a near-tie; the LoRA epilogue alone
                    against float32 x.A.(scale B) within LORA_RTOL.  Then
                    decode ticks of 8 busy slots on 3 adapters against the
                    base model (the epilogue's device share) and
                    constrained against unconstrained (wall).
 11. tiers        — the host and disk kv tiers on the same model: the
                    1,000-token system prompt served, every cached page
                    demoted (demote_step(force=True)) and evicted from HBM,
                    then a request on it that can only hit by promotion,
                    from the host tier and (2 host pages, the rest spilled
                    to files in a temporary directory the phase removes)
                    from disk, at bf16 and on int8 caches.  Promoted pages
                    equal the demoted ones byte for byte; the tokens equal
                    a tier-less run's; prefill restarts at the first
                    uncached token; refcounts and the tiers balance after
                    every tick; on disk at bf16 a corrupted spill is
                    quarantined and the request re-prefills from the block
                    before it, its logits within LOGIT_TOL.  Demotion and
                    promotion ms a page and GB/s; TTFT with a promotion hit
                    against a full re-prefill.
 12. graphs       — every engine program and generate()'s decode step as
                    CUDA graphs (paddle_tpu_torch/jit/graphs.py) against
                    the same traffic run eagerly under disable_graphs(), in
                    turns eager, graph, graph, eager, each turn a fresh
                    engine with the same generator seed: the dense engine
                    (6 requests, greedy and sampled rows, bf16; int8 at
                    decode_chunk=4; spec_k=4), the paged engine (bf16;
                    int8; spec_k=4 over the prefix cache; the tenants
                    traffic: 4 adapters in a 3-page pool, regex and JSON
                    constraints; a host-tier promotion hit of the
                    1,000-token system prompt), and generate() (ids
                    [4, 1024] on bf16 and int8 caches, [8, 256] sampled,
                    [4, 512] paged and sampled).  Every turn's tokens must
                    equal the first eager turn's bit for bit; launches
                    equal the work; the graph turns stage and replay under
                    torch.cuda.set_sync_debug_mode("error") (check_syncs())
                    and capture after warmup() only what the reference
                    compiles lazily (another effective decode chunk, the
                    dense full-length bucket), no key twice.  Logs each
                    turn's prefill ms a chunk, TTFT, decode tok/s, capture
                    seconds and graph pool bytes; then decode ticks of 8
                    busy slots eager and on graphs (dense, paged, paged on
                    3 adapters): wall, device time, kernels, busy share.
 13. gpt          — GPTConfig() (hidden 768, 12 layers of 12 heads of 64,
                    vocab 50,304, bf16, random weights from seed 0):
                    generate() on ids [8, 256], the dense engine, and the
                    paged engine with the prefix cache and spec_k=4.
 14. dtypes       — LLaMA-2-7B widths (16 layers, random weights) at
                    float32, the config's default: generate() with ids
                    [4, 1024] on a float32 and an int8 static cache, the
                    dense engine's 12 requests, the paged engine's 12 and
                    then 4 on an int8 pool, the no-cache forward at
                    [1, 2048] (flash) and [4, 512] (the encoder) against
                    dense math, a profiled paged decode tick; at float16:
                    generate() on its float16 cache, the paged engine's
                    12 requests (float32 pools, as for every model that is
                    not bf16) and the no-cache forwards at [1, 2048] and
                    [4, 512] (their walls beside the dense-math forward's);
                    BERT-base eval on [32, 128] at float32 and at float16
                    (the fused-LN kernels at float16).  Every attention
                    launch (decode, paged, generate()'s prefill, the
                    forwards, BERT's eval) runs the tensor-core kernels,
                    float32 as split-bf16 products; logits within
                    F32_LOGIT_TOL (F16_LOGIT_TOL, INT8_LOGIT_TOL); peak
                    memory per model.
 15. train        — bench.py's training configuration (hidden 2048, 12
                    layers, bf16, random weights and tokens from seed 0)
                    through TrainStep + AdamW(3e-4, weight_decay=0.01):
                    first every parameter's gradient through the kernels
                    against dense-math attention at 2 layers (S 2048 runs
                    flash, S 512 the encoder kernels); then B 8 x S 2048,
                    3 warm-up and 10 timed steps on one batch (flash
                    forward, dq and dkv 12 launches a step), one of them
                    profiled; then B 32 x S 512 at accum_steps=2 with
                    ClipGradByGlobalNorm(1.0) (encoder forward and backward
                    24 a step).  Each loss finite, the last below the first.
                    Then the same at float32, the config's default (the
                    flash and encoder kernels, forward and backward, on
                    the tensor cores as split-bf16 products, the flash
                    split pass 12 launches a step):
                    parity at 2 layers within F32_GRAD_RTOL, B 8 x S 2048
                    and B 32 x S 512 at F32_TRAIN_STEPS timed steps (the
                    cut: over a second a step), each with one step
                    profiled; and the parity at float16 within F16_GRAD_RTOL
                    (float16 training needs f32 master weights, O1
                    auto_cast, not ported: a pure float16 AdamW step is
                    inf once (1 - beta2) g^2 underflows).
                    Then all of it at 8 heads of 256 (Gemma-2B's attention
                    layout at the same widths) through the D = 256
                    backward kernels, but for the S 512 runs (the
                    reference takes dense math there at D = 256): parity
                    at S 2048 in bf16, float32 and float16, B 8 x S 2048 in
                    bf16 and float32, the statistics pass, dq and dkv 12
                    launches a step each.
 16. ernie        — bench.py's ERNIE-base pretraining (BertConfig.base(),
                    bf16, B 512 x S 128, 20 masked positions, dropout 0.1,
                    random weights and batch from seed 0): gradient parity
                    of every parameter against the composed/dense paths at
                    2 layers and rate 0; the same loss from the same seed();
                    the eval forward's MLM logits at 12 layers against the
                    composed forward's; then TrainStep + AdamW(1e-4,
                    weight_decay=0.01), 2 warm-up and 8 timed steps, fused
                    LN forward and backward 24 and encoder forward and
                    backward 12 launches a step with no copy of q, k or v,
                    one step profiled.  Then all of it at float32 (the
                    encoder forward and backward on the tensor cores as
                    split-bf16 products, the fused LN at f32;
                    ERNIE_F32_STEPS timed steps), and the gradient parity
                    at float16 through the fused-LN and tensor-core
                    encoder kernels at float16 (its launches count in the
                    kernels line: float16 training is no path yet).
 17. resnet       — bench.py's ResNet-50 training in NHWC, the layout that
                    reaches the fused 1x1-conv + BN kernels: first one
                    bottleneck block at each stage's shape, fused against
                    composed in f32 (output, every gradient, running
                    statistics); then resnet50(num_classes=1000,
                    data_format="NHWC"), bf16, batch 128 at 224 x 224,
                    Momentum(0.1, 0.9) through TrainStep, 5 warm-up and 20
                    timed steps on one batch (fused conv + BN forward 16
                    and backward 32 launches a step), one step profiled;
                    then the eval forward (no fused launch).
Then one JSON line of per-kernel results, the card line again, and last
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero before
that line.  Without CUDA, or without the repository beside this file, it
exits non-zero and prints no result.  Long results also go to
chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12        # dense bf16 tensor-core peak
# The main paths' model and the engines' traffic: LLaMA-2-7B's widths at
# half its depth (16 of 32 layers: the cut that keeps the whole script in
# half its time limit since the float32 training runs came in), 12
# requests on a bf16 cache, then 4 on an int8 cache.
LAYERS, REQUESTS, INT8_REQUESTS = 16, 12, 4
# Kernel inputs: q ~ N(0, 2.5^2), k and v ~ N(0, 1).  With the 1/sqrt(D)
# scale the scores spread by about 2.5, so the softmax is far from uniform
# and a row's last visible key often carries much of its weight.
Q_STD = 2.5
# Kernel vs plain, by pool: max |kernel - plain| over max |plain|, per
# case.  The kernel writes bf16 (<= 2^-9 of |out| per element) and rounds
# each probability to bf16 before P.V as the reference kernel does; the
# plain version runs in f32 on the same bf16/int8 values.  Sound runs on an
# H100 gave at most 2.9e-3 (bf16) and 4.5e-3 (int8); the planted faults
# below come out at 0.29 or more.
KERNEL_RTOL = {"bf16": 5e-3, "int8": 1e-2}
# Flash's logsumexp output, absolute (values ~10 here): f32 sums of the
# same bf16 products in another order differ by about 1e-5.
LSE_TOL = 1e-3
# kernel -> (its source, the TPU kernel it replaces, None for a helper)
KERNELS = {
    "paged_attention": ("paddle_tpu_torch/csrc/paged_attention.cu",
                        "paddle_tpu/ops/decode_attention.py:313"),
    "decode_attention": ("paddle_tpu_torch/csrc/decode_attention.cu",
                         "paddle_tpu/ops/decode_attention.py:66"),
    "flash_attention": ("paddle_tpu_torch/csrc/flash_attention.cu",
                        "paddle_tpu/ops/flash_attention.py:45"),
    "encoder_attention": ("paddle_tpu_torch/csrc/encoder_attention.cu",
                          "paddle_tpu/ops/encoder_attention.py:78"),
    "flash_attention_dq": ("paddle_tpu_torch/csrc/flash_attention_bwd.cu",
                           "paddle_tpu/ops/flash_attention.py:111"),
    "flash_attention_dkv": ("paddle_tpu_torch/csrc/flash_attention_bwd.cu",
                            "paddle_tpu/ops/flash_attention.py:153"),
    "encoder_attention_bwd": ("paddle_tpu_torch/csrc/encoder_attention_bwd.cu",
                              "paddle_tpu/ops/encoder_attention.py:101"),
    "fused_ln": ("paddle_tpu_torch/csrc/fused_ln.cu", "paddle_tpu/ops/fused_ln.py:55"),
    "fused_ln_bwd": ("paddle_tpu_torch/csrc/fused_ln.cu", "paddle_tpu/ops/fused_ln.py:77"),
    "fused_conv_bn": ("paddle_tpu_torch/csrc/fused_conv_bn.cu",
                      "paddle_tpu/ops/fused_conv_bn.py:66"),
    "fused_conv_bn_bwd": ("paddle_tpu_torch/csrc/fused_conv_bn.cu",
                          "paddle_tpu/ops/fused_conv_bn.py:139"),
    # decode and paged at float32 and float16 q: the kernels' float32 and
    # float16 instantiations (float32 as split-bf16 products), their
    # launches the wrappers' in the main paths' float32 and float16 runs
    # (INSTANTIATIONS); float16's paged row leads with float16 q on float32
    # pools, what a float16 model's engines run
    "paged_attention_f32": ("paddle_tpu_torch/csrc/paged_attention.cu",
                            "paddle_tpu/ops/decode_attention.py:313"),
    "paged_attention_f16": ("paddle_tpu_torch/csrc/paged_attention.cu",
                            "paddle_tpu/ops/decode_attention.py:313"),
    "decode_attention_f32": ("paddle_tpu_torch/csrc/decode_attention.cu",
                             "paddle_tpu/ops/decode_attention.py:66"),
    "decode_attention_f16": ("paddle_tpu_torch/csrc/decode_attention.cu",
                             "paddle_tpu/ops/decode_attention.py:66"),
    # the flash and encoder forwards at float32: the wgmma kernels' float32
    # instantiations, split-bf16 products, the planes made in shared memory;
    # their launches the wrappers' in the main paths' float32 runs
    # (INSTANTIATIONS), flash at head dim 256 in the _d256_f32 row
    "flash_attention_f32": ("paddle_tpu_torch/csrc/flash_attention.cu",
                            "paddle_tpu/ops/flash_attention.py:45"),
    "flash_attention_d256_f32": ("paddle_tpu_torch/csrc/flash_attention.cu",
                                 "paddle_tpu/ops/flash_attention.py:45"),
    "encoder_attention_f32": ("paddle_tpu_torch/csrc/encoder_attention.cu",
                              "paddle_tpu/ops/encoder_attention.py:78"),
    # the encoder backward at float32: the wgmma kernels' float32
    # instantiations, split-bf16 products, the planes made in shared memory;
    # its launches the wrapper's in the main paths' float32 runs
    "encoder_attention_bwd_f32": ("paddle_tpu_torch/csrc/encoder_attention_bwd.cu",
                                  "paddle_tpu/ops/encoder_attention.py:101"),
    # the flash backward at float32: the wgmma kernels' float32
    # instantiations, split-bf16 products; their launches the wrappers' in
    # the main paths' float32 runs (INSTANTIATIONS), at every head dim, and
    # at head dim 256 in the _d256_f32 rows.  The split pass makes both
    # kernels' operand planes (float32 only): a helper of :111 and :153
    # that ports no TPU kernel, since only the tensor cores need 16-bit
    # operands, so it replaces none (null in the kernels line)
    "flash_attention_bwd_stats_f32": ("paddle_tpu_torch/csrc/flash_attention_bwd.cu",
                                      "paddle_tpu/ops/flash_attention.py:111"),
    "flash_attention_bwd_split": ("paddle_tpu_torch/csrc/flash_attention_bwd.cu", None),
    "flash_attention_dq_f32": ("paddle_tpu_torch/csrc/flash_attention_bwd.cu",
                               "paddle_tpu/ops/flash_attention.py:111"),
    "flash_attention_dkv_f32": ("paddle_tpu_torch/csrc/flash_attention_bwd.cu",
                                "paddle_tpu/ops/flash_attention.py:153"),
    # the bf16 backward's statistics pass, the dsum each flash TPU kernel
    # takes first
    "flash_attention_bwd_stats": ("paddle_tpu_torch/csrc/flash_attention_bwd.cu",
                                  "paddle_tpu/ops/flash_attention.py:111"),
    # the flash backward's head dim 256 instantiations (every type on
    # wgmma): one counter a wrapper, so their launches are the wrappers' in
    # the main paths' runs at head dim 256 (INSTANTIATIONS), every type in
    # the _d256 rows, float32 alone in the _d256_f32 ones
    "flash_attention_bwd_stats_d256": ("paddle_tpu_torch/csrc/flash_attention_bwd.cu",
                                       "paddle_tpu/ops/flash_attention.py:111"),
    "flash_attention_dq_d256": ("paddle_tpu_torch/csrc/flash_attention_bwd.cu",
                                "paddle_tpu/ops/flash_attention.py:111"),
    "flash_attention_dkv_d256": ("paddle_tpu_torch/csrc/flash_attention_bwd.cu",
                                 "paddle_tpu/ops/flash_attention.py:153"),
    "flash_attention_bwd_stats_d256_f32": ("paddle_tpu_torch/csrc/flash_attention_bwd.cu",
                                           "paddle_tpu/ops/flash_attention.py:111"),
    "flash_attention_dq_d256_f32": ("paddle_tpu_torch/csrc/flash_attention_bwd.cu",
                                    "paddle_tpu/ops/flash_attention.py:111"),
    "flash_attention_dkv_d256_f32": ("paddle_tpu_torch/csrc/flash_attention_bwd.cu",
                                     "paddle_tpu/ops/flash_attention.py:153"),
    # the fused LN at float16, its launches the wrappers' in the main paths'
    # float16 runs
    "fused_ln_f16": ("paddle_tpu_torch/csrc/fused_ln.cu", "paddle_tpu/ops/fused_ln.py:55"),
    "fused_ln_bwd_f16": ("paddle_tpu_torch/csrc/fused_ln.cu", "paddle_tpu/ops/fused_ln.py:77"),
    # the flash forward and backward at float16: the bf16 kernels' wgmma
    # design and wrappers, instantiated at __half; their launches the
    # wrappers' in the main paths' float16 runs, their cases at D 64, 128
    # and 256
    "flash_attention_f16": ("paddle_tpu_torch/csrc/flash_attention.cu",
                            "paddle_tpu/ops/flash_attention.py:45"),
    "flash_attention_bwd_stats_f16": ("paddle_tpu_torch/csrc/flash_attention_bwd.cu",
                                      "paddle_tpu/ops/flash_attention.py:111"),
    "flash_attention_dq_f16": ("paddle_tpu_torch/csrc/flash_attention_bwd.cu",
                               "paddle_tpu/ops/flash_attention.py:111"),
    "flash_attention_dkv_f16": ("paddle_tpu_torch/csrc/flash_attention_bwd.cu",
                                "paddle_tpu/ops/flash_attention.py:153"),
    # the encoder forward and backward at float16: the bf16 kernels' wgmma
    # design and wrappers, instantiated at __half; their launches the
    # wrappers' in the main paths' float16 runs (BERT's float16 eval, the
    # float16 no-cache forward at [4, 512]; the backward in ERNIE's float16
    # gradient parity)
    "encoder_attention_f16": ("paddle_tpu_torch/csrc/encoder_attention.cu",
                              "paddle_tpu/ops/encoder_attention.py:78"),
    "encoder_attention_bwd_f16": ("paddle_tpu_torch/csrc/encoder_attention_bwd.cu",
                                  "paddle_tpu/ops/encoder_attention.py:101"),
}
# A run's field and value -> the suffix of the KERNELS rows of that
# instantiation: every launch in a run at head dim 256 (or at float16, or
# float32) is that instantiation's, since a model has one head dim and one
# dtype; a run that matches two counts in their joined suffix too
# ("_d256_f32").
INSTANTIATIONS = {("D", 256): "_d256", ("dtype", "f16"): "_f16", ("dtype", "f32"): "_f32"}
# Backward kernels vs their plain versions: max |kernel - plain| over max
# |plain|, for each of dQ, dK and dV, with dO ~ N(0, 1).  The kernels round
# dS (and, for flash's dV, P) to bf16 where the reference does and write
# bf16; the plain version runs in f32 on the same bf16 values.  Sound runs
# on an H100 gave at most 4.6e-3; the planted faults below come out at
# 0.157 or more (dlse ignored is the closest).
BWD_RTOL = 1e-2
# Logit drift: max |paged-path logit - no-cache-forward logit| over every
# generated position of the greedy requests (both bf16 through the layers,
# rounding in different orders).  Logits here are ~N(0, 0.5); sound runs on
# an H100 drift by at most 0.041.
LOGIT_TOL = 0.1
# The same drift with an int8 kv cache, against the same bf16 forward: the
# cache rounds every K and V element to its row's absmax / 127, on top of
# the bf16 differences above.
INT8_LOGIT_TOL = 0.5
# The same drift of the dtypes phase's float32 model (both sides f32: the
# kernels and cuBLAS sum in other orders, nothing rounds to 16 bits) and
# float16 model (float16 rounds like bf16 with three more mantissa bits).
F32_LOGIT_TOL = 5e-3
F16_LOGIT_TOL = 0.05


# The fused LN at float16 vs its plain version, forward and backward: both
# compute in f32 from the same float16 values and round each [n, h] output
# once to float16 (2^-11 of a value); a sum taken in another order can put
# a value on the other side of a rounding boundary, one unit, at most
# 2^-10 of max |plain|.  Two units.
F16_LN_RTOL = 2e-3


# Dropout: ERNIE's rate on hidden states and attention probabilities.  Each
# dropout case's keep fraction must lie within KEEP_SIGMAS binomial
# standard deviations of 1 - rate.
DROP_RATE = 0.1
KEEP_SIGMAS = 5.0
# Philox's floor: 40 32-bit multiplies a call (10 rounds of 2 mul.lo and
# 2 mul.hi) over the card's integer multiply rate, 64 INT32 lanes a SM (half
# its 128 FP32 lanes) x 132 SMs x 1.98 GHz, the clock of the 67 TFLOP/s f32
# peak.  Elementwise f32 work counts against that f32 peak.
H100_INT32_OPS = 16.7e12
H100_F32_FLOPS = 67e12
PHILOX_MULS = 40
# Philox4x32-10 known answers (Random123): (counter, key) -> words.
PHILOX_KAT = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
              ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
               (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
              ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
               (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]


def log(*a):
    print(*a, flush=True)


def card_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except Exception as e:  # noqa: BLE001 - reported, not fatal
        return f"nvidia-smi unavailable: {e!r}"


def cuda_ms(fn, iters):
    """Mean ms of fn() over `iters` launches, CUDA events, after warmup."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(fn, iters=20, repeats=5, per_graph=10, stream=None):
    """Device ms of one fn() from CUDA-graph replays: ``per_graph`` calls
    captured in one graph (on ``stream``, where fn's autograd graph lives),
    the graph replayed ``iters`` times between CUDA events, the least of
    ``repeats`` such windows.  The host's launch and autograd cost stays
    out, so a small call reads the card, not the host."""
    s = stream or torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=s):
        for _ in range(per_graph):
            fn()
    g.replay()
    torch.cuda.synchronize()
    best = math.inf
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(repeats):
        a.record()
        for _ in range(iters):
            g.replay()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b) / (iters * per_graph))
    del g
    torch.cuda.synchronize()
    return best


# ---------------------------------------------------------------- kernels

def paged_case(name, B, S, H, Hkv, offsets, quant, seed, ps=128, D=128, pages=None,
               stale=False):
    """One kernel-vs-plain case.  ``pages`` narrows the page table below what
    the longest row would need, as when a chunk's padded rows run past a
    pool of max_seq_len: keys past the table are never visited.  ``stale``
    poisons (1e4) the rows of each slot's own pages past its length, as a
    rolled-back verify leaves them: the kernel must mask by length."""
    from paddle_tpu_torch.models.kv_cache import _quantize_kv
    from paddle_tpu_torch.ops import decode_attention as da

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    M = pages or max(-(-(o + S) // ps) for o in offsets)
    P = 1 + B * M
    q = (torch.randn(B, S, H, D, generator=g, device=dev) * Q_STD).bfloat16()
    kp = torch.randn(P, Hkv, ps, D, generator=g, device=dev).bfloat16()
    vp = torch.randn(P, Hkv, ps, D, generator=g, device=dev).bfloat16()
    kp[0], vp[0] = 1e4, 1e4           # the trash page: a read of it shows
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(seed)) + 1
    tbl = torch.zeros(B, M, dtype=torch.int32)
    it = iter(perm.tolist())
    for b, o in enumerate(offsets):
        for j in range(min(M, -(-(o + S) // ps))):
            tbl[b, j] = next(it)
    if stale:
        for b, o in enumerate(offsets):
            for j in range(min(M, -(-(o + S) // ps))):
                r0 = max(0, o + S - j * ps)
                page = int(tbl[b, j])
                kp[page, :, r0:], vp[page, :, r0:] = 1e4, 1e4
    tbl = tbl.to(dev)
    off = torch.tensor(offsets, dtype=torch.int64, device=dev)
    lengths = (off + S).to(torch.int32)
    if quant:
        kq, ks = _quantize_kv(kp.float())
        vq, vs = _quantize_kv(vp.float())
        kp, vp, scales = kq.contiguous(), vq.contiguous(), (ks.contiguous(), vs.contiguous())
    else:
        scales = (None, None)
    scale = 1.0 / D ** 0.5

    def kernel():
        return da.paged_attention_kernel(q, kp, vp, lengths, tbl, *scales, scale)

    def plain():
        return da._paged_dense(q, kp, vp, off, tbl, *scales, scale)

    got = kernel()
    same_bits = bool(torch.equal(got, kernel()))  # split order, not arrival order
    torch.cuda.synchronize()
    # the oracle: the plain version in f32 on the same values
    f32 = [None if s is None else s.float() for s in scales]
    k32, v32 = (kp, vp) if quant else (kp.float(), vp.float())

    def oracle(qq, offsets_):
        return da._paged_dense(qq, k32, v32, offsets_, tbl, *f32, scale)

    want = oracle(q.float(), off)
    top = want.abs().max().item()
    err = (got.float() - want).abs().max().item()
    # planted faults: variants of the plain version that the gate must
    # reject, so that it is known to be tight enough to catch a wrong kernel
    faults = {"uniform_weights": oracle(torch.zeros_like(want), off),  # Q.K ignored
              "causal_end_short": oracle(q.float(), off - 1)}        # last key dropped
    fault_rel = {k: (f - want).abs().max().item() / top for k, f in faults.items()}
    tol = KERNEL_RTOL["int8" if quant else "bf16"]
    finite = bool(torch.isfinite(got).all())
    iters = 50 if S == 1 else 20
    # device time from CUDA-graph replays; eager_ms (events around
    # back-to-back calls) also holds the wrapper's host cost
    ms, eager_ms = graph_ms(kernel), cuda_ms(kernel, iters)
    plain_ms = cuda_ms(plain, max(5, iters // 5))
    # yardstick: one SDPA call on the gathered (dequantized, GQA-expanded)
    # pages with a per-slot causal mask; timed here, never used by the port
    used = tbl[:, :M]
    kg, vg = da.gather_pages(kp, used), da.gather_pages(vp, used)
    if quant:
        kg = kg.bfloat16() * da.gather_pages(scales[0], used).bfloat16()[..., None]
        vg = vg.bfloat16() * da.gather_pages(scales[1], used).bfloat16()[..., None]
    rep = H // Hkv
    kg, vg = kg.repeat_interleave(rep, 1), vg.repeat_interleave(rep, 1)
    kpos = torch.arange(M * ps, device=dev)
    mask = kpos[None, None, None, :] <= (off[:, None, None, None]
                                         + torch.arange(S, device=dev)[None, None, :, None])
    qh = q.transpose(1, 2)
    library_ms = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kg, vg, attn_mask=mask))
    # least time: bytes (q + out once, the K/V rows of the keys each kv head
    # must see, scales, table, lengths) and operations (QK and PV: 4 * D per
    # visible (query row, key) pair)
    visible = sum(max(0, min(o + s + 1, M * ps)) for o in offsets for s in range(S))
    keys = sum(min(o + S, M * ps) for o in offsets)
    elem = 1 if quant else 2
    nbytes = (2 * q.numel() * 2 + keys * Hkv * D * elem * 2
              + (keys * Hkv * 4 * 2 if quant else 0) + tbl.numel() * 4 + B * 4)
    flops = 4.0 * D * H * visible
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_BF16_FLOPS * 1e3
    return dict(name=name, B=B, S=S, H=H, Hkv=Hkv, ps=ps, D=D,
                pool="int8" if quant else "bf16", max_len=max(offsets) + S, pages=M,
                max_abs_err=err, max_abs_want=top, rel_err=err / top,
                fault_rel=fault_rel, finite=finite, same_bits=same_bits,
                tol=tol, ok=(finite and same_bits and err / top <= tol
                             and min(fault_rel.values()) > tol),
                ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops)


def bound(nbytes, flops):
    """(bound ms, what bounds it): the larger of the bytes over the HBM rate
    and the operations over the bf16 tensor-core rate."""
    return bound3(nbytes, tc_flops=flops)[:2]


def gate(name, got, want, faults, tol, **extra):
    """Common verdict of a kernel case: relative error to max |want| within
    ``tol``, every planted fault (a wrong variant of the plain version)
    outside it, and finite output."""
    top = want.abs().max().item()
    err = (got.float() - want).abs().max().item()
    fault_rel = {k: (f - want).abs().max().item() / top for k, f in faults.items()}
    finite = bool(torch.isfinite(got).all())
    ok = (finite and err / top <= tol and min(fault_rel.values()) > tol
          and extra.pop("ok", True))
    return dict(name=name, max_abs_err=err, max_abs_want=top, rel_err=err / top,
                fault_rel=fault_rel, finite=finite, tol=tol, ok=ok, **extra)


def randn(g, shape, std=1.0, dtype=torch.bfloat16):
    return (torch.randn(*shape, generator=g, device="cuda") * std).to(dtype)


def decode_case(name, B, H, Hkv, offsets, quant, seed, L=2048, D=128, S=1):
    """Static decode kernel vs its plain version: S query rows a slot (1 for
    a decode step, K + 1 for a speculative verify) against a head-major
    [B, Hkv, L, D] cache whose rows past each slot's valid length
    (offset + S) are poisoned (1e4), so a read past the length shows: the
    stale rows a rolled-back verify leaves behind."""
    from paddle_tpu_torch.models.kv_cache import _quantize_kv
    from paddle_tpu_torch.ops import decode_attention as da

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = randn(g, (B, S, H, D), Q_STD)
    k, v = randn(g, (B, Hkv, L, D)), randn(g, (B, Hkv, L, D))
    off = torch.tensor(offsets, dtype=torch.int64, device="cuda")
    for b, o in enumerate(offsets):
        k[b, :, o + S:], v[b, :, o + S:] = 1e4, 1e4
    if quant:
        (k, ks), (v, vs) = _quantize_kv(k), _quantize_kv(v)
        scales = (ks.contiguous(), vs.contiguous())
    else:
        scales = (None, None)
    lengths = (off + S).to(torch.int32)
    scale = 1.0 / D ** 0.5

    def kernel():
        return da.decode_attention_kernel(q, k, v, lengths, *scales, scale)

    def plain():
        return da._decode_dense(q, k, v, off, *scales, scale)

    got = kernel()
    same_bits = bool(torch.equal(got, kernel()))  # split order, not arrival order
    torch.cuda.synchronize()
    f32 = [None if x is None else x.float() for x in scales]
    k32, v32 = (k, v) if quant else (k.float(), v.float())

    def oracle(qq, o):
        return da._decode_dense(qq, k32, v32, o, *f32, scale)

    want = oracle(q.float(), off)
    res = gate(name, got, want, {"uniform_weights": oracle(torch.zeros_like(q.float()), off),
                                 "causal_end_short": oracle(q.float(), off - 1)},
               KERNEL_RTOL["int8" if quant else "bf16"], B=B, S=S, H=H, Hkv=Hkv, L=L,
               D=D, cache="int8" if quant else "bf16", max_len=max(offsets) + S,
               same_bits=same_bits, ok=same_bits)
    res["ms"], res["eager_ms"] = graph_ms(kernel), cuda_ms(kernel, 50)  # as paged_case
    res["plain_ms"] = cuda_ms(plain, 10)
    # yardstick: SDPA on the dequantized, GQA-expanded cache with a length
    # mask; timed here, never used by the port
    kd, vd = (k.bfloat16() * scales[0].bfloat16()[..., None],
              v.bfloat16() * scales[1].bfloat16()[..., None]) if quant else (k, v)
    kd, vd = kd.repeat_interleave(H // Hkv, 1), vd.repeat_interleave(H // Hkv, 1)
    mask = torch.arange(L, device="cuda")[None, None, None, :] <= (
        off[:, None, None, None] + torch.arange(S, device="cuda")[None, None, :, None])
    qh = q.transpose(1, 2)
    res["library_ms"] = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kd, vd, attn_mask=mask))
    # least time: q and out once, the valid K/V rows (and scales) once,
    # lengths; QK and PV over each (query row, visible key) pair
    keys = sum(o + S for o in offsets)
    visible = sum(o + s + 1 for o in offsets for s in range(S))
    nbytes = (2 * q.numel() * 2 + keys * Hkv * D * (1 if quant else 2) * 2
              + (keys * Hkv * 4 * 2 if quant else 0) + B * 4)
    res["bound_ms"], res["bound_by"] = bound(nbytes, 4.0 * D * H * visible)
    return res


def visible_pairs(Sq, Sk, causal):
    """Query-key pairs a (bottom-right) causal or full attention computes."""
    if not causal:
        return Sq * Sk
    off = Sk - Sq
    return sum(min(Sk, i + off + 1) for i in range(Sq))


def masked_attention(q, k, v, vis, scale):
    """Dense attention in f32 over an explicit [Sq, Sk] visibility mask;
    the planted faults are built from it."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = torch.where(vis, s, torch.full_like(s, -1e30))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v.float())


def seq_attention_case(name, kind, B, H, Sq, Sk, D, causal, seed, dtype=torch.bfloat16):
    """Flash or encoder kernel vs its plain version on q, k, v
    [B, S, H, D] of ``dtype`` (bf16 within KERNEL_RTOL; flash also at
    float16, within F16_RTOL); planted faults are uniform weights and each
    row's key range one short (its causal end, or the last key when not
    causal)."""
    from paddle_tpu_torch.ops import encoder_attention as ea
    from paddle_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = randn(g, (B, Sq, H, D), Q_STD, dtype)
    k, v = randn(g, (B, Sk, H, D), dtype=dtype), randn(g, (B, Sk, H, D), dtype=dtype)
    scale = 1.0 / D ** 0.5
    if kind == "flash":
        def kernel():
            return fa.flash_attention_kernel(q, k, v, causal, scale)

        def plain():
            return fa._flash_dense(q, k, v, causal, scale)
    else:
        def kernel():
            return ea.encoder_attention_kernel(q, k, v, scale, causal)

        def plain():
            return ea._encoder_dense(q, k, v, scale, causal)

    got = kernel()
    torch.cuda.synchronize()
    ones = torch.ones(Sq, Sk, dtype=torch.bool, device="cuda")
    if causal:
        short = ones.tril(Sk - Sq - 1)
    else:
        short = ones.clone()
        short[:, -1] = False
    faults = {"uniform_weights": masked_attention(torch.zeros_like(q), k, v, ones, scale),
              "causal_end_short": masked_attention(q, k, v, short, scale)}
    got, lse = got
    again = kernel()  # the same bits on a second run
    same = bool(torch.equal(got, again[0]) and torch.equal(lse, again[1]))
    if kind == "flash":
        want, want_lse = fa._flash_dense(q.float(), k.float(), v.float(), causal, scale)
    else:
        want = ea._encoder_dense(q.float(), k.float(), v.float(), scale, causal)
        want_lse = ea._encoder_lse(q.float(), k.float(), scale, causal)
    lse_err = (lse.reshape(B, H, Sq) - want_lse.reshape(B, H, Sq)).abs().max().item()
    extra = dict(lse_max_abs_err=lse_err, lse_tol=LSE_TOL, same_bits=same,
                 ok=lse_err <= LSE_TOL and same and got.dtype == dtype)
    tol = KERNEL_RTOL["bf16"] if dtype == torch.bfloat16 else F16_RTOL
    res = gate(name, got, want, faults, tol, kind=kind, B=B, H=H, Sq=Sq, Sk=Sk, D=D,
               causal=causal, dtype=TAGS[dtype], **extra)
    iters = 20
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)

    if kind == "flash":
        res["ms"] = cuda_ms(kernel, iters)
    else:  # the kernel and its yardstick both from graph replays (device time)
        res["ms"] = graph_ms(kernel)
    res["plain_ms"] = cuda_ms(plain, 5)
    # yardstick: SDPA where it computes the same function (its is_causal is
    # top-left aligned, so causal only at Sq == Sk); timed, never used
    res["library_ms"] = None
    if Sq == Sk or not causal:
        res["library_ms"] = cuda_ms(sdpa, iters) if kind == "flash" else graph_ms(sdpa)
    nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel()) + (B * H * Sq * 4 if kind == "flash" else 0)
    res["bound_ms"], res["bound_by"] = bound(nbytes, 4.0 * D * B * H * visible_pairs(Sq, Sk, causal))
    return res


def masked_attention_bwd(q, k, v, do, vis, scale, dlse=None, dsum_zero=False):
    """Dense attention backward in f32 over an explicit [Sq, Sk] visibility
    mask, written from the math (P = softmax(S), O = P V, dsum = rowsum(dO
    O) - dlse); the planted faults are built from it.  Returns (dq, dk,
    dv) in f32."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.softmax(torch.where(vis, s, torch.full_like(s, -1e30)), -1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    dsum = torch.einsum("bqhd,bqhd->bhq", dof, o)
    if dlse is not None:
        dsum = dsum - dlse
    if dsum_zero:
        dsum = torch.zeros_like(dsum)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - dsum[..., None])
    return (torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale,
            torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale,
            torch.einsum("bhqk,bqhd->bkhd", p, dof))


def bwd_gate(name, gots, wants, faults, tol, **extra):
    """Verdict on a set of outputs (the gradients dq, dk, dv or a subset;
    y, s1 and s2 of a forward): each within ``tol`` of max |its plain|,
    and every planted fault outside it in at least one of them."""
    def rel(a, w):
        return (a.float() - w).abs().max().item() / w.abs().max().item()

    errs = [(g.float() - w).abs().max().item() for g, w in zip(gots, wants)]
    rels = [rel(g, w) for g, w in zip(gots, wants)]
    fault_rel = {k: max(rel(f, w) for f, w in zip(fs, wants)) for k, fs in faults.items()}
    finite = all(bool(torch.isfinite(g).all()) for g in gots)
    ok = (finite and max(rels) <= tol and min(fault_rel.values()) > tol
          and extra.pop("ok", True))
    return dict(name=name, max_abs_err=max(errs),
                max_abs_want=max(w.abs().max().item() for w in wants), rel_err=max(rels),
                grad_rel=rels, fault_rel=fault_rel, finite=finite, tol=tol, ok=ok, **extra)


def sdpa_bwd_ms(q, k, v, do, causal, iters, dropout_p=0.0, graph=False):
    """The yardstick: torch.autograd.grad of one SDPA output with the same
    dO, the forward excluded (timed, never called by the port).  With
    ``graph`` the backward is timed from CUDA-graph replays (graph_ms), the
    forward run on the capture stream so that its backward lands there: the
    card's time, not the host's autograd overhead."""
    qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    doh = do.transpose(1, 2)
    if not graph:
        out = torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, dropout_p=dropout_p,
                                                               is_causal=causal)
        return cuda_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), doh, retain_graph=True),
                       iters)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        out = torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, dropout_p=dropout_p,
                                                               is_causal=causal)
    return graph_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), doh, retain_graph=True),
                    stream=s)


def split_case(name, q, k, v, do):
    """The float32 backward's split pass (``flash_attention_bwd_split``)
    against ``_split_planes_dense`` of q, k, v and dO: bit-equal (gate 0),
    the same bits twice, one launch counted; planted faults: the lo planes
    dropped and hi truncated (not rounded)."""
    from paddle_tpu_torch.ops import flash_attention as fa

    got, n_split = counted(lambda: fa.flash_attention_bwd_split(q, k, v, do),
                           fa.flash_attention_bwd_split, 1)
    again = fa.flash_attention_bwd_split(q, k, v, do)
    torch.cuda.synchronize()

    def plain():
        return torch.cat([fa._split_planes_dense(t).flatten() for t in (q, k, v, do)])

    want = plain()
    bits = bool(torch.equal(got.view(torch.int16), want.view(torch.int16)))
    same = bool(torch.equal(got.view(torch.int16), again.view(torch.int16)))
    dropped, truncated = [], []
    for t in (q, k, v, do):
        pl = fa._split_planes_dense(t)
        dropped.append(torch.stack((pl[..., 0, :], torch.zeros_like(pl[..., 1, :])), -2).flatten())
        hi = (t.contiguous().view(torch.int32) & -65536).view(torch.float32)  # truncated, not RN
        truncated.append(torch.stack((hi.bfloat16(), (t - hi).bfloat16()), -2).flatten())
    faults = {"lo_plane_dropped": torch.cat(dropped).float(),
              "hi_truncated": torch.cat(truncated).float()}
    res = gate(name, got.float(), want.float(), faults, 0.0, kind="split", bit_equal=bits,
               same_bits=same, launches_counted=n_split, ok=bits and same and n_split)
    res["ms"] = cuda_ms(lambda: fa.flash_attention_bwd_split(q, k, v, do), 10)
    res["plain_ms"] = cuda_ms(plain, 3)
    res["library_ms"] = None  # no one PyTorch call makes both planes
    n = sum(t.numel() for t in (q, k, v, do))
    res["bound_ms"], res["bound_by"], res["floors"] = bound3(8 * n)  # 4 B in, 2 x 2 B out
    return res


def flash_bwd_case(name, B, H, Sq, Sk, D, causal, seed, with_dlse=False, dtype=torch.bfloat16):
    """The flash backward kernels (the statistics pass, dq, dkv; at float32
    also the split pass) at ``dtype`` vs ``_flash_bwd_dense`` on O and LSE
    from the plain forward: bf16 within BWD_RTOL of the plain version in
    f32, float16 within F16_RTOL of the plain version at float16 (which
    rounds dS, and P for dV, where the kernels do; the CUDA-core float16
    cases' gate), float32 within F32_RTOL of the plain version in f32;
    planted faults: dsum taken as 0, each row's key range one short, (with
    dlse) dlse ignored and (float32) the lo planes dropped, the plain
    backward on q, k, v and dO rounded to bf16; the statistics against
    ``_flash_bwd_stats_dense`` within F32_RTOL, with faults of their own:
    lse in natural-log units, dsum taken as 0 (and dlse ignored).  The
    statistics pass is timed from CUDA-graph replays (``eager_ms`` beside
    it), dq and dkv from CUDA events.  Returns {"stats", "dq", "dkv"} cases
    (and "split" at float32), each launch counted around its call."""
    from paddle_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = randn(g, (B, Sq, H, D), Q_STD, dtype)
    k, v = randn(g, (B, Sk, H, D), dtype=dtype), randn(g, (B, Sk, H, D), dtype=dtype)
    do = randn(g, (B, Sq, H, D), dtype=dtype)
    scale = 1.0 / D ** 0.5
    o32, lse = fa._flash_dense(q.float(), k.float(), v.float(), causal, scale)
    # contiguous, as the flash forward hands it to the backward (the plain
    # forward's O is [B, H, S, D] in memory: each wrapper call would copy it)
    o = o32.to(dtype).contiguous()
    lse = lse.contiguous()
    dlse = (torch.randn(B, H, Sq, generator=g, device="cuda") if with_dlse else None)
    f32 = dtype == torch.float32
    args = (q, k, v, o, do, lse, causal, scale, dlse)
    stats, n_st = counted(lambda: fa.flash_attention_bwd_stats(o, do, lse, dlse),
                          fa.flash_attention_bwd_stats, 1)
    planes = fa.flash_attention_bwd_split(q, k, v, do) if f32 else None
    dq, n_dq = counted(lambda: fa.flash_attention_dq_kernel(*args, stats=stats, planes=planes),
                       fa.flash_attention_dq_kernel, 1)
    (dk, dv), n_dkv = counted(
        lambda: fa.flash_attention_dkv_kernel(*args, stats=stats, planes=planes),
        fa.flash_attention_dkv_kernel, 1)
    dq2 = fa.flash_attention_dq_kernel(*args)  # the same bits, the entry's own statistics
    dk2, dv2 = fa.flash_attention_dkv_kernel(*args)
    stats2 = fa.flash_attention_bwd_stats(o, do, lse, dlse)
    torch.cuda.synchronize()
    same = {"stats": bool(torch.equal(stats, stats2)), "dq": bool(torch.equal(dq, dq2)),
            "dkv": bool(torch.equal(dk, dk2) and torch.equal(dv, dv2))}
    bf16 = dtype == torch.bfloat16
    if bf16:
        want = fa._flash_bwd_dense(q.float(), k.float(), v.float(), o.float(), lse, do.float(),
                                   causal, scale, dlse)
    else:
        want = fa._flash_bwd_dense(q, k, v, o, lse, do, causal, scale, dlse)
    # the statistics: [2, B * H, Sqp], Sq padded to 64 with zeros
    want_stats = fa._flash_bwd_stats_dense(o, do, lse, dlse)
    stat_faults = {"lse_natural_log": want_stats.clone(), "dsum_zero": want_stats.clone()}
    stat_faults["lse_natural_log"][0, :, :Sq] = lse.reshape(B * H, Sq)
    stat_faults["dsum_zero"][1] = 0.0
    if with_dlse:
        stat_faults["dlse_ignored"] = want_stats.clone()
        stat_faults["dlse_ignored"][1, :, :Sq] += dlse.reshape(B * H, Sq)
    ones = torch.ones(Sq, Sk, dtype=torch.bool, device="cuda")
    vis = ones.tril(Sk - Sq) if causal else ones
    if causal:
        short = ones.tril(Sk - Sq - 1)
    else:
        short = ones.clone()
        short[:, -1] = False
    faults = {"dsum_zero": masked_attention_bwd(q, k, v, do, vis, scale, dlse, dsum_zero=True),
              "causal_end_short": masked_attention_bwd(q, k, v, do, short, scale, dlse)}
    if with_dlse:
        faults["dlse_ignored"] = masked_attention_bwd(q, k, v, do, vis, scale)
    if f32:  # what the kernels would give with the hi planes alone
        r = [t.bfloat16().float() for t in (q, k, v, do)]
        faults["lo_plane_dropped"] = fa._flash_bwd_dense(r[0], r[1], r[2], o, lse, r[3], causal,
                                                         scale, dlse)
    shape = dict(kind="flash", B=B, H=H, Sq=Sq, Sk=Sk, D=D, causal=causal, dlse=with_dlse,
                 dtype=TAGS[dtype])
    tol = BWD_RTOL if bf16 else (F32_RTOL if f32 else F16_RTOL)
    res = {"stats": bwd_gate(name, (stats[0], stats[1]), (want_stats[0], want_stats[1]),
                             {f: (t[0], t[1]) for f, t in stat_faults.items()}, F32_RTOL,
                             same_bits=same["stats"], launches_counted=n_st,
                             ok=same["stats"] and n_st, **shape),
           "dq": bwd_gate(name, (dq,), want[:1], {f: t[:1] for f, t in faults.items()},
                          tol, same_bits=same["dq"], launches_counted=n_dq,
                          ok=same["dq"] and n_dq and dq.dtype == dtype, **shape),
           "dkv": bwd_gate(name, (dk, dv), want[1:], {f: t[1:] for f, t in faults.items()},
                           tol, same_bits=same["dkv"], launches_counted=n_dkv,
                           ok=same["dkv"] and n_dkv and dk.dtype == dv.dtype == dtype, **shape)}
    iters = 10
    plain_ms = cuda_ms(lambda: fa._flash_bwd_dense(q, k, v, o, lse, do, causal, scale, dlse), 3)
    library_ms = (None if with_dlse or (causal and Sq != Sk)
                  else sdpa_bwd_ms(q, k, v, do, causal, iters))
    pairs = B * H * visible_pairs(Sq, Sk, causal)
    it = q.element_size()
    nq, nk = B * Sq * H * D * it, B * Sk * H * D * it   # bytes of one q-side / k-side tensor
    nstat = B * H * Sq * 4 * (2 if with_dlse else 1)
    ins = 3 * nq + 2 * nk + nstat                       # q, o, dO, k, v, lse (, dlse)
    # float32: three bf16 products for each product at the tensor-core rate
    # (the f32 FFMA floor kept beside it)
    terms = 3 if f32 else 1
    # dq and dkv read the statistics (and planes) the autograd backward made once
    for key, fn, nbytes, ops in (
            ("stats", lambda: fa.flash_attention_bwd_stats(o, do, lse, dlse),
             2 * nq + nstat + stats.numel() * 4, 2.0 * D * B * H * Sq),
            ("dq", lambda: fa.flash_attention_dq_kernel(*args, stats=stats, planes=planes),
             ins + nq, 6.0 * D * pairs),
            ("dkv", lambda: fa.flash_attention_dkv_kernel(*args, stats=stats, planes=planes),
             ins + 2 * nk, 8.0 * D * pairs)):
        r = res[key]
        r["plain_ms"] = plain_ms
        if key == "stats":
            # device time from CUDA-graph replays (a call of a few tens of
            # microseconds); eager_ms also holds the wrapper's host cost; no
            # one PyTorch call computes the statistics pass's pair
            r["ms"], r["eager_ms"], r["library_ms"] = graph_ms(fn), cuda_ms(fn, iters), None
            r["bound_ms"], r["bound_by"], r["floors"] = bound3(nbytes, **{rate_key(dtype): ops})
        else:
            r["ms"], r["library_ms"] = cuda_ms(fn, iters), library_ms
            r["bound_ms"], r["bound_by"], r["floors"] = bound3(nbytes, tc_flops=terms * ops)
            if f32:
                r["floors"]["f32_ffma_ms"] = ops / H100_F32_FLOPS * 1e3
                r["bound_note"] = "ops, 3 bf16 products"
    res["function_bound_ms"], res["function_bound_by"] = bound(ins + nq + 2 * nk,
                                                               terms * 10.0 * D * pairs)
    if f32:
        res["split"] = split_case(name, q, k, v, do)
        res["split"].update(shape)

    def autograd_bwd():  # the backward as _FlashAttention runs it: stats once, dq, dkv
        stats = fa.flash_attention_bwd_stats(o, do, lse, dlse)
        planes = fa.flash_attention_bwd_split(q, k, v, do) if f32 else None
        fa.flash_attention_dq_kernel(*args, stats=stats, planes=planes)
        fa.flash_attention_dkv_kernel(*args, stats=stats, planes=planes)

    res["backward_ms"] = cuda_ms(autograd_bwd, iters)
    return res


def encoder_bwd_case(name, B, H, S, D, causal, seed):
    """The encoder backward kernel vs ``_encoder_bwd_dense``; planted faults:
    dsum taken as 0 and each row's key range one short."""
    from paddle_tpu_torch.ops import encoder_attention as ea

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = randn(g, (B, S, H, D), Q_STD)
    k, v, do = randn(g, (B, S, H, D)), randn(g, (B, S, H, D)), randn(g, (B, S, H, D))
    scale = 1.0 / D ** 0.5

    _, lse = ea.encoder_attention_kernel(q, k, v, scale, causal)

    def kernel():
        return ea.encoder_attention_bwd_kernel(q, k, v, do, scale, causal, lse=lse)

    got = kernel()
    again = kernel()  # the same bits on a second run
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    want = ea._encoder_bwd_dense(q.float(), k.float(), v.float(), do.float(), scale, causal)
    ones = torch.ones(S, S, dtype=torch.bool, device="cuda")
    vis = ones.tril() if causal else ones
    if causal:
        short = ones.tril(-1)
        short[0, 0] = True  # row 0 keeps its one key
    else:
        short = ones.clone()
        short[:, -1] = False
    faults = {"dsum_zero": masked_attention_bwd(q, k, v, do, vis, scale, dsum_zero=True),
              "causal_end_short": masked_attention_bwd(q, k, v, do, short, scale)}
    res = bwd_gate(name, got, want, faults, BWD_RTOL, kind="encoder", B=B, H=H, Sq=S, Sk=S,
                   D=D, causal=causal, same_bits=same, ok=same)
    res["ms"] = graph_ms(kernel)
    res["plain_ms"] = cuda_ms(lambda: ea._encoder_bwd_dense(q, k, v, do, scale, causal), 3)
    res["library_ms"] = sdpa_bwd_ms(q, k, v, do, causal, 10, graph=True)
    n = B * S * H * D * 2
    res["bound_ms"], res["bound_by"] = bound(7 * n, 10.0 * D * B * H * visible_pairs(S, S, causal))
    return res


def bound3(nbytes, tc_flops=0.0, f32_flops=0.0, philox_calls=0):
    """(bound ms, what bounds it, the floors): the largest of the bytes over
    the HBM rate, tensor-core and f32 operations over their peaks, and the
    Philox calls' multiplies over the integer rate."""
    floors = dict(bytes_ms=nbytes / H100_BYTES_PER_S * 1e3,
                  tensor_core_ms=tc_flops / H100_BF16_FLOPS * 1e3,
                  f32_ms=f32_flops / H100_F32_FLOPS * 1e3,
                  philox_ms=philox_calls * PHILOX_MULS / H100_INT32_OPS * 1e3)
    top = max(floors.values())
    return top, "bytes" if floors["bytes_ms"] >= top else "operations", floors


def keep_check(keep, rate):
    """Keep fraction of a mask and its distance from 1 - rate in binomial
    standard deviations."""
    n = keep.numel()
    frac = keep.float().mean().item()
    sig = abs(frac - (1.0 - rate)) / math.sqrt(rate * (1.0 - rate) / n)
    return dict(keep_fraction=frac, keep_elements=n, keep_sigmas=sig,
                ok=sig <= KEEP_SIGMAS)


def add_keep(keep, rate, *cases):
    """Record the mask's keep fraction in each case, which fails with it."""
    kc = keep_check(keep, rate)
    for c in cases:
        c.update({k: v for k, v in kc.items() if k != "ok"}, ok=c["ok"] and kc["ok"])


def seed_pair(g):
    """An int32 [2] seed pair on the card from generator ``g``."""
    return torch.randint(0, 2**32, (2,), generator=g, device="cuda",
                         dtype=torch.int64).to(torch.int32)


def philox_case():
    """The Philox device function on the card: Random123's known answers,
    and 65,536 random (counter, key) rows against the torch twin."""
    from paddle_tpu_torch.ops import _prng
    from paddle_tpu_torch.ops.fused_ln import philox_kernel

    def i32(rows):
        return torch.tensor(rows, dtype=torch.int64, device="cuda").to(torch.int32)

    got = philox_kernel(i32([list(c) + list(k) for c, k, _ in PHILOX_KAT]))
    want = i32([list(w) for _, _, w in PHILOX_KAT])
    g = torch.Generator(device="cuda").manual_seed(99)
    rows = torch.randint(0, 2**32, (65536, 6), generator=g, device="cuda", dtype=torch.int64)
    twin = torch.stack(_prng.philox4x32(*rows.unbind(1)), 1)
    dev = philox_kernel(rows.to(torch.int32)).to(torch.int64) & 0xFFFFFFFF
    res = dict(name="philox_known_answers",
               known_answers=[" ".join(f"{x & 0xFFFFFFFF:08x}" for x in r)
                              for r in got.tolist()],
               known_answers_equal=bool((got == want).all()),
               random_rows=rows.shape[0], twin_mismatches=int((dev != twin).sum()))
    res["ok"] = res["known_answers_equal"] and res["twin_mismatches"] == 0
    log(f"  philox known answers {res['known_answers']} equal {res['known_answers_equal']}; "
        f"{res['random_rows']} random rows vs the torch twin: {res['twin_mismatches']} "
        f"mismatches {'ok' if res['ok'] else 'FAIL'}")
    return res


def fused_ln_case(name, n, h, dtype, rate, seed, eps=1e-12):
    """The fused-LN forward and backward kernels vs their plain versions on
    the card, with the same seed tensor; each gives the same bits twice.
    Planted faults: gamma ignored and the statistics of the row beside;
    with dropout, the mask read one column over, the seed words swapped
    and (backward) no mask.  The backward's raw partial rows are held
    against the plain model of the kernel's row-to-team assignment
    (``_team_partials``) at PARTIALS_RTOL, with the rows assigned one team
    over as the planted fault."""
    from paddle_tpu_torch.ops import fused_ln as fl

    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = {"bf16": torch.bfloat16, "f32": torch.float32, "f16": torch.float16}[dtype]
    fwd_tol, bwd_tol = ((F16_LN_RTOL, F16_LN_RTOL) if dt == torch.float16
                        else (KERNEL_RTOL["bf16"], BWD_RTOL))
    x = torch.randn(n, h, generator=g, device="cuda").to(dt)
    y = torch.randn(n, h, generator=g, device="cuda").to(dt)
    gamma = (1.0 + 0.1 * torch.randn(h, generator=g, device="cuda")).to(dt)
    beta = (0.1 * torch.randn(h, generator=g, device="cuda")).to(dt)
    dz = torch.randn(n, h, generator=g, device="cuda").to(dt)
    sd = seed_pair(g)
    keep = fl.dropout_keep(sd, n, h, rate) if rate > 0 else None
    plan = fl._plan(h, dt)
    shape = dict(n=n, h=h, dtype=dtype, rate=rate, plan=plan._asdict())

    def plain(k=keep, gm=gamma, xx=x, sdd=sd):
        return fl._fused_ln_dense(xx, y, gm, beta, sdd, rate, eps, True, k)

    out, s = fl.fused_ln_kernel(x, y, gamma, beta, sd, rate, eps)
    again = fl.fused_ln_kernel(x, y, gamma, beta, sd, rate, eps)
    torch.cuda.synchronize()
    same_fwd = bool(torch.equal(out, again[0]) and torch.equal(s, again[1]))
    del again
    want, want_s = plain()
    ones = torch.ones_like(gamma)
    faults = {"gamma_ignored": plain(gm=ones)[0]}
    if rate > 0:
        faults["mask_shifted"] = plain(k=keep.roll(1, -1))[0]
        faults["seeds_swapped"] = plain(k=fl.dropout_keep(sd.flip(0), n, h, rate))[0]
    else:
        faults["residual_dropped"] = plain(xx=torch.zeros_like(x))[0]
    fwd = gate(name, out.float(), want.float(), {k: f.float() for k, f in faults.items()},
               fwd_tol, same_bits=same_fwd, **shape)
    s_err = (s.float() - want_s.float()).abs().max().item()
    fwd.update(s_max_abs_err=s_err, ok=fwd["ok"] and same_fwd and s_err <= fwd_tol
               * want_s.float().abs().max().item())
    del faults, out, s, want

    dx, dy, dgp, dbp = fl.fused_ln_bwd_kernel(want_s, gamma, dz, sd, rate, eps)
    again = fl.fused_ln_bwd_kernel(want_s, gamma, dz, sd, rate, eps)
    torch.cuda.synchronize()
    same_bwd = all(torch.equal(a, b) for a, b in zip((dx, dy, dgp, dbp), again))
    del again
    teams = dgp.shape[0]

    def bwd_raw(k=keep, gm=gamma, ss=want_s, r=rate):
        return fl._fused_ln_bwd_dense(ss, gm, dz, sd, r, eps, True, k, teams=teams,
                                      rows=plan.rows)

    def bwd_plain(**kw):
        dxx, dyy, dgm, dbm = bwd_raw(**kw)
        return dxx.float(), dyy.float(), dgm.sum(0), dbm.sum(0)

    gots = (dx, dy, dgp.sum(0), dbp.sum(0))
    model = bwd_raw()
    partials_rel, partials_fault_rel = partials_check(
        (dgp, dbp), model[2:], [m.roll(1, 0) for m in model[2:]])
    bfaults = {"gamma_ignored": bwd_plain(gm=ones),
               "stats_of_row_beside": bwd_plain(ss=want_s.roll(1, 0))}
    if rate > 0:
        bfaults.update(mask_shifted=bwd_plain(k=keep.roll(1, -1)),
                       seeds_swapped=bwd_plain(k=fl.dropout_keep(sd.flip(0), n, h, rate)),
                       no_mask=bwd_plain(r=0.0))
    partials_ok = partials_rel <= PARTIALS_RTOL < partials_fault_rel
    bwd = bwd_gate(name, gots, bwd_plain(), bfaults, bwd_tol, same_bits=same_bwd, teams=teams,
                   partials_rel=partials_rel, partials_fault_rel=partials_fault_rel,
                   partials_tol=PARTIALS_RTOL, ok=same_bwd and partials_ok, **shape)
    del bfaults, model, gots, dx, dy
    if rate > 0:
        add_keep(keep, rate, fwd, bwd)
    esz = x.element_size()
    calls = n * h // 4 if rate > 0 else 0
    # ms and library_ms from CUDA-graph replays (the card's time: at the
    # small wide cases the wrapper's host cost exceeds the kernel's);
    # eager_ms from CUDA events around back-to-back calls
    def fwd_kernel():
        return fl.fused_ln_kernel(x, y, gamma, beta, sd, rate, eps)

    def bwd_kernel():
        return fl.fused_ln_bwd_kernel(want_s, gamma, dz, sd, rate, eps)

    fwd["ms"], fwd["eager_ms"] = graph_ms(fwd_kernel), cuda_ms(fwd_kernel, 20)
    fwd["plain_ms"] = cuda_ms(plain, 3)
    tF = torch.nn.functional
    fwd["library_ms"] = graph_ms(lambda: tF.layer_norm(x + tF.dropout(y, rate), (h,), gamma,
                                                       beta, eps))
    fwd["bound_ms"], fwd["bound_by"], fwd["floors"] = bound3(
        4 * n * h * esz + 2 * h * gamma.element_size(), f32_flops=10.0 * n * h,
        philox_calls=calls)
    bwd["ms"], bwd["eager_ms"] = graph_ms(bwd_kernel), cuda_ms(bwd_kernel, 20)
    bwd["plain_ms"] = cuda_ms(bwd_plain, 3)
    xr, yr, gr, br = (t.detach().clone().requires_grad_(True) for t in (x, y, gamma, beta))
    st = torch.cuda.Stream()  # the forward on the capture stream, so its backward runs there
    st.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(st):
        lib_out = tF.layer_norm(xr + tF.dropout(yr, rate), (h,), gr, br, eps)
    bwd["library_ms"] = graph_ms(lambda: torch.autograd.grad(
        lib_out, (xr, yr, gr, br), dz, retain_graph=True), stream=st)
    # the partials this run's grid writes: one f32 row of dgamma and of dbeta a team
    bwd["bound_ms"], bwd["bound_by"], bwd["floors"] = bound3(
        4 * n * h * esz + h * gamma.element_size() + 2 * teams * h * 4,
        f32_flops=16.0 * n * h, philox_calls=calls)
    return fwd, bwd


def fused_ln_routing_case(n=8192, h=4096, rate=DROP_RATE):
    """``F.fused_dropout_add_layer_norm`` with autograd at a wide h: both
    fused-LN counters rise by one (the routing reaches the wide kernels),
    and the result matches the plain versions fed the same mask."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import fused_ln as fl

    g = torch.Generator(device="cuda").manual_seed(7)
    x, res, dz = (torch.randn(n, h, generator=g, device="cuda").bfloat16() for _ in range(3))
    w = torch.ones(h, device="cuda", dtype=torch.bfloat16, requires_grad=True)
    b = torch.zeros(h, device="cuda", dtype=torch.bfloat16, requires_grad=True)
    xr = x.clone().requires_grad_(True)
    before = (fl.fused_ln_kernel.launches, fl.fused_ln_bwd_kernel.launches)
    out = F.fused_dropout_add_layer_norm(xr, res, w, b, p=rate, epsilon=1e-5, training=True)
    out.backward(dz)
    torch.cuda.synchronize()
    rose = (fl.fused_ln_kernel.launches - before[0], fl.fused_ln_bwd_kernel.launches - before[1])
    keep = xr.grad != 0  # a kept element's gradient is nonzero almost surely
    # the plain version's s (rounded to bf16, as the kernel's), then its
    # output left in f32, the oracle KERNEL_RTOL is stated against: the
    # output rounded to bf16 as well could sit one bf16 unit (up to 2^-7 of
    # a value) from the kernel's where the two f32 results straddle a
    # rounding boundary, more than the gate, and the mask of this call is
    # the framework generator's, new in every run
    _, s = fl._fused_ln_dense(res, x, w, b, None, rate, 1e-5, True, keep)
    mean, rstd = fl._stats(s.float(), 1e-5)
    want = (s.float() - mean) * rstd * w.float() + b.float()
    err = (out.float() - want).abs().max().item() / want.abs().max().item()
    res_ = dict(name=f"routing_n{n}_h{h}_bf16_drop", launches_rose=list(rose), rel_err=err,
                tol=KERNEL_RTOL["bf16"], finite=bool(torch.isfinite(xr.grad).all()),
                keep_fraction=keep.float().mean().item())
    res_["ok"] = rose == (1, 1) and err <= KERNEL_RTOL["bf16"] and res_["finite"]
    log(f"  fused_ln routing at n {n} h {h}: launches rose {rose} (want (1, 1)), out rel err "
        f"{err:.3e}, keep {res_['keep_fraction']:.4f} {'ok' if res_['ok'] else 'FAIL'}")
    return res_


def encoder_dropout_case(name, B, H, S, D, causal, seed, rate=DROP_RATE, packed=False):
    """The encoder forward and backward kernels with dropout vs their plain
    versions on the card, with the same seed tensor.  Planted faults: the
    mask read one key over, the seed words swapped and (backward) no
    mask.  With ``packed``, q, k and v are the three strided slices of one
    [B, S, 3, H, D] tensor (ERNIE's projection), fed to both kernels as
    they are: no copy may be made.  Both kernels give the same bits twice."""
    from paddle_tpu_torch.ops import encoder_attention as ea

    g = torch.Generator(device="cuda").manual_seed(seed)
    if packed:
        qkv = randn(g, (B, S, 3, H, D))
        qkv[:, :, 0] *= Q_STD
        q, k, v = qkv.unbind(2)
        do = randn(g, (B, S, H, D))
    else:
        q = randn(g, (B, S, H, D), Q_STD)
        k, v, do = randn(g, (B, S, H, D)), randn(g, (B, S, H, D)), randn(g, (B, S, H, D))
    sd = seed_pair(g)
    scale = 1.0 / D ** 0.5
    keep = ea.dropout_keep(sd, B, H, S, rate)
    f32 = [t.float() for t in (q, k, v, do)]
    shape = dict(kind="encoder", B=B, H=H, Sq=S, Sk=S, D=D, causal=causal, rate=rate,
                 packed=packed)
    copies0 = ea._check_inputs.copies

    def plain(kp=keep):
        # v in bf16, so that the oracle rounds the kept, scaled probabilities
        # to bf16 before P.V as the reference kernel and this one do: a
        # probability scaled past 1 by 1 / (1 - rate) rounds in steps of 2^-7,
        # twice those below 1, so an f32 P would add a rounding difference
        # the rate-0 cases do not have.  The products and the output stay f32.
        return ea._encoder_dense(f32[0], f32[1], v, scale, causal, kp, rate)

    def fwd_kernel():
        return ea.encoder_attention_kernel(q, k, v, scale, causal, sd, rate)

    got, lse = fwd_kernel()
    again = fwd_kernel()
    torch.cuda.synchronize()
    same_fwd = bool(torch.equal(got, again[0]) and torch.equal(lse, again[1]))
    lse_err = (lse - ea._encoder_lse(f32[0], f32[1], scale, causal)).abs().max().item()
    swapped = ea.dropout_keep(sd.flip(0), B, H, S, rate)
    fwd = gate(name, got, plain(), {"mask_shifted": plain(keep.roll(1, -1)),
                                    "seeds_swapped": plain(swapped)},
               KERNEL_RTOL["bf16"], same_bits=same_fwd, lse_max_abs_err=lse_err,
               lse_tol=LSE_TOL, ok=same_fwd and lse_err <= LSE_TOL, **shape)

    def bwd_plain(kp=keep, r=rate):
        return ea._encoder_bwd_dense(*f32, scale, causal, kp, r)

    def bwd_kernel():
        return ea.encoder_attention_bwd_kernel(q, k, v, do, scale, causal, sd, rate, lse)

    gots = bwd_kernel()
    again = bwd_kernel()
    torch.cuda.synchronize()
    same_bwd = all(torch.equal(a, b) for a, b in zip(gots, again))
    copies = ea._check_inputs.copies - copies0
    bwd = bwd_gate(name, gots, bwd_plain(), {"mask_shifted": bwd_plain(keep.roll(1, -1)),
                                             "seeds_swapped": bwd_plain(swapped),
                                             "no_mask": bwd_plain(None, 0.0)},
                   BWD_RTOL, same_bits=same_bwd, ok=same_bwd, **shape)
    for c in (fwd, bwd):
        c["input_copies"] = copies
        c["ok"] = c["ok"] and copies == 0
    add_keep(keep, rate, fwd, bwd)
    pairs = B * H * visible_pairs(S, S, causal)
    calls = pairs // 4  # one Philox call serves 4 probabilities
    n = B * S * H * D * 2
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    # the function's least work: one Philox draw per element in each
    # direction (what the kernels draw), q, k, v (+ dO) read and o (dq, dk,
    # dv) written once
    for c, kern, pl, nbytes, ops in (
            (fwd, fwd_kernel,
             lambda: ea._encoder_dense(q, k, v, scale, causal, keep, rate), 4 * n, 4.0),
            (bwd, bwd_kernel,
             lambda: ea._encoder_bwd_dense(q, k, v, do, scale, causal, keep, rate), 7 * n,
             10.0)):
        c["ms"] = graph_ms(kern)
        c["plain_ms"] = cuda_ms(pl, 3)
        c["bound_ms"], c["bound_by"], c["floors"] = bound3(
            nbytes, tc_flops=ops * D * pairs, philox_calls=calls)
    # yardsticks: SDPA with the same dropout rate (its own mask); timed, never used
    fwd["library_ms"] = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, dropout_p=rate, is_causal=causal))
    bwd["library_ms"] = sdpa_bwd_ms(q, k, v, do, causal, 10, dropout_p=rate, graph=True)
    return fwd, bwd


def dropout_kernel_cases():
    """The ERNIE path's kernels with dropout: {kernel name: [case, ...]},
    the ERNIE shape first, and the Philox check; the fused LN at float16
    under the ``_f16`` names (rate 0 first: the float16 ERNIE parity and
    BERT eval run at rate 0)."""
    out = {"fused_ln": [], "fused_ln_bwd": [], "fused_ln_f16": [], "fused_ln_bwd_f16": []}
    for i, (name, n, h, dtype, rate) in enumerate([
            ("ernie_bf16_drop", 65536, 768, "bf16", DROP_RATE),   # the ERNIE step's
            ("ernie_bf16_rate0", 65536, 768, "bf16", 0.0),        # the eval forward's
            ("ernie_f32_drop", 65536, 768, "f32", DROP_RATE),
            ("h1024_bf16_drop", 16384, 1024, "bf16", DROP_RATE),
            # the wide kernels (h > 1024): 9 groups of 128 columns, then one
            # block a row, then a cluster of 8 blocks a row in bf16 and f32
            ("h1152_bf16_drop", 8192, 1152, "bf16", DROP_RATE),
            ("h2048_bf16_drop", 32768, 2048, "bf16", DROP_RATE),
            ("h4096_bf16_drop", 16384, 4096, "bf16", DROP_RATE),
            ("h32768_bf16_rate0", 2048, 32768, "bf16", 0.0),
            ("h32768_f32_drop", 1024, 32768, "f32", DROP_RATE),
            ("ernie_f16_rate0", 65536, 768, "f16", 0.0),
            ("ernie_f16_drop", 65536, 768, "f16", DROP_RATE),
            ("h4096_f16_drop", 16384, 4096, "f16", DROP_RATE)]):
        fwd, bwd = fused_ln_case(name, n, h, dtype, rate, 90 + i)
        tag = "_f16" if dtype == "f16" else ""
        out["fused_ln" + tag].append(fwd)
        out["fused_ln_bwd" + tag].append(bwd)
        log_case("fused_ln" + tag, fwd)
        log_case("fused_ln_bwd" + tag, bwd)
    out["fused_ln_routing"] = [fused_ln_routing_case()]
    enc = {"encoder_attention": [], "encoder_attention_bwd": []}
    for i, (name, B, H, S, D, causal, packed) in enumerate([
            ("ernie_drop", 512, 12, 128, 64, False, False),       # the ERNIE step's
            ("b8_s512_d128_causal_drop", 8, 16, 512, 128, True, False),
            ("ernie_packed_qkv_drop", 512, 12, 128, 64, False, True),  # BERT's qkv views
            ("b8_s512_d128_causal_packed_qkv_drop", 8, 16, 512, 128, True, True)]):
        fwd, bwd = encoder_dropout_case(name, B, H, S, D, causal, 95 + i, packed=packed)
        enc["encoder_attention"].append(fwd)
        enc["encoder_attention_bwd"].append(bwd)
        log_case("encoder_attention", fwd)
        log_case("encoder_attention_bwd", bwd)
    return out, enc


def bwd_kernel_cases():
    """Backward cases: {kernel name: [case, ...]}, the training shapes first;
    head dim 256 (the D = 256 LLaMA's step [8, 2048, 8, 256], a full Sq < Sk
    case, a ragged one) under the ``_d256`` names; the flash backward at
    float16 (D 64, 128 and 256) under the ``_f16`` names and at float32
    (its split pass under ``flash_attention_bwd_split``) under the ``_f32``
    and ``_d256_f32`` names."""
    out = {f"flash_attention_{k}{d}": [] for k in ("bwd_stats", "dq", "dkv")
           for d in ("", "_d256", "_f16", "_f32", "_d256_f32")}
    out["flash_attention_bwd_split"] = []
    out["encoder_attention_bwd"] = []
    for i, (name, B, H, Sq, Sk, D, causal, dlse) in enumerate([
            ("train_s2048", 8, 16, 2048, 2048, 128, True, False),   # the bench's step
            ("7b_heads_s2048", 1, 32, 2048, 2048, 128, True, False),
            ("bh64_s1024_d64", 2, 32, 1024, 1024, 64, True, False),
            ("sq1024_sk2048_causal", 1, 32, 1024, 2048, 128, True, False),
            ("sq1024_sk1536_full", 1, 32, 1024, 1536, 128, False, False),
            ("s2048_dlse", 2, 16, 2048, 2048, 128, True, True),
            ("s264_ragged_causal", 2, 8, 264, 264, 128, True, False),
            ("train_d256_s2048", 8, 8, 2048, 2048, 256, True, False),  # the D = 256 step
            ("d256_sq1024_sk1536_full", 1, 16, 1024, 1536, 256, False, False),
            ("d256_s264_ragged_causal_dlse", 2, 8, 264, 264, 256, True, True)]):
        r = flash_bwd_case(name, B, H, Sq, Sk, D, causal, 60 + i, dlse)
        for key in ("bwd_stats", "dq", "dkv"):
            c = r["stats" if key == "bwd_stats" else key]
            c["function_bound_ms"] = r["function_bound_ms"]
            c["backward_ms"] = r["backward_ms"]
            kern = f"flash_attention_{key}{'_d256' if D == 256 else ''}"
            out[kern].append(c)
            log_case(kern, c)
    # float16 on the same kernels, D 64, 128 and 256 (the shapes and seeds
    # of the CUDA-core float16 cases they replace), the training step first
    for name, B, H, Sq, Sk, D, causal, dlse, seed in [
            ("train_s2048_f16", 8, 16, 2048, 2048, 128, True, False, 160),
            ("sq1024_sk2048_causal_f16", 1, 32, 1024, 2048, 128, True, False, 161),
            ("s2048_dlse_f16", 2, 16, 2048, 2048, 128, True, True, 162),
            ("bh64_s1024_d64_f16", 2, 32, 1024, 1024, 64, True, False, 163),
            ("sq1024_sk1536_full_f16", 1, 16, 1024, 1536, 128, False, False, 164),
            ("train_d256_s2048_f16", 8, 8, 2048, 2048, 256, True, False, 166),
            ("d256_sq1024_sk1536_full_f16", 1, 16, 1024, 1536, 256, False, False, 167),
            ("d256_s264_ragged_causal_dlse_f16", 2, 8, 264, 264, 256, True, True, 168)]:
        r = flash_bwd_case(name, B, H, Sq, Sk, D, causal, seed, dlse, dtype=torch.float16)
        for key in ("bwd_stats", "dq", "dkv"):
            c = r["stats" if key == "bwd_stats" else key]
            c["function_bound_ms"] = r["function_bound_ms"]
            c["backward_ms"] = r["backward_ms"]
            out[f"flash_attention_{key}_f16"].append(c)
            log_case(f"flash_attention_{key}_f16", c)
    # float32 on the same kernels, split-bf16 products: the shapes and seeds
    # of the CUDA-core float32 cases they replace, the LLaMA step first
    for name, B, H, Sq, Sk, D, causal, dlse, seed in [
            ("train_s2048_f32", 8, 16, 2048, 2048, 128, True, False, 160),
            ("sq1024_sk2048_causal_f32", 1, 32, 1024, 2048, 128, True, False, 161),
            ("s2048_dlse_f32", 2, 16, 2048, 2048, 128, True, True, 162),
            ("bh64_s1024_d64_f32", 2, 32, 1024, 1024, 64, True, False, 163),
            ("s264_ragged_causal_f32", 2, 8, 264, 264, 128, True, False, 165),
            ("train_d256_s2048_f32", 8, 8, 2048, 2048, 256, True, False, 166),
            ("d256_sq1024_sk1536_full_f32", 1, 16, 1024, 1536, 256, False, False, 167)]:
        r = flash_bwd_case(name, B, H, Sq, Sk, D, causal, seed, dlse, dtype=torch.float32)
        for key in ("bwd_stats", "dq", "dkv"):
            c = r["stats" if key == "bwd_stats" else key]
            c["function_bound_ms"] = r["function_bound_ms"]
            c["backward_ms"] = r["backward_ms"]
            kern = f"flash_attention_{key}{'_d256' if D == 256 else ''}_f32"
            out[kern].append(c)
            log_case(kern, c)
        out["flash_attention_bwd_split"].append(r["split"])
        log_case("flash_attention_bwd_split", r["split"])
    for i, (S, D, H, causal) in enumerate([(512, 128, 16, True), (128, 128, 16, True),
                                           (256, 128, 16, True), (512, 64, 32, True),
                                           (512, 128, 16, False)]):
        name = "train_s512" if i == 0 else f"b16_s{S}_d{D}_{'causal' if causal else 'full'}"
        out["encoder_attention_bwd"].append(encoder_bwd_case(name, 16, H, S, D, causal, 80 + i))
        log_case("encoder_attention_bwd", out["encoder_attention_bwd"][-1])
    return out


# ---------------------------------------------------------- fused conv + BN

# ResNet-50's bottleneck 1x1 convs at bench.py's batch and resolution (128 x
# 224^2): per stage, conv3's input [N, H, W', K] with wv valid columns (the
# W' ladder 56/56, 28/32, 14/16, 7/8) and K -> C; the backward kernel also
# runs without the fold (conv1) at each of these shapes, and at conv1's
# own shapes 4w -> w (K > C): stage 2's first conv1, [128, 56, 56, 256] ->
# 128, at its block's input resolution, and the conv1s of stages 1, 3 and 4
# (stage 1's first block takes the stem's 64 channels).
CONV_STAGES = [("stage1", 56, 56, 56, 64, 256), ("stage2", 28, 32, 28, 128, 512),
               ("stage3", 14, 16, 14, 256, 1024), ("stage4", 7, 8, 7, 512, 2048)]
CONV1_SHAPE = ("stage2_conv1", 56, 56, 56, 256, 128)
CONV1_CASES = [("stage1_conv1", 56, 56, 56, 256, 64), ("stage1_first_conv1", 56, 56, 56, 64, 64),
               ("stage3_conv1", 14, 16, 14, 1024, 256), ("stage4_conv1", 7, 8, 7, 2048, 512)]
# Shapes admitted by ``supported`` that have no one-pass backward kernel
# (K * C <= 16384, not one of its (K, C) pairs): the two passes, at a small
# M (N 4) whose block ranges end inside W' rows.
CONV_ODD_CASES = [("small_k64_c192", 4, 24, 20, 64, 192), ("small_k192_c64", 4, 24, 20, 192, 64)]
RESNET_B = 128
# Kernel vs plain, relative to max |plain| per output.  y and dx are bf16 on
# both sides: where the kernel's f32 sum and the plain version's (cuBLAS,
# the same bf16 products in another order) fall on either side of a
# rounding boundary an element moves by one bf16 step, up to 2^-7 of it,
# so every output is gated at CONV_RTOL = 1e-2; the f32 outputs (s1, s2,
# dW, dscale, doffset) differ by f32 summation order only.  The planted
# faults come out at 0.10 or more (the ds1 term of a backward without the
# fold dropped is the closest).  The f32 case: every output is f32 on both
# sides (measured on an H100: within 2e-6 of max).  F32_RTOL is every
# float32 kernel case's gate; the float32 flash backward's products are
# split-bf16 (three bf16 products of hi and lo planes, lo x lo left out,
# each operand carried to about 16 of its 24 bits): a CPU emulation of its
# term list gave 1.0-1.4e-5 of max on dQ, dK and dV, and 3-9e-3 with the
# lo planes dropped (the planted "lo plane dropped" fault).
CONV_RTOL = 1e-2
F32_RTOL = 1e-4
# The kernels' raw per-block partials (column sums, dW, dscale/doffset)
# against their plain model (_fwd_partials_dense, _bwd_partials_dense) on
# the same inputs, relative to max |model| of each: the two differ only in
# the order of f32 sums within a block, so PARTIALS_RTOL = 1e-5.  The
# planted fault is the model over ranges that start W' rows later (the
# inputs rolled by W' rows, which keeps the pad columns where they are).
PARTIALS_RTOL = 1e-5


def partials_check(raw, model, shifted):
    """(max rel err of the kernel's partials against the model, the same
    for the shifted-range fault): both relative to max |model|."""
    def rel(a, w):
        return (a.float() - w).abs().max().item() / w.abs().max().item()

    return (max(rel(r, m) for r, m in zip(raw, model)),
            min(rel(f, m) for f, m in zip(shifted, model)))


def roll_rows(t, Wp):
    """t [N, H, W', .] with every flattened row moved W' rows up."""
    return torch.roll(t.reshape(-1, t.shape[-1]), -Wp, 0).reshape(t.shape)


def conv_bn_inputs(H, Wp, wv, K, C, dt, seed, N=RESNET_B, fold=True):
    """x ~ N(0, 1) (pad columns non-zero with the fold, zero without, as
    conv1's input holds them), w ~ N(0, 1 / K), scale 1 + 0.2 N, offset
    0.2 N (so the ReLU cuts and pad columns would be non-zero without the
    mask), dy ~ N(0, 1), ds1 and ds2 ~ 0.3 N: their terms in dy_tot are of
    dy's size, so that dropping one shows."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    x = rn(N, H, Wp, K).to(dt)
    if not fold:
        x[:, :, wv:] = 0
    w2 = (rn(K, C) / math.sqrt(K)).to(dt)
    sc, of = 1.0 + 0.2 * rn(1, K), 0.2 * rn(1, K)
    return x, w2, sc, of, rn(N, H, Wp, C).to(dt), 0.3 * rn(C), 0.3 * rn(C)


def conv_bn_fwd_case(name, H, Wp, wv, K, C, dtype, seed, N=RESNET_B):
    """The forward kernel (with the fold, ReLU) against ``_fwd_fold_dense``;
    planted faults: scale ignored, ReLU dropped and, with pad columns, the
    pad mask dropped.  Its raw column-sum partials against
    ``_fwd_partials_dense`` of its own y."""
    from paddle_tpu_torch.ops import fused_conv_bn as fcb

    dt = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype]
    x, w2, sc, of, _, _, _ = conv_bn_inputs(H, Wp, wv, K, C, dt, seed, N=N)
    M = x.shape[0] * H * Wp

    def kernel():
        return fcb.fused_conv_bn_kernel(x, w2, sc, of, True, wv)

    def plain(scc=sc, relu=True, wvv=wv):
        return fcb._fwd_fold_dense(x, w2, scc, of, relu, wvv)

    got = kernel()
    again = kernel()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    want = plain()
    faults = {"scale_ignored": plain(scc=torch.ones_like(sc)), "relu_dropped": plain(relu=False)}
    if wv < Wp:
        faults["pad_mask_dropped"] = plain(wvv=Wp)
    yk, part = fcb._fwd_launch(x, w2, sc, of, True, wv)
    partials_rel, partials_fault_rel = partials_check(
        [part], [fcb._fwd_partials_dense(yk, K)], [fcb._fwd_partials_dense(roll_rows(yk, Wp), K)])
    partials_ok = partials_rel <= PARTIALS_RTOL < partials_fault_rel
    res = bwd_gate(name, got, want, faults, CONV_RTOL if dtype == "bf16" else F32_RTOL,
                   ok=same and partials_ok, same_bits=same, partials_rel=partials_rel,
                   partials_fault_rel=partials_fault_rel, M=M, K=K, C=C, wv=wv, Wp=Wp,
                   dtype=dtype)
    res["ms"] = cuda_ms(kernel, 10)
    res["plain_ms"] = cuda_ms(plain, 3)
    live = (torch.arange(Wp, device="cuda") < wv).reshape(1, 1, Wp, 1)

    def library():  # the same function from PyTorch library calls (a yardstick)
        a = torch.where(live, torch.relu(x.float() * sc.reshape(-1) + of.reshape(-1)), 0.0)
        yl = torch.matmul(a.to(dt).reshape(-1, K), w2).float()
        return yl.sum(0), (yl * yl).sum(0)

    res["library_ms"] = cuda_ms(library, 10)
    esz = x.element_size()
    nbytes = (M * K + M * C + K * C) * esz + 2 * K * 4 + 2 * C * 4
    flops = 2.0 * M * K * C
    res["bound_ms"], res["bound_by"], res["floors"] = (
        bound3(nbytes, tc_flops=flops) if dtype == "bf16" else bound3(nbytes, f32_flops=flops))
    return res


def conv_bn_bwd_case(name, H, Wp, wv, K, C, dtype, fold, seed, N=RESNET_B):
    """The backward kernel against ``_bwd_dense`` on the plain forward's y;
    planted faults: the ds2 term dropped from dy_tot, and with the fold the
    scale ignored and the ReLU mask dropped from the backward (without it,
    the ds1 term dropped), and with pad columns the pad mask dropped.  Its
    raw dW (and dscale/doffset) partials against ``_bwd_partials_dense``."""
    from paddle_tpu_torch.ops import fused_conv_bn as fcb

    dt = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype]
    x, w2, sc, of, dy, ds1, ds2 = conv_bn_inputs(H, Wp, wv, K, C, dt, seed, N=N, fold=fold)
    sc, of = (sc, of) if fold else (None, None)
    N = x.shape[0]
    M = N * H * Wp
    y = (fcb._fwd_fold_dense(x, w2, sc, of, True, wv) if fold else fcb._fwd_plain(x, w2))[0]

    def kernel():
        return fcb.fused_conv_bn_bwd_kernel(dy, y, x, w2, sc, of, ds1, ds2, True, wv)

    def plain(scc=sc, d1=ds1, d2=ds2, wvv=wv):
        return fcb._bwd_dense(dy, y, x, w2, scc, of, d1, d2, True, wvv)

    def no_relu_mask():  # the fold's backward without its ReLU mask
        x2 = x.reshape(-1, K)
        dyt = fcb._dyt(dy.reshape(-1, C), y.reshape(-1, C), ds1, ds2, Wp, wv).float()
        _, xf = fcb._fold(x2, sc, of, True, Wp, wv)
        g = dyt @ w2.float().T
        return ((g * sc.reshape(-1)).to(dt).reshape(x.shape), xf.float().T @ dyt,
                (g * x2.float()).sum(0)[None], g.sum(0)[None])

    n_out = 4 if fold else 2
    got = kernel()[:n_out]
    again = kernel()[:n_out]
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    want = plain()[:n_out]
    zeros = torch.zeros_like(ds2)
    faults = {"ds2_term_dropped": plain(d2=zeros)}
    if fold:
        faults.update(scale_ignored=plain(scc=torch.ones_like(sc)), relu_mask_dropped=no_relu_mask())
    else:
        faults["ds1_term_dropped"] = plain(d1=zeros)
    if wv < Wp:
        faults["pad_mask_dropped"] = plain(wvv=Wp)
    faults = {k: f[:n_out] for k, f in faults.items()}
    tol = CONV_RTOL if dtype == "bf16" else F32_RTOL
    _, *raw = fcb._bwd_launch(dy, y, x, w2, sc, of, ds1, ds2, True, wv)

    def model(dyy, yy, xx):
        return [m for m in fcb._bwd_partials_dense(dyy, yy, xx, w2, sc, of, ds1, ds2, True, wv)
                if m is not None]

    partials_rel, partials_fault_rel = partials_check(
        [r for r in raw if r is not None], model(dy, y, x),
        model(*(roll_rows(t, Wp) for t in (dy, y, x))))
    partials_ok = partials_rel <= PARTIALS_RTOL < partials_fault_rel
    res = bwd_gate(name, got, want, faults, tol, ok=same and partials_ok, same_bits=same,
                   partials_rel=partials_rel, partials_fault_rel=partials_fault_rel, M=M, K=K,
                   C=C, wv=wv, Wp=Wp, dtype=dtype, fold=fold)
    res["ms"] = cuda_ms(kernel, 10)
    res["plain_ms"] = cuda_ms(plain, 3)
    # yardstick: autograd of the same function composed of library calls
    xr, wr = x.detach().requires_grad_(True), w2.detach().requires_grad_(True)
    leaves = [xr, wr]
    a = xr
    if fold:
        sr, orr = sc.detach().requires_grad_(True), of.detach().requires_grad_(True)
        leaves += [sr, orr]
        live = (torch.arange(Wp, device="cuda") < wv).reshape(1, 1, Wp, 1)
        a = torch.where(live, torch.relu(xr.float() * sr.reshape(-1) + orr.reshape(-1)),
                        0.0).to(dt)
    yl = torch.matmul(a.reshape(-1, K), wr)
    yf = yl.float()
    outs = (yl, yf.sum(0), (yf * yf).sum(0))
    cts = (dy.reshape(-1, C), ds1, ds2)
    res["library_ms"] = cuda_ms(lambda: torch.autograd.grad(outs, leaves, cts, retain_graph=True),
                                5)
    esz = x.element_size()
    aff = 4 * K * 4 if fold else 0  # scale and offset in, dscale and doffset out
    nbytes = (2 * M * C + 2 * M * K + K * C) * esz + K * C * 4 + 2 * C * 4 + aff
    plan = fcb._geometry(M, K, C, dtype == "bf16")
    # what this design moves beyond the bound, counting a tile that several
    # blocks read at about the same time (a dX slice's dy and y, a dW tile's
    # dyt and x) once, as L2 serves the rest: the partials (dW, and with the
    # fold dscale and doffset) written and summed; in two passes (bf16 where
    # _geometry plans them, and f32) also dyt written and read again (bf16)
    # or dy and y read again (f32), and x read again by the dW pass
    parts = 2 * (fcb._blocks(M, plan.dw_rows) * K * C
                 + (2 * fcb._blocks(M, plan.bwd_rows) * K if fold else 0)) * 4
    res["design_extra_bytes"] = parts + (0 if plan.one_pass else (2 * M * C + M * K) * esz)
    flops = 4.0 * M * K * C
    res["bound_ms"], res["bound_by"], res["floors"] = (
        bound3(nbytes, tc_flops=flops) if dtype == "bf16" else bound3(nbytes, f32_flops=flops))
    return res


def conv_bn_kernel_cases():
    """The ResNet path's kernels: {kernel name: [case, ...]}, stage 1's
    conv3 (the most bytes, three launches each way a step) first."""
    out = {"fused_conv_bn": [], "fused_conv_bn_bwd": []}
    for i, (stage, H, Wp, wv, K, C) in enumerate(CONV_STAGES):
        fwd = conv_bn_fwd_case(f"{stage}_conv3_bf16", H, Wp, wv, K, C, "bf16", 110 + i)
        out["fused_conv_bn"].append(fwd)
        log_case("fused_conv_bn", fwd)
        torch.cuda.empty_cache()
    fwd = conv_bn_fwd_case("stage4_conv3_f32", *CONV_STAGES[3][1:], "f32", 115)
    out["fused_conv_bn"].append(fwd)
    log_case("fused_conv_bn", fwd)
    for i, (name, *shape) in enumerate(CONV_ODD_CASES):
        fwd = conv_bn_fwd_case(f"{name}_bf16", *shape, "bf16", 116 + i, N=4)
        out["fused_conv_bn"].append(fwd)
        log_case("fused_conv_bn", fwd)
    cases = [(f"{st}_conv3_bf16", shape, "bf16", True) for st, *shape in CONV_STAGES]
    cases += [(f"{st}_nofold_bf16", shape, "bf16", False) for st, *shape in CONV_STAGES]
    cases += [(f"{CONV1_SHAPE[0]}_nofold_bf16", CONV1_SHAPE[1:], "bf16", False),
              ("stage4_conv3_f32", CONV_STAGES[3][1:], "f32", True)]
    cases += [(f"{st}_bf16", shape, "bf16", False) for st, *shape in CONV1_CASES]
    cases = [(*c, RESNET_B) for c in cases]
    cases += [(f"{st}{tag}_bf16", shape, "bf16", fold, 4) for st, *shape in CONV_ODD_CASES
              for tag, fold in (("", True), ("_nofold", False))]
    for i, (name, shape, dtype, fold, n) in enumerate(cases):
        bwd = conv_bn_bwd_case(name, *shape, dtype, fold, 120 + i, N=n)
        out["fused_conv_bn_bwd"].append(bwd)
        log_case("fused_conv_bn_bwd", bwd)
        torch.cuda.empty_cache()
    return out


RAGGED = [2047, 1500, 1100, 777, 512, 300, 129, 37]  # 8 slots' lengths <= 2048
# A speculative verify's offsets: K + 1 = 5 query rows a slot at 8 ragged
# depths, ending on the capacity (2043), crossing the page edges 1024, 768
# and 128, starting on one (512), and near the start.
VERIFY = [2043, 1498, 1020, 765, 512, 299, 126, 3]
VERIFY_S = 5
# 256-token chunks off the page grid, as a prefix hit that ends inside a page
# starts them.
OFFGRID = [1000, 700]


def split_edges(B, Hkv, cap=2048):
    """Decode offsets whose lengths (offset + 1) fall exactly on the decode
    regime's split boundaries (its plan for B slots and Hkv kv heads on
    this card), on 128-key page boundaries and on the capacity, with one
    slot at length 1."""
    from paddle_tpu_torch.ops import decode_attention as da

    sk = da._split_plan(B, Hkv, cap, torch.cuda.get_device_properties(0).multi_processor_count)[1]
    lengths = [sk, min(2 * sk, cap), 128, 256, sk + 1, 1, cap, 640][:B]
    return [n - 1 for n in lengths]


def decode_kernel_cases():
    """The static decode kernel's cases: the main paths' LLaMA-2-7B and 70B
    (GQA) widths at 8 ragged slots, bf16 and int8; GPT's heads (12 x 64)
    and 16 heads of 256; lengths on split and page edges; and a cache of
    2,000 rows (not whole 64-key tiles: loaded with cp.async)."""
    cases = []
    for quant in (False, True):
        tag = "int8" if quant else "bf16"
        for name, H, Hkv, D, seed in ((f"7b_decode_{tag}", 32, 32, 128, 11),
                                      (f"70b_gqa_decode_{tag}", 64, 8, 128, 12),
                                      (f"gpt_d64_decode_{tag}", 12, 12, 64, 13),
                                      (f"d256_decode_{tag}", 16, 16, 256, 14)):
            cases.append(decode_case(name, 8, H, Hkv, RAGGED, quant, seed, D=D))
            log_case("decode_attention", cases[-1])
    cases.append(decode_case("7b_decode_split_edges_bf16", 8, 32, 32, split_edges(8, 32),
                             False, 15))
    log_case("decode_attention", cases[-1])
    cases.append(decode_case("7b_decode_l2000_bf16", 8, 32, 32, [min(o, 1999) for o in RAGGED],
                             False, 16, L=2000))
    log_case("decode_attention", cases[-1])
    # the dense verify (S = K + 1): 5 rows a kv head split-K at 7B and GPT
    # widths, 40 on wgmma at 70B GQA
    for name, H, Hkv, D, quant, seed in (("7b_verify_s5_bf16", 32, 32, 128, False, 17),
                                         ("7b_verify_s5_int8", 32, 32, 128, True, 18),
                                         ("70b_gqa_verify_s5_bf16", 64, 8, 128, False, 19),
                                         ("gpt_d64_verify_s5_bf16", 12, 12, 64, False, 20),
                                         ("gpt_d64_verify_s5_int8", 12, 12, 64, True, 21)):
        cases.append(decode_case(name, 8, H, Hkv, VERIFY, quant, seed, D=D, S=VERIFY_S))
        log_case("decode_attention", cases[-1])
    return cases


def paged_kernel_cases():
    """The paged kernel's cases: decode ticks and 256-token prefill chunks
    at LLaMA-2-7B and 70B widths, bf16 and int8; GPT's heads and 16 heads
    of 256; lengths on split and page edges; pages of 16 (TMA runs of a
    page) and of 24 (loaded with cp.async); a chunk past the table."""
    cases = []
    for quant in (False, True):
        tag = "int8" if quant else "bf16"
        cases += [
            paged_case(f"7b_decode_{tag}", 8, 1, 32, 32, RAGGED, quant, 1),
            paged_case(f"7b_chunk256_{tag}", 2, 256, 32, 32, [1280, 384], quant, 2),
            paged_case(f"70b_gqa_decode_{tag}", 8, 1, 64, 8, RAGGED, quant, 3),
            paged_case(f"70b_gqa_chunk256_{tag}", 2, 256, 64, 8, [1280, 384], quant, 4),
            paged_case(f"gpt_d64_decode_{tag}", 8, 1, 12, 12, RAGGED, quant, 6, D=64),
            paged_case(f"d256_decode_{tag}", 8, 1, 16, 16, RAGGED, quant, 7, D=256),
            paged_case(f"7b_chunk256_ps16_{tag}", 2, 256, 32, 32, [1280, 384], quant, 8, ps=16),
        ]
    # max_seq_len 2100 pads to 2176 positions (17 pages): the last 256-token
    # chunk of a 2100-token prompt starts at 2048, and its padded rows reach
    # past the table
    cases += [
        paged_case("7b_chunk256_past_table_bf16", 2, 256, 32, 32, [2048, 384], False, 5,
                   pages=17),
        paged_case("gpt_d64_chunk256_bf16", 2, 256, 12, 12, [1280, 384], False, 9, D=64),
        paged_case("d256_chunk256_bf16", 2, 256, 16, 16, [1280, 384], False, 10, D=256),
        paged_case("7b_decode_split_edges_bf16", 8, 1, 32, 32, split_edges(8, 32), False, 11,
                   pages=16),
        paged_case("7b_decode_ps24_int8", 8, 1, 32, 32, RAGGED, True, 12, ps=24),
        paged_case("7b_chunk256_ps24_bf16", 2, 256, 32, 32, [1280, 384], False, 13, ps=24),
    ]
    # the speculative verify (S = K + 1 at ragged offsets, split-K at 7B and
    # GPT widths, a mostly empty 128-row wgmma tile of 40 rows at 70B GQA)
    # and prefill chunks that start off the page grid, over pages whose rows
    # past each length are stale
    for quant in (False, True):
        tag = "int8" if quant else "bf16"
        cases += [
            paged_case(f"7b_verify_s5_{tag}", 8, VERIFY_S, 32, 32, VERIFY, quant, 14,
                       stale=True),
            paged_case(f"70b_gqa_verify_s5_{tag}", 8, VERIFY_S, 64, 8, VERIFY, quant, 15,
                       stale=True),
            paged_case(f"7b_chunk256_offgrid_{tag}", 2, 256, 32, 32, OFFGRID, quant, 16,
                       stale=True),
        ]
    cases += [
        paged_case("gpt_d64_verify_s5_bf16", 8, VERIFY_S, 12, 12, VERIFY, False, 17, D=64,
                   stale=True),
        paged_case("70b_gqa_chunk256_offgrid_bf16", 2, 256, 64, 8, OFFGRID, False, 18,
                   stale=True),
        paged_case("gpt_d64_chunk256_offgrid_bf16", 2, 256, 12, 12, OFFGRID, False, 19, D=64,
                   stale=True),
    ]
    for c in cases:
        log_case("paged_attention", c)
    return cases


# ------------------------------------------------ f32 and f16 attention

# The decode, paged, flash and encoder kernels at float16 and float32 (on
# the tensor cores, float32 as split-bf16 products) vs their plain versions
# in f32 on the same values: max |kernel - plain| over max |plain|.
# float32 (q, k and v f32) at F32_RTOL: three bf16 products a product (lo x
# lo, under 2^-16 of the rest, left out).  float16 writes its output in
# float16 (2^-11 of |out|) and rounds p to float16 before p.v as the
# reference does: F16_RTOL, under bf16's 5e-3.  int8 caches round p to bf16
# whatever q's type, as the bf16 kernels do: KERNEL_RTOL["int8"].  A
# float16 model's engines keep float32 pools, so a float16 q against
# float32 k/v is a case of its own (float16 output: F16_RTOL).
F16_RTOL = 2e-3
TAGS = {torch.float32: "f32", torch.float16: "f16", torch.int8: "int8", torch.bfloat16: "bf16"}


def kv_tol(q_dtype, kv_dtype):
    if kv_dtype == torch.int8:
        return KERNEL_RTOL["int8"]
    return F32_RTOL if torch.float32 == q_dtype == kv_dtype else F16_RTOL


def typed_tol(dtype, backward=False):
    """The gate of a flash or encoder case at q, k, v of ``dtype`` against
    its plain version: F32_RTOL, F16_RTOL, or the bf16 kernels' gates."""
    if dtype == torch.bfloat16:
        return BWD_RTOL if backward else KERNEL_RTOL["bf16"]
    return kv_tol(dtype, dtype)


def rate_key(*dtypes):
    """bound3's keyword for products of these types at their peak: the f32
    rate where an operand is float32, the 16-bit tensor-core rate otherwise
    (float16 against float16, or int8 widened to bf16)."""
    return "f32_flops" if torch.float32 in dtypes else "tc_flops"


def typed_kv_case(kind, name, B, S, H, Hkv, offsets, q_dtype, kv_dtype, seed, ps=128, D=128,
                  L=2048):
    """The static decode (``kind`` "decode": a head-major [B, Hkv, L, D]
    cache) or paged kernel (pages of ``ps``) at q of ``q_dtype`` against a
    cache of ``kv_dtype`` vs its plain version in f32, over stale rows (1e4)
    past each slot's length and a poisoned trash page; planted faults as the
    bf16 cases', and where the cache is float32 also its lo planes dropped
    (the plain version on k and v rounded to bf16); one launch counted
    around the call.  The kernel, its plain version and SDPA (on the
    dequantized, GQA-expanded cache; at float32 where the cache is float32,
    else at q's dtype) are timed."""
    from paddle_tpu_torch.models.kv_cache import _quantize_kv
    from paddle_tpu_torch.ops import decode_attention as da

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    quant = kv_dtype == torch.int8
    q = (torch.randn(B, S, H, D, generator=g, device=dev) * Q_STD).to(q_dtype)
    tbl = None
    if kind == "decode":
        k = torch.randn(B, Hkv, L, D, generator=g, device=dev)
        v = torch.randn(B, Hkv, L, D, generator=g, device=dev)
        for b, o in enumerate(offsets):
            k[b, :, o + S:], v[b, :, o + S:] = 1e4, 1e4
        cap = L
    else:
        M = max(-(-(o + S) // ps) for o in offsets)
        P = 1 + B * M
        k = torch.randn(P, Hkv, ps, D, generator=g, device=dev)
        v = torch.randn(P, Hkv, ps, D, generator=g, device=dev)
        k[0], v[0] = 1e4, 1e4  # the trash page: a read of it shows
        perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(seed)) + 1
        tbl = torch.zeros(B, M, dtype=torch.int32)
        it = iter(perm.tolist())
        for b, o in enumerate(offsets):
            for j in range(-(-(o + S) // ps)):
                page = tbl[b, j] = next(it)
                r0 = max(0, o + S - j * ps)
                k[page, :, r0:], v[page, :, r0:] = 1e4, 1e4
        tbl = tbl.to(dev)
        cap = M * ps
    if quant:
        (k, ks), (v, vs) = _quantize_kv(k), _quantize_kv(v)
        k, v, scales = k.contiguous(), v.contiguous(), (ks.contiguous(), vs.contiguous())
    else:
        k, v, scales = k.to(kv_dtype), v.to(kv_dtype), (None, None)
    off = torch.tensor(offsets, dtype=torch.int64, device=dev)
    lengths = (off + S).to(torch.int32)
    scale = 1.0 / D ** 0.5
    f32 = [None if x is None else x.float() for x in scales]
    k32, v32 = (k, v) if quant else (k.float(), v.float())
    if kind == "decode":
        wrapper = da.decode_attention_kernel

        def kernel():
            return wrapper(q, k, v, lengths, *scales, scale)

        def plain():
            return da._decode_dense(q, k, v, off, *scales, scale)

        def oracle(qq, o_, kk=k32, vv=v32):
            return da._decode_dense(qq, kk, vv, o_, *f32, scale)
    else:
        wrapper = da.paged_attention_kernel

        def kernel():
            return wrapper(q, k, v, lengths, tbl, *scales, scale)

        def plain():
            return da._paged_dense(q, k, v, off, tbl, *scales, scale)

        def oracle(qq, o_, kk=k32, vv=v32):
            return da._paged_dense(qq, kk, vv, o_, tbl, *f32, scale)

    got, n_launch = counted(kernel, wrapper, 1)
    same_bits = bool(torch.equal(got, kernel()))
    torch.cuda.synchronize()
    want = oracle(q.float(), off)
    faults = {"uniform_weights": oracle(torch.zeros_like(want), off),
              "causal_end_short": oracle(q.float(), off - 1)}
    if kv_dtype == q_dtype == torch.float32:  # what K's and V's hi planes alone would give
        faults["lo_plane_dropped"] = oracle(q.float(), off, k32.bfloat16().float(),
                                            v32.bfloat16().float())
    res = gate(name, got, want, faults, kv_tol(q_dtype, kv_dtype), kind=kind, B=B, S=S, H=H,
               Hkv=Hkv, D=D, ps=ps if tbl is not None else None, cap=cap,
               q_dtype=TAGS[q_dtype], kv_dtype=TAGS[kv_dtype], max_len=max(offsets) + S,
               kernel=wrapper.__name__, same_bits=same_bits, launches_counted=n_launch,
               out_dtype=TAGS.get(got.dtype),
               ok=same_bits and n_launch and got.dtype == q_dtype)
    res["ms"], res["eager_ms"] = graph_ms(kernel), cuda_ms(kernel, 20)
    res["plain_ms"] = cuda_ms(plain, 5)
    # yardstick: SDPA on the dequantized, GQA-expanded cache with a per-slot
    # causal mask, at float32 with q upcast where the cache is float32 (the
    # function the kernel computes reads f32 k and v), else at q's dtype;
    # timed here, never used by the port
    ydt = torch.float32 if kv_dtype == torch.float32 else q_dtype
    if tbl is not None:
        kd, vd = da.gather_pages(k, tbl), da.gather_pages(v, tbl)
        sd = [None if x is None else da.gather_pages(x, tbl) for x in scales]
    else:
        kd, vd, sd = k, v, scales
    kd, vd = kd.to(ydt), vd.to(ydt)
    if quant:
        kd, vd = kd * sd[0].to(ydt)[..., None], vd * sd[1].to(ydt)[..., None]
    kd, vd = kd.repeat_interleave(H // Hkv, 1), vd.repeat_interleave(H // Hkv, 1)
    mask = torch.arange(kd.shape[2], device=dev)[None, None, None, :] <= (
        off[:, None, None, None] + torch.arange(S, device=dev)[None, None, :, None])
    qh = q.transpose(1, 2).to(ydt)
    res["library_ms"] = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kd, vd, attn_mask=mask))
    # least time: q and out once, the K/V rows each kv head must see (and
    # scales, table, lengths) once; QK and PV, 4 * D per visible pair
    keys = sum(min(o + S, cap) for o in offsets)
    visible = sum(max(0, min(o + s + 1, cap)) for o in offsets for s in range(S))
    nbytes = (2 * q.numel() * q.element_size() + keys * Hkv * D * k.element_size() * 2
              + (keys * Hkv * 4 * 2 if quant else 0) + (tbl.numel() * 4 if tbl is not None else 0)
              + B * 4)
    res["bound_ms"], res["bound_by"], res["floors"] = bound3(
        nbytes, **{rate_key(q_dtype, kv_dtype): 4.0 * D * H * visible})
    return res


def typed_seq_case(name, kind, B, H, Sq, Sk, D, causal, dtype, seed, rate=0.0, packed=False):
    """The flash or encoder forward kernel (``flash_attention_kernel``,
    ``encoder_attention_kernel``) at ``dtype`` (bfloat16, float16, or
    float32 as split-bf16 products) vs its plain version in f32 on the same
    values, with its lse; the encoder at ``rate`` > 0 with the Philox mask
    from the same seed tensor (planted faults: the mask read one key over,
    the seed words swapped), else the planted faults of
    ``seq_attention_case``; at float32 also the lo planes dropped (the
    plain version on q, k and v rounded to bf16).  ``packed``: q, k, v the
    three strided slices of one [B, S, 3, H, D] tensor (BERT's projection),
    read in place.  The kernel, its plain version and SDPA at the same
    dtype are timed."""
    from paddle_tpu_torch.ops import encoder_attention as ea
    from paddle_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(seed)
    if packed:
        qkv = torch.randn(B, Sq, 3, H, D, generator=g, device="cuda")
        qkv[:, :, 0] *= Q_STD
        q, k, v = qkv.to(dtype).unbind(2)
    else:
        q = (torch.randn(B, Sq, H, D, generator=g, device="cuda") * Q_STD).to(dtype)
        k = torch.randn(B, Sk, H, D, generator=g, device="cuda").to(dtype)
        v = torch.randn(B, Sk, H, D, generator=g, device="cuda").to(dtype)
    scale = 1.0 / D ** 0.5
    sd = seed_pair(g) if rate > 0 else None
    keep = ea.dropout_keep(sd, B, H, Sq, rate) if rate > 0 else None
    qf, kf, vf = q.float(), k.float(), v.float()
    copies0 = ea._check_inputs.copies
    f32 = dtype == torch.float32
    if kind == "flash":
        wrapper = fa.flash_attention_kernel

        def kernel():
            return wrapper(q, k, v, causal, scale)

        def plain():
            return fa._flash_dense(q, k, v, causal, scale)

        def oracle(a, b, c):
            return fa._flash_dense(a, b, c, causal, scale)[0]

        want, want_lse = fa._flash_dense(qf, kf, vf, causal, scale)
    else:
        wrapper = ea.encoder_attention_kernel

        def kernel():
            return wrapper(q, k, v, scale, causal, sd, rate)

        def plain():
            return ea._encoder_dense(q, k, v, scale, causal, keep, rate)

        def oracle(a, b, c):
            return ea._encoder_dense(a, b, c, scale, causal, keep, rate)

        # v in its own dtype, so that the oracle rounds the kept, scaled
        # probabilities to it as the kernel does (encoder_dropout_case)
        want = ea._encoder_dense(qf, kf, v if rate > 0 else vf, scale, causal, keep, rate)
        want_lse = ea._encoder_lse(qf, kf, scale, causal)
    (got, lse), n_launch = counted(kernel, wrapper, 1)
    again = kernel()
    torch.cuda.synchronize()
    same = bool(torch.equal(got, again[0]) and torch.equal(lse, again[1]))
    copies = ea._check_inputs.copies - copies0
    if rate > 0:
        swapped = ea.dropout_keep(sd.flip(0), B, H, Sq, rate)
        faults = {"mask_shifted": ea._encoder_dense(qf, kf, v, scale, causal, keep.roll(1, -1),
                                                    rate),
                  "seeds_swapped": ea._encoder_dense(qf, kf, v, scale, causal, swapped, rate)}
    else:
        ones = torch.ones(Sq, Sk, dtype=torch.bool, device="cuda")
        if causal:
            short = ones.tril(Sk - Sq - 1)
        else:
            short = ones.clone()
            short[:, -1] = False
        faults = {"uniform_weights": masked_attention(torch.zeros_like(q), k, v, ones, scale),
                  "causal_end_short": masked_attention(q, k, v, short, scale)}
    if f32:  # what the kernel would give with the hi planes alone
        faults["lo_plane_dropped"] = oracle(*(t.bfloat16().float() for t in (q, k, v)))
    lse_err = (lse.reshape(B, H, Sq) - want_lse.reshape(B, H, Sq)).abs().max().item()
    res = gate(name, got, want, faults, typed_tol(dtype), kind=kind, B=B, H=H, Sq=Sq, Sk=Sk,
               D=D, causal=causal, rate=rate, packed=packed, dtype=TAGS[dtype],
               kernel=wrapper.__name__, lse_max_abs_err=lse_err, lse_tol=LSE_TOL,
               same_bits=same, input_copies=copies, launches_counted=n_launch,
               ok=(lse_err <= LSE_TOL and same and got.dtype == dtype and copies == 0
                   and n_launch))
    if keep is not None:
        add_keep(keep, rate, res)
    res["ms"] = graph_ms(kernel)  # device time from CUDA-graph replays
    res["plain_ms"] = cuda_ms(plain, 3)
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    # yardstick: SDPA at the same dtype (top-left causal, so causal only at
    # Sq == Sk; the encoder's with the same dropout rate, its own mask)
    res["library_ms"] = None
    if Sq == Sk or not causal:
        res["library_ms"] = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, dropout_p=rate, is_causal=causal))
    # least time: q, k, v read and o, lse written once; 4 * D operations a
    # visible pair at the tensor-core rate (float32: three bf16 products for
    # each, the f32 FFMA floor of the CUDA-core kernel it replaced kept
    # beside it), and a Philox call for four of them
    pairs = B * H * visible_pairs(Sq, Sk, causal)
    ops = 4.0 * D * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() + B * H * Sq * 4
    res["bound_ms"], res["bound_by"], res["floors"] = bound3(
        nbytes, tc_flops=(3 if f32 else 1) * ops, philox_calls=pairs // 4 if rate > 0 else 0)
    if f32:
        res["floors"]["f32_ffma_ms"] = ops / H100_F32_FLOPS * 1e3
        res["bound_note"] = "3 bf16 products a product"
    return res


def typed_kv_cases():
    """The decode and paged kernels' float32 and float16 instantiations
    (the ``_f32`` and ``_f16`` rows, by q's type), the main paths' shapes,
    the case each main path runs most first in each row: LLaMA-2-7B widths
    (S = 1 at 8 ragged slots; the verify's S = 5; 256-token chunks off the
    page grid; pages of 16 and 128), 70B's GQA 64/8, head dims 64 and 256,
    int8 caches under float32 and float16 q, and the float16 engines'
    float16 q against float32 pools, which leads the paged float16 row
    (float16 generate() runs a float16 static cache)."""
    f32, f16, i8 = torch.float32, torch.float16, torch.int8
    out = {f"{k}_attention_{TAGS[t]}": [] for k in ("decode", "paged") for t in (f32, f16)}
    for kind in ("decode", "paged"):
        specs = [  # (name, B, S, H, Hkv, offsets, q, kv, extra)
            ("7b_decode", 8, 1, 32, 32, RAGGED, f32, f32, {}),
            ("7b_decode", 8, 1, 32, 32, RAGGED, f16, f16, {}),   # float16 generate()
            ("7b_decode", 8, 1, 32, 32, RAGGED, f16, f32, {}),   # a float16 model's engines
            ("7b_verify_s5", 8, VERIFY_S, 32, 32, VERIFY, f32, f32, {}),
            ("7b_verify_s5", 8, VERIFY_S, 32, 32, VERIFY, f16, f16, {}),
            ("70b_gqa_decode", 8, 1, 64, 8, RAGGED, f32, f32, {}),
            ("70b_gqa_decode", 8, 1, 64, 8, RAGGED, f16, f16, {}),
            ("7b_decode", 8, 1, 32, 32, RAGGED, f32, i8, {}),
            ("7b_decode", 8, 1, 32, 32, RAGGED, f16, i8, {}),
            ("gpt_d64_decode", 8, 1, 12, 12, RAGGED, f32, f32, dict(D=64)),
            ("d256_decode", 8, 1, 16, 16, RAGGED, f16, f16, dict(D=256)),
        ]
        if kind == "paged":
            specs += [
                ("7b_chunk256_offgrid", 2, 256, 32, 32, OFFGRID, f32, f32, {}),
                ("7b_chunk256_offgrid", 2, 256, 32, 32, OFFGRID, f16, f32, {}),
                ("7b_chunk256_offgrid", 2, 256, 32, 32, OFFGRID, f16, f16, {}),
                ("7b_chunk256_ps16", 2, 256, 32, 32, [1280, 384], f32, f32, dict(ps=16)),
                ("7b_decode_ps16", 8, 1, 32, 32, RAGGED, f16, f32, dict(ps=16)),
                ("70b_gqa_chunk256", 2, 256, 64, 8, [1280, 384], f32, f32, {}),
                ("7b_chunk256", 2, 256, 32, 32, [1280, 384], f32, i8, {}),
                ("7b_chunk256", 2, 256, 32, 32, [1280, 384], f16, i8, {}),
                # the other loads and layouts: pages of 24 (cp.async, no TMA),
                # head dim 256 with planes (a one-stage ring; 64-row chunk
                # tiles whose warpgroups own half of O each)
                ("7b_decode_ps24", 8, 1, 32, 32, RAGGED, f32, f32, dict(ps=24)),
                ("7b_chunk64_ps24", 2, 64, 32, 32, [1280, 384], f32, f32, dict(ps=24)),
                ("d256_decode", 8, 1, 16, 16, RAGGED, f32, f32, dict(D=256)),
                ("d256_decode_ps24", 4, 1, 16, 16, RAGGED[:4], f16, f32, dict(D=256, ps=24)),
                ("d256_chunk64", 2, 64, 16, 8, [300, 40], f32, f32, dict(D=256)),
                ("d256_chunk64_ps24", 2, 64, 16, 8, [300, 40], f16, f32, dict(D=256, ps=24)),
                ("d256_chunk64", 2, 64, 16, 8, [300, 40], f16, i8, dict(D=256)),
            ]
        else:
            specs += [("7b_decode_l2000", 8, 1, 32, 32, [min(o, 1999) for o in RAGGED], f32, f32,
                       dict(L=2000)),
                      ("d256_decode", 8, 1, 16, 16, RAGGED, f32, f32, dict(D=256)),
                      ("d256_decode_l2000", 4, 1, 16, 16, [1999, 1500, 300, 37], f32, f32,
                       dict(D=256, L=2000)),
                      ("d256_verify_s5", 4, VERIFY_S, 16, 16, VERIFY[:4], f32, i8, dict(D=256)),
                      ("70b_gqa_verify_s5", 4, VERIFY_S, 64, 8, VERIFY[:4], f32, f32, {})]
        for i, (name, B, S, H, Hkv, offs, qt, kvt, extra) in enumerate(specs):
            tag = TAGS[qt] if qt == kvt else f"{TAGS[qt]}_{TAGS[kvt]}kv"
            key = f"{kind}_attention_{TAGS[qt]}"
            out[key].append(typed_kv_case(kind, f"{name}_{tag}", B, S, H, Hkv, offs, qt, kvt,
                                          100 + i, **extra))
            log_case(key, out[key][-1])
    rows = out["paged_attention_f16"]  # a float16 model's engines lead the paged float16 row
    rows.insert(0, rows.pop(1))
    return out


def f32_forward_cases():
    """The flash and encoder forwards at float32 (the ``_f32`` rows: the
    wgmma kernels' float32 instantiations, split-bf16 products, the planes
    made in shared memory), at the shapes of the CUDA-core cases they
    replace, the case each main path runs most first: flash at generate()'s
    [4, 1024, 32, 128] causal, the no-cache forward's [1, 2048, 32, 128],
    the training shape [8, 2048, 16, 128], head dim 64, Sq < Sk causal and
    a ragged length (rows past S, masked keys); head dim 256 (the
    ``_d256_f32`` row: 64 query rows shared by both warpgroups) at the
    D = 256 LLaMA's [8, 2048, 8, 256] causal and [4, 1024, 16, 256] full;
    the encoder at ERNIE's [512, 128, 12, 64] at rate 0 (BERT's eval) and
    0.1 and as BERT's packed views, the LLaMA no-cache forward's
    [4, 512, 32, 128] causal and the b32_s512 microbatch [16, 512, 16, 128]
    causal (the streamed kernel, 64-key tiles), and one case of each other
    float32 regime: S = 128 at head dim 128 (one head resident), S = 256 at
    head dim 64 with dropout (one head resident), S = 512 at head dim 64
    with dropout (streamed, 128-key tiles) and S = 256 at head dim 128,
    causal, with dropout, as packed views."""
    f32 = torch.float32
    out = {"flash_attention_f32": [], "flash_attention_d256_f32": [],
           "encoder_attention_f32": []}
    for i, (row, name, B, H, Sq, Sk, D, causal) in enumerate([
            ("", "7b_generate_s1024", 4, 32, 1024, 1024, 128, True),   # generate(ids[4, 1024])
            ("", "7b_forward_s2048", 1, 32, 2048, 2048, 128, True),    # the no-cache forward
            ("", "train_shape_s2048", 8, 16, 2048, 2048, 128, True),   # the LLaMA step's
            ("", "bh64_s1024_d64", 2, 32, 1024, 1024, 64, True),
            ("", "sq1024_sk2048_causal", 1, 32, 1024, 2048, 128, True),
            ("", "s264_ragged_causal", 2, 8, 264, 264, 128, True),
            ("_d256", "d256_train_s2048", 8, 8, 2048, 2048, 256, True),  # the D = 256 step's
            ("_d256", "d256_s1024_full", 4, 16, 1024, 1024, 256, False)]):
        key = f"flash_attention{row}_f32"
        out[key].append(typed_seq_case(f"{name}_f32", "flash", B, H, Sq, Sk, D, causal, f32,
                                       130 + i))
        log_case(key, out[key][-1])
    for i, (name, B, H, S, D, causal, rate, packed) in enumerate([
            ("ernie_rate0", 512, 12, 128, 64, False, 0.0, False),   # the BERT eval forward's
            ("ernie_drop", 512, 12, 128, 64, False, DROP_RATE, False),
            ("ernie_packed_qkv_rate0", 512, 12, 128, 64, False, 0.0, True),
            ("7b_forward_s512_causal", 4, 32, 512, 128, True, 0.0, False),
            ("train_s512", 16, 16, 512, 128, True, 0.0, False),  # LLaMA's b32_s512 step
            ("b16_s128_d128_causal", 16, 16, 128, 128, True, 0.0, False),
            ("b8_s256_d64_causal_drop", 8, 12, 256, 64, True, DROP_RATE, False),
            ("b8_s512_d64_full_drop", 8, 12, 512, 64, False, DROP_RATE, False),
            ("b4_s256_d128_causal_drop_packed", 4, 8, 256, 128, True, DROP_RATE, True)]):
        out["encoder_attention_f32"].append(typed_seq_case(
            f"{name}_f32", "encoder", B, H, S, S, D, causal, f32, 140 + i, rate=rate,
            packed=packed))
        log_case("encoder_attention_f32", out["encoder_attention_f32"][-1])
    return out


# ---------------------------------- f32 and f16 encoder backward (wgmma)

# The encoder backward at float32 (split-bf16 products) and float16 vs
# their plain versions on the same values: max |kernel - plain| over max
# |plain| for each of dQ, dK and dV, float32 within F32_RTOL (three bf16
# products a product, lo x lo left out, and f32 sums in another order),
# float16 within F16_RTOL (the plain version rounds dS to float16 where the
# kernels do, and both write float16: a rounding boundary crossed in one
# and not the other moves a gradient by about 2^-11 of one term).  The same
# bits twice; launches counted around each call.

def counted(fn, counter, n):
    """fn()'s result, and whether ``counter`` rose by exactly ``n`` in it."""
    before = counter.launches
    out = fn()
    return out, counter.launches - before == n


def typed_encoder_bwd_case(name, B, H, S, D, causal, dtype, seed, rate=0.0, packed=False):
    """The encoder backward kernel (``encoder_attention_bwd_kernel``) at
    ``dtype`` (bfloat16, float16, or float32 as split-bf16 products) vs
    ``_encoder_bwd_dense`` on the same values and mask (which rounds dS to
    the inputs' type where the kernels do), on the whole-head kernel or the
    streamed pair (from the plain lse) as ``_whole_head`` decides; planted
    faults: at rate 0 dsum taken as 0 and each row's key range one short,
    with dropout the mask read one key over, the seed words swapped and no
    mask, and at float32 the lo planes dropped (the plain backward on q, k,
    v and dO rounded to bf16).  ``packed``: q, k, v the three strided slices
    of one [B, S, 3, H, D] tensor, read with no copy."""
    from paddle_tpu_torch.ops import encoder_attention as ea

    g = torch.Generator(device="cuda").manual_seed(seed)
    if packed:
        qkv = torch.randn(B, S, 3, H, D, generator=g, device="cuda")
        qkv[:, :, 0] *= Q_STD
        q, k, v = qkv.to(dtype).unbind(2)
    else:
        q = (torch.randn(B, S, H, D, generator=g, device="cuda") * Q_STD).to(dtype)
        k, v = (torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype) for _ in range(2))
    do = torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype)
    scale = 1.0 / D ** 0.5
    sd = seed_pair(g) if rate > 0 else None
    keep = ea.dropout_keep(sd, B, H, S, rate) if rate > 0 else None
    lse = ea._encoder_lse(q.float(), k.float(), scale, causal).contiguous()
    copies0 = ea._check_inputs.copies

    wrapper = ea.encoder_attention_bwd_kernel

    def kernel():
        return wrapper(q, k, v, do, scale, causal, sd, rate, lse)

    def plain(kp=keep, r=rate):
        return ea._encoder_bwd_dense(q, k, v, do, scale, causal, kp, r)

    got, n_launch = counted(kernel, wrapper, 1)
    again = kernel()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    copies = ea._check_inputs.copies - copies0
    if rate > 0:
        swapped = ea.dropout_keep(sd.flip(0), B, H, S, rate)
        faults = {"mask_shifted": plain(keep.roll(1, -1)), "seeds_swapped": plain(swapped),
                  "no_mask": plain(None, 0.0)}
    else:
        ones = torch.ones(S, S, dtype=torch.bool, device="cuda")
        vis = ones.tril() if causal else ones
        if causal:
            short = ones.tril(-1)
            short[0, 0] = True  # row 0 keeps its one key
        else:
            short = ones.clone()
            short[:, -1] = False
        faults = {"dsum_zero": masked_attention_bwd(q, k, v, do, vis, scale, dsum_zero=True),
                  "causal_end_short": masked_attention_bwd(q, k, v, do, short, scale)}
    f32 = dtype == torch.float32
    if f32:  # what the kernel would give with the hi planes alone
        r = [t.bfloat16().float() for t in (q, k, v, do)]
        faults["lo_plane_dropped"] = ea._encoder_bwd_dense(*r, scale, causal, keep, rate)
    res = bwd_gate(name, got, plain(), faults, typed_tol(dtype, backward=True), kind="encoder",
                   B=B, H=H, Sq=S, Sk=S, D=D, causal=causal, rate=rate, packed=packed,
                   dtype=TAGS[dtype], kernel=wrapper.__name__, same_bits=same,
                   input_copies=copies, launches_counted=n_launch,
                   ok=same and n_launch and copies == 0 and got[0].dtype == dtype)
    if keep is not None:
        add_keep(keep, rate, res)
    res["ms"] = graph_ms(kernel)
    res["plain_ms"] = cuda_ms(plain, 2)
    # SDPA's float32 backward with dropout faults inside a CUDA graph on the
    # card (an illegal address at replay): timed with events there
    res["library_ms"] = sdpa_bwd_ms(q, k, v, do, causal, 10, dropout_p=rate,
                                    graph=rate == 0 or not f32)
    pairs = B * H * visible_pairs(S, S, causal)
    n = B * S * H * D * q.element_size()
    ops = 10.0 * D * pairs
    # float32: three bf16 products for each product at the tensor-core rate
    # (the f32 FFMA floor of the CUDA-core kernel it replaced kept beside it)
    res["bound_ms"], res["bound_by"], res["floors"] = bound3(
        7 * n + (0 if ea._whole_head(S, D, q.element_size()) else B * H * S * 4),
        tc_flops=(3 if f32 else 1) * ops, philox_calls=pairs // 4 if rate > 0 else 0)
    if f32:
        res["floors"]["f32_ffma_ms"] = ops / H100_F32_FLOPS * 1e3
        res["bound_note"] = "3 bf16 products a product"
    return res


def f32_encoder_bwd_cases():
    """The encoder backward's cases at float32 (the ``_f32`` row: the wgmma
    kernels' float32 instantiations, split-bf16 products), the main paths'
    shapes, the case each main path runs most first: ERNIE's
    [512, 128, 12, 64] with dropout 0.1 (the whole head; and as BERT's
    packed views), the LLaMA b32_s512 microbatch [16, 512, 16, 128] causal
    (the streamed pair at W = 256), S = 128 causal at head dim 128 (the
    streamed pair at S = 128), S = 512 at head dim 64 with dropout (the
    streamed pair at W = 128), and S = 256 at head dim 128, causal, with
    dropout, as packed views (W = 256 with the mask's bits, strided f32
    tiles of 32 columns)."""
    f32 = torch.float32
    out = {"encoder_attention_bwd_f32": []}
    for i, (name, B, H, S, D, causal, rate, packed) in enumerate([
            ("ernie_drop", 512, 12, 128, 64, False, DROP_RATE, False),  # ERNIE's
            ("ernie_packed_qkv_drop", 512, 12, 128, 64, False, DROP_RATE, True),
            ("train_s512", 16, 16, 512, 128, True, 0.0, False),  # LLaMA's b32_s512
            ("b16_s128_d128_causal", 16, 16, 128, 128, True, 0.0, False),
            ("b8_s512_d64_full_drop", 8, 12, 512, 64, False, DROP_RATE, False),
            ("b4_s256_d128_causal_drop_packed", 4, 8, 256, 128, True, DROP_RATE, True)]):
        out["encoder_attention_bwd_f32"].append(typed_encoder_bwd_case(
            f"{name}_f32", B, H, S, D, causal, f32, 180 + i, rate=rate, packed=packed))
        log_case("encoder_attention_bwd_f32", out["encoder_attention_bwd_f32"][-1])
    return out


def encoder_f16_cases():
    """The encoder forward and backward at float16 on the tensor-core
    kernels (the ``_f16`` rows), at the shapes and seeds of the CUDA-core
    float16 cases they replace, the main path's case first: ERNIE's
    [512, 128, 12, 64] at rate 0 (BERT's float16 eval; the backward's
    first row with dropout 0.1, ERNIE's step) and 0.1, and as BERT's
    packed q, k, v views; the LLaMA no-cache forward's [4, 512, 32, 128]
    causal (the streamed forward); the b32_s512 microbatch
    [16, 512, 16, 128] causal (the streamed backward); S = 128 causal at
    D = 128; [8, 512, 12, 64] full with dropout (resident D 64 at S 512).
    Each within F16_RTOL, with its planted faults, the same bits twice, the
    lse gate and no copy of the packed views.  Returns ({row: [case, ...]},
    {row: [case, ...]}): the float16 rows, and the bf16 twins of those of
    their shapes that the bf16 rows lack, for ``f16_against_bf16``."""
    f16, bf16 = torch.float16, torch.bfloat16
    out = {"encoder_attention_f16": [], "encoder_attention_bwd_f16": []}
    twins = {"encoder_attention": [], "encoder_attention_bwd": []}
    for i, (name, B, H, S, D, causal, rate, packed, twin) in enumerate([
            ("ernie_rate0", 512, 12, 128, 64, False, 0.0, False, True),  # BERT's float16 eval
            ("ernie_drop", 512, 12, 128, 64, False, DROP_RATE, False, False),
            ("ernie_packed_qkv_rate0", 512, 12, 128, 64, False, 0.0, True, True),
            ("ernie_packed_qkv_drop", 512, 12, 128, 64, False, DROP_RATE, True, False),
            ("7b_forward_s512_causal", 4, 32, 512, 128, True, 0.0, False, True),
            ("b16_s128_d128_causal", 16, 16, 128, 128, True, 0.0, False, True),
            ("b8_s512_d64_full_drop", 8, 12, 512, 64, False, DROP_RATE, False, True)]):
        for dt, rows in ((f16, out), (bf16, twins)) if twin else ((f16, out),):
            c = typed_seq_case(f"{name}_{TAGS[dt]}", "encoder", B, H, S, S, D, causal, dt,
                               140 + i, rate=rate, packed=packed)
            key = "encoder_attention" + ("_f16" if dt == f16 else "")
            rows[key].append(c)
            log_case(key, c)
    for i, (name, B, H, S, D, causal, rate, packed, twin) in enumerate([
            ("ernie_drop", 512, 12, 128, 64, False, DROP_RATE, False, False),  # ERNIE's step
            ("ernie_packed_qkv_drop", 512, 12, 128, 64, False, DROP_RATE, True, False),
            ("train_s512", 16, 16, 512, 128, True, 0.0, False, False),  # LLaMA's b32_s512
            ("b16_s128_d128_causal", 16, 16, 128, 128, True, 0.0, False, False),
            ("b8_s512_d64_full_drop", 8, 12, 512, 64, False, DROP_RATE, False, True)]):
        for dt, rows in ((f16, out), (bf16, twins)) if twin else ((f16, out),):
            c = typed_encoder_bwd_case(f"{name}_{TAGS[dt]}", B, H, S, D, causal, dt, 180 + i,
                                       rate=rate, packed=packed)
            key = "encoder_attention_bwd" + ("_f16" if dt == f16 else "")
            rows[key].append(c)
            log_case(key, c)
    return out, twins


def kernel_phase():
    """Every kernel against its plain version at the main paths' shapes.
    Returns {kernel name: [case, ...]}; the first case of each is the one
    its main path runs most."""
    out = {"decode_attention": decode_kernel_cases(), "flash_attention": [],
           "encoder_attention": []}
    for i, (name, B, H, Sq, Sk, D, causal) in enumerate([
            ("7b_generate_s1024", 4, 32, 1024, 1024, 128, True),   # generate(ids[4, 1024])
            ("7b_engine_s2048", 1, 32, 2048, 2048, 128, True),     # the engine's L bucket
            ("bh32_s1024", 1, 32, 1024, 1024, 128, True),
            ("bh64_s2048", 2, 32, 2048, 2048, 128, True),
            ("bh64_s1024_d64", 2, 32, 1024, 1024, 64, True),
            ("sq1024_sk2048_causal", 1, 32, 1024, 2048, 128, True),
            ("sq1024_sk1536_full", 1, 32, 1024, 1536, 128, False),
            ("train_s2048", 8, 16, 2048, 2048, 128, True),         # the train phase's
            ("d256_s1024_causal", 4, 16, 1024, 1024, 256, True),   # SDPA's D = 256 gate
            ("d256_s1024_full", 4, 16, 1024, 1024, 256, False),
            ("d256_sq1024_sk1536_causal", 1, 16, 1024, 1536, 256, True),
            ("s264_ragged_causal", 2, 8, 264, 264, 128, True),     # rows past S, masked keys
            ("d256_train_s2048", 8, 8, 2048, 2048, 256, True)]):   # the D = 256 LLaMA's step
        out["flash_attention"].append(
            seq_attention_case(name, "flash", B, H, Sq, Sk, D, causal, 20 + i))
        log_case("flash_attention", out["flash_attention"][-1])
    # float16 on the same kernel: generate()'s prefill first (the float16
    # main path), then the dtypes phase's no-cache forward, the training
    # shape and head dims 64 and 256
    out["flash_attention_f16"] = []
    for name, B, H, S, D, causal, seed in [
            ("7b_generate_s1024_f16", 4, 32, 1024, 128, True, 131),
            ("7b_forward_s2048_f16", 1, 32, 2048, 128, True, 130),
            ("train_shape_s2048_f16", 8, 16, 2048, 128, True, 132),
            ("bh64_s1024_d64_f16", 2, 32, 1024, 64, True, 133),
            ("d256_s1024_full_f16", 4, 16, 1024, 256, False, 134)]:
        out["flash_attention_f16"].append(seq_attention_case(
            name, "flash", B, H, S, S, D, causal, seed, dtype=torch.float16))
        log_case("flash_attention_f16", out["flash_attention_f16"][-1])
    encoder_shapes = [(256, 128, True)] + [(S, D, c) for S in (128, 256, 512)
                                           for D in (128, 64) for c in (True, False)
                                           if (S, D, c) != (256, 128, True)]
    for i, (S, D, causal) in enumerate(encoder_shapes):
        H = 32 if D == 128 else 64  # hidden 4096 either way
        out["encoder_attention"].append(seq_attention_case(
            f"b8_s{S}_d{D}_{'causal' if causal else 'full'}", "encoder", 8, H, S, S, D,
            causal, 40 + i))
        log_case("encoder_attention", out["encoder_attention"][-1])
    out["encoder_attention"].append(seq_attention_case(  # the train phase's microbatch
        "train_s512", "encoder", 16, 16, 512, 512, 128, True, 59))
    log_case("encoder_attention", out["encoder_attention"][-1])
    out["paged_attention"] = paged_kernel_cases()
    out.update(bwd_kernel_cases())
    fused, enc = dropout_kernel_cases()
    out.update(fused)
    for kern, cases in enc.items():  # the ERNIE step's shape first
        out[kern] = cases[:1] + out[kern] + cases[1:]
    f16_rows, twins = encoder_f16_cases()
    out.update(f16_rows)
    for kern, cases in twins.items():
        out[kern] += cases
    out["philox"] = [philox_case()]
    out.update(conv_bn_kernel_cases())
    out.update(typed_kv_cases())
    out.update(f32_forward_cases())
    out.update(f32_encoder_bwd_cases())
    f16_against_bf16(out)
    zero_counts()  # comparison launches do not count
    return out


def f16_against_bf16(out):
    """Each float16 flash and encoder case's time beside the bf16 case of
    the same shape, rate and layout in this run (``bf16_ms``,
    ``f16_over_bf16``): the one design at either 2-byte type should run
    alike; each float32 flash backward case's too (``f32_over_bf16``: three
    bf16 products a product, on float32's own tiles)."""
    def key(c):
        return (c["B"], c["H"], c["Sq"], c["Sk"], c["D"], c["causal"], bool(c.get("dlse")),
                c.get("rate") or 0.0, bool(c.get("packed")))

    for kern in ("flash_attention", "flash_attention_bwd_stats", "flash_attention_dq",
                 "flash_attention_dkv", "encoder_attention", "encoder_attention_bwd"):
        bf16 = {key(c): c for d in ("", "_d256") for c in out.get(kern + d, [])}
        rows = [(kern + "_f16", "f16")] + [(kern + d + "_f32", "f32") for d in ("", "_d256")
                                           if kern + d + "_f32" in out]
        for row, tag in rows:
            for c in out[row]:
                twin = bf16.get(key(c))
                if twin is None:
                    continue
                c["bf16_ms"], c[f"{tag}_over_bf16"] = twin["ms"], c["ms"] / twin["ms"]
                log(f"  {row} {c['name']}: {c['ms']:.4f} ms against bf16 {twin['name']} "
                    f"{twin['ms']:.4f} ms: {c[tag + '_over_bf16']:.3f}x")


# The libraries whose SASS must hold the Hopper instructions their design
# rests on, and whose ptxas report must show no spill: those built on
# wgmma_attention.cuh need wgmma (HGMMA) and TMA loads (UTMALDG); fused_ln,
# which has no product, its rows' 1-D bulk copies (UBLKCP).
HOPPER_LIBS = {**{lib: ("HGMMA", "UTMALDG") for lib in (
    "flash_attention", "flash_attention_bwd", "encoder_attention", "encoder_attention_bwd",
    "decode_attention", "paged_attention", "fused_conv_bn")}, "fused_ln": ("UBLKCP",)}
SASS_OPS = ("HGMMA", "UTMALDG", "UBLKCP")
# The libraries built at more than one element type, with their wgmma
# kernels and the head dims each is built at: every instantiation (element
# type x head dim) must hold HGMMA, as many at float16 as at bf16 (one
# design at either type); each is built at float32 too (its split-bf16
# products: three HGMMA a bf16 product's one, on tiles of its own), but
# the UNBUILT ones: the encoder backward's whole-head kernel at D = 128,
# whose float32 tiles do not fit (that shape runs the streamed pair), and
# the encoder's streamed forward at D = 64 at the 2-byte types (S <= 512
# keeps their D = 64 resident); the element types as the mangled names
# spell them.
FLASH_DIMS, ENCODER_DIMS = (64, 128, 256), (64, 128)
TYPED_LIBS = {"flash_attention": {"flash_fwd_kernel": FLASH_DIMS},
              "flash_attention_bwd": {"flash_dq_kernel": FLASH_DIMS,
                                      "flash_dkv_kernel": FLASH_DIMS},
              "encoder_attention": {"encoder_fwd_resident": ENCODER_DIMS,
                                    "encoder_fwd_streamed": ENCODER_DIMS},
              "encoder_attention_bwd": {"encoder_bwd_head": ENCODER_DIMS,
                                        "encoder_dq": ENCODER_DIMS,
                                        "encoder_dkv": ENCODER_DIMS}}
TYPED_TAGS = ("bf16", "f16")
BUILT_TAGS = TYPED_TAGS + ("f32",)
UNBUILT = {"encoder_bwd_head<f32,128>", "encoder_fwd_streamed<bf16,64>",
           "encoder_fwd_streamed<f16,64>"}
MANGLED_TYPES = {"13__nv_bfloat16": "bf16", "6__half": "f16", "IfLi": "f32"}


def sass_text(lib):
    """A library's SASS (cuobjdump -sass)."""
    from paddle_tpu_torch.ops import _build

    cuobjdump = str(Path(_build.nvcc_path()).parent / "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          timeout=120, check=True).stdout


def sass_counts(lib):
    """HGMMA, UTMALDG and UBLKCP instructions in a library's SASS (cuobjdump)."""
    sass = sass_text(lib)
    return {op: sass.count(op) for op in SASS_OPS}


def hgmma_by_instance(name, lib):
    """HGMMA instructions of each instantiation of the wgmma kernels of
    TYPED_LIBS[name] in its SASS, keyed "kernel<type,D>" (type and head dim,
    the first integer argument, read from the mangled function name; the
    instantiations of one key that differ only in a later argument, as the
    resident encoder forward's head buffers, are summed)."""
    out, key = {}, None
    for line in sass_text(lib).splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            kern = next((k for k in TYPED_LIBS[name] if k in fn), None)
            tag = next((t for m, t in MANGLED_TYPES.items() if m in fn), "?")
            dim = re.search(r"Li(\d+)E", fn)
            key = kern and f"{kern}<{tag},{dim.group(1) if dim else '?'}>"
            if key:
                out.setdefault(key, 0)
        elif key and "HGMMA" in line:
            out[key] += 1
    return out


def typed_faults(by_instance):
    """The instantiations of TYPED_LIBS (at BUILT_TAGS' types, but UNBUILT)
    without HGMMA, and the (kernel, head dim) pairs whose float16 instantiation holds
    another number of HGMMA than its bf16 twin."""
    missing, unequal = [], []
    for name, kerns in TYPED_LIBS.items():
        got = by_instance[name]
        for kern, dims in kerns.items():
            for d in dims:
                n = {t: got.get(f"{kern}<{t},{d}>", 0) for t in TYPED_TAGS}
                missing += [f"{kern}<{t},{d}>" for t in BUILT_TAGS
                            if not got.get(f"{kern}<{t},{d}>", 0)
                            and f"{kern}<{t},{d}>" not in UNBUILT]
                if len(set(n.values())) > 1:
                    unequal.append(f"{kern}<{d}>: " + ", ".join(f"{t} {v}" for t, v in n.items()))
    return missing, unequal


def log_case(kern, c):
    if "ms" not in c:
        return
    lib = "n/a" if c["library_ms"] is None else f"{c['library_ms']:.4f} ms"
    lse = f" lse err {c['lse_max_abs_err']:.2e}" if "lse_max_abs_err" in c else ""
    if "grad_rel" in c:
        lse += " per grad " + "/".join(f"{r:.2e}" for r in c["grad_rel"])
    if "same_bits" in c:
        lse += f" same bits {c['same_bits']}"
    if "input_copies" in c:
        lse += f" input copies {c['input_copies']}"
    if "partials_rel" in c:
        lse += f" partials {c['partials_rel']:.2e} (fault {c['partials_fault_rel']:.2e})"
    if "backward_ms" in c:
        lse += f" stats+dq+dkv {c['backward_ms']:.4f} ms"
    if "eager_ms" in c:
        lse += f" eager {c['eager_ms']:.4f} ms"
    if "keep_fraction" in c:
        lse += (f" keep {c['keep_fraction']:.6f} ({c['keep_sigmas']:.2f} sigma) floors "
                + ", ".join(f"{k} {v:.4f}" for k, v in c["floors"].items()))
    log(f"  {kern:21s} {c['name']:26s} err {c['max_abs_err']:.3e} of max "
        f"{c['max_abs_want']:.3f}: rel {c['rel_err']:.3e} (tol {c['tol']}; planted "
        "faults " + ", ".join(f"{k} {v:.3e}" for k, v in c["fault_rel"].items())
        + f"){lse} kernel {c['ms']:.4f} ms  plain {c['plain_ms']:.4f} ms  "
        f"sdpa {lib}  bound {c['bound_ms']:.4f} ms ({c['bound_by']})  "
        f"{'ok' if c['ok'] else 'FAIL'}")


# ------------------------------------------------------------- main paths

def counters():
    from paddle_tpu_torch.ops import decode_attention as da
    from paddle_tpu_torch.ops import encoder_attention as ea
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_conv_bn as fcb
    from paddle_tpu_torch.ops import fused_ln as fl

    return {"paged_attention": da.paged_attention_kernel,
            "decode_attention": da.decode_attention_kernel,
            "flash_attention": fa.flash_attention_kernel,
            "encoder_attention": ea.encoder_attention_kernel,
            "flash_attention_dq": fa.flash_attention_dq_kernel,
            "flash_attention_dkv": fa.flash_attention_dkv_kernel,
            "encoder_attention_bwd": ea.encoder_attention_bwd_kernel,
            "fused_ln": fl.fused_ln_kernel,
            "fused_ln_bwd": fl.fused_ln_bwd_kernel,
            "fused_conv_bn": fcb.fused_conv_bn_kernel,
            "fused_conv_bn_bwd": fcb.fused_conv_bn_bwd_kernel,
            "flash_attention_bwd_stats": fa.flash_attention_bwd_stats,
            "flash_attention_bwd_split": fa.flash_attention_bwd_split}


def zero_counts():
    from paddle_tpu_torch.ops import encoder_attention as ea

    for fn in counters().values():
        fn.launches = 0
    ea._check_inputs.copies = 0


def input_copies():
    """Copies the encoder wrappers made of views TMA cannot read, since the
    counters were last zeroed."""
    from paddle_tpu_torch.ops import encoder_attention as ea

    return ea._check_inputs.copies


def read_counts():
    return {k: fn.launches for k, fn in counters().items()}


def model_dtype(model):
    return next(model.parameters()).dtype


def prefill_kernel(cfg, B, S):
    """The kernel a no-cache prefill of [B, S] tokens runs per layer, at any
    type: the reference's routing (encoder, flash, or None for dense
    math)."""
    from paddle_tpu_torch.nn.functional.attention import _reference_kernel

    H, D = cfg.num_attention_heads, cfg.hidden_size // cfg.num_attention_heads
    q = torch.empty(B, S, H, D, device="meta")
    return _reference_kernel(q, q, None, True, "auto")


def logit_tol(dtype, cache_dtype=None):
    """The teacher-forced logit gate of a model at ``dtype``."""
    if cache_dtype == "int8":
        return INT8_LOGIT_TOL
    return {torch.float32: F32_LOGIT_TOL, torch.float16: F16_LOGIT_TOL}.get(dtype, LOGIT_TOL)


@torch.no_grad()
def forward_logits(model, prompt, out):
    """The oracle, independent of every kernel under test: the no-cache
    forward with dense-math attention over prompt + out[:-1], its logits at
    the positions that produced out ([n, V] f32)."""
    cfg = model.config
    seq = list(prompt) + list(out[:-1])
    n = len(seq)
    if not hasattr(cfg, "use_flash_attention") and n % 128 == 0:
        # GPT routes by shape alone: one more (causally invisible) token
        # keeps the length off the encoder and flash kernels' gates
        seq.append(0)
    flash = getattr(cfg, "use_flash_attention", None)
    if flash is not None:
        cfg.use_flash_attention = False
    try:
        ids = torch.tensor(seq, device=model.device)[None]
        return model(ids)[0, len(prompt) - 1:n].float()
    finally:
        if flash is not None:
            cfg.use_flash_attention = flash


def judge(cases, tol):
    """cases: [(tokens, forward logits [n, V], path logits [n, V][, allowed
    [n, V] bool])].  The path's logits must lie within ``tol`` of the
    forward's; each token must be the forward's argmax (over the tokens a
    constraint allowed there, where a case gives them), unless the
    forward's top-2 gap is under twice the drift this run measured, the
    most by which two logits can trade places."""
    per, drift = [], []
    for toks, want, path, *allowed in cases:
        d = (path - want).abs().amax(-1).tolist()
        if allowed and allowed[0] is not None:
            want = want.masked_fill(~allowed[0], float("-inf"))
        top2 = want.topk(2, dim=-1).values
        per.append((toks, want.argmax(-1).tolist(), (top2[:, 0] - top2[:, 1]).tolist()))
        drift += d
    tie_tol = 2 * max(drift)
    exact = ties = bad = under = 0
    for toks, am, gaps in per:
        for tok, a, gap in zip(toks, am, gaps):
            under += gap < tie_tol
            if tok == a:
                exact += 1
            elif gap < tie_tol:
                ties += 1
            else:
                bad += 1
    return dict(positions=len(drift), max_logit_drift=max(drift),
                mean_logit_drift=sum(drift) / len(drift), logit_tol=tol,
                tie_tol=tie_tol, share_gap_under_tie_tol=under / len(drift),
                exact=exact, near_ties=ties, failures=bad,
                ok=max(drift) <= tol and bad == 0)


def launch_check(launches, expected):
    return all(launches[k] == expected.get(k, 0) for k in launches) and any(launches.values())


# --------------------------------------------------------------- generate

@torch.no_grad()
def static_path_logits(model, ids, out, cache_dtype):
    """generate()'s own path, teacher-forced on its output: the prefill,
    then one static-cache decode step per generated token but the last
    ([B, n, V] f32)."""
    from paddle_tpu_torch.models.generation import _to_static_caches

    logits, caches = model.generate_step(ids)
    caches = _to_static_caches(caches, ids, ids.shape[1] + out.shape[1], cache_dtype,
                               None, 128, False)
    rows = [logits[:, -1]]
    for i in range(out.shape[1] - 1):
        logits, caches = model.generate_step(out[:, i:i + 1].long(), caches=caches)
        rows.append(logits[:, -1])
    return torch.stack(rows, dim=1).float()


def generate_run(model, name, B, S0, n_new, cache_dtype, seed):
    cfg = model.config
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(1, cfg.vocab_size, (B, S0), generator=g).to(model.device)
    # the same call first, so that the timed one pays no first launch and
    # no capture of its decode program (jit/graphs.py)
    model.generate(ids, max_new_tokens=n_new, cache_dtype=cache_dtype)
    torch.cuda.synchronize()
    zero_counts()                                        # the run starts here
    t0 = time.perf_counter()
    out = model.generate(ids, max_new_tokens=n_new, cache_dtype=cache_dtype)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()                             # ... and ends here
    L, dt = cfg.num_hidden_layers, model_dtype(model)
    expected = {"decode_attention": L * (n_new - 1)}
    kern = prefill_kernel(cfg, B, S0)
    if kern:
        expected[kern] = L
    path = static_path_logits(model, ids, out, cache_dtype)
    verdict = judge([(out[b].tolist(), forward_logits(model, ids[b].tolist(), out[b].tolist()),
                      path[b]) for b in range(B)], logit_tol(dt, cache_dtype))
    valid = tuple(out.shape) == (B, n_new) and bool(((out >= 0) & (out < cfg.vocab_size)).all())
    res = dict(path="generate", name=name, B=B, prompt=S0, new_tokens=n_new, dtype=TAGS[dt],
               cache=cache_dtype or TAGS[dt], prefill_kernel=kern, wall_s=wall,
               decode_tok_per_s=B * (n_new - 1) / wall, launches=launches,
               expected_launches=expected, replay_equal=bool(
                   (path.argmax(-1) == out.long()).all()),
               teacher_forced=verdict, valid_ids=valid)
    res["ok"] = valid and launch_check(launches, expected) and verdict["ok"]
    return res


def generate_phase(model, card):
    runs = [generate_run(model, "b4_s1024_bf16", 4, 1024, 32, None, 1),   # flash prefill
            generate_run(model, "b4_s1024_int8", 4, 1024, 32, "int8", 1),
            generate_run(model, "b8_s256_bf16", 8, 256, 32, None, 2)]    # encoder prefill
    for r in runs:
        tf = r["teacher_forced"]
        log(f"  {r['name']}: prefill {r['prefill_kernel']}, wall {r['wall_s']:.3f} s "
            f"({r['decode_tok_per_s']:.1f} tok/s incl. prefill); launches {r['launches']} "
            f"(expected {r['expected_launches']}); drift max {tf['max_logit_drift']:.4f} "
            f"(tol {tf['logit_tol']}), {tf['exact']} exact, {tf['near_ties']} near-ties, "
            f"{tf['failures']} failures; replay equal {r['replay_equal']}; "
            f"{'ok' if r['ok'] else 'FAIL'} [{card}]")
    return runs


# ------------------------------------------------------------ engine runs

def pool_balanced(eng):
    """Each page's refcount equals its holders: the slot tables that map it
    plus one if a prefix-cache node holds it; free pages hold 0 and sit in
    the free list once; the trash page is never held.  With adapters, their
    pins balance too (adapters_balanced), and with the kv tiers the host
    and disk tiers (tiers_balanced)."""
    holds = {}
    for pages in eng._slot_pages:
        for p in pages:
            holds[p] = holds.get(p, 0) + 1
    cached = set(eng._prefix.pages()) if eng._prefix is not None else set()
    free = list(eng._free_pages)
    ok = len(free) == len(set(free)) and 0 not in free and int(eng._page_ref[0]) == 0
    ok &= {p for p in range(eng.num_pages) if eng._page_cached[p]} == cached
    for p in range(1, eng.num_pages):
        ref = int(eng._page_ref[p])
        ok &= ref == holds.get(p, 0) + (p in cached) and (p in free) == (ref == 0)
    return (bool(ok) and (eng.adapters is None or adapters_balanced(eng))
            and (eng._host_kv is None or tiers_balanced(eng)))


def drive(eng, reqs):
    """Submit ``reqs`` (with their adapter and constraint, where given) and
    tick the engine in this thread until they finish, checking the pool's
    balance after every tick (paged).  Returns (token lists, whether the
    pool stayed balanced)."""
    futs = [eng.submit(r["prompt"], max_new_tokens=r["max_new"], do_sample=r["sampled"],
                       temperature=0.8, top_p=0.9, adapter_id=r.get("adapter"),
                       constraint=r.get("constraint")) for r in reqs]
    balanced = True
    while not all(f.done() for f in futs) or eng._prefilling is not None:
        eng.step()
        if eng.paged:
            balanced &= pool_balanced(eng)
    return [f.result() for f in futs], balanced


def paged_engine(model, **kw):
    from paddle_tpu_torch.inference import LLMEngine

    base = dict(max_batch_slots=8, max_seq_len=2048, kv_layout="paged", page_size=128,
                prefill_chunk=256, generator=torch.Generator(device=model.device).manual_seed(5))
    return LLMEngine(model, **{**base, **kw})


def engine_run(model, name, eng, waves, check, split=None, verify=0):
    """One engine run: ``waves`` of requests, each wave driven to the end
    before the next; launch counts against the work, the teacher-forced
    logit and argmax gates on the greedy requests marked ``check``."""
    cfg = model.config
    warm = eng.warmup()
    st0 = eng.stats()  # the counters of any traffic before the run
    zero_counts()                                        # the run starts here
    t0 = time.perf_counter()
    outs, balanced = [], True
    for wave in waves:
        o, b = drive(eng, wave)
        outs += o
        balanced &= b
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()                             # ... and ends here
    st = eng.stats()
    reqs = [r for wave in waves for r in wave]
    L, dt = cfg.num_hidden_layers, model_dtype(model)

    def ran(key):
        return st[key] - st0[key]

    verifies = st["spec"]["verify_calls"] - st0["spec"]["verify_calls"] if st["spec"] else 0
    if eng.paged:
        expected = {"paged_attention": L * (ran("prefill_chunks") + ran("decode_ticks")
                                            + verifies)}
    else:
        expected = {"decode_attention": L * (ran("decode_steps") + verifies)}
        for Lb, count in st["prefill_buckets"].items():
            kern = prefill_kernel(cfg, 1, Lb)
            if kern:
                count -= st0["prefill_buckets"].get(Lb, 0)
                expected[kern] = expected.get(kern, 0) + L * count
    # a request ends at its max_new tokens, or earlier at the engine's eos
    valid = all((len(o) == r["max_new"] or 0 < len(o) < r["max_new"] and o[-1] == eng.eos)
                and all(0 <= t < cfg.vocab_size for t in o) for o, r in zip(outs, reqs))
    res = dict(path=name, dtype=TAGS[dt], cache=eng.cache_dtype or TAGS[eng.caches[0][0].dtype],
               requests=len(reqs),
               warmup_s=warm, wall_s=wall, launches=launches, expected_launches=expected,
               prefill_chunks=st["prefill_chunks"], decode_ticks=st["decode_ticks"],
               decode_tokens=st["decode_tokens"], prefill_s=st["prefill_seconds"],
               decode_s=st["decode_seconds"],
               decode_tok_per_s=st["decode_tokens"] / max(st["decode_seconds"], 1e-9),
               ttft_s=st["ttft_seconds"], prompt_tokens=sum(len(r["prompt"]) for r in reqs),
               preemptions=st["preemptions"], prefix_cache=st["prefix_cache"],
               spec=st["spec"], decode_chunk=eng.decode_chunk,
               prefill_buckets=st.get("prefill_buckets"), valid_ids=valid, outputs=outs)
    if eng.paged:
        res["pool_balanced_every_tick"] = balanced
        # the pool drains to the pages the prefix cache alone holds
        cached = st["prefix_cache"]["cached_pages"] if st["prefix_cache"] else 0
        res["drained_to_cache"] = (st["kv_pages_in_use"] == 0
                                   and int(eng._page_ref.sum()) == cached)
    checked = [(r, o) for r, o in zip(reqs, outs) if r.get("check") and not r["sampled"]]
    if check and checked:
        res["teacher_forced"] = judge(
            [(o, forward_logits(model, r["prompt"], o),
              paged_logits(model, r["prompt"], o, split=split(r) if split else None,
                           verify=verify) if eng.paged else
              dense_path_logits(model, eng, r["prompt"], o)) for r, o in checked],
            logit_tol(dt, eng.cache_dtype))
    res["ok"] = (valid and launch_check(launches, expected)
                 and res.get("pool_balanced_every_tick", True)
                 and res.get("drained_to_cache", True)
                 and (not check or res.get("teacher_forced", {}).get("ok", False)))
    return res


def log_run(r, card, extra=""):
    """One line of a run's numbers and verdicts; its token lists are dropped
    from the report."""
    r.pop("outputs", None)
    tf = r.get("teacher_forced")
    tf = (f"drift max {tf['max_logit_drift']:.4f} (tol {tf['logit_tol']}), {tf['exact']} exact, "
          f"{tf['near_ties']} near-ties, {tf['failures']} failures" if tf else "not checked")
    buckets = f" (buckets {r['prefill_buckets']})" if r.get("prefill_buckets") else ""
    log(f"  {r['path']} {r['cache']} decode_chunk={r.get('decode_chunk', 1)}: "
        f"{r['requests']} req, {r['prompt_tokens']} prompt tok, {r['prefill_chunks']} prefills{buckets} in "
        f"{r['prefill_s']:.3f} s, TTFT mean "
        f"{r['ttft_s']['mean']:.3f} s; {r['decode_tokens']} decode tok at "
        f"{r['decode_tok_per_s']:.1f} tok/s; wall {r['wall_s']:.1f} s; launches "
        f"{r['launches']} (expected {r['expected_launches']}); balanced "
        f"{r.get('pool_balanced_every_tick')}, drained {r.get('drained_to_cache')}; "
        f"teacher-forced {tf}{extra}; {'ok' if r['ok'] else 'FAIL'} [{card}]")


# ------------------------------------------------------------ dense engine

@torch.no_grad()
def dense_path_logits(model, eng, prompt, out):
    """The dense engine's path for one request, teacher-forced at batch 1:
    the bucket-padded prefill, its rows written into a static cache (int8
    when the engine's is), then one per-slot decode step per generated
    token but the last."""
    from paddle_tpu_torch.models.kv_cache import _quantize_kv

    n, dev, L = len(prompt), model.device, eng.L
    Lb = eng._bucket(n)
    ids = torch.zeros(1, Lb, dtype=torch.int64)
    ids[0, :n] = torch.tensor(prompt)
    logits, kvs = model.prefill_step(ids.to(dev), n - 1)
    pos = torch.tensor([n], device=dev)
    caches = []
    for k, v in kvs:
        H, D = k.shape[2], k.shape[3]
        if eng.cache_dtype == "int8":
            c = (torch.zeros(1, H, L, D, dtype=torch.int8, device=dev),
                 torch.zeros(1, H, L, D, dtype=torch.int8, device=dev), pos,
                 torch.full((1, H, L), 1e-8, device=dev), torch.full((1, H, L), 1e-8, device=dev))
            (c[0][:, :, :Lb], c[3][:, :, :Lb]) = _quantize_kv(k.transpose(1, 2))
            (c[1][:, :, :Lb], c[4][:, :, :Lb]) = _quantize_kv(v.transpose(1, 2))
        else:
            c = (torch.zeros(1, H, L, D, dtype=k.dtype, device=dev),
                 torch.zeros(1, H, L, D, dtype=k.dtype, device=dev), pos)
            c[0][:, :, :Lb], c[1][:, :, :Lb] = k.transpose(1, 2), v.transpose(1, 2)
        caches.append(c)
    rows = [logits[0, 0]]
    for tok in out[:-1]:
        logits, caches = model.generate_step(torch.tensor([[tok]], device=dev), caches=caches)
        rows.append(logits[0, -1])
    return torch.stack(rows).float()


def dense_requests(rng, vocab, n_req, sampled_every):
    """Prompts spread over the buckets 64, 128, 256 and L (2048)."""
    spans = [(33, 64), (65, 128), (129, 256), (257, 2000)]
    reqs = []
    for i in range(n_req):
        lo, hi = spans[i % 4]
        reqs.append(dict(prompt=rng.integers(1, vocab, int(rng.integers(lo, hi + 1))).tolist(),
                         max_new=int(rng.integers(32, 65)), check=True,
                         sampled=sampled_every > 0 and i % sampled_every == sampled_every - 1))
    return reqs


def serve_dense(model, n_req, rng, cache_dtype, decode_chunk, sampled_every, check):
    from paddle_tpu_torch.inference import LLMEngine

    eng = LLMEngine(model, max_batch_slots=8, max_seq_len=2048, cache_dtype=cache_dtype,
                    decode_chunk=decode_chunk,
                    generator=torch.Generator(device=model.device).manual_seed(5))
    reqs = dense_requests(rng, model.config.vocab_size, n_req, sampled_every)
    res = engine_run(model, "dense_engine", eng, [reqs], check)
    del eng
    torch.cuda.empty_cache()
    return res


def dense_engine_phase(model, card):
    import numpy as np

    rng = np.random.default_rng(10)
    runs = [serve_dense(model, REQUESTS, rng, None, 1, 4, True),
            serve_dense(model, INT8_REQUESTS, rng, "int8", 4, 0, True)]
    tick = decode_breakdown(model, "dense")
    log(f"  dense decode tick, 8 slots at ~1k context: {json.dumps(tick)} [{card}]")
    for r in runs:
        log_run(r, card)
    return runs, tick


# ------------------------------------------------------------ paged engine

@torch.no_grad()
def paged_logits(model, prompt, out, chunk=256, ps=128, split=None, verify=0):
    """The paged path's logits at each generated position of one request,
    teacher-forced: the prompt in prefill chunks (from 0, or, as a prefix
    hit of ``split`` tokens runs them, to ``split`` and from there), then one
    decode step for each generated token but the last, or with ``verify``
    = K verify steps of K + 1 rows, on a one-slot pool of the model's
    dtype.  Pad rows of the chunks and the rows a verify writes past the
    tokens stay in the pool, as the engine leaves them."""
    cfg, dev = model.config, model.device
    D = cfg.hidden_size // cfg.num_attention_heads
    Hkv = getattr(cfg, "num_key_value_heads", cfg.num_attention_heads)
    npg = -(-(len(prompt) + len(out) + chunk + verify) // ps)
    dt = next(model.parameters()).dtype
    pools = [tuple(torch.zeros(npg + 1, Hkv, ps, D, dtype=dt, device=dev) for _ in range(2))
             for _ in range(cfg.num_hidden_layers)]
    tbl = torch.arange(1, npg + 1, dtype=torch.int32, device=dev)[None]

    def caches(pos):
        p = torch.tensor([pos], dtype=torch.int64, device=dev)
        return [(k, v, p, tbl) for k, v in pools]

    n = len(prompt)
    starts = (list(range(0, n, chunk)) if split is None else
              list(range(0, split, chunk)) + list(range(split, n, chunk)))
    for done, end in zip(starts, starts[1:] + [n]):
        m = end - done
        ids = torch.zeros(1, chunk, dtype=torch.int64)  # the engine pads with 0
        ids[0, :m] = torch.tensor(prompt[done:done + m])
        logits, _ = model.prefill_chunk_step(ids.to(dev), caches(done), m - 1)
    rows = [logits[0, 0]]
    if verify:
        for i in range(0, len(out) - 1, verify + 1):
            blk = out[i:i + verify + 1]
            ids = torch.tensor([blk + [0] * (verify + 1 - len(blk))], device=dev)
            lg, _ = model.verify_step(ids, caches(n + i))
            rows += list(lg[0, :len(blk)])
        return torch.stack(rows[:len(out)]).float()
    for i, tok in enumerate(out[:-1]):
        logits, _ = model.generate_step(torch.tensor([[tok]], device=dev), caches(n + i))
        rows.append(logits[0, 0])
    return torch.stack(rows).float()


def serve_paged(model, n_req, rng, cache_dtype, sampled_every, check):
    reqs = []
    for i in range(n_req):
        n = int(rng.integers(64, 1501))
        reqs.append(dict(prompt=rng.integers(1, model.config.vocab_size, n).tolist(),
                         max_new=int(rng.integers(32, 65)), check=True,
                         sampled=sampled_every > 0 and i % sampled_every == sampled_every - 1))
    eng = paged_engine(model, prefix_cache=False, cache_dtype=cache_dtype)
    res = engine_run(model, "paged_engine", eng, [reqs], check)
    del eng
    torch.cuda.empty_cache()
    return res


def busy_engine(model, layout, spec_k=0, engine_kw=None, submit_kw=None):
    """An engine of either layout with all 8 slots decoding at about 1k
    tokens of context (verifying K drafts a tick with ``spec_k``);
    ``engine_kw`` goes to the engine, ``submit_kw(i)`` to request i's
    submit."""
    import numpy as np

    from paddle_tpu_torch.inference import LLMEngine

    kw = (dict(kv_layout="paged", page_size=128, prefill_chunk=256, prefix_cache=False)
          if layout == "paged" else {})
    eng = LLMEngine(model, max_batch_slots=8, max_seq_len=2048, spec_k=spec_k, **kw,
                    **(engine_kw or {}))
    rng = np.random.default_rng(1)
    # a verify tick emits up to K + 1 tokens a slot: room for the 32 ticks
    # of the 8 admissions and the measured ticks, so no slot finishes early
    for i in range(8):
        eng.submit(rng.integers(1, model.config.vocab_size, 1000).tolist(),
                   max_new_tokens=96 * (spec_k + 1), **(submit_kw(i) if submit_kw else {}))
    for _ in range(64):  # prefill every prompt
        if eng.stats()["active_slots"] == 8:
            return eng
        eng.step()
    raise RuntimeError(f"busy_engine: {eng.stats()['active_slots']} of 8 slots active")


def tick_ms(eng, ticks):
    """Host wall per decode tick, unprofiled, over ``ticks`` ticks."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        eng.step()
    return (time.perf_counter() - t0) * 1e3 / ticks


def decode_breakdown(model, layout, ticks=8, spec_k=0, **busy):
    """Where one decode (or, with ``spec_k``, verify) tick's time goes with
    all 8 slots busy (``busy``: busy_engine's engine_kw and submit_kw): host
    wall per tick (unprofiled, then under torch.profiler) and the device
    time of the kernels the ticks ran, by kind.  Informational: a profiler
    that records no device events gives "not measured", not a failure."""
    eng = busy_engine(model, layout, spec_k, **busy)
    res = dict(layout=layout, spec_k=spec_k, ticks=ticks, slots=8,
               wall_ms_per_tick=tick_ms(eng, ticks))
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            res["profiled_wall_ms_per_tick"] = tick_ms(eng, ticks)
        kern = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        by_kind, by_name = {}, {}
        for e in kern:
            us = e.time_range.elapsed_us()
            low = e.name.lower()
            kind = ("attention" if "kv_attention" in low else
                    "matmul" if any(w in low for w in ("gemm", "gemv", "nvjet", "xmma")) else
                    "other")
            by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3 / ticks
            by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3 / ticks
        if kern:
            busy = sum(by_kind.values())
            res.update(device_ms_per_tick=busy, kernels_per_tick=len(kern) / ticks,
                       device_ms_by_kind=by_kind,
                       busy_share=busy / res["profiled_wall_ms_per_tick"],
                       # the profiler slows the host: the same device time
                       # over the unprofiled wall
                       busy_share_unprofiled=busy / res["wall_ms_per_tick"],
                       top_kernels=sorted(by_name.items(), key=lambda kv: -kv[1])[:6])
        else:
            res["device_ms_per_tick"] = "not measured (no device events)"
    except Exception as e:  # noqa: BLE001 - a measurement, not a phase
        res["device_ms_per_tick"] = f"not measured ({e!r})"
    eng.stop()
    del eng
    torch.cuda.empty_cache()
    return res


def paged_engine_phase(model, card):
    import numpy as np

    rng = np.random.default_rng(0)
    runs = [serve_paged(model, REQUESTS, rng, None, 4, True),
            serve_paged(model, INT8_REQUESTS, rng, "int8", 0, False)]
    tick = decode_breakdown(model, "paged")
    log(f"  paged decode tick, 8 slots at ~1k context: {json.dumps(tick)} [{card}]")
    for r in runs:
        log_run(r, card)
    return runs, tick


def ticks_phase(model, card):
    """Both engines' decode ticks in turns (dense, paged, paged, dense),
    unprofiled, in one process: the spread between the turns of one layout
    bounds what a difference between the layouts can mean."""
    runs = []
    for layout in ("dense", "paged", "paged", "dense"):
        eng = busy_engine(model, layout)
        runs.append(dict(layout=layout, ticks=16, slots=8, wall_ms_per_tick=tick_ms(eng, 16)))
        eng.stop()
        del eng
        torch.cuda.empty_cache()
        log(f"  {layout:5s} decode tick, 8 slots at ~1k context: "
            f"{runs[-1]['wall_ms_per_tick']:.2f} ms [{card}]")
    return [], runs


# ------------------------------------------------- prefix cache and spec

SYSTEM_PROMPT = 1000  # shared tokens: 7 full pages of 128 and a 104-token tail


def prefix_requests(rng, vocab, n, system, check_every=2, tails=(64, 300), new=(16, 24)):
    return [dict(prompt=system + rng.integers(1, vocab, int(rng.integers(*tails) + 1)).tolist(),
                 max_new=int(rng.integers(new[0], new[1] + 1)), sampled=False,
                 check=i % check_every == 0) for i in range(n)]


def prefix_phase(model, card):
    """The paged engine with its default prefix cache: the 1,000-token
    system prompt alone (it leaves a 104-token partial tail in the cache),
    then 16 requests on it in two waves of 8, each hitting 1,000 tokens off
    the page grid and forking the tail page; the same traffic with the
    cache off; 4 requests on an int8 pool; and a 9-page pool in which a
    prefill takes a cached tail back (steal-back) and an admission evicts."""
    import numpy as np

    vocab = model.config.vocab_size
    rng = np.random.default_rng(20)
    system = rng.integers(1, vocab, SYSTEM_PROMPT).tolist()
    reqs = prefix_requests(rng, vocab, 16, system)
    waves = [[dict(prompt=system, max_new=8, sampled=False, check=True)], reqs[:8], reqs[8:]]
    split = lambda r: SYSTEM_PROMPT  # noqa: E731 - the hit's chunk grid
    runs = [engine_run(model, "prefix_on", paged_engine(model), waves, True, split)]
    st = runs[0]["prefix_cache"]
    runs[0]["ok"] &= st["hit_tokens"] > 0 and st["cow_copies"] > 0
    off = engine_run(model, "prefix_off", paged_engine(model, prefix_cache=False),
                     [[dict(r, check=False) for r in w] for w in waves], False)
    off["tokens_equal_cache_on"] = sum(a == b for a, b in zip(off["outputs"],
                                                             runs[0]["outputs"]))
    runs.append(off)
    int8 = prefix_requests(rng, vocab, 4, system, check_every=99)
    runs.append(engine_run(model, "prefix_on", paged_engine(model, cache_dtype="int8"),
                           [[dict(prompt=system, max_new=8, sampled=False)], int8], False))
    runs[-1]["ok"] &= runs[-1]["prefix_cache"]["hit_tokens"] > 0
    runs.append(small_pool_run(model, rng, system))
    for r in runs:
        log_run(r, card, f"; prefix {r['prefix_cache']}" if r["prefix_cache"] else
                f"; {r.get('tokens_equal_cache_on')} of {r['requests']} equal to the cache-on run")
    return runs, None


def small_pool_run(model, rng, system):
    """9 allocatable pages: A (the 1,000-token system prompt) decodes from a
    forked copy of its cached tail page, which takes the last free page; B,
    the same prompt, maps all 8 cached pages, and its prefill must write
    into the tail page that only it and the cache hold, with no page free
    and every cached page pinned: it takes the page back from the cache
    (an eviction; its first decode write does so again, once its insert
    cached the page anew).  Then C, another 1,000 tokens, evicts A's
    cached chain."""
    vocab = model.config.vocab_size
    eng = paged_engine(model, num_pages=10)
    warm = eng.warmup()
    a = dict(prompt=system, max_new=16, sampled=False, check=True)
    b = dict(prompt=system, max_new=12, sampled=False, check=True)
    c = dict(prompt=rng.integers(1, vocab, SYSTEM_PROMPT).tolist(), max_new=8, sampled=False,
             check=True)
    zero_counts()
    t0 = time.perf_counter()
    fa = eng.submit(a["prompt"], max_new_tokens=a["max_new"])
    balanced = True
    while eng.stats()["prefix_cache"]["cow_copies"] == 0 and not fa.done():
        eng.step()  # until A forks its tail page, decoding
        balanced &= pool_balanced(eng)
    fb = eng.submit(b["prompt"], max_new_tokens=b["max_new"])
    while not (fa.done() and fb.done()):
        eng.step()
        balanced &= pool_balanced(eng)
    steal_backs = eng.stats()["prefix_cache"]["evictions"]
    outs, bal = drive(eng, [c])
    outs = [fa.result(), fb.result()] + outs
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    st = eng.stats()
    L = model.config.num_hidden_layers
    expected = {"paged_attention": L * (st["prefill_chunks"] + st["decode_ticks"])}
    reqs = [a, b, c]
    res = dict(path="prefix_small_pool", cache="bf16", requests=3, warmup_s=warm, wall_s=wall,
               launches=launches, expected_launches=expected,
               prefill_chunks=st["prefill_chunks"], decode_ticks=st["decode_ticks"],
               decode_tokens=st["decode_tokens"], prefill_s=st["prefill_seconds"],
               decode_s=st["decode_seconds"],
               decode_tok_per_s=st["decode_tokens"] / max(st["decode_seconds"], 1e-9),
               ttft_s=st["ttft_seconds"], prompt_tokens=3 * SYSTEM_PROMPT,
               preemptions=st["preemptions"], prefix_cache=st["prefix_cache"], spec=None,
               steal_backs=steal_backs, pool_balanced_every_tick=balanced and bal,
               drained_to_cache=(st["kv_pages_in_use"] == 0 and int(eng._page_ref.sum())
                                 == st["prefix_cache"]["cached_pages"]),
               outputs=outs)
    res["teacher_forced"] = judge(
        [(o, forward_logits(model, r["prompt"], o),
          paged_logits(model, r["prompt"], o, split=999 if r is b else None))
         for r, o in zip(reqs, outs)], LOGIT_TOL)
    res["ok"] = (launch_check(launches, expected) and res["pool_balanced_every_tick"]
                 and res["drained_to_cache"] and steal_backs >= 1
                 and st["prefix_cache"]["evictions"] > steal_backs
                 and res["teacher_forced"]["ok"]
                 and all(len(o) == r["max_new"] for o, r in zip(outs, reqs)))
    del eng
    torch.cuda.empty_cache()
    return res


@torch.no_grad()
def extractive_requests(model, rng, n, check_every=2):
    """Prompts that quote text the model goes on to produce: a random 64-token
    seed, its greedy continuation G (generate, 160 tokens), then the seed
    again and G's first 16 tokens: the rest of G is what a copy would
    draft."""
    vocab = model.config.vocab_size
    seeds = torch.tensor(rng.integers(1, vocab, (n, 64)), device=model.device)
    g = model.generate(seeds, max_new_tokens=160).tolist()
    return [dict(prompt=s + gi + s + gi[:16], max_new=32, sampled=False,
                 check=i % check_every == 0)
            for i, (s, gi) in enumerate(zip(seeds.tolist(), g))]


def spec_phase(model, card):
    """Speculative decoding at spec_k=4 with the n-gram drafter: the paged
    engine on 8 extractive requests and 4 of random tokens, each against
    the same traffic at spec_k=0; the dense engine on bf16 and int8 caches;
    generate(spec_k=4) on ids [4, 512]."""
    import numpy as np

    K = 4
    vocab = model.config.vocab_size
    rng = np.random.default_rng(30)
    kinds = {"extractive": extractive_requests(model, rng, 8),
             "random": [dict(prompt=rng.integers(1, vocab, int(rng.integers(200, 800))).tolist(),
                             max_new=32, sampled=False, check=i % 2 == 0) for i in range(4)]}
    runs = []
    for kind, reqs in kinds.items():
        pair = []
        for k in (K, 0):
            r = engine_run(model, f"spec_paged_{kind}_k{k}", paged_engine(model, spec_k=k),
                           [reqs], k > 0, verify=k)
            pair.append(r)
        spec, plain = pair
        spec["tokens_equal_spec0"] = sum(a == b for a, b in zip(spec["outputs"],
                                                                plain["outputs"]))
        spec["decode_speedup"] = spec["decode_tok_per_s"] / plain["decode_tok_per_s"]
        if kind == "extractive":
            spec["ok"] &= spec["spec"]["accepted_tokens"] > 0
        runs += pair
    for cache_dtype in (None, "int8"):
        from paddle_tpu_torch.inference import LLMEngine

        reqs = [dict(prompt=rng.integers(1, vocab, int(rng.integers(100, 1500))).tolist(),
                     max_new=24, sampled=False, check=i < 2) for i in range(4)]
        eng = LLMEngine(model, max_batch_slots=8, max_seq_len=2048, cache_dtype=cache_dtype,
                        spec_k=K, generator=torch.Generator(device=model.device).manual_seed(5))
        runs.append(engine_run(model, "spec_dense", eng, [reqs], cache_dtype is None))
    runs.append(spec_generate_run(model, rng, K))
    # a verify tick against a decode tick, 8 busy slots of random prompts
    ticks = [decode_breakdown(model, "paged", spec_k=k) for k in (K, 0)]
    for t in ticks:
        log(f"  paged {'verify' if t['spec_k'] else 'decode'} tick, 8 slots at ~1k context: "
            f"{json.dumps(t)} [{card}]")
    for r in runs:
        if r["path"] == "spec_generate":
            continue
        sp = r["spec"]
        extra = (f"; spec {sp}, {r.get('tokens_equal_spec0')} of {r['requests']} equal to "
                 f"spec_k=0, decode speedup {r.get('decode_speedup')}" if sp else "")
        log_run(r, card, extra)
    return runs, ticks


def spec_generate_run(model, rng, K, B=4, S0=512, n_new=32):
    """generate(spec_k=K) on ids [B, S0]: every verify through the static
    decode kernel at S = K + 1, the prefill through the encoder kernel."""
    cfg = model.config
    ids = torch.tensor(rng.integers(1, cfg.vocab_size, (B, S0)), device=model.device)
    calls = [0]
    verify = model.verify_step

    def counted(*a, **kw):
        calls[0] += 1
        return verify(*a, **kw)

    model.verify_step = counted
    try:
        model.generate(ids[:, :8], max_new_tokens=2, spec_k=K)
        torch.cuda.synchronize()
        calls[0] = 0
        zero_counts()                                    # the run starts here
        t0 = time.perf_counter()
        out = model.generate(ids, max_new_tokens=n_new, spec_k=K)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()                         # ... and ends here
    finally:
        del model.verify_step
    L = cfg.num_hidden_layers
    expected = {"decode_attention": L * calls[0]}
    kern = prefill_kernel(cfg, B, S0)
    if kern:
        expected[kern] = L
    plain = model.generate(ids, max_new_tokens=n_new)
    path = static_path_logits(model, ids[:2], out[:2], None)
    verdict = judge([(out[b].tolist(), forward_logits(model, ids[b].tolist(), out[b].tolist()),
                      path[b]) for b in range(2)], LOGIT_TOL)
    res = dict(path="spec_generate", name=f"b{B}_s{S0}_k{K}", B=B, prompt=S0,
               new_tokens=n_new, cache="bf16", verify_calls=calls[0], wall_s=wall,
               tok_per_s=B * (n_new - 1) / wall, launches=launches, expected_launches=expected,
               rows_equal_spec0=int((out == plain).all(1).sum()), teacher_forced=verdict)
    res["ok"] = (launch_check(launches, expected) and tuple(out.shape) == (B, n_new)
                 and verdict["ok"])
    log(f"  spec generate {res['name']}: {calls[0]} verify calls, wall {wall:.3f} s "
        f"({res['tok_per_s']:.1f} tok/s incl. prefill); launches {launches} (expected "
        f"{expected}); {res['rows_equal_spec0']} of {B} rows equal to spec_k=0; argmax "
        f"{verdict['exact']} exact, {verdict['near_ties']} near-ties, {verdict['failures']} "
        f"failures; {'ok' if res['ok'] else 'FAIL'}")
    return res


# ------------------------------------------------- multi-tenant serving

# The tenants phase: 4 adapters of rank 16 on every LLaMA site, in a pool of
# 3 usable pages, so admissions wait for a page and LRU eviction runs.
TENANT_RANK, TENANT_POOL_PAGES, TENANT_ADAPTERS = 16, 3, 4
# The adapters' scale: with standard-normal A [d_in, 16] and B [16, d_out]
# the delta's largest gain is about scale (sqrt(d_in) + 4)^2, 4.6 at 1e-3
# and d_in 4096 (the Xavier-initialised base projection's is about 2), and
# its entries about 4 sqrt(d_in) scale |x|, a quarter of the base output's:
# the adapters change the tokens.  At 4e-3 (a gain of 18) the model
# amplifies rounding along the adapters' 16 directions, and two sound bf16
# paths (the paged engine's, dense math) drift apart by 0.13-0.45 in the
# logits; at 1e-3 and below they drift as the base model's do (0.035-0.039
# against 0.033; tools/tenant_drift.py on an H100).
TENANT_SCALE = 1e-3
# The deterministic vocabulary's alphabet: digits, letters and the JSON
# punctuation the grammars below need.
TENANT_ALPHABET = '0123456789abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ{}[]:,"-. _'
# Bounded grammars, so every constrained request must reach eos within its
# new tokens: a phone number, and a JSON object of a boolean, an enum and a
# null (at most 37 characters: {"ok":false,"kind":"emu","note":null}).
TENANT_REGEX = "[0-9][0-9][0-9]-[0-9][0-9][0-9][0-9]"
TENANT_SCHEMA = {"type": "object", "properties": {
    "ok": {"type": "boolean"}, "kind": {"enum": ["cat", "dog", "emu"]},
    "note": {"type": "null"}}}
# The 12 requests: (adapter, constraint).
TENANT_MIX = [(None, None), ("a0", None), ("a1", "regex"), ("a2", None), (None, "schema"),
              ("a3", None), ("a0", "schema"), (None, "regex"), ("a1", None),
              ("a3", "schema"), ("a2", "regex"), (None, None)]
# The direct check of the LoRA epilogue (bf16 activations and pages, bf16
# products with f32 accumulation, the rank-16 intermediate rounded to bf16)
# against float32 math on the adapter's own float32 weights: each rounding
# is at most 2^-9 of its value, so a few parts in a thousand of max |ref|.
LORA_RTOL = 1e-2


def tenant_vocab(vocab_size, seed=0):
    """A deterministic id -> string map without a tokenizer: each alphabet
    character alone first (so any grammar over the alphabet can finish),
    then strings of 1-3 characters from ``seed``; ``</s>`` at the last id,
    the eos."""
    import numpy as np

    rng = np.random.default_rng(seed)
    chars = list(TENANT_ALPHABET)
    words = ["".join(rng.choice(chars, int(rng.integers(1, 4))))
             for _ in range(vocab_size - len(chars) - 1)]
    return chars + words + ["</s>"]


def adapters_balanced(eng):
    """Each adapter's pin count equals the live requests holding its page
    (the slots and the one mid-prefill), and each holder's page is the
    registry's page for its adapter."""
    reg, held = eng.adapters, {}
    live = list(eng.slot_req) + ([eng._prefilling[0]] if eng._prefilling is not None else [])
    for r in live:
        if r is not None and r.adapter_page:
            if reg._page_of.get(r.adapter_id) != r.adapter_page:
                return False
            held[r.adapter_id] = held.get(r.adapter_id, 0) + 1
    return (all(ref == held.get(aid, 0) for aid, ref in reg._ref.items())
            and not set(held) - set(reg._ref))


def constraint_masks(tc, toks, device):
    """The allowed-token masks [n, V] (bool, on ``device``) in force at
    each of ``toks`` and whether the automaton accepted every token."""
    cur, rows, ok = tc.cursor(), [], True
    for t in toks:
        rows.append(torch.from_numpy(cur.mask().copy()))
        ok &= cur.advance(t)
    return torch.stack(rows).to(device), ok


def lora_epilogue_check(reg, adapters):
    """The LoRA epilogue alone at the decode shape, 8 rows over the pool's
    pages and the zero page, against float32 math on the adapters' own
    float32 weights: x.A.(scale B) a row."""
    from paddle_tpu_torch.ops.lora import lora_epilogue

    dev = reg.pool.device
    g = torch.Generator(device=dev).manual_seed(3)
    cases = []
    for site in ("q", "down"):
        a_pool, b_pool = reg.pool.site_pools()[site]
        x = torch.randn(8, 1, a_pool.shape[1], generator=g, device=dev).to(torch.bfloat16)
        ids = [aid for aid in sorted(adapters) if reg.page_for(aid)]
        rows = [reg.page_for(ids[i % len(ids)]) if i % 4 else 0 for i in range(8)]
        got = lora_epilogue(x, a_pool, b_pool, torch.tensor(rows, device=dev)).float()
        by_page = {reg.page_for(aid): aid for aid in ids}
        want = torch.zeros_like(got)
        for i, p in enumerate(rows):
            if p:
                a, b = (torch.from_numpy(w).to(dev) for w in adapters[by_page[p]].weights[site])
                want[i] = x[i].float() @ a @ b
        err = (got - want).abs().max().item() / want.abs().max().item()
        cases.append(dict(site=site, rows=rows, rel_err=err, zero_rows_exact=all(
            not got[i].any() for i, p in enumerate(rows) if p == 0)))
    return dict(cases=cases, tol=LORA_RTOL,
                ok=all(c["rel_err"] <= LORA_RTOL and c["zero_rows_exact"] for c in cases))


def tenants_phase(model, card):
    """Multi-tenant serving through the paged engine: 12 requests mixing the
    base model, 4 adapters in a 3-page pool and regex- and JSON-schema-
    constrained traffic over a 32,000-entry vocabulary; then decode ticks of
    8 busy slots with adapters, without, and constrained."""
    import numpy as np

    from paddle_tpu_torch.inference.constrain import compile_constraint
    from paddle_tpu_torch.models.lora import AdapterRegistry, LoraAdapter, lora_sites
    from paddle_tpu_torch.ops import lora as oplora

    cfg, dev = model.config, model.device
    V, L = cfg.vocab_size, cfg.num_hidden_layers
    eos = V - 1
    vocab = tenant_vocab(V)
    t0 = time.perf_counter()
    grammars = {"regex": compile_constraint(TENANT_REGEX, vocab, eos),
                "schema": compile_constraint(TENANT_SCHEMA, vocab, eos)}
    compile_s = time.perf_counter() - t0
    sites = lora_sites(model)
    adapters = {f"a{i}": LoraAdapter.random(sites, TENANT_RANK, seed=200 + i, scale=TENANT_SCALE)
                for i in range(TENANT_ADAPTERS)}
    reg = AdapterRegistry(model, max_adapters=TENANT_POOL_PAGES, rank=TENANT_RANK)
    for aid, ad in adapters.items():
        reg.register(aid, ad)
    rng = np.random.default_rng(50)
    reqs = [dict(prompt=rng.integers(1, eos, int(rng.integers(64, 401))).tolist(),
                 adapter=aid, kind=kind, constraint=grammars.get(kind), sampled=False,
                 max_new={"schema": 48, "regex": 16}.get(kind, 24), check=i % 2 == 0)
            for i, (aid, kind) in enumerate(TENANT_MIX)]
    eng = paged_engine(model, adapters=reg, constraint_vocab=vocab, eos_token_id=eos)
    warm = eng.warmup()
    zero_counts()                                        # the run starts here
    t0 = time.perf_counter()
    outs, balanced = drive(eng, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()                             # ... and ends here
    st = eng.stats()
    expected = {"paged_attention": L * (st["prefill_chunks"] + st["decode_ticks"])}
    # every constrained output: accepted token by token, ended by eos, and
    # its text the grammar's (the phone regex; JSON with the schema's keys)
    grammar_ok, texts = True, []
    for r, o in zip(reqs, outs):
        if r["kind"] is None:
            continue
        _, ok = constraint_masks(r["constraint"], o, dev)
        text = "".join(vocab[t] for t in o[:-1])
        texts.append(text)
        ok &= o[-1] == eos
        if r["kind"] == "regex":
            ok &= re.fullmatch(TENANT_REGEX, text) is not None
        else:
            try:
                obj = json.loads(text)
                ok &= (list(obj) == ["ok", "kind", "note"] and isinstance(obj["ok"], bool)
                       and obj["kind"] in ("cat", "dog", "emu") and obj["note"] is None)
            except ValueError:
                ok = False
        grammar_ok &= bool(ok)
    # every second request: the teacher-forced paged path against the
    # dense-math forward under the same adapter page, and solo generate()'s
    # tokens, equal up to a divergence at a near-tie
    cases, solo, adapter_drift = [], [], 0.0
    for r, o in zip(reqs, outs):
        if not r["check"]:
            continue
        tc = r["constraint"]
        page = reg.acquire(r["adapter"])
        try:
            with (oplora.activate(reg.pool.site_pools(), torch.tensor([page], device=dev))
                  if page else contextlib.nullcontext()):
                want = forward_logits(model, r["prompt"], o)
                path = paged_logits(model, r["prompt"], o)
        finally:
            reg.release(r["adapter"])
        if page:
            adapter_drift = max(adapter_drift, (want - path).abs().max().item())
        allowed = constraint_masks(tc, o, dev)[0] if tc is not None else None
        cases.append((o, want, path, allowed))
        s = model.generate(torch.tensor([r["prompt"]], device=dev), max_new_tokens=r["max_new"],
                           eos_token_id=eos, kv_layout="paged", page_size=128,
                           adapter_id=r["adapter"], adapters=reg, token_mask_fn=tc)[0].tolist()
        s = s[:s.index(eos) + 1] if eos in s else s
        solo.append((o, s, want, allowed))
    verdict = judge(cases, LOGIT_TOL)
    solo_equal = solo_tie = solo_bad = 0
    for o, s, want, allowed in solo:
        j = next((i for i, (a, b) in enumerate(zip(o, s)) if a != b), None)
        if j is None and len(o) == len(s):
            solo_equal += 1
            continue
        j = min(len(o), len(s)) - 1 if j is None else j
        w = want[j] if allowed is None else want[j].masked_fill(~allowed[j], float("-inf"))
        top2 = w.topk(2).values
        if (top2[0] - top2[1]).item() < verdict["tie_tol"]:
            solo_tie += 1
        else:
            solo_bad += 1
    epilogue = lora_epilogue_check(reg, adapters)
    res = dict(path="tenants", dtype=TAGS[model_dtype(model)], cache="bf16", requests=len(reqs),
               warmup_s=warm, wall_s=wall, constraint_compile_s=compile_s,
               launches=launches, expected_launches=expected,
               prefill_chunks=st["prefill_chunks"], decode_ticks=st["decode_ticks"],
               decode_tokens=st["decode_tokens"], prefill_s=st["prefill_seconds"],
               decode_s=st["decode_seconds"],
               decode_tok_per_s=st["decode_tokens"] / max(st["decode_seconds"], 1e-9),
               ttft_s=st["ttft_seconds"], adapters=st["adapters"],
               constrained_tokens=st["constrained_tokens"],
               constraint_rejects=st["constraint_rejects"], constrained_texts=texts,
               pool_balanced_every_tick=balanced,
               drained=st["kv_pages_in_use"] == 0 and st["adapters"]["pages_pinned"] == 0,
               grammar_ok=grammar_ok, teacher_forced=verdict,
               adapter_row_max_logit_drift=adapter_drift,
               solo=dict(compared=len(solo), equal=solo_equal, near_tie_divergence=solo_tie,
                         failures=solo_bad),
               lora_epilogue=epilogue,
               valid_ids=all(0 <= t < V for o in outs for t in o))
    res["ok"] = (launch_check(launches, expected) and balanced and res["drained"] and grammar_ok and verdict["ok"] and solo_bad == 0
                 and adapter_drift <= LOGIT_TOL and epilogue["ok"] and res["valid_ids"]
                 and st["constraint_rejects"] == 0 and st["adapters"]["evictions"] > 0)
    del eng
    torch.cuda.empty_cache()
    log(f"  tenants: {len(reqs)} req ({sum(r['adapter'] is not None for r in reqs)} on "
        f"{TENANT_ADAPTERS} adapters in {TENANT_POOL_PAGES} pages, "
        f"{sum(r['kind'] is not None for r in reqs)} constrained), "
        f"{st['prefill_chunks']} prefills in {st['prefill_seconds']:.3f} s, "
        f"{st['decode_tokens']} decode tok at {res['decode_tok_per_s']:.1f} tok/s, wall "
        f"{wall:.1f} s; adapters {st['adapters']}; launches {launches} (expected {expected}); "
        f"balanced {balanced}; grammars {grammar_ok} {texts}; teacher-forced "
        f"drift max {verdict['max_logit_drift']:.4f} (adapter rows {adapter_drift:.4f}, tol "
        f"{LOGIT_TOL}), {verdict['exact']} exact, {verdict['near_ties']} near-ties, "
        f"{verdict['failures']} failures; solo {res['solo']}; epilogue "
        f"{[(c['site'], round(c['rel_err'], 6)) for c in epilogue['cases']]} (tol "
        f"{LORA_RTOL}); constraints compiled in {compile_s:.2f} s; "
        f"{'ok' if res['ok'] else 'FAIL'} [{card}]")
    ticks = tenant_ticks(model, reg, vocab, eos, card)
    return [res], ticks


def tenant_ticks(model, reg, vocab, eos, card):
    """Decode ticks of 8 busy slots: on 3 adapters against the base model
    (the LoRA epilogue's share of the device time is their difference), and
    constrained against unconstrained (wall a tick: the masks' upload and
    the automata on the host)."""
    rows = dict(engine_kw=dict(adapters=reg),
                submit_kw=lambda i: dict(adapter_id=f"a{i % TENANT_POOL_PAGES}"))
    lora = decode_breakdown(model, "paged", **rows)
    base = decode_breakdown(model, "paged", engine_kw=dict(adapters=reg))
    out = dict(lora=lora, base=base)
    if isinstance(lora.get("device_ms_per_tick"), float) and isinstance(
            base.get("device_ms_per_tick"), float):
        out["lora_epilogue_device_ms"] = lora["device_ms_per_tick"] - base["device_ms_per_tick"]
        out["lora_epilogue_share"] = out["lora_epilogue_device_ms"] / lora["device_ms_per_tick"]
    walls = {}
    for name, kw in (("constrained", dict(constraint="[0-9a-z]+")), ("unconstrained", {})):
        eng = busy_engine(model, "paged", engine_kw=dict(constraint_vocab=vocab, eos_token_id=eos),
                          submit_kw=lambda i, kw=kw: kw)
        walls[name] = tick_ms(eng, 16)
        out[f"{name}_active_slots"] = eng.stats()["active_slots"]
        eng.stop()
        del eng
        torch.cuda.empty_cache()
    out.update(constrained_wall_ms=walls["constrained"], unconstrained_wall_ms=walls["unconstrained"])
    log(f"  tenant ticks, 8 slots at ~1k context: {json.dumps(out)} [{card}]")
    return out


# --------------------------------------------------------- the kv tiers

TIER_HOST_PAGES, TIER_DISK_PAGES = 16, 64
# The disk runs keep 2 pages on the host, so the system prompt's 8 staged
# pages mostly spill.
TIER_SMALL_HOST = 2


def tiers_balanced(eng):
    """The host tier within its capacity with its bytes counted, every disk
    entry a committed file, no partial-tail entry pointing at nothing."""
    import os

    pool = eng._host_kv
    st = pool.stats()
    return bool(st["host_entries"] == len(pool._host) <= pool.host_pages
                and st["host_bytes"] == sum(pool._entry_bytes(e) for e in pool._host.values())
                and st["disk_entries"] == len(pool._disk) <= pool.disk_pages
                and all(os.path.exists(rec["path"]) for rec in pool._disk.values())
                and all(keys and all(k in pool for k in keys)
                        for keys in pool._partials.values()))


def cached_pages(eng):
    """{prefix key: the page's rows in every layer's pools, on the host}."""
    return {key: [x[page].cpu() for c in eng.caches for x in c]
            for key, _, page, _, _ in eng._prefix.lru_entries()}


def chain_keys(prompt, ps):
    """The prefix cache's keys of ``prompt``'s full blocks, in order."""
    import numpy as np

    from paddle_tpu_torch.inference.prefix_cache import _root_key, chained_block_key

    p, key, out = np.asarray(prompt, np.int32), _root_key(None), []
    for i in range(len(p) // ps):
        key = chained_block_key(key, p[i * ps:(i + 1) * ps].tobytes())
        out.append(key)
    return out


def tier_oracle(model, a, b, cache_dtype):
    """The same traffic without the tiers: A (the system prompt), then B
    hitting it in HBM (B's tokens, the oracle), then B again after every
    cached page was evicted: a full re-prefill, its TTFT."""
    eng = paged_engine(model, cache_dtype=cache_dtype)
    eng.warmup()
    drive(eng, [a])
    (tokens,), _ = drive(eng, [b])
    hit_ttft = eng._ttfts[-1]
    assert eng._evict_prefix(int(eng._page_cached.sum()))
    chunks = eng.stats()["prefill_chunks"]
    drive(eng, [b])
    res = dict(tokens=tokens, hbm_hit_ttft_s=hit_ttft, reprefill_ttft_s=eng._ttfts[-1],
               reprefill_chunks=eng.stats()["prefill_chunks"] - chunks)
    del eng
    torch.cuda.empty_cache()
    return res


def tier_run(model, name, a, b, c, cache_dtype, oracle, spill_dir):
    """A (the system prompt alone), then every cached page demoted
    (``demote_step(force=True)``) and its HBM copy evicted; then B, which
    can hit only by promotion from the host tier (or, with ``spill_dir``,
    mostly from disk).  With ``c``: B's pages demoted and evicted as well,
    one spill of the system prompt's chain corrupted, and C, which must
    fall back to re-prefill from the block before it."""
    import numpy as np

    disk = spill_dir is not None
    eng = paged_engine(model, cache_dtype=cache_dtype,
                       host_cache_pages=TIER_SMALL_HOST if disk else TIER_HOST_PAGES,
                       disk_cache_dir=spill_dir, disk_cache_pages=TIER_DISK_PAGES if disk else 0)
    warm = eng.warmup()
    L, ps = model.config.num_hidden_layers, eng.ps
    _, balanced = drive(eng, [a])
    staged_bytes = cached_pages(eng)
    page_bytes = sum(x.nbytes for x in next(iter(staged_bytes.values())))

    def demote_all():
        t0, n = time.perf_counter(), 0
        while True:
            k = eng.demote_step(force=True)
            if not k:
                break
            n += k
        return n, time.perf_counter() - t0

    demoted, demote_s = demote_all()
    balanced &= pool_balanced(eng)
    assert eng._evict_prefix(int(eng._page_cached.sum()))
    promote = eng._promote_from_tiers
    timing = dict(pages=0, s=0.0)

    def timed_promote(req):
        t0 = time.perf_counter()
        n = promote(req)
        torch.cuda.synchronize()
        timing["pages"] += n
        timing["s"] += time.perf_counter() - t0
        return n

    eng._promote_from_tiers = timed_promote
    st0 = st_w = eng.stats()
    zero_counts()                                        # the run starts here
    t0 = time.perf_counter()
    (out_b,), bal = drive(eng, [b])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    balanced &= bal
    st = eng.stats()
    hit_b = st["prefix_cache"]["hit_tokens"] - st0["prefix_cache"]["hit_tokens"]
    chunks_b = st["prefill_chunks"] - st0["prefill_chunks"]
    ttft_b = eng._ttfts[-1]
    tiers = st["prefix_cache"]["tiers"]
    promoted_equal = all(
        eng._prefix.node_info(k) is not None and all(
            torch.equal(x[eng._prefix.node_info(k)[0]].cpu(), y)
            for x, y in zip((x for cc in eng.caches for x in cc), rows))
        for k, rows in staged_bytes.items())
    res = dict(path="tiers", name=name, dtype=TAGS[model_dtype(model)],
               cache=cache_dtype or "bf16", tier="disk" if disk else "host", requests=1,
               warmup_s=warm, wall_s=wall, page_mib=page_bytes / 2**20, demoted_pages=demoted,
               demote_ms_per_page=demote_s * 1e3 / max(demoted, 1),
               demote_gb_per_s=demoted * page_bytes / demote_s / 1e9 if demoted else 0.0,
               promoted_pages=timing["pages"],
               promote_ms_per_page=timing["s"] * 1e3 / max(timing["pages"], 1),
               promote_gb_per_s=(timing["pages"] * page_bytes / timing["s"] / 1e9
                                 if timing["pages"] else 0.0),
               hit_tokens=hit_b, prefill_chunks_b=chunks_b,
               expected_chunks_b=-(-(len(b["prompt"]) - hit_b) // eng.prefill_chunk),
               ttft_promotion_s=ttft_b, ttft_reprefill_s=oracle["reprefill_ttft_s"],
               ttft_hbm_hit_s=oracle["hbm_hit_ttft_s"], reprefill_chunks=oracle["reprefill_chunks"],
               promoted_equal_demoted=promoted_equal, tokens_equal_tierless=out_b == oracle["tokens"],
               tiers=tiers)
    ok = (promoted_equal and res["tokens_equal_tierless"] and hit_b >= SYSTEM_PROMPT - 1
          and tiers["host"]["hit_tokens"] + tiers["disk"]["hit_tokens"] == hit_b
          and chunks_b == res["expected_chunks_b"] and timing["pages"] == demoted
          and (not disk or tiers["disk"]["loads"] > 0))
    if c is not None:
        # B's own pages go to the tiers as well; then one spill of the
        # system prompt's chain (a disk page past the first) is corrupted
        more, _ = demote_all()
        assert eng._evict_prefix(int(eng._page_cached.sum()))
        pool = eng._host_kv
        keys = chain_keys(a["prompt"], ps)
        j = next(i for i, k in enumerate(keys) if i > 0 and pool.tier_of(k) == "disk")
        path = pool._disk[keys[j]]["path"]
        with open(path, "r+b") as f:
            f.seek(-4096, 2)
            byte = f.read(1)
            f.seek(-4096, 2)
            f.write(bytes([byte[0] ^ 1]))
        st0 = eng.stats()
        (out_c,), bal = drive(eng, [c])
        balanced &= bal
    launches = read_counts()                             # ... and ends here
    st = eng.stats()
    expected = {"paged_attention": L * (st["prefill_chunks"] - st_w["prefill_chunks"]
                                        + st["decode_ticks"] - st_w["decode_ticks"])}
    if c is not None:
        hit_c = st["prefix_cache"]["hit_tokens"] - st0["prefix_cache"]["hit_tokens"]
        chunks_c = st["prefill_chunks"] - st0["prefill_chunks"]
        tf = judge([(out_c, forward_logits(model, c["prompt"], out_c),
                     paged_logits(model, c["prompt"], out_c, split=hit_c or None))], LOGIT_TOL)
        res.update(corrupted_block=j, quarantined=st["prefix_cache"]["tiers"]["disk"]["quarantined"],
                   hit_tokens_c=hit_c, prefill_chunks_c=chunks_c,
                   expected_chunks_c=-(-(len(c["prompt"]) - hit_c) // eng.prefill_chunk),
                   teacher_forced_c=tf, demoted_after_b=more)
        ok &= (res["quarantined"] == 1 and hit_c == j * ps and chunks_c == res["expected_chunks_c"]
               and tf["ok"])
    res.update(launches=launches, expected_launches=expected, pool_balanced_every_tick=balanced,
               drained=st["kv_pages_in_use"] == 0)
    res["ok"] = bool(ok and balanced and res["drained"] and launch_check(launches, expected))
    del eng
    torch.cuda.empty_cache()
    return res


def tiers_phase(model, card):
    """The host and disk kv tiers through the paged engine, at bf16 and on
    int8 caches: the 1,000-token system prompt demoted, evicted from HBM
    and promoted back for a request on it, against the same traffic
    without the tiers; on disk at bf16, also a corrupted spill."""
    import shutil
    import tempfile

    import numpy as np

    vocab = model.config.vocab_size
    rng = np.random.default_rng(60)
    system = rng.integers(1, vocab, SYSTEM_PROMPT).tolist()
    a = dict(prompt=system, max_new=8, sampled=False)
    b = dict(prompt=system + rng.integers(1, vocab, 150).tolist(), max_new=16, sampled=False)
    c = dict(prompt=system + rng.integers(1, vocab, 120).tolist(), max_new=16, sampled=False)
    runs = []
    spill = tempfile.mkdtemp(prefix="kv_tiers_")
    try:
        for cache_dtype in (None, "int8"):
            oracle = tier_oracle(model, a, b, cache_dtype)
            for disk in (False, True):
                name = f"{'disk' if disk else 'host'}_{cache_dtype or 'bf16'}"
                sub = None
                if disk:
                    sub = tempfile.mkdtemp(prefix=name + "_", dir=spill)
                runs.append(tier_run(model, name, a, b, c if disk and cache_dtype is None else None,
                                     cache_dtype, oracle, sub))
    finally:
        shutil.rmtree(spill, ignore_errors=True)
    for r in runs:
        extra = ""
        if "hit_tokens_c" in r:
            tf = r["teacher_forced_c"]
            extra = (f"; corrupted spill of block {r['corrupted_block']}: quarantined "
                     f"{r['quarantined']}, C hit {r['hit_tokens_c']} tokens, "
                     f"{r['prefill_chunks_c']} chunks (expected {r['expected_chunks_c']}), "
                     f"drift max {tf['max_logit_drift']:.4f}, {tf['failures']} failures")
        log(f"  tiers {r['name']}: {r['demoted_pages']} pages of {r['page_mib']:.2f} MiB demoted "
            f"at {r['demote_ms_per_page']:.2f} ms/page ({r['demote_gb_per_s']:.2f} GB/s), "
            f"{r['promoted_pages']} promoted at {r['promote_ms_per_page']:.2f} ms/page "
            f"({r['promote_gb_per_s']:.2f} GB/s); B hit {r['hit_tokens']} tokens, "
            f"{r['prefill_chunks_b']} chunks (expected {r['expected_chunks_b']}); TTFT promotion "
            f"{r['ttft_promotion_s'] * 1e3:.1f} ms vs re-prefill {r['ttft_reprefill_s'] * 1e3:.1f} "
            f"ms ({r['reprefill_chunks']} chunks; HBM hit {r['ttft_hbm_hit_s'] * 1e3:.1f} ms); "
            f"promoted == demoted {r['promoted_equal_demoted']}, tokens == tier-less "
            f"{r['tokens_equal_tierless']}; launches {r['launches']} (expected "
            f"{r['expected_launches']}); balanced {r['pool_balanced_every_tick']}{extra}; "
            f"{'ok' if r['ok'] else 'FAIL'} [{card}]")
    return runs, None


# ------------------------------------------------------------------ graphs

GRAPH_REQUESTS = 6  # requests a turn of an engine scenario
GRAPH_TENANTS = 8   # the first requests of TENANT_MIX


def graph_requests(rng, vocab, n=GRAPH_REQUESTS):
    """``n`` requests of 64-700 prompt tokens, every second one sampled."""
    return [dict(prompt=rng.integers(1, vocab, int(rng.integers(64, 701))).tolist(),
                 max_new=int(rng.integers(24, 41)), sampled=i % 2 == 1) for i in range(n)]


def graph_engine_run(model, name, make, reqs, eager, prep=None):
    """One turn of an engine scenario: a fresh engine (``make()``), then
    ``prep(eng)`` (traffic before the measured run), ``warmup()`` and
    ``engine_run``'s measured drive, eagerly under ``disable_graphs()`` or
    on graphs under ``check_syncs()`` (any synchronizing call in a
    program's staging or replay raises).  The engine may capture after
    warmup() only what the reference compiles lazily: another effective
    decode chunk, the dense full-length bucket; no key twice."""
    from paddle_tpu_torch.jit import check_syncs, disable_graphs

    with disable_graphs() if eager else check_syncs():
        eng = make()
        if prep is not None:
            prep(eng)
        t0 = time.perf_counter()
        eng.warmup()
        warm_s = time.perf_counter() - t0
        warm = len(eng.programs.captured)
        pool = None if eager else eng.programs.pool_bytes()
        res = engine_run(model, f"graphs_{name}", eng, [reqs], False)
    captured = eng.programs.captured
    late = captured[warm:]
    allowed = all(k[0] == "decode" or k == ("bucket", eng.L) for k in late)
    res.update(scenario=name, mode="eager" if eager else "graph", warmup_s=warm_s,
               captures_at_warmup=warm, lazy_captures=[repr(k) for k in late],
               capture_s=eng.programs.capture_seconds, node_check_s=eng.programs.node_seconds,
               graph_pool_bytes=pool,
               replays=eng.programs.replays,
               prefill_s_per_chunk=res["prefill_s"] / max(res["prefill_chunks"], 1))
    res["captures_ok"] = (not captured if eager else
                          allowed and len(set(captured)) == len(captured) and warm > 0)
    res["ok"] = bool(res["ok"] and res["captures_ok"])
    eng.stop()
    del eng
    torch.cuda.empty_cache()
    return res


def graph_scenario(model, name, make, reqs, prep=None, check=None):
    """Turns eager, graph, graph, eager of one scenario: every turn's tokens
    must equal the first eager turn's, bit for bit; ``check(res)`` adds a
    scenario's own gate."""
    runs = [graph_engine_run(model, name, make, reqs, eager, prep)
            for eager in (True, False, False, True)]
    outs = [r.pop("outputs") for r in runs]
    for r, o in zip(runs, outs):
        r["tokens_equal_eager"] = o == outs[0]
        r["ok"] = bool(r["ok"] and r["tokens_equal_eager"] and (check is None or check(r)))
    return runs


# peak growth allowed on a reused generate() signature, in static caches:
# the held cache overlaps the prefill's working set (under one cache); a
# second cache, as a copy-in design makes, reaches one
GENERATE_PEAK_SHARE = 1.0


def graph_generate(model, name, B, S0, n_new, seed, cache_dtype=None, kv_layout=None,
                   sampled=False, adapter=False):
    """generate() in turns eager, graph, graph, eager, sampled rows drawn
    from a fresh generator of one seed each turn, with ``adapter`` a fresh
    {id: LoraAdapter} mapping of a fresh adapter object each turn: tokens
    equal bit for bit, the launches equal to the work, one capture in all
    (the program is keyed by the signature, not by the caller's objects),
    and the second graph turn, which writes its prefill into the program's
    static cache, peaks less than GENERATE_PEAK_SHARE of that cache above
    the first eager turn, which started with no program held (the held
    cache overlaps only the prefill's working set)."""
    from paddle_tpu_torch.jit import check_syncs, disable_graphs
    from paddle_tpu_torch.models.generation import free_programs
    from paddle_tpu_torch.models.lora import LoraAdapter, lora_sites

    cfg = model.config
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(1, cfg.vocab_size, (B, S0), generator=g).to(model.device)
    L = cfg.num_hidden_layers
    decode = "paged_attention" if kv_layout == "paged" else "decode_attention"
    expected = {decode: L * (n_new - 1)}
    kern = prefill_kernel(cfg, B, S0)
    if kern:
        expected[kern] = L
    free_programs(model)
    torch.cuda.empty_cache()
    runs, outs = [], []
    for eager in (True, False, False, True):
        kw = {}
        if adapter:
            kw = dict(adapter_id="t", adapters={"t": LoraAdapter.random(
                lora_sites(model), TENANT_RANK, seed=seed, scale=TENANT_SCALE)})
        with disable_graphs() if eager else check_syncs():
            torch.cuda.synchronize()
            progs = model.__dict__.get("_generate_programs")
            captured = len(progs.captured) if progs is not None else 0
            torch.cuda.reset_peak_memory_stats()
            zero_counts()                                # the run starts here
            t0 = time.perf_counter()
            out = model.generate(ids, max_new_tokens=n_new, do_sample=sampled, temperature=0.8,
                                 top_p=0.9, cache_dtype=cache_dtype, kv_layout=kv_layout,
                                 generator=torch.Generator(device=model.device).manual_seed(seed),
                                 **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_counts()                     # ... and ends here
            peak = torch.cuda.max_memory_allocated()
        progs = model._generate_programs
        (prog,) = [progs.get(k) for k in progs.keys()]
        cache = sum(t.numel() * t.element_size() for t in prog.inputs.values())
        outs.append(out.tolist())
        runs.append(dict(path="graphs_generate", scenario=name, mode="eager" if eager else "graph",
                         B=B, prompt=S0, new_tokens=n_new, cache=cache_dtype or "bf16",
                         kv_layout=kv_layout or "static", sampled=sampled, adapter=adapter,
                         wall_s=wall, decode_tok_per_s=B * (n_new - 1) / wall, launches=launches,
                         expected_launches=expected, captures=len(progs.captured) - captured,
                         peak_bytes=peak, static_cache_bytes=cache,
                         ok=launch_check(launches, expected)))
    first_graph = runs[1]
    for r in runs:
        r["captures_ok"] = r["captures"] == (1 if r is first_graph else 0)
    reuse = runs[2]
    reuse["peak_over_eager_bytes"] = reuse["peak_bytes"] - runs[0]["peak_bytes"]
    reuse["peak_ok"] = (reuse["peak_over_eager_bytes"]
                        < GENERATE_PEAK_SHARE * reuse["static_cache_bytes"])
    for r, o in zip(runs, outs):
        r["tokens_equal_eager"] = o == outs[0]
        r["ok"] = bool(r["ok"] and r["tokens_equal_eager"] and r["captures_ok"]
                       and r.get("peak_ok", True))
    free_programs(model)
    return runs


def graph_ticks(model, reg):
    """Decode ticks of 8 busy slots, eager (disable_graphs()) then on
    graphs: dense, paged, and paged on 3 adapters."""
    from paddle_tpu_torch.jit import disable_graphs

    lora = dict(engine_kw=dict(adapters=reg),
                submit_kw=lambda i: dict(adapter_id=f"a{i % TENANT_POOL_PAGES}"))
    out = {}
    for name, layout, kw in (("dense", "dense", {}), ("paged", "paged", {}),
                             ("paged_lora3", "paged", lora)):
        for mode in ("eager", "graph"):
            with disable_graphs() if mode == "eager" else contextlib.nullcontext():
                out[f"{name}_{mode}"] = decode_breakdown(model, layout, **kw)
    return out


def graphs_phase(model, card):
    """Every engine program and generate()'s decode step as CUDA graphs
    against the same traffic run eagerly, in turns E G G E: the dense
    engine (bf16 greedy and sampled rows; int8 at decode_chunk=4; spec_k=4),
    the paged engine (bf16; int8; spec_k=4 over the prefix cache; tenants:
    adapters in a 3-page pool, regex and JSON constraints; a host-tier
    promotion hit), generate() (static bf16 and int8, sampled, paged);
    then decode ticks eager and on graphs."""
    import numpy as np

    from paddle_tpu_torch.inference import LLMEngine
    from paddle_tpu_torch.inference.constrain import compile_constraint
    from paddle_tpu_torch.models.lora import AdapterRegistry, LoraAdapter, lora_sites

    cfg, dev = model.config, model.device
    V = cfg.vocab_size
    eos = V - 1
    rng = np.random.default_rng(70)
    mixed = graph_requests(rng, V)

    def dense(**kw):
        return LLMEngine(model, max_batch_slots=8, max_seq_len=2048,
                         generator=torch.Generator(device=dev).manual_seed(5), **kw)

    vocab = tenant_vocab(V)
    grammars = {"regex": compile_constraint(TENANT_REGEX, vocab, eos),
                "schema": compile_constraint(TENANT_SCHEMA, vocab, eos)}
    adapters = {f"a{i}": LoraAdapter.random(lora_sites(model), TENANT_RANK, seed=200 + i,
                                            scale=TENANT_SCALE) for i in range(TENANT_ADAPTERS)}

    def registry():
        reg = AdapterRegistry(model, max_adapters=TENANT_POOL_PAGES, rank=TENANT_RANK)
        for aid, ad in adapters.items():
            reg.register(aid, ad)
        return reg

    tenant_reqs = [dict(prompt=rng.integers(1, eos, int(rng.integers(64, 401))).tolist(),
                        adapter=aid, constraint=grammars.get(kind), sampled=False,
                        max_new={"schema": 48, "regex": 16}.get(kind, 24))
                   for aid, kind in TENANT_MIX[:GRAPH_TENANTS]]
    system = rng.integers(1, V, SYSTEM_PROMPT).tolist()
    tier_a = dict(prompt=system, max_new=8, sampled=False)
    tier_b = dict(prompt=system + rng.integers(1, V, 150).tolist(), max_new=16, sampled=True)

    def tier_prep(eng):
        drive(eng, [tier_a])
        while eng.demote_step(force=True):
            pass
        assert eng._evict_prefix(int(eng._page_cached.sum()))

    scenarios = [
        ("dense_bf16", lambda: dense(), mixed, None, None),
        ("dense_int8_chunk4", lambda: dense(cache_dtype="int8", decode_chunk=4), mixed, None,
         None),
        ("dense_spec4", lambda: dense(spec_k=4), mixed, None, None),
        ("paged_bf16", lambda: paged_engine(model, prefix_cache=False), mixed, None, None),
        ("paged_int8", lambda: paged_engine(model, prefix_cache=False, cache_dtype="int8"),
         mixed, None, None),
        ("paged_spec4", lambda: paged_engine(model, spec_k=4), mixed, None, None),
        ("tenants", lambda: paged_engine(model, adapters=registry(), constraint_vocab=vocab,
                                         eos_token_id=eos), tenant_reqs, None, None),
        ("tiers_host", lambda: paged_engine(model, host_cache_pages=TIER_HOST_PAGES), [tier_b],
         tier_prep, lambda r: r["prefix_cache"]["tiers"]["promotions"] > 0),
    ]
    runs = []
    for name, make, reqs, prep, check in scenarios:
        runs += graph_scenario(model, name, make, reqs, prep, check)
    for name, args, kw in (("b4_s1024_bf16", (4, 1024, 32, 1), {}),
                           ("b4_s1024_int8", (4, 1024, 32, 1), dict(cache_dtype="int8")),
                           ("b8_s256_sampled", (8, 256, 32, 2), dict(sampled=True)),
                           ("b4_s512_paged_sampled_lora", (4, 512, 32, 3),
                            dict(kv_layout="paged", sampled=True, adapter=True))):
        runs += graph_generate(model, "generate_" + name, *args, **kw)
    torch.cuda.empty_cache()
    ticks = graph_ticks(model, registry())
    for r in runs:
        if r["path"] == "graphs_generate":
            peak = ""
            if "peak_ok" in r:
                peak = (f"; reused signature peaks {r['peak_over_eager_bytes'] / 2**20:.1f} MiB "
                        f"above the first eager turn (static cache "
                        f"{r['static_cache_bytes'] / 2**20:.1f} MiB, limit "
                        f"{GENERATE_PEAK_SHARE} of it)")
            log(f"  {r['scenario']} {r['mode']}: wall {r['wall_s']:.3f} s "
                f"({r['decode_tok_per_s']:.1f} tok/s incl. prefill); launches {r['launches']} "
                f"(expected {r['expected_launches']}); captures {r['captures']}; tokens == "
                f"eager {r['tokens_equal_eager']}{peak}; {'ok' if r['ok'] else 'FAIL'} [{card}]")
            continue
        log(f"  {r['scenario']} {r['mode']}: {r['requests']} req, {r['prefill_chunks']} prefills "
            f"at {r['prefill_s_per_chunk'] * 1e3:.2f} ms each, TTFT mean "
            f"{r['ttft_s']['mean'] * 1e3:.1f} ms; {r['decode_tokens']} decode tok at "
            f"{r['decode_tok_per_s']:.1f} tok/s; wall {r['wall_s']:.2f} s; warmup "
            f"{r['warmup_s']:.2f} s ({r['captures_at_warmup']} captures, "
            f"{r['capture_s']:.3f} s capturing, {r['node_check_s'] * 1e3:.1f} ms of it reading "
            f"nodes, pool {r['graph_pool_bytes']} B); lazy "
            f"{r['lazy_captures']}; replays {r['replays']}; launches {r['launches']} "
            f"(expected {r['expected_launches']}); tokens == eager {r['tokens_equal_eager']}; "
            f"{'ok' if r['ok'] else 'FAIL'} [{card}]")
    for name, t in ticks.items():
        log(f"  tick {name}: {json.dumps(t)} [{card}]")
    return runs, ticks


# --------------------------------------------------------------------- gpt

def build_gpt():
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

    cfg = GPTConfig()  # the reference's GPT: hidden 768, 12 x 64 heads, vocab 50,304
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16).eval()
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"  model: GPT {model.num_params / 1e6:.1f} M params, {cfg.num_hidden_layers} layers, "
        f"{cfg.num_attention_heads} heads of {cfg.hidden_size // cfg.num_attention_heads}, bf16")
    return model


def gpt_phase(card):
    """GPTConfig() at its full widths: generate() on the static cache, the
    dense engine, and the paged engine with the prefix cache and spec_k=4."""
    import numpy as np

    model = build_gpt()
    vocab = model.config.vocab_size
    rng = np.random.default_rng(40)
    runs = [generate_run(model, "gpt_b8_s256_bf16", 8, 256, 32, None, 3)]
    dense = [dict(prompt=rng.integers(1, vocab, int(rng.integers(40, 600))).tolist(),
                  max_new=32, sampled=False, check=True) for _ in range(8)]
    from paddle_tpu_torch.inference import LLMEngine

    eng = LLMEngine(model, max_batch_slots=8, max_seq_len=1024,
                    generator=torch.Generator(device=model.device).manual_seed(5))
    runs.append(engine_run(model, "gpt_dense", eng, [dense], True))
    system = rng.integers(1, vocab, 300).tolist()
    paged = prefix_requests(rng, vocab, 8, system, check_every=2, tails=(20, 200), new=(24, 32))
    runs.append(engine_run(model, "gpt_paged_prefix_spec",
                           paged_engine(model, max_seq_len=1024, spec_k=4), [paged[:1], paged[1:]],
                           True, lambda r: 300, verify=4))
    runs[-1]["ok"] &= runs[-1]["prefix_cache"]["hit_tokens"] > 0
    for r in runs[1:]:
        log_run(r, card, f"; prefix {r['prefix_cache']}; spec {r['spec']}")
    tf = runs[0]["teacher_forced"]
    log(f"  gpt generate: launches {runs[0]['launches']} (expected "
        f"{runs[0]['expected_launches']}); drift max {tf['max_logit_drift']:.4f}, "
        f"{tf['failures']} failures; {'ok' if runs[0]['ok'] else 'FAIL'} [{card}]")
    del model
    torch.cuda.empty_cache()
    return runs


# ------------------------------------------------------------------ train

# The repo's single-chip training configuration (bench.py _bench_llama):
# LLaMA at hidden 2048, 12 layers, 16 heads of 128, vocab 32000, bf16, flash
# attention (738.3 M parameters), AdamW(3e-4, weight_decay=0.01), a batch of
# 8 x 2048 random tokens.
TRAIN_CFG = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5504,
                 num_hidden_layers=12, num_attention_heads=16, num_key_value_heads=16,
                 max_position_embeddings=2048, dtype="bfloat16", use_flash_attention=True)
TRAIN_WARMUP, TRAIN_STEPS = 3, 10
# Gradient parity, kernels against dense math: max |g_kernel - g_dense| over
# max |g_dense|, per parameter, two bf16 models on the same weights and
# batch.  Both round every activation to bf16, in different places (the
# dense path takes its scores in bf16, the kernels in f32), so the gate is
# set from the measured spread; a gradient that misses a term (the planted
# faults of the kernel phase) is off by 0.16 or more.
GRAD_RTOL = 5e-2
# The same parity of float32 models (the config's default), through the
# split-bf16 kernels against dense math in f32: nothing rounds to 16 bits on
# either side (three bf16 products keep about 16 bits of each operand), so
# the order of f32 sums and the 2^-16 left out differ.  Float16 models round
# every activation to float16 (three more mantissa bits than bf16), and the
# dense path takes its scores in float16 where the kernels take them in f32.
F32_GRAD_RTOL = 1e-3
F16_GRAD_RTOL = 2e-2
# Float16 gradients of this loss underflow: dlogits is about 1 / (B S V),
# 8e-9 at B 2 x S 2048 and vocab 32,000, under float16's smallest
# subnormal (6e-8), and the weights' gradients (medians 2e-5 to 5e-5 on
# this model in f32) are subnormal.  So the float16 parity backpropagates
# from a loss gradient of 2^15 on both sides, a GradScaler's scaling (not
# ported, ROADMAP Queue 1 item 6) applied by hand; the largest scaled
# gradient is then about 180, far from float16's 65,504.
F16_GRAD_SCALE = 2.0 ** 15
# Float32 training at full width: an f32 step of bench.py's LLaMA does about
# 73 TFLOP of matmul (6 x 738 M x 16,384 tokens) at the f32 rate without
# TF32, over a second a step, so the timed steps are cut (not the width).
F32_TRAIN_WARMUP, F32_TRAIN_STEPS = 1, 3


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def train_model(layers, device="cuda", **over):
    """The training configuration at ``layers`` layers, random weights from
    seed 0."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(**{**TRAIN_CFG, "num_hidden_layers": layers, **over})
    model = LlamaForCausalLM(cfg, device=device)
    model.init_weights(torch.Generator(device=device).manual_seed(0))
    return model


def token_batch(cfg, B, S, seed, device):
    """Random ids and labels [B, S] from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    labels = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    return ids.to(device), labels.to(device)


def lm_loss(model):
    """bench.py's loss: cross entropy of the [B * S, V] logits."""
    from paddle_tpu_torch.nn import functional as F

    V = model.config.vocab_size

    def loss_fn(ids, labels):
        return F.cross_entropy(model(ids).reshape(-1, V), labels.reshape(-1))

    return loss_fn


def grad_parity(model, B, S, seed, expected, tol=GRAD_RTOL, grad_scale=1.0):
    """Every parameter's gradient through the kernels against the same
    model's with dense-math attention (use_flash_attention=False), an
    oracle that runs none of the kernels under test, within ``tol``; both
    backpropagate from a loss gradient of ``grad_scale``."""
    cfg = model.config
    ids, labels = token_batch(cfg, B, S, seed, model.device)
    names, params = zip(*model.named_parameters())
    loss_fn = lm_loss(model)
    grads, launches, losses = {}, {}, {}
    try:
        for kern in (True, False):
            cfg.use_flash_attention = kern
            zero_counts()
            loss = loss_fn(ids, labels)
            grads[kern] = torch.autograd.grad(loss, params, torch.full_like(loss, grad_scale))
            sync()
            launches[kern], losses[kern] = read_counts(), float(loss.detach())
    finally:
        cfg.use_flash_attention = True
    rel = {n: ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
           for n, a, b in zip(names, grads[True], grads[False])}
    worst = max(rel, key=rel.get)
    finite = all(bool(torch.isfinite(g).all()) for g in grads[True])
    ordered = sorted(rel.values())
    return dict(B=B, S=S, D=cfg.hidden_size // cfg.num_attention_heads,
                layers=cfg.num_hidden_layers, dtype=TAGS[model_dtype(model)],
                grad_scale=grad_scale, loss_kernels=losses[True],
                loss_dense=losses[False], max_rel=rel[worst], worst_param=worst,
                median_rel=ordered[len(ordered) // 2], tol=tol, finite=finite,
                launches=launches[True], expected_launches=expected,
                dense_launches=launches[False],
                ok=(finite and rel[worst] <= tol and launch_check(launches[True], expected)
                    and not any(launches[False].values())))


def train_kind(name):
    low = name.lower()
    if "fused_ln_fwd_kernel" in low or "fused_ln_bwd_kernel" in low:
        return low[low.index("fused_ln_"):][:12]  # fused_ln_fwd / fused_ln_bwd
    # flash_dq_kernel, flash_dkv_kernel, flash_dsum_kernel, flash_split_kernel
    # (the wgmma backward, its statistics pass and its float32 split pass);
    # the encoder's encoder_bwd_head (S = 128) and encoder_dq and
    # encoder_dkv (the streamed pair), at every type
    if any(w in low for w in ("dq_kernel", "dkv_kernel", "dsum_kernel", "split_kernel",
                              "encoder_bwd_head", "encoder_dq", "encoder_dkv")):
        return "attention_bwd"
    if any(w in low for w in ("flash_fwd_kernel", "encoder_fwd")):
        return "attention_fwd"
    if any(w in low for w in ("gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas")):
        return "matmul"
    return "other"


TRAIN_KINDS = ("matmul", "attention_fwd", "attention_bwd", "fused_ln_fwd", "fused_ln_bwd",
               "optimizer", "other")


def train_profile(step, batch, kind=train_kind, kinds=TRAIN_KINDS, span_kinds=("other",)):
    """One step under torch.profiler: device time by ``kind`` of kernel
    name (LLaMA and ERNIE: matmul, attention forward and backward, fused LN,
    the optimizer, other) and the busy share.  The optimizer's kernels are
    those of ``span_kinds`` that start inside the device span of
    TrainStep's "TrainStep.optimizer" label.  Informational: a profiler
    that records no device events gives "not measured", not a failure."""
    res = {}
    try:
        from torch.profiler import ProfilerActivity, profile

        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(*batch)
            sync()
            res["profiled_wall_ms"] = (time.perf_counter() - t0) * 1e3
        dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        spans = [(e.time_range.start, e.time_range.end) for e in dev
                 if e.name == "TrainStep.optimizer"]
        kern = [e for e in dev if not e.name.startswith("TrainStep.")]
        by_kind = dict.fromkeys(kinds, 0.0)
        by_name = {}
        for e in kern:
            k = kind(e.name)
            if k in span_kinds and any(a <= e.time_range.start < b for a, b in spans):
                k = "optimizer"
            ms = e.time_range.elapsed_us() / 1e3
            by_kind[k] += ms
            by_name[e.name] = by_name.get(e.name, 0.0) + ms
        res["optimizer_from"] = ("device span of TrainStep.optimizer" if spans else
                                 "not measured: no device span of TrainStep.optimizer, "
                                 "its kernels count as other")
        if kern:
            busy = sum(by_kind.values())
            # eager copies and adds (ERNIE's q/k/v copies and the qkv
            # gradient's fills and adds were among them), all and bf16
            copy_add = {}
            for tag, word in (("direct_copy", "direct_copy_kernel"), ("add", "CUDAFunctor_add"),
                              ("fill", "FillFunctor")):
                named = [(n, ms) for n, ms in by_name.items() if word in n]
                copy_add[tag] = sum(ms for _, ms in named)
                copy_add[tag + "_bf16"] = sum(ms for n, ms in named if "BFloat16" in n)
            res.update(device_ms=busy, device_ms_by_kind=by_kind, kernels=len(kern),
                       busy_share=busy / res["profiled_wall_ms"], copy_add_ms=copy_add,
                       top_kernels=sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
        else:
            res["device_ms"] = "not measured (no device events)"
    except Exception as e:  # noqa: BLE001 - a measurement, not a phase
        res["device_ms"] = f"not measured ({e!r})"
    return res


def timed_steps(step, batch, steps, warmup):
    """``warmup`` steps, then ``steps`` timed ones on the host clock, each
    ending in reading the loss, with the launch counters zeroed just before
    the timed steps and read just after (and the peak memory reset).
    Returns (every loss, ms per timed step, launches)."""
    losses = [float(step(*batch)) for _ in range(warmup)]
    sync()
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    zero_counts()                                        # the run starts here
    ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(step(*batch)))               # the host waits for the loss
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms, read_counts()                     # ... and ends here


def train_run(model, name, B, S, seed, per_step, steps=TRAIN_STEPS, warmup=TRAIN_WARMUP,
              accum_steps=1, grad_clip=None, profiled=False):
    """TrainStep + AdamW(3e-4, weight_decay=0.01) on one fixed batch:
    ``warmup`` steps, then ``steps`` timed ones with the launch counters
    zeroed just before; ``per_step`` is each kernel's expected launches per
    step."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW

    cfg = model.config
    step = TrainStep(model, lm_loss(model), AdamW(3e-4, weight_decay=0.01, grad_clip=grad_clip),
                     accum_steps=accum_steps)
    batch = token_batch(cfg, B, S, seed, model.device)
    losses, ms, launches = timed_steps(step, batch, steps, warmup)
    copies = input_copies()
    step_ms = sorted(ms)[len(ms) // 2]
    tokens = B * S
    # bench.py's count: 6 N per token, plus the causal attention products
    flops = (6 * model.num_params * tokens
             + 3 * 2 * B * S * S * cfg.hidden_size * cfg.num_hidden_layers)
    expected = {k: n * steps for k, n in per_step.items()}
    res = dict(path="train", name=name, B=B, S=S,
               D=cfg.hidden_size // cfg.num_attention_heads, accum_steps=accum_steps,
               grad_clip=repr(grad_clip), layers=cfg.num_hidden_layers,
               params=model.num_params, warmup=warmup, steps=steps, losses=losses,
               step_ms=step_ms, step_ms_all=ms, tokens_per_s=tokens / step_ms * 1e3,
               flops_per_step=flops, mfu=flops / (step_ms / 1e3) / H100_BF16_FLOPS,
               f32_peak_share=flops / (step_ms / 1e3) / H100_F32_FLOPS,
               dtype=TAGS[model_dtype(model)],
               peak_mem_bytes=(torch.cuda.max_memory_allocated()
                               if torch.cuda.is_available() else None),
               launches=launches, expected_launches=expected, encoder_input_copies=copies)
    res["ok"] = (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
                 and launch_check(launches, expected))
    if profiled:
        res["profile"] = train_profile(step, batch)
    return res


def flash_launches(n, dtype):
    """Expected launches of ``n`` flash forwards and backwards at q's dtype,
    on the tensor-core kernels at every type, each backward with its
    statistics pass and, at float32, its split pass."""
    bwd = ["flash_attention_bwd_stats", "flash_attention_dq", "flash_attention_dkv"]
    bwd += ["flash_attention_bwd_split"] if dtype == torch.float32 else []
    return {k: n for k in ["flash_attention"] + bwd}


def encoder_launches(n):
    """Expected launches of ``n`` encoder forwards and backwards, at any type."""
    return {k: n for k in ("encoder_attention", "encoder_attention_bwd")}


def log_parity(r, card):
    log(f"  grad parity {r['dtype']} S {r['S']} D {r['D']}, {r['layers']} layers, loss gradient "
        f"{r['grad_scale']:g}: max rel "
        f"{r['max_rel']:.3e} ({r['worst_param']}), median {r['median_rel']:.3e} (tol "
        f"{r['tol']}); loss {r['loss_kernels']:.4f} vs dense {r['loss_dense']:.4f}; launches "
        f"{r['launches']} (expected {r['expected_launches']}); "
        f"{'ok' if r['ok'] else 'FAIL'} [{card}]")


def log_train_run(r, card):
    log(f"  {r['name']}: step {r['step_ms']:.1f} ms (median of {r['steps']}), "
        f"{r['tokens_per_s']:.0f} tok/s, MFU {r['mfu']:.4f} (of bf16 peak; "
        f"{r['f32_peak_share']:.4f} of the f32 peak), peak "
        f"{(r['peak_mem_bytes'] or 0) / 2**30:.2f} GiB; loss {r['losses'][0]:.4f} -> "
        f"{r['losses'][-1]:.4f}; launches {r['launches']} (expected "
        f"{r['expected_launches']}); profile {json.dumps(r.get('profile'))}; "
        f"{'ok' if r['ok'] else 'FAIL'} [{card}]")


def train_phase(card, device="cuda", layers=12, parity_layers=2, heads=(16, 8), **over):
    """For each head count in ``heads`` (16 heads of 128: bench.py's LLaMA;
    8 heads of 256 at the same widths, Gemma-2B's attention layout, through
    the D = 256 backward kernels): gradient parity at ``parity_layers``
    layers (S 2048: flash; S 512: encoder, at D = 128 only, since the
    reference sends S = 512 at D = 256 to its dense path), then the training
    runs at ``layers``: B 8 x S 2048 and, at D = 128, B 32 x S 512 at
    accum_steps=2 with ClipGradByGlobalNorm(1.0) (the same 16,384 tokens a
    step); first in bf16, then in float32 (the config's default: the
    attention kernels on the tensor cores as split-bf16 products;
    F32_TRAIN_STEPS timed steps,
    the S 512 step profiled too), and the parity once more in float16."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm

    L = parity_layers
    parity, runs = [], []
    for nh in heads:
        cfg = {**over, "num_attention_heads": nh, "num_key_value_heads": nh}
        for dt, tol, scale in (("bfloat16", GRAD_RTOL, 1.0), ("float32", F32_GRAD_RTOL, 1.0),
                               ("float16", F16_GRAD_RTOL, F16_GRAD_SCALE)):
            small = train_model(parity_layers, device, **{**cfg, "dtype": dt})
            tdt = model_dtype(small)
            D = small.config.hidden_size // small.config.num_attention_heads
            checks = [grad_parity(small, 2, 2048, 3, flash_launches(L, tdt), tol, scale)]
            if D != 256:
                checks.append(grad_parity(small, 2, 512, 4, encoder_launches(L), tol, scale))
            del small
            for r in checks:
                log_parity(r, card)
            parity += checks
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            if dt == "float16":
                break  # float16 training needs f32 master weights (ROADMAP Queue 1, item 6)
            t0 = time.perf_counter()
            model = train_model(layers, device, **{**cfg, "dtype": dt})
            sync()
            log(f"  model: {model.num_params / 1e6:.1f} M params, {layers} layers, "
                f"{nh} heads of {D}, {model.config.dtype}, init {time.perf_counter() - t0:.1f} s")
            steps, warmup = ((TRAIN_STEPS, TRAIN_WARMUP) if dt == "bfloat16"
                             else (F32_TRAIN_STEPS, F32_TRAIN_WARMUP))
            tag = ("" if D == 128 else f"_d{D}") + ("" if dt == "bfloat16" else f"_{TAGS[tdt]}")
            part = [train_run(model, f"b8_s2048{tag}", 8, 2048, 0,
                              flash_launches(layers, tdt), steps=steps, warmup=warmup,
                              profiled=True)]
            if D != 256:  # float32's step profiled: its encoder backward's device time
                part.append(train_run(model, f"b32_s512_accum2_clip{tag}", 32, 512, 1,
                                      encoder_launches(2 * layers), steps=min(steps, 5),
                                      warmup=warmup, accum_steps=2,
                                      grad_clip=ClipGradByGlobalNorm(1.0),
                                      profiled=dt == "float32"))
            del model
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            for r in part:
                log_train_run(r, card)
            runs += part
    return parity, runs


# ------------------------------------------------------------------ ernie

# bench.py _bench_ernie's configuration: ErnieForPretraining(BertConfig.base())
# (hidden 768, 12 layers, 12 heads of 64, intermediate 3072, vocab 30522,
# dropout 0.1 on hidden states and attention probabilities, LayerNorm eps
# 1e-12), bf16, AdamW(1e-4, weight_decay=0.01), B 512 x S 128 with 20 masked
# positions a sequence, random weights and batch from seed 0.
ERNIE_B, ERNIE_S, ERNIE_P = 512, 128, 20
ERNIE_WARMUP, ERNIE_STEPS = 2, 8
# At float32 (about a second a step: 35.8 TFLOP at the f32 rate), fewer.
ERNIE_F32_WARMUP, ERNIE_F32_STEPS = 1, 4
# The eval forward's MLM logits against the composed/dense forward's.  With
# the decoder tied to an N(0, 1) embedding the logits spread by about
# sqrt(768) = 28 (LLaMA's by 0.5), so LOGIT_TOL applies in units of the
# logits' standard deviation: max |kernel - composed| <= LOGIT_TOL * std.


class composed_paths:
    """Inside: attention takes the dense math and the dropout + add + LN
    the composed math, on every device, so that a run goes through no
    kernel under test (the oracle of the ernie phase).  The port has no
    switch of its own for this, as the reference has none."""

    def __enter__(self):
        from paddle_tpu_torch.nn.functional import attention, norm

        self._saved = (attention._reference_kernel, norm._use_fused_kernel)
        attention._reference_kernel = lambda *a, **k: None
        norm._use_fused_kernel = lambda *a, **k: False
        return self

    def __exit__(self, *exc):
        from paddle_tpu_torch.nn.functional import attention, norm

        attention._reference_kernel, norm._use_fused_kernel = self._saved
        return False


def ernie_model(layers, device="cuda", dtype=torch.bfloat16, dropout=True, **over):
    """ErnieForPretraining at bench.py's widths and ``layers`` layers,
    random weights from seed 0; ``dropout=False`` zeroes both rates."""
    from paddle_tpu_torch.models import BertConfig, ErnieForPretraining

    if not dropout:
        over = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0, **over)
    model = ErnieForPretraining(BertConfig.base(num_hidden_layers=layers, **over),
                                device=device, dtype=dtype)
    model.init_weights(torch.Generator(device=device).manual_seed(0))
    return model


def ernie_batch(cfg, B, S, P, seed, device):
    """bench.py _bench_ernie's batch: int32 ids and segment ids [B, S], P
    distinct masked positions a row, their labels [B, P] and NSP labels
    [B, 1]."""
    import numpy as np

    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    seg = (rng.rand(B, S) > 0.5).astype(np.int32)
    pos = np.stack([rng.choice(S, P, replace=False) for _ in range(B)]).astype(np.int32)
    labels = rng.randint(0, cfg.vocab_size, (B, P)).astype(np.int32)
    nsp = rng.randint(0, 2, (B, 1)).astype(np.int32)
    return [torch.from_numpy(a).to(device) for a in (ids, seg, pos, labels, nsp)]


def ernie_loss(model):
    def loss_fn(ids, seg, pos, labels, nsp):
        loss, _ = model(ids, token_type_ids=seg, masked_lm_labels=labels,
                        next_sentence_label=nsp, masked_positions=pos)
        return loss

    return loss_fn


def ernie_flops(cfg, B, S, P):
    """bench.py's count for the masked recipe: encoder matmuls on every
    token, the MLM transform and tied decoder on the B * P masked rows, the
    pooler and NSP head per sequence, and the bidirectional attention."""
    h, L = cfg.hidden_size, cfg.num_hidden_layers
    enc = L * (h * 3 * h + h * h + 2 * h * cfg.intermediate_size)
    head = h * h + h * cfg.vocab_size
    pooled = h * h + h * 2
    return (6 * enc * B * S + 6 * head * B * P + 6 * pooled * B
            + 3 * 4 * B * S * S * h * L)


def ln_launches(n, bwd=True):
    """Expected launches of ``n`` fused LN forwards (and backwards)."""
    return {k: n for k in (["fused_ln", "fused_ln_bwd"] if bwd else ["fused_ln"])}


def ernie_per_layer(L, dtype=torch.bfloat16):
    """Launches of one step of an ``L``-layer ERNIE at ``dtype``: the fused
    LN kernels and the encoder kernels of that type."""
    return {**ln_launches(2 * L), **encoder_launches(L)}


def ernie_grad_parity(model, batch, tol=GRAD_RTOL):
    """Every parameter's gradient through the kernels against the same
    model's through the composed/dense paths, at rate 0, within ``tol``."""
    L = model.config.num_hidden_layers
    names, params = zip(*model.named_parameters())
    loss_fn = ernie_loss(model)
    grads, launches, losses = {}, {}, {}
    def grad(loss):  # the task-type embedding takes no part without task ids
        got = torch.autograd.grad(loss, params, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g for p, g in zip(params, got)]

    for kern in (True, False):
        zero_counts()
        if kern:
            loss = loss_fn(*batch)
            grads[kern] = grad(loss)
        else:
            with composed_paths():
                loss = loss_fn(*batch)
                grads[kern] = grad(loss)
        sync()
        launches[kern], losses[kern] = read_counts(), float(loss.detach())
    rel = {n: ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)
               ).item() for n, a, b in zip(names, grads[True], grads[False])}
    worst = max(rel, key=rel.get)
    finite = all(bool(torch.isfinite(g).all()) for g in grads[True])
    ordered = sorted(rel.values())
    expected = ernie_per_layer(L, model_dtype(model))
    return dict(layers=L, B=batch[0].shape[0], dtype=TAGS[model_dtype(model)],
                loss_kernels=losses[True],
                loss_composed=losses[False], max_rel=rel[worst], worst_param=worst,
                median_rel=ordered[len(ordered) // 2], tol=tol, finite=finite,
                launches=launches[True], expected_launches=expected,
                composed_launches=launches[False],
                ok=(finite and rel[worst] <= tol and launch_check(launches[True], expected)
                    and not any(launches[False].values())))


@torch.no_grad()
def ernie_determinism(model, batch):
    """At rate 0.1: the same seed() gives the same loss and MLM logits
    twice, another seed another loss.  The model's loss is bf16, whose
    steps are 0.5 at a loss near 115, coarser than what another mask moves
    it by, so the check reads the MLM cross entropy of the logits in f32."""
    import torch.nn.functional as tF

    from paddle_tpu_torch import seed

    ids, seg, pos, labels, nsp = batch
    got, f32, logits = [], [], []
    for s in (1, 1, 2):
        seed(s)
        loss, mlm = model(ids, token_type_ids=seg, masked_lm_labels=labels,
                          next_sentence_label=nsp, masked_positions=pos)
        got.append(float(loss))
        f32.append(float(tF.cross_entropy(mlm.float(), labels.reshape(-1).long())))
        logits.append(mlm)
    same = bool(torch.equal(logits[0], logits[1]))
    return dict(losses=got, mlm_losses_f32=f32, same_seed_logits_equal=same,
                other_seed_logits_equal=bool(torch.equal(logits[0], logits[2])),
                ok=same and got[0] == got[1] and f32[0] == f32[1] and f32[2] != f32[0])


@torch.no_grad()
def ernie_eval(model, batch, tol=LOGIT_TOL):
    """The eval forward at full depth: MLM logits through the kernels (rate
    0: the fused-LN forward and encoder forward at rate 0, the model's
    type's encoder kernel) against the composed/dense forward's, within
    ``tol`` logit standard deviations; the wall time (host clock, the
    card synced) and peak memory of that forward, after one warm-up."""
    model.eval()
    ids, seg, pos = batch[:3]
    model(ids, token_type_ids=seg, masked_positions=pos)
    sync()
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    logits, nsp = model(ids, token_type_ids=seg, masked_positions=pos)
    sync()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else None
    with composed_paths():
        want, want_nsp = model(ids, token_type_ids=seg, masked_positions=pos)
    model.train()
    L = model.config.num_hidden_layers
    drift = (logits.float() - want.float()).abs().max().item()
    std = want.float().std().item()
    expected = {**ln_launches(2 * L, bwd=False),
                "encoder_attention": L}
    return dict(layers=L, logits_shape=list(logits.shape), max_logit_drift=drift,
                logit_std=std, drift_in_std=drift / std, logit_tol_in_std=tol,
                nsp_drift=(nsp.float() - want_nsp.float()).abs().max().item(),
                finite=bool(torch.isfinite(logits).all()), launches=launches,
                expected_launches=expected, wall_ms=wall_ms, peak_mem_bytes=peak,
                ok=(bool(torch.isfinite(logits).all()) and drift <= tol * std
                    and launch_check(launches, expected)))


def ernie_train(model, batch, steps=ERNIE_STEPS, warmup=ERNIE_WARMUP, profiled=True):
    """TrainStep + AdamW(1e-4, weight_decay=0.01) on one fixed batch at
    dropout 0.1: ``warmup`` steps, then ``steps`` timed ones with the
    launch counters zeroed just before."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW

    cfg = model.config
    step = TrainStep(model, ernie_loss(model), AdamW(1e-4, weight_decay=0.01))
    losses, ms, launches = timed_steps(step, batch, steps, warmup)
    copies = input_copies()
    B, S = batch[0].shape
    P = batch[2].shape[1]
    step_ms = sorted(ms)[len(ms) // 2]
    flops = ernie_flops(cfg, B, S, P)
    dt = model_dtype(model)
    expected = {k: n * steps for k, n in ernie_per_layer(cfg.num_hidden_layers, dt).items()}
    tag = "" if dt == torch.bfloat16 else f"_{TAGS[dt]}"
    res = dict(path="ernie", name=f"b{B}_s{S}_p{P}_drop{cfg.hidden_dropout_prob}{tag}", B=B, S=S,
               masked_per_seq=P, layers=cfg.num_hidden_layers, params=model.num_params,
               warmup=warmup, steps=steps, losses=losses, step_ms=step_ms, step_ms_all=ms,
               tokens_per_s=B * S / step_ms * 1e3, flops_per_step=flops,
               mfu=flops / (step_ms / 1e3) / H100_BF16_FLOPS,
               f32_peak_share=flops / (step_ms / 1e3) / H100_F32_FLOPS, dtype=TAGS[dt],
               peak_mem_bytes=(torch.cuda.max_memory_allocated()
                               if torch.cuda.is_available() else None),
               launches=launches, expected_launches=expected, encoder_input_copies=copies)
    # BERT's q, k, v are strided views of one packed projection: the
    # encoder kernels must read them in place
    res["ok"] = (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
                 and launch_check(launches, expected) and copies == 0)
    if profiled:
        res["profile"] = train_profile(step, batch)
    return res


def log_ernie_parity(parity, card):
    log(f"  grad parity {parity['dtype']}, {parity['layers']} layers, rate 0: max rel "
        f"{parity['max_rel']:.3e} ({parity['worst_param']}), median {parity['median_rel']:.3e} "
        f"(tol {parity['tol']}); loss {parity['loss_kernels']:.4f} vs composed "
        f"{parity['loss_composed']:.4f}; launches {parity['launches']} (expected "
        f"{parity['expected_launches']}); {'ok' if parity['ok'] else 'FAIL'} [{card}]")


def ernie_phase(card, device="cuda", layers=12, parity_layers=2, B=ERNIE_B, S=ERNIE_S,
                P=ERNIE_P, dtype=torch.bfloat16, steps=ERNIE_STEPS, warmup=ERNIE_WARMUP,
                **over):
    """bench.py's ERNIE pretraining at ``dtype`` (bf16, or float32: the
    encoder forward and backward on the tensor cores as split-bf16
    products): gradient parity at ``parity_layers``
    layers and rate 0, determinism at rate 0.1, the eval forward and the
    training run at ``layers`` layers, ``steps`` timed steps."""
    f32 = dtype == torch.float32
    small = ernie_model(parity_layers, device, dtype, dropout=False, **over)
    batch = ernie_batch(small.config, B, S, P, 0, device)
    parity = ernie_grad_parity(small, batch, F32_GRAD_RTOL if f32 else GRAD_RTOL)
    del small
    log_ernie_parity(parity, card)
    small = ernie_model(parity_layers, device, dtype, **over)
    determinism = ernie_determinism(small, batch)
    del small
    log(f"  determinism at rate 0.1: losses {determinism['losses']}, MLM in f32 "
        f"{determinism['mlm_losses_f32']}; same-seed logits equal "
        f"{determinism['same_seed_logits_equal']}, other-seed logits equal "
        f"{determinism['other_seed_logits_equal']}; "
        f"{'ok' if determinism['ok'] else 'FAIL'} [{card}]")
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = ernie_model(layers, device, dtype, **over)
    sync()
    log(f"  model: {model.num_params / 1e6:.1f} M params, {layers} layers, {dtype}, "
        f"init {time.perf_counter() - t0:.1f} s")
    ev = ernie_eval(model, batch, tol=F32_LOGIT_TOL if f32 else LOGIT_TOL)
    log(f"  eval forward, {ev['layers']} layers: MLM logits {ev['logits_shape']}, drift max "
        f"{ev['max_logit_drift']:.4f} = {ev['drift_in_std']:.4f} std (std "
        f"{ev['logit_std']:.3f}; tol {ev['logit_tol_in_std']} std); launches {ev['launches']} "
        f"(expected {ev['expected_launches']}); {'ok' if ev['ok'] else 'FAIL'} [{card}]")
    run = ernie_train(model, batch, steps, warmup, profiled=device != "cpu")
    del model
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    log(f"  {run['name']}: step {run['step_ms']:.2f} ms (median of {run['steps']}), "
        f"{run['tokens_per_s']:.0f} tok/s, MFU {run['mfu']:.4f} ({run['f32_peak_share']:.4f} "
        f"of the f32 peak), peak "
        f"{(run['peak_mem_bytes'] or 0) / 2**30:.2f} GiB; loss {run['losses'][0]:.4f} -> "
        f"{run['losses'][-1]:.4f}; launches {run['launches']} (expected "
        f"{run['expected_launches']}); encoder input copies {run['encoder_input_copies']} "
        f"(expected 0); profile {json.dumps(run.get('profile'))}; "
        f"{'ok' if run['ok'] else 'FAIL'} [{card}]")
    return dict(grad_parity=parity, determinism=determinism, eval=ev), [run]


def ernie_f16_parity(card, device="cuda", parity_layers=2, B=ERNIE_B, S=ERNIE_S, P=ERNIE_P,
                     **over):
    """ERNIE at float16, gradient parity only (training at float16 needs f32
    master weights, ROADMAP Queue 1 item 6): the tensor-core encoder kernels
    and the fused-LN kernels at float16 against the composed/dense paths at
    rate 0."""
    small = ernie_model(parity_layers, device, torch.float16, dropout=False, **over)
    parity = ernie_grad_parity(small, ernie_batch(small.config, B, S, P, 0, device),
                               F16_GRAD_RTOL)
    del small
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    log_ernie_parity(parity, card)
    return parity


# ----------------------------------------------------------------- resnet

# bench.py _bench_resnet's configuration in NHWC (the layout whose training
# reaches the fused kernels): resnet50(num_classes=1000, data_format="NHWC"),
# bf16, a batch of 128 random 224 x 224 images in [-1, 1) with random
# labels, Momentum(0.1, 0.9), CrossEntropyLoss on f32 logits, random weights
# from seed 0; 5 warm-up and 20 timed steps on one batch.
RESNET_S, RESNET_WARMUP, RESNET_STEPS = 224, 5, 20
RESNET_TRAIN_FLOPS = 3 * 4.1e9  # bench.py's count a 224^2 image: 3 x the forward
# Block parity on the card, fused against composed, f32 with TF32 off: the
# reference test's own bounds (tests/test_fused_conv_bn.py:78-131): output
# within 1e-4 of max |composed|, each parameter's gradient within 2e-3 of
# its max, running statistics within 1e-5.
BLOCK_TOL = dict(out=1e-4, grad=2e-3, stats=1e-5)
# (name, inplanes, planes, stride, H, wv_in, W'_in): a block at each stage's
# shape; the strided ones enter stages 2-4 and make their pad columns.
RESNET_BLOCKS = [("stage1_block1", 256, 64, 1, 56, 56, 56),
                 ("stage2_block0", 256, 128, 2, 56, 56, 56),
                 ("stage3_block0", 512, 256, 2, 28, 28, 32),
                 ("stage4_block0", 1024, 512, 2, 14, 14, 16)]
RESNET_KINDS = ("conv", "fused_conv_bn", "matmul", "bn_elementwise", "optimizer", "other")


def resnet_kind(name):
    """Kind of a kernel of the ResNet step, by name: cuDNN's convolutions,
    the fused conv + BN kernels, matrix products (fc and conv1's forward),
    BN's and the rest's elementwise and reduction kernels, other."""
    low = name.lower()
    if any(k in low for k in ("fcbn_", "gemm_f32")):
        return "fused_conv_bn"
    if any(k in low for k in ("conv", "cudnn", "fprop", "dgrad", "wgrad", "implicit")):
        return "conv"
    if any(k in low for k in ("gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas")):
        return "matmul"
    if any(k in low for k in ("elementwise", "reduce", "vectorized", "unrolled", "pool")):
        return "bn_elementwise"
    return "other"


class forced_fused:
    """Inside: the fused ResNet path on CPU tensors too (its rehearsal)."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        from paddle_tpu_torch.vision.models import _fused_resnet as FR

        self._saved = FR.FORCE
        FR.FORCE = self._saved or self.on
        return self

    def __exit__(self, *exc):
        from paddle_tpu_torch.vision.models import _fused_resnet as FR

        FR.FORCE = self._saved
        return False


def block_parity(spec, device, N):
    """One bottleneck block, fused (forward_fused on the W'-padded input)
    against composed (forward on the valid columns), the same f32 weights:
    the output, every parameter's gradient of sum(z^2), and the running
    statistics.  Launches: the fused run's, the composed run's."""
    import copy

    from paddle_tpu_torch import nn
    from paddle_tpu_torch.vision.models.resnet import BottleneckBlock

    name, inplanes, planes, stride, H, wv_in, wp_in = spec
    torch.manual_seed(11)
    ds = None
    if stride != 1 or inplanes != planes * 4:
        ds = nn.Sequential(nn.Conv2D(inplanes, planes * 4, 1, stride=stride, bias_attr=False,
                                     data_format="NHWC", device=device),
                           nn.BatchNorm2D(planes * 4, data_format="NHWC", device=device))
    fused = BottleneckBlock(inplanes, planes, stride, ds, data_format="NHWC",
                            device=device).train()
    composed = copy.deepcopy(fused)
    g = torch.Generator(device=device).manual_seed(12)
    x = torch.zeros(N, H, wp_in, inplanes, device=device)
    x[:, :, :wv_in] = torch.rand(N, H, wv_in, inplanes, generator=g, device=device) - 0.5
    wv_out = wv_in // stride
    wp_out = -(-wv_out // 8) * 8
    zero_counts()
    with forced_fused(device == "cpu"):
        zf = fused.forward_fused(x, wv_in, wv_out, wp_out)
        (zf.float() ** 2).sum().backward()
    sync()
    launches = read_counts()
    zero_counts()
    zc = composed(x[:, :, :wv_in].contiguous())
    (zc.float() ** 2).sum().backward()
    sync()
    composed_launches = read_counts()

    def rel(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)).item()

    out_rel = rel(zf[:, :, :wv_out], zc)
    pad_zero = bool((zf[:, :, wv_out:] == 0).all())
    cp = dict(composed.named_parameters())
    grad_rel = {n: rel(p.grad, cp[n].grad) for n, p in fused.named_parameters()}
    cb = dict(composed.named_buffers())
    stats_err = max((b.float() - cb[n].float()).abs().max().item()
                    for n, b in fused.named_buffers())
    worst = max(grad_rel, key=grad_rel.get)
    expected = {"fused_conv_bn": 1, "fused_conv_bn_bwd": 2}
    return dict(name=name, N=N, out_rel=out_rel, pad_zero=pad_zero, max_grad_rel=grad_rel[worst],
                worst_param=worst, stats_max_abs_err=stats_err, tol=BLOCK_TOL,
                launches=launches, expected_launches=expected,
                composed_launches=composed_launches,
                ok=(out_rel <= BLOCK_TOL["out"] and pad_zero
                    and grad_rel[worst] <= BLOCK_TOL["grad"]
                    and stats_err <= BLOCK_TOL["stats"]
                    and (device == "cpu" or launch_check(launches, expected))
                    and not any(composed_launches.values())))


def resnet_batch(B, S, dtype, device, seed=0):
    """bench.py's batch in NHWC: images [B, S, S, 3] uniform in [-1, 1), int32
    labels in [0, 1000)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.rand(B, S, S, 3) * 2 - 1).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 1000, (B,)).astype(np.int32))
    return x.to(device=device, dtype=dtype), y.to(device)


def resnet_train(model, batch, steps, warmup, profiled):
    """TrainStep + Momentum(0.1, 0.9) on one fixed batch: ``warmup`` steps,
    then ``steps`` timed ones with the launch counters zeroed just before."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Momentum

    ce = CrossEntropyLoss()

    def loss_fn(x, y):
        return ce(model(x).float(), y)

    step = TrainStep(model, loss_fn, Momentum(learning_rate=0.1, momentum=0.9))
    losses, ms, launches = timed_steps(step, batch, steps, warmup)
    B, S = batch[0].shape[0], batch[0].shape[1]
    step_ms = sorted(ms)[len(ms) // 2]
    flops = RESNET_TRAIN_FLOPS * B * (S / 224) ** 2
    expected = {"fused_conv_bn": 16 * steps, "fused_conv_bn_bwd": 32 * steps}
    finite_stats = all(bool(torch.isfinite(b).all()) for b in model.buffers())
    res = dict(path="resnet", name=f"resnet50_nhwc_b{B}_s{S}", B=B, S=S, warmup=warmup,
               steps=steps, losses=losses, step_ms=step_ms, step_ms_all=ms,
               images_per_s=B / step_ms * 1e3, flops_per_step=flops,
               mfu=flops / (step_ms / 1e3) / H100_BF16_FLOPS, params=model.num_params,
               peak_mem_bytes=(torch.cuda.max_memory_allocated()
                               if torch.cuda.is_available() else None),
               running_stats_finite=finite_stats, launches=launches,
               expected_launches=expected)
    res["ok"] = (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
                 and finite_stats and launch_check(launches, expected))
    if profiled:
        res["profile"] = train_profile(step, batch, resnet_kind, RESNET_KINDS,
                                       ("other", "bn_elementwise"))
    return res


@torch.no_grad()
def resnet_eval(model, batch):
    """The eval forward: finite logits [B, 1000], no fused launch (eval runs
    the composed layers, as in the reference)."""
    model.eval()
    zero_counts()
    logits = model(batch[0])
    sync()
    launches = read_counts()
    model.train()
    return dict(logits_shape=list(logits.shape), finite=bool(torch.isfinite(logits).all()),
                launches=launches,
                ok=bool(torch.isfinite(logits).all()) and not any(launches.values()))


def resnet_phase(card, device="cuda", B=RESNET_B, S=RESNET_S, steps=RESNET_STEPS,
                 warmup=RESNET_WARMUP, dtype=torch.bfloat16, block_batch=4, blocks=None):
    """Block parity at each stage's shape (f32), then bench.py's ResNet-50
    training in NHWC through TrainStep + Momentum, and its eval forward."""
    from paddle_tpu_torch.vision.models import resnet50

    parity = []
    for spec in RESNET_BLOCKS if blocks is None else blocks:
        r = block_parity(spec, device, block_batch)
        parity.append(r)
        log(f"  block parity {r['name']} (batch {r['N']}, f32): out {r['out_rel']:.2e}, worst "
            f"grad {r['max_grad_rel']:.2e} ({r['worst_param']}), stats "
            f"{r['stats_max_abs_err']:.2e} (tol {r['tol']}); pad columns zero "
            f"{r['pad_zero']}; launches {r['launches']} (expected {r['expected_launches']}), "
            f"composed {r['composed_launches']}; {'ok' if r['ok'] else 'FAIL'} [{card}]")
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = resnet50(num_classes=1000, data_format="NHWC", device=device, dtype=dtype)
    model.init_weights(torch.Generator(device=device).manual_seed(0))
    batch = resnet_batch(B, S, dtype, device)
    sync()
    log(f"  model: {model.num_params / 1e6:.2f} M params, NHWC, {dtype}, init "
        f"{time.perf_counter() - t0:.1f} s")
    with forced_fused(device == "cpu"):
        run = resnet_train(model, batch, steps, warmup, profiled=device != "cpu")
    ev = resnet_eval(model, batch)
    del model
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    log(f"  {run['name']}: step {run['step_ms']:.2f} ms (median of {run['steps']}), "
        f"{run['images_per_s']:.1f} images/s, MFU {run['mfu']:.4f}, peak "
        f"{(run['peak_mem_bytes'] or 0) / 2**30:.2f} GiB; loss {run['losses'][0]:.4f} -> "
        f"{run['losses'][-1]:.4f}; launches {run['launches']} (expected "
        f"{run['expected_launches']}); profile {json.dumps(run.get('profile'))}; "
        f"{'ok' if run['ok'] else 'FAIL'} [{card}]")
    log(f"  eval forward: logits {ev['logits_shape']} finite {ev['finite']}; launches "
        f"{ev['launches']} (expected none); {'ok' if ev['ok'] else 'FAIL'} [{card}]")
    return dict(block_parity=parity, eval=ev), [run]


def build_model(dtype="bfloat16"):
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.llama2_7b(num_hidden_layers=LAYERS, dtype=dtype)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda").eval()
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"  model: {model.num_params / 1e9:.3f} B params, {LAYERS} layers, {dtype}, "
        f"init {time.perf_counter() - t0:.1f} s")
    return model


# ------------------------------------------------------------------ dtypes

@torch.no_grad()
def forward_run(model, name, B, S, seed):
    """The no-cache forward of ids [B, S] through the reference's routing
    (flash at S >= 1024, the encoder at S <= 512, at the model's type)
    against the same forward with dense-math attention
    (use_flash_attention=False): logits within the type's gate, one launch
    of the routed kernel a layer."""
    cfg, dt = model.config, model_dtype(model)
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(1, cfg.vocab_size, (B, S), generator=g).to(model.device)
    zero_counts()                                        # the run starts here
    t0 = time.perf_counter()
    got = model(ids).float()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()                             # ... and ends here
    kern = prefill_kernel(cfg, B, S)
    expected = {kern: cfg.num_hidden_layers} if kern else {}
    flash = cfg.use_flash_attention
    cfg.use_flash_attention = False
    try:
        t0 = time.perf_counter()
        want = model(ids).float()
        torch.cuda.synchronize()
        dense_wall = time.perf_counter() - t0
    finally:
        cfg.use_flash_attention = flash
    drift = (got - want).abs().max().item()
    finite = bool(torch.isfinite(got).all())
    tol = logit_tol(dt)
    return dict(path="forward", name=name, B=B, S=S, dtype=TAGS[dt], kernel=kern, wall_s=wall,
                dense_wall_s=dense_wall, launches=launches, expected_launches=expected, max_logit_drift=drift,
                logit_std=want.std().item(), logit_tol=tol, finite=finite,
                argmax_equal_share=(got.argmax(-1) == want.argmax(-1)).float().mean().item(),
                ok=finite and drift <= tol and launch_check(launches, expected))


def log_dtype_run(r, card):
    if r["path"] == "generate":
        tf = r["teacher_forced"]
        log(f"  generate {r['name']}: prefill {r['prefill_kernel']}, wall {r['wall_s']:.3f} s "
            f"({r['decode_tok_per_s']:.1f} tok/s incl. prefill); launches {r['launches']} "
            f"(expected {r['expected_launches']}); drift max {tf['max_logit_drift']:.2e} "
            f"(tol {tf['logit_tol']}), {tf['exact']} exact, {tf['near_ties']} near-ties, "
            f"{tf['failures']} failures; {'ok' if r['ok'] else 'FAIL'} [{card}]")
    elif r["path"] == "forward":
        log(f"  forward {r['name']} ({r['dtype']}): {r['kernel']}, wall {r['wall_s']:.3f} s "
            f"(dense math {r['dense_wall_s']:.3f} s); "
            f"launches {r['launches']} (expected {r['expected_launches']}); logit drift vs "
            f"dense math {r['max_logit_drift']:.2e} (tol {r['logit_tol']}, logit std "
            f"{r['logit_std']:.3f}), argmax equal {r['argmax_equal_share']:.4f}; "
            f"{'ok' if r['ok'] else 'FAIL'} [{card}]")
    elif r["path"] == "bert_eval":
        log(f"  BERT-base eval {r['name']}: MLM logits drift {r['max_logit_drift']:.2e} "
            f"({r['drift_in_std']:.2e} std; tol {r['logit_tol_in_std']} std); wall "
            f"{r['wall_ms']:.2f} ms, peak {(r['peak_mem_bytes'] or 0) / 2**30:.2f} GiB; launches "
            f"{r['launches']} (expected {r['expected_launches']}); "
            f"{'ok' if r['ok'] else 'FAIL'} [{card}]")
    else:
        log_run(r, card)


def dtypes_phase(card):
    """LLaMA-2-7B widths, LAYERS layers, at float32 (the config's default):
    generate() on a float32 and an int8 static cache, the dense engine's 12
    requests, the paged engine's 12 and then 4 on an int8 pool, the
    no-cache forward at [1, 2048] (flash) and [4, 512] (the encoder), and
    the paged decode tick under the profiler; then at float16: generate()
    on its float16 static cache, the paged engine's 12 requests (float32
    pools, as for every model that is not bf16) and the no-cache forwards at
    [1, 2048] (flash) and [4, 512] (the encoder), both on the tensor cores;
    then BERT-base at float32 and at float16 (eval, [32, 128]; float16
    through the fused-LN kernels and the tensor-core encoder kernel at
    float16).  Decode, paged, flash and the encoder (generate()'s prefill,
    the forwards, BERT's eval) run the tensor-core kernels at either type,
    float32 as split-bf16 products."""
    import numpy as np

    runs, extra = [], {}
    for dt in ("float32", "float16"):
        model = build_model(dt)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if dt == "float32":
            rng = np.random.default_rng(0)
            part = [generate_run(model, "b4_s1024_f32", 4, 1024, 32, None, 1),
                    generate_run(model, "b4_s1024_int8", 4, 1024, 32, "int8", 1),
                    serve_dense(model, REQUESTS, np.random.default_rng(10), None, 1, 4, True),
                    serve_paged(model, REQUESTS, rng, None, 4, True),
                    serve_paged(model, INT8_REQUESTS, rng, "int8", 0, False),
                    forward_run(model, "s2048_flash", 1, 2048, 3),
                    forward_run(model, "b4_s512_encoder", 4, 512, 4)]
            extra["f32_paged_decode_tick"] = decode_breakdown(model, "paged")
            log(f"  float32 paged decode tick, 8 slots at ~1k context: "
                f"{json.dumps(extra['f32_paged_decode_tick'])} [{card}]")
        else:
            part = [generate_run(model, "b4_s1024_f16", 4, 1024, 32, None, 1),
                    serve_paged(model, REQUESTS, np.random.default_rng(0), None, 4, True),
                    forward_run(model, "s2048_flash", 1, 2048, 3),
                    forward_run(model, "b4_s512_encoder", 4, 512, 4)]
        extra[f"{dt}_wall_s"] = time.perf_counter() - t0
        extra[f"{dt}_peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        log(f"  {dt}: {len(part)} runs in {extra[f'{dt}_wall_s']:.1f} s, peak memory "
            f"{extra[f'{dt}_peak_mem_bytes'] / 2**30:.2f} GiB [{card}]")
        for r in part:
            r["model_dtype"] = dt
            log_dtype_run(r, card)
        runs += part
        del model
        torch.cuda.empty_cache()
    for dt, tol in ((torch.float32, F32_LOGIT_TOL), (torch.float16, F16_LOGIT_TOL)):
        bert = ernie_model(12, dtype=dt, dropout=False)
        ev = ernie_eval(bert, ernie_batch(bert.config, 32, 128, ERNIE_P, 0, "cuda"), tol=tol)
        ev.update(path="bert_eval", name=f"base_b32_s128_{TAGS[dt]}", dtype=TAGS[dt],
                  model_dtype=str(dt).replace("torch.", ""))
        log_dtype_run(ev, card)
        runs.append(ev)
        del bert
        torch.cuda.empty_cache()
    return runs, extra


# ------------------------------------------------------------------- main

PHASES = ("device", "build", "kernels", "generate", "dense_engine", "paged_engine",
          "ticks", "prefix", "spec", "tenants", "tiers", "graphs", "gpt", "dtypes", "train",
          "ernie", "resnet")
PATH_TITLES = {"generate": "model.generate() on the static cache",
               "dense_engine": "the dense LLMEngine",
               "paged_engine": "the paged LLMEngine",
               "ticks": "both engines' decode ticks in turns",
               "prefix": "the paged LLMEngine with its prefix cache",
               "spec": "speculative decoding (spec_k=4)",
               "tenants": "the paged LLMEngine with LoRA adapters and constraints",
               "tiers": "the paged LLMEngine with its host and disk kv tiers",
               "graphs": "both engines and generate() on CUDA graphs against eager"}
PATH_PHASES = {"dense_engine": dense_engine_phase, "paged_engine": paged_engine_phase,
               "ticks": ticks_phase, "prefix": prefix_phase, "spec": spec_phase,
               "tenants": tenants_phase, "tiers": tiers_phase, "graphs": graphs_phase}


def phase_done(report, name, t0):
    """Record and log a phase's wall seconds (the command's time budget)."""
    report.setdefault("phase_s", {})[name] = time.perf_counter() - t0
    log(f"[{name}] {report['phase_s'][name]:.1f} s")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "paddle_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: the paddle_tpu_torch package is not beside this "
              f"file (in {ROOT})", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from paddle_tpu_torch.ops import _build
    report = {"card": card_line(), "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(), "paths": []}
    ok = True
    log(f"[device] {report['card']} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {report['kind']} x{report['count']}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[device] TF32 off for matmul and cuDNN: float32 products run in full float32")
    paths = [ph for ph in PHASES[3:] if ph in phases]
    if phases & {"build", "kernels", *paths}:
        t0 = time.perf_counter()
        built = _build.build_all(ptxas_verbose="build" in phases)
        report["build_s"] = time.perf_counter() - t0
        log(f"[build] {', '.join(built)} in {report['build_s']:.1f} s "
            f"-> {_build.BUILD_DIR}")
        report["ptxas"] = {}
        for name, b in built.items():
            for line in b["log"].splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build]   {name}: {line.strip()}")
                if any(w in line for w in ("registers", "spill", "entry function")):
                    report["ptxas"].setdefault(name, []).append(line.strip())
        report["sass"] = {name: sass_counts(built[name]["path"]) for name in HOPPER_LIBS}
        for name, n in report["sass"].items():
            log(f"[build]   {name}: SASS {n['HGMMA']} HGMMA (wgmma), {n['UTMALDG']} UTMALDG "
                f"(TMA loads), {n['UBLKCP']} UBLKCP (bulk copies)")
        report["hgmma_by_instance"] = {name: hgmma_by_instance(name, built[name]["path"])
                                       for name in TYPED_LIBS}
        for name, n in report["hgmma_by_instance"].items():
            log(f"[build]   {name}: HGMMA by instantiation: "
                + ", ".join(f"{k} {v}" for k, v in sorted(n.items())))
        spills = [f"{name}: {line}" for name in HOPPER_LIBS
                  for line in report["ptxas"].get(name, [])
                  if "spill" in line and not line.startswith("0 bytes stack frame, 0 bytes spill")]
        report["hopper_spills"] = spills
        if spills:
            log("[build] FAIL: ptxas spills in a Hopper library: " + "; ".join(spills))
            ok = False
    if "kernels" in phases:
        t_ph = time.perf_counter()
        log("[kernels] every kernel vs its plain version")
        report["kernels"] = kernel_phase()
        ok &= all(c["ok"] for cases in report["kernels"].values() for c in cases)
        missing = [(name, op) for name, n in report["sass"].items()
                   for op in HOPPER_LIBS[name] if n[op] == 0]
        for name, op in missing:
            log(f"[kernels] FAIL: the {name} library has no {op} instruction")
        ok &= not missing
        untyped, unequal = typed_faults(report["hgmma_by_instance"])
        for inst in untyped:
            log(f"[kernels] FAIL: no HGMMA in the instantiation {inst}")
        for pair in unequal:
            log(f"[kernels] FAIL: HGMMA differs between bf16 and float16 in {pair}")
        ok &= not untyped and not unequal
        phase_done(report, "kernels", t_ph)
    serving = [ph for ph in paths if ph not in ("gpt", "dtypes", "train", "ernie", "resnet")]
    if serving:
        model = build_model()
        for ph in serving:
            t_ph = time.perf_counter()
            log(f"[{ph}] LLaMA-2-7B widths through {PATH_TITLES[ph]}")
            if ph == "generate":
                runs = generate_phase(model, report["card"])
            else:
                runs, tick = PATH_PHASES[ph](model, report["card"])
                if tick is not None:
                    report[f"{ph}_decode_tick"] = tick
            report["paths"] += runs
            ok &= all(r["ok"] for r in runs)
            phase_done(report, ph, t_ph)
        del model
        torch.cuda.empty_cache()
    if "gpt" in paths:
        t_ph = time.perf_counter()
        log("[gpt] GPTConfig() (hidden 768, 12 layers) through generate() and both engines")
        runs = gpt_phase(report["card"])
        report["paths"] += runs
        ok &= all(r["ok"] for r in runs)
        phase_done(report, "gpt", t_ph)
    if "dtypes" in paths:
        t_ph = time.perf_counter()
        log("[dtypes] LLaMA-2-7B widths at float32 and float16, BERT-base at float32 and "
            "float16: every attention kernel on the tensor cores (float32 as split-bf16 "
            "products)")
        runs, report["dtypes"] = dtypes_phase(report["card"])
        report["paths"] += runs
        ok &= all(r["ok"] for r in runs)
        phase_done(report, "dtypes", t_ph)
    if "train" in paths:
        t_ph = time.perf_counter()
        log("[train] bench.py's LLaMA training configuration through TrainStep + AdamW, at "
            "16 heads of 128 and 8 heads of 256")
        report["train_grad_parity"], runs = train_phase(report["card"])
        report["paths"] += runs
        ok &= all(r["ok"] for r in report["train_grad_parity"] + runs)
        phase_done(report, "train", t_ph)
    if "ernie" in paths:
        t_ph = time.perf_counter()
        log("[ernie] bench.py's ERNIE-base pretraining through TrainStep + AdamW, bf16 and "
            "float32; float16 gradient parity through the fused-LN and tensor-core encoder "
            "kernels")
        report["ernie_checks"], runs = ernie_phase(report["card"])
        report["ernie_f32_checks"], f32_runs = ernie_phase(
            report["card"], dtype=torch.float32, steps=ERNIE_F32_STEPS, warmup=ERNIE_F32_WARMUP)
        report["ernie_f16_parity"] = ernie_f16_parity(report["card"])
        runs += f32_runs
        report["paths"] += runs
        ok &= all(r["ok"] for r in list(report["ernie_checks"].values())
                  + list(report["ernie_f32_checks"].values())
                  + [report["ernie_f16_parity"]] + runs)
        phase_done(report, "ernie", t_ph)
    if "resnet" in paths:
        t_ph = time.perf_counter()
        log("[resnet] bench.py's ResNet-50 in NHWC through TrainStep + Momentum")
        report["resnet_checks"], runs = resnet_phase(report["card"])
        report["paths"] += runs
        ok &= all(r["ok"] for r in report["resnet_checks"]["block_parity"]
                  + [report["resnet_checks"]["eval"]] + runs)
        phase_done(report, "resnet", t_ph)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    if not ok:
        log("chip_smoke: FAILED (see above)")
        return 1
    if "kernels" in report:
        # launches: the sum over every path's run (each zeroed just before);
        # an instantiation's row sums its wrapper over the runs at its head
        # dim or dtype
        launches = {}
        # float16 training is no path yet: ERNIE's float16 gradient parity is
        # the one run of the float16 backward kernels, so it counts too
        counted_runs = report["paths"] + ([report["ernie_f16_parity"]]
                                          if "ernie_f16_parity" in report else [])
        for run in counted_runs:
            tags = [t for (key, val), t in INSTANTIATIONS.items() if run.get(key) == val]
            tags = [""] + tags + (["".join(tags)] if len(tags) > 1 else [])
            for k, n in run["launches"].items():
                for t in tags:
                    if k + t in KERNELS:
                        launches[k + t] = launches.get(k + t, 0) + n
        line = []
        for name, (source, replaces) in KERNELS.items():
            cases = report["kernels"][name]
            main_case = cases[0]  # the shape its main path runs most
            line.append(dict(
                name=name, route="cuda", source=source, replaces=replaces,
                launches=launches.get(name, 0),
                max_abs_err=max(c["max_abs_err"] for c in cases),
                ms=main_case["ms"], plain_ms=main_case["plain_ms"],
                bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
                library_ms=main_case["library_ms"]))
        log(json.dumps({"kernels": line}))
    log(report["card"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": report["kind"],
                                             "count": report["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
