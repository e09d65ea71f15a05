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
                    kernels and SDPA timed from CUDA-graph replays); one
                    of the seven wgmma libraries (with fused_conv_bn)
                    without HGMMA or UTMALDG fails the phase, naming it.  The
                    encoder cases include q, k, v as the three strided
                    slices of one packed [B, S, 3, H, D] tensor, fed to both
                    kernels with no copy, and time the kernels and their
                    SDPA yardsticks from CUDA-graph replays (device time).
  4. generate     — model.generate() at LLaMA-2-7B widths (32 layers, bf16,
                    random weights from a seed): ids [4, 1024] (flash
                    prefill) on a bf16 and an int8 cache, and ids [8, 256]
                    (encoder prefill), 32 new tokens each, every decode
                    step through the static decode kernel.
  5. dense_engine — the dense LLMEngine on the same model: 12 requests
                    with prompts in the buckets 64, 128, 256 and 2048,
                    then 4 on an int8 cache at decode_chunk=4.
  6. paged_engine — the paged LLMEngine on the same model: 12 requests,
                    then 4 on an int8 pool.
In phases 4-6 and 8-10 the launch counters are zeroed just before each run
and must match the work the run did.  For the greedy outputs, each path's logits
(teacher-forced) must stay within LOGIT_TOL (INT8_LOGIT_TOL on an int8
cache) of the no-cache forward's with dense-math attention, and each token
must be the forward's argmax but at near-ties.  Each engine phase ends with
a few decode ticks of 8 busy slots under torch.profiler: where a tick's
time goes.
  7. ticks        — both engines' decode ticks, 8 busy slots, in turns
                    (dense, paged, paged, dense), unprofiled.
  8. train        — bench.py's training configuration (hidden 2048, 12
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
  9. ernie        — bench.py's ERNIE-base pretraining (BertConfig.base(),
                    bf16, B 512 x S 128, 20 masked positions, dropout 0.1,
                    random weights and batch from seed 0): gradient parity
                    of every parameter against the composed/dense paths at
                    2 layers and rate 0; the same loss from the same seed();
                    the eval forward's MLM logits at 12 layers against the
                    composed forward's; then TrainStep + AdamW(1e-4,
                    weight_decay=0.01), 2 warm-up and 8 timed steps, fused
                    LN forward and backward 24 and encoder forward and
                    backward 12 launches a step with no copy of q, k or v,
                    one step profiled.
 10. resnet       — bench.py's ResNet-50 training in NHWC, the layout that
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
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12        # dense bf16 tensor-core peak
# The main paths' model and the engines' traffic: LLaMA-2-7B's depth, 12
# requests on a bf16 cache, then 4 on an int8 cache.
LAYERS, REQUESTS, INT8_REQUESTS = 32, 12, 4
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
# kernel -> (its source, the TPU kernel it replaces)
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
}
# Backward kernels vs their plain versions: max |kernel - plain| over max
# |plain|, for each of dQ, dK and dV, with dO ~ N(0, 1).  The kernels round
# dS (and, for flash's dV, P) to bf16 where the reference does and write
# bf16; the plain version runs in f32 on the same bf16 values.  Sound runs
# on an H100 gave at most 4.6e-3; the planted faults below come out at
# 0.157 or more (dlse ignored is the closest).
BWD_RTOL = 1e-2
# Logit drift: max |paged-path logit - no-cache-forward logit| over every
# generated position of the greedy requests (both bf16 through 32 layers,
# rounding in different orders).  Logits here are ~N(0, 0.5); sound runs on
# an H100 drift by at most 0.041.
LOGIT_TOL = 0.1
# The same drift with an int8 kv cache, against the same bf16 forward: the
# cache rounds every K and V element to its row's absmax / 127, on top of
# the bf16 differences above.
INT8_LOGIT_TOL = 0.5


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

def paged_case(name, B, S, H, Hkv, offsets, quant, seed, ps=128, D=128, pages=None):
    """One kernel-vs-plain case.  ``pages`` narrows the page table below what
    the longest row would need, as when a chunk's padded rows run past a
    pool of max_seq_len: keys past the table are never visited."""
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


def randn(g, shape, std=1.0):
    return (torch.randn(*shape, generator=g, device="cuda") * std).bfloat16()


def decode_case(name, B, H, Hkv, offsets, quant, seed, L=2048, D=128):
    """Static decode kernel vs its plain version: S = 1 against a head-major
    [B, Hkv, L, D] cache whose rows past each slot's valid length are
    poisoned (1e4), so a read past the length shows."""
    from paddle_tpu_torch.models.kv_cache import _quantize_kv
    from paddle_tpu_torch.ops import decode_attention as da

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = randn(g, (B, 1, H, D), Q_STD)
    k, v = randn(g, (B, Hkv, L, D)), randn(g, (B, Hkv, L, D))
    off = torch.tensor(offsets, dtype=torch.int64, device="cuda")
    for b, o in enumerate(offsets):
        k[b, :, o + 1:], v[b, :, o + 1:] = 1e4, 1e4
    if quant:
        (k, ks), (v, vs) = _quantize_kv(k), _quantize_kv(v)
        scales = (ks.contiguous(), vs.contiguous())
    else:
        scales = (None, None)
    lengths = (off + 1).to(torch.int32)
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
               KERNEL_RTOL["int8" if quant else "bf16"], B=B, S=1, H=H, Hkv=Hkv, L=L,
               D=D, cache="int8" if quant else "bf16", max_len=max(offsets) + 1,
               same_bits=same_bits, ok=same_bits)
    res["ms"], res["eager_ms"] = graph_ms(kernel), cuda_ms(kernel, 50)  # as paged_case
    res["plain_ms"] = cuda_ms(plain, 10)
    # yardstick: SDPA on the dequantized, GQA-expanded cache with a length
    # mask; timed here, never used by the port
    kd, vd = (k.bfloat16() * scales[0].bfloat16()[..., None],
              v.bfloat16() * scales[1].bfloat16()[..., None]) if quant else (k, v)
    kd, vd = kd.repeat_interleave(H // Hkv, 1), vd.repeat_interleave(H // Hkv, 1)
    mask = torch.arange(L, device="cuda")[None, None, None, :] <= off[:, None, None, None]
    qh = q.transpose(1, 2)
    res["library_ms"] = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kd, vd, attn_mask=mask))
    # least time: q and out once, the valid K/V rows (and scales) once, lengths
    keys = sum(o + 1 for o in offsets)
    nbytes = (2 * q.numel() * 2 + keys * Hkv * D * (1 if quant else 2) * 2
              + (keys * Hkv * 4 * 2 if quant else 0) + B * 4)
    res["bound_ms"], res["bound_by"] = bound(nbytes, 4.0 * D * H * keys)
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


def seq_attention_case(name, kind, B, H, Sq, Sk, D, causal, seed):
    """Flash or encoder kernel vs its plain version on q, k, v
    [B, S, H, D]; planted faults are uniform weights and each row's key
    range one short (its causal end, or the last key when not causal)."""
    from paddle_tpu_torch.ops import encoder_attention as ea
    from paddle_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = randn(g, (B, Sq, H, D), Q_STD)
    k, v = randn(g, (B, Sk, H, D)), randn(g, (B, Sk, H, D))
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
                 ok=lse_err <= LSE_TOL and same)
    res = gate(name, got, want, faults, KERNEL_RTOL["bf16"], kind=kind, B=B, H=H, Sq=Sq,
               Sk=Sk, D=D, causal=causal, **extra)
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


def flash_bwd_case(name, B, H, Sq, Sk, D, causal, seed, with_dlse=False):
    """The flash backward kernels (dq, dkv) vs ``_flash_bwd_dense`` on O and
    LSE from the plain forward; planted faults: dsum taken as 0, each
    row's key range one short, and (with dlse) dlse ignored."""
    from paddle_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = randn(g, (B, Sq, H, D), Q_STD)
    k, v = randn(g, (B, Sk, H, D)), randn(g, (B, Sk, H, D))
    do = randn(g, (B, Sq, H, D))
    scale = 1.0 / D ** 0.5
    o32, lse = fa._flash_dense(q.float(), k.float(), v.float(), causal, scale)
    o = o32.bfloat16()
    dlse = (torch.randn(B, H, Sq, generator=g, device="cuda") if with_dlse else None)
    args = (q, k, v, o, do, lse, causal, scale, dlse)
    dq = fa.flash_attention_dq_kernel(*args)
    dk, dv = fa.flash_attention_dkv_kernel(*args)
    dq2 = fa.flash_attention_dq_kernel(*args)  # the same bits on a second run
    dk2, dv2 = fa.flash_attention_dkv_kernel(*args)
    torch.cuda.synchronize()
    same = {"dq": bool(torch.equal(dq, dq2)),
            "dkv": bool(torch.equal(dk, dk2) and torch.equal(dv, dv2))}
    want = fa._flash_bwd_dense(q.float(), k.float(), v.float(), o.float(), lse, do.float(),
                               causal, scale, dlse)
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
    shape = dict(kind="flash", B=B, H=H, Sq=Sq, Sk=Sk, D=D, causal=causal, dlse=with_dlse)
    res = {"dq": bwd_gate(name, (dq,), want[:1], {f: t[:1] for f, t in faults.items()},
                          BWD_RTOL, same_bits=same["dq"], ok=same["dq"], **shape),
           "dkv": bwd_gate(name, (dk, dv), want[1:], {f: t[1:] for f, t in faults.items()},
                           BWD_RTOL, same_bits=same["dkv"], ok=same["dkv"], **shape)}
    iters = 10
    plain_ms = cuda_ms(lambda: fa._flash_bwd_dense(q, k, v, o, lse, do, causal, scale, dlse), 3)
    library_ms = (None if with_dlse or (causal and Sq != Sk)
                  else sdpa_bwd_ms(q, k, v, do, causal, iters))
    pairs = B * H * visible_pairs(Sq, Sk, causal)
    nq, nk = B * Sq * H * D * 2, B * Sk * H * D * 2     # bytes of one q-side / k-side tensor
    nstat = B * H * Sq * 4 * (2 if with_dlse else 1)
    ins = 3 * nq + 2 * nk + nstat                       # q, o, dO, k, v, lse (, dlse)
    for key, fn, out_bytes, ops in (
            ("dq", lambda: fa.flash_attention_dq_kernel(*args), nq, 6.0 * D * pairs),
            ("dkv", lambda: fa.flash_attention_dkv_kernel(*args), 2 * nk, 8.0 * D * pairs)):
        r = res[key]
        r["ms"] = cuda_ms(fn, iters)
        r["plain_ms"], r["library_ms"] = plain_ms, library_ms
        r["bound_ms"], r["bound_by"] = bound(ins + out_bytes, ops)
    res["function_bound_ms"], res["function_bound_by"] = bound(ins + nq + 2 * nk,
                                                               10.0 * D * pairs)

    def autograd_bwd():  # the backward as _FlashAttention runs it: stats once, dq, dkv
        stats = fa.flash_attention_bwd_stats(o, do, lse, dlse)
        fa.flash_attention_dq_kernel(*args, stats=stats)
        fa.flash_attention_dkv_kernel(*args, stats=stats)

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
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype]
    x = torch.randn(n, h, generator=g, device="cuda").to(dt)
    y = torch.randn(n, h, generator=g, device="cuda").to(dt)
    gamma = (1.0 + 0.1 * torch.randn(h, generator=g, device="cuda")).to(dt)
    beta = (0.1 * torch.randn(h, generator=g, device="cuda")).to(dt)
    dz = torch.randn(n, h, generator=g, device="cuda").to(dt)
    sd = seed_pair(g)
    keep = fl.dropout_keep(sd, n, h, rate) if rate > 0 else None
    plan = fl._plan(h, dt == torch.bfloat16)
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
               KERNEL_RTOL["bf16"], same_bits=same_fwd, **shape)
    s_err = (s.float() - want_s.float()).abs().max().item()
    fwd.update(s_max_abs_err=s_err, ok=fwd["ok"] and same_fwd and s_err <= KERNEL_RTOL["bf16"]
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
    bwd = bwd_gate(name, gots, bwd_plain(), bfaults, BWD_RTOL, same_bits=same_bwd, teams=teams,
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
    want, _ = fl._fused_ln_dense(res, x, w, b, None, rate, 1e-5, True, keep)
    err = (out.float() - want.float()).abs().max().item() / want.float().abs().max().item()
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
    the ERNIE shape first, and the Philox check."""
    out = {"fused_ln": [], "fused_ln_bwd": []}
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
            ("h32768_f32_drop", 1024, 32768, "f32", DROP_RATE)]):
        fwd, bwd = fused_ln_case(name, n, h, dtype, rate, 90 + i)
        out["fused_ln"].append(fwd)
        out["fused_ln_bwd"].append(bwd)
        log_case("fused_ln", fwd)
        log_case("fused_ln_bwd", bwd)
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
    """Backward cases: {kernel name: [case, ...]}, the training shapes first."""
    out = {"flash_attention_dq": [], "flash_attention_dkv": [], "encoder_attention_bwd": []}
    for i, (name, B, H, Sq, Sk, D, causal, dlse) in enumerate([
            ("train_s2048", 8, 16, 2048, 2048, 128, True, False),   # the bench's step
            ("7b_heads_s2048", 1, 32, 2048, 2048, 128, True, False),
            ("bh64_s1024_d64", 2, 32, 1024, 1024, 64, True, False),
            ("sq1024_sk2048_causal", 1, 32, 1024, 2048, 128, True, False),
            ("sq1024_sk1536_full", 1, 32, 1024, 1536, 128, False, False),
            ("s2048_dlse", 2, 16, 2048, 2048, 128, True, True),
            ("s264_ragged_causal", 2, 8, 264, 264, 128, True, False)]):
        r = flash_bwd_case(name, B, H, Sq, Sk, D, causal, 60 + i, dlse)
        for key in ("dq", "dkv"):
            r[key]["function_bound_ms"] = r["function_bound_ms"]
            r[key]["backward_ms"] = r["backward_ms"]
            out[f"flash_attention_{key}"].append(r[key])
            log_case(f"flash_attention_{key}", r[key])
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
# sides (measured on an H100: within 2e-6 of max).
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
    for c in cases:
        log_case("paged_attention", c)
    return cases


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
            ("s264_ragged_causal", 2, 8, 264, 264, 128, True)]):   # rows past S, masked keys
        out["flash_attention"].append(
            seq_attention_case(name, "flash", B, H, Sq, Sk, D, causal, 20 + i))
        log_case("flash_attention", out["flash_attention"][-1])
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
    out["philox"] = [philox_case()]
    out.update(conv_bn_kernel_cases())
    zero_counts()  # comparison launches do not count
    return out


# The libraries whose SASS must hold the Hopper instructions their design
# rests on, and whose ptxas report must show no spill: those built on
# wgmma_attention.cuh need wgmma (HGMMA) and TMA loads (UTMALDG); fused_ln,
# which has no product, its rows' 1-D bulk copies (UBLKCP).
HOPPER_LIBS = {**{lib: ("HGMMA", "UTMALDG") for lib in (
    "flash_attention", "flash_attention_bwd", "encoder_attention", "encoder_attention_bwd",
    "decode_attention", "paged_attention", "fused_conv_bn")}, "fused_ln": ("UBLKCP",)}
SASS_OPS = ("HGMMA", "UTMALDG", "UBLKCP")


def sass_counts(lib):
    """HGMMA, UTMALDG and UBLKCP instructions in a library's SASS (cuobjdump)."""
    from paddle_tpu_torch.ops import _build

    cuobjdump = str(Path(_build.nvcc_path()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    return {op: sass.count(op) for op in SASS_OPS}


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
            "fused_conv_bn_bwd": fcb.fused_conv_bn_bwd_kernel}


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


def prefill_kernel(cfg, B, S):
    """The kernel a no-cache prefill of [B, S] tokens runs per layer: the
    reference's routing (encoder, flash, or None for dense math)."""
    from paddle_tpu_torch.nn.functional.attention import _reference_kernel

    H, D = cfg.num_attention_heads, cfg.hidden_size // cfg.num_attention_heads
    q = torch.empty(B, S, H, D, device="meta")
    return _reference_kernel(q, q, None, True, "auto")


@torch.no_grad()
def forward_logits(model, prompt, out):
    """The oracle, independent of every kernel under test: the no-cache
    forward with dense-math attention over prompt + out[:-1], its logits at
    the positions that produced out ([n, V] f32)."""
    cfg = model.config
    flash, cfg.use_flash_attention = cfg.use_flash_attention, False
    try:
        seq = torch.tensor(list(prompt) + list(out[:-1]), device=model.device)[None]
        return model(seq)[0, len(prompt) - 1:].float()
    finally:
        cfg.use_flash_attention = flash


def judge(cases, tol):
    """cases: [(tokens, forward logits [n, V], path logits [n, V])].  The
    path's logits must lie within ``tol`` of the forward's; each token must
    be the forward's argmax, unless the forward's top-2 gap is under twice
    the drift this run measured, the most by which two logits can trade
    places."""
    per, drift = [], []
    for toks, want, path in cases:
        d = (path - want).abs().amax(-1).tolist()
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
    # a short run first, so that the timed one pays no first launch of
    # this cache's decode path
    model.generate(ids[:, :8], max_new_tokens=2, cache_dtype=cache_dtype)
    torch.cuda.synchronize()
    zero_counts()                                        # the run starts here
    t0 = time.perf_counter()
    out = model.generate(ids, max_new_tokens=n_new, cache_dtype=cache_dtype)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()                             # ... and ends here
    L = cfg.num_hidden_layers
    expected = {"decode_attention": L * (n_new - 1)}
    kern = prefill_kernel(cfg, B, S0)
    if kern:
        expected[kern] = L
    path = static_path_logits(model, ids, out, cache_dtype)
    verdict = judge([(out[b].tolist(), forward_logits(model, ids[b].tolist(), out[b].tolist()),
                      path[b]) for b in range(B)],
                    INT8_LOGIT_TOL if cache_dtype else LOGIT_TOL)
    valid = tuple(out.shape) == (B, n_new) and bool(((out >= 0) & (out < cfg.vocab_size)).all())
    res = dict(path="generate", name=name, B=B, prompt=S0, new_tokens=n_new,
               cache=cache_dtype or "bf16", prefill_kernel=kern, wall_s=wall,
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
                         max_new=int(rng.integers(32, 65)),
                         sampled=sampled_every > 0 and i % sampled_every == sampled_every - 1))
    return reqs


def serve_dense(model, n_req, rng, cache_dtype, decode_chunk, sampled_every, check):
    from paddle_tpu_torch.inference import LLMEngine

    cfg = model.config
    eng = LLMEngine(model, max_batch_slots=8, max_seq_len=2048, cache_dtype=cache_dtype,
                    decode_chunk=decode_chunk,
                    generator=torch.Generator(device=model.device).manual_seed(5))
    warm = eng.warmup()
    reqs = dense_requests(rng, cfg.vocab_size, n_req, sampled_every)
    zero_counts()                                        # the run starts here
    eng.start()
    t0 = time.perf_counter()
    futs = [eng.submit(r["prompt"], max_new_tokens=r["max_new"], do_sample=r["sampled"],
                       temperature=0.8, top_p=0.9) for r in reqs]
    outs = [f.result(timeout=900) for f in futs]
    wall = time.perf_counter() - t0
    eng.stop()
    launches = read_counts()                             # ... and ends here
    st = eng.stats()
    L = cfg.num_hidden_layers
    expected = {"decode_attention": L * st["decode_steps"]}
    for Lb, count in st["prefill_buckets"].items():
        kern = prefill_kernel(cfg, 1, Lb)
        if kern:
            expected[kern] = expected.get(kern, 0) + L * count
    valid = all(len(o) == r["max_new"] and all(0 <= t < cfg.vocab_size for t in o)
                for o, r in zip(outs, reqs))
    res = dict(path="dense_engine", cache=cache_dtype or "bf16", decode_chunk=decode_chunk,
               requests=n_req, warmup_s=warm, wall_s=wall, launches=launches,
               expected_launches=expected, prefill_buckets=st["prefill_buckets"],
               decode_ticks=st["decode_ticks"], decode_steps=st["decode_steps"],
               decode_tokens=st["decode_tokens"], prefill_s=st["prefill_seconds"],
               decode_s=st["decode_seconds"],
               decode_tok_per_s=st["decode_tokens"] / max(st["decode_seconds"], 1e-9),
               ttft_s=st["ttft_seconds"], prompt_tokens=sum(len(r["prompt"]) for r in reqs),
               valid_ids=valid)
    if check:
        res["teacher_forced"] = judge(
            [(o, forward_logits(model, r["prompt"], o), dense_path_logits(model, eng, r["prompt"], o))
             for r, o in zip(reqs, outs) if not r["sampled"]],
            INT8_LOGIT_TOL if cache_dtype else LOGIT_TOL)
    res["ok"] = (valid and launch_check(launches, expected)
                 and (not check or res["teacher_forced"]["ok"]))
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
        log(f"  dense {r['cache']} decode_chunk={r['decode_chunk']}: {r['requests']} req, "
            f"{r['prompt_tokens']} prompt tok, buckets {r['prefill_buckets']}, "
            f"{r['decode_tokens']} decode tok in {r['decode_ticks']} ticks; launches "
            f"{r['launches']} (expected {r['expected_launches']}); TTFT mean "
            f"{r['ttft_s']['mean']:.3f} s p50 {r['ttft_s']['p50']:.3f} s; decode "
            f"{r['decode_tok_per_s']:.1f} tok/s; wall {r['wall_s']:.1f} s; teacher-forced "
            f"{r.get('teacher_forced')}; {'ok' if r['ok'] else 'FAIL'} [{card}]")
    return runs, tick


# ------------------------------------------------------------ paged engine

@torch.no_grad()
def paged_logits(model, prompt, out, chunk=256, ps=128):
    """The paged path's logits at each generated position of one request,
    teacher-forced: the prompt in prefill chunks, then one decode step for
    each generated token but the last, on a one-slot pool of the model's
    dtype."""
    cfg, dev = model.config, model.device
    D = cfg.hidden_size // cfg.num_attention_heads
    npg = -(-(len(prompt) + len(out)) // ps)
    dt = next(model.parameters()).dtype
    pools = [tuple(torch.zeros(npg + 1, cfg.num_key_value_heads, ps, D,
                               dtype=dt, device=dev) for _ in range(2))
             for _ in range(cfg.num_hidden_layers)]
    tbl = torch.arange(1, npg + 1, dtype=torch.int32, device=dev)[None]

    def caches(pos):
        p = torch.tensor([pos], dtype=torch.int64, device=dev)
        return [(k, v, p, tbl) for k, v in pools]

    for done in range(0, len(prompt), chunk):
        m = min(chunk, len(prompt) - done)
        ids = torch.zeros(1, chunk, dtype=torch.int64)  # the engine pads with 0
        ids[0, :m] = torch.tensor(prompt[done:done + m])
        logits, _ = model.prefill_chunk_step(ids.to(dev), caches(done), m - 1)
    rows = [logits[0, 0]]
    for i, tok in enumerate(out[:-1]):
        logits, _ = model.generate_step(torch.tensor([[tok]], device=dev),
                                        caches(len(prompt) + i))
        rows.append(logits[0, 0])
    return torch.stack(rows).float()


def serve_paged(model, n_req, rng, cache_dtype, sampled_every, check):
    from paddle_tpu_torch.inference import LLMEngine

    cfg = model.config
    eng = LLMEngine(model, max_batch_slots=8, max_seq_len=2048, kv_layout="paged",
                    page_size=128, prefill_chunk=256, prefix_cache=False,
                    cache_dtype=cache_dtype,
                    generator=torch.Generator(device=model.device).manual_seed(5))
    warm = eng.warmup()
    reqs = []
    for i in range(n_req):
        n = int(rng.integers(64, 1501))
        reqs.append(dict(prompt=rng.integers(1, cfg.vocab_size, n).tolist(),
                         max_new=int(rng.integers(32, 65)),
                         sampled=sampled_every > 0 and i % sampled_every == sampled_every - 1))
    zero_counts()                                        # the run starts here
    eng.start()
    t0 = time.perf_counter()
    futs = [eng.submit(r["prompt"], max_new_tokens=r["max_new"],
                       do_sample=r["sampled"], temperature=0.8, top_p=0.9)
            for r in reqs]
    outs = [f.result(timeout=900) for f in futs]
    wall = time.perf_counter() - t0
    eng.stop()
    launches = read_counts()                             # ... and ends here
    st = eng.stats()
    expected = {"paged_attention": cfg.num_hidden_layers * (st["prefill_chunks"]
                                                            + st["decode_ticks"])}
    valid = all(len(o) == r["max_new"] and all(0 <= t < cfg.vocab_size for t in o)
                for o, r in zip(outs, reqs))
    res = dict(path="paged_engine", cache=cache_dtype or "bf16", requests=n_req,
               warmup_s=warm, wall_s=wall, launches=launches, expected_launches=expected,
               prefill_chunks=st["prefill_chunks"], decode_ticks=st["decode_ticks"],
               decode_tokens=st["decode_tokens"], prefill_s=st["prefill_seconds"],
               decode_s=st["decode_seconds"],
               decode_tok_per_s=st["decode_tokens"] / max(st["decode_seconds"], 1e-9),
               ttft_s=st["ttft_seconds"], prompt_tokens=sum(len(r["prompt"]) for r in reqs),
               valid_ids=valid, preemptions=st["preemptions"])
    if check:
        res["teacher_forced"] = judge(
            [(o, forward_logits(model, r["prompt"], o), paged_logits(model, r["prompt"], o))
             for r, o in zip(reqs, outs) if not r["sampled"]], LOGIT_TOL)
    res["ok"] = (valid and launch_check(launches, expected)
                 and (not check or res["teacher_forced"]["ok"]))
    del eng
    torch.cuda.empty_cache()
    return res


def busy_engine(model, layout):
    """An engine of either layout with all 8 slots decoding at about 1k
    tokens of context."""
    import numpy as np

    from paddle_tpu_torch.inference import LLMEngine

    kw = (dict(kv_layout="paged", page_size=128, prefill_chunk=256, prefix_cache=False)
          if layout == "paged" else {})
    eng = LLMEngine(model, max_batch_slots=8, max_seq_len=2048, **kw)
    rng = np.random.default_rng(1)
    for _ in range(8):
        eng.submit(rng.integers(1, model.config.vocab_size, 1000).tolist(), max_new_tokens=96)
    while eng.stats()["active_slots"] < 8:  # prefill every prompt
        eng.step()
    return eng


def tick_ms(eng, ticks):
    """Host wall per decode tick, unprofiled, over ``ticks`` ticks."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        eng.step()
    return (time.perf_counter() - t0) * 1e3 / ticks


def decode_breakdown(model, layout, ticks=8):
    """Where one decode tick's time goes with all 8 slots busy: host wall
    per tick (unprofiled, then under torch.profiler) and the device time of
    the kernels the ticks ran, by kind.  Informational: a profiler that
    records no device events gives "not measured", not a failure."""
    eng = busy_engine(model, layout)
    res = dict(layout=layout, ticks=ticks, slots=8, wall_ms_per_tick=tick_ms(eng, ticks))
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
        log(f"  paged {r['cache']}: {r['requests']} req, {r['prompt_tokens']} prompt tok, "
            f"{r['decode_tokens']} decode tok; launches {r['launches']} "
            f"(expected {r['expected_launches']}); TTFT mean {r['ttft_s']['mean']:.3f} s "
            f"p50 {r['ttft_s']['p50']:.3f} s; decode {r['decode_tok_per_s']:.1f} tok/s; "
            f"wall {r['wall_s']:.1f} s; teacher-forced {r.get('teacher_forced')}; "
            f"{'ok' if r['ok'] else 'FAIL'} [{card}]")
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


def grad_parity(model, B, S, seed, expected):
    """Every parameter's gradient through the kernels against the same
    model's with dense-math attention (use_flash_attention=False), an
    oracle that runs none of the kernels under test."""
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
            grads[kern] = torch.autograd.grad(loss, params)
            sync()
            launches[kern], losses[kern] = read_counts(), float(loss.detach())
    finally:
        cfg.use_flash_attention = True
    rel = {n: ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
           for n, a, b in zip(names, grads[True], grads[False])}
    worst = max(rel, key=rel.get)
    finite = all(bool(torch.isfinite(g).all()) for g in grads[True])
    ordered = sorted(rel.values())
    return dict(B=B, S=S, layers=cfg.num_hidden_layers, loss_kernels=losses[True],
                loss_dense=losses[False], max_rel=rel[worst], worst_param=worst,
                median_rel=ordered[len(ordered) // 2], tol=GRAD_RTOL, finite=finite,
                launches=launches[True], expected_launches=expected,
                dense_launches=launches[False],
                ok=(finite and rel[worst] <= GRAD_RTOL and launch_check(launches[True], expected)
                    and not any(launches[False].values())))


def train_kind(name):
    low = name.lower()
    if "fused_ln_fwd_kernel" in low or "fused_ln_bwd_kernel" in low:
        return low[low.index("fused_ln_"):][:12]  # fused_ln_fwd / fused_ln_bwd
    if "flash_fwd_kernel" in low or "encoder_fwd" in low:
        return "attention_fwd"
    # flash_dq_kernel, flash_dkv_kernel, flash_dsum_kernel (the wgmma
    # backward and its statistics pass); the encoder's encoder_bwd_head
    # (S = 128), encoder_dq and encoder_dkv (S > 128)
    if any(w in low for w in ("dq_kernel", "dkv_kernel", "dsum_kernel", "encoder_bwd_head",
                              "encoder_dq", "encoder_dkv")):
        return "attention_bwd"
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
    res = dict(path="train", name=name, B=B, S=S, accum_steps=accum_steps,
               grad_clip=repr(grad_clip), layers=cfg.num_hidden_layers,
               params=model.num_params, warmup=warmup, steps=steps, losses=losses,
               step_ms=step_ms, step_ms_all=ms, tokens_per_s=tokens / step_ms * 1e3,
               flops_per_step=flops, mfu=flops / (step_ms / 1e3) / H100_BF16_FLOPS,
               peak_mem_bytes=(torch.cuda.max_memory_allocated()
                               if torch.cuda.is_available() else None),
               launches=launches, expected_launches=expected, encoder_input_copies=copies)
    res["ok"] = (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
                 and launch_check(launches, expected))
    if profiled:
        res["profile"] = train_profile(step, batch)
    return res


def train_phase(card, device="cuda", layers=12, parity_layers=2, **over):
    """Gradient parity at ``parity_layers`` layers (S 2048: flash; S 512:
    encoder), then the training runs at ``layers``: B 8 x S 2048, and B 32 x
    S 512 at accum_steps=2 with ClipGradByGlobalNorm(1.0) (the same 16,384
    tokens a step)."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm

    small = train_model(parity_layers, device, **over)
    L = parity_layers
    parity = [grad_parity(small, 2, 2048, 3, {"flash_attention": L, "flash_attention_dq": L,
                                              "flash_attention_dkv": L}),
              grad_parity(small, 2, 512, 4, {"encoder_attention": L,
                                             "encoder_attention_bwd": L})]
    del small
    for r in parity:
        log(f"  grad parity S {r['S']}, {r['layers']} layers: max rel {r['max_rel']:.3e} "
            f"({r['worst_param']}), median {r['median_rel']:.3e} (tol {r['tol']}); loss "
            f"{r['loss_kernels']:.4f} vs dense {r['loss_dense']:.4f}; launches "
            f"{r['launches']} (expected {r['expected_launches']}); "
            f"{'ok' if r['ok'] else 'FAIL'} [{card}]")
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = train_model(layers, device, **over)
    sync()
    log(f"  model: {model.num_params / 1e6:.1f} M params, {layers} layers, "
        f"{model.config.dtype}, init "
        f"{time.perf_counter() - t0:.1f} s")
    runs = [train_run(model, "b8_s2048", 8, 2048, 0, {"flash_attention": layers,
                                                      "flash_attention_dq": layers,
                                                      "flash_attention_dkv": layers},
                      profiled=True),
            train_run(model, "b32_s512_accum2_clip", 32, 512, 1,
                      {"encoder_attention": 2 * layers, "encoder_attention_bwd": 2 * layers},
                      steps=5, accum_steps=2, grad_clip=ClipGradByGlobalNorm(1.0))]
    del model
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    for r in runs:
        log(f"  {r['name']}: step {r['step_ms']:.1f} ms (median of {r['steps']}), "
            f"{r['tokens_per_s']:.0f} tok/s, MFU {r['mfu']:.4f}, peak "
            f"{(r['peak_mem_bytes'] or 0) / 2**30:.2f} GiB; loss {r['losses'][0]:.4f} -> "
            f"{r['losses'][-1]:.4f}; launches {r['launches']} (expected "
            f"{r['expected_launches']}); profile {json.dumps(r.get('profile'))}; "
            f"{'ok' if r['ok'] else 'FAIL'} [{card}]")
    return parity, runs


# ------------------------------------------------------------------ ernie

# bench.py _bench_ernie's configuration: ErnieForPretraining(BertConfig.base())
# (hidden 768, 12 layers, 12 heads of 64, intermediate 3072, vocab 30522,
# dropout 0.1 on hidden states and attention probabilities, LayerNorm eps
# 1e-12), bf16, AdamW(1e-4, weight_decay=0.01), B 512 x S 128 with 20 masked
# positions a sequence, random weights and batch from seed 0.
ERNIE_B, ERNIE_S, ERNIE_P = 512, 128, 20
ERNIE_WARMUP, ERNIE_STEPS = 2, 8
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


def ernie_per_layer(L):
    return {"fused_ln": 2 * L, "fused_ln_bwd": 2 * L, "encoder_attention": L,
            "encoder_attention_bwd": L}


def ernie_grad_parity(model, batch):
    """Every parameter's gradient through the kernels against the same
    model's through the composed/dense paths, at rate 0."""
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
    expected = ernie_per_layer(L)
    return dict(layers=L, B=batch[0].shape[0], loss_kernels=losses[True],
                loss_composed=losses[False], max_rel=rel[worst], worst_param=worst,
                median_rel=ordered[len(ordered) // 2], tol=GRAD_RTOL, finite=finite,
                launches=launches[True], expected_launches=expected,
                composed_launches=launches[False],
                ok=(finite and rel[worst] <= GRAD_RTOL and launch_check(launches[True], expected)
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
def ernie_eval(model, batch):
    """The eval forward at full depth: MLM logits through the kernels (rate
    0: the fused-LN forward and encoder forward at rate 0) against the
    composed/dense forward's."""
    model.eval()
    ids, seg, pos = batch[:3]
    zero_counts()
    logits, nsp = model(ids, token_type_ids=seg, masked_positions=pos)
    sync()
    launches = read_counts()
    with composed_paths():
        want, want_nsp = model(ids, token_type_ids=seg, masked_positions=pos)
    model.train()
    L = model.config.num_hidden_layers
    drift = (logits.float() - want.float()).abs().max().item()
    std = want.float().std().item()
    expected = {"fused_ln": 2 * L, "encoder_attention": L}
    return dict(layers=L, logits_shape=list(logits.shape), max_logit_drift=drift,
                logit_std=std, drift_in_std=drift / std, logit_tol_in_std=LOGIT_TOL,
                nsp_drift=(nsp.float() - want_nsp.float()).abs().max().item(),
                finite=bool(torch.isfinite(logits).all()), launches=launches,
                expected_launches=expected,
                ok=(bool(torch.isfinite(logits).all()) and drift <= LOGIT_TOL * std
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
    expected = {k: n * steps for k, n in ernie_per_layer(cfg.num_hidden_layers).items()}
    res = dict(path="ernie", name=f"b{B}_s{S}_p{P}_drop{cfg.hidden_dropout_prob}", B=B, S=S,
               masked_per_seq=P, layers=cfg.num_hidden_layers, params=model.num_params,
               warmup=warmup, steps=steps, losses=losses, step_ms=step_ms, step_ms_all=ms,
               tokens_per_s=B * S / step_ms * 1e3, flops_per_step=flops,
               mfu=flops / (step_ms / 1e3) / H100_BF16_FLOPS,
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


def ernie_phase(card, device="cuda", layers=12, parity_layers=2, B=ERNIE_B, S=ERNIE_S,
                P=ERNIE_P, dtype=torch.bfloat16, **over):
    """bench.py's ERNIE pretraining: gradient parity at ``parity_layers``
    layers and rate 0, determinism at rate 0.1, the eval forward and the
    training run at ``layers`` layers."""
    small = ernie_model(parity_layers, device, dtype, dropout=False, **over)
    batch = ernie_batch(small.config, B, S, P, 0, device)
    parity = ernie_grad_parity(small, batch)
    del small
    log(f"  grad parity, {parity['layers']} layers, rate 0: max rel {parity['max_rel']:.3e} "
        f"({parity['worst_param']}), median {parity['median_rel']:.3e} (tol {parity['tol']}); "
        f"loss {parity['loss_kernels']:.4f} vs composed {parity['loss_composed']:.4f}; "
        f"launches {parity['launches']} (expected {parity['expected_launches']}); "
        f"{'ok' if parity['ok'] else 'FAIL'} [{card}]")
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
    ev = ernie_eval(model, batch)
    log(f"  eval forward, {ev['layers']} layers: MLM logits {ev['logits_shape']}, drift max "
        f"{ev['max_logit_drift']:.4f} = {ev['drift_in_std']:.4f} std (std "
        f"{ev['logit_std']:.3f}; tol {LOGIT_TOL} std); launches {ev['launches']} (expected "
        f"{ev['expected_launches']}); {'ok' if ev['ok'] else 'FAIL'} [{card}]")
    run = ernie_train(model, batch, profiled=device != "cpu")
    del model
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    log(f"  {run['name']}: step {run['step_ms']:.2f} ms (median of {run['steps']}), "
        f"{run['tokens_per_s']:.0f} tok/s, MFU {run['mfu']:.4f}, peak "
        f"{(run['peak_mem_bytes'] or 0) / 2**30:.2f} GiB; loss {run['losses'][0]:.4f} -> "
        f"{run['losses'][-1]:.4f}; launches {run['launches']} (expected "
        f"{run['expected_launches']}); encoder input copies {run['encoder_input_copies']} "
        f"(expected 0); profile {json.dumps(run.get('profile'))}; "
        f"{'ok' if run['ok'] else 'FAIL'} [{card}]")
    return dict(grad_parity=parity, determinism=determinism, eval=ev), [run]


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


def build_model():
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.llama2_7b(num_hidden_layers=LAYERS, dtype="bfloat16")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda").eval()
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"  model: {model.num_params / 1e9:.3f} B params, {LAYERS} layers, bf16, "
        f"init {time.perf_counter() - t0:.1f} s")
    return model


# ------------------------------------------------------------------- main

PHASES = ("device", "build", "kernels", "generate", "dense_engine", "paged_engine",
          "ticks", "train", "ernie", "resnet")
PATH_TITLES = {"generate": "model.generate() on the static cache",
               "dense_engine": "the dense LLMEngine",
               "paged_engine": "the paged LLMEngine",
               "ticks": "both engines' decode ticks in turns"}
PATH_PHASES = {"dense_engine": dense_engine_phase, "paged_engine": paged_engine_phase,
               "ticks": ticks_phase}


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
        spills = [f"{name}: {line}" for name in HOPPER_LIBS
                  for line in report["ptxas"].get(name, [])
                  if "spill" in line and not line.startswith("0 bytes stack frame, 0 bytes spill")]
        report["hopper_spills"] = spills
        if spills:
            log("[build] FAIL: ptxas spills in a Hopper library: " + "; ".join(spills))
            ok = False
    if "kernels" in phases:
        log("[kernels] every kernel vs its plain version")
        report["kernels"] = kernel_phase()
        ok &= all(c["ok"] for cases in report["kernels"].values() for c in cases)
        missing = [(name, op) for name, n in report["sass"].items()
                   for op in HOPPER_LIBS[name] if n[op] == 0]
        for name, op in missing:
            log(f"[kernels] FAIL: the {name} library has no {op} instruction")
        ok &= not missing
    serving = [ph for ph in paths if ph not in ("train", "ernie", "resnet")]
    if serving:
        model = build_model()
        for ph in serving:
            log(f"[{ph}] LLaMA-2-7B widths through {PATH_TITLES[ph]}")
            if ph == "generate":
                runs = generate_phase(model, report["card"])
            else:
                runs, report[f"{ph}_decode_tick"] = PATH_PHASES[ph](model, report["card"])
            report["paths"] += runs
            ok &= all(r["ok"] for r in runs)
        del model
        torch.cuda.empty_cache()
    if "train" in paths:
        log("[train] bench.py's LLaMA training configuration through TrainStep + AdamW")
        report["train_grad_parity"], runs = train_phase(report["card"])
        report["paths"] += runs
        ok &= all(r["ok"] for r in report["train_grad_parity"] + runs)
    if "ernie" in paths:
        log("[ernie] bench.py's ERNIE-base pretraining through TrainStep + AdamW")
        report["ernie_checks"], runs = ernie_phase(report["card"])
        report["paths"] += runs
        ok &= all(r["ok"] for r in list(report["ernie_checks"].values()) + runs)
    if "resnet" in paths:
        log("[resnet] bench.py's ResNet-50 in NHWC through TrainStep + Momentum")
        report["resnet_checks"], runs = resnet_phase(report["card"])
        report["paths"] += runs
        ok &= all(r["ok"] for r in report["resnet_checks"]["block_parity"]
                  + [report["resnet_checks"]["eval"]] + runs)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    if not ok:
        log("chip_smoke: FAILED (see above)")
        return 1
    if "kernels" in report:
        # launches: the sum over every path's run (each zeroed just before)
        launches = {}
        for run in report["paths"]:
            for k, n in run["launches"].items():
                launches[k] = launches.get(k, 0) + n
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
