#!/usr/bin/env python3
"""Chip smoke test of paddle_tpu_torch on one NVIDIA GPU (written for H100).

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --phases device,build,kernels

Phases:
  1. device  — the card's name and power limit (nvidia-smi); TF32 off.
  2. build   — nvcc builds every kernel under paddle_tpu_torch/csrc/ (one
               process per source, all at once) into
               paddle_tpu_torch/build/kernels/, with ptxas's report.
  3. kernels — each kernel against its plain PyTorch version at the
               serving shapes, with its time, the plain version's time, a
               PyTorch library call's time as a yardstick, and the bound;
               planted faults of the plain version must fail the same gate.
  4. engine  — LLaMA-2-7B widths (32 layers, bf16, random weights from a
               seed) served by the paged LLMEngine: 12 requests, then a
               shorter int8-cache run.  Launch counters are zeroed just
               before each run and must match the work the run did.  For
               the greedy outputs, the paged path's logits (teacher-forced)
               must stay within LOGIT_TOL of the no-cache forward's, and
               each token must be the forward's argmax but at near-ties.
               Last, a few decode ticks with all 8 slots busy run under
               torch.profiler: where a tick's time goes.
Then one JSON line of per-kernel results, the card line again, and last
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero before
that line.  Without CUDA, or without the repository beside this file, it
exits non-zero and prints no result.  Long results also go to
chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12        # dense bf16 tensor-core peak
# The engine phase's model and traffic: LLaMA-2-7B's depth, 12 requests on
# a bf16 cache, then 4 on an int8 cache.
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
# Logit drift: max |paged-path logit - no-cache-forward logit| over every
# generated position of the greedy requests (both bf16 through 32 layers,
# rounding in different orders).  Logits here are ~N(0, 0.5); sound runs on
# an H100 drift by at most 0.041.
LOGIT_TOL = 0.1


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
    ms = cuda_ms(kernel, iters)
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
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kg, vg, attn_mask=mask), iters)
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
                fault_rel=fault_rel, finite=finite,
                tol=tol, ok=(finite and err / top <= tol
                             and min(fault_rel.values()) > tol),
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops)


def kernel_phase():
    from paddle_tpu_torch.ops import decode_attention as da

    ragged = [2047, 1500, 1100, 777, 512, 300, 129, 37]  # lengths <= 2048
    cases = []
    for quant in (False, True):
        tag = "int8" if quant else "bf16"
        cases += [
            paged_case(f"7b_decode_{tag}", 8, 1, 32, 32, ragged, quant, 1),
            paged_case(f"7b_chunk256_{tag}", 2, 256, 32, 32, [1280, 384], quant, 2),
            paged_case(f"70b_gqa_decode_{tag}", 8, 1, 64, 8, ragged, quant, 3),
            paged_case(f"70b_gqa_chunk256_{tag}", 2, 256, 64, 8, [1280, 384], quant, 4),
        ]
    # max_seq_len 2100 pads to 2176 positions (17 pages): the last 256-token
    # chunk of a 2100-token prompt starts at 2048, and its padded rows reach
    # past the table
    cases.append(paged_case("7b_chunk256_past_table_bf16", 2, 256, 32, 32,
                            [2048, 384], False, 5, pages=17))
    da.paged_attention_kernel.launches = 0  # comparison launches do not count
    for c in cases:
        log(f"  {c['name']:24s} err {c['max_abs_err']:.3e} of max {c['max_abs_want']:.3f}: "
            f"rel {c['rel_err']:.3e} (tol {c['tol']}; planted faults "
            + ", ".join(f"{k} {v:.3e}" for k, v in c["fault_rel"].items()) + ") "
            f"kernel {c['ms']:.4f} ms  plain {c['plain_ms']:.4f} ms  "
            f"sdpa {c['library_ms']:.4f} ms  bound {c['bound_ms']:.4f} ms "
            f"({c['bound_by']})  {'ok' if c['ok'] else 'FAIL'}")
    return cases


# ----------------------------------------------------------------- engine

@torch.no_grad()
def paged_logits(model, prompt, out, chunk=256, ps=128):
    """The paged path's logits at each generated position of one request,
    teacher-forced: the prompt in prefill chunks, then one decode step for
    each generated token but the last, on a one-slot bf16 pool."""
    cfg, dev = model.config, model.device
    D = cfg.hidden_size // cfg.num_attention_heads
    npg = -(-(len(prompt) + len(out)) // ps)
    pools = [tuple(torch.zeros(npg + 1, cfg.num_key_value_heads, ps, D,
                               dtype=torch.bfloat16, device=dev) for _ in range(2))
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


@torch.no_grad()
def teacher_forced(model, reqs, outs):
    """The engine's greedy tokens against one no-cache forward over each
    prompt + out[:-1].  First the paged path's logits, teacher-forced, must
    lie within LOGIT_TOL of the forward's.  Then each engine token must be
    the forward's argmax, unless the forward's top-2 gap is under twice the
    drift this run measured, the most by which two logits can trade places."""
    per_req = []
    for r, out in zip(reqs, outs):
        seq = torch.tensor(list(r["prompt"]) + list(out[:-1]), device=model.device)[None]
        want = model(seq)[0, len(r["prompt"]) - 1:].float()
        drift = (paged_logits(model, r["prompt"], out) - want).abs().amax(-1)
        top2 = want.topk(2, dim=-1).values
        per_req.append((out, want.argmax(-1).tolist(), (top2[:, 0] - top2[:, 1]).tolist(),
                        drift.tolist()))
    drift = [d for *_, ds in per_req for d in ds]
    tie_tol = 2 * max(drift)
    exact = ties = bad = under = 0
    for out, am, gaps, _ in per_req:
        for tok, a, gap in zip(out, am, gaps):
            under += gap < tie_tol
            if tok == a:
                exact += 1
            elif gap < tie_tol:
                ties += 1
            else:
                bad += 1
    return dict(positions=len(drift), max_logit_drift=max(drift),
                mean_logit_drift=sum(drift) / len(drift), logit_tol=LOGIT_TOL,
                tie_tol=tie_tol, share_gap_under_tie_tol=under / len(drift),
                exact=exact, near_ties=ties, failures=bad,
                ok=max(drift) <= LOGIT_TOL and bad == 0)


def serve(model, cfg, n_req, rng, cache_dtype, sampled_every, check):
    from paddle_tpu_torch.inference import LLMEngine
    from paddle_tpu_torch.ops import decode_attention as da

    eng = LLMEngine(model, max_batch_slots=8, max_seq_len=2048, kv_layout="paged",
                    page_size=128, prefill_chunk=256, prefix_cache=False,
                    cache_dtype=cache_dtype,
                    generator=torch.Generator(device="cuda").manual_seed(5))
    warm = eng.warmup()
    reqs = []
    for i in range(n_req):
        n = int(rng.integers(64, 1501))
        reqs.append(dict(prompt=rng.integers(1, cfg.vocab_size, n).tolist(),
                         max_new=int(rng.integers(32, 65)),
                         sampled=sampled_every > 0 and i % sampled_every == sampled_every - 1))
    da.paged_attention_kernel.launches = 0          # the run starts here
    eng.start()
    t0 = time.perf_counter()
    futs = [eng.submit(r["prompt"], max_new_tokens=r["max_new"],
                       do_sample=r["sampled"], temperature=0.8, top_p=0.9)
            for r in reqs]
    outs = [f.result(timeout=900) for f in futs]
    wall = time.perf_counter() - t0
    eng.stop()
    launches = da.paged_attention_kernel.launches   # ... and ends here
    st = eng.stats()
    expected = cfg.num_hidden_layers * (st["prefill_chunks"] + st["decode_ticks"])
    valid = all(len(o) == r["max_new"] and all(0 <= t < cfg.vocab_size for t in o)
                for o, r in zip(outs, reqs))
    res = dict(cache=cache_dtype or "bf16", requests=n_req, warmup_s=warm, wall_s=wall,
               launches=launches, expected_launches=expected,
               prefill_chunks=st["prefill_chunks"], decode_ticks=st["decode_ticks"],
               decode_tokens=st["decode_tokens"], prefill_s=st["prefill_seconds"],
               decode_s=st["decode_seconds"],
               decode_tok_per_s=st["decode_tokens"] / max(st["decode_seconds"], 1e-9),
               ttft_s=st["ttft_seconds"], prompt_tokens=sum(len(r["prompt"]) for r in reqs),
               valid_ids=valid, preemptions=st["preemptions"])
    if check:
        greedy = [(r, o) for r, o in zip(reqs, outs) if not r["sampled"]]
        res["teacher_forced"] = teacher_forced(model, *zip(*greedy))
    res["ok"] = (valid and launches == expected and launches > 0
                 and (not check or res["teacher_forced"]["ok"]))
    return res


def decode_breakdown(model, cfg, ticks=8):
    """Where one decode tick's time goes with all 8 slots decoding at about
    1k tokens of context: host wall per tick (unprofiled, then under
    torch.profiler) and the device time of the kernels the ticks ran, by
    kind.  Informational: a profiler that records no device events gives
    "not measured", not a failure."""
    import numpy as np

    from paddle_tpu_torch.inference import LLMEngine

    eng = LLMEngine(model, max_batch_slots=8, max_seq_len=2048, kv_layout="paged",
                    page_size=128, prefill_chunk=256, prefix_cache=False)
    rng = np.random.default_rng(1)
    for _ in range(8):
        eng.submit(rng.integers(1, cfg.vocab_size, 1000).tolist(), max_new_tokens=96)
    while eng.stats()["active_slots"] < 8:  # prefill every prompt
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        eng.step()
    wall_ms = (time.perf_counter() - t0) * 1e3 / ticks
    res = dict(ticks=ticks, slots=8, wall_ms_per_tick=wall_ms)
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(ticks):
                eng.step()
            res["profiled_wall_ms_per_tick"] = (time.perf_counter() - t0) * 1e3 / ticks
        kern = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        by_kind, by_name = {}, {}
        for e in kern:
            us = e.time_range.elapsed_us()
            low = e.name.lower()
            kind = ("paged_attention" if "paged_attention" in low else
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
    return res


def engine_phase(card):
    import numpy as np

    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.llama2_7b(num_hidden_layers=LAYERS, use_flash_attention=False,
                                dtype="bfloat16")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda").eval()
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"  model: {model.num_params / 1e9:.3f} B params, {LAYERS} layers, bf16, "
        f"init {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    runs = [serve(model, cfg, REQUESTS, rng, None, 4, True),
            serve(model, cfg, INT8_REQUESTS, rng, "int8", 0, False)]
    for r in runs:
        log(f"  {r['cache']}: {r['requests']} req, {r['prompt_tokens']} prompt tok, "
            f"{r['decode_tokens']} decode tok; launches {r['launches']} "
            f"(expected {r['expected_launches']}); TTFT mean {r['ttft_s']['mean']:.3f} s "
            f"p50 {r['ttft_s']['p50']:.3f} s; decode {r['decode_tok_per_s']:.1f} tok/s; "
            f"wall {r['wall_s']:.1f} s; teacher-forced {r.get('teacher_forced')}; "
            f"{'ok' if r['ok'] else 'FAIL'} [{card}]")
    tick = decode_breakdown(model, cfg)
    log(f"  decode tick, 8 slots at ~1k context: {json.dumps(tick)} [{card}]")
    return runs, tick


# ------------------------------------------------------------------- main

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="device,build,kernels,engine")
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
              "count": torch.cuda.device_count()}
    ok = True
    log(f"[device] {report['card']} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {report['kind']} x{report['count']}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[device] TF32 off for matmul and cuDNN: float32 products run in full float32")
    if phases & {"build", "kernels", "engine"}:
        t0 = time.perf_counter()
        built = _build.build_all(ptxas_verbose="build" in phases)
        report["build_s"] = time.perf_counter() - t0
        log(f"[build] {', '.join(built)} in {report['build_s']:.1f} s "
            f"-> {_build.BUILD_DIR}")
        for name, b in built.items():
            for line in b["log"].splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build]   {name}: {line.strip()}")
    if "kernels" in phases:
        log("[kernels] paged_attention vs its plain version")
        report["paged_attention"] = kernel_phase()
        ok &= all(c["ok"] for c in report["paged_attention"])
    if "engine" in phases:
        log("[engine] LLaMA-2-7B widths through the paged LLMEngine")
        report["engine"], report["decode_tick"] = engine_phase(report["card"])
        ok &= all(r["ok"] for r in report["engine"])
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    if not ok:
        log("chip_smoke: FAILED (see above)")
        return 1
    if "paged_attention" in report:
        main_case = report["paged_attention"][0]  # 7B bf16 decode: the main path's shape
        launches = report["engine"][0]["launches"] if "engine" in report else 0
        log(json.dumps({"kernels": [{
            "name": "paged_attention", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/ops/decode_attention.py:313",
            "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in report["paged_attention"]),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"]}]}))
    log(report["card"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": report["kind"],
                                             "count": report["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
