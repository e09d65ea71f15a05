"""One turn of a parent/change comparison on the card: the flash
backward's statistics pass (``flash_attention_bwd_stats``) at bf16, float16
and float32 on [8, 2048, 16, 128] and [8, 2048, 8, 256] causal (the LLaMA
steps' shapes), timed from CUDA-graph replays as chip_smoke.py times it,
with dq, dkv and the whole backward (statistics, at float32 the split, dq,
dkv) from CUDA events, on a contiguous O from the flash forward; then the
bf16 LLaMA b8_s2048 step (chip_smoke.py's training configuration), timed
and profiled as chip_smoke.py does, from the checkout in the working
directory.

    python3 tools/bwd_stats_turn.py TAG      # from a checkout's root

Prints the times and the step's profile, and writes them to
chiprun_out/bwd_stats_TAG.json.  tools/bwd_stats_ab.sh runs it in a parent
checkout and this one in turns.
"""
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path.cwd()))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.ops import _build  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as fa  # noqa: E402

tag = sys.argv[1]
t0 = time.time()
_build.build_all()
print(tag, "build", round(time.time() - t0, 1), cs.card_line(), flush=True)
out = {"card": cs.card_line(), "stats": []}
for dt in (torch.bfloat16, torch.float16, torch.float32):
    for B, S, H, D in ((8, 2048, 16, 128), (8, 2048, 8, 256)):
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, do = (torch.randn(B, S, H, D, generator=g, device="cuda").to(dt)
                       for _ in range(4))
        o, lse = fa.flash_attention_kernel(q, k, v, causal=True)  # contiguous, as in training
        args = (q, k, v, o, do, lse, True, None)

        def backward():  # as the autograd backward runs it: the statistics once, dq, dkv
            stats = fa.flash_attention_bwd_stats(o, do, lse)
            planes = fa.flash_attention_bwd_split(q, k, v, do) if dt == torch.float32 else None
            fa.flash_attention_dq_kernel(*args, stats=stats, planes=planes)
            fa.flash_attention_dkv_kernel(*args, stats=stats, planes=planes)

        stats = fa.flash_attention_bwd_stats(o, do, lse)
        planes = fa.flash_attention_bwd_split(q, k, v, do) if dt == torch.float32 else None
        nbytes = 2 * o.numel() * o.element_size() + lse.numel() * 4 + stats.numel() * 4
        row = dict(dtype=cs.TAGS[dt], B=B, S=S, H=H, D=D,
                   ms=cs.graph_ms(lambda: fa.flash_attention_bwd_stats(o, do, lse)),
                   bound_ms=nbytes / cs.H100_BYTES_PER_S * 1e3,
                   dq_ms=cs.cuda_ms(lambda: fa.flash_attention_dq_kernel(
                       *args, stats=stats, planes=planes), 10),
                   dkv_ms=cs.cuda_ms(lambda: fa.flash_attention_dkv_kernel(
                       *args, stats=stats, planes=planes), 10),
                   backward_ms=cs.cuda_ms(backward, 10))
        out["stats"].append(row)
        print(tag, "stats", json.dumps(row), flush=True)
        del q, k, v, o, do, lse, stats, planes
        torch.cuda.empty_cache()
model = cs.train_model(12, "cuda", num_attention_heads=16, num_key_value_heads=16,
                       dtype="bfloat16")
r = cs.train_run(model, "b8_s2048", 8, 2048, 0, cs.flash_launches(12, torch.bfloat16),
                 profiled=True)
out["llama_b8_s2048"] = r
print(tag, "llama b8_s2048 bf16 step", r["step_ms"], r["step_ms_all"], "ok", r["ok"], "profile",
      json.dumps({k: r["profile"].get(k) for k in (
          "device_ms", "device_ms_by_kind", "busy_share", "profiled_wall_ms")}), flush=True)
Path("chiprun_out").mkdir(exist_ok=True)
Path(f"chiprun_out/bwd_stats_{tag}.json").write_text(json.dumps(out, indent=1, default=str))
print(tag, "turn", round(time.time() - t0, 1), flush=True)
