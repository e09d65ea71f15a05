"""One turn of a parent/change comparison on the card: the float32 LLaMA
b8_s2048 and b32_s512_accum2_clip steps (chip_smoke.py's training
configuration) and the float32 ERNIE-base step, each timed as
chip_smoke.py times it and profiled once, from the checkout in the working
directory.

    python3 tools/f32_steps_turn.py TAG      # from a checkout's root

Prints the step times, losses and profiles, and writes them to
chiprun_out/f32_steps_TAG.json.  tools/f32_steps_ab.sh runs it in a parent
checkout and this one in turns.
"""
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path.cwd()))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.nn import ClipGradByGlobalNorm  # noqa: E402
from paddle_tpu_torch.ops import _build  # noqa: E402

tag = sys.argv[1]
t0 = time.time()
_build.build_all()
print(tag, "build", round(time.time() - t0, 1), cs.card_line(), flush=True)
f32 = torch.float32
out = {"card": cs.card_line()}


def show(name, r):
    print(tag, name, "step", r["step_ms"], r["step_ms_all"], "losses", r["losses"], "ok", r["ok"],
          "profile", json.dumps({k: r["profile"].get(k) for k in (
              "device_ms", "device_ms_by_kind", "busy_share", "profiled_wall_ms")}), flush=True)


model = cs.train_model(12, "cuda", num_attention_heads=16, num_key_value_heads=16, dtype="float32")
r = cs.train_run(model, "b8_s2048_f32", 8, 2048, 0, cs.flash_launches(12, f32),
                 steps=cs.F32_TRAIN_STEPS, warmup=cs.F32_TRAIN_WARMUP, profiled=True)
out["llama_b8_s2048"] = r
show("llama b8_s2048 f32", r)
r = cs.train_run(model, "b32_s512_accum2_clip_f32", 32, 512, 1, cs.encoder_launches(24),
                 steps=cs.F32_TRAIN_STEPS, warmup=cs.F32_TRAIN_WARMUP, accum_steps=2,
                 grad_clip=ClipGradByGlobalNorm(1.0), profiled=True)
del model
torch.cuda.empty_cache()
out["llama_b32_s512"] = r
show("llama b32_s512 f32", r)
model = cs.ernie_model(12, "cuda", f32)
batch = cs.ernie_batch(model.config, cs.ERNIE_B, cs.ERNIE_S, cs.ERNIE_P, 0, "cuda")
r = cs.ernie_train(model, batch, cs.ERNIE_F32_STEPS, cs.ERNIE_F32_WARMUP, profiled=True)
out["ernie"] = r
show("ernie f32", r)
Path("chiprun_out").mkdir(exist_ok=True)
Path(f"chiprun_out/f32_steps_{tag}.json").write_text(json.dumps(out, indent=1, default=str))
print(tag, "turn", round(time.time() - t0, 1), flush=True)
