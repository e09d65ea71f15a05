"""One turn of a parent/change comparison on the card of the decode and
paged kernels at float32 and float16 along chip_smoke.py's serving path
(LLaMA-2-7B widths, chip_smoke.LAYERS layers, random weights from seed 0):
the float32 paged decode tick with all 8 slots at about 1k tokens of
context under the profiler (device ms, attention ms, kernels, busy share:
``decode_breakdown``), then the paged engine's 12 requests at float32 and
at float16 (float32 pools, as a float16 model's engines keep them):
``prefill_s``, decode tok/s and TTFT (the engine's own counters; no
teacher-forced check, which chip_smoke.py's dtypes phase makes), from the
checkout in the working directory.

    python3 tools/kv_tick_turn.py TAG      # from a checkout's root

Prints the numbers and writes them to chiprun_out/kv_tick_TAG.json.
tools/kv_tick_ab.sh runs it in a parent checkout and this one in turns.
"""
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path.cwd()))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.ops import _build  # noqa: E402

tag = sys.argv[1]
t0 = time.time()
_build.build_all()
print(tag, "build", round(time.time() - t0, 1), cs.card_line(), flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
out = {"card": cs.card_line()}
KEYS = ("path", "prefill_s", "decode_s", "decode_tok_per_s", "ttft_s", "prefill_chunks",
        "decode_ticks", "launches", "expected_launches", "ok")
for dt in ("float32", "float16"):
    model = cs.build_model(dt)
    if dt == "float32":
        tick = cs.decode_breakdown(model, "paged")
        out["f32_paged_tick"] = tick
        print(tag, "f32 paged tick", json.dumps({k: tick.get(k) for k in (
            "wall_ms_per_tick", "device_ms_per_tick", "device_ms_by_kind", "kernels_per_tick",
            "busy_share")}), flush=True)
    run = cs.serve_paged(model, cs.REQUESTS, np.random.default_rng(0), None, 4, False)
    run.pop("outputs", None)
    out[f"{dt}_paged_engine"] = {k: run.get(k) for k in KEYS}
    print(tag, dt, "paged engine", json.dumps(out[f"{dt}_paged_engine"], default=str), flush=True)
    del model
    torch.cuda.empty_cache()
Path("chiprun_out").mkdir(exist_ok=True)
Path(f"chiprun_out/kv_tick_{tag}.json").write_text(json.dumps(out, indent=1, default=str))
print(tag, "turn", round(time.time() - t0, 1), flush=True)
