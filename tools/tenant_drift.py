"""Teacher-forced logit drift of LoRA adapter rows on the card, by adapter
scale and matmul setting, along chip_smoke.py's tenants path (LLaMA-2-7B
widths, chip_smoke.LAYERS layers, bf16, random weights from seed 0; 4
prompts of 300 tokens, 24 greedy tokens each from solo generate() on the
paged layout).

For each case: the paged path (chunked prefill, then decode steps), teacher-
forced under the adapter's page, against the dense-math no-cache forward
under the same page (chip_smoke.paged_logits / forward_logits): the max
|logit difference|, the logits' standard deviation, and how many of the
greedy tokens equal the forward's argmax.  Cases: the base model; adapters
of rank 16 at the scale 4e-3; the same with cuBLAS's reduced-precision
bf16 reductions off; and at 1e-3 (chip_smoke.TENANT_SCALE), 2.5e-4 and
1e-4.

    python3 tools/tenant_drift.py          # from the checkout's root

Prints one line a case and writes chiprun_out/tenant_drift.json.
"""
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path.cwd()))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.models.lora import AdapterRegistry, LoraAdapter, lora_sites  # noqa: E402
from paddle_tpu_torch.ops import _build  # noqa: E402
from paddle_tpu_torch.ops import lora as oplora  # noqa: E402

t0 = time.time()
_build.build_all()
print("build", round(time.time() - t0, 1), cs.card_line(), flush=True)
torch.backends.cuda.matmul.allow_tf32 = False
model = cs.build_model()
rng = np.random.default_rng(70)
prompts = [rng.integers(1, model.config.vocab_size - 1, 300).tolist() for _ in range(4)]
out = {"card": cs.card_line(), "cases": []}
CASES = [("base", None, True), ("scale_4e-3", 4e-3, True),
         ("scale_4e-3_no_reduced_precision", 4e-3, False),
         ("scale_1e-3", 1e-3, True), ("scale_2.5e-4", 2.5e-4, True), ("scale_1e-4", 1e-4, True)]
for name, scale, reduced in CASES:
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
    page, reg = 0, None
    if scale is not None:
        ad = LoraAdapter.random(lora_sites(model), cs.TENANT_RANK, seed=200, scale=scale)
        reg = AdapterRegistry.from_adapters(model, {"a0": ad}, rank=cs.TENANT_RANK)
        page = reg.acquire("a0")
    drift, sigma, exact, n = [], [], 0, 0
    for p in prompts:
        ctx = (oplora.activate(reg.pool.site_pools(), torch.tensor([page], device="cuda"))
               if page else contextlib.nullcontext())
        with ctx, torch.no_grad():
            toks = model.generate(torch.tensor([p], device="cuda"), max_new_tokens=24,
                                  kv_layout="paged", page_size=128)[0].tolist()
            want = cs.forward_logits(model, p, toks)
            path = cs.paged_logits(model, p, toks)
        drift.append((want - path).abs().amax().item())
        sigma.append(want.std().item())
        exact += int((want.argmax(-1).cpu() == torch.tensor(toks)).sum())
        n += len(toks)
    row = dict(case=name, scale=scale, reduced_precision_reduction=reduced,
               max_logit_drift=max(drift), drift_by_prompt=drift,
               logit_sigma=float(np.mean(sigma)), argmax_equal=exact, tokens=n)
    out["cases"].append(row)
    print(json.dumps(row), flush=True)
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
Path("chiprun_out").mkdir(exist_ok=True)
Path("chiprun_out/tenant_drift.json").write_text(json.dumps(out, indent=1))
print(cs.card_line())
