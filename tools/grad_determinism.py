#!/usr/bin/env python3
"""Which gradients of a training step differ between two eager backward
passes from the same weights, batch and seed, on one CUDA card.

    python3 tools/grad_determinism.py

Runs chip_smoke.py's ERNIE-base (2 layers, B 512 x S 128, bf16 and float32,
dropout off and at 0.1) and LLaMA training configuration (2 layers, B 8 x
S 2048, bf16), each with torch.use_deterministic_algorithms off and on
(warn_only), and prints the parameters whose two gradients are not equal
bit for bit.  chip_smoke.py's oracle turns (eager against CUDA graphs) run
under the deterministic mode because of what this shows.
"""
from __future__ import annotations

import sys
import warnings
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def differing(loss_fn, model, batch):
    """(parameters whose gradients differ, whether the losses are equal)."""
    from paddle_tpu_torch import seed

    names, params = zip(*model.named_parameters())
    out = []
    for _ in range(2):
        seed(7)
        loss = loss_fn(*batch)
        out.append((loss.detach(), torch.autograd.grad(loss, params, allow_unused=True)))
    (la, ga), (lb, gb) = out
    diff = [n for n, a, b in zip(names, ga, gb) if a is not None and not torch.equal(a, b)]
    return diff, bool(torch.equal(la, lb))


def main():
    if not torch.cuda.is_available():
        print("grad_determinism: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line())
    warnings.simplefilter("ignore")
    for det in (False, True):
        torch.use_deterministic_algorithms(det, warn_only=True)
        for dt in (torch.bfloat16, torch.float32):
            for dropout in (False, True):
                m = cs.ernie_model(2, "cuda", dt, dropout=dropout)
                batch = cs.ernie_batch(m.config, cs.ERNIE_B, cs.ERNIE_S, cs.ERNIE_P, 0, "cuda")
                diff, same_loss = differing(cs.ernie_loss(m), m, batch)
                print(f"ERNIE {cs.TAGS[dt]} dropout {dropout} deterministic {det}: losses equal "
                      f"{same_loss}, {len(diff)} gradients differ {diff[:8]}", flush=True)
                del m
                torch.cuda.empty_cache()
        m = cs.train_model(2)
        batch = cs.token_batch(m.config, 8, 2048, 0, "cuda")
        diff, same_loss = differing(cs.lm_loss(m), m, batch)
        print(f"LLaMA bf16 deterministic {det}: losses equal {same_loss}, {len(diff)} gradients "
              f"differ {diff[:8]}", flush=True)
        del m
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
