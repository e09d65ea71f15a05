"""The loss and gradients of one training step (counterpart of
paddle_tpu/jit/_step_impl.py).

``loss_and_grads`` runs the loss function and takes the gradients of every
trainable parameter with torch autograd.  With ``accum_steps > 1`` it
splits the batch axis into that many equal microbatches, runs them one
after the other and averages their gradients and losses (the loss in f32),
as the reference's ``lax.scan`` does; auxiliary outputs are the last
microbatch's.  It makes no host sync and no pageable copy, and what it
allocates lives for the step alone, so that ``jit/train_step.py`` can
capture it (with the update) into one CUDA graph.  There is no
counterpart of the reference's in-graph loss scaling: ``TrainStep``
raises on ``scaler=``.
"""
from __future__ import annotations

import torch


def _split(out):
    """(loss, aux tuple) of a loss function's return value."""
    if isinstance(out, (tuple, list)):
        return out[0], tuple(out[1:])
    return out, ()


def _detach(aux):
    return tuple(a.detach() if torch.is_tensor(a) else a for a in aux)


def _grads(loss, params):
    """d loss / d param for each param; zeros for a parameter the loss does
    not reach, as jax.grad gives."""
    got = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, got)]


def loss_and_grads(loss_fn, params, batch, accum_steps=1):
    """(loss, aux, [grad per param]) of ``loss_fn(*batch)``."""
    if accum_steps == 1:
        loss, aux = _split(loss_fn(*batch))
        return loss.detach(), _detach(aux), _grads(loss, params)
    for b in batch:
        if b.shape[0] % accum_steps:
            raise ValueError(
                f"accum_steps={accum_steps} does not divide the batch size "
                f"{b.shape[0]} - gradient accumulation splits the batch axis into "
                "equal microbatches")
    gsum, lsum, aux = None, None, ()
    for i in range(accum_steps):
        mb = tuple(b.reshape(accum_steps, b.shape[0] // accum_steps, *b.shape[1:])[i]
                   for b in batch)
        loss, aux = _split(loss_fn(*mb))
        g = _grads(loss, params)
        gsum = g if gsum is None else [a + c for a, c in zip(gsum, g)]
        lf = loss.detach().float()
        lsum = lf if lsum is None else lsum + lf
    return lsum / accum_steps, _detach(aux), [g / accum_steps for g in gsum]
