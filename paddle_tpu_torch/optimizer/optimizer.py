"""Optimizers (counterpart of paddle_tpu/optimizer/optimizer.py).

Each optimizer ports the reference's update rule, ``_update_rule(p, g,
state, lr) -> (new_p, new_state)``, not ``torch.optim``'s, so that the
rounding order and the decoupled weight decay (new_p - lr * coeff * p_old)
match.  ``_apply_update`` wraps the rule as the reference's does: the
gradient is cast to the parameter's dtype, an L2 decay is added to it (or
a decoupled one subtracted after the rule), and the new value and state
keep their dtypes.  Moments live in the parameter's dtype (bf16 moments
for a bf16 model, as the reference keeps them); ``beta1_pow`` and
``beta2_pow`` are f32 scalars.

The learning rate is an f32 scalar, as the reference's compiled train step
passes it, so every update is computed in f32 and then cast back to the
parameter's dtype; bf16 arithmetic stays bf16 exactly where the
reference's does (the moments).  The reference's eager ``step()`` passes
a Python float instead, which keeps a bf16 update in bf16; the port
follows the train step in both.  JAX rounds a Python scalar to the array's
dtype before it multiplies (so the reference's bf16 Adam decays its second
moment by bf16(0.999) = 1.0); ``_like`` does the same, where torch would
multiply by the unrounded scalar.

Unlike the reference, whose arrays are immutable, the port updates each
parameter in place (``copy_`` under ``torch.no_grad()``), so no second copy
of the weights is ever allocated.  ``step()`` reads ``param.grad``;
``jit.TrainStep`` hands its gradients to ``_update`` directly.  Not ported
yet, and raising NotImplementedError: learning-rate schedulers (ROADMAP.md
Queue 1 item 6, the rest of the surface), regularizer objects as
``weight_decay`` (the same item) and the optimizers other than SGD,
Momentum, Adam and AdamW (``paddle_tpu_torch.optimizer``).
"""
from __future__ import annotations

import torch

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW"]


def _like(x, t):
    """The Python scalar ``x`` rounded to ``t``'s dtype, as JAX rounds a
    weakly typed scalar before an operation in that dtype."""
    return torch.tensor(x, dtype=t.dtype).item()


def _not_ported(what):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md Queue 1 item 6: the rest of the "
        "surface); pass a float")


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        if not isinstance(learning_rate, (int, float)):
            raise _not_ported("an LRScheduler as learning_rate")
        if weight_decay is not None and not isinstance(weight_decay, (int, float)):
            raise _not_ported("a regularizer object as weight_decay")
        self._learning_rate = float(learning_rate)
        self._parameter_list = list(parameters) if parameters is not None else None
        self._grad_clip = grad_clip
        self._weight_decay = weight_decay
        self._accumulators: dict[torch.Tensor, dict] = {}
        self._step_count = 0

    # ------------------------------------------------------------------ lr
    def get_lr(self) -> float:
        return self._learning_rate

    def set_lr(self, value):
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        raise _not_ported("set_lr_scheduler")

    # --------------------------------------------------------------- state
    def _state_for(self, p) -> dict:
        st = self._accumulators.get(p)
        if st is None:
            st = self._accumulators[p] = self._init_state(p)
        return st

    def _init_state(self, p) -> dict:
        return {}

    # ---------------------------------------------------------------- step
    def _params(self):
        if self._parameter_list is None:
            raise RuntimeError("optimizer constructed without a parameters list")
        return self._parameter_list

    def _decay_mode(self):
        return "l2"

    def _decay_spec(self, p):
        """(coeff, mode, lr_scale) for one parameter: the optimizer's float
        ``weight_decay`` (0 when None) in this optimizer's mode, at the
        full learning rate."""
        coeff = 0.0 if self._weight_decay is None else float(self._weight_decay)
        return coeff, self._decay_mode(), 1.0

    def _param_decay_coeff(self, p):
        """Per-parameter decay spec (AdamW's apply_decay_param_fun
        overrides it)."""
        return self._decay_spec(p)

    def _clipped_grads(self, params_and_grads):
        """[(param, grad)] -> the same with ``grad_clip`` applied, in f32
        where the reference computes in f32; no host sync."""
        clip = self._grad_clip
        if clip is None or not params_and_grads:
            return params_and_grads
        cname = type(clip).__name__
        if cname == "ClipGradByGlobalNorm":
            sq = sum(g.float().square().sum() for _, g in params_and_grads)
            gnorm = torch.sqrt(sq)
            scale = torch.where(gnorm > clip.clip_norm, clip.clip_norm / (gnorm + 1e-6),
                                torch.ones_like(gnorm))
            return [(p, (g.float() * scale).to(g.dtype)) for p, g in params_and_grads]
        if cname == "ClipGradByNorm":
            out = []
            for p, g in params_and_grads:
                n = torch.linalg.vector_norm(g.float())
                scale = torch.where(n > clip.clip_norm, clip.clip_norm / (n + 1e-6),
                                    torch.ones_like(n))
                out.append((p, g * scale.to(g.dtype)))
            return out
        if cname == "ClipGradByValue":
            return [(p, g.clamp(_like(clip.min, g), _like(clip.max, g)))
                    for p, g in params_and_grads]
        return params_and_grads

    def _apply_update(self, p_val, g, state, lr, decay):
        """The update shared by ``step()`` and ``jit.TrainStep``: decay +
        rule + dtype restore.  ``lr`` is an f32 scalar tensor; returns
        (new value, new state)."""
        if g.dtype != p_val.dtype:
            g = g.to(p_val.dtype)
        coeff, mode, lr_scale = decay
        if lr_scale != 1.0:
            lr = lr * lr_scale
        if coeff and mode == "l2":
            g = g + _like(coeff, p_val) * p_val
        new_p, new_state = self._update_rule(p_val, g, state, lr)
        if coeff and mode == "decoupled":
            new_p = new_p.float() - (lr * coeff) * p_val.float()
        new_p = new_p.to(p_val.dtype)
        new_state = {k: v.to(state[k].dtype) if torch.is_tensor(v) else v
                     for k, v in new_state.items()}
        return new_p, new_state

    @torch.no_grad()
    def _update(self, params_and_grads, lr):
        """Clip, then update each parameter in place; ``lr`` a float."""
        lr_on = {}
        for p, g in self._clipped_grads(params_and_grads):
            if p.device not in lr_on:
                lr_on[p.device] = torch.tensor(lr, dtype=torch.float32, device=p.device)
            new_p, self._accumulators[p] = self._apply_update(
                p.detach(), g, self._state_for(p), lr_on[p.device],
                self._param_decay_coeff(p))
            p.copy_(new_p)

    def step(self):
        """Apply one update from each parameter's ``.grad``."""
        lr = self.get_lr()
        self._step_count += 1
        self._update([(p, p.grad) for p in self._params()
                      if p.grad is not None and p.requires_grad], lr)

    def _update_rule(self, p, g, state, lr):
        raise NotImplementedError

    def clear_grad(self, set_to_zero=False):
        for p in self._params():
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad


class SGD(Optimizer):
    def _update_rule(self, p, g, state, lr):
        return p.float() - lr * g.float(), state


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_state(self, p):
        return {"velocity": torch.zeros_like(p, memory_format=torch.contiguous_format)}

    def _update_rule(self, p, g, state, lr):
        mu = _like(self._momentum, g)
        v = mu * state["velocity"] + g
        step = g + mu * v if self._nesterov else v
        return p.float() - lr * step.float(), {"velocity": v}


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=None, grad_clip=None, lazy_mode=False,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip, name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _init_state(self, p):
        zeros = lambda: torch.zeros_like(p, memory_format=torch.contiguous_format)  # noqa: E731
        one = torch.ones((), dtype=torch.float32, device=p.device)
        return {"moment1": zeros(), "moment2": zeros(), "beta1_pow": one,
                "beta2_pow": one.clone()}

    def _update_rule(self, p, g, state, lr):
        b1, b2 = self._beta1, self._beta2
        m = _like(b1, g) * state["moment1"] + _like(1 - b1, g) * g
        v = _like(b2, g) * state["moment2"] + _like(1 - b2, g) * g.square()
        b1p = state["beta1_pow"] * b1
        b2p = state["beta2_pow"] * b2
        mhat = m / (1 - b1p).to(m.dtype)
        vhat = v / (1 - b2p).to(v.dtype)
        new_p = p.float() - lr * mhat.float() / (vhat.sqrt() + _like(self._eps, v)).float()
        return new_p, {"moment1": m, "moment2": v, "beta1_pow": b1p, "beta2_pow": b2p}


class AdamW(Adam):
    """Decoupled weight decay (ref optimizer/adamw.py).
    ``apply_decay_param_fun(name)`` decides per parameter; it is given the
    parameter's ``name`` attribute or "" (torch parameters carry none, and
    the reference's LLaMA parameters are all named "" too)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 parameters=None, weight_decay=0.01, lr_ratio=None,
                 apply_decay_param_fun=None, grad_clip=None, lazy_mode=False,
                 multi_precision=False, name=None):
        if lr_ratio is not None:
            raise _not_ported("AdamW lr_ratio")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision, name)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decay_mode(self):
        return "decoupled"

    def _param_decay_coeff(self, p):
        fun = self._apply_decay_param_fun
        if fun is not None and not fun(getattr(p, "name", None) or ""):
            return 0.0, "decoupled", 1.0
        return self._decay_spec(p)
