"""The training step (counterpart of paddle_tpu/jit/train_step.py).

``TrainStep(model, loss_fn, optimizer)`` keeps the reference's contract:
``step(*batch)`` runs ``loss_fn(*batch)`` (a loss, or a tuple ``(loss,
*aux)``), takes the gradients of every parameter that requires them,
averages them over ``accum_steps`` microbatches of the batch axis, clips
them with the optimizer's ``grad_clip``, applies one update to each
parameter and adds 1 to ``optimizer._step_count``.  It returns the loss, or
``(loss, *aux)``.  The batch is torch tensors.

The reference traces forward, backward and update into one XLA program;
here the step runs eagerly (a CUDA graph of it is later work), and the
update is in place, so ``donate`` is accepted and has no effect.  The two
phases carry ``torch.profiler`` labels, ``TrainStep.forward_backward`` and
``TrainStep.optimizer``, so a profile can split the step's device time.
``scaler=`` (dynamic loss scaling) is not ported yet and raises
NotImplementedError.
"""
from __future__ import annotations

from torch.autograd.profiler import record_function

from ._step_impl import loss_and_grads


class TrainStep:
    """train_step = TrainStep(model, loss_fn, optimizer); loss = train_step(x, y)."""

    def __init__(self, model, loss_fn, optimizer, donate=True, accum_steps=1, scaler=None):
        if scaler is not None:
            raise NotImplementedError(
                "TrainStep(scaler=): GradScaler and AMP loss scaling are not ported "
                "yet (ROADMAP.md Queue 1 item 6: the rest of the surface, amp/)")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._donate = donate
        self.accum_steps = max(1, int(accum_steps))
        self.scaler = None

    def __call__(self, *batch):
        params = [p for p in self.model.parameters() if p.requires_grad]
        lr = self.optimizer.get_lr()
        with record_function("TrainStep.forward_backward"):
            loss, aux, grads = loss_and_grads(self.loss_fn, params, batch, self.accum_steps)
        with record_function("TrainStep.optimizer"):
            self.optimizer._update(list(zip(params, grads)), lr)
        self.optimizer._step_count += 1
        return (loss, *aux) if aux else loss
