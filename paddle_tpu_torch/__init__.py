"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu, for NVIDIA Hopper.

The JAX package ``paddle_tpu`` stays the reference; this package mirrors its
module paths (``paddle_tpu_torch.models.llama`` is the counterpart of
``paddle_tpu.models.llama``) and never imports it or JAX.  Every TPU kernel
on a ported path is a kernel written by hand for Hopper under ``csrc/``,
built at first use (``ops/_build.py``); its plain PyTorch version serves
CPU tensors and is the kernel's oracle.

Ported so far: serving — ``models.llama`` with ``generate()`` on the
static and paged kv caches and the dense and paged ``inference.LLMEngine``
(the decode, paged, flash and encoder attention kernels of ``ops``); and
training — ``LlamaForCausalLM(ids, labels=)`` under ``jit.TrainStep`` with
the ``optimizer`` package and ``nn`` clipping, through the flash and
encoder attention backward kernels; and BERT/ERNIE pretraining
(``models.bert``) through the fused dropout + add + LayerNorm kernels and
the encoder attention kernels with their Philox dropout; and ResNet
training (``vision.models``, ``nn.Conv2D``/``BatchNorm2D``/pooling) whose
NHWC bottlenecks run the fused 1x1-conv + BatchNorm kernels forward and
backward (``ops.fused_conv_bn``).  ``seed(s)`` reseeds every device's
generator, and with it every dropout mask.
ROADMAP.md lists what is still to port.
"""

from .framework.random import seed  # noqa: F401

__version__ = "0.1.0"
