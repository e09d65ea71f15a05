"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu, for NVIDIA Hopper.

The JAX package ``paddle_tpu`` stays the reference; this package mirrors its
module paths (``paddle_tpu_torch.models.llama`` is the counterpart of
``paddle_tpu.models.llama``) and never imports it or JAX.  Every TPU kernel
on a ported path is a kernel written by hand for Hopper under ``csrc/``,
built at first use (``ops/_build.py``); its plain PyTorch version serves
CPU tensors and is the kernel's oracle.

Ported so far: the paged serving path — ``models.llama`` on the paged kv
cache, the ragged paged-attention kernel (``ops.decode_attention``) and the
paged ``inference.LLMEngine``.  ROADMAP.md lists what is still to port.
"""

__version__ = "0.1.0"
