"""paddle_tpu_torch stands alone: it imports neither JAX nor the reference
package, and it never carries on silently on the CPU.

- In a subprocess where ``import jax`` and ``import paddle_tpu`` fail, every
  module of the port and ``chip_smoke.py`` import.
- Every kernel source under ``csrc/`` (``*.cu`` and the shared ``*.cuh``)
  ships as package data.
- An AST scan of the port's sources finds no jax/paddle_tpu import.
- Building the engine's model with no ``device=`` on a machine without CUDA
  raises instead of falling back to the CPU.
"""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "paddle_tpu_torch"

_BLOCKED_IMPORTS = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any import of them now raises
sys.modules["paddle_tpu"] = None
sys.path.insert(0, sys.argv[1])
import paddle_tpu_torch
names = [m.name for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                               "paddle_tpu_torch.")]
for needed in ("jit.train_step", "jit._step_impl", "optimizer.optimizer", "nn.clip",
               "nn.functional.loss",  # the training slice's modules
               "models.bert", "ops.fused_ln", "ops._prng", "nn.layer.norm",
               "nn.functional.common",  # the encoder slice's
               "vision.models.resnet", "vision.models._fused_resnet", "ops.fused_conv_bn",
               "nn.functional.conv", "nn.functional.pooling", "nn.layer.conv",
               "nn.layer.pooling"):  # the ResNet slice's
    assert "paddle_tpu_torch." + needed in names, needed
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1] + "/chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")
                and sys.modules[m] is not None)
print(len(names), leaked)
"""


def test_port_imports_without_jax_or_reference():
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORTS, str(ROOT)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, leaked = out.stdout.split(" ", 1)
    assert int(n) >= 46  # every module of slices 1 to 5 was imported
    assert leaked.strip() == "[]"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax_or_reference(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")]
    assert not bad, f"{path.name} imports {bad}"


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from paddle_tpu_torch.core.device import resolve_device
    from paddle_tpu_torch.framework.random import get_generator
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.vision.models import resnet50

    with pytest.raises(RuntimeError, match="CUDA"):
        LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        resnet50(data_format="NHWC")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda:0")
    with pytest.raises(RuntimeError, match="CUDA"):
        get_generator()
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("tpu")


def test_kernel_sources_ship_as_package_data():
    from paddle_tpu_torch.ops import _build

    text = (ROOT / "pyproject.toml").read_text()
    assert '"paddle_tpu_torch" = ["csrc/*.cu", "csrc/*.cuh"]' in text
    kernels = ["decode_attention", "encoder_attention", "encoder_attention_bwd",
               "flash_attention", "flash_attention_bwd", "fused_conv_bn", "fused_ln",
               "paged_attention"]
    assert _build.sources() == kernels  # one library per .cu, built at first use
    for name in kernels:
        assert (PKG / "csrc" / f"{name}.cu").is_file()
    for header in ("encoder_wgmma.cuh", "kv_attention.cuh", "philox.cuh",
                   "wgmma_attention.cuh"):
        assert (PKG / "csrc" / header).is_file()
