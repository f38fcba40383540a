"""The port's package boundary: paddle_tpu_torch (and chip_smoke.py,
chip_ab.py) never import jax or anything of paddle_tpu, and its entry points run on
CUDA unless the caller asks for the CPU — without a GPU they raise
instead of quietly running on the CPU."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "paddle_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _modules():
    out = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def _forbidden(name):
    return name.split(".")[0] in FORBIDDEN


def test_importing_every_module_pulls_in_no_jax_and_no_paddle_tpu():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "paddle_tpu_torch.serving.engine" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py",
                                          REPO / "chip_ab.py"],
    ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert bad == []


def test_entry_points_default_to_cuda_and_raise_without_a_gpu(
        monkeypatch):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.engine import Engine
    from paddle_tpu_torch.nlp.transformers import ernie as ternie
    from paddle_tpu_torch.nlp.transformers import gpt as tgpt
    from paddle_tpu_torch.quantization import init_scale_state
    from paddle_tpu_torch.serving import Server, SlotEngine
    from paddle_tpu_torch.vision.models import resnet18
    from torch_parity import ERNIE_TINY, TINY

    assert pt.default_device() == torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tgpt.GPTConfig(**TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgpt.GPTForPretraining(cfg)
    model = tgpt.GPTForPretraining(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SlotEngine(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Server(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.to_tensor([1, 2])
    assert SlotEngine(model, device="cpu").device.type == "cpu"
    ecfg = ternie.ErnieConfig(**ERNIE_TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ternie.ErnieForPretraining(ecfg)
    ernie = ternie.ErnieForPretraining(ecfg, device="cpu")
    opt = optimizer.AdamW(parameters=ernie.parameters())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(ernie, opt, lambda out, mlm: out[0].sum())
    assert Engine(ernie, opt, lambda out, mlm: out[0].sum(),
                  device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resnet18(num_classes=4)
    assert resnet18(num_classes=4, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_scale_state()
    assert init_scale_state(device="cpu").scale.device.type == "cpu"
