"""PyTorch / CUDA port of paddle_tpu, one slice at a time.

Module paths and public names mirror ``paddle_tpu`` so each counterpart
is easy to find; inside, the code is plain PyTorch: ``nn.Module``s,
functions on tensors, an explicit ``device`` and explicit
``torch.Generator``s. Every hand-written kernel lives under ``csrc/``
and is built by ``ops/_build.py`` with nvcc on first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(the CPU tests do); asking for ``cuda`` where no GPU is visible raises
instead of silently running on the CPU. Float32 matmuls run in full
float32 (TF32 off), as the reference computes in float32.

This package imports neither ``jax`` nor anything of ``paddle_tpu``.
"""

from __future__ import annotations

import numpy as np
import torch

from .framework.io import load, save
from .framework.random import seed
from .param_attr import ParamAttr

__all__ = ["seed", "default_device", "resolve_device", "to_tensor", "save",
           "load", "ParamAttr", "Model"]

# the reference computes in float32: keep cuBLAS and cuDNN off TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def default_device():
    """The port's default device: the first CUDA card."""
    return torch.device("cuda")


def resolve_device(device=None):
    """``device`` as a ``torch.device`` (None -> `default_device`; a
    bare 'cuda' gets the current card's index, so devices compare).
    Raises when CUDA is asked for and no GPU is visible — the port never
    falls back to the CPU on its own."""
    dev = torch.device(device) if device is not None else default_device()
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on CUDA by default and no GPU is "
                "visible; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:   # 'cuda' -> the current card, 'cuda:N'
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_tensor(data, dtype=None, device=None):
    """paddle.to_tensor: a copy of `data` on `device` (default cuda)."""
    dev = resolve_device(device)
    if isinstance(data, torch.Tensor):
        return data.detach().to(device=dev, dtype=dtype, copy=True)
    return torch.as_tensor(np.array(data), dtype=dtype, device=dev)


def __getattr__(name):
    # paddle.Model, imported on first use (it pulls in the engine)
    if name == "Model":
        from .hapi import Model

        return Model
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
