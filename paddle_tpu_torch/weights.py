"""Weights across the package boundary, as numpy arrays under
``paddle_tpu.engine.state_values`` names (the two packages' parameter
names and layouts are equal one to one)."""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from . import resolve_device
from .quantization import dequantize_state, is_quantized_state

__all__ = ["from_paddle_tpu_values", "to_numpy_values"]


def from_paddle_tpu_values(values, model, device=None):
    """Load a ``{name: array}`` state-values dict into the port's `model`.

    A pre-frozen int8 dict (``quantize_state_int8`` output: int8 leaves
    plus ``@scale`` companions) loads as its canonical dequant. Returns
    the dict as tensors on `device` (default: the model's device) with
    int8 leaves kept int8, ready for ``SlotEngine(values=...)``. Raises
    on missing or unexpected names and on shape mismatches."""
    dev = resolve_device(device) if device is not None else model.device
    tvals = {k: torch.as_tensor(np.array(v)).to(dev)
             for k, v in values.items()}
    fvals = dequantize_state(tvals) if is_quantized_state(tvals) else tvals
    model.load_state_dict(fvals, strict=True)
    return tvals


def to_numpy_values(model):
    """The model's state as ``OrderedDict[name, np.ndarray]``."""
    return OrderedDict((k, v.detach().cpu().numpy())
                       for k, v in model.state_dict().items())
