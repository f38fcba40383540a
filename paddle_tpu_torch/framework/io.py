"""paddle.save / paddle.load (counterpart of paddle_tpu/framework/io.py):
pickled numpy, protocol 4. Tensors become numpy arrays on the host
(nested dicts, lists and tuples keep their shape), so a file written by
either package loads in the other."""

from __future__ import annotations

import os
import pickle

import torch

__all__ = ["save", "load"]


def _to_saveable(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_saveable(v) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_saveable(obj), f, protocol=protocol)


def load(path, **configs):
    with open(path, "rb") as f:
        return pickle.load(f)
