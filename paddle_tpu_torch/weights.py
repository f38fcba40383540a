"""Weights across the package boundary, as numpy arrays under
``paddle_tpu.engine.state_values`` names (the two packages' parameter
names and layouts are equal one to one: GPT, ERNIE pretraining and
``ErnieForSequenceClassification``, whose ``classifier.weight`` is
``[hidden, classes]`` as the reference's ``Linear``; the ResNet family,
whose state also holds the batch norms' ``_mean`` / ``_variance``
running stats, loaded as buffers; and any model built from `nn` layers:
a `Transformer`, the RNN family under ``weight_ih_l{k}[_reverse]`` ...,
`SpectralNorm`'s ``weight_u`` / ``weight_v``, a weight-normed layer's
``weight_g`` / ``weight_v`` and a spectral-normed one's ``weight_orig``
/ ``weight_u`` / ``weight_v``), and the engine state that a resumed
trajectory needs: the optimizer's moments and the low-precision
ScaleState."""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from . import resolve_device
from .quantization import dequantize_state, is_quantized_state

__all__ = ["from_paddle_tpu_values", "from_paddle_tpu_opt_state",
           "from_paddle_tpu_scale_state", "to_numpy_values"]


def from_paddle_tpu_values(values, model, device=None):
    """Load a ``{name: array}`` state-values dict into the port's `model`
    (by default onto the model's device: its ``device`` attribute, else
    where its state lies).

    A pre-frozen int8 dict (``quantize_state_int8`` output: int8 leaves
    plus ``@scale`` companions) loads as its canonical dequant. Returns
    the dict as tensors on `device` (default: the model's device) with
    int8 leaves kept int8, ready for ``SlotEngine(values=...)``. Raises
    on missing or unexpected names and on shape mismatches."""
    if device is not None:
        dev = resolve_device(device)
    else:
        dev = getattr(model, "device", None) or next(
            iter(model.state_dict().values())).device
    tvals = {k: _tensor_of(v).to(dev) for k, v in values.items()}
    fvals = dequantize_state(tvals) if is_quantized_state(tvals) else tvals
    model.load_state_dict(fvals, strict=True)
    return tvals


def _tensor_of(v):
    """A tensor of the array `v`. A bfloat16 array (the ml_dtypes type
    the reference's decorated leaves carry, told by its dtype name, so
    the port never imports ml_dtypes) is read bit for bit through an
    int16 view."""
    a = np.array(v)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.as_tensor(a)


def to_numpy_values(model):
    """The model's state as ``OrderedDict[name, np.ndarray]``, each leaf
    in its own dtype, except bfloat16 (numpy has none): its leaves come
    back as float32, which holds every bfloat16 value exactly."""
    return OrderedDict(
        (k, (v.float() if v.dtype == torch.bfloat16 else v).detach().cpu()
         .numpy()) for k, v in model.state_dict().items())


@torch.no_grad()
def from_paddle_tpu_opt_state(opt_state, engine):
    """Copy a paddle_tpu engine's optimizer state (``engine.state.
    opt_state``: ``{param name: {"moment1": ..., "beta1_pow": ...}}``,
    arrays) into the port's `engine`, in place, so a trajectory resumes
    where the reference's left off. Raises on missing or unexpected
    parameter or state names and on shape mismatches."""
    mine = engine.state.opt_state
    if set(opt_state) != set(mine):
        raise KeyError(
            f"optimizer state names differ: missing "
            f"{sorted(set(mine) - set(opt_state))}, unexpected "
            f"{sorted(set(opt_state) - set(mine))}")
    for name, st in opt_state.items():
        if set(st) != set(mine[name]):
            raise KeyError(f"{name}: state keys {sorted(st)} != "
                           f"{sorted(mine[name])}")
        for key, val in st.items():
            t = _tensor_of(val)
            if tuple(t.shape) != tuple(mine[name][key].shape):
                raise ValueError(f"{name}.{key}: shape {tuple(t.shape)} "
                                 f"!= {tuple(mine[name][key].shape)}")
            mine[name][key].copy_(t)


def from_paddle_tpu_scale_state(scale_state, engine):
    """Install a paddle_tpu engine's low-precision ScaleState
    (``engine.state.buffers["__lowp_scale__"]``: a NamedTuple, or a
    dict, of arrays under the fields of `quantization.ScaleState`) in
    the port's `engine`, so a low-precision trajectory resumes with the
    reference's amax history and scales. The engine must have been built
    with ``FLAGS_lowp_matmul`` on; raises on missing or unexpected
    fields and on shape mismatches."""
    from .engine import LOWP_SCALE_KEY
    from .quantization.scaling import ScaleState

    mine = engine.state.buffers.get(LOWP_SCALE_KEY)
    if mine is None:
        raise KeyError("the engine carries no ScaleState: FLAGS_lowp_matmul "
                       "was off when it was built")
    leaves = scale_state._asdict() if hasattr(scale_state, "_asdict") \
        else dict(scale_state)
    if set(leaves) != set(ScaleState._fields):
        raise KeyError(f"ScaleState fields {sorted(leaves)} != "
                       f"{sorted(ScaleState._fields)}")
    new = {}
    for name in ScaleState._fields:
        t = _tensor_of(leaves[name])
        ref = getattr(mine, name)
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"ScaleState.{name}: shape {tuple(t.shape)} "
                             f"!= {tuple(ref.shape)}")
        new[name] = t.to(device=ref.device, dtype=ref.dtype)
    engine.state.buffers[LOWP_SCALE_KEY] = ScaleState(**new)
