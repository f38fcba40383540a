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
ScaleState.

`shard_values` / `gather_values` carry weights across to a model built
under a hybrid group: the reference's full arrays onto this rank's
model-parallel shards, by each parameter's ``split_axis`` /
``packed_heads`` marks (`distributed.fleet.meta_parallel.mp_layers`),
and a sharded model back into full arrays."""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from . import resolve_device
from .quantization import dequantize_state, is_quantized_state

__all__ = ["from_paddle_tpu_values", "from_paddle_tpu_opt_state",
           "from_paddle_tpu_scale_state", "to_numpy_values",
           "shard_values", "gather_values", "shard_array", "join_arrays"]


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


# -- sharded models ----------------------------------------------------------


def shard_array(full, axis, rank, degree, packs=1):
    """Rank `rank`'s piece of `full` split `degree` ways along `axis`.
    With `packs` > 1 the axis is laid out as [packs, ...] and the rank
    takes its piece of each pack (GPT's q / k / v: its heads of each)."""
    a = np.moveaxis(np.asarray(full), axis, 0)
    a = a.reshape((packs, degree, a.shape[0] // (packs * degree))
                  + a.shape[1:])[:, rank]
    return np.moveaxis(a.reshape((-1,) + a.shape[2:]), 0, axis)


def join_arrays(pieces, axis, packs=1):
    """The inverse of `shard_array`: the ranks' pieces, in rank order,
    back into the full array."""
    a = [np.moveaxis(np.asarray(p), axis, 0) for p in pieces]
    per = a[0].shape[0] // packs
    stacked = np.stack([x.reshape((packs, per) + x.shape[1:]) for x in a],
                       axis=1)
    return np.moveaxis(stacked.reshape((-1,) + a[0].shape[1:]), 0, axis)


def _mp_of(hcg):
    if hcg is None:
        from .distributed.topology import get_hybrid_communicate_group

        hcg = get_hybrid_communicate_group()
    if hcg is None:
        return 0, 1
    return hcg.get_model_parallel_rank(), hcg.get_model_parallel_world_size()


def _split_of(t):
    packs = getattr(t, "packed_heads", None)
    return getattr(t, "split_axis", None), packs[0] if packs else 1


@torch.no_grad()
def shard_values(values, model, hcg=None):
    """Write the reference's full ``{name: array}`` into `model`, built
    under the hybrid group `hcg` (default: the current one): each
    parameter takes this rank's model-parallel piece (by its
    ``split_axis`` / ``packed_heads``), the others the whole array.
    Returns this rank's ``{name: array}``. Raises on missing or
    unexpected names and on shape mismatches."""
    rank, degree = _mp_of(hcg)
    sd = model.state_dict(keep_vars=True)
    if set(values) != set(sd):
        raise KeyError(f"names differ: missing {sorted(set(sd) - set(values))}"
                       f", unexpected {sorted(set(values) - set(sd))}")
    local = OrderedDict()
    for name, t in sd.items():
        axis, packs = _split_of(t)
        full = np.asarray(values[name])
        a = full if axis is None else shard_array(full, axis, rank, degree,
                                                  packs)
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"{name}: shard {a.shape} != parameter "
                             f"{tuple(t.shape)}")
        t.copy_(_tensor_of(a))
        local[name] = a
    return local


def gather_values(model, hcg=None, names=None):
    """The full ``{name: array}`` of a model sharded under the hybrid
    group `hcg`, on every rank (a collective: every rank calls it). Each
    name is taken from the ranks at dp 0 and sharding 0 that hold it (a
    pipeline stage holds only its blocks; an emptied parameter is not
    held) and joined over mp. A ZeRO-3 engine's parameters must be
    gathered into the model first (``sync_to_layer``)."""
    from .distributed.collective import all_gather_object
    from .distributed.parallel import get_rank

    if hcg is None:
        from .distributed.topology import get_hybrid_communicate_group

        hcg = get_hybrid_communicate_group()
    sd = model.state_dict(keep_vars=True)
    names = list(sd) if names is None else list(names)
    mine = {}
    for name in names:
        t = sd[name]
        if t.numel():
            mine[name] = (t.detach().float().cpu().numpy()
                          if t.dtype == torch.bfloat16
                          else t.detach().cpu().numpy())
    if hcg is None:
        return OrderedDict((k, mine[k]) for k in names)
    coord = hcg.rank_coord(get_rank())
    got = all_gather_object([], (coord, mine))
    out = OrderedDict()
    for name in names:
        axis, packs = _split_of(sd[name])
        pieces = {}
        for (dp, _pp, shard, mp), held in got:
            if dp == 0 and shard == 0 and name in held:
                pieces.setdefault(mp, held[name])
        if not pieces:
            raise KeyError(f"no rank holds {name}")
        if axis is None:
            out[name] = pieces[min(pieces)]
        else:
            out[name] = join_arrays([pieces[r] for r in sorted(pieces)],
                                    axis, packs)
    return out

