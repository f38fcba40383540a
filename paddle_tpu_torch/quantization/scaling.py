"""Delayed scaling for the low-precision matmul path (counterpart of
paddle_tpu/quantization/scaling.py).

``ScaleState`` is the fp8-recipe amax bookkeeping as one NamedTuple of
device tensors, carried by `engine.Engine` in ``state.buffers`` under
``LOWP_SCALE_KEY``:

  * ``history`` — per-slot ring of the last H abs-max values, written
    each step (the QAT observers' abs-max statistic without the EMA:
    delayed scaling keeps the raw window and takes its max).
  * ``scale``   — the active per-slot representable abs-max, updated
    every ``FLAGS_lowp_scale_interval`` steps as
    ``max(history) * 2**FLAGS_lowp_amax_margin``.
  * ``step`` / ``updates`` — schedule counters (int32).
  * ``clipped`` / ``total`` — running element counts (f32, as in the
    reference) feeding the clip-rate gauge.

Slots bind to matmul operands in call order (`ops.lowp._ScaleRegion`);
the capacity is ``FLAGS_lowp_slots``. A slot unseen in a step writes
0.0 into its ring column, so its scale decays toward the floor as its
window rolls off. `update_scale_state` runs on the device with no host
read; `publish_scale_state` is the one host read.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device

__all__ = ["ScaleState", "init_scale_state", "update_scale_state",
           "publish_scale_state"]

_EPS = 1e-9


class ScaleState(NamedTuple):
    history: torch.Tensor   # f32 [capacity, H] amax ring
    scale: torch.Tensor     # f32 [capacity] active delayed scales
    step: torch.Tensor      # int32 [] steps absorbed into the history
    updates: torch.Tensor   # int32 [] scale-recompute events so far
    clipped: torch.Tensor   # f32 [] elements clipped, cumulative
    total: torch.Tensor     # f32 [] elements quantized, cumulative


def init_scale_state(capacity=None, history=None, device=None):
    """Fresh state on `device` (default cuda): unit scales (never used:
    the first step falls back to the dynamic abs-max), an empty ring."""
    from ..framework.flags import flag

    cap = int(flag("FLAGS_lowp_slots") if capacity is None else capacity)
    h = int(flag("FLAGS_lowp_amax_history") if history is None
            else history)
    cap, h = max(cap, 1), max(h, 1)
    dev = resolve_device(device)
    f32, i32 = torch.float32, torch.int32
    return ScaleState(
        history=torch.zeros((cap, h), dtype=f32, device=dev),
        scale=torch.ones((cap,), dtype=f32, device=dev),
        step=torch.zeros((), dtype=i32, device=dev),
        updates=torch.zeros((), dtype=i32, device=dev),
        clipped=torch.zeros((), dtype=f32, device=dev),
        total=torch.zeros((), dtype=f32, device=dev))


def update_scale_state(state, amax, mask, clipped=None, total=None):
    """One step of the delayed-scaling schedule, on the device.

    amax: f32 [capacity] this step's per-slot abs-max (0 where unseen);
    mask: bool [capacity] the slots seen. Writes ring column
    ``step % H``, then every ``FLAGS_lowp_scale_interval`` steps sets
    ``scale = max(ring) * 2**margin`` for slots whose ring holds any
    signal (an all-zero ring keeps its previous scale, so a never-seen
    slot stays at the unit init instead of the epsilon floor)."""
    from ..framework.flags import flag

    margin = int(flag("FLAGS_lowp_amax_margin"))
    interval = max(int(flag("FLAGS_lowp_scale_interval")), 1)
    cap, h = state.history.shape
    dev = state.history.device
    amax = torch.as_tensor(amax, dtype=torch.float32, device=dev).reshape(cap)
    mask = torch.as_tensor(mask, dtype=torch.bool, device=dev).reshape(cap)
    col = torch.remainder(state.step, h)
    here = torch.arange(h, device=dev) == col
    seen = torch.where(mask, amax, torch.zeros((), device=dev))
    ring = torch.where(here[None, :], seen[:, None], state.history)
    step = state.step + 1
    do = torch.remainder(step, interval) == 0
    ringmax = ring.amax(1)
    fresh = torch.clamp_min(ringmax * (2.0 ** margin), _EPS)
    scale = torch.where(do & (ringmax > 0.0), fresh, state.scale)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return ScaleState(
        history=ring, scale=scale, step=step,
        updates=state.updates + do.to(torch.int32),
        clipped=state.clipped + (zero if clipped is None else clipped),
        total=state.total + (zero if total is None else total))


def publish_scale_state(state):
    """Host side: push the state's counters into the monitor stats
    behind the reference's ``paddle_lowp_*`` family. Waits for the
    device: call it from benchmark or diagnostic code, never the hot
    loop. Returns the clip rate."""
    from ..framework import monitor

    monitor.stat_set("lowp.scale_updates", int(state.updates))
    monitor.stat_set("lowp.clipped_elems", int(state.clipped))
    monitor.stat_set("lowp.quantized_elems", int(state.total))
    monitor.stat_set("lowp.amax_history_depth", int(state.history.shape[1]))
    tot = float(state.total)
    rate = float(state.clipped) / tot if tot > 0 else 0.0
    # monitor stats are integers: the rate gauge is kept in ppm
    monitor.stat_set("lowp.clip_rate_ppm", int(round(rate * 1e6)))
    return rate
