"""Random state (counterpart of paddle_tpu/framework/random.py).

The reference threads JAX keys: a global generator serves eager code,
and the train step installs its own base key with ``rng_scope`` so every
dropout of the step draws from it. Here an engine owns an `RngState` on
its device and installs it with `rng_scope`: its ``torch.Generator``
draws the hidden-dropout masks (`generator_for`), and `next_seed` gives
each attention-dropout call one 32-bit seed (the reference's
``_random.next_key()[0]``). Those seeds are a counter-based stream,
``seed + n * 0x9E3779B9 mod 2**32`` for the n-th call, computed on the
device: drawing one never synchronises with the host, and an engine
seeded alike on another device drops the same attention elements (the
mask is a hash of the seed, shared by the kernels and the plain
versions). Outside a scope, torch's default generators serve. The two
frameworks give different numbers from the same seed.

A meshed engine (``Engine(mesh=)``, the hybrid and pipeline engines)
gives its `RngState` a `DropoutLayout` for each step. Every dropout of
the step then draws no stream at all: its keep mask is murmur3 of the
element's GLOBAL coordinates (batch row, position, feature for hidden
dropout; batch-head, query, key for attention) under a seed of its
site and step, so a mask depends neither on the rank, nor on the
micro-batch split, the sequence-parallel chunk or the pipeline stage
(the property of the reference's GSPMD masks, whose numbers come from
jax's stream and cannot be reproduced). A site is the n-th dropout of
a scope: the engine enters one scope a pipeline unit (the embeddings,
each block, the head), or keeps the one scope of a step that every rank
runs whole.
"""

from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["seed", "RngState", "rng_scope", "installed", "generator_for",
           "next_seed", "DropoutLayout", "layout_for"]

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_tls = threading.local()


def seed(s):
    """paddle.seed: seed torch's default generators (the ones drawn from
    when no RngState is installed) and return the CPU one."""
    return torch.manual_seed(int(s))


class RngState:
    """One engine's random source on `device`, from the integer `seed`."""

    def __init__(self, seed, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self._reseed(seed)

    def _reseed(self, seed):
        self.seed = int(seed)
        self.generator.manual_seed(self.seed)
        self._base = torch.tensor(self.seed & _M32, dtype=torch.int64,
                                  device=self.device)
        self.calls = 0
        self.layout = None      # a meshed step's DropoutLayout

    def next_seed(self):
        s = (self._base + ((self.calls * _GOLDEN) & _M32)) & _M32
        self.calls += 1
        return s

    def snapshot(self):
        """Where both streams stand: the generator's state, the seed
        counter and the layout's site (a replay from here draws the same
        masks)."""
        lay = self.layout
        return (self.generator.get_state(), self.calls,
                None if lay is None else lay.position())

    def restore(self, snap):
        state, calls, pos = snap
        self.generator.set_state(state)
        self.calls = calls
        if pos is not None:
            self.layout.set_position(pos)

    def state_dict(self):
        """Both streams and the seed, as JSON-ready values (the
        generator's state as hex text): what a checkpoint stores so that
        a resumed engine, whatever its own seed, draws the same masks."""
        return {"seed": self.seed, "calls": self.calls,
                "generator": self.generator.get_state().numpy().tobytes()
                .hex()}

    def set_state_dict(self, state):
        self._reseed(state["seed"])
        self.generator.set_state(torch.frombuffer(
            bytearray.fromhex(state["generator"]), dtype=torch.uint8))
        self.calls = int(state["calls"])


@contextlib.contextmanager
def rng_scope(state):
    """Install the `RngState` `state` for this thread: the port's random
    ops on its device draw from it inside the block."""
    prev = getattr(_tls, "state", None)
    _tls.state = state
    try:
        yield state
    finally:
        _tls.state = prev


def installed():
    """The `RngState` installed in this thread, or None."""
    return getattr(_tls, "state", None)


def _installed(device):
    st = getattr(_tls, "state", None)
    if st is not None and st.device.type == torch.device(device).type:
        return st
    return None


def generator_for(device):
    """The installed generator when it lives on `device`'s type, else
    None (torch's default generator for that device)."""
    st = _installed(device)
    return st.generator if st is not None else None


def next_seed(device):
    """A 32-bit seed as a 0-dim int64 tensor on `device`: the installed
    state's next, else a draw from torch's default generator."""
    st = _installed(device)
    if st is not None:
        return st.next_seed()
    return torch.randint(0, 2 ** 32, (), dtype=torch.int64, device=device)


class DropoutLayout:
    """Where this rank's tensors sit in the step's global ones, and the
    dropout sites of the step (see the module docstring).

    `step_seed`: a 0-dim int64 device tensor, the step's draw from the
    engine's `RngState` (the same on every rank). `row0`: the global
    batch row of this rank's first row (its dp slice and micro-batch).
    `seq_len`: the global sequence length: a hidden tensor whose dim 1
    holds ``seq_len / mp_degree`` positions is this rank's
    sequence-parallel chunk, number `mp_rank`. `heads_split`: attention
    heads are split over mp (a tensor-parallel attention), so a call's
    heads are heads ``mp_rank * h, ...`` of ``mp_degree * h``."""

    def __init__(self, step_seed, *, row0=0, seq_len=None, mp_rank=0,
                 mp_degree=1, heads_split=False):
        self.step_seed = step_seed
        self.row0 = int(row0)
        self.seq_len = seq_len
        self.mp_rank, self.mp_degree = int(mp_rank), int(mp_degree)
        self.heads_split = bool(heads_split) and self.mp_degree > 1
        self.scope, self.n = 0, 0
        self._seeds = {}        # scope -> int64 [width] site seeds

    def enter(self, scope):
        """Start the sites of `scope` (an int): its n-th dropout is site
        (scope, n) whatever ran before it on this rank."""
        self.scope, self.n = int(scope), 0

    def position(self):
        return self.row0, self.scope, self.n

    def set_position(self, pos):
        self.row0, self.scope, self.n = pos

    def site_seed(self):
        """The next site's seed: a 0-dim int64 device tensor (a view of
        the scope's table, hashed on the device from the step seed)."""
        from ..ops.fused_ops import hash3

        n = self.n
        self.n += 1
        row = self._seeds.get(self.scope)
        if row is None or n >= row.numel():
            width = 16 if row is None else 2 * row.numel()
            while width <= n:
                width *= 2
            dev = self.step_seed.device
            row = hash3(self.step_seed,
                        torch.tensor([self.scope], dtype=torch.int64,
                                     device=dev),
                        torch.zeros(1, dtype=torch.int64, device=dev),
                        torch.arange(width, dtype=torch.int64,
                                     device=dev)).reshape(width)
            self._seeds[self.scope] = row
        return row[n]

    def _pos0(self, s):
        """The global position of this rank's first position of a
        tensor whose dim 1 holds `s` of them."""
        if self.seq_len is None or s == self.seq_len:
            return 0
        if s * self.mp_degree == self.seq_len:
            return self.mp_rank * s
        raise ValueError(
            f"dropout layout: {s} positions are neither the sequence "
            f"({self.seq_len}) nor its sequence-parallel chunk")

    def hidden_keep(self, x, keep_below):
        """The bool keep mask of a hidden dropout of `x` (dim 0 the
        batch rows, dim 1 the positions when x has three or more dims,
        the rest one feature axis): murmur3 of (global row, global
        position, feature) under the site's seed below `keep_below`."""
        from ..ops.fused_ops import hash3

        dev = x.device
        seed = self.site_seed()
        b = x.shape[0]
        s = x.shape[1] if x.dim() >= 3 else 1
        feat = x.numel() // max(b * s, 1)
        ar = lambda n: torch.arange(n, dtype=torch.int64, device=dev)  # noqa
        pos0 = self._pos0(s) if x.dim() >= 3 else 0
        h = hash3(seed, ar(b) + self.row0, ar(s) + pos0, ar(feat))
        return (h < keep_below).reshape(x.shape)

    def attention(self, heads):
        """(seed, bh_offset) of an attention dropout over `heads` heads a
        row (`ops.fused_ops.flash_attention`'s)."""
        if self.heads_split:
            offset = (self.row0, self.mp_rank * heads,
                      self.mp_degree * heads)
        else:
            offset = (self.row0, 0, heads)
        return self.site_seed(), offset


def layout_for(device):
    """The installed state's `DropoutLayout` when the state lives on
    `device`'s type, else None."""
    st = _installed(device)
    return st.layout if st is not None else None
