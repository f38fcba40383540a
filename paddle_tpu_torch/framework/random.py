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
"""

from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["seed", "RngState", "rng_scope", "installed", "generator_for",
           "next_seed"]

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

    def next_seed(self):
        s = (self._base + ((self.calls * _GOLDEN) & _M32)) & _M32
        self.calls += 1
        return s

    def snapshot(self):
        """Where both streams stand: the generator's state and the seed
        counter (a replay from here draws the same masks)."""
        return self.generator.get_state(), self.calls

    def restore(self, snap):
        state, calls = snap
        self.generator.set_state(state)
        self.calls = calls

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
