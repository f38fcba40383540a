"""paddle.regularizer (counterpart of paddle_tpu/regularizer.py): the
public path of `L1Decay` / `L2Decay`, which live with the optimizers
that read them."""

from .optimizer import L1Decay, L2Decay  # noqa: F401

__all__ = ["L1Decay", "L2Decay"]
