"""Distributed training (counterpart of paddle_tpu/distributed): only
`fleet.utils.recompute` is ported so far."""
