"""Fleet (counterpart of paddle_tpu/distributed/fleet): only
`utils.recompute` is ported so far."""
