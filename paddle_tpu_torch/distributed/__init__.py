"""Distributed training (counterpart of paddle_tpu/distributed): so far
`fleet.utils.recompute`, the single-process half of `checkpoint`
(atomic verified saves, `CheckpointManager`, `AsyncCheckpointManager`,
`train_epoch_range`) and `preempt`."""
