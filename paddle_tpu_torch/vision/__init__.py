"""Vision models of the ported slices (ref paddle_tpu/vision)."""
