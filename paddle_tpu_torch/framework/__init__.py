"""Runtime flags and the stat registry (serving subset)."""
