"""Ops with hand-written CUDA kernels (see ``ops/_build.py``)."""
