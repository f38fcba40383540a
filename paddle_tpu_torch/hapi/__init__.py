"""High-level API (counterpart of paddle_tpu/hapi): `Model` and the
callbacks."""

from . import callbacks  # noqa: F401
from .model import Model  # noqa: F401
