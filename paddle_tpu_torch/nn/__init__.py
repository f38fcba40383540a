"""The nn subset the GPT serving slice uses (ref paddle_tpu/nn)."""

from torch.nn import Module as Layer  # noqa: F401
from torch.nn import ModuleList as LayerList  # noqa: F401

from . import functional, initializer  # noqa: F401
from .layer.common import Dropout, Embedding, Linear  # noqa: F401
from .layer.norm import LayerNorm  # noqa: F401
