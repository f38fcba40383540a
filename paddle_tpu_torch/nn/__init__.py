"""The nn subset of the ported slices (ref paddle_tpu/nn): torch's
`Module` and `ModuleList` under paddle's names (their train/eval are
paddle's), and paddle-layout layers."""

from torch.nn import Module as Layer  # noqa: F401
from torch.nn import ModuleList as LayerList  # noqa: F401

from . import functional, initializer  # noqa: F401
from .layer.common import Dropout, Embedding, Linear  # noqa: F401
from .layer.norm import LayerNorm  # noqa: F401
