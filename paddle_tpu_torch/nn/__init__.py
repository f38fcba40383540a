"""The nn subset of the ported slices (ref paddle_tpu/nn): torch's
`Module` and `ModuleList` under paddle's names (their train/eval are
paddle's), and paddle-layout layers."""

from torch.nn import Module as Layer  # noqa: F401
from torch.nn import ModuleList as LayerList  # noqa: F401

from . import functional, initializer  # noqa: F401
from .layer.activation import ReLU  # noqa: F401
from .layer.common import Dropout, Embedding, Linear  # noqa: F401
from .layer.container import Sequential  # noqa: F401
from .layer.conv import Conv2D  # noqa: F401
from .layer.loss import CrossEntropyLoss  # noqa: F401
from .layer.norm import (  # noqa: F401
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, LayerNorm,
)
from .layer.pooling import AdaptiveAvgPool2D, MaxPool2D  # noqa: F401
