"""The nn subset of the ported slices (ref paddle_tpu/nn): paddle's
`Layer` (a torch ``Module`` with ``create_parameter`` and
``set_state_dict``) and `Parameter`, torch's ``ModuleList`` under
paddle's name, and paddle-layout layers."""

from torch.nn import ModuleList as LayerList  # noqa: F401

from . import functional, initializer  # noqa: F401
from .layer.layers import Layer, Parameter  # noqa: F401
from .layer.activation import ReLU  # noqa: F401
from .layer.common import Dropout, Embedding, Linear  # noqa: F401
from .layer.container import Sequential  # noqa: F401
from .layer.conv import Conv2D  # noqa: F401
from .layer.loss import CrossEntropyLoss  # noqa: F401
from .layer.norm import (  # noqa: F401
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, LayerNorm,
)
from .layer.pooling import AdaptiveAvgPool2D, MaxPool2D  # noqa: F401
