"""paddle.nn of the port (ref paddle_tpu/nn/__init__.py): paddle's
`Layer` (a torch ``Module`` with ``create_parameter`` and
``set_state_dict``) and `Parameter`, the containers, and every layer of
the reference's list in paddle's layouts. Not ported: `SyncBatchNorm`
and ``nn.quant``."""

from . import functional, initializer, utils  # noqa: F401
from ..clip import (  # noqa: F401
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
)
from .layer import loss  # noqa: F401
from .layer.layers import Layer, Parameter  # noqa: F401
from .layer.container import (  # noqa: F401
    LayerDict, LayerList, ParameterList, Sequential,
)
from .layer.common import (  # noqa: F401
    AlphaDropout, Bilinear, CosineSimilarity, Dropout, Dropout2D,
    Dropout3D, Embedding, Flatten, Identity, Linear, Pad1D, Pad2D, Pad3D,
    PairwiseDistance, PixelShuffle, Unfold, Upsample,
    UpsamplingBilinear2D, UpsamplingNearest2D,
)
from .layer.conv import (  # noqa: F401
    Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
    Conv3DTranspose,
)
from .layer.norm import (  # noqa: F401
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, GroupNorm,
    InstanceNorm1D, InstanceNorm2D, InstanceNorm3D, LayerNorm,
    LocalResponseNorm, RMSNorm, SpectralNorm,
)
from .layer.pooling import (  # noqa: F401
    AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
    AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
    AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D,
)
from .layer.activation import (  # noqa: F401
    CELU, ELU, GELU, Hardshrink, Hardsigmoid, Hardswish, Hardtanh, LeakyReLU,
    LogSigmoid, LogSoftmax, Maxout, Mish, PReLU, ReLU, ReLU6, SELU, Sigmoid,
    Silu, Softmax, Softplus, Softshrink, Softsign, Swish, Tanh, Tanhshrink,
    ThresholdedReLU,
)
from .layer.loss import (  # noqa: F401
    BCELoss, BCEWithLogitsLoss, CrossEntropyLoss, CTCLoss, HSigmoidLoss,
    KLDivLoss, L1Loss, MarginRankingLoss, MSELoss, NLLLoss, SmoothL1Loss,
)
from .utils import spectral_norm  # noqa: F401
from .layer.rnn import (  # noqa: F401
    GRU, GRUCell, LSTM, LSTMCell, RNN, BiRNN, RNNCellBase, SimpleRNN,
    SimpleRNNCell,
)
from .layer.decode import BeamSearchDecoder, dynamic_decode  # noqa: F401
from .layer.transformer import (  # noqa: F401
    MultiHeadAttention, Transformer, TransformerDecoder,
    TransformerDecoderLayer, TransformerEncoder, TransformerEncoderLayer,
)
