"""Meta-parallel layers and engines (counterpart of
paddle_tpu/distributed/fleet/meta_parallel)."""

from .mp_layers import (  # noqa: F401
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding, parallel_linear_split,
)
from .pipeline_parallel import (  # noqa: F401
    PipelineParallel, pipeline_spmd, pipeline_spmd_hetero,
)
from .pp_layers import LayerDesc, PipelineLayer, SharedLayerDesc  # noqa: F401
