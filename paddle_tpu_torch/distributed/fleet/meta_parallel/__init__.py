"""Meta-parallel layers and engines (counterpart of
paddle_tpu/distributed/fleet/meta_parallel)."""

from .mp_layers import (  # noqa: F401
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding, parallel_linear_split,
)
from .pipeline_parallel import PipelineParallel, pipeline_spmd  # noqa: F401
