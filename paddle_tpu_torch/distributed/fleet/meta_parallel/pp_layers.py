"""Pipeline layer description and segmentation (counterpart of
paddle_tpu/distributed/fleet/meta_parallel/pp_layers.py).

`PipelineLayer` builds a model from a list of `LayerDesc` /
`SharedLayerDesc` entries, layers and callables into ``run_function``
(a `LayerList`, so parameters are named ``run_function.<n>.*`` as in the
reference) and cuts it into ``num_stages`` contiguous stages of equal
count (``segment_parts``). Every rank builds every stage, as the
reference's one process does; `distributed.pp_engine.PipelineEngine`
keeps this rank's stage and frees the others. The second occurrence of
a `SharedLayerDesc` key is a `_SharedRef` to the first one's layer (the
same parameters, registered once, with an optional other forward: a
tied embedding read as the logits' table).
"""

from __future__ import annotations

from ....nn.layer.container import LayerList
from ....nn.layer.layers import Layer

__all__ = ["LayerDesc", "SharedLayerDesc", "PipelineLayer"]


class LayerDesc:
    def __init__(self, layer_func, *inputs, **kwargs):
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs
        if not issubclass(layer_func, Layer):
            raise TypeError("LayerDesc expects an nn.Layer subclass")

    def build_layer(self):
        return self.layer_func(*self.inputs, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_func.__name__})"


class SharedLayerDesc(LayerDesc):
    def __init__(self, key, layer_func, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class PipelineLayer(Layer):
    """The reference's ``PipelineLayer`` (``pp_layers.py:202``)."""

    def __init__(self, layers, num_stages=None, topology=None,
                 loss_fn=None, seg_method="uniform", recompute_interval=0,
                 recompute_ctx=None, num_virtual_pipeline_stages=None):
        super().__init__()
        self._loss_fn = loss_fn
        self._topo = topology
        if num_stages is None and topology is not None:
            num_stages = topology.get_dim("pipe")
        self._num_stages = num_stages or 1
        self._seg_method = seg_method
        self._recompute_interval = recompute_interval
        built = []
        self._shared = {}
        for d in layers:
            if isinstance(d, SharedLayerDesc):
                if d.layer_name in self._shared:
                    built.append(_SharedRef(self._shared[d.layer_name],
                                            d.forward_func))
                else:
                    layer = d.build_layer()
                    self._shared[d.layer_name] = layer
                    built.append(layer)
            elif isinstance(d, LayerDesc):
                built.append(d.build_layer())
            elif isinstance(d, Layer):
                built.append(d)
            elif callable(d):
                built.append(_FuncLayer(d))
            else:
                raise TypeError(f"bad pipeline entry {d!r}")
        self.run_function = LayerList(built)
        self._segment()

    def _segment(self):
        n = len(self.run_function)
        s = self._num_stages
        base, rem = divmod(n, s)
        bounds = [0]
        for i in range(s):
            bounds.append(bounds[-1] + base + (1 if i < rem else 0))
        self.segment_parts = bounds

    def get_stage_layers(self, stage_id):
        lo, hi = self.segment_parts[stage_id], \
            self.segment_parts[stage_id + 1]
        return [self.run_function[i] for i in range(lo, hi)]

    def stage_of_layer(self, idx):
        for s in range(self._num_stages):
            if self.segment_parts[s] <= idx < self.segment_parts[s + 1]:
                return s
        return self._num_stages - 1

    def forward(self, x):
        for layer in self.run_function:
            x = layer(x)
        return x

    @property
    def num_stages(self):
        return self._num_stages

    def loss_fn(self, *args):
        return self._loss_fn(*args)


class _FuncLayer(Layer):
    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def forward(self, *args):
        return self._fn(*args)


class _SharedRef(Layer):
    """Second occurrence of a SharedLayerDesc: same parameters, optional
    alternate forward (e.g. tied embedding -> logits)."""

    def __init__(self, base, forward_func=None):
        super().__init__()
        self._base = [base]  # hidden from the sublayers: counted once
        self._forward_func = forward_func

    def forward(self, *args):
        base = self._base[0]
        if self._forward_func is not None:
            return self._forward_func(base, *args)
        return base(*args)
