"""Megatron tensor-parallel layers (counterpart of
paddle_tpu/distributed/fleet/meta_parallel/mp_layers.py).

The reference keeps each parameter at its full logical shape with a
PartitionSpec over 'mp' and lets GSPMD insert the collectives. Here each
rank holds only its shard, read from the hybrid group when the layer is
built, and issues the Megatron collectives itself through the conjugate
operators below, each a ``torch.autograd.Function``:

    copy_to_mp         identity forward, all-reduce backward
    reduce_from_mp     all-reduce forward, identity backward
    gather_seq         all-gather of the sequence (dim 1) forward,
                       reduce-scatter backward
    gather_seq_replicated  all-gather of the sequence forward, this
                       rank's piece backward (for a consumer that every
                       rank runs alike on the whole sequence)
    reduce_scatter_seq reduce-scatter of the sequence forward,
                       all-gather backward
    scatter_seq        this rank's piece of the sequence forward,
                       all-gather backward
    gather_last        all-gather of the last dim forward, this rank's
                       piece backward
    scatter_last       this rank's piece of the last dim forward,
                       all-gather backward

With ``sequence_parallel=True`` a column-parallel layer gathers the
sequence before its product and a row-parallel one reduce-scatters it
after, so activations outside the products hold ``s / mp`` positions;
the parameters such a rank uses on its part of the sequence alone (a
row-parallel bias, the LayerNorms around them) carry
``sequence_parallel = True`` and their gradients are summed over mp
(`distributed.sharding`). Sharded parameters carry ``split_axis`` (the
logical dimension that is split) and ``is_distributed``; a packed
projection (GPT's q, k, v) carries ``packed_heads`` = (packs, heads):
its split dimension is laid out as [packs, heads, head_dim] and each
rank holds, for every pack, the heads ``[r * heads / mp, (r + 1) * heads
/ mp)`` (`weights.shard_values` maps full weights onto that layout).

At degree 1 every layer is the dense layer: ``F.linear`` /
``F.embedding`` / softmax cross entropy, so ``FLAGS_lowp_matmul`` routes
its products to kernel B9 as the reference's comment
(``mp_layers.py:172-174``) requires. Under mp > 1 the column- and
row-parallel products route to B9 on the rank's shards with per-tensor
scales that the mp group agrees on (`ops.lowp.shard_groups`): the
abs-max of an operand held in shards (a column-parallel weight, a
row-parallel activation and weight) is reduced (max) over the group, as
the reference's abs-max covers the whole tensor under GSPMD. The scales
and the int8 codes then equal one device's.
"""

from __future__ import annotations

import torch

from .... import amp
from ....nn import functional as F
from ....nn import initializer as I
from ....nn.layer.layers import Layer
from ....ops import lowp as _lowp
from ...collective import (
    all_gather_cat, all_reduce, reduce_scatter_dim, ReduceOp,
)
from ...topology import get_hybrid_communicate_group

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy",
           "parallel_linear_split", "copy_to_mp", "reduce_from_mp",
           "gather_seq", "gather_seq_replicated", "reduce_scatter_seq",
           "scatter_seq", "mp_group_of"]


def mp_group_of(mp_group=None):
    """(group, rank, degree) of model parallelism: `mp_group` when given,
    else the hybrid group's, else degree 1."""
    if mp_group is not None:
        return mp_group, max(mp_group.rank, 0), mp_group.nranks
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        return None, 0, 1
    return (hcg.get_model_parallel_group(), hcg.get_model_parallel_rank(),
            hcg.get_model_parallel_world_size())


def _piece(x, dim, group):
    n = group.nranks
    size = x.shape[dim] // n
    return x.narrow(dim, group.rank * size, size).contiguous()


class _CopyToMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), group=ctx.group), None


class _ReduceFromMP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_cat(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, 1, ctx.group), None


class _ReduceScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return reduce_scatter_dim(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, 1, ctx.group), None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _piece(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, 1, ctx.group), None


class _GatherSeqReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_cat(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        return _piece(g, 1, ctx.group), None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_cat(x, x.dim() - 1, group)

    @staticmethod
    def backward(ctx, g):
        return _piece(g, g.dim() - 1, ctx.group), None


class _ScatterLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _piece(x, x.dim() - 1, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, g.dim() - 1, ctx.group), None


def _apply(fn, x, group):
    if group is None or group.nranks <= 1:
        return x
    return fn.apply(x, group)


def copy_to_mp(x, group):
    return _apply(_CopyToMP, x, group)


def reduce_from_mp(x, group):
    return _apply(_ReduceFromMP, x, group)


def gather_seq(x, group):
    return _apply(_GatherSeq, x, group)


def gather_seq_replicated(x, group):
    return _apply(_GatherSeqReplicated, x, group)


def reduce_scatter_seq(x, group):
    return _apply(_ReduceScatterSeq, x, group)


def scatter_seq(x, group):
    return _apply(_ScatterSeq, x, group)


def _mark(p, split_axis, packed_heads=None):
    p.split_axis = split_axis
    p.is_distributed = split_axis is not None
    if packed_heads is not None:
        p.packed_heads = packed_heads


def _local(n, degree, what):
    if n % degree:
        raise ValueError(f"{what} {n} is not divisible by the model "
                         f"parallel degree {degree}")
    return n // degree


class VocabParallelEmbedding(Layer):
    """Embedding whose table rows (the vocabulary) are split over mp: a
    rank looks up the ids in its range, zeroes the rest, and the ranks'
    rows are summed."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, generator=None):
        super().__init__()
        self.group, self.rank, self.degree = mp_group_of(mp_group)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.per_rank = _local(num_embeddings, self.degree, "vocab size")
        self.vocab_start = self.rank * self.per_rank
        self.weight = self.create_parameter(
            [self.per_rank, embedding_dim], attr=weight_attr,
            default_initializer=I.XavierNormal(), generator=generator)
        _mark(self.weight, 0 if self.degree > 1 else None)

    def forward(self, x):
        if self.degree <= 1:
            return F.embedding(x, self.weight)
        local = x.long() - self.vocab_start
        outside = (local < 0) | (local >= self.per_rank)
        out = F.embedding(local.masked_fill(outside, 0), self.weight)
        out = out.masked_fill(outside.unsqueeze(-1), 0.0)
        return reduce_from_mp(out, self.group)


class ColumnParallelLinear(Layer):
    """Linear whose output features are split over mp: weight ``[in,
    out / mp]``, bias ``[out / mp]``. ``gather_output`` all-gathers the
    output's features; ``sequence_parallel`` all-gathers the input's
    sequence first."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, sequence_parallel=False,
                 packed_heads=None, generator=None):
        super().__init__()
        self.group, self.rank, self.degree = mp_group_of(mp_group)
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        self.sequence_parallel = sequence_parallel and self.degree > 1
        out_local = _local(out_features, self.degree, "out_features")
        if packed_heads is not None:
            _local(packed_heads[1], self.degree, "the number of heads")
        split = 1 if self.degree > 1 else None
        self.weight = self.create_parameter(
            [in_features, out_local], attr=weight_attr,
            default_initializer=I.XavierNormal(), generator=generator)
        _mark(self.weight, split, packed_heads)
        if has_bias or has_bias is None:
            self.bias = self.create_parameter(
                [out_local], attr=None, is_bias=True, generator=generator)
            _mark(self.bias, 0 if split is not None else None, packed_heads)
        else:
            self.bias = None

    def forward(self, x):
        if self.degree <= 1:
            return F.linear(x, self.weight, self.bias)
        x = gather_seq(x, self.group) if self.sequence_parallel \
            else copy_to_mp(x, self.group)
        # the input is whole on every rank; the weight is this rank's
        # columns
        with _lowp.shard_groups(b=self.group):
            out = F.linear(x, self.weight, self.bias)
        if self.gather_output:
            out = _apply(_GatherLast, out, self.group)
        return out


class RowParallelLinear(Layer):
    """Linear whose input features are split over mp: weight ``[in / mp,
    out]``, bias ``[out]`` (replicated, added after the reduction). The
    ranks' partial products are all-reduced, or reduce-scattered over the
    sequence under ``sequence_parallel``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None,
                 sequence_parallel=False, generator=None):
        super().__init__()
        self.group, self.rank, self.degree = mp_group_of(mp_group)
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        self.sequence_parallel = sequence_parallel and self.degree > 1
        in_local = _local(in_features, self.degree, "in_features")
        self.weight = self.create_parameter(
            [in_local, out_features], attr=weight_attr,
            default_initializer=I.XavierNormal(), generator=generator)
        _mark(self.weight, 0 if self.degree > 1 else None)
        if has_bias:
            self.bias = self.create_parameter(
                [out_features], attr=None, is_bias=True, generator=generator)
            _mark(self.bias, None)
            self.bias.sequence_parallel = self.sequence_parallel
        else:
            self.bias = None

    def forward(self, x):
        if self.degree <= 1:
            return F.linear(x, self.weight, self.bias)
        if not self.input_is_parallel:
            x = _apply(_ScatterLast, x, self.group)
        with _lowp.shard_groups(a=self.group, b=self.group):
            out = F.linear(x, self.weight)
        out = reduce_scatter_seq(out, self.group) if self.sequence_parallel \
            else reduce_from_mp(out, self.group)
        if self.bias is not None:
            out = amp.binary("elementwise_add", out, self.bias)
        return out


class _VocabParallelCE(torch.autograd.Function):
    """Softmax cross entropy over logits whose classes are split over
    mp: the max, the sum of exponentials and the target's logit are
    all-reduced; rows labelled `ignore_index` give 0."""

    @staticmethod
    def forward(ctx, logits, label, group, start, ignore_index):
        x = logits.float()
        gmax = x.amax(dim=-1, keepdim=True)
        all_reduce(gmax, ReduceOp.MAX, group=group)
        shifted = x - gmax
        e = torch.exp(shifted)
        sumexp = e.sum(dim=-1, keepdim=True)
        all_reduce(sumexp, group=group)
        n = x.shape[-1]
        local = label.long() - start
        inside = (local >= 0) & (local < n)
        idx = local.clamp(0, n - 1).unsqueeze(-1)
        target = torch.gather(shifted, -1, idx) * inside.unsqueeze(-1)
        all_reduce(target, group=group)
        valid = (label.long() != ignore_index).unsqueeze(-1)
        loss = (torch.log(sumexp) - target) * valid
        ctx.save_for_backward(e / sumexp, idx, inside, valid)
        ctx.in_dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        softmax, idx, inside, valid = ctx.saved_tensors
        grad = softmax.clone()
        grad.scatter_add_(-1, idx, -inside.unsqueeze(-1).to(grad.dtype))
        grad = grad * (g * valid)
        return grad.to(ctx.in_dtype), None, None, None, None


class ParallelCrossEntropy(Layer):
    """Cross entropy over vocab-split logits ``[..., V / mp]``; returns
    the per-token loss ``[..., 1]`` (0 where the label is
    `ignore_index`), as the reference's ``softmax_with_cross_entropy``."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.group, self.rank, self.degree = mp_group_of(mp_group)
        self.ignore_index = ignore_index

    def forward(self, input, label):
        if label.dim() == input.dim():
            label = label.squeeze(-1)
        if self.degree <= 1:
            return F.softmax_with_cross_entropy(
                input, label, ignore_index=self.ignore_index)
        (input,) = amp.cast("softmax_with_cross_entropy", input)
        start = self.rank * input.shape[-1]
        return _VocabParallelCE.apply(input, label, self.group, start,
                                      self.ignore_index)


def parallel_linear_split(x, size, operation, axis=0, num_partitions=1,
                          gather_out=True, weight_attr=None, bias_attr=None):
    """paddle.distributed.split: a row- (axis 0) or column- (axis 1)
    parallel linear, or a vocab-parallel embedding, built and applied to
    `x` (its parameters are new, as in the reference)."""
    dev = x.device
    if operation == "linear":
        if axis == 0:
            layer = RowParallelLinear(size[0], size[1], weight_attr,
                                      has_bias=bias_attr is not False)
        else:
            layer = ColumnParallelLinear(size[0], size[1], weight_attr,
                                         has_bias=bias_attr is not False,
                                         gather_output=gather_out)
        return layer.to(dev)(x)
    if operation == "embedding":
        layer = VocabParallelEmbedding(size[0], size[1], weight_attr)
        return layer.to(dev)(x)
    raise ValueError(f"unsupported split operation {operation!r}")
