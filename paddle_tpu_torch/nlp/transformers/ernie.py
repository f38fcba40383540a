"""ERNIE / BERT encoder family (counterpart of
paddle_tpu/nlp/transformers/ernie.py).

``use_parallel=True`` builds the Megatron layout of
`distributed.fleet.meta_parallel`, as the reference's (``ernie.py:68-69,
104-107, 138-142``): the word table as `VocabParallelEmbedding`, the
packed q / k / v and fc1 as `ColumnParallelLinear` (a rank holds whole
heads of each of q, k and v, ``packed_heads``), out_proj and fc2 as
`RowParallelLinear`, each reading the hybrid group's model-parallel
degree when built (degree 1 without one: the dense layers under the
same names and shapes). Under mp > 1 the tied head's logits are the
rank's slice of the vocabulary, the fused LM-head loss is off (the
reference's predicate, ``:225-249``) and `ErniePretrainingCriterion`
runs on `ParallelCrossEntropy` (``:279-281``). ``sequence_parallel=True``
keeps ``s / mp`` positions a rank between the products: the embeddings'
output is split over the sequence, each column-parallel layer gathers
it, each row-parallel one reduce-scatters it, and the LayerNorms of the
blocks and of the MLM transform normalise the rank's part (their
gradients are summed over mp); the pooler reads position 0 of the
gathered sequence and the tied product gathers the sequence again, so
`ErnieModel` returns the rank's part of the sequence and the whole
pooled output. ``recompute=True`` reruns each encoder block in the
backward (`distributed.fleet.utils.recompute`, which replays the same
dropout masks). Parameter names and (at degree 1) layouts equal
``paddle_tpu.engine.state_values`` one to one, so weights cross between
the packages as numpy arrays (``paddle_tpu_torch.weights``, whose
`shard_values` / `gather_values` map them onto a rank's shards).

The MLM head is tied to ``ernie.embeddings.word_embeddings.weight``.
The head reads that table through its owner at call time and never
registers it, so the table is one parameter under one name, as in the
reference's state dict. With ``FLAGS_use_fused_lm_loss`` on (the
default, as in the reference) the head returns a `DeferredLMHead`
(hidden states and the tied table) in place of ``[b, s, V]`` logits,
and the criterion consumes it through the fused chunked-vocab loss
(`F.fused_linear_cross_entropy`: kernels B4-B6 on CUDA). With the flag
off the head is the plain tied ``matmul_v2`` and the criterion a
``cross_entropy`` over the logits.
"""

from __future__ import annotations

import torch

from ... import amp, nn, resolve_device
from ...distributed.fleet.meta_parallel import mp_layers as mpl
from ...distributed.fleet.utils.recompute import recompute
from ...distributed.sharding import batch_weight
from ...framework.flags import flag
from ...nn import functional as F
from ...ops import lowp
from ...ops.fused_loss import DeferredLMHead

__all__ = ["ErnieConfig", "ernie_config", "ErnieEmbeddings",
           "ErnieSelfAttention", "ErnieEncoderLayer", "ErniePooler",
           "ErnieModel", "ErniePretrainingHeads", "ErnieForPretraining",
           "ErniePretrainingCriterion", "ErnieForSequenceClassification",
           "DeferredLMHead", "BertConfig", "BertModel",
           "BertForPretraining", "BertPretrainingCriterion", "bert_config"]


class ErnieConfig:
    def __init__(self, vocab_size=18000, hidden_size=768, num_layers=12,
                 num_heads=12, ffn_hidden_size=3072, max_seq_len=512,
                 type_vocab_size=4, dropout=0.1, attn_dropout=0.1,
                 layer_norm_eps=1e-12, initializer_range=0.02,
                 use_parallel=False, sequence_parallel=False,
                 recompute=False):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.ffn_hidden_size = ffn_hidden_size
        self.max_seq_len = max_seq_len
        self.type_vocab_size = type_vocab_size
        self.dropout = dropout
        self.attn_dropout = attn_dropout
        self.layer_norm_eps = layer_norm_eps
        self.initializer_range = initializer_range
        self.use_parallel = use_parallel
        self.sequence_parallel = sequence_parallel
        self.recompute = recompute


_PRESETS = {
    "ernie-1.0": dict(vocab_size=18000, hidden_size=768, num_layers=12,
                      num_heads=12, ffn_hidden_size=3072),
    "bert-base": dict(vocab_size=30522, hidden_size=768, num_layers=12,
                      num_heads=12, ffn_hidden_size=3072,
                      type_vocab_size=2),
    "bert-large": dict(vocab_size=30522, hidden_size=1024, num_layers=24,
                       num_heads=16, ffn_hidden_size=4096,
                       type_vocab_size=2),
}


def ernie_config(name, **overrides):
    cfg = dict(_PRESETS[name])
    cfg.update(overrides)
    return ErnieConfig(**cfg)


def _seq_parallel(config):
    """Sequence parallelism is on: asked for, under mp > 1."""
    return bool(config.use_parallel and config.sequence_parallel and
                mpl.mp_group_of()[2] > 1)


def _mark_seq_parallel(*layers):
    """Mark the parameters of `layers`, which see only this rank's part
    of the sequence, for the gradient sum over mp."""
    for layer in layers:
        for p in layer.parameters():
            p.sequence_parallel = True


class ErnieEmbeddings(nn.Layer):
    def __init__(self, config: ErnieConfig, generator=None):
        super().__init__()
        init = nn.initializer.Normal(std=config.initializer_range)
        if config.use_parallel:
            self.word_embeddings = mpl.VocabParallelEmbedding(
                config.vocab_size, config.hidden_size, weight_attr=init,
                generator=generator)
        else:
            self.word_embeddings = nn.Embedding(
                config.vocab_size, config.hidden_size, weight_attr=init,
                generator=generator)
        self.position_embeddings = nn.Embedding(
            config.max_seq_len, config.hidden_size, weight_attr=init,
            generator=generator)
        self.token_type_embeddings = nn.Embedding(
            config.type_vocab_size, config.hidden_size, weight_attr=init,
            generator=generator)
        self.layer_norm = nn.LayerNorm(config.hidden_size,
                                       epsilon=config.layer_norm_eps)
        self.dropout = config.dropout

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[-1],
                                        device=input_ids.device)
        x = amp.binary("elementwise_add", self.word_embeddings(input_ids),
                       self.position_embeddings(position_ids))
        if token_type_ids is not None:
            x = amp.binary("elementwise_add", x,
                           self.token_type_embeddings(token_type_ids))
        x = self.layer_norm(x)
        return F.dropout(x, self.dropout, training=self.training)


class ErnieSelfAttention(nn.Layer):
    def __init__(self, config: ErnieConfig, generator=None):
        super().__init__()
        h, nh = config.hidden_size, config.num_heads
        self.num_heads = nh
        self.head_dim = h // nh
        self.attn_dropout = config.attn_dropout
        init = nn.initializer.Normal(std=config.initializer_range)
        if config.use_parallel:
            sp = config.sequence_parallel
            self.qkv_proj = mpl.ColumnParallelLinear(
                h, 3 * h, weight_attr=init, gather_output=False,
                sequence_parallel=sp, packed_heads=(3, nh),
                generator=generator)
            self.out_proj = mpl.RowParallelLinear(
                h, h, weight_attr=init, input_is_parallel=True,
                sequence_parallel=sp, generator=generator)
            self.num_heads = nh // self.qkv_proj.degree   # this rank's
        else:
            self.qkv_proj = nn.Linear(h, 3 * h, weight_attr=init,
                                      generator=generator)
            self.out_proj = nn.Linear(h, h, weight_attr=init,
                                      generator=generator)

    def forward(self, x, attn_mask=None):
        # one packed [b, s, 3, nh, d] -> [3, b, nh, s, d] permute; the
        # attention reads q, k, v through their strides. Each Tensor
        # method casts under the reference's op name (O2). The sequence
        # is whole here (gathered under sequence parallelism)
        (qkv,) = amp.cast("reshape", self.qkv_proj(x))
        b, s = qkv.shape[:2]
        h = self.num_heads * self.head_dim
        (qkv,) = amp.cast("transpose", qkv.reshape(
            b, s, 3, self.num_heads, self.head_dim))
        (qkv,) = amp.cast("unstack", qkv.permute(2, 0, 3, 1, 4))
        q, k, v = qkv.unbind(0)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.attn_dropout if self.training else 0.0,
            qkv_layout="bhsd")
        (out,) = amp.cast("reshape", out)
        return self.out_proj(out.reshape(b, s, h))


class ErnieEncoderLayer(nn.Layer):
    """Post-LN encoder block (BERT convention)."""

    def __init__(self, config: ErnieConfig, generator=None):
        super().__init__()
        init = nn.initializer.Normal(std=config.initializer_range)
        self.self_attn = ErnieSelfAttention(config, generator)
        self.norm1 = nn.LayerNorm(config.hidden_size,
                                  epsilon=config.layer_norm_eps)
        if config.use_parallel:
            sp = config.sequence_parallel
            self.fc1 = mpl.ColumnParallelLinear(
                config.hidden_size, config.ffn_hidden_size, weight_attr=init,
                gather_output=False, sequence_parallel=sp,
                generator=generator)
            self.fc2 = mpl.RowParallelLinear(
                config.ffn_hidden_size, config.hidden_size, weight_attr=init,
                input_is_parallel=True, sequence_parallel=sp,
                generator=generator)
        else:
            self.fc1 = nn.Linear(config.hidden_size, config.ffn_hidden_size,
                                 weight_attr=init, generator=generator)
            self.fc2 = nn.Linear(config.ffn_hidden_size, config.hidden_size,
                                 weight_attr=init, generator=generator)
        self.norm2 = nn.LayerNorm(config.hidden_size,
                                  epsilon=config.layer_norm_eps)
        self.dropout = config.dropout
        if _seq_parallel(config):
            _mark_seq_parallel(self.norm1, self.norm2)

    def forward(self, x, attn_mask=None):
        h = self.self_attn(x, attn_mask)
        h = F.dropout(h, self.dropout, training=self.training)
        x = self.norm1(amp.binary("elementwise_add", x, h))
        h = self.fc2(F.gelu(self.fc1(x), approximate=True))
        h = F.dropout(h, self.dropout, training=self.training)
        return self.norm2(amp.binary("elementwise_add", x, h))


class ErniePooler(nn.Layer):
    def __init__(self, config: ErnieConfig, generator=None):
        super().__init__()
        self.dense = nn.Linear(config.hidden_size, config.hidden_size,
                               generator=generator)

    def forward(self, hidden):
        (hidden,) = amp.cast("getitem", hidden)
        return F.tanh(self.dense(hidden[:, 0]))


class ErnieModel(nn.Layer):
    def __init__(self, config: ErnieConfig, generator=None):
        super().__init__()
        self.config = config
        self.embeddings = ErnieEmbeddings(config, generator)
        self.encoder = nn.LayerList(
            [ErnieEncoderLayer(config, generator)
             for _ in range(config.num_layers)])
        self.pooler = ErniePooler(config, generator)
        self.mp_group = mpl.mp_group_of()[0] if config.use_parallel \
            else None
        self.sequence_parallel = _seq_parallel(config)

    def embed(self, input_ids, token_type_ids=None, position_ids=None):
        """The embeddings' output, this rank's part of the sequence under
        sequence parallelism."""
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        if self.sequence_parallel:
            x = mpl.scatter_seq(x, self.mp_group)
        return x

    def pool(self, x):
        """The pooler's output of the encoder's output `x` (this rank's
        part of the sequence under sequence parallelism: the pooler,
        which every rank runs alike, reads position 0 of the gathered
        sequence)."""
        if self.sequence_parallel:
            x = mpl.gather_seq_replicated(x, self.mp_group)
        return self.pooler(x)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        if attention_mask is not None and attention_mask.dim() == 2:
            # [b, s] padding mask -> additive [b, 1, 1, s]
            m = attention_mask.float()
            attention_mask = (1.0 - m)[:, None, None, :] * -1e4
        x = self.embed(input_ids, token_type_ids, position_ids)
        for layer in self.encoder:
            if self.config.recompute:
                # rematerialise the block in backward: O(layers) fewer
                # saved activations for one more forward of each block
                x = recompute(layer, x, attention_mask)
            else:
                x = layer(x, attention_mask)
        return x, self.pool(x)


class ErniePretrainingHeads(nn.Layer):
    """MLM transform + tied decoder, and the NSP classifier.

    `embedding_owner` is the module whose ``.weight`` is the tied
    ``[vocab, hidden]`` table (read at call time, not registered here;
    under mp > 1 this rank's rows of it, and the logits its slice of the
    vocabulary).
    """

    def __init__(self, config: ErnieConfig, embedding_owner,
                 generator=None):
        super().__init__()
        self.transform = nn.Linear(config.hidden_size, config.hidden_size,
                                   generator=generator)
        self.layer_norm = nn.LayerNorm(config.hidden_size,
                                       epsilon=config.layer_norm_eps)
        # a plain attribute: torch would register a Module or Parameter
        self.__dict__["_tied_owner"] = embedding_owner
        self.seq_relationship = nn.Linear(config.hidden_size, 2,
                                          generator=generator)
        self.config = config
        self.mp_group = mpl.mp_group_of()[0] if config.use_parallel \
            else None
        self.sequence_parallel = _seq_parallel(config)
        if self.sequence_parallel:
            _mark_seq_parallel(self.transform, self.layer_norm)

    def _fuse_lm_loss(self):
        """The reference's plainness predicate: a tied table, no vocab
        sharding, and the flag on."""
        return (self._tied_owner is not None
                and not self.config.use_parallel
                and flag("FLAGS_use_fused_lm_loss"))

    def forward(self, sequence_output, pooled_output):
        # under sequence parallelism the transform's input is this rank's
        # part of the sequence: a low-precision route takes its abs-max
        # over the whole sequence
        with lowp.shard_groups(a=self.mp_group if self.sequence_parallel
                               else None):
            h = self.transform(sequence_output)
        h = self.layer_norm(F.gelu(h))
        if self._fuse_lm_loss():
            # the criterion takes (h, W) through the fused loss, so the
            # [b, s, V] logits are never written
            logits = DeferredLMHead(h, self._tied_owner.weight)
        else:
            # the whole sequence times this rank's rows of the table
            if self.sequence_parallel:
                h = mpl.gather_seq(h, self.mp_group)
            elif self.mp_group is not None:
                h = mpl.copy_to_mp(h, self.mp_group)
            logits = F.matmul(h, self._tied_owner.weight, transpose_y=True)
        return logits, self.seq_relationship(pooled_output)


class ErnieForPretraining(nn.Layer):
    """ERNIE with the MLM + NSP heads, built on `device` (default cuda;
    raises when no GPU is visible). Weights are drawn on the CPU from
    `generator` (torch's default generator when None), so one seed
    gives the same weights on every device."""

    def __init__(self, config: ErnieConfig, device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.ernie = ErnieModel(config, generator)
        self.cls = ErniePretrainingHeads(
            config, embedding_owner=self.ernie.embeddings.word_embeddings,
            generator=generator)
        self.to(dev)

    @property
    def device(self):
        return self.ernie.embeddings.word_embeddings.weight.device

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        seq, pooled = self.ernie(input_ids, token_type_ids, position_ids,
                                 attention_mask)
        return self.cls(seq, pooled)


class ErniePretrainingCriterion(nn.Layer):
    """MLM + NSP loss: mean cross entropy over the non-ignored MLM rows,
    plus the NSP cross entropy when its labels are given. Under
    ``use_parallel`` the MLM rows' losses come from `ParallelCrossEntropy`
    over the vocab-split logits, summed over the non-ignored rows and
    divided by their count (at least 1), as the reference's. Under a
    meshed engine the MLM mean is over the non-ignored rows of the
    global batch (`distributed.sharding.batch_weight`)."""

    def __init__(self, config: ErnieConfig = None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index
        use_parallel = config.use_parallel if config is not None else False
        self.parallel_ce = mpl.ParallelCrossEntropy(
            ignore_index=ignore_index) if use_parallel else None

    def loss_weight(self, masked_lm_labels):
        """The MLM rows that count: the weight a meshed engine totals
        over the global batch."""
        return (masked_lm_labels != self.ignore_index).float().sum()

    def forward(self, prediction_scores, seq_relationship_score,
                masked_lm_labels, next_sentence_labels=None):
        valid = self.loss_weight(masked_lm_labels)
        total, parts = batch_weight(valid)
        if isinstance(prediction_scores, DeferredLMHead):
            mlm = F.fused_linear_cross_entropy(
                prediction_scores.hidden, prediction_scores.weight,
                masked_lm_labels, ignore_index=self.ignore_index)
        elif self.parallel_ce is not None:
            loss = self.parallel_ce(prediction_scores,
                                    masked_lm_labels).squeeze(-1)
            mask = (masked_lm_labels != self.ignore_index).float()
            return self._with_nsp(
                (loss * mask).sum() * parts / total.clamp_min(1.0),
                seq_relationship_score, next_sentence_labels)
        else:
            mlm = F.cross_entropy(prediction_scores, masked_lm_labels,
                                  ignore_index=self.ignore_index)
        if parts > 1:
            # the slice's mean times its share of the global batch's rows
            mlm = mlm * (valid * parts / total.clamp_min(1.0))
        return self._with_nsp(mlm, seq_relationship_score,
                              next_sentence_labels)

    @staticmethod
    def _with_nsp(mlm, seq_relationship_score, next_sentence_labels):
        if next_sentence_labels is None:
            return mlm
        return mlm + F.cross_entropy(seq_relationship_score,
                                     next_sentence_labels)


class ErnieForSequenceClassification(nn.Layer):
    """ERNIE with a classifier on the pooled output, built on `device`
    (default cuda) from `generator`, as `ErnieForPretraining`."""

    def __init__(self, config: ErnieConfig, num_classes=2, dropout=None,
                 device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.ernie = ErnieModel(config, generator)
        self.dropout = nn.Dropout(dropout if dropout is not None
                                  else config.dropout)
        self.classifier = nn.Linear(config.hidden_size, num_classes,
                                    generator=generator)
        self.to(dev)

    @property
    def device(self):
        return self.classifier.weight.device

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        _, pooled = self.ernie(input_ids, token_type_ids, position_ids,
                               attention_mask)
        return self.classifier(self.dropout(pooled))


# Bert aliases (same architecture)
BertConfig = ErnieConfig
BertModel = ErnieModel
BertForPretraining = ErnieForPretraining
BertPretrainingCriterion = ErniePretrainingCriterion
bert_config = ernie_config
