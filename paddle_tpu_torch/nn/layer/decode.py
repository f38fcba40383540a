"""Seq2seq decoding (ref paddle_tpu/nn/layer/decode.py):
`BeamSearchDecoder` and `dynamic_decode`.

The decode loop runs up to `max_step_num` steps with static [B, W] beam
shapes (a finished beam extends only with the end token, at probability
1) and stops once every beam has finished; the final sequences are
re-threaded through `ops.extra_ops.gather_tree`.
"""

from __future__ import annotations

import torch

from ...ops import extra_ops

__all__ = ["BeamSearchDecoder", "dynamic_decode"]

_NEG_INF = -1e9


def _tree_map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    return fn(tree)


def _first_leaf(tree):
    return _first_leaf(tree[0]) if isinstance(tree, (tuple, list)) else tree


class BeamSearchDecoder:
    """Beam search over `cell(step_input [B W, ...], states) -> (output,
    new states)`; `output_fn` maps the output to vocab logits (or it is
    already logits) and `embedding_fn` maps token ids to step inputs."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """[B, ...] -> [B W, ...], each batch item repeated W times."""
        return x.repeat_interleave(beam_size, dim=0)

    def decode(self, initial_states, max_step_num):
        """(ids [B, T, W], scores [B, W]), beams best first."""
        W = self.beam_size
        first = _first_leaf(initial_states)
        B, dev = first.shape[0], first.device
        states = _tree_map(lambda s: s.repeat_interleave(W, dim=0),
                           initial_states)
        tokens = torch.full((B * W,), self.start_token, dtype=torch.long,
                            device=dev)
        # beam 0 starts live, the others muted, so step 1 picks W
        # distinct continuations of the one start hypothesis
        log_probs = torch.tensor([0.0] + [_NEG_INF] * (W - 1),
                                 device=dev).repeat(B)
        finished = torch.zeros((B * W,), dtype=torch.bool, device=dev)
        step_ids, step_parents = [], []
        for _ in range(max_step_num):
            inp = self.embedding_fn(tokens) if self.embedding_fn is not None \
                else tokens
            out, states = self.cell(inp, states)
            logits = self.output_fn(out) if self.output_fn is not None \
                else out
            logp = torch.log_softmax(logits.float(), dim=-1)
            V = logp.shape[-1]
            fin_row = torch.full((V,), _NEG_INF, device=dev)
            fin_row[self.end_token] = 0.0
            logp = torch.where(finished[:, None], fin_row[None, :], logp)
            scores = (log_probs[:, None] + logp).reshape(B, W * V)
            top_scores, top_idx = torch.topk(scores, W, dim=-1)
            parent = top_idx // V
            token = top_idx % V
            flat_parent = (parent + (torch.arange(B, device=dev) * W)[:, None]
                           ).reshape(-1)
            states = _tree_map(lambda s: s[flat_parent], states)
            log_probs = top_scores.reshape(-1)
            tokens = token.reshape(-1)
            finished = finished[flat_parent] | (tokens == self.end_token)
            step_ids.append(token)
            step_parents.append(parent)
            if bool(finished.all()):
                break
        full = extra_ops.gather_tree(torch.stack(step_ids),
                                     torch.stack(step_parents))
        return full.permute(1, 0, 2), log_probs.reshape(B, W)


def dynamic_decode(decoder, inits=None, max_step_num=100, **kwargs):
    """Drive `decoder` to completion: (ids [B, T, W], scores [B, W])."""
    if not isinstance(decoder, BeamSearchDecoder):
        raise TypeError("dynamic_decode drives a BeamSearchDecoder")
    return decoder.decode(inits, max_step_num)
