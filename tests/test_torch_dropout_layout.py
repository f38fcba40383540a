"""Layout-free dropout under a mesh (`framework.random.DropoutLayout`).

The reference's GSPMD masks depend on the seed and the element, not on
how the batch, the heads or the sequence are laid out over devices. The
port's meshed engines hash every element's global coordinates instead of
drawing from a per-rank stream:

* the plain keep hash of flash attention with a batch-head offset
  (``bh_offset=(b0, h0, heads)``) is the matching slice of the whole
  batch's mask, and without one it is the kernels' own bh (the
  attention kernels' hash with offset 0 is unchanged);
* a hidden dropout's mask of a rank's rows or of its sequence-parallel
  chunk is the slice of the whole tensor's mask, and sites differ;
* two gloo ranks (spawned once for the module through
  tests/torch_dist_workers.py) train the narrow ERNIE at dropout and
  attention dropout 0.1: the hybrid engine at dp2, mp2 with sequence
  parallelism, pp2 (4 micro-batches) and sharding2 under ZeRO 2, and
  the meshed `Engine` at dp2 and mp2 with sequence parallelism, each
  within rtol 1e-5 of the same engine at world size 1, every
  parameter's change within 1e-3 of the largest element of world size
  1's change (a rank-local mask reads ~0.1-1 there), and every
  trajectory away from the dropout-free one.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from paddle_tpu_torch.framework import random as trandom  # noqa: E402
from paddle_tpu_torch.ops import fused_ops as tfo  # noqa: E402

from test_torch_ernie_parallel import (  # noqa: E402
    DELTA_TOL, _batch, _master, delta_errs, reference_run,
)
from torch_dist_workers import run_ranks  # noqa: E402

P = 0.1
STEPS = 2
GRIDS = [("hybrid.w1", (1, 1, 1, 1, 0, False), True),
         ("hybrid.dp2", (2, 1, 1, 1, 0, False), True),
         ("hybrid.mp2.seqpar", (1, 2, 1, 1, 0, True), True),
         ("hybrid.pp2", (1, 1, 2, 1, 0, False), True),
         ("hybrid.sharding2.z2", (1, 1, 1, 2, 2, False), True),
         ("engine.w1", (1, 1, 1, 1, 0, False), False),
         ("engine.dp2", (2, 1, 1, 1, 0, False), False),
         ("engine.mp2.seqpar", (1, 2, 1, 1, 0, True), False)]


@pytest.mark.parametrize("b0,h0,b,h", [(0, 0, 4, 6), (1, 0, 2, 6),
                                       (0, 3, 4, 3), (2, 2, 2, 2)])
def test_keep_hash_with_a_bh_offset_is_a_slice_of_the_whole_mask(b0, h0, b,
                                                                 h):
    B, H, sq, sk = 4, 6, 5, 7
    seed = torch.tensor(1234567)
    whole = tfo._keep_mask(seed, B * H, sq, sk, P, H).reshape(B, H, sq, sk)
    part = tfo._keep_mask(seed, b * h, sq, sk, P, h, (b0, h0, H))
    np.testing.assert_array_equal(
        part.reshape(b, h, sq, sk).numpy(),
        whole[b0:b0 + b, h0:h0 + h].numpy())


def test_keep_hash_without_an_offset_is_the_kernels_bh():
    """heads and a zero offset leave the hash of (bh, q, k) as it was:
    the offset form (b0 + b) * H + h0 + h is bh itself."""
    seed = torch.tensor(99)
    plain = tfo._keep_hash(seed, 12, 9, 11)
    for heads in (1, 3, 12):
        np.testing.assert_array_equal(
            tfo._keep_hash(seed, 12, 9, 11, heads, (0, 0, heads)).numpy(),
            plain.numpy())


def test_flash_attention_on_a_slice_drops_the_slice_of_the_whole():
    rng = np.random.RandomState(0)
    q, k, v = (torch.tensor(rng.randn(4, 6, 8, 32).astype(np.float32))
               for _ in range(3))
    seed = torch.tensor(77)
    whole = tfo.flash_attention(q, k, v, seed, dropout_p=P)
    part = tfo.flash_attention(q[1:3, 2:5], k[1:3, 2:5], v[1:3, 2:5], seed,
                               dropout_p=P, bh_offset=(1, 2, 6))
    np.testing.assert_allclose(part.numpy(), whole[1:3, 2:5].numpy(),
                               rtol=1e-6, atol=1e-6)
    off = tfo.flash_attention(q[1:3, 2:5], k[1:3, 2:5], v[1:3, 2:5], seed,
                              dropout_p=P)
    assert not np.allclose(off.numpy(), whole[1:3, 2:5].numpy())


def test_hidden_keep_of_a_rank_is_a_slice_of_the_whole():
    """Rows r0.. of the batch and chunk c of the sequence under mp2:
    the slice of one device's mask at the same site; the next site
    another mask."""
    step = torch.tensor(4242)
    x = torch.zeros(6, 8, 10)
    thresh = tfo._thresh(P)
    whole = trandom.DropoutLayout(step, seq_len=8).hidden_keep(x, thresh)
    for r0, chunk in ((0, 0), (2, 1), (3, 0)):
        lay = trandom.DropoutLayout(step, row0=r0, seq_len=8,
                                    mp_rank=chunk, mp_degree=2)
        got = lay.hidden_keep(x[:3, :4], thresh)
        np.testing.assert_array_equal(
            got.numpy(), whole[r0:r0 + 3, chunk * 4:(chunk + 1) * 4].numpy())
    lay = trandom.DropoutLayout(step, seq_len=8)
    first = lay.hidden_keep(x, thresh)
    second = lay.hidden_keep(x, thresh)
    np.testing.assert_array_equal(first.numpy(), whole.numpy())
    assert not torch.equal(first, second)
    lay.enter(0)
    np.testing.assert_array_equal(lay.hidden_keep(x, thresh).numpy(),
                                  whole.numpy())
    assert 0.85 < float(whole.float().mean()) < 0.95


@pytest.fixture(scope="module")
def master():
    return _master()


@pytest.fixture(scope="module")
def ranks(master, tmp_path_factory):
    ids, labels = _batch()
    return run_ranks(2, "dropout_layout",
                     (master, ids, labels, GRIDS, STEPS, P),
                     str(tmp_path_factory.mktemp("dropout")))


@pytest.mark.parametrize("grid", [g for g in GRIDS if "w1" not in g[0]],
                         ids=[g[0] for g in GRIDS if "w1" not in g[0]])
def test_factorization_at_dropout_repeats_world_one(grid, master, ranks):
    name = grid[0]
    w1 = name.split(".")[0] + ".w1"
    res = ranks[0]
    np.testing.assert_allclose(res["losses"][name], res["losses"][w1],
                               rtol=1e-5, err_msg=name)
    errs = delta_errs(res["params"][name], res["params"][w1], master)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= DELTA_TOL, (name, worst, errs[worst])


def test_dropout_moves_the_trajectory(master, ranks):
    ids, labels = _batch()
    free, _ = reference_run(master, STEPS, ids, labels)
    for name in ("hybrid.w1", "engine.w1"):
        got = ranks[0]["losses"][name]
        assert abs(got[0] - free[0]) > 1e-3 * abs(free[0]), (name, got, free)
