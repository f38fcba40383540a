"""The port's collectives (`paddle_tpu_torch.distributed.collective`).

Four gloo ranks on the CPU (spawned once for the module through
tests/torch_dist_workers.py) run every collective on tensors made from
their rank; each result is held against the semantics the reference
gives it over a mesh axis (``paddle_tpu/distributed/collective.py``:
``psum`` / ``pmax`` / ``pmin`` / ``pmean``, ``all_gather`` in rank
order, ``psum_scatter`` of the stacked list, ``all_to_all`` over dim 0,
one-to-all broadcast; `reduce` leaves the result everywhere), computed
here with numpy. Without a process group every call is the identity,
as the reference's at world size 1, which runs beside the port's on the
same values.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed as JD

import paddle_tpu_torch.distributed as TD
from paddle_tpu_torch.distributed import collective as TC

from torch_dist_workers import run_ranks

N = 4


def _base(rank):
    return np.arange(6, dtype=np.float32).reshape(2, 3) + 10.0 * rank


_RNG = np.random.RandomState(4)
DP_W = _RNG.randn(3, 2).astype(np.float32)
DP_B = _RNG.randn(2).astype(np.float32)
DP_X = _RNG.randn(2 * N, 3).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(N, "collectives", (DP_W, DP_B, DP_X),
                     str(tmp_path_factory.mktemp("collectives")))


_REDUCE = {"SUM": np.sum, "MAX": np.max, "MIN": np.min, "PROD": np.prod,
           "AVG": np.mean}


@pytest.mark.parametrize("op", sorted(_REDUCE))
def test_all_reduce(op, ranks):
    want = _REDUCE[op](np.stack([_base(r) + 1.0 for r in range(N)]), axis=0)
    for res in ranks:
        np.testing.assert_allclose(res[f"all_reduce_{op}"], want, rtol=1e-6)


def test_all_gather_in_rank_order(ranks):
    for res in ranks:
        assert len(res["all_gather"]) == N
        for r, got in enumerate(res["all_gather"]):
            np.testing.assert_array_equal(got, _base(r))
        assert res["all_gather_object"] == [{"rank": r} for r in range(N)]
        np.testing.assert_array_equal(
            res["split"], np.concatenate([_base(r) for r in range(N)], 1))


def test_broadcast_and_reduce(ranks):
    total = sum(_base(r) for r in range(N))
    for res in ranks:
        np.testing.assert_array_equal(res["broadcast"], _base(2))
        np.testing.assert_array_equal(res["reduce"], total)


def test_reduce_scatter_and_scatter(ranks):
    for me, res in enumerate(ranks):
        want = sum(_base(r) * (me + 1) for r in range(N))
        np.testing.assert_array_equal(res["reduce_scatter"], want)
        np.testing.assert_array_equal(res["scatter"],
                                      _base(3) + 100.0 * me)


def test_alltoall(ranks):
    for me, res in enumerate(ranks):
        assert len(res["alltoall"]) == N
        for src, got in enumerate(res["alltoall"]):
            np.testing.assert_array_equal(got, _base(src) + 100.0 * me)


def test_send_recv_subgroup_and_no_staging_on_the_cpu(ranks):
    for me, res in enumerate(ranks):
        want = _base(me - 1) if me % 2 else np.zeros((2, 3), np.float32)
        np.testing.assert_array_equal(res["send_recv"], want)
        grank, gsize, got = res["subgroup"]
        if me in (0, 2):
            assert (grank, gsize) == (me // 2, 2)
            np.testing.assert_array_equal(got, _base(0) + _base(2))
        else:
            assert (grank, gsize) == (-1, 2)
            np.testing.assert_array_equal(got, _base(me))
        # CPU tensors on a gloo group never cross a host copy
        assert res["staged"] == {"d2h": 0, "h2d": 0}


_WORLD1 = {
    "all_reduce": lambda D, t, ts: D.all_reduce(t),
    "broadcast": lambda D, t, ts: D.broadcast(t, src=0),
    "reduce": lambda D, t, ts: D.reduce(t, dst=0),
    "all_gather": lambda D, t, ts: D.all_gather([], t),
    "reduce_scatter": lambda D, t, ts: D.reduce_scatter(t, ts),
    "scatter": lambda D, t, ts: D.scatter(t, ts, src=0),
    "alltoall": lambda D, t, ts: D.alltoall(ts, []),
}


def _np(x):
    if isinstance(x, list):
        return [_np(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x.numpy())


@pytest.mark.parametrize("name", sorted(_WORLD1))
def test_world_of_one_is_the_identity_as_in_the_reference(name):
    """No process group: the call returns what the reference's does at
    world size 1 on the same values."""
    fn = _WORLD1[name]
    x = _base(0)
    xs = [_base(1) + 5.0]
    want = _np(fn(JD, paddle.to_tensor(x), [paddle.to_tensor(v)
                                            for v in xs]))
    got = _np(fn(TD, torch.tensor(x), [torch.tensor(v) for v in xs]))
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_array_equal(got, want)
    assert TC.get_group().pg is None


def test_data_parallel_averages_the_gradients_over_dp(ranks):
    """Each rank's rows, the gradients averaged over dp: the gradient of
    the mean loss over the global batch, as the reference's Linear gives
    it on the whole batch; one SGD step of the distributed optimizer
    then leaves every rank with the same parameters."""
    from paddle_tpu import nn as jnn

    lin = jnn.Linear(3, 2)
    lin.set_state_dict({"weight": paddle.to_tensor(DP_W),
                        "bias": paddle.to_tensor(DP_B)})
    y = lin(paddle.to_tensor(DP_X))
    (y * y).mean().backward()
    want = {k: np.asarray(p.grad.numpy()) for k, p in lin.named_parameters()}
    for res in ranks:
        for k, g in want.items():
            np.testing.assert_allclose(res["dp_grads"][k], g, rtol=1e-5,
                                       atol=1e-7)
            np.testing.assert_allclose(
                res["dp_after"][k],
                {"weight": DP_W, "bias": DP_B}[k] - 0.1 * g, rtol=1e-5,
                atol=1e-7)


def test_topology_matches_the_reference():
    """The grid, its coordinates and comm lists are the reference's."""
    from paddle_tpu.distributed.topology import CommunicateTopology as JT

    from paddle_tpu_torch.distributed.topology import CommunicateTopology

    dims = (2, 2, 1, 2)
    names = ("data", "pipe", "sharding", "model")
    jt, tt = JT(names, dims), CommunicateTopology(names, dims)
    assert tt.world_size() == jt.world_size() == 8
    for r in range(8):
        assert tuple(tt.get_coord(r)) == tuple(jt.get_coord(r))
    for name in names:
        assert tt.get_comm_list(name) == jt.get_comm_list(name)
        assert tt.get_axis_list(name, 0) == jt.get_axis_list(name, 0)
