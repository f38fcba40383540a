"""Collective communication (counterpart of
paddle_tpu/distributed/collective.py).

Each `Group` wraps a ``torch.distributed`` process group and records its
backend. On an NCCL group CUDA tensors go to NCCL as they are. On a gloo
group (the CPU, or several ranks sharing one card) a CUDA tensor is
staged through host memory, and only by `_staged`, which counts the
bytes it moves each way (`staged_bytes`): the price of running several
ranks on one card, not a figure of NCCL.

Without a process group (a world of one that never opened one) every
call is the identity, as in the reference. A group of one rank gets no
torch group and is the identity too; every rank builds every group in
the same order, so none waits on a group the others skip.

The calls are synchronous; ``sync_op`` / ``use_calc_stream`` are taken
for the reference's signatures. `reduce` leaves the result on every
rank, as the reference's (``collective.py:243``) does.

`all_reduce` and `barrier` are deadline-scoped, as the reference's
eager ones: each passes `gang.deadline_guard` (the ``dist.allreduce`` /
``dist.barrier`` fault sites) and runs its transport under
`gang.call_with_deadline` (FLAGS_dist_timeout_s), so a peer that died
mid-collective becomes a typed retriable `gang.CollectiveTimeoutError`
(the deadline expired) or `gang.PeerGoneError` (the transport reported
the connection closed), never a hang. The transport then runs on a
worker thread, on the caller's card.
"""

from __future__ import annotations

import threading

import torch
import torch.distributed as dist

from .parallel import get_rank, get_world_size

__all__ = ["ReduceOp", "Group", "new_group", "get_group", "all_reduce",
           "all_gather", "all_gather_object", "broadcast", "reduce",
           "reduce_scatter", "scatter", "alltoall", "send", "recv",
           "barrier", "wait", "split", "staged_bytes",
           "reset_staged_bytes"]

_default_group = None
_groups = {}
_group_counter = 0

_staged_lock = threading.Lock()
_staged_count = {"d2h": 0, "h2d": 0}


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX:
              dist.ReduceOp.MAX, ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PROD: dist.ReduceOp.PRODUCT,
              ReduceOp.AVG: dist.ReduceOp.SUM}


class Group:
    """A set of ranks, its ``torch.distributed`` group (`pg`; None when
    the call is the identity) and the mesh axis it runs along."""

    def __init__(self, rank, nranks, id=0, ranks=None, axis_name=None,
                 pg=None):
        self.rank = rank
        self.nranks = nranks
        self.id = id
        self.ranks = list(ranks) if ranks is not None else \
            list(range(nranks))
        self.axis_name = axis_name
        self.pg = pg
        self.backend = dist.get_backend(pg) if pg is not None else None

    @property
    def world_size(self):
        return self.nranks

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    def __repr__(self):
        return (f"Group(rank={self.rank}, nranks={self.nranks}, "
                f"id={self.id}, axis={self.axis_name}, "
                f"backend={self.backend})")


def _get_default_group():
    global _default_group
    if _default_group is None:
        pg = dist.group.WORLD if dist.is_initialized() else None
        _default_group = Group(get_rank(), max(get_world_size(), 1), 0,
                               pg=pg)
    return _default_group


def _reset_default_group():
    """Forget the default group (a new world was opened)."""
    global _default_group
    _default_group = None


def new_group(ranks=None, backend=None, axis_name=None):
    """A group of the global `ranks` (default: all). Every rank of the
    world must call it for every group, in the same order."""
    global _group_counter
    _group_counter += 1
    rank = get_rank()
    ranks = list(ranks) if ranks is not None else \
        list(range(get_world_size()))
    pg = None
    if dist.is_initialized() and len(ranks) > 1:
        pg = dist.new_group(ranks, backend=backend)
        if rank not in ranks:       # torch's NON_GROUP_MEMBER
            pg = None
    grp_rank = ranks.index(rank) if rank in ranks else -1
    g = Group(grp_rank, len(ranks), _group_counter, ranks, axis_name, pg)
    _groups[_group_counter] = g
    return g


def get_group(gid=0):
    if gid == 0:
        return _get_default_group()
    return _groups.get(gid)


def _group(group):
    return group if group is not None else _get_default_group()


# -- host staging ------------------------------------------------------------


def staged_bytes():
    """Bytes `_staged` has copied ``{"d2h": ..., "h2d": ...}`` since the
    last `reset_staged_bytes`."""
    with _staged_lock:
        return dict(_staged_count)


def reset_staged_bytes():
    with _staged_lock:
        _staged_count.update(d2h=0, h2d=0)


def _nbytes(t):
    return t.numel() * t.element_size()


def _staged(group, fn, reads=(), writes=()):
    """``fn(*reads, *writes)`` on `group`: it reads `reads` and fills
    `writes` in place (a tensor may be in both). On a gloo group CUDA
    tensors cross through host copies, counted here; anywhere else `fn`
    sees the tensors themselves."""
    if group.backend != "gloo" or not any(
            t.is_cuda for t in (*reads, *writes)):
        fn(*reads, *writes)
        return
    host = {}
    d2h = h2d = 0
    for t in reads:
        if t.is_cuda and id(t) not in host:
            host[id(t)] = t.detach().cpu()
            d2h += _nbytes(t)
    for t in writes:
        if t.is_cuda and id(t) not in host:
            host[id(t)] = torch.empty(t.shape, dtype=t.dtype)
    fn(*(host.get(id(t), t) for t in reads),
       *(host.get(id(t), t) for t in writes))
    for t in writes:
        if t.is_cuda:
            t.copy_(host[id(t)])
            h2d += _nbytes(t)
    with _staged_lock:
        _staged_count["d2h"] += d2h
        _staged_count["h2d"] += h2d


# -- collectives -----------------------------------------------------------


def _deadline(site, fn=None, tag=None):
    """`fn()` under the gang deadline of `site` (the fault site fired
    first), on the caller's card; with no `fn` (an identity collective)
    only the fault site."""
    from .gang import call_with_deadline, deadline_guard

    remaining = deadline_guard(site, tag=tag)
    if fn is None:
        return None
    if remaining is not None and torch.cuda.is_available() and \
            torch.cuda.is_initialized():
        dev, inner = torch.cuda.current_device(), fn

        def fn():
            torch.cuda.set_device(dev)
            return inner()
    return call_with_deadline(fn, remaining, site)


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True,
               tag=None):
    """Reduce `tensor` over the group, in place on every rank.
    Deadline-scoped (the module docstring); `tag` tags the
    ``dist.allreduce`` fault site."""
    g = _group(group)
    if g.pg is None:
        _deadline("dist.allreduce", tag=tag)
        return tensor
    _deadline("dist.allreduce", lambda: _staged(
        g, lambda t, _o: dist.all_reduce(t, op=_TORCH_OPS[op], group=g.pg),
        reads=[tensor], writes=[tensor]), tag)
    if op == ReduceOp.AVG:
        with torch.no_grad():
            tensor.div_(g.nranks)
    return tensor


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    """Append every rank's `tensor` to `tensor_list`, in rank order (a
    new list when `tensor_list` is None, which is returned)."""
    g = _group(group)
    out = tensor_list if tensor_list is not None else []
    if g.pg is None:
        out.append(tensor)
        return out
    parts = [torch.empty_like(tensor) for _ in range(g.nranks)]
    _staged(g, lambda t, *o: dist.all_gather(list(o), t, group=g.pg),
            reads=[tensor.contiguous()], writes=parts)
    out.extend(parts)
    return out


def all_gather_object(object_list, obj, group=None):
    """Append every rank's picklable `obj` to `object_list`."""
    g = _group(group)
    if g.pg is None:
        object_list.append(obj)
        return object_list
    got = [None] * g.nranks
    dist.all_gather_object(got, obj, group=g.pg)
    object_list.extend(got)
    return object_list


def broadcast(tensor, src, group=None, sync_op=True):
    """`tensor` of the global rank `src` onto every rank, in place."""
    g = _group(group)
    if g.pg is None:
        return tensor
    _staged(g, lambda t, _o: dist.broadcast(t, src=int(src), group=g.pg),
            reads=[tensor], writes=[tensor])
    return tensor


def reduce(tensor, dst, op=ReduceOp.SUM, group=None, sync_op=True):
    """The reference's reduce: the result lands on every rank."""
    return all_reduce(tensor, op, group, sync_op)


def reduce_scatter(tensor, tensor_list, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """`tensor` <- the reduction over ranks of their
    ``tensor_list[group rank]``."""
    g = _group(group)
    if g.pg is None:
        with torch.no_grad():
            tensor.copy_(tensor_list[0])
        return tensor
    parts = [t.contiguous() for t in tensor_list]
    _staged(g, lambda *ts: dist.reduce_scatter(
        ts[-1], list(ts[:-1]), op=_TORCH_OPS[op], group=g.pg),
        reads=parts, writes=[tensor])
    if op == ReduceOp.AVG:
        with torch.no_grad():
            tensor.div_(g.nranks)
    return tensor


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """`tensor` <- ``tensor_list[group rank]`` of the global rank
    `src`."""
    g = _group(group)
    if g.pg is None:
        if tensor_list:
            with torch.no_grad():
                tensor.copy_(tensor_list[max(g.rank, 0)])
        return tensor
    is_src = get_rank() == int(src)
    parts = [t.contiguous() for t in tensor_list] if is_src else []
    _staged(g, lambda *ts: dist.scatter(
        ts[-1], list(ts[:-1]) if is_src else None, src=int(src),
        group=g.pg), reads=parts, writes=[tensor])
    return tensor


def alltoall(in_tensor_list, out_tensor_list, group=None, sync_op=True):
    """Rank i's ``in_tensor_list[j]`` lands in rank j's output list at
    position i; the received tensors are appended to `out_tensor_list`."""
    g = _group(group)
    if g.pg is None:
        out_tensor_list.extend(in_tensor_list)
        return out_tensor_list
    ins = [t.contiguous() for t in in_tensor_list]
    outs = [torch.empty_like(t) for t in ins]
    n = len(ins)
    _staged(g, lambda *ts: dist.all_to_all(list(ts[n:]), list(ts[:n]),
                                           group=g.pg),
            reads=ins, writes=outs)
    out_tensor_list.extend(outs)
    return out_tensor_list


def send(tensor, dst=0, group=None, sync_op=True):
    """Blocking send of `tensor` to the global rank `dst`."""
    exchange(sends=[(tensor, dst)], group=group)
    return tensor


def recv(tensor, src=0, group=None, sync_op=True):
    """Blocking receive from the global rank `src` into `tensor`."""
    exchange(recvs=[(tensor, src)], group=group)
    return tensor


def exchange(sends=(), recvs=(), group=None):
    """One batch of point-to-point transfers (``batch_isend_irecv``):
    `sends` of ``(tensor, global dst)``, `recvs` of ``(tensor, global
    src)`` filled in place; returns when all have completed."""
    g = _group(group)
    if g.pg is None:
        if sends or recvs:
            raise RuntimeError("send / recv need a process group")
        return
    send_ts = [t.contiguous() for t, _ in sends]
    recv_ts = [t for t, _ in recvs]
    n = len(send_ts)

    def run(*ts):
        ops = [dist.P2POp(dist.isend, t, int(peer), group=g.pg)
               for t, (_, peer) in zip(ts[:n], sends)]
        ops += [dist.P2POp(dist.irecv, t, int(peer), group=g.pg)
                for t, (_, peer) in zip(ts[n:], recvs)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()

    _staged(g, run, reads=send_ts, writes=recv_ts)


def barrier(group=None):
    """Deadline-scoped (the module docstring)."""
    g = _group(group)
    if g.pg is None:
        _deadline("dist.barrier")
        return
    if g.backend == "nccl":
        dev = torch.cuda.current_device()
        _deadline("dist.barrier", lambda: dist.barrier(
            group=g.pg, device_ids=[dev]))
    else:
        _deadline("dist.barrier", lambda: dist.barrier(group=g.pg))


def wait(tensor, group=None, use_calc_stream=True):
    """Block the host until `tensor`'s pending work is done."""
    if isinstance(tensor, torch.Tensor) and tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()
    return tensor


# -- along a dimension (the building blocks of the TP layers) ---------------


def all_gather_cat(x, dim, group):
    """Every rank's `x` concatenated along `dim`, in rank order."""
    g = _group(group)
    if g.pg is None:
        return x
    return torch.cat(all_gather(None, x.contiguous(), g), dim=dim)


def reduce_scatter_dim(x, dim, group):
    """The sum over ranks of `x`, split evenly along `dim`; this rank's
    piece."""
    g = _group(group)
    if g.pg is None:
        return x
    parts = [p.contiguous() for p in x.chunk(g.nranks, dim=dim)]
    out = torch.empty_like(parts[0])
    return reduce_scatter(out, parts, group=g)


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """paddle.distributed.split: a Megatron TP layer applied to `x`
    (`fleet.meta_parallel.parallel_linear_split`)."""
    from .fleet.meta_parallel import parallel_linear_split

    return parallel_linear_split(x, size, operation, axis, num_partitions,
                                 gather_out, weight_attr, bias_attr)
