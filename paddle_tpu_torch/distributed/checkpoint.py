"""Checkpointing for one process (counterpart of the single-process half
of paddle_tpu/distributed/checkpoint.py, with the same names,
directory contract and monitor stats).

Fault-tolerance contract:
- every save is ATOMIC: arrays + checksum manifest + metadata land in
  ``<path>.tmp`` and a single directory rename commits them, so a crash
  at any instant leaves either the previous checkpoint or the new one —
  never a valid-looking torn dir;
- every leaf carries a sha256 in ``paddle_manifest.json`` verified on
  restore (FLAGS_ckpt_verify_checksums), so silent storage corruption is
  a loud error the restore fallback can route around;
- checkpoint I/O retries with exponential backoff
  (framework.errors.retry_with_backoff) before giving up;
- `AsyncCheckpointManager` moves hashing and writing off the step
  thread: the step loop pays only the device->host copy, the background
  writer owns serialize + commit + retention.

On-disk format. The reference writes arrays with orbax; the port keeps
its own framework-neutral layout under the same directory contract:
one ``.npy`` file per leaf under ``d/`` (``numpy.load(...,
allow_pickle=False)`` reads each; a bfloat16 leaf is stored as its raw
2-byte words, uint16), ``d/index.json`` mapping each leaf's key to its
file and dtype, ``paddle_manifest.json`` and the optional
``paddle_meta.json``. Leaves are keyed as ``jax.tree_util.keystr``
keys them (``['params']['fc1.weight']``, ``['opt_state'][...][
'moment1']``; dict keys sorted, a NamedTuple's fields as ``.name``),
and each manifest entry holds the sha256 of the leaf's C-order bytes,
its shape and its dtype name (``"bfloat16"`` for bf16): for the same
values the two packages write identical manifests.

Entry points:
- save_state / load_state          — any tree (dicts, lists, tuples,
  NamedTuples) of tensors / numpy arrays
- save_train_state / load_train_state — engine.Engine (params, moments,
  buffers, step, LR scheduler, the engine's RngState and torch's
  default generators); the restore copies into the engine's own
  tensors in place
- CheckpointManager                — numbered checkpoints with retention
- AsyncCheckpointManager           — same contract, background writer
- save_hybrid_state / load_hybrid_state — HybridParallelEngine, under
  the reference's keys and global shapes
- GangCheckpointManager            — numbered checkpoints with a gang
  commit barrier and a cross-rank digest
- save_persistables / load_persistables, train_epoch_range

Meshed state is written at its logical, global shapes. The reference's
meshed state is global arrays laid onto a mesh; a rank of the port holds
slices (model-parallel shards, ZeRO slices of the moments and, at stage
3, of the parameters). So the payload of `Engine(mesh=)` gathers every
leaf over the engine's groups first, and its manifest is layout-free:
for the same values it equals world size 1's and the reference's. On
restore, `load_state(shardings=)` takes, for each leaf, the `Slice` this
rank keeps (the dimension, the rank, the degree, in order); a meshed
engine's `load_train_state` derives them from the engine's own rules
(the mp split of `mp_layers`, `sharding.zero_dim`), so a checkpoint
written on one factorization restores on another whose global shapes
match, as the reference's re-layout does.

Each path runs under the reference's ``observe.phase`` spans, which
goodput reads: ``checkpoint-restore`` (load_state),
``checkpoint-write`` (a synchronous manager's save and save_with),
``checkpoint-snapshot`` (the async manager's device->host copy on the
step thread) and ``checkpoint-write-async`` (its background write,
overlapped with training).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import time
import warnings

import numpy as np
import torch

from ..framework import faults as _faults
from ..framework import monitor as _monitor
from ..framework.errors import retry_with_backoff
from ..observe import phase as _phase

__all__ = ["MANIFEST_NAME", "META_NAME", "Slice", "leaf_digests",
           "load_manifest", "verify_manifest", "save_state", "load_state",
           "load_metadata", "save_train_state", "load_train_state",
           "save_hybrid_state", "load_hybrid_state", "CheckpointManager",
           "AsyncCheckpointManager", "GangCheckpointManager",
           "save_persistables", "load_persistables", "train_epoch_range"]

MANIFEST_NAME = "paddle_manifest.json"
META_NAME = "paddle_meta.json"
DATA_DIR = "d"
INDEX_NAME = "index.json"


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------


def _is_namedtuple(x):
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix=""):
    """[(key, leaf)] in jax.tree_util's order and keystr notation: dict
    keys sorted, ``[k!r]`` for a dict key, ``[i]`` for a list or tuple
    index, ``.name`` for a NamedTuple field; None is an empty node."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in _flatten(getattr(tree, f), f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, f"{prefix}[{i}]")]
    if tree is None:
        return []
    return [(prefix, tree)]


def _map(fn, tree, prefix=""):
    """`tree` with each leaf replaced by ``fn(key, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, f"{prefix}[{k!r}]") for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_map(fn, getattr(tree, f), f"{prefix}.{f}")
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(prefix, tree)


def _dtype_name(leaf):
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return _host(leaf)[1]


def _host(leaf):
    """(a host numpy array of the leaf's values in C order, its dtype
    name). A bfloat16 leaf comes back as its raw uint16 words; a CPU
    tensor's array shares its memory; Python scalars become 0-d arrays
    as jnp.asarray makes them (int32, float32, bool)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), _dtype_name(t)
    if isinstance(leaf, (bool, np.bool_)):
        a = np.asarray(leaf, np.bool_)
    elif isinstance(leaf, int):
        a = np.asarray(leaf, np.int32)
    elif isinstance(leaf, float):
        a = np.asarray(leaf, np.float32)
    else:
        a = np.asarray(leaf)
        if not a.flags.c_contiguous:
            a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16), "bfloat16"
    return a, a.dtype.name


def _digest(words):
    return hashlib.sha256(np.ascontiguousarray(words)).hexdigest()


# ---------------------------------------------------------------------------
# checksum manifest
# ---------------------------------------------------------------------------


def _leaf_digest(leaf):
    return _digest(_host(leaf)[0])


def _manifest_entry(words, dtype):
    return {"sha256": _digest(words), "shape": list(words.shape),
            "dtype": dtype}


def _manifest_of(state):
    """Per-leaf sha256, shape and dtype name, keyed as the reference
    keys its manifest."""
    return {k: _manifest_entry(*_host(leaf)) for k, leaf in _flatten(state)}


def leaf_digests(state):
    """Flat ``name -> sha256`` view of the manifest."""
    return {k: v["sha256"] for k, v in _manifest_of(state).items()}


def load_manifest(path):
    p = os.path.join(os.path.abspath(path), MANIFEST_NAME)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def _check_digests(path, manifest, digests):
    bad = [k for k, d in digests if k in manifest
           and d != manifest[k]["sha256"]]
    if bad:
        raise ValueError(
            f"checkpoint {path} failed checksum verification for leaves "
            f"{bad} — the data on disk does not match what was saved")


def verify_manifest(path, restored):
    """Re-hash every restored leaf against the saved manifest; raises
    ValueError on any mismatch (a truncated/corrupted leaf). Leaves
    absent from the manifest are skipped."""
    manifest = load_manifest(path)
    if manifest is None:
        return  # pre-manifest checkpoint: nothing to verify against
    _check_digests(path, manifest, [(k, _leaf_digest(leaf))
                                    for k, leaf in _flatten(restored)])


# ---------------------------------------------------------------------------
# atomic save / verified load
# ---------------------------------------------------------------------------


def save_state(path, state, *, metadata=None):
    """Write a tree of tensors / arrays to `path` (a directory),
    atomically.

    The full checkpoint (one ``.npy`` per leaf, the index, the per-leaf
    sha256 manifest, optional JSON `metadata`) is staged in
    ``<path>.tmp`` and committed by one directory rename — a crash can
    never leave a valid-looking torn dir at `path`. Scalars are stored
    as 0-d arrays. Device tensors are copied to the host here.
    """
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    leaves = [(k, *_host(leaf)) for k, leaf in _flatten(state)]
    manifest = {k: _manifest_entry(words, dtype)
                for k, words, dtype in leaves}
    tmp = path + ".tmp"

    def _stage():
        _faults.fault_point("checkpoint.io")
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(os.path.join(tmp, DATA_DIR))
        index = {}
        for i, (key, words, dtype) in enumerate(leaves):
            name = f"{i}.npy"
            np.save(os.path.join(tmp, DATA_DIR, name), words,
                    allow_pickle=False)
            index[key] = {"file": name, "dtype": dtype}
        with open(os.path.join(tmp, DATA_DIR, INDEX_NAME), "w") as f:
            json.dump(index, f)
        with open(os.path.join(tmp, MANIFEST_NAME), "w") as f:
            json.dump(manifest, f)
        if metadata is not None:
            with open(os.path.join(tmp, META_NAME), "w") as f:
                json.dump(metadata, f)

    # transient filesystem failures (NFS/fuse hiccups) retry with
    # backoff; each retry restages from scratch into the tmp dir
    retry_with_backoff(_stage, retries=3, stat="ckpt_retries",
                       description=f"checkpoint write to {path}")

    _faults.fault_point("checkpoint.before_commit")
    old = None
    if os.path.exists(path):
        # replacing an existing dir: move it aside first so there is no
        # instant where a half-deleted dir sits at the final path
        old = f"{path}.old-{os.getpid()}"
        shutil.rmtree(old, ignore_errors=True)
        os.rename(path, old)
    os.rename(tmp, path)  # THE commit point
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)
    _monitor.stat_add("ckpt_saves")
    _faults.fault_point("checkpoint.after_commit", path)


def _restored_leaf(words, dtype, like):
    """The stored words as a leaf like the template's `like`: a tensor
    on its device, else a numpy array."""
    if isinstance(like, torch.Tensor):
        if not words.flags.c_contiguous:    # a slice of a global leaf
            words = words.copy()
        if dtype == "bfloat16":
            t = torch.from_numpy(words.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(words)
        return t.to(like.device)
    return words


class Slice:
    """The part of a global leaf a rank keeps: along `dim`, piece `rank`
    of `degree` (with `packs` > 1 the dimension is laid out as ``[packs,
    ...]`` and the rank takes its piece of each pack, as a packed q / k
    / v projection splits its heads). `then` adds a further slice of the
    result (ZeRO's of an mp shard)."""

    def __init__(self, dim, rank, degree, packs=1):
        self.steps = ((int(dim), int(rank), int(degree), int(packs)),)

    def then(self, dim, rank, degree, packs=1):
        out = Slice(dim, rank, degree, packs)
        out.steps = self.steps + out.steps
        return out

    def apply(self, a):
        """This rank's part of the array `a`."""
        from ..weights import shard_array

        for dim, rank, degree, packs in self.steps:
            if degree > 1:
                a = shard_array(a, dim, rank, degree, packs)
        return a

    def __repr__(self):
        return "Slice(" + " -> ".join(
            f"dim {d}: {r}/{n}" + (f" x{p}" if p > 1 else "")
            for d, r, n, p in self.steps) + ")"


def _read(path, keys, verify=None):
    """``{key: (global words, dtype name)}`` of the leaves `keys` of the
    checkpoint at `path`, each verified against the manifest before
    anything is returned (`verify`: default the
    FLAGS_ckpt_verify_checksums flag)."""
    from ..framework import flags as _flags

    with open(os.path.join(path, DATA_DIR, INDEX_NAME)) as f:
        index = json.load(f)
    read = {}
    for key in keys:
        if key not in index:
            raise KeyError(f"checkpoint {path} holds no leaf {key}")
        ent = index[key]
        read[key] = (np.load(os.path.join(path, DATA_DIR, ent["file"]),
                             allow_pickle=False), ent["dtype"])
    if verify is None:
        verify = _flags.flag("FLAGS_ckpt_verify_checksums")
    if verify:
        manifest = load_manifest(path)
        if manifest is not None:
            _check_digests(path, manifest,
                           [(k, _digest(w)) for k, (w, _) in read.items()])
    return read


def load_state(path, template, *, shardings=None, verify=None):
    """Restore a tree saved by save_state.

    `template` supplies the structure and each leaf's shape, dtype and
    device (tensors come back on the template leaf's device, other
    leaves as numpy arrays); a missing leaf or a shape or dtype that
    differs raises. `shardings` (the template's structure; a `Slice` or
    None at each leaf) gives the part of each stored global leaf this
    rank keeps: restoring a checkpoint written on a different topology
    works as long as global shapes match. When `verify` (default: the
    FLAGS_ckpt_verify_checksums flag), every leaf read is re-hashed
    against the saved manifest before anything is returned and a
    mismatch raises ValueError.
    """
    path = os.path.abspath(path)
    with _phase("checkpoint-restore", cat="checkpoint"):
        slices = dict(_flatten(shardings)) if shardings is not None else {}
        leaves = _flatten(template)
        read = _read(path, [k for k, _ in leaves], verify)
        for key, like in leaves:
            words, dtype = read[key]
            if key in slices:
                words = slices[key].apply(words)
            shape = tuple(like.shape) if hasattr(like, "shape") else ()
            if tuple(words.shape) != shape or dtype != _dtype_name(like):
                raise ValueError(
                    f"checkpoint {path}: leaf {key} is {dtype}"
                    f"{list(words.shape)}"
                    + (f" ({slices[key]})" if key in slices else "")
                    + f", the template wants {_dtype_name(like)}"
                    f"{list(shape)}")
            read[key] = (words, dtype)
        return _map(lambda k, like: _restored_leaf(*read[k], like), template)


def load_metadata(path):
    p = os.path.join(os.path.abspath(path), META_NAME)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# Engine state
# ---------------------------------------------------------------------------


def _state_hex(state):
    return state.numpy().tobytes().hex()


def _hex_state(text):
    return torch.frombuffer(bytearray.fromhex(text), dtype=torch.uint8)


def _rng_metadata():
    """torch's default generators (the reference's default_generator):
    the CPU one, and the current card's once CUDA is in use."""
    meta = {"torch_rng": _state_hex(torch.get_rng_state())}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        meta["torch_cuda_rng"] = _state_hex(torch.cuda.get_rng_state())
    return meta


def _restore_rng(meta):
    if meta and "torch_rng" in meta:
        torch.set_rng_state(_hex_state(meta["torch_rng"]))
    if meta and "torch_cuda_rng" in meta and torch.cuda.is_available():
        torch.cuda.set_rng_state(_hex_state(meta["torch_cuda_rng"]))


def _scheduler(optimizer):
    from ..optimizer.lr import LRScheduler

    lr = getattr(optimizer, "_learning_rate", None)
    return lr if isinstance(lr, LRScheduler) else None


def _engine_metadata(engine, step):
    """The metadata that resumes an engine exactly: its step, torch's
    default generators, the engine's own RngState and the LR
    scheduler's position."""
    meta = {"step": int(step), **_rng_metadata(),
            "engine_rng": engine.rng.state_dict()}
    sched = _scheduler(engine.optimizer)
    if sched is not None:
        meta["lr_scheduler"] = sched.state_dict()
    return meta


def _restore_streams(meta, engine):
    """The random streams and the LR scheduler of `_engine_metadata`."""
    _restore_rng(meta)
    if "engine_rng" in meta:
        engine.rng.set_state_dict(meta["engine_rng"])
    sched = _scheduler(engine.optimizer)
    if sched is not None and "lr_scheduler" in meta:
        sched.set_state_dict(meta["lr_scheduler"])


def _mp_join(t, like, hcg):
    """`t`, a rank's piece of a leaf that model parallelism splits as it
    splits `like` (a parameter with ``split_axis`` / ``packed_heads``),
    joined over the mp group into the global leaf (a collective of the
    mp group); `t` itself when nothing splits it."""
    from ..weights import _split_of
    from .collective import all_gather

    axis, packs = _split_of(like)
    group = hcg.get_model_parallel_group()
    if axis is None or group is None or group.pg is None:
        return t
    pieces = [x.movedim(axis, 0) for x in
              all_gather(None, t.contiguous(), group=group)]
    per = pieces[0].shape[0] // packs
    stacked = torch.stack([x.reshape((packs, per) + tuple(x.shape[1:]))
                           for x in pieces], dim=1)
    return stacked.reshape((-1,) + tuple(pieces[0].shape[1:])).movedim(
        0, axis)


def _zero_join(t, k, zero, device):
    """`t`, this rank's ZeRO slice of leaf `k` (a parameter's shard or a
    moment), gathered over the ZeRO group (a collective of it)."""
    from .collective import all_gather_cat

    d = zero.dims.get(k)
    if d is None or zero.degree <= 1 or t.dim() == 0:
        return t
    return all_gather_cat(t.to(device).contiguous(), d, zero.group)


def _global_state(engine):
    """The meshed engine's params, moments and buffers at their logical,
    global shapes (collectives of the engine's groups: every rank calls
    it, in the same order)."""
    st, zero, hcg, dev = engine.state, engine._zero, engine.hcg, \
        engine.device
    params = {}
    for k, p in st.params.items():
        t = _zero_join(zero.shards[k], k, zero, dev) \
            if k in zero.shards else p.detach()
        params[k] = _mp_join(t, p, hcg)
    opt_state = {
        k: {n: _mp_join(_zero_join(v, k, zero, dev), st.params[k], hcg)
            if isinstance(v, torch.Tensor) and v.dim() else v
            for n, v in s.items()}
        for k, s in st.opt_state.items()}
    buffers = {k: _mp_join(b.detach(), b, hcg)
               if isinstance(b, torch.Tensor) and b.dim() else b
               for k, b in st.buffers.items()}
    return {"params": params, "opt_state": opt_state, "buffers": buffers}


def _engine_payload(engine):
    """(state tree, metadata) capturing an engine.Engine with full
    resume fidelity: params, optimizer moments, buffers, step count,
    LR-scheduler position, the engine's own RngState and torch's
    default generators (in the metadata, so the payload's keys match
    the reference's). A meshed engine's leaves are gathered to their
    global shapes (a collective: every rank calls it)."""
    st = engine.state
    meta = _engine_metadata(engine, st.step)
    if engine.hcg is not None:
        return _global_state(engine), meta
    state = {"params": st.params, "opt_state": st.opt_state,
             "buffers": st.buffers}
    return state, meta


def save_train_state(path, engine):
    """Checkpoint an engine.Engine: params, optimizer moments, buffers,
    step count, LR-scheduler position, and the random streams (a meshed
    engine's at global shapes; every rank calls it)."""
    state, meta = _engine_payload(engine)
    save_state(path, state, metadata=meta)


def _rank_slice(like, k, zero, hcg, zeroed):
    """The `Slice` of a global leaf this rank keeps (None: all of it):
    the mp split of its parameter `like` (``split_axis`` /
    ``packed_heads``), then, when `zeroed`, leaf `k`'s ZeRO slice
    (`sharding.zero_dim`'s dimension) where the engine keeps one."""
    from ..weights import _split_of

    axis, packs = _split_of(like)
    mp = hcg.get_model_parallel_world_size()
    out = Slice(axis, hcg.get_model_parallel_rank(), mp, packs) \
        if axis is not None and mp > 1 else None
    d = zero.dims.get(k) if zeroed else None
    if d is not None and zero.degree > 1:
        out = out.then(d, zero.rank, zero.degree) if out else \
            Slice(d, zero.rank, zero.degree)
    return out


def _engine_shardings(engine):
    """The `Slice` of each leaf of a meshed engine's global payload that
    this rank keeps (None without a mesh)."""
    if engine.hcg is None:
        return None
    st, zero, hcg = engine.state, engine._zero, engine.hcg
    return {
        "params": {k: _rank_slice(p, k, zero, hcg, k in zero.shards)
                   for k, p in st.params.items()},
        "opt_state": {k: {n: _rank_slice(st.params[k], k, zero, hcg, True)
                          if isinstance(v, torch.Tensor) and v.dim()
                          else None for n, v in s.items()}
                      for k, s in st.opt_state.items()},
        "buffers": {k: _rank_slice(b, k, zero, hcg, False)
                    if isinstance(b, torch.Tensor) and b.dim() else None
                    for k, b in st.buffers.items()},
    }


def load_train_state(path, engine):
    """Restore an engine.Engine in place. The parameters are the layer's
    own and the forward updates model buffers (BN running stats) in
    place, so every restored value is copied into the engine's existing
    tensor; the engine's reserved scalars (loss scale, anomaly counter,
    grad norm, ScaleState) are rebound to fresh tensors instead, so that
    no flight-recorder record that holds the old ones changes. A meshed
    engine keeps its slice of each global leaf (`_engine_shardings`),
    whatever factorization wrote it; under ZeRO-3 the parameters' slices
    are restored and gathered at the next step. Nothing is touched until
    every leaf has been read and verified."""
    from ..engine import _RESERVED

    # validate metadata BEFORE mutating the engine so a failed load leaves
    # the caller free to fall back to fresh training
    meta = load_metadata(path)
    if meta is None:
        raise FileNotFoundError(
            f"checkpoint {path} has no {META_NAME} — it was written "
            "by an interrupted save and cannot be resumed exactly")
    st = engine.state
    shards = engine._zero.shards if engine.hcg is not None else {}
    params = {k: shards.get(k, p) for k, p in st.params.items()}
    tpl = {"params": params, "opt_state": st.opt_state,
           "buffers": st.buffers}
    restored = load_state(path, tpl, shardings=_engine_shardings(engine))
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(restored["params"][k])
        for k, s in st.opt_state.items():
            for n, t in s.items():
                t.copy_(restored["opt_state"][k][n])
        for k, b in list(st.buffers.items()):
            if k in _RESERVED:
                st.buffers[k] = restored["buffers"][k]
            else:
                b.copy_(restored["buffers"][k])
    # 'engine_step' is the legacy auto-checkpoint key for the same value
    st.step = int(meta.get("step", meta.get("engine_step", 0)))
    _restore_streams(meta, engine)
    return engine


# ---------------------------------------------------------------------------
# HybridParallelEngine state
# ---------------------------------------------------------------------------


def _hybrid_layout(eng):
    """``{name: (kind, key, layer)}`` for the hybrid engine's parameters:
    kind "block" (key: the name within a block, layer: its global
    index) or "rest" (key: the name)."""
    pat = re.compile(eng.block_regex)
    out = {}
    for k in eng.params:
        m = pat.match(k)
        out[k] = ("block", m.group(2), int(m.group(1))) if m else \
            ("rest", k, None)
    return out


def _hybrid_global(eng):
    """The reference's hybrid state at global shapes from this rank's
    slices: ``block_params`` ``{name: [pp, L/pp, ...]}``,
    ``rest_params``, ``rest_buffers`` and ``opt_state`` ``{"blocks":
    ..., "rest": ...}`` (a block's optimizer scalars, equal in every
    layer, once per name). Collectives of the engine's groups."""
    from .collective import all_gather

    zero, hcg, dev = eng._zero, eng.hcg, eng.device
    layout = _hybrid_layout(eng)
    pp_group = hcg.get_pipe_parallel_group()

    def whole(t, k):
        return _mp_join(_zero_join(t, k, zero, dev), eng.params[k], hcg)

    def stack(per_layer):
        # this stage's layers in order, then every stage's over pp
        x = torch.stack([per_layer[i] for i in sorted(per_layer)])
        if pp_group is not None and pp_group.pg is not None:
            x = torch.cat(all_gather(None, x.contiguous(), group=pp_group))
        return x.reshape((eng.pp, eng.layers_per_stage) + tuple(x.shape[1:]))

    blocks, block_opt = {}, {}
    rest, rest_opt = {}, {}
    for k, p in eng.params.items():
        kind, key, layer = layout[k]
        t = whole(zero.shards[k], k) if k in zero.shards else \
            _mp_join(p.detach(), p, hcg)
        st = {n: whole(v, k) if v.dim() else v
              for n, v in zero.states[k].items()}
        if kind == "block":
            blocks.setdefault(key, {})[layer] = t
            for n, v in st.items():
                block_opt.setdefault(key, {}).setdefault(n, {})[layer] = v
        else:
            rest[k], rest_opt[k] = t, st
    block_opt = {key: {n: stack(v) if next(iter(v.values())).dim() else
                       v[min(v)] for n, v in leaves.items()}
                 for key, leaves in block_opt.items()}
    return {"block_params": {k: stack(v) for k, v in blocks.items()},
            "rest_params": rest,
            "rest_buffers": {k: b for k, b in eng.model.named_buffers()
                             if k not in layout and not re.match(
                                 eng.block_regex, k)},
            "opt_state": {"blocks": block_opt, "rest": rest_opt}}


def _hybrid_meta(eng):
    meta = _engine_metadata(eng, eng.step)
    meta["buffers"] = {k: [v.item(), str(v.dtype).replace("torch.", "")]
                       for k, v in eng.buffers.items()}
    return meta


def save_hybrid_state(path, hybrid_engine):
    """Checkpoint a HybridParallelEngine under the reference's keys and
    global shapes (``block_params`` at ``[pp, L/pp, ...]``,
    ``rest_params``, ``rest_buffers``, ``opt_state`` with ``blocks`` and
    ``rest``), gathered from this rank's mp shards, pipeline stage and
    ZeRO slices (a collective: every rank calls it). The metadata keeps
    the step, the random streams, the step features' scalars and the LR
    scheduler, so a restored engine takes the next step bit for bit."""
    save_state(path, _hybrid_global(hybrid_engine),
               metadata=_hybrid_meta(hybrid_engine))


def load_hybrid_state(path, hybrid_engine):
    """Restore a HybridParallelEngine in place from `save_hybrid_state`'s
    checkpoint, written on any factorization of the same global shapes:
    each parameter and moment takes this rank's layers, mp shard and
    ZeRO slice (under ZeRO-3 the parameters' slices; offloaded moments
    stay in host memory)."""
    eng = hybrid_engine
    path = os.path.abspath(path)
    meta = load_metadata(path)
    if meta is None:
        raise FileNotFoundError(
            f"checkpoint {path} has no {META_NAME} — it was written "
            "by an interrupted save and cannot be resumed exactly")
    zero, hcg = eng._zero, eng.hcg
    layout = _hybrid_layout(eng)
    lps = eng.layers_per_stage

    def key_of(k, leaf=None):
        kind, key, _ = layout[k]
        if kind == "block":
            return (f"['block_params'][{key!r}]" if leaf is None else
                    f"['opt_state']['blocks'][{key!r}][{leaf!r}]")
        return (f"['rest_params'][{key!r}]" if leaf is None else
                f"['opt_state']['rest'][{key!r}][{leaf!r}]")

    keys = []
    for k in eng.params:
        keys.append(key_of(k))
        keys += [key_of(k, n) for n in zero.states[k]]
    with _phase("checkpoint-restore", cat="checkpoint"):
        read = _read(path, sorted(set(keys)))

    def local(k, key, zeroed, like):
        words, dtype = read[key]
        kind, _, layer = layout[k]
        if kind == "block" and words.ndim >= 2:
            words = words[layer // lps, layer % lps]
        sl = _rank_slice(eng.params[k], k, zero, hcg, zeroed)
        if sl is not None and words.ndim:
            words = sl.apply(words)
        if tuple(words.shape) != tuple(like.shape) or \
                dtype != _dtype_name(like):
            raise ValueError(f"checkpoint {path}: {key} for {k} is {dtype}"
                             f"{list(words.shape)}, the engine holds "
                             f"{_dtype_name(like)}{list(like.shape)}")
        return _restored_leaf(words, dtype, like)

    with torch.no_grad():
        new = {}
        for k, p in eng.params.items():
            target = zero.shards.get(k, p)
            new[k] = (target, local(k, key_of(k), k in zero.shards, target),
                      {n: (v, local(k, key_of(k, n), True, v))
                       for n, v in zero.states[k].items()})
        for target, value, states in new.values():
            target.copy_(value)
            for t, v in states.values():
                t.copy_(v)
    eng.step = int(meta.get("step", 0))
    _restore_streams(meta, eng)
    for k, (value, dtype) in meta.get("buffers", {}).items():
        eng.buffers[k] = torch.tensor(value, dtype=getattr(torch, dtype),
                                      device=eng.device)
    return eng


# ---------------------------------------------------------------------------
# numbered checkpoints (auto_checkpoint analogue)
# ---------------------------------------------------------------------------


class CheckpointManager:
    """Numbered checkpoints with retention + latest-resume.

    Ref parity: fluid/incubate/checkpoint/auto_checkpoint.py:71
    (AutoCheckpointChecker / train_epoch_range) and
    checkpoint_saver.py's numbered dirs. `save(step, state)` writes
    `<dir>/ckpt-<step>`; `latest_step()` + `restore(template)` resume.
    """

    def __init__(self, directory, max_to_keep=3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step):
        return os.path.join(self.directory, f"ckpt-{step}")

    def all_steps(self):
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("ckpt-"):
                try:
                    # 'ckpt-<n>.tmp' staging dirs and '.old-' remnants
                    # fail the int() parse and are invisible here
                    out.append(int(name.split("-", 1)[1]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _is_readable(self, step):
        """Cheap commit check: an atomically-committed dir always holds
        the manifest (and metadata when one was supplied). Torn dirs
        from legacy non-atomic saves or fabricated corruption lack both."""
        p = self._path(step)
        return os.path.isdir(p) and (
            os.path.exists(os.path.join(p, MANIFEST_NAME))
            or os.path.exists(os.path.join(p, META_NAME)))

    def is_readable(self, step):
        """True only for a committed `ckpt-<step>` dir — staging `.tmp`
        dirs and torn writes never qualify."""
        return self._is_readable(step)

    def readable_steps(self):
        return [s for s in self.all_steps() if self._is_readable(s)]

    def save(self, step, state, *, metadata=None):
        meta = dict(metadata or {})
        meta.setdefault("step", int(step))
        meta.update(_rng_metadata())
        with _phase("checkpoint-write", cat="checkpoint"):
            save_state(self._path(step), state, metadata=meta)
            self._gc()

    def save_engine(self, step, engine):
        """Numbered full-fidelity engine.Engine snapshot."""
        self.save_with(step, lambda p: save_train_state(p, engine))

    def restore(self, template, *, step=None):
        self.wait_until_finished()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no checkpoints under {self.directory}")
        state = load_state(self._path(step), template)
        meta = load_metadata(self._path(step)) or {}
        _restore_rng(meta)
        return state, meta

    def _gc(self):
        """Retention that can never GC the last good checkpoint: only
        READABLE checkpoints count toward max_to_keep, and the newest
        readable one is always kept. Unreadable/torn dirs are garbage
        and removed regardless of age."""
        steps = self.all_steps()
        readable = [s for s in steps if self._is_readable(s)]
        keep = set(readable[-max(self.max_to_keep, 1):])
        for s in steps:
            if s in keep:
                continue
            shutil.rmtree(self._path(s), ignore_errors=True)
            _monitor.stat_add("ckpt_gc_removed")

    def save_with(self, step, writer_fn):
        """Numbered save through an external writer (e.g.
        save_train_state): writer_fn(path) persists, then retention
        applies — keeps the numbering+gc contract in one place."""
        with _phase("checkpoint-write", cat="checkpoint"):
            writer_fn(self._path(step))
            self._gc()

    def restore_with(self, reader_fn, *, step=None):
        """Numbered restore through an external reader, falling back to
        OLDER checkpoints when the newest is unreadable: a torn dir
        (metadata absent), a checksum mismatch (ValueError from the
        manifest check), or any reader failure. Each fallback warns and
        counts in ``ckpt_restore_fallbacks``."""
        self.wait_until_finished()
        candidates = [step] if step is not None else \
            list(reversed(self.all_steps()))
        if not candidates:
            raise FileNotFoundError(
                f"no checkpoints under {self.directory}")
        last_err = None
        for s in candidates:
            try:
                return s, reader_fn(self._path(s))
            except Exception as e:  # noqa: BLE001 — any unreadable ckpt
                last_err = e
                warnings.warn(
                    f"checkpoint ckpt-{s} unreadable ({e}); trying the "
                    "previous one")
                _monitor.stat_add("ckpt_restore_fallbacks")
        raise FileNotFoundError(
            f"no readable checkpoint under {self.directory}") from last_err

    def wait_until_finished(self):
        """Synchronous manager: every save already committed."""


class _Snapshot:
    """A host copy of a state tree, and the CUDA event after its
    device->host copies (None when no leaf was on a card)."""

    def __init__(self, tree, event):
        self.tree = tree
        self.event = event


class AsyncCheckpointManager(CheckpointManager):
    """CheckpointManager with a background writer.

    The step thread pays only the device->host copy (so the snapshot is
    a consistent point-in-time view even while training continues);
    hashing, serialization, the atomic commit, retries, and retention
    run on a single worker thread. Failures surface on the next save()
    or on wait_until_finished() — call the latter before relying on the
    latest checkpoint (restore/restore_with do it automatically).
    """

    def __init__(self, directory, max_to_keep=3):
        super().__init__(directory, max_to_keep=max_to_keep)
        from concurrent.futures import ThreadPoolExecutor

        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt-writer")
        self._pending = []

    @staticmethod
    def _to_host(state):
        """A copy of `state` that the next step cannot change: the
        engine updates its tensors in place, and a CPU tensor's numpy
        view shares its memory, so every CPU leaf is cloned; a CUDA
        leaf is copied into pinned host memory without blocking,
        ordered before the next step's kernels on the same stream, and
        the writer waits on the event recorded after the copies before
        it reads a byte."""
        streams = {}

        def copy(_key, leaf):
            if isinstance(leaf, torch.Tensor):
                leaf = leaf.detach()
                if leaf.is_cuda:
                    host = torch.empty(leaf.shape, dtype=leaf.dtype,
                                       pin_memory=True)
                    host.copy_(leaf, non_blocking=True)
                    streams.setdefault(
                        leaf.device, torch.cuda.current_stream(leaf.device))
                    return host
                return leaf.clone()
            if isinstance(leaf, np.ndarray):
                return leaf.copy()
            return leaf

        with _phase("checkpoint-snapshot", cat="checkpoint"):
            tree = _map(copy, state)
            event = None
            if streams:
                (stream,) = streams.values()   # one process, one card
                event = torch.cuda.Event()
                event.record(stream)
        return _Snapshot(tree, event)

    def save(self, step, state, *, metadata=None):
        meta = dict(metadata or {})
        meta.setdefault("step", int(step))
        meta.update(_rng_metadata())
        self._submit(step, self._to_host(state), meta)

    def save_engine(self, step, engine):
        state, meta = _engine_payload(engine)
        meta.setdefault("ckpt_step", int(step))
        self._submit(step, self._to_host(state), meta)

    def save_with(self, step, writer_fn):
        """writer_fn reads live state, so it cannot be deferred safely;
        run it synchronously (use save/save_engine for async writes)."""
        super().save_with(step, writer_fn)

    def _submit(self, step, snapshot, meta):
        self._raise_failed()
        fut = self._executor.submit(self._write, step, snapshot, meta)
        self._pending.append(fut)
        _monitor.stat_add("ckpt_async_saves")
        return fut

    def _write(self, step, snapshot, meta):
        # background-writer time: a phase of its own, so goodput
        # reports it without charging the step thread (it overlaps
        # training)
        with _phase("checkpoint-write-async", cat="checkpoint"):
            if snapshot.event is not None:
                snapshot.event.synchronize()
            save_state(self._path(step), snapshot.tree, metadata=meta)
            self._gc()

    def _raise_failed(self):
        done = [f for f in self._pending if f.done()]
        self._pending = [f for f in self._pending if not f.done()]
        for f in done:
            exc = f.exception()
            if exc is not None:
                raise exc

    def wait_until_finished(self):
        """Block until every queued save committed; re-raises the first
        background failure."""
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def close(self):
        self.wait_until_finished()
        self._executor.shutdown(wait=True)


# ---------------------------------------------------------------------------
# gang-consistent checkpoints (commit barrier + cross-rank digest)
# ---------------------------------------------------------------------------


def _combined_digest(digests):
    """One sha256 over sorted per-leaf (or per-rank) digests — the
    cross-rank state fingerprint the GANG marker records."""
    h = hashlib.sha256()
    for k in sorted(digests):
        h.update(f"{k}:{digests[k]}\n".encode())
    return h.hexdigest()


class GangCheckpointManager:
    """Numbered checkpoints with a GLOBAL commit barrier.

    Per-rank CheckpointManagers alone are not enough for gang restart:
    rank 0 may have committed step 40 while rank 1 died at step 39, and
    restoring 'everyone's newest local step' silently resumes a world
    that never existed. This manager makes the commit gang-atomic:

    - each rank saves into ``<dir>/rank-<r>/ckpt-<step>`` (the usual
      atomic per-rank commit) and then drops a per-rank commit marker
      ``<dir>/commits/s<step>.r<rank>.json`` recording its state digest;
    - rank 0 waits for every rank's marker and atomically writes
      ``s<step>.GANG.json`` with the full ``{rank: digest}`` map and a
      combined cross-rank digest; non-zero ranks wait for that marker —
      this wait is the **commit barrier**, deadline-scoped via the
      ``dist.barrier`` fault site (FLAGS_dist_timeout_s);
    - a step is READABLE for resume only when the GANG marker exists
      *and* the local shard is readable; `restore_engine` restores the
      newest such step, remaps ranks when the world re-formed within
      [min_np, max_np] (``src = rank % marker_world``), and cross-checks
      the restored state's digest against what the marker recorded.

    A rank SIGKILLed between its local commit and the barrier leaves no
    GANG marker, so every survivor resumes from the previous committed
    step — globally consistent by construction.
    """

    def __init__(self, directory, rank, world, *, max_to_keep=3,
                 barrier_timeout_s=None, poll_interval=0.02):
        self.directory = os.path.abspath(directory)
        self.rank = int(rank)
        self.world = int(world)
        self.local = CheckpointManager(
            os.path.join(self.directory, f"rank-{self.rank}"),
            max_to_keep=max_to_keep)
        self.commits = os.path.join(self.directory, "commits")
        os.makedirs(self.commits, exist_ok=True)
        self.barrier_timeout_s = barrier_timeout_s
        self.poll_interval = poll_interval

    # -- marker paths -------------------------------------------------------

    def _rank_marker(self, step, rank):
        return os.path.join(self.commits, f"s{step}.r{rank}.json")

    def _gang_marker(self, step):
        return os.path.join(self.commits, f"s{step}.GANG.json")

    @staticmethod
    def _read_json(path):
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None  # absent or torn mid-write: not committed

    @staticmethod
    def _write_json(path, rec):
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, path)

    # -- save + commit barrier ----------------------------------------------

    def save(self, step, state, *, metadata=None):
        """Atomic local save, then the gang commit barrier. Returns only
        once the step is GLOBALLY committed (every rank wrote and rank 0
        published the GANG marker) — or raises CollectiveTimeoutError,
        leaving the step uncommitted everywhere."""
        self.local.save(step, state, metadata=metadata)
        self._commit(step, _combined_digest(leaf_digests(state)))

    def save_engine(self, step, engine):
        """`save` of an engine.Engine's full payload (a meshed engine's
        at global shapes); the digest is the written manifest's."""
        self.local.save_engine(step, engine)
        manifest = load_manifest(self.local._path(step))
        self._commit(step, _combined_digest(
            {k: v["sha256"] for k, v in manifest.items()}))

    def _commit(self, step, digest):
        from .gang import CollectiveTimeoutError, deadline_guard

        self._write_json(self._rank_marker(step, self.rank),
                         {"rank": self.rank, "digest": digest,
                          "ts": time.time()})
        remaining = deadline_guard("dist.barrier", self.barrier_timeout_s,
                                   tag="gang-commit")
        end = None if remaining is None \
            else time.monotonic() + remaining

        def _expired(what):
            if end is not None and time.monotonic() > end:
                _monitor.stat_add("gang.collective_timeouts")
                raise CollectiveTimeoutError(
                    f"gang checkpoint commit barrier for step {step} "
                    f"timed out waiting for {what} (deadline "
                    f"{remaining:.3f}s) — a peer died before commit; "
                    "the step stays uncommitted and resume falls back "
                    "to the previous GANG-committed step")

        if self.rank == 0:
            digests = {}
            for r in range(self.world):
                while True:
                    rec = self._read_json(self._rank_marker(step, r))
                    if rec is not None:
                        digests[str(r)] = rec["digest"]
                        break
                    _expired(f"rank {r}'s commit marker")
                    time.sleep(self.poll_interval)
            self._write_json(self._gang_marker(step), {
                "step": int(step), "world": self.world,
                "digests": digests,
                "digest": _combined_digest(digests),
                "ts": time.time()})
        else:
            while self._read_json(self._gang_marker(step)) is None:
                _expired("rank 0's GANG marker")
                time.sleep(self.poll_interval)
        _monitor.stat_add("gang.commits")

    # -- globally committed view --------------------------------------------

    def _shard_readable(self, step, marker):
        """Is the shard THIS rank would restore from readable? For a
        rank of the committing world that is its own local shard; a
        rank joining a re-formed (grown) world has no local shard and
        checks its cyclically-mapped source rank's instead."""
        src = self._src_rank(marker)
        if src == self.rank:
            return self.local.is_readable(step)
        shard = os.path.join(self.directory, f"rank-{src}",
                             f"ckpt-{step}")
        return os.path.isdir(shard) and (
            os.path.exists(os.path.join(shard, MANIFEST_NAME))
            or os.path.exists(os.path.join(shard, META_NAME)))

    def committed_steps(self):
        """Steps with a GANG marker AND a readable source shard for
        this rank — the only steps resume may use."""
        out = []
        for name in os.listdir(self.commits):
            if name.endswith(".GANG.json") and name.startswith("s"):
                try:
                    step = int(name[1:].split(".", 1)[0])
                except ValueError:
                    continue
                marker = self._read_json(
                    os.path.join(self.commits, name))
                if marker is not None and \
                        self._shard_readable(step, marker):
                    out.append(step)
        return sorted(out)

    def latest_committed_step(self):
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def marker(self, step):
        return self._read_json(self._gang_marker(step))

    # -- resume -------------------------------------------------------------

    def _src_rank(self, marker):
        """When the world re-formed (elastic shrink/grow within
        [min_np, max_np]) the restored world may differ from the one
        that wrote the marker; ranks map onto the writers cyclically."""
        return self.rank % int(marker["world"])

    def _resolve(self, step):
        """(step, marker, src rank, src checkpoint path) for a resume,
        defaulting to the newest globally committed step."""
        if step is None:
            step = self.latest_committed_step()
        if step is None:
            raise FileNotFoundError(
                f"no globally committed checkpoint under "
                f"{self.directory}")
        marker = self.marker(step)
        if marker is None:
            raise FileNotFoundError(
                f"step {step} has no GANG commit marker under "
                f"{self.commits}")
        src = self._src_rank(marker)
        return step, marker, src, os.path.join(
            self.directory, f"rank-{src}", f"ckpt-{step}")

    def _check_digest(self, step, marker, src, state):
        got = _combined_digest(leaf_digests(state))
        want = marker["digests"][str(src)]
        if got != want:
            raise ValueError(
                f"gang restore digest mismatch at step {step}: rank "
                f"{self.rank} restored rank {src}'s shard but its "
                f"digest {got[:12]} != committed {want[:12]} — the "
                "bytes on disk are not what the gang committed")
        _monitor.stat_add("gang.restores")

    def restore(self, template, *, step=None):
        """Restore a plain pytree from the newest (or given) globally
        committed step, digest-checked. Returns (step, state)."""
        step, marker, src, path = self._resolve(step)
        state = load_state(path, template)
        self._check_digest(step, marker, src, state)
        return step, state

    def restore_engine(self, engine, *, step=None):
        """Restore this rank's engine from the newest (or given)
        globally committed step, verifying the restored state digest
        against the GANG marker. Returns the restored step."""
        step, marker, src, path = self._resolve(step)
        load_train_state(path, engine)
        state, _ = _engine_payload(engine)
        self._check_digest(step, marker, src, state)
        return step


# ---------------------------------------------------------------------------
# persistables and the auto-checkpointed epoch loop
# ---------------------------------------------------------------------------


def save_persistables(engine_or_layer, dirname):
    """fleet.save_persistables analogue (ref fluid/io.py:668): persist
    every parameter + buffer of a Layer, or the full state of an Engine."""
    from ..engine import Engine

    if isinstance(engine_or_layer, Engine):
        save_train_state(dirname, engine_or_layer)
        return
    save_state(dirname, dict(engine_or_layer.state_dict()))


def load_persistables(engine_or_layer, dirname):
    from ..engine import Engine

    if isinstance(engine_or_layer, Engine):
        load_train_state(dirname, engine_or_layer)
        return
    sd = engine_or_layer.state_dict()
    restored = load_state(dirname, dict(sd))
    with torch.no_grad():
        for k, v in restored.items():
            sd[k].copy_(v)


def train_epoch_range(max_epoch, directory, engine, save_interval=1,
                      max_to_keep=3, async_save=False,
                      handle_preemption=True):
    """Auto-checkpointed epoch loop (ref fluid/incubate/checkpoint/
    auto_checkpoint.py:71 train_epoch_range): yields epoch indices,
    snapshotting the engine's full TrainState after each `save_interval`
    epochs, and TRANSPARENTLY RESUMES — after a restart the generator
    restores the latest snapshot (params, optimizer state, RNG) and
    continues from the next epoch, so the training script needs no
    resume logic of its own:

        for epoch in checkpoint.train_epoch_range(10, ckpt_dir, engine):
            ... train one epoch ...

    `async_save=True` routes snapshots through AsyncCheckpointManager so
    the epoch loop overlaps serialization. `handle_preemption` (default)
    installs the SIGTERM/SIGUSR1 handlers: a preemption triggers an
    emergency snapshot at the next epoch boundary, writes a PREEMPTED
    marker, and raises PreemptedError; the restarted job consumes the
    marker and resumes the exact epoch/step/RNG state.
    """
    from ..engine import Engine
    from . import preempt as _preempt

    if not isinstance(engine, Engine):
        raise TypeError("train_epoch_range drives an Engine; for raw "
                        "Layers use CheckpointManager directly")
    mgr_cls = AsyncCheckpointManager if async_save else CheckpointManager
    mgr = mgr_cls(os.path.join(directory, "auto_ckpt"),
                  max_to_keep=max_to_keep)
    if handle_preemption:
        _preempt.install()
        _preempt.consume_marker(mgr.directory)
    # anomaly-guarded engines roll back to the newest snapshot here
    engine.attach_checkpoint_manager(mgr)
    start = 0
    if mgr.all_steps():
        restored_step, _ = mgr.restore_with(
            lambda p: load_train_state(p, engine))
        start = restored_step + 1

    try:
        for epoch in range(start, max_epoch):
            yield epoch
            preempted = handle_preemption and _preempt.poll()
            if preempted or (epoch + 1) % save_interval == 0 \
                    or epoch == max_epoch - 1:
                mgr.save_engine(epoch, engine)
            if preempted:
                mgr.wait_until_finished()
                _preempt.write_marker(
                    mgr.directory,
                    {"epoch": epoch, "step": int(engine.state.step)})
                _monitor.stat_add("preempt_emergency_saves")
                raise _preempt.PreemptedError(
                    f"preempted ({_preempt.reason()}); emergency "
                    f"checkpoint committed at epoch {epoch} — exit and "
                    "restart to resume")
    finally:
        mgr.wait_until_finished()
