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
- save_persistables / load_persistables, train_epoch_range

Each path runs under the reference's ``observe.phase`` spans, which
goodput reads: ``checkpoint-restore`` (load_state),
``checkpoint-write`` (a synchronous manager's save and save_with),
``checkpoint-snapshot`` (the async manager's device->host copy on the
step thread) and ``checkpoint-write-async`` (its background write,
overlapped with training). The reference's gang checkpoints
(`GangCheckpointManager`), ``save_hybrid_state`` and resharded restores
are not ported yet.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import warnings

import numpy as np
import torch

from ..framework import faults as _faults
from ..framework import monitor as _monitor
from ..framework.errors import retry_with_backoff
from ..observe import phase as _phase

__all__ = ["MANIFEST_NAME", "META_NAME", "leaf_digests", "load_manifest",
           "verify_manifest", "save_state", "load_state", "load_metadata",
           "save_train_state", "load_train_state", "CheckpointManager",
           "AsyncCheckpointManager", "save_persistables",
           "load_persistables", "train_epoch_range"]

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
        if dtype == "bfloat16":
            t = torch.from_numpy(words.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(words)
        return t.to(like.device)
    return words


def load_state(path, template, *, verify=None):
    """Restore a tree saved by save_state.

    `template` supplies the structure and each leaf's shape, dtype and
    device (tensors come back on the template leaf's device, other
    leaves as numpy arrays); a missing leaf or a shape or dtype that
    differs raises. When `verify` (default: the
    FLAGS_ckpt_verify_checksums flag), every leaf read is re-hashed
    against the saved manifest before anything is returned and a
    mismatch raises ValueError.
    """
    from ..framework import flags as _flags

    path = os.path.abspath(path)
    with _phase("checkpoint-restore", cat="checkpoint"):
        with open(os.path.join(path, DATA_DIR, INDEX_NAME)) as f:
            index = json.load(f)
        read = {}
        for key, like in _flatten(template):
            if key not in index:
                raise KeyError(f"checkpoint {path} holds no leaf {key}")
            ent = index[key]
            words = np.load(os.path.join(path, DATA_DIR, ent["file"]),
                            allow_pickle=False)
            shape = tuple(like.shape) if hasattr(like, "shape") else ()
            if tuple(words.shape) != shape or \
                    ent["dtype"] != _dtype_name(like):
                raise ValueError(
                    f"checkpoint {path}: leaf {key} is {ent['dtype']}"
                    f"{list(words.shape)}, the template wants "
                    f"{_dtype_name(like)}{list(shape)}")
            read[key] = (words, ent["dtype"])
        if verify is None:
            verify = _flags.flag("FLAGS_ckpt_verify_checksums")
        if verify:
            manifest = load_manifest(path)
            if manifest is not None:
                _check_digests(path, manifest,
                               [(k, _digest(w)) for k, (w, _) in read.items()])
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


def _engine_payload(engine):
    """(state tree, metadata) capturing an engine.Engine with full
    resume fidelity: params, optimizer moments, buffers, step count,
    LR-scheduler position, the engine's own RngState and torch's
    default generators (in the metadata, so the payload's keys match
    the reference's)."""
    from ..optimizer.lr import LRScheduler

    st = engine.state
    meta = {"step": int(st.step), **_rng_metadata(),
            "engine_rng": engine.rng.state_dict()}
    lr = getattr(engine.optimizer, "_learning_rate", None)
    if isinstance(lr, LRScheduler):
        meta["lr_scheduler"] = lr.state_dict()
    state = {"params": st.params, "opt_state": st.opt_state,
             "buffers": st.buffers}
    return state, meta


def save_train_state(path, engine):
    """Checkpoint an engine.Engine: params, optimizer moments, buffers,
    step count, LR-scheduler position, and the random streams."""
    state, meta = _engine_payload(engine)
    save_state(path, state, metadata=meta)


def load_train_state(path, engine):
    """Restore an engine.Engine in place. The parameters are the layer's
    own and the forward updates model buffers (BN running stats) in
    place, so every restored value is copied into the engine's existing
    tensor; the engine's reserved scalars (loss scale, anomaly counter,
    grad norm, ScaleState) are rebound to fresh tensors instead, so that
    no flight-recorder record that holds the old ones changes. Nothing
    is touched until every leaf has been read and verified."""
    from ..engine import _RESERVED
    from ..optimizer.lr import LRScheduler

    # validate metadata BEFORE mutating the engine so a failed load leaves
    # the caller free to fall back to fresh training
    meta = load_metadata(path)
    if meta is None:
        raise FileNotFoundError(
            f"checkpoint {path} has no {META_NAME} — it was written "
            "by an interrupted save and cannot be resumed exactly")
    st = engine.state
    tpl = {"params": st.params, "opt_state": st.opt_state,
           "buffers": st.buffers}
    restored = load_state(path, tpl)
    with torch.no_grad():
        for k, p in st.params.items():
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
    _restore_rng(meta)
    if "engine_rng" in meta:
        engine.rng.set_state_dict(meta["engine_rng"])
    lr = getattr(engine.optimizer, "_learning_rate", None)
    if isinstance(lr, LRScheduler) and "lr_scheduler" in meta:
        lr.set_state_dict(meta["lr_scheduler"])
    return engine


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
