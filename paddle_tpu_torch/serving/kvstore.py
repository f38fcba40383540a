"""Persistent SSD KV tier: crash-safe cold storage for evicted
prefix-cache blocks (counterpart of paddle_tpu/serving/kvstore.py, in
its on-disk format).

* **Spill on eviction** — when the radix `PrefixCache` evicts a cold
  block whose last reference is about to drop, the owning engine copies
  the block's KV rows to the host and appends them here *before* the
  allocator frees it (append-before-evict). Fault site
  ``serving.spill`` fires before each record write; a spill failure
  loses durability for that block, never correctness.
* **Restore on resume** — a later request whose token prefix extends a
  spilled record re-stages the block through the engine's all-or-
  nothing admission path (`SlotEngine._maybe_restore`). Every record
  re-verifies its crc32 at read time, so a torn tail or bit-rotted
  record degrades to re-prefill, never to wrong tokens.
* **Generation fencing** — each record carries the weight version its
  KV was computed under; `fence` retires a version, and a resume
  against one of its records raises the typed retriable
  `SpillFencedError` so the caller re-prefills on the live weights.
  `attach_registry` subscribes to a rollout `WeightRegistry`: every
  commit fences the records of the versions it retired.

Records are framed ``<I crc32> <I len> payload``; the payload is
`_META` (digest, generation, token count, block size, layers, heads,
head dim, dtype tag), the int32 tokens, then each layer's K and V rows.
The dtype tag is numpy's name of the rows' type. A bfloat16 pool is
written and read as its raw 16-bit words under the tag ``bfloat16``
(the name the reference's numpy gives it), so a record written by either
package reads in the other without a bfloat16 numpy type on this side:
`_unpack_record` returns such rows as uint16 words and says so in the
record's ``"dtype"``. Compaction rewrites the live records via tmp +
fsync + rename when the file crosses ``FLAGS_serving_kv_spill_cap_mb``.
One store instance is shared per directory (`open_spill_store`).
"""

from __future__ import annotations

import os
import struct
import threading
import zlib

import numpy as np

from ..framework import faults, monitor
from ..framework.flags import flag
from .queueing import ServingError

__all__ = ["KVSpillStore", "SpillFencedError", "open_spill_store",
           "reset_spill_stores", "host_rows"]

_HDR = struct.Struct("<II")           # crc32(payload), len(payload)
#: digest(20B sha1), generation(int64), n_tokens, block_size, n_layers,
#: n_heads, head_dim, dtype tag (8B ascii, NUL-padded)
_META = struct.Struct("<20sq5i8s")

SPILL_FILE = "kv.spill"

BF16 = "bfloat16"


class SpillFencedError(ServingError):
    """The spilled KV record was written under a weight version that
    has since been fenced — its attention state is meaningless on the
    current weights. Retriable: the caller re-prefills on the live
    version."""

    status = 503
    retriable = True


def host_rows(rows):
    """``(numpy array, dtype tag)`` of KV rows on the host: a torch
    tensor is copied to the host (a synchronous copy — the bytes are
    there when this returns); bfloat16 rows, from torch or from a
    numpy bfloat16 type, become their raw uint16 words under the tag
    ``bfloat16``."""
    import torch

    if isinstance(rows, torch.Tensor):
        t = rows.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        a = t.numpy()
        return a, str(a.dtype)
    a = np.asarray(rows)
    if a.dtype.name == BF16:
        return a.view(np.uint16), BF16
    return a, str(a.dtype)


def _frame(payload: bytes) -> bytes:
    return _HDR.pack(zlib.crc32(payload), len(payload)) + payload


def _pack_record(digest, generation, tokens, layers):
    tokens = np.ascontiguousarray(tokens, np.int32)
    host = [(host_rows(k), host_rows(v)) for k, v in layers]
    (k0, tag), _ = host[0]
    nh, bs, hd = k0.shape
    parts = [_META.pack(digest, int(generation), tokens.size, bs,
                        len(host), nh, hd, tag.encode()[:8]),
             tokens.tobytes()]
    for (k, _kt), (v, _vt) in host:
        parts.append(np.ascontiguousarray(k).tobytes())
        parts.append(np.ascontiguousarray(v).tobytes())
    return b"".join(parts)


def _unpack_record(payload):
    digest, gen, n_tok, bs, n_layers, nh, hd, dtype = \
        _META.unpack_from(payload, 0)
    pos = _META.size
    tokens = np.frombuffer(payload, np.int32, count=n_tok, offset=pos)
    pos += n_tok * 4
    tag = dtype.rstrip(b"\x00").decode()
    dt = np.dtype(np.uint16) if tag == BF16 else np.dtype(tag)
    rows = nh * bs * hd
    layers = []
    for _ in range(n_layers):
        k = np.frombuffer(payload, dt, count=rows, offset=pos)
        pos += rows * dt.itemsize
        v = np.frombuffer(payload, dt, count=rows, offset=pos)
        pos += rows * dt.itemsize
        layers.append((k.reshape(nh, bs, hd), v.reshape(nh, bs, hd)))
    return {"digest": digest, "generation": gen, "tokens": tokens,
            "block_size": bs, "layers": layers, "dtype": tag}


class KVSpillStore:
    """Append-only, crc-framed store of spilled KV blocks, keyed by the
    same cumulative sha1 token-prefix digest the `PrefixCache` indexes
    on. Thread-safe; shared across every engine of a process."""

    def __init__(self, path, *, cap_mb=None, metrics=None):
        if os.path.isdir(path):
            path = os.path.join(path, SPILL_FILE)
        self.path = path
        self.cap_mb = flag("FLAGS_serving_kv_spill_cap_mb") \
            if cap_mb is None else cap_mb
        self.metrics = metrics
        self._lock = threading.RLock()
        #: digest -> (offset of payload, payload length, generation)
        self._index: dict = {}
        self._fenced: set = set()      # fenced generations
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        good_end = self._scan()
        self._f = open(path, "r+b" if os.path.exists(path) else "w+b")
        self._f.truncate(good_end)     # drop any torn tail for good
        self._f.seek(good_end)

    # -- scan / recovery -----------------------------------------------------

    def _scan(self):
        """Rebuild the index from an existing file; returns the offset
        of the first torn/corrupt byte (everything after is dead)."""
        try:
            with open(self.path, "rb") as f:
                raw = f.read()
        except OSError:
            return 0
        pos = 0
        while pos + _HDR.size <= len(raw):
            crc, n = _HDR.unpack_from(raw, pos)
            body = raw[pos + _HDR.size:pos + _HDR.size + n]
            if len(body) < n or zlib.crc32(body) != crc:
                break                   # torn tail — end of durable data
            try:
                digest, gen = struct.unpack_from("<20sq", body, 0)
            except struct.error:
                break
            # later records supersede earlier ones for the same prefix
            self._index[digest] = (pos + _HDR.size, n, gen)
            pos += _HDR.size + n
        return pos

    def _inc(self, name, n=1):
        if self.metrics is not None:
            self.metrics.inc(name, n)
        else:
            monitor.stat_add(f"serving.{name}", n)

    # -- spill side ----------------------------------------------------------

    def append(self, digest, generation, tokens, layers):
        """Durably append one evicted block's KV rows (numpy arrays or
        torch tensors, ``[(k [nh, bs, hd], v), ...]`` per layer). Fires
        the ``serving.spill`` fault site before the write; must be
        called *before* the allocator frees the block. Returns the
        record's bytes on disk."""
        payload = _pack_record(digest, generation, tokens, layers)
        buf = _frame(payload)
        with self._lock:
            faults.fault_point("serving.spill")
            off = self._f.tell()
            self._f.write(buf)
            self._f.flush()
            os.fsync(self._f.fileno())
            self._index[digest] = (off + _HDR.size, len(payload),
                                   int(generation))
            self._inc("kv_spilled_blocks")
            self._inc("kv_spill_bytes", len(buf))
            if self.cap_mb and self._f.tell() > self.cap_mb * (1 << 20):
                self._compact_locked()
        return len(buf)

    def get(self, digest):
        """The record for a prefix digest, or None when absent or
        corrupt (bit rot re-verifies at read time and degrades to
        re-prefill). Raises `SpillFencedError` when the record's weight
        generation has been fenced."""
        with self._lock:
            entry = self._index.get(digest)
            if entry is None:
                return None
            off, n, gen = entry
            if gen in self._fenced:
                raise SpillFencedError(
                    f"spilled KV for this prefix was written under "
                    f"retired weight version {gen}; re-prefill on the "
                    "live version")
            self._f.flush()
            with open(self.path, "rb") as f:
                f.seek(off - _HDR.size)
                hdr = f.read(_HDR.size)
                body = f.read(n)
            crc = _HDR.unpack(hdr)[0] if len(hdr) == _HDR.size else None
            if crc is None or len(body) < n or zlib.crc32(body) != crc:
                # bit rot / tamper: the record can never produce wrong
                # tokens — it simply stops existing
                self._index.pop(digest, None)
                self._inc("kv_restore_corrupt")
                return None
            return _unpack_record(body)

    def __contains__(self, digest):
        with self._lock:
            return digest in self._index

    def __len__(self):
        with self._lock:
            return len(self._index)

    # -- generation fencing --------------------------------------------------

    def fence(self, generation):
        """Fence one weight generation: resumes against its records now
        raise `SpillFencedError` until compaction drops them."""
        with self._lock:
            self._fenced.add(int(generation))
            n = sum(1 for (_o, _n, g) in self._index.values()
                    if g == int(generation))
            if n:
                self._inc("kv_invalidated_blocks", n)
            return n

    def fence_retired(self, is_live):
        """Fence every indexed generation for which ``is_live(gen)`` is
        False — the rollout-commit hook."""
        with self._lock:
            gens = {g for (_o, _n, g) in self._index.values()}
        return sum(self.fence(g) for g in sorted(gens)
                   if g not in self._fenced and not is_live(g))

    def attach_registry(self, registry):
        """Subscribe to a `WeightRegistry` (serving/rollout.py): every
        commit fences the spilled records of versions the commit
        retired."""
        registry.subscribe(
            lambda _wv: self.fence_retired(registry.is_live))
        return self

    # -- compaction ----------------------------------------------------------

    def compact(self):
        with self._lock:
            return self._compact_locked()

    def _compact_locked(self):
        """Rewrite only the live, unfenced records (tmp + fsync +
        rename — a crash leaves the old or the new complete file)."""
        live = []
        self._f.flush()
        with open(self.path, "rb") as f:
            for digest, (off, n, gen) in sorted(self._index.items(),
                                                key=lambda kv: kv[1][0]):
                if gen in self._fenced:
                    continue
                f.seek(off, 0)
                body = f.read(n)
                if len(body) == n:
                    live.append((digest, gen, body))
        tmp = self.path + ".tmp"
        index = {}
        with open(tmp, "wb") as f:
            for digest, gen, body in live:
                index[digest] = (f.tell() + _HDR.size, len(body), gen)
                f.write(_frame(body))
            f.flush()
            os.fsync(f.fileno())
        self._f.close()
        os.replace(tmp, self.path)
        self._index = index
        self._f = open(self.path, "r+b")
        self._f.seek(0, os.SEEK_END)
        monitor.stat_add("serving.kv_spill_compactions")
        return len(index)

    # -- admin ---------------------------------------------------------------

    @property
    def nbytes(self):
        with self._lock:
            return self._f.tell()

    def stats(self):
        with self._lock:
            return {"records": len(self._index),
                    "bytes": self._f.tell(),
                    "fenced_generations": sorted(self._fenced)}

    def close(self):
        with self._lock:
            if self._f is not None and not self._f.closed:
                self._f.flush()
                self._f.close()


# one shared store per directory: every engine in the process spills
# into — and resumes from — the same tier
_stores: dict = {}
_stores_lock = threading.Lock()


def open_spill_store(directory=None, *, metrics=None):
    """The process-shared `KVSpillStore` for a spill directory (default
    ``FLAGS_serving_kv_spill_dir``); None when the tier is disabled."""
    if directory is None:
        directory = flag("FLAGS_serving_kv_spill_dir")
    if not directory:
        return None
    key = os.path.abspath(directory)
    with _stores_lock:
        store = _stores.get(key)
        if store is None or store._f.closed:
            store = _stores[key] = KVSpillStore(key, metrics=metrics)
        elif metrics is not None and store.metrics is None:
            store.metrics = metrics
        return store


def reset_spill_stores():
    """Close and forget every shared store (test isolation)."""
    with _stores_lock:
        for store in _stores.values():
            store.close()
        _stores.clear()
