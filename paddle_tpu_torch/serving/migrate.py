"""Prefix KV-block migration between engines (counterpart of
paddle_tpu/serving/migrate.py).

An engine that prefilled a prompt hands its fully written KV blocks to
another engine that will produce the response tokens, as an explicit
export -> stream -> adopt pipeline:

  * export: the source engine gathers the prompt's cached prefix blocks
    from its pool into host arrays (`SlotEngine.export_prefix_blocks`);
  * stream: the payload rides `KVMailbox`, an in-process loopback with a
    per-leg deadline;
  * adopt: the destination engine allocates blocks, writes the rows into
    its own pool and indexes them in its PrefixCache
    (`SlotEngine.adopt_prefix_blocks`) — all-or-nothing: a fault
    mid-adoption (site ``serving.kv_migrate``) frees every block taken
    so far, so the pool stays leak-free and the request prefills from
    scratch.

The reference's mailbox passes through the gang layer's deadline guard
and its ``dist.p2p_send`` / ``dist.p2p_recv`` fault sites; those join
the port with its distributed runtime, and until then the mailbox here
is a plain deadline-bounded queue.
"""

from __future__ import annotations

import queue
import threading

from ..framework import monitor
from ..framework.errors import UnavailableError

__all__ = ["KVMailbox", "PeerGoneError", "migrate_prefix", "payload_bytes"]

#: default per-leg deadline for the in-process loopback (seconds)
DEFAULT_DEADLINE_S = 5.0


class PeerGoneError(UnavailableError):
    """No KV payload arrived within the deadline (the source engine is
    gone or wedged). Retriable: the request prefills from scratch."""

    retriable = True


class KVMailbox:
    """In-process loopback mailbox keyed by destination engine name."""

    def __init__(self):
        self._queues = {}
        self._lock = threading.Lock()

    def _queue(self, name):
        with self._lock:
            q = self._queues.get(name)
            if q is None:
                q = self._queues[name] = queue.Queue()
            return q

    def send(self, payload, dst):
        self._queue(dst).put(payload)

    def recv(self, dst, timeout=DEFAULT_DEADLINE_S):
        try:
            return self._queue(dst).get(timeout=timeout)
        except queue.Empty:
            monitor.stat_add("serving.kv_migrate_timeouts")
            raise PeerGoneError(
                f"no KV payload for {dst!r} within {timeout:.3f}s "
                "(source engine gone or wedged mid-migration)")


def payload_bytes(payload):
    """Bytes of KV rows a payload carries."""
    return int(sum(k.nbytes + v.nbytes for k, v in payload["layers"]))


def migrate_prefix(src_engine, dst_engine, ids, mailbox=None,
                   deadline_s=DEFAULT_DEADLINE_S):
    """Move the cached KV prefix for token ids `ids` from `src_engine`
    to `dst_engine`. Returns the number of prompt tokens now cached on
    the destination (0 = nothing exportable or an incompatible
    payload); a mailbox or adoption error propagates to the caller,
    whose request stays servable by a plain prefill either way."""
    payload = src_engine.export_prefix_blocks(ids)
    if payload is None:
        return 0
    box = mailbox if mailbox is not None else KVMailbox()
    box.send(payload, dst_engine.name)
    got = box.recv(dst_engine.name, timeout=deadline_s)
    adopted = dst_engine.adopt_prefix_blocks(got)
    if adopted:
        m = dst_engine.metrics
        nblocks = len(got["layers"][0][0]) if got["layers"] else 0
        m.inc("kv_migrations")
        m.inc("kv_migrate_blocks", nblocks)
        m.inc("kv_migrate_bytes", payload_bytes(got))
    return adopted
