"""Elastic training: node registry, liveness watch, restart signalling
(counterpart of paddle_tpu/distributed/elastic.py, with the same names,
verdicts and files).

The registry is a shared directory of per-node heartbeat files
``<node>.beat``, each one JSON object ``{"node": id, "ts": unix time}``
with ``"step"`` when the beat carries a step watermark, written to
``<node>.beat.tmp`` and renamed over the old file: byte for byte the
reference's format, so either package's reader reads the other's
files. The manager only detects and signals; recovery is
checkpoint-based (`distributed.checkpoint`), as in the reference.
"""

from __future__ import annotations

import json
import os
import time

__all__ = ["ElasticStatus", "ElasticManager"]


class ElasticStatus:
    COMPLETED = "completed"
    ERROR = "error"
    HOLD = "hold"
    RESTART = "restart"
    EXIT = "exit"


class ElasticManager:
    """File-registry elastic manager.

    np can float between min_np and max_np (PADDLE_ELASTIC_NP semantics):
    - fewer live nodes than min_np        -> HOLD (wait for peers)
    - membership changed but >= min_np    -> RESTART (re-form the job)
    - stable membership                   -> HOLD steady state
    """

    def __init__(self, registry_dir, node_id=None, min_np=1, max_np=None,
                 heartbeat_interval=1.0, timeout=10.0):
        self.registry = os.path.abspath(registry_dir)
        os.makedirs(self.registry, exist_ok=True)
        self.node_id = node_id or f"node-{os.getpid()}"
        self.min_np = int(min_np)
        self.max_np = int(max_np) if max_np else None
        self.heartbeat_interval = heartbeat_interval
        self.timeout = timeout
        self._known = None

    def _path(self, node_id):
        return os.path.join(self.registry, f"{node_id}.beat")

    # -- registration / heartbeat (ref elastic.py:142-190) -------------------
    def register(self):
        self.beat()
        return self

    def beat(self, step=None):
        from ..framework import faults as _faults

        if _faults.fault_point("elastic.beat") is _faults.DROP:
            return  # injected heartbeat loss: peers see this node die
        rec = {"node": self.node_id, "ts": time.time()}
        if step is not None:
            # step-progress watermark: the gang supervisor's hang
            # detection reads this to tell "alive but stuck" from
            # "alive and advancing"
            rec["step"] = int(step)
        tmp = self._path(self.node_id) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, self._path(self.node_id))

    def deregister(self):
        try:
            os.remove(self._path(self.node_id))
        except FileNotFoundError:
            pass

    # -- liveness ------------------------------------------------------------
    def live_nodes(self):
        now = time.time()
        live = []
        for name in os.listdir(self.registry):
            if not name.endswith(".beat"):
                continue
            p = os.path.join(self.registry, name)
            try:
                with open(p) as f:
                    rec = json.load(f)
            except (OSError, ValueError):
                continue
            age = now - rec.get("ts", 0)
            if age <= self.timeout:
                live.append(rec["node"])
            elif age > 3 * self.timeout:
                # sweep long-dead registrations so the registry dir does
                # not grow forever across job generations (a revived node
                # simply re-beats)
                try:
                    os.remove(p)
                except OSError:
                    pass
        return sorted(live)

    def records(self):
        """{node_id: beat record} for every parseable registration —
        the gang supervisor's raw view (liveness judgement is the
        caller's; torn/half-written files are simply skipped)."""
        out = {}
        for name in os.listdir(self.registry):
            if not name.endswith(".beat"):
                continue
            try:
                with open(os.path.join(self.registry, name)) as f:
                    rec = json.load(f)
            except (OSError, ValueError):
                continue
            out[rec.get("node", name[:-5])] = rec
        return out

    def watch(self):
        """One poll step -> ElasticStatus (ref watch loop elastic.py)."""
        from . import preempt as _preempt

        if _preempt.requested():
            # this node is being preempted: leave the registry so peers
            # observe a membership change and re-form without us
            self.deregister()
            return ElasticStatus.EXIT
        live = self.live_nodes()
        if len(live) < self.min_np:
            self._known = live
            return ElasticStatus.HOLD
        if self.max_np and len(live) > self.max_np:
            live = live[: self.max_np]
        if self._known is None:
            self._known = live
            return ElasticStatus.HOLD
        if live != self._known:
            self._known = live
            return ElasticStatus.RESTART
        return ElasticStatus.HOLD

    def world(self):
        """(rank, world_size) from the STABLE membership snapshotted by
        the last watch() poll — not a live re-read, which could flap
        rank/world between two polls mid-step while a peer's heartbeat
        expires (same max_np truncation the watcher applies; nodes beyond
        the cutoff get rank -1). Before the first poll, falls back to a
        live read."""
        live = self._known if self._known is not None else self.live_nodes()
        if self.max_np:
            live = live[: self.max_np]
        rank = live.index(self.node_id) if self.node_id in live else -1
        return rank, len(live)
