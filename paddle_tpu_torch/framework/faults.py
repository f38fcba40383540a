"""Deterministic fault-injection harness (counterpart of
paddle_tpu/framework/faults.py, with the same spec grammar, actions,
environment variable and names).

A fault point is a named site the runtime passes through; faults fire
deterministically by occurrence index, so recovery tests can assert
bitwise-identical loss trajectories instead of "it eventually
restarts". The port fires these sites:

    checkpoint.io             each checkpoint write attempt (retry target)
    checkpoint.before_commit  after arrays+manifest land in ckpt-N.tmp,
                              before the atomic directory rename
    checkpoint.after_commit   after the rename; payload = committed dir
    train.batch               each Engine.train_batch; payload = the
                              host batch {"inputs": ..., "labels": ...}
    preempt.poll              each preemption poll (step boundary)
    elastic.beat              each heartbeat write (drop target)
    dist.allreduce            each eager all-reduce, before the transport
                              (delay past FLAGS_dist_timeout_s = the
                              deterministic CollectiveTimeoutError path)
    dist.barrier              each eager barrier, including the gang
                              checkpoint commit barrier
    gang.heartbeat            each gang worker heartbeat+watermark write
                              (drop = supervisor sees the rank stall)
    gang.restart              each coordinated gang restart, after the
                              teardown and before the respawn
    serving.*                 the serving sites, fired by
                              serving/queueing.py, batcher.py,
                              paging.py, kvstore.py, engine.py,
                              fleet.py and rollout.py (see `SITES` for
                              each)

The reference's other sites (``serving.shard_step``, the p2p mailbox's
``dist.p2p_*``, ps, rec) join `SITES` as their modules are ported.
`fault_point` refuses to fire for an unregistered site that no active
spec names.

Faults are scheduled programmatically::

    with faults.inject("checkpoint.before_commit@1:raise"):
        ...   # first save attempt dies between write and commit

or across process boundaries via the env var ``PADDLE_TPU_FAULTS``
(semicolon-separated specs, read once at first use), the reference's
name, so one chaos schedule drives either package.

Spec grammar: ``site[tag]@occurrence:action[:arg]`` where the optional
``[tag]`` pins the spec to one tagged firer of a shared site (tagged
specs count occurrences per tag, untagged specs per site) and
occurrence is a 1-based hit index (``3``), an inclusive range
(``2-5``, open ``3-``), or ``*``; actions:

    crash        os._exit(137) — ungraceful death at the exact point
    raise        raise FaultError (in-process tests)
    ioerror      raise OSError (exercises retry_with_backoff paths)
    delay:<s>    sleep s seconds (slow I/O)
    nan          return the payload with float leaves poisoned to NaN
    corrupt      truncate the largest array file under payload (a ckpt
                 dir)
    drop         return the DROP sentinel (caller skips its action)

Every fire bumps ``monitor`` counter ``faults.<site>``.
"""

from __future__ import annotations

import os
import threading
import time

from . import monitor

__all__ = ["FaultError", "DROP", "SITES", "fault_point", "inject",
           "reset", "parse_spec", "corrupt_leaf", "ChaosSchedule"]

#: every fault site the port fires (site -> where it fires).
#: `fault_point` raises on an unregistered site, so a renamed site
#: cannot silently turn a chaos test into a clean run, and the audit
#: test (tests/test_torch_faults.py) fails when a registered site loses
#: its tier-1 coverage.
SITES = {
    "checkpoint.io": "each checkpoint write attempt",
    "checkpoint.before_commit": "after tmp write, before atomic rename",
    "checkpoint.after_commit": "after the rename; payload = ckpt dir",
    "train.batch": "each Engine.train_batch",
    "preempt.poll": "each preemption poll (step boundary)",
    "elastic.beat": "each elastic heartbeat write",
    "dist.allreduce": "each eager all-reduce before the transport "
                      "(delay eats the FLAGS_dist_timeout_s budget)",
    "dist.barrier": "each eager barrier / gang ckpt commit barrier",
    "gang.heartbeat": "each gang worker heartbeat+watermark write "
                      "(drop = the supervisor sees this rank stall)",
    "gang.restart": "each coordinated gang restart, after teardown "
                    "and before the respawn",
    "serving.submit": "each admission attempt (drop = shed as a full "
                      "queue would)",
    "serving.dequeue": "each queue pop by the batcher or decode engine",
    "serving.batch": "each dynamic-batcher flush (raise fails every "
                     "member)",
    "serving.step": "each continuous-batching decode step (raise fails "
                    "every in-flight request, the engine stays up)",
    "serving.alloc_block": "each physical KV-block allocation",
    "serving.cow_split": "before each copy-on-write block copy",
    "serving.draft": "before each speculative draft phase (a fault "
                     "degrades the round to plain decode)",
    "serving.verify": "before each speculative verify step",
    "serving.dequant": "each decode step of an int8-frozen engine, "
                       "before the step",
    "serving.w8a8": "each decode step of a w8a8 engine before the "
                    "activation-quant head (a fault degrades that step "
                    "to the weights-only head, leak-free)",
    "serving.spill": "each evicted-KV-block spill append to the SSD "
                     "tier, before the record write (a fault loses "
                     "durability, never blocks)",
    "serving.kv_restore": "each KV-block restore from a spilled record "
                          "(tag = engine name; all-or-nothing, falls "
                          "back to re-prefill)",
    "serving.kv_migrate": "each KV-block adoption of a migrated prefix "
                          "(tag = adopting engine name; all-or-nothing)",
    "serving.adapter_swap": "each adapter-bank hot-swap, before any "
                            "mutation (tag = engine name; the old bank "
                            "keeps serving bitwise)",
    "serving.replica_step": "each decode step of a supervised (fleet) "
                            "engine, tag = replica name (raise = step "
                            "error, delay = a hang the watchdog sees)",
    "serving.replica_heartbeat": "each supervised engine loop heartbeat, "
                                 "tag = replica name (raise kills the "
                                 "engine thread: a crash)",
    "serving.route": "each fleet Router dispatch attempt (raise / drop = "
                     "a retriable routing failure)",
    "serving.replay": "each failover replay of a dead replica's request",
    "serving.scale_up": "each ReplicaSet.add_replica before the build "
                        "(tag = replica name)",
    "serving.scale_down": "each ReplicaSet.remove_replica before the "
                          "drain (tag = replica name)",
    "serving.drain": "each drained-victim eviction attempt (tag = replica "
                     "name; raise = retried at the next poll)",
    "serving.affinity": "each prefix-affinity routing decision (raise = "
                        "that decision falls back to least-loaded)",
    "serving.admit_tenant": "each tenant admission decision in the "
                            "TenantFairQueue (tag = tenant; drop = a "
                            "budget shed)",
    "serving.canary": "before the canary replica's gate evaluation (tag = "
                      "replica name)",
    "serving.rollout_load": "each weight-registry checkpoint-dir load",
    "serving.rollback": "each rollout rollback attempt (tag = version)",
}


class FaultError(RuntimeError):
    """Raised by the 'raise' action (deliberately NOT an OSError so
    checkpoint retry loops do not swallow injected crashes)."""


#: sentinel returned by `fault_point` when a 'drop' fault fires
DROP = object()

_lock = threading.Lock()
_specs: list = []            # active FaultSpec list (env + injected)
_hits: dict = {}             # site -> number of times the point was hit
_env_loaded = False


class FaultSpec:
    def __init__(self, site, lo, hi, action, arg=None, tag=None):
        self.site = site
        self.lo = lo          # 1-based inclusive
        self.hi = hi          # inclusive; None = open
        self.action = action
        self.arg = arg
        self.tag = tag        # None = any firer of the site

    def matches_occ(self, hit):
        if self.lo is None:   # '*'
            return True
        return hit >= self.lo and (self.hi is None or hit <= self.hi)

    def matches(self, site, hit):
        return site == self.site and self.matches_occ(hit)

    def __repr__(self):
        occ = "*" if self.lo is None else (
            str(self.lo) if self.hi == self.lo else
            f"{self.lo}-{'' if self.hi is None else self.hi}")
        arg = f":{self.arg}" if self.arg is not None else ""
        tag = f"[{self.tag}]" if self.tag is not None else ""
        return f"{self.site}{tag}@{occ}:{self.action}{arg}"


def parse_spec(text):
    """``site[tag]@occ:action[:arg]`` -> FaultSpec."""
    site, _, rest = text.strip().partition("@")
    occ, _, act = rest.partition(":")
    if not site or not occ or not act:
        raise ValueError(f"bad fault spec {text!r} "
                         "(want site[tag]@occurrence:action[:arg])")
    tag = None
    if site.endswith("]") and "[" in site:
        site, _, tag = site[:-1].partition("[")
    action, _, arg = act.partition(":")
    if occ == "*":
        lo = hi = None
    elif "-" in occ:
        a, b = occ.split("-", 1)
        lo, hi = int(a), (int(b) if b else None)
    else:
        lo = hi = int(occ)
    return FaultSpec(site, lo, hi, action, arg or None, tag=tag)


def _load_env():
    global _env_loaded
    if _env_loaded:
        return
    with _lock:
        if _env_loaded:
            return
        raw = os.environ.get("PADDLE_TPU_FAULTS", "")
        for part in raw.split(";"):
            if part.strip():
                _specs.append(parse_spec(part))
        _env_loaded = True


def reset(site=None):
    """Zero hit counters (one site — including its per-tag counters —
    or all). inject() does this for its own sites so occurrence indices
    are test-local and deterministic."""
    with _lock:
        if site is None:
            _hits.clear()
        else:
            for key in [k for k in _hits
                        if k == site
                        or (isinstance(k, tuple) and k[0] == site)]:
                del _hits[key]


class inject:
    """Context manager activating fault specs for its dynamic extent."""

    def __init__(self, *specs, reset_counters=True):
        self._specs = [parse_spec(s) if isinstance(s, str) else s
                       for s in specs]
        self._reset = reset_counters

    def __enter__(self):
        _load_env()
        with _lock:
            _specs.extend(self._specs)
        if self._reset:
            for s in self._specs:
                reset(s.site)
        return self

    def __exit__(self, *exc):
        with _lock:
            for s in self._specs:
                try:
                    _specs.remove(s)
                except ValueError:
                    pass
        return False


def _poison_nan(payload):
    """`payload` with every floating leaf (numpy array, torch tensor on
    its own device, Python float) replaced by NaNs of its shape and
    dtype, walking lists, tuples and dicts; other leaves (integer ids,
    labels) pass through untouched."""
    import numpy as np
    import torch

    if isinstance(payload, dict):
        return {k: _poison_nan(v) for k, v in payload.items()}
    if isinstance(payload, (list, tuple)):
        return type(payload)(_poison_nan(v) for v in payload)
    if isinstance(payload, torch.Tensor):
        return torch.full_like(payload, float("nan")) \
            if payload.is_floating_point() else payload
    if isinstance(payload, np.ndarray):
        return np.full_like(payload, np.nan) \
            if np.issubdtype(payload.dtype, np.floating) else payload
    if isinstance(payload, float):
        return float("nan")
    return payload


def corrupt_leaf(path):
    """Truncate the largest ARRAY file under `path` (a checkpoint
    directory written by `distributed.checkpoint`, whose leaves are
    ``.npy`` files under ``d/``) to half its size: the
    'truncate-a-leaf' corruption, aimed at array data so that it
    exercises the checksum / restore path rather than a metadata parse
    error. Falls back to the largest file overall."""
    victim, size = None, -1
    any_victim, any_size = None, -1
    for root, _dirs, files in os.walk(path):
        for name in files:
            p = os.path.join(root, name)
            try:
                s = os.path.getsize(p)
            except OSError:
                continue
            if s > any_size:
                any_victim, any_size = p, s
            if name.endswith(".npy") and s > size:
                victim, size = p, s
    if victim is None:
        victim, size = any_victim, any_size
    if victim is None:
        raise FileNotFoundError(f"no files to corrupt under {path}")
    with open(victim, "r+b") as f:
        f.truncate(max(size // 2, 1))
    return victim


def fault_point(site, payload=None, tag=None):
    """Pass through a named fault site.

    `tag` names this particular firer of a shared site: tagged specs
    match only their tag's own occurrence count, untagged specs the
    site-global count.

    Returns `payload` (possibly transformed by a 'nan' fault), or the
    DROP sentinel when a 'drop' fault fires. May raise, sleep, or exit
    the process depending on the scheduled action.
    """
    _load_env()
    with _lock:
        if not _specs:
            return payload  # zero-cost when nothing is scheduled
        if site not in SITES and not any(s.site == site for s in _specs):
            # A spec that names the site explicitly is its own audit
            # trail (tests exercise the scheduling machinery through
            # ad-hoc sites); an unregistered site nobody asked for is
            # a typo'd or undeclared production fault point.
            raise ValueError(
                f"fault_point fired for unregistered site {site!r} — "
                "add it to faults.SITES (and a tier-1 test) so chaos "
                "schedules stay auditable")
        _hits[site] = hit = _hits.get(site, 0) + 1
        thit = None
        if tag is not None:
            key = (site, tag)
            _hits[key] = thit = _hits.get(key, 0) + 1
        matched = []
        for s in _specs:
            if s.site != site:
                continue
            if s.tag is None:
                if s.matches_occ(hit):
                    matched.append(s)
            elif tag is not None and s.tag == tag and s.matches_occ(thit):
                matched.append(s)
    for spec in matched:
        monitor.stat_add(f"faults.{site}")
        try:  # black-box the firing (lazy import: faults must stay leaf)
            from .. import observe

            observe.flight.note("fault", site=site, hit=hit,
                                action=spec.action)
            if spec.action == "crash":
                # last chance to persist the ring: os._exit skips every
                # atexit/finally a normal unwind would run
                observe.flight.dump(f"fault-crash:{site}")
        except Exception:
            pass
        if spec.action == "crash":
            os._exit(137)
        elif spec.action == "raise":
            raise FaultError(f"injected fault at {site} (hit {hit})")
        elif spec.action == "ioerror":
            raise OSError(f"injected I/O error at {site} (hit {hit})")
        elif spec.action == "delay":
            time.sleep(float(spec.arg or 0.1))
        elif spec.action == "nan":
            payload = _poison_nan(payload)
        elif spec.action == "corrupt":
            corrupt_leaf(payload)
        elif spec.action == "drop":
            return DROP
        else:
            raise ValueError(f"unknown fault action {spec.action!r}")
    return payload


class ChaosSchedule(inject):
    """`inject` that can certify its own delivery.

    A chaos test schedules a scripted fault sweep, runs the workload,
    then calls `verify()` to assert every *finite* spec actually fired
    exactly as many times as planned — catching the silent failure
    where a fault point was renamed (or never reached) and the "chaos"
    test quietly certified a clean run. Open-ended specs (`@*`, `@3-`)
    are excluded from the plan; `fired()` still reports their sites'
    totals.
    """

    def __enter__(self):
        super().__enter__()
        self._base = {site: monitor.stat_get(f"faults.{site}")
                      for site in {s.site for s in self._specs}}
        return self

    def fired(self):
        """{site: fires since __enter__} over this schedule's sites."""
        return {site: monitor.stat_get(f"faults.{site}") - base
                for site, base in self._base.items()}

    def planned(self):
        """{site: expected fires} summed over finite occurrence windows."""
        plan: dict = {}
        for s in self._specs:
            if s.lo is None or s.hi is None:
                continue          # open-ended: no finite plan
            plan[s.site] = plan.get(s.site, 0) + (s.hi - s.lo + 1)
        return plan

    def verify(self):
        """Assert fired == planned per site; returns the fired dict."""
        fired = self.fired()
        for site, want in self.planned().items():
            got = fired.get(site, 0)
            if got != want:
                raise AssertionError(
                    f"chaos schedule under-delivered at {site}: "
                    f"planned {want} fires, observed {got}")
        return fired
