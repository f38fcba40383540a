"""Zero-downtime model rollout: versioned weights, rolling canary
upgrades, and bitwise auto-rollback across a live replica fleet
(counterpart of paddle_tpu/serving/rollout.py, same names and phase
machine).

The fleet already owns every primitive a rolling upgrade needs
(drain-then-evict membership, restart, first-wins failover replay,
SLO-windowed autoscaling, deterministic chaos), so this module only
adds the coordination:

`WeightVersion`
    One immutable weight set: flat ``name -> tensor`` values + a
    monotonically increasing version id + a per-leaf sha256 manifest.
    Loadable from the port's `distributed/checkpoint.py` dirs with
    their READABLE/checksum verification — a torn or tampered dir is
    rejected at the registry, before any replica can see it.

`WeightRegistry`
    The version store. `load_dir()` ingests a committed checkpoint
    dir (fault site ``serving.rollout_load``); `watch()` polls a
    trainer's checkpoint directory and picks up new committed
    ``ckpt-N`` dirs as versions; `begin`/`commit`/`abort` pin the
    previous version for rollback until the rollout commits, after
    which it is retired (pinned replays against it fail retriable —
    `VersionRetiredError` — instead of re-decoding on new weights).

`RolloutController`
    Upgrades a live ReplicaSet one replica at a time behind the
    existing drain→rebuild path (`_build` under `_build_lock`). Phase
    machine: **canary** (one
    replica takes the new version and must pass the golden-prompt
    bitwise gate and an SLO burn gate over the autoscaler's windowed
    p99) → **waves** of `wave_size` replicas with a sustain period
    between waves → **commit** (retarget + retire previous). Any gate
    failure, or `rollback()`, drains upgraded replicas back to the
    pinned previous version (fault site ``serving.rollback``).

The golden gate is the bitwise teeth: reference digests come from an
eager full-re-forward greedy chain over the new values (no KV cache, no
paging), so corrupt or mis-activated weights can never self-certify —
the canary's served decode must match them exactly. On a card the
chain's matmuls run at other row counts than the engine's step, so a
greedy pick at a near-tie may flip there (a gate refusal, never a
silent pass).
"""

from __future__ import annotations

import hashlib
import os
import threading
import time

import numpy as np
import torch
from torch.func import functional_call

from ..framework import faults, monitor
from ..framework.flags import flag

__all__ = ["WeightVersion", "WeightRegistry", "RolloutController",
           "RolloutError", "RolloutGateError", "golden_digests",
           "golden_logits", "artifact_digest"]


class RolloutError(RuntimeError):
    """A rollout phase failed (gate, timeout, or operator abort)."""


class RolloutGateError(RolloutError):
    """The canary/sustain gate rejected the new version."""


def _digest_ids(ids):
    a = np.ascontiguousarray(np.asarray(ids, np.int32))
    return hashlib.sha256(a.tobytes()).hexdigest()


def artifact_digest(manifest):
    """One sha256 identifying a whole artifact: the hash of its sorted
    per-leaf digest lines. Two artifacts (weight sets, adapter banks)
    are bitwise-identical iff their artifact digests match — the
    identity key the multi-tenant `ArtifactCatalog` (serving/tenancy.py)
    and `WeightVersion.digest` share."""
    h = hashlib.sha256()
    for name in sorted(manifest):
        h.update(f"{name}={manifest[name]}\n".encode())
    return h.hexdigest()


class _Chain(torch.nn.Module):
    """One padded row's eager full re-forward: the trunk, then (with
    `project`) the model's own head on the last position only."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, ids, last, project):
        h = self.model.gpt(ids)[:, last]
        return self.model.logits(h) if project else h


def _on_device(values, device):
    """`values` as tensors on `device` (numpy leaves converted; a leaf
    already there is not copied)."""
    return {k: torch.as_tensor(v).to(device) for k, v in values.items()}


def golden_logits(model, values, prompt, *, max_new=6):
    """The eager reference chain of one prompt: greedy `max_new` steps,
    each a full re-forward of the sequence padded to the model's
    ``max_seq_len`` (no KV cache, no paging) through a module shell of
    `model` on `values`. Returns (the ids, the f32 logits row behind
    each pick).

    Int8-frozen values (``@scale`` companion leaves present) chain with
    the engine's exact arithmetic: the body runs on
    `quantization.dequantize_state` (the one canonical dequant formula)
    and the tied LM head goes through `dequant_matmul` (kernel B7 on a
    CUDA tensor) on the raw int8 table."""
    from ..ops.quant_ops import dequant_matmul
    from ..quantization import (SCALE_SUFFIX, dequantize_state,
                                is_quantized_state)
    from .engine import module_shell

    dev = model.device
    vals = _on_device(values, dev)
    quantized = is_quantized_state(vals)
    fvals = dequantize_state(vals) if quantized else vals
    head_key = None   # (int8 table, scale) for the tied kernel head
    if quantized and getattr(model.config, "tie_word_embeddings", False):
        for k in vals:
            if k.endswith("word_embeddings.weight") and \
                    (k + SCALE_SUFFIX) in vals:
                head_key = (k, k + SCALE_SUFFIX)
                break
    chain = _Chain(module_shell(model)).eval()
    params = {"model." + k: v for k, v in fvals.items()}
    pad = model.config.max_seq_len
    toks = [int(t) for t in prompt]
    if len(toks) + max_new > pad:
        raise ValueError(f"golden prompt of {len(toks)} + {max_new} new "
                         f"tokens exceeds max_seq_len {pad}")
    rows = []
    with torch.no_grad():
        for _ in range(max_new):
            ids = torch.zeros((1, pad), dtype=torch.int64, device=dev)
            ids[0, :len(toks)] = torch.as_tensor(toks, dtype=torch.int64)
            out = functional_call(chain, params,
                                  (ids, len(toks) - 1, head_key is None))
            if head_key is not None:
                out = dequant_matmul(out, vals[head_key[0]],
                                     vals[head_key[1]])
            row = out.float()[0].cpu().numpy()
            rows.append(row)
            toks.append(int(row.argmax()))
    return toks, rows


def golden_digests(model, values, prompts, *, max_new=6):
    """Reference digests for the canary gate: `golden_logits`'s eager
    greedy chain over `values` for each prompt, hashed — independent of
    everything the canary could get wrong (paging, chunked prefill, the
    slot batch)."""
    out = {}
    for pi, prompt in enumerate(prompts):
        toks, _ = golden_logits(model, values, prompt, max_new=max_new)
        out[f"p{pi}"] = _digest_ids(toks)
    return out


class WeightVersion:
    """One immutable weight set: flat ``name -> array`` values, a
    monotonically increasing id, and a per-leaf sha256 manifest.
    `golden` holds the precomputed golden-prompt digests once
    `RolloutController.ensure_golden` (or the caller) fills them.

    Quantized artifacts are first-class versions: values frozen by
    `quantization.quantize_state_int8` carry int8 tables plus
    ``@scale`` companion leaves, all covered by the same per-leaf
    sha256 manifest, and `quant` records the ``{leaf: {dtype, scale}}``
    summary (auto-derived from the companions when not given). A
    rollout to — or bitwise rollback from — an int8 version goes
    through the exact same drain→rebuild path as a float one; the
    engine adopts a pre-frozen values dict as-is (each replica copies
    it onto its device when the version lives elsewhere)."""

    def __init__(self, version, values, *, manifest=None, source=None,
                 golden=None, quant=None, act_schema=None):
        from ..distributed import checkpoint as ckpt
        from ..quantization import SCALE_SUFFIX

        self.version = int(version)
        self.values = dict(values)
        self.manifest = dict(manifest) if manifest else \
            ckpt.leaf_digests(self.values)
        self.digest = artifact_digest(self.manifest)
        self.source = source
        self.golden = dict(golden) if golden else None
        if quant is None:
            scales = [k for k in self.values if k.endswith(SCALE_SUFFIX)]
            if scales:
                quant = {}
                for sk in scales:
                    leaf = sk[:-len(SCALE_SUFFIX)]
                    v = self.values[leaf]
                    quant[leaf] = {
                        "dtype": (str(v.dtype).replace("torch.", "")
                                  if isinstance(v, torch.Tensor)
                                  else str(np.asarray(v).dtype)),
                        "scale": float(self.values[sk]),
                    }
        self.quant = dict(quant) if quant else None
        # w8a8 artifacts additionally record the activation-quant
        # schema (per-tensor dtype + frozen scales by site). Golden
        # digests stay weights-only — activations quantize in the step at
        # serve time against these scales, so the quant summary (not
        # the values manifest) is where the schema is certified.
        self.act_schema = dict(act_schema) if act_schema else None
        if self.act_schema is not None and self.quant is not None:
            self.quant = dict(self.quant)
            self.quant["__activations__"] = dict(self.act_schema)

    @classmethod
    def from_model(cls, model, version=0):
        values = {k: v.detach() for k, v in model.state_dict().items()}
        return cls(version, values, source="model")

    @classmethod
    def quantized_from(cls, wv, version, act_scales=None):
        """Freeze an existing float version's 2-D weights to int8 (+
        ``@scale`` companions) as a NEW version with its own manifest:
        the artifact the fleet serves is the artifact the registry
        certifies, not its float parent.

        `act_scales` ({site: float} — e.g. the engine's frozen head
        activation scale) marks the artifact w8a8: the activation-quant
        schema is recorded in the quant summary (per-tensor int8,
        scale = representable abs-max, q = clip(round(x/s*127))) so the
        version rolls through the bitwise canary gate with its serving
        contract attached, like the weights-only ones."""
        from ..quantization import quantize_state_int8

        schema = None
        src = f"int8(v{wv.version})"
        if act_scales:
            schema = {
                "dtype": "int8",
                "granularity": "per_tensor",
                "scales": {str(k): float(v)
                           for k, v in dict(act_scales).items()},
            }
            src = f"w8a8(v{wv.version})"
        return cls(version, quantize_state_int8(wv.values),
                   source=src, act_schema=schema)

    def __repr__(self):
        q = ", int8" if self.quant else ""
        return (f"WeightVersion(v{self.version}, {len(self.values)} leaves"
                f"{q}, source={self.source!r})")


class WeightRegistry:
    """Versioned weight store for a serving fleet.

    Version ids only ever grow; a retired id never comes back. During a
    rollout the previous version stays pinned (`previous`) so rollback
    always has a target; `commit()` retires it and notifies subscribers
    (e.g. a spill store's fence, `KVSpillStore.attach_registry`) of the
    new current version.

    `load_dir` restores a checkpoint dir against `template` (default:
    the model's own state): pass an int8-frozen template to ingest
    int8 artifacts. Restored leaves land on the template leaves'
    device.
    """

    def __init__(self, model=None, *, template=None):
        if model is None and template is None:
            raise ValueError("WeightRegistry needs a model or a template")
        self._lock = threading.RLock()
        self.versions: dict = {}
        self.retired: list = []
        self.current = None
        self.previous = None       # rollback pin while a rollout runs
        self._high = -1            # highest id ever seen (monotonicity)
        self._skip: set = set()    # watch(): steps that failed to load
        self._subs: list = []
        self._watch_stop = None
        self._watch_thread = None
        if model is not None:
            base = WeightVersion.from_model(model)
            self.versions[0] = base
            self.current = 0
            self._high = 0
            if template is None:
                template = base.values
        self._template = dict(template)

    # -- store ---------------------------------------------------------------

    def get(self, version):
        with self._lock:
            if version not in self.versions:
                raise KeyError(f"no weight version {version} "
                               f"(live: {sorted(self.versions)}, "
                               f"retired: {self.retired})")
            return self.versions[version]

    def is_live(self, version):
        with self._lock:
            return version in self.versions

    def latest(self):
        with self._lock:
            return max(self.versions) if self.versions else None

    def subscribe(self, fn):
        """Call ``fn(weight_version)`` on every commit (the version
        boundary downstream consumers swap at)."""
        self._subs.append(fn)

    def add(self, wv):
        """Register an in-memory `WeightVersion` (tests / handcrafted
        versions); same monotonic-id rule as `load_dir`."""
        with self._lock:
            if wv.version <= self._high:
                raise ValueError(
                    f"version ids are monotonic: {wv.version} <= "
                    f"high-water {self._high}")
            self.versions[wv.version] = wv
            self._high = wv.version
            return wv

    # -- checkpoint ingestion ------------------------------------------------

    def load_dir(self, path, *, version=None, golden=None):
        """Ingest one committed checkpoint dir as a new version.

        Reuses the port's CheckpointManager READABLE semantics (a committed
        dir always holds the manifest/metadata; staging ``.tmp`` dirs
        and torn writes never qualify) and `load_state`'s per-leaf
        sha256 verification — a tampered leaf raises and the registry
        (and therefore the fleet) never sees the bad version. Fault
        site ``serving.rollout_load`` fires per ingestion attempt."""
        from ..distributed import checkpoint as ckpt

        faults.fault_point("serving.rollout_load", path)
        norm = os.path.normpath(path)
        base, parent = os.path.basename(norm), os.path.dirname(norm) or "."
        readable = False
        if base.startswith("ckpt-"):
            try:
                step = int(base.split("-", 1)[1])
            except ValueError:
                step = None
            if step is not None:
                readable = ckpt.CheckpointManager(parent).is_readable(step)
        else:
            readable = os.path.isdir(norm) and (
                os.path.exists(os.path.join(norm, ckpt.MANIFEST_NAME))
                or os.path.exists(os.path.join(norm, ckpt.META_NAME)))
        if not readable:
            monitor.stat_add("fleet.rollout_load_failures")
            raise ValueError(
                f"{path} is not a committed checkpoint dir (torn write, "
                "staging .tmp, or missing manifest/metadata) — refusing "
                "to register it as a weight version")
        with self._lock:
            vid = version if version is not None else self._high + 1
            if vid <= self._high:
                raise ValueError(
                    f"version ids are monotonic: {vid} <= high-water "
                    f"{self._high}")
        try:
            # per-leaf sha256 verification against the saved manifest
            restored = ckpt.load_state(norm, self._template, verify=True)
        except Exception:
            monitor.stat_add("fleet.rollout_load_failures")
            raise
        saved = ckpt.load_manifest(norm)
        manifest = {k: v["sha256"] for k, v in saved.items()} if saved \
            else None
        wv = WeightVersion(vid, restored, manifest=manifest, source=norm,
                           golden=golden)
        with self._lock:
            if wv.version <= self._high:   # raced another load
                raise ValueError(
                    f"version ids are monotonic: {wv.version} <= "
                    f"high-water {self._high}")
            self.versions[wv.version] = wv
            self._high = wv.version
        monitor.stat_add("fleet.rollout_loads")
        return wv

    def watch(self, directory, *, poll_s=0.25, on_version=None):
        """Background poller: pick up new committed ``ckpt-N`` dirs
        from a live trainer's checkpoint directory (version id = the
        checkpoint step). Uncommitted staging dirs are invisible; a
        dir that fails checksum verification is skipped for good."""
        from ..distributed import checkpoint as ckpt

        mgr = ckpt.CheckpointManager(directory)
        stop = threading.Event()

        def loop():
            while True:
                self.poll_dir(mgr, on_version)
                if stop.wait(poll_s):
                    return

        self.stop_watch()
        self._watch_stop = stop
        self._watch_thread = threading.Thread(
            target=loop, name="rollout-watch", daemon=True)
        self._watch_thread.start()
        return self

    def poll_dir(self, mgr, on_version=None):
        """One watch pass over a CheckpointManager's directory."""
        found = []
        for step in mgr.readable_steps():
            with self._lock:
                if step <= self._high or step in self._skip:
                    continue
            try:
                wv = self.load_dir(
                    os.path.join(mgr.directory, f"ckpt-{step}"),
                    version=step)
            except Exception:  # noqa: BLE001 — bad dirs never re-tried
                self._skip.add(step)
                continue
            found.append(wv)
            if on_version is not None:
                try:
                    on_version(wv)
                except Exception:  # noqa: BLE001 — observer-only
                    monitor.stat_add("fleet.rollout_sub_errors")
        return found

    def stop_watch(self):
        if self._watch_stop is not None:
            self._watch_stop.set()
            self._watch_thread.join(timeout=5.0)
            self._watch_stop = self._watch_thread = None

    # -- rollout transaction -------------------------------------------------

    def begin(self, target):
        """Start a rollout toward `target`: pin the current version as
        the rollback target until commit/abort."""
        with self._lock:
            if target not in self.versions:
                raise KeyError(f"no weight version {target}")
            self.previous = self.current

    def commit(self, target):
        """Make `target` current, retire the pinned previous version,
        and notify subscribers (the version boundary)."""
        with self._lock:
            if target not in self.versions:
                raise KeyError(f"no weight version {target}")
            prev = self.previous
            self.current = target
            self.previous = None
            if prev is not None and prev != target:
                self._retire(prev)
            wv = self.versions[target]
            subs = list(self._subs)
        for fn in subs:
            try:
                fn(wv)
            except Exception:  # noqa: BLE001 — observer-only
                monitor.stat_add("fleet.rollout_sub_errors")

    def abort(self, target=None):
        """Abandon a begun rollout: unpin, and retire the (bad) target
        so it can never be rolled to again."""
        with self._lock:
            self.previous = None
            if target is not None and target != self.current \
                    and target in self.versions:
                self._retire(target)

    def retire(self, version):
        with self._lock:
            if version == self.current:
                raise ValueError("cannot retire the current version")
            self._retire(version)

    def _retire(self, version):
        if self.versions.pop(version, None) is not None:
            self.retired.append(version)

    def snapshot(self):
        with self._lock:
            return {"current": self.current, "previous": self.previous,
                    "live": sorted(self.versions),
                    "retired": list(self.retired)}


class RolloutController:
    """Drives a rolling upgrade of a live Router fleet.

    Attaches itself as ``router.rollout`` (the same pattern the
    Autoscaler uses), so `/v1/version` and `Router.snapshot()` can see
    rollout state. One rollout at a time; `roll_to(version)` runs the
    canary → waves → commit machine and auto-rolls-back on any gate
    failure. All replica mutation goes through the ReplicaSet's
    drain→rebuild path, so in-flight requests always finish on the
    weights they started on.
    """

    def __init__(self, router, registry, *, canary_secs=None,
                 sustain_s=None, wave_size=None, golden_prompts=None,
                 golden_max_new=6, slo_p99_ms=None, window=64,
                 poll_s=0.01, replica_timeout_s=120.0,
                 gate_timeout_s=60.0):
        self.router = router
        self.registry = registry
        self.canary_secs = flag("FLAGS_rollout_canary_secs") \
            if canary_secs is None else canary_secs
        self.sustain_s = self.canary_secs if sustain_s is None \
            else sustain_s
        self.wave_size = max(int(flag("FLAGS_rollout_wave_size")
                                 if wave_size is None else wave_size), 1)
        self.golden_max_new = golden_max_new
        self.slo_p99_ms = flag("FLAGS_fleet_slo_p99_ms") \
            if slo_p99_ms is None else slo_p99_ms
        self.window = window
        self.poll_s = poll_s
        self.replica_timeout_s = replica_timeout_s
        self.gate_timeout_s = gate_timeout_s
        self._given_prompts = golden_prompts
        self._prompt_cache = None
        self.state = "idle"
        self.target = None
        self.error = None
        self.history: list = []
        self._abort_reason = None
        self._lock = threading.Lock()   # one rollout at a time
        router.rollout = self
        # generation-fence the SSD KV spill tier (serving/kvstore.py):
        # every registry commit fences spilled records of the retired
        # versions, so a session can never resume attention state
        # computed under weights the rollout replaced
        fenced = set()
        for r in router.replica_set.replicas:
            store = getattr(r.engine, "spill_store", None)
            if store is not None and id(store) not in fenced:
                fenced.add(id(store))
                store.attach_registry(registry)

    # -- public API ----------------------------------------------------------

    def roll_to(self, version, *, block=True):
        """Upgrade the fleet to `version`. Returns True on commit,
        False on auto-rollback (see `.state`/`.error`). With
        ``block=False`` runs in a background thread and returns it."""
        wv = self.registry.get(version)
        if block:
            return self._run(wv)
        t = threading.Thread(target=self._run, args=(wv,),
                             name=f"{self.router.name}-rollout",
                             daemon=True)
        t.start()
        return t

    def rollback(self, reason="operator rollback"):
        """Abort the in-progress rollout; the running `roll_to` drains
        every upgraded replica back to the pinned previous version."""
        if self.state in ("idle", "committed", "rolled_back", "failed"):
            raise RolloutError(f"no rollout in progress (state "
                               f"{self.state!r})")
        self._abort_reason = reason

    def ensure_golden(self, wv):
        """Precompute `wv.golden` from its own values (eager reference
        chain) — called automatically before the canary, or explicitly
        right after `load_dir` to freeze the digests early. The chain
        runs its own module shell; the build lock keeps it off the
        device while a replica builds."""
        if wv.golden is not None:
            return wv.golden
        rs = self.router.replica_set
        with rs._build_lock:
            wv.golden = golden_digests(rs.model, wv.values,
                                       self._prompts(),
                                       max_new=self.golden_max_new)
        return wv.golden

    def snapshot(self):
        return {"state": self.state, "target": self.target,
                "error": self.error, "registry": self.registry.snapshot(),
                "history": list(self.history)}

    # -- phase machine -------------------------------------------------------

    def _run(self, wv):
        with self._lock:
            rs = self.router.replica_set
            prev = self.registry.get(self.registry.current)
            self.registry.begin(wv.version)
            self.target, self.error = wv.version, None
            self._abort_reason = None
            upgraded = []
            try:
                plan = sorted((r for r in rs.replicas
                               if r.state == "healthy"),
                              key=lambda r: r.index)
                if not plan:
                    raise RolloutError("no healthy replicas to roll")
                self.state = "canary"
                self.ensure_golden(wv)
                canary = plan[0]
                self._upgrade(canary, wv)
                upgraded.append(canary)
                faults.fault_point("serving.canary", tag=canary.name)
                ok, why = self._golden_gate(canary, wv)
                if ok:
                    ok, why = self._slo_gate(self.canary_secs, "canary")
                if not ok:
                    raise RolloutGateError(why)
                rest, w = plan[1:], self.wave_size
                waves = [rest[i:i + w] for i in range(0, len(rest), w)]
                for wi, wave in enumerate(waves):
                    self.state = f"wave-{wi + 1}/{len(waves)}"
                    for r in wave:     # one replica at a time, even
                        self._upgrade(r, wv)   # within a wave
                        upgraded.append(r)
                    self.state = "sustain"
                    ok, why = self._slo_gate(self.sustain_s,
                                             f"wave {wi + 1}")
                    if not ok:
                        raise RolloutGateError(why)
                # stragglers: replicas that were in backoff at planning
                # time, or added by the autoscaler mid-rollout
                self._sweep(wv)
                rs.retarget(wv)
                self.registry.commit(wv.version)
                self.state = "committed"
                monitor.stat_set("fleet.weight_version", wv.version)
                monitor.stat_add("fleet.rollouts")
                self.history.append({"target": wv.version, "ok": True})
                return True
            except Exception as e:  # noqa: BLE001 — any failure rolls back
                self.error = f"{type(e).__name__}: {e}"
                self._rollback(upgraded, prev)
                self.history.append({"target": wv.version, "ok": False,
                                     "error": self.error})
                return False

    def _rollback(self, upgraded, prev):
        """Drain every upgraded replica back to the pinned previous
        version. Fault site ``serving.rollback`` fires per attempt; a
        raise there fails the attempt and it is retried."""
        self.state = "rolling_back"
        monitor.stat_add("fleet.rollbacks")
        rs = self.router.replica_set
        rs.retarget(prev)   # crash-restarts must land on prev, not target
        err = None
        for _ in range(3):
            try:
                faults.fault_point("serving.rollback",
                                   tag=f"v{prev.version}")
                for r in upgraded:
                    self._upgrade(r, prev, abortable=False)
                self._sweep(prev, abortable=False)
                err = None
                break
            except Exception as e:  # noqa: BLE001 — retry the rollback
                err = e
                self.router.metrics.inc("rollback_retries")
        self.registry.abort(self.target)
        monitor.stat_set("fleet.weight_version", self.registry.current or 0)
        if err is not None:
            self.state = "failed"
            self.error = f"{self.error}; rollback failed: {err}"
        else:
            self.state = "rolled_back"

    def _check_abort(self):
        if self._abort_reason is not None:
            reason, self._abort_reason = self._abort_reason, None
            raise RolloutError(reason)

    def _upgrade(self, replica, wv, *, abortable=True):
        """Drive one replica to `wv` through drain→rebuild, riding out
        crashes: a replica that dies mid-drain restarts pinned to its
        assigned target, one that dies before the command comes back
        healthy on its old version and is re-commanded."""
        rs = self.router.replica_set
        deadline = time.monotonic() + self.replica_timeout_s
        while time.monotonic() < deadline:
            if abortable:
                self._check_abort()
            if replica.state == "stopped":
                return   # scaled away mid-rollout: nothing to upgrade
            if replica.state == "healthy":
                if replica.engine.weight_version == wv.version:
                    return
                try:
                    rs.rebuild_replica(replica.name, wv)
                except (KeyError, ValueError):
                    pass   # raced the watchdog; re-check next tick
            time.sleep(self.poll_s)
        raise RolloutError(
            f"replica {replica.name} did not reach weight version "
            f"{wv.version} within {self.replica_timeout_s}s")

    def _sweep(self, wv, *, abortable=True):
        """Converge every non-stopped replica onto `wv` (single-version
        fleet before commit/after rollback)."""
        rs = self.router.replica_set
        deadline = time.monotonic() + self.replica_timeout_s
        while time.monotonic() < deadline:
            if abortable:
                self._check_abort()
            off = [r for r in rs.replicas if r.state != "stopped"
                   and (r.weight_version != wv.version
                        or (r.state == "healthy"
                            and r.engine.weight_version != wv.version))]
            if not off:
                return
            for r in off:
                if r.state == "healthy":
                    try:
                        rs.rebuild_replica(r.name, wv)
                    except (KeyError, ValueError):
                        pass
            time.sleep(self.poll_s)
        raise RolloutError(
            f"fleet did not converge to weight version {wv.version} "
            f"within {self.replica_timeout_s}s")

    # -- gates ---------------------------------------------------------------

    def _prompts(self):
        if self._given_prompts is not None:
            return [tuple(int(t) for t in p) for p in self._given_prompts]
        if self._prompt_cache is None:
            # deterministic pinned prompt set, synthesized from a fixed
            # seed: same model config -> same prompts forever
            vocab = self.router.replica_set.model.config.vocab_size
            n = max(int(flag("FLAGS_rollout_golden_prompts")), 1)
            rng = np.random.RandomState(0xC0DE)
            self._prompt_cache = [
                tuple(int(t) for t in rng.randint(1, vocab, size=5))
                for _ in range(n)]
        return self._prompt_cache

    def _golden_gate(self, canary, wv):
        """Greedy-decode the pinned prompts ON THE CANARY (the real
        serving path: paged KV, the slot step) and compare bitwise
        against the reference digests of the new checkpoint."""
        engine = canary.engine
        if engine is None or engine.weight_version != wv.version:
            return False, f"canary {canary.name} lost its engine"
        want = wv.golden or {}
        got = {}
        for pi, prompt in enumerate(self._prompts()):
            try:
                req = engine.submit(list(prompt),
                                    max_new_tokens=self.golden_max_new,
                                    timeout=self.gate_timeout_s)
                got[f"p{pi}"] = _digest_ids(req.result(self.gate_timeout_s))
            except Exception as e:  # noqa: BLE001 — gate failure
                return False, (f"canary golden decode failed on prompt "
                               f"{pi}: {e}")
        bad = sorted(k for k in want if got.get(k) != want[k])
        if bad or not want:
            self.router.metrics.inc("canary_failures")
            return False, (
                f"golden-prompt digest mismatch on {bad or 'all'} — the "
                "canary's served decode does not match the checkpoint's "
                "reference chain (corrupt/mis-activated weights)")
        return True, None

    def _slo_gate(self, duration, label):
        """Hold the SLO burn gate for `duration`: the autoscaler's own
        freshness-gated windowed p99 must stay under the SLO."""
        from .autoscale import SLOWindow

        slo = SLOWindow(self.router.metrics, window=self.window,
                        freshness_s=max(4.0 * duration, 1.0))
        end = time.monotonic() + duration
        while time.monotonic() < end:
            self._check_abort()
            p99 = slo.p99_s()
            if p99 is not None and p99 * 1e3 > self.slo_p99_ms:
                self.router.metrics.inc("canary_failures")
                return False, (
                    f"SLO burn during {label}: windowed e2e p99 "
                    f"{p99 * 1e3:.1f}ms > {self.slo_p99_ms:g}ms")
            time.sleep(self.poll_s)
        return True, None
