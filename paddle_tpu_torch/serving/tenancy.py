"""Multi-tenant serving: tenant directory, SLO classes, token budgets,
the (model, adapter, version) artifact catalog, and batched-adapter
rollouts (counterpart of paddle_tpu/serving/tenancy.py, same names).

The platform layer over one fleet:

`TenantSpec` / `TenantDirectory`
    One tenant's admission contract — weighted-fair-queueing weight,
    priority class, SLO class (``gold``/``silver``/``bronze`` mapping
    to brownout tiers 2/1/0), and a lazily refilled token-bucket
    budget in tokens/second. `TenantDirectory` resolves names to specs
    (auto-creating defaults from ``FLAGS_tenant_default_budget``) and
    owns the fleet brownout floor: during brownout, tenants whose tier
    is below ``brownout_tier`` shed instead of a global priority floor.

`ArtifactCatalog`
    `WeightRegistry` generalized to *named* artifact lines keyed
    ``(kind, name)`` — e.g. ``("model", "base")`` and
    ``("adapter", "support-bot")`` — each with monotonically increasing
    versions, a per-leaf sha256 manifest, and the whole-artifact
    `rollout.artifact_digest`. Lines roll out independently: committing
    a new adapter version never touches the model line.

`AdapterRollout`
    The canary→wave→commit machinery from `RolloutController` applied
    to the engine's stacked LoRA bank: one healthy replica hot-swaps
    first (``SlotEngine.swap_adapters`` — a step-boundary rebind
    behind fault site ``serving.adapter_swap``), an optional
    probe request certifies it live, then the rest of the fleet swaps
    and the catalog commits. Any failure mid-fleet swaps the OLD bank
    back onto every already-swapped replica — all-or-nothing fleet-wide,
    and a faulted single swap is all-or-nothing per engine (the old
    bank keeps serving bitwise).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..framework.flags import flag
from .rollout import artifact_digest

__all__ = ["DEFAULT_TENANT", "TenantSpec", "TenantDirectory",
           "Artifact", "ArtifactCatalog", "AdapterRollout"]

#: tenant name used when a request carries none
DEFAULT_TENANT = "default"

#: SLO class -> brownout tier (higher survives longer under brownout)
SLO_TIERS = {"bronze": 0, "silver": 1, "gold": 2}


def _host(v):
    """A host numpy array of a tensor or array leaf."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class TenantSpec:
    """One tenant's admission contract.

    ``weight`` scales the deficit-round-robin quantum in
    `TenantFairQueue`; ``priority`` is the default request priority the
    workload generator stamps; ``slo_class`` maps to the brownout tier
    (``gold``=2 / ``silver``=1 / ``bronze``=0); ``budget_tokens_per_s``
    is a token bucket (capacity = rate * ``burst_s``, lazily refilled)
    debited per admission with the request's prompt + decode budget —
    0 means unlimited. Thread-safe: many submitting threads debit one
    bucket."""

    def __init__(self, name, *, weight=1.0, priority=0,
                 slo_class="bronze", slo_p99_ms=None,
                 budget_tokens_per_s=None, burst_s=1.0):
        if slo_class not in SLO_TIERS:
            raise ValueError(
                f"slo_class must be one of {sorted(SLO_TIERS)}, "
                f"got {slo_class!r}")
        if weight <= 0:
            raise ValueError(f"weight must be > 0, got {weight}")
        self.name = str(name)
        self.weight = float(weight)
        self.priority = int(priority)
        self.slo_class = str(slo_class)
        self.tier = SLO_TIERS[self.slo_class]
        self.slo_p99_ms = float(slo_p99_ms) if slo_p99_ms else None
        if budget_tokens_per_s is None:
            budget_tokens_per_s = flag("FLAGS_tenant_default_budget")
        self.budget_tokens_per_s = float(budget_tokens_per_s or 0)
        self.burst_s = float(burst_s)
        self._capacity = self.budget_tokens_per_s * max(self.burst_s,
                                                        1e-3)
        self._tokens = self._capacity
        self._last = time.monotonic()
        self._lock = threading.Lock()

    @property
    def unlimited(self):
        return not self.budget_tokens_per_s

    def _refill(self, now):
        self._tokens = min(
            self._capacity,
            self._tokens + (now - self._last) * self.budget_tokens_per_s)
        self._last = now

    def try_debit(self, tokens):
        """Debit ``tokens`` from the bucket. Returns ``(ok, wait_s)``:
        on success ``(True, 0.0)``; on an empty bucket ``(False, s)``
        where ``s`` is exactly how long the refill needs to cover this
        request — the ``Retry-After`` the HTTP front surfaces."""
        if self.unlimited:
            return True, 0.0
        tokens = float(tokens)
        with self._lock:
            now = time.monotonic()
            self._refill(now)
            if self._tokens >= tokens:
                self._tokens -= tokens
                return True, 0.0
            short = min(tokens, self._capacity) - self._tokens
            return False, max(short / self.budget_tokens_per_s, 1e-3)

    def budget_remaining(self):
        """Tokens currently in the bucket (None when unlimited)."""
        if self.unlimited:
            return None
        with self._lock:
            self._refill(time.monotonic())
            return self._tokens

    def to_dict(self):
        d = {"name": self.name, "weight": self.weight,
             "priority": self.priority, "slo_class": self.slo_class,
             "budget_tokens_per_s": self.budget_tokens_per_s,
             "burst_s": self.burst_s}
        if self.slo_p99_ms is not None:
            d["slo_p99_ms"] = self.slo_p99_ms
        return d


class TenantDirectory:
    """Name -> `TenantSpec` resolution + the fleet brownout floor.

    `resolve` never fails: an unregistered tenant gets a default
    bronze/weight-1 spec with the flag-default budget, so "no tenant
    configured" behaves exactly like the anonymous pre-tenancy world.
    ``brownout_tier`` is the shedding floor the fleet Router consults
    while browned out: tenants with ``spec.tier < brownout_tier`` shed
    (default 1 — bronze sheds, silver and gold ride through)."""

    def __init__(self, tenants=None, *, brownout_tier=1):
        self._specs: dict = {}
        self._lock = threading.Lock()
        self.brownout_tier = int(brownout_tier)
        if isinstance(tenants, dict):
            # {name: TenantSpec | kwargs-dict} mapping form
            for name, t in tenants.items():
                if isinstance(t, TenantSpec):
                    self.register(t)
                else:
                    kw = dict(t)
                    kw.setdefault("name", name)
                    self.register(TenantSpec(**kw))
        else:
            for t in tenants or []:
                if isinstance(t, TenantSpec):
                    self.register(t)
                else:
                    self.register(TenantSpec(**dict(t)))

    def register(self, spec: TenantSpec):
        with self._lock:
            self._specs[spec.name] = spec
        return spec

    def resolve(self, name) -> TenantSpec:
        name = name or DEFAULT_TENANT
        with self._lock:
            spec = self._specs.get(name)
            if spec is None:
                spec = self._specs[name] = TenantSpec(name)
            return spec

    def names(self):
        with self._lock:
            return sorted(self._specs)

    def __contains__(self, name):
        with self._lock:
            return name in self._specs

    def snapshot(self):
        with self._lock:
            return {n: s.to_dict() for n, s in self._specs.items()}


class Artifact:
    """One immutable catalog entry: a ``(kind, name, version)`` triple
    plus its per-leaf sha256 manifest and whole-artifact digest. The
    payload (``values``) rides along for in-process rollouts but the
    identity is the digest — two artifacts are bitwise-equal iff their
    digests match."""

    def __init__(self, kind, name, version, manifest, *, values=None,
                 meta=None):
        self.kind = str(kind)
        self.name = str(name)
        self.version = int(version)
        self.manifest = dict(manifest)
        self.digest = artifact_digest(self.manifest)
        self.values = values
        self.meta = dict(meta or {})
        self.state = "registered"    # -> serving | retired

    @property
    def key(self):
        return (self.kind, self.name, self.version)

    def to_dict(self):
        return {"kind": self.kind, "name": self.name,
                "version": self.version, "digest": self.digest,
                "state": self.state, "leaves": len(self.manifest),
                "meta": dict(self.meta)}


class ArtifactCatalog:
    """Named ``(kind, name)`` artifact lines with independent versions.

    Each line is monotonic (`add` assigns ``last + 1`` unless a higher
    version is given) and tracks at most one ``serving`` version;
    `commit` marks a version serving (demoting the previous one to
    ``registered``), `retire` removes one from rotation permanently.
    Manifests come from `checkpoint.leaf_digests` when raw values are
    given, so catalog identity is the same sha256 story the rollout
    registry certifies bitwise."""

    def __init__(self):
        self._lines: dict = {}   # (kind, name) -> {version: Artifact}
        self._serving: dict = {}  # (kind, name) -> version
        self._lock = threading.Lock()

    @staticmethod
    def _manifest_of(values):
        from ..distributed import checkpoint as ckpt

        return ckpt.leaf_digests(
            {k: _host(v) for k, v in dict(values).items()})

    def add(self, kind, name, *, values=None, manifest=None,
            version=None, meta=None) -> Artifact:
        """Register a new version on the ``(kind, name)`` line. Either
        ``values`` (manifest derived) or an explicit ``manifest`` must
        be given. Versions are monotonic per line."""
        if manifest is None:
            if values is None:
                raise ValueError("add() needs values or a manifest")
            manifest = self._manifest_of(values)
        with self._lock:
            line = self._lines.setdefault((kind, name), {})
            nxt = max(line) + 1 if line else 1
            if version is None:
                version = nxt
            elif int(version) < nxt:
                raise ValueError(
                    f"version {version} not monotonic for "
                    f"({kind}, {name}): next is {nxt}")
            art = Artifact(kind, name, version, manifest, values=values,
                           meta=meta)
            line[art.version] = art
            return art

    def get(self, kind, name, version=None) -> Artifact:
        """A specific version, or the serving one (falling back to the
        latest registered) when ``version`` is None."""
        with self._lock:
            line = self._lines.get((kind, name))
            if not line:
                raise KeyError(f"no artifact line ({kind}, {name})")
            if version is None:
                version = self._serving.get((kind, name)) or max(line)
            art = line.get(int(version))
            if art is None or art.state == "retired":
                raise KeyError(
                    f"({kind}, {name}) version {version} not available")
            return art

    def commit(self, kind, name, version) -> Artifact:
        """Mark ``version`` as the line's serving artifact."""
        with self._lock:
            line = self._lines.get((kind, name)) or {}
            art = line.get(int(version))
            if art is None or art.state == "retired":
                raise KeyError(
                    f"({kind}, {name}) version {version} not available")
            prev = self._serving.get((kind, name))
            if prev is not None and prev in line:
                line[prev].state = "registered"
            art.state = "serving"
            self._serving[(kind, name)] = art.version
            return art

    def serving_version(self, kind, name):
        with self._lock:
            return self._serving.get((kind, name))

    def retire(self, kind, name, version):
        with self._lock:
            line = self._lines.get((kind, name)) or {}
            art = line.get(int(version))
            if art is None:
                return
            art.state = "retired"
            if self._serving.get((kind, name)) == art.version:
                del self._serving[(kind, name)]

    def lines(self):
        with self._lock:
            return sorted(self._lines)

    def snapshot(self):
        with self._lock:
            return {
                f"{kind}/{name}": {
                    "serving": self._serving.get((kind, name)),
                    "versions": {v: a.to_dict()
                                 for v, a in sorted(line.items())},
                }
                for (kind, name), line in sorted(self._lines.items())
            }


class AdapterRollout:
    """Canary→wave→commit for the batched LoRA bank across a fleet.

    ``router`` is a `fleet.Router` whose replicas were built with
    ``max_adapters > 0``; ``catalog`` is the `ArtifactCatalog` the new
    bank registers into under ``("adapter", name)``. `roll_to` swaps
    one healthy replica first, optionally certifies it with a live
    probe request through that replica's own engine, then swaps the
    rest and commits the catalog line. A failure anywhere mid-fleet
    swaps the old bank back onto every already-swapped replica and the
    new version retires — all-or-nothing fleet-wide."""

    def __init__(self, router, catalog=None, *, name="adapters"):
        self.router = router
        self.catalog = catalog if catalog is not None else \
            ArtifactCatalog()
        self.name = str(name)
        self.state = "idle"
        self.error = None

    def _engines(self):
        rs = self.router.replica_set
        engines = [r.engine for r in rs.healthy()]
        if not engines:
            raise RuntimeError("no healthy replica to roll adapters on")
        if not engines[0].max_adapters:
            raise ValueError(
                "fleet engines were built without adapters "
                "(engine_kw max_adapters=0)")
        return engines

    def roll_to(self, lora_a, lora_b, *, probe=None, probe_max_new=4,
                timeout=30.0) -> Artifact:
        """Roll the fleet onto a new stacked adapter bank. Returns the
        committed `Artifact`; raises (after restoring the old bank on
        every already-swapped replica) on any canary/wave failure."""
        engines = self._engines()
        old = [(e, e._lora_a, e._lora_b, e.adapter_version)
               for e in engines]
        art = self.catalog.add(
            "adapter", self.name,
            values={"lora_a": _host(lora_a), "lora_b": _host(lora_b)})
        swapped: list = []
        self.state = "canary"
        self.error = None
        try:
            canary = engines[0]
            canary.swap_adapters(lora_a, lora_b, version=art.version,
                                 timeout=timeout)
            swapped.append(canary)
            if probe is not None:
                # a live request through the canary's own engine: the
                # swap must not just land, it must serve
                canary.submit(
                    probe, max_new_tokens=probe_max_new,
                    timeout=timeout).result(timeout)
            self.state = "wave"
            for eng in engines[1:]:
                eng.swap_adapters(lora_a, lora_b, version=art.version,
                                  timeout=timeout)
                swapped.append(eng)
            self.catalog.commit("adapter", self.name, art.version)
            self.state = "committed"
            return art
        except Exception as e:
            self.error = f"{type(e).__name__}: {e}"
            for eng, la, lb, ver in old:
                if any(eng is s for s in swapped):
                    try:
                        eng.swap_adapters(la, lb, version=ver,
                                          timeout=timeout)
                    except Exception:  # noqa: BLE001 — best-effort
                        pass           # restore; original error wins
            self.catalog.retire("adapter", self.name, art.version)
            self.state = "rolled_back"
            raise
