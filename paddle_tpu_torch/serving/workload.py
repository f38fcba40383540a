"""Open-loop traffic simulator: seeded, replayable arrival traces
(counterpart of paddle_tpu/serving/workload.py, numpy only: the same
spec gives the same trace, bit for bit, in either package).

Closed-loop load (each client waits for its previous answer) never
shows what a feed of many users produces: offered load keeps arriving
whether or not the fleet keeps up. This module is the *open-loop*
scenario language:

- **Scenario** — a JSON-able spec: phases of offered load (the diurnal
  curve / flash crowd / 10x swing), an arrival process per phase
  (``poisson`` exponential interarrivals, ``burst`` on/off clusters,
  ``heavy_tail`` Pareto gaps), a zipfian user population whose per-user
  token prefixes repeat across requests (so the radix PrefixCache sees
  realistic shared-prefix traffic), prompt/output length ranges, and
  weighted priority classes (feeding fleet brownout shedding). With
  ``multi_turn=True`` every base arrival opens a *session*: 2..N turns
  separated by think-time gaps, each turn's prompt a pure extension of
  the previous one — the resume-heavy shape that exercises prefix-
  affinity routing and the SSD KV spill tier. With ``tenants={name: {"weight": ..., "priority": ...}}``
  every arrival additionally bills to a tenant drawn from that weighted
  mix, feeding weighted-fair admission and per-tenant SLO accounting.
- **Scenario.trace()** — expands the spec into a concrete arrival list,
  bit-deterministic in the seed: the same JSON replays the exact same
  trace on any machine, which is what lets a chaos re-run be compared
  against its clean baseline request-for-request.
- **replay()** — the open-loop driver: submits each arrival at its
  scheduled time (scaled by ``time_scale``) regardless of completions,
  so queue growth, shedding, brownout, and autoscaling are exercised
  honestly instead of being hidden by client back-pressure.

No wall-clock, hostname, or RNG state leaks into a trace — `Scenario`
round-trips through JSON and `trace()` is a pure function of the spec.
"""

from __future__ import annotations

import json
import time

import numpy as np

__all__ = ["Arrival", "Scenario", "replay"]

#: arrival processes a phase may name
ARRIVAL_PROCESSES = ("poisson", "burst", "heavy_tail")


class Arrival:
    """One scheduled request of a trace (times are seconds from t=0).

    ``session``/``turn`` identify multi-turn traffic: every turn of a
    session shares the session id, and turn k's prompt is a pure
    extension of turn k-1's — the shape that makes prefix-affinity
    routing and the SSD KV spill tier earn their keep. Single-shot
    arrivals carry ``session=None, turn=0``.

    ``tenant`` names the paying tenant the request bills to (None on
    single-tenant scenarios); multi-tenant scenarios draw it zipfian
    from the spec's ``tenants`` mix."""

    __slots__ = ("t", "user", "prompt", "max_new", "priority",
                 "session", "turn", "tenant")

    def __init__(self, t, user, prompt, max_new, priority,
                 session=None, turn=0, tenant=None):
        self.t = float(t)
        self.user = int(user)
        self.prompt = np.asarray(prompt, np.int32)
        self.max_new = int(max_new)
        self.priority = int(priority)
        self.session = None if session is None else int(session)
        self.turn = int(turn)
        self.tenant = None if tenant is None else str(tenant)

    def __repr__(self):
        sess = "" if self.session is None \
            else f", session={self.session}, turn={self.turn}"
        ten = "" if self.tenant is None else f", tenant={self.tenant!r}"
        return (f"Arrival(t={self.t:.4f}, user={self.user}, "
                f"len={self.prompt.size}, max_new={self.max_new}, "
                f"priority={self.priority}{sess}{ten})")


def _normalize_phase(p):
    phase = {
        "duration_s": float(p["duration_s"]),
        "rate_rps": float(p["rate_rps"]),
        "arrival": str(p.get("arrival", "poisson")),
        "burst_n": int(p.get("burst_n", 8)),
        "pareto_alpha": float(p.get("pareto_alpha", 1.8)),
    }
    if phase["arrival"] not in ARRIVAL_PROCESSES:
        raise ValueError(
            f"unknown arrival process {phase['arrival']!r}; "
            f"one of {ARRIVAL_PROCESSES}")
    if phase["duration_s"] <= 0 or phase["rate_rps"] <= 0:
        raise ValueError(f"phase needs positive duration and rate: {p}")
    if phase["pareto_alpha"] <= 1.0:
        raise ValueError("pareto_alpha must be > 1 (finite mean)")
    return phase


class Scenario:
    """Replayable workload spec; `trace()` is deterministic in `seed`.

    ``phases`` is the offered-load curve: each entry is a dict with
    ``duration_s``, ``rate_rps``, and optionally ``arrival`` (one of
    ``poisson`` / ``burst`` / ``heavy_tail``), ``burst_n`` (requests
    per cluster for ``burst``), ``pareto_alpha`` (tail index for
    ``heavy_tail``; must be > 1 so the mean gap exists). Users are
    drawn zipfian over ``n_users``; each user carries a persistent
    ``user_prefix_len``-token prefix prepended to every one of its
    prompts, so hot users produce real prefix-cache traffic.
    ``priorities`` is a list of ``(priority, weight)`` pairs.
    """

    def __init__(self, name="scenario", seed=0, vocab=97, n_users=64,
                 zipf_s=1.2, user_prefix_len=8, prompt_len=(4, 12),
                 max_new=(4, 8), priorities=((0, 0.7), (1, 0.2), (2, 0.1)),
                 phases=None, multi_turn=False, session_turns=(2, 4),
                 think_time=(0.05, 0.2), tenants=None):
        self.name = str(name)
        self.seed = int(seed)
        self.vocab = int(vocab)
        self.n_users = int(n_users)
        self.zipf_s = float(zipf_s)
        self.user_prefix_len = int(user_prefix_len)
        self.prompt_len = (int(prompt_len[0]), int(prompt_len[1]))
        self.max_new = (int(max_new[0]), int(max_new[1]))
        self.priorities = [(int(p), float(w)) for p, w in priorities]
        if phases is None:
            phases = [{"duration_s": 10.0, "rate_rps": 4.0}]
        self.phases = [_normalize_phase(p) for p in phases]
        if self.vocab < 2 or self.n_users < 1:
            raise ValueError("vocab must be >= 2 and n_users >= 1")
        if self.zipf_s <= 1.0:
            raise ValueError("zipf_s must be > 1")
        if not self.priorities or \
                sum(w for _, w in self.priorities) <= 0:
            raise ValueError("priorities need positive total weight")
        if self.prompt_len[0] < 1 or self.prompt_len[1] < self.prompt_len[0]:
            raise ValueError(f"bad prompt_len range {self.prompt_len}")
        if self.max_new[0] < 1 or self.max_new[1] < self.max_new[0]:
            raise ValueError(f"bad max_new range {self.max_new}")
        # multi-turn sessions: each base arrival opens a
        # session of `session_turns` turns separated by `think_time`
        # gaps; every turn's prompt extends the previous turn's with a
        # fresh tail, so the radix caches (and the spill tier) see
        # genuine resume traffic at the same zipfian popularity
        self.multi_turn = bool(multi_turn)
        self.session_turns = (int(session_turns[0]),
                              int(session_turns[1]))
        self.think_time = (float(think_time[0]), float(think_time[1]))
        if self.session_turns[0] < 1 or \
                self.session_turns[1] < self.session_turns[0]:
            raise ValueError(
                f"bad session_turns range {self.session_turns}")
        if self.think_time[0] < 0 or \
                self.think_time[1] < self.think_time[0]:
            raise ValueError(f"bad think_time range {self.think_time}")
        # multi-tenant mix: name -> {"weight": draw weight,
        # "priority": optional override of the drawn priority class}.
        # None keeps the trace single-tenant AND bit-identical to every
        # pre-tenancy trace (the tenant draw consumes RNG only when a
        # mix is configured).
        self.tenants = None
        if tenants:
            self.tenants = {}
            for tname in sorted(tenants):
                spec = dict(tenants[tname])
                spec["weight"] = float(spec.get("weight", 1.0))
                if spec["weight"] <= 0:
                    raise ValueError(
                        f"tenant {tname!r} needs positive weight")
                if "priority" in spec:
                    spec["priority"] = int(spec["priority"])
                self.tenants[str(tname)] = spec

    # -- spec (de)serialization ---------------------------------------------

    def to_dict(self):
        d = {
            "name": self.name, "seed": self.seed, "vocab": self.vocab,
            "n_users": self.n_users, "zipf_s": self.zipf_s,
            "user_prefix_len": self.user_prefix_len,
            "prompt_len": list(self.prompt_len),
            "max_new": list(self.max_new),
            "priorities": [list(pw) for pw in self.priorities],
            "phases": [dict(p) for p in self.phases],
            "multi_turn": self.multi_turn,
            "session_turns": list(self.session_turns),
            "think_time": list(self.think_time),
        }
        if self.tenants is not None:
            d["tenants"] = {t: dict(s) for t, s in self.tenants.items()}
        return d

    def to_json(self, path=None, **kw):
        text = json.dumps(self.to_dict(), sort_keys=True, **kw)
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text

    @classmethod
    def from_dict(cls, d):
        return cls(**d)

    @classmethod
    def from_json(cls, path_or_text):
        text = path_or_text
        if "{" not in text:           # a path, not inline JSON
            with open(path_or_text) as f:
                text = f.read()
        return cls.from_dict(json.loads(text))

    @classmethod
    def swing(cls, low_rps=2.0, high_rps=20.0, low_s=3.0, high_s=4.0,
              arrival="poisson", **kw):
        """The canonical traffic-swing scenario: low -> high -> low
        (default 10x — the flash-crowd shape)."""
        phases = [
            {"duration_s": low_s, "rate_rps": low_rps, "arrival": arrival},
            {"duration_s": high_s, "rate_rps": high_rps,
             "arrival": arrival},
            {"duration_s": low_s, "rate_rps": low_rps, "arrival": arrival},
        ]
        kw.setdefault("name", f"swing{high_rps / low_rps:g}x")
        return cls(phases=phases, **kw)

    @classmethod
    def diurnal(cls, base_rps=2.0, peak_rps=10.0, period_s=12.0,
                n_phases=6, arrival="poisson", **kw):
        """A sinusoidal day: `n_phases` slices of one period between
        base and peak rate (piecewise-constant diurnal curve)."""
        phases = []
        for i in range(int(n_phases)):
            frac = 0.5 - 0.5 * np.cos(2 * np.pi * (i + 0.5) / n_phases)
            phases.append({
                "duration_s": period_s / n_phases,
                "rate_rps": base_rps + (peak_rps - base_rps) * float(frac),
                "arrival": arrival,
            })
        kw.setdefault("name", "diurnal")
        return cls(phases=phases, **kw)

    # -- trace generation ---------------------------------------------------

    @property
    def duration_s(self):
        return sum(p["duration_s"] for p in self.phases)

    def user_prefix(self, user):
        """The persistent token prefix of one user — a deterministic
        function of (seed, user), NOT of the trace RNG stream, so the
        same user shares the same prefix across scenarios and phases."""
        if self.user_prefix_len == 0:
            return np.zeros((0,), np.int32)
        rng = np.random.RandomState(
            (self.seed * 1000003 + user * 7919) % (2 ** 31 - 1))
        return rng.randint(0, self.vocab,
                           (self.user_prefix_len,)).astype(np.int32)

    def _gaps(self, rng, phase):
        """Generator of interarrival gaps for one phase (mean 1/rate
        for every process — the processes differ in variance/shape,
        not offered load)."""
        rate = phase["rate_rps"]
        mean = 1.0 / rate
        kind = phase["arrival"]
        if kind == "poisson":
            while True:
                yield float(rng.exponential(mean))
        elif kind == "heavy_tail":
            # Pareto with minimum xm and tail alpha has mean
            # xm * a / (a - 1); solve xm for the target mean gap
            a = phase["pareto_alpha"]
            xm = mean * (a - 1.0) / a
            while True:
                yield float(xm * (1.0 + rng.pareto(a)))
        else:  # burst: clusters of burst_n back-to-back arrivals
            n = max(phase["burst_n"], 1)
            intra = mean / 50.0
            # inter-burst gap keeps the phase's average rate: each
            # cluster spends (n-1)*intra inside itself
            inter = max(n * mean - (n - 1) * intra, intra)
            i = 0
            while True:
                yield intra if i % n else float(rng.exponential(inter))
                i += 1

    def trace(self):
        """Expand the spec into the concrete arrival list (sorted by
        time). Bit-deterministic: one RandomState seeded on `seed`
        consumed in a fixed order."""
        rng = np.random.RandomState(self.seed)
        ranks = np.arange(1, self.n_users + 1, dtype=np.float64)
        zipf_p = ranks ** -self.zipf_s
        zipf_p /= zipf_p.sum()
        prio_vals = np.asarray([p for p, _ in self.priorities])
        prio_w = np.asarray([w for _, w in self.priorities], np.float64)
        prio_w /= prio_w.sum()
        tnames, tw = None, None
        if self.tenants is not None:
            tnames = list(self.tenants)          # sorted at construction
            tw = np.asarray([self.tenants[t]["weight"] for t in tnames],
                            np.float64)
            tw /= tw.sum()
        prefixes = {}
        arrivals = []
        t0, session_id = 0.0, 0
        for phase in self.phases:
            end = t0 + phase["duration_s"]
            gaps = self._gaps(rng, phase)
            t = t0
            while True:
                t += next(gaps)
                if t >= end:
                    break
                user = int(rng.choice(self.n_users, p=zipf_p))
                if user not in prefixes:
                    prefixes[user] = self.user_prefix(user)
                lo, hi = self.prompt_len
                tail = rng.randint(0, self.vocab,
                                   (int(rng.randint(lo, hi + 1)),))
                lo, hi = self.max_new
                max_new = int(rng.randint(lo, hi + 1))
                priority = int(prio_vals[rng.choice(len(prio_vals),
                                                    p=prio_w)])
                tenant = None
                if tnames is not None:
                    # the tenant draw consumes RNG only in multi-tenant
                    # mode, so legacy seeded traces stay bit-identical
                    tenant = tnames[int(rng.choice(len(tnames), p=tw))]
                    tprio = self.tenants[tenant].get("priority")
                    if tprio is not None:
                        priority = int(tprio)
                prompt = np.concatenate(
                    [prefixes[user], tail.astype(np.int32)])
                if not self.multi_turn:
                    arrivals.append(Arrival(t, user, prompt, max_new,
                                            priority, tenant=tenant))
                    continue
                # multi-turn: this arrival opens a session; turn k's
                # prompt extends turn k-1's with a fresh tail after a
                # think-time gap (all draws from the same stream, so
                # the trace stays bit-deterministic in the seed)
                sid, session_id = session_id, session_id + 1
                lo, hi = self.session_turns
                n_turns = int(rng.randint(lo, hi + 1))
                tt = t
                for turn in range(n_turns):
                    if turn:
                        tlo, thi = self.think_time
                        tt += float(rng.uniform(tlo, thi))
                        lo, hi = self.prompt_len
                        ext = rng.randint(
                            0, self.vocab,
                            (int(rng.randint(lo, hi + 1)),))
                        prompt = np.concatenate(
                            [prompt, ext.astype(np.int32)])
                        lo, hi = self.max_new
                        max_new = int(rng.randint(lo, hi + 1))
                    arrivals.append(Arrival(tt, user, prompt, max_new,
                                            priority, session=sid,
                                            turn=turn, tenant=tenant))
            t0 = end
        if self.multi_turn:
            # session turns overrun their phase slot; restore global
            # time order (stable sort keeps the per-time-tie draw order)
            arrivals.sort(key=lambda a: a.t)
        return arrivals


def replay(submit, trace, *, time_scale=1.0, stop=None):
    """Open-loop replay of a trace against a serving front.

    ``submit(arrival)`` places one request and returns its future (any
    object; a synchronous raise is recorded as the submit error — e.g.
    a brownout shed). Arrivals are issued at ``arrival.t * time_scale``
    seconds after the replay starts, NEVER waiting on completions —
    that open loop is the point. Returns one record per arrival:
    ``{"arrival", "t_submit", "future", "error"}`` with ``t_submit``
    seconds from replay start. ``stop`` (an optional callable) aborts
    the replay early when it returns True.
    """
    t0 = time.monotonic()
    records = []
    for arrival in trace:
        if stop is not None and stop():
            break
        delay = arrival.t * time_scale - (time.monotonic() - t0)
        if delay > 0:
            time.sleep(delay)
        rec = {"arrival": arrival, "t_submit": time.monotonic() - t0,
               "future": None, "error": None}
        try:
            rec["future"] = submit(arrival)
        except Exception as e:  # noqa: BLE001 — shed/closed are outcomes
            rec["error"] = e
        records.append(rec)
    return records
