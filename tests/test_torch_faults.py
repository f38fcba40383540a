"""Port parity: paddle_tpu_torch's fault harness (`framework.faults`),
error taxonomy (`framework.errors`), preemption handling
(`distributed.preempt`) and flight recorder (`observe`) against
paddle_tpu's, on the CPU.

- `parse_spec` gives the same ``repr`` in both packages for every spec
  string of a list (exact string equality), and one ``PADDLE_TPU_FAULTS``
  value schedules the same fault in both.
- Occurrence, range and tag scheduling, `ChaosSchedule.verify`, the
  unregistered-site refusal and `retry_with_backoff` behave as the
  reference's own tests pin them (exact counts).
- The port's `_poison_nan` poisons float numpy arrays and torch tensors
  (on their own device, same dtype and shape) and leaves integer leaves
  untouched; on numpy leaves it equals the reference's bit for bit.
  `corrupt_leaf` truncates the largest ``.npy`` of a port checkpoint to
  half its size.
- The error classes keep the reference's builtin bases, and `enforce*`
  raise the same classes with the same messages.
- Preemption: the simulated schedule (FLAGS_simulate_preempt_at_step),
  a ``preempt.poll`` drop, `on_preempt`, the marker round trip, and one
  real SIGUSR1 to this process (its handlers restored in ``finally``).
- The flight recorder: a bounded ring, values kept lazy until a dump,
  the black box an injected ``train.batch`` raise leaves behind, and the
  grad norm under FLAGS_record_grad_norm against the reference engine's
  (rtol 1e-6, test_torch_optimizer.py's parity tolerance).
- The site audit: every entry of the port's `SITES` has a
  ``fault_point`` call in the port and is fired by some
  tests/test_torch_*.py test.

A fixture restores every global this file changes: the flags of both
packages, the fault specs, hit counters and environment latch, the
preemption state and signal handlers, and the flight ring.
"""

from __future__ import annotations

import glob
import json
import os
import re
import signal
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import engine as jengine
from paddle_tpu.framework import errors as jerrors
from paddle_tpu.framework import faults as jfaults
from paddle_tpu.framework import flags as jflags

from paddle_tpu_torch import engine as tengine
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import observe
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.distributed import preempt
from paddle_tpu_torch.framework import errors, faults, flags, monitor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FLAGS = ("FLAGS_simulate_preempt_at_step", "FLAGS_record_grad_norm",
          "FLAGS_flight_recorder_dir", "FLAGS_flight_record_memory",
          "FLAGS_flight_recorder_capacity")


def _stat(name):
    return monitor.stat_get(name)


@pytest.fixture(autouse=True)
def _restore_globals(tmp_path):
    tflags0 = flags.get_flags(list(_FLAGS))
    jflags0 = jflags.get_flags(["FLAGS_record_grad_norm"])
    specs = (faults._specs[:], dict(faults._hits), faults._env_loaded)
    jspecs = (jfaults._specs[:], dict(jfaults._hits), jfaults._env_loaded)
    ring = observe.flight
    saved_ring = (ring._ring, list(ring._notes), list(ring._dumped))
    ring.reset()
    preempt.clear()
    flags.set_flags({"FLAGS_flight_recorder_dir": str(tmp_path / "bb")})
    yield
    preempt.uninstall()
    preempt.clear()
    for mod, (sp, hits, env) in ((faults, specs), (jfaults, jspecs)):
        mod._specs[:] = sp
        mod._hits.clear()
        mod._hits.update(hits)
        mod._env_loaded = env
    ring._ring = saved_ring[0]
    ring._notes.clear()
    ring._notes.extend(saved_ring[1])
    ring._dumped[:] = saved_ring[2]
    flags.set_flags(tflags0)
    jflags.set_flags(jflags0)


# -- spec grammar and scheduling ---------------------------------------------

SPECS = ["checkpoint.io@1:ioerror", "train.batch@3-4:nan", "x.y@2-:raise",
         "site@*:delay:0.5", "serving.replica_step[fleet.r0]@3:crash",
         "preempt.poll@1:drop", "checkpoint.after_commit@2:corrupt",
         " gang.heartbeat[w1]@5-7:drop "]


@pytest.mark.parametrize("text", SPECS)
def test_parse_spec_repr_matches_reference(text):
    """Both packages' specs repr to the stripped input (exact)."""
    got, want = faults.parse_spec(text), jfaults.parse_spec(text)
    assert repr(got) == repr(want) == text.strip()
    assert (got.site, got.lo, got.hi, got.action, got.arg, got.tag) == \
        (want.site, want.lo, want.hi, want.action, want.arg, want.tag)


@pytest.mark.parametrize("text", ["nosite", "a@1", "@1:raise", "a@:raise"])
def test_parse_spec_rejects_malformed_specs_like_reference(text):
    """A malformed spec raises ValueError in both packages."""
    with pytest.raises(ValueError):
        jfaults.parse_spec(text)
    with pytest.raises(ValueError):
        faults.parse_spec(text)


def test_fault_occurrence_scheduling():
    """A spec fires at exactly its occurrences, and leaves with its
    block."""
    spec = faults.parse_spec("x.y@2-3:raise")
    assert not spec.matches("x.y", 1)
    assert spec.matches("x.y", 2) and spec.matches("x.y", 3)
    assert not spec.matches("x.y", 4)
    assert not spec.matches("other", 2)
    with faults.inject("site.a@2:raise"):
        faults.fault_point("site.a")  # hit 1: clean
        with pytest.raises(faults.FaultError):
            faults.fault_point("site.a")  # hit 2: fires
        faults.fault_point("site.a")  # hit 3: clean again
    # specs removed on exit
    faults.fault_point("site.a")


def test_tagged_specs_count_per_tag():
    """Tagged specs count their tag's hits, untagged ones the site's
    (exact occurrences)."""
    with faults.inject("site.t[a]@2:raise", "site.t@3:drop"):
        faults.fault_point("site.t", tag="a")        # a: 1, site: 1
        faults.fault_point("site.t", tag="b")        # b: 1, site: 2
        assert faults.fault_point("site.t", tag="b") is faults.DROP
        with pytest.raises(faults.FaultError):
            faults.fault_point("site.t", tag="a")    # a: 2
        assert faults.fault_point("site.t", 7, tag="b") == 7


def test_unregistered_site_refuses_to_fire():
    """An unregistered site no spec names raises ValueError."""
    with faults.inject("site.b@1:raise"):
        with pytest.raises(ValueError, match="unregistered"):
            faults.fault_point("not.registered")


def test_chaos_schedule_certifies_its_delivery():
    """`planned`, `fired` and `verify` count exactly; an under-delivered
    schedule fails `verify`."""
    with faults.ChaosSchedule("site.c@1-2:delay:0", "site.d@1:drop",
                              "site.e@*:delay:0") as chaos:
        for _ in range(3):
            faults.fault_point("site.c")
            faults.fault_point("site.e")
        assert faults.fault_point("site.d") is faults.DROP
        assert chaos.planned() == {"site.c": 2, "site.d": 1}
        assert chaos.verify() == {"site.c": 2, "site.d": 1, "site.e": 3}
    with faults.ChaosSchedule("site.c@1-2:delay:0") as chaos:
        faults.fault_point("site.c")
        with pytest.raises(AssertionError, match="under-delivered"):
            chaos.verify()


def test_fault_env_var_drives_either_package(monkeypatch):
    """One PADDLE_TPU_FAULTS value, read once at first use, schedules
    the same fault in both packages."""
    monkeypatch.setenv("PADDLE_TPU_FAULTS", "site.env@2:raise; ")
    for mod in (faults, jfaults):
        mod._env_loaded = False
        mod.fault_point("site.env")
        with pytest.raises(mod.FaultError):
            mod.fault_point("site.env")


def test_poison_nan_walks_containers_and_keeps_integer_leaves():
    """Float leaves become NaN of the same dtype, shape and device,
    integer leaves are the same objects, containers keep their types;
    on numpy leaves the port equals the reference bitwise."""
    f32 = np.arange(6, dtype=np.float32).reshape(2, 3)
    payload = {"inputs": (f32, np.arange(4, dtype=np.int32),
                          torch.ones(3, dtype=torch.bfloat16)),
               "labels": [torch.arange(3), 2.5, 7]}
    out = faults._poison_nan(payload)
    x, ids, t = out["inputs"]
    assert x.dtype == np.float32 and x.shape == (2, 3) and \
        np.isnan(x).all()
    assert ids is payload["inputs"][1]
    assert t.dtype == torch.bfloat16 and t.device == torch.device("cpu") \
        and torch.isnan(t).all()
    assert out["labels"][0] is payload["labels"][0]
    assert np.isnan(out["labels"][1]) and out["labels"][2] == 7
    assert isinstance(out["inputs"], tuple) and \
        isinstance(out["labels"], list)
    assert not np.isnan(f32).any()           # the input is not mutated
    want = jfaults._poison_nan({"a": f32, "b": np.arange(4, dtype=np.int32)})
    got = faults._poison_nan({"a": f32, "b": np.arange(4, dtype=np.int32)})
    for k in ("a", "b"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def test_corrupt_leaf_truncates_the_largest_array_file(tmp_path):
    """The largest ``.npy`` under ``d/`` is cut to exactly half its
    size, and loading the checkpoint then fails."""
    path = str(tmp_path / "ck")
    ckpt.save_state(path, {"big": np.ones((64, 64), np.float32),
                           "small": np.ones((3,), np.float32)},
                    metadata={"step": 1})
    size = {p: os.path.getsize(p)
            for p in glob.glob(os.path.join(path, "d", "*.npy"))}
    victim = faults.corrupt_leaf(path)
    assert os.sep + "d" + os.sep in victim and victim.endswith(".npy")
    assert size[victim] == max(size.values())
    assert os.path.getsize(victim) == size[victim] // 2
    with pytest.raises(ValueError):
        ckpt.load_state(path, {"big": np.zeros((64, 64), np.float32),
                               "small": np.zeros((3,), np.float32)})


# -- errors and retries -------------------------------------------------------


@pytest.mark.parametrize("name", [n for n in jerrors.__all__
                                  if n[0].isupper()])
def test_error_classes_keep_the_reference_bases(name):
    """Each class has the reference's builtin bases (exact)."""
    def builtin_bases(cls):
        return sorted(b.__name__ for b in cls.__mro__
                      if b.__module__ == "builtins")

    assert builtin_bases(getattr(errors, name)) == \
        builtin_bases(getattr(jerrors, name))
    assert issubclass(getattr(errors, name), errors.PaddleError)


@pytest.mark.parametrize("call", [
    lambda m: m.enforce(False, "boom"),
    lambda m: m.enforce(False, "pre", m.PreconditionNotMetError),
    lambda m: m.enforce_eq(1, 2, "ids"),
    lambda m: m.enforce_gt(1, 2),
    lambda m: m.enforce_shape(np.zeros((2, 3)), (2, -1, 1), "x")],
    ids=["enforce", "enforce_cls", "eq", "gt", "shape"])
def test_enforce_helpers_raise_like_reference(call):
    """Same class name and same message as the reference (exact)."""
    with pytest.raises(jerrors.PaddleError) as want:
        call(jerrors)
    with pytest.raises(errors.PaddleError) as got:
        call(errors)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_retry_with_backoff_retries_then_succeeds():
    """Two failures, then success: exactly 3 calls and 2 ``retries``."""
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "ok"

    before = _stat("retries")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert errors.retry_with_backoff(flaky, retries=3,
                                         base_delay=0.001) == "ok"
    assert calls["n"] == 3
    assert _stat("retries") - before == 2


def test_retry_gives_up_and_does_not_swallow_fault_errors():
    """OSError escapes after the retries; FaultError on the first call."""
    def always_bad():
        raise OSError("persistent")

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(OSError):
            errors.retry_with_backoff(always_bad, retries=2,
                                      base_delay=0.001)
    calls = {"n": 0}

    def injected():
        calls["n"] += 1
        raise faults.FaultError("boom")

    with pytest.raises(faults.FaultError):
        errors.retry_with_backoff(injected, retries=5, base_delay=0.001)
    assert calls["n"] == 1


# -- preemption ---------------------------------------------------------------


def test_simulated_preemption_schedule_and_drop():
    """The 3rd counted poll reports the preemption, a dropped poll is
    not counted, callbacks fire once (exact counts)."""
    fired = []
    preempt.on_preempt(lambda: fired.append(1))
    flags.set_flags({"FLAGS_simulate_preempt_at_step": 3})
    before = _stat("preemptions")
    with faults.inject("preempt.poll@2:drop"):
        # the dropped poll is not counted: the 3rd counted poll is the
        # 4th call
        assert [preempt.poll() for _ in range(4)] == \
            [False, False, False, True]
    assert preempt.requested() and preempt.reason() == "simulated"
    assert fired == [1] and _stat("preemptions") - before == 1
    preempt.request("again")              # idempotent
    assert fired == [1] and preempt.reason() == "simulated"
    kinds = [n["kind"] for n in observe.flight.snapshot()["notes"]]
    assert "preemption" in kinds and "fault" in kinds
    late = []
    preempt.on_preempt(lambda: late.append(1))   # fires at once
    assert late == [1]


def test_preempt_marker_round_trip(tmp_path):
    """The marker carries its fields exactly and is consumed once."""
    preempt.request("test")
    p = preempt.write_marker(str(tmp_path), {"epoch": 4})
    assert os.path.exists(p)
    rec = preempt.consume_marker(str(tmp_path))
    assert rec["epoch"] == 4 and rec["reason"] == "test"
    assert not os.path.exists(p)
    assert preempt.consume_marker(str(tmp_path)) is None


def test_preempt_signal_flag_in_process():
    """The one real signal of the port's tests: SIGUSR1 to this process
    sets the flag without killing it; the handlers that install()
    replaced are put back in ``finally``."""
    prev = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGUSR1)}
    try:
        preempt.install()
        assert not preempt.requested()
        os.kill(os.getpid(), signal.SIGUSR1)
        assert preempt.requested()
        assert "signal" in preempt.reason()
        assert preempt.poll() is True
        preempt.clear()
        assert not preempt.requested()
    finally:
        preempt.uninstall()
        for s, h in prev.items():
            signal.signal(s, h)
    assert {s: signal.getsignal(s) for s in prev} == prev


# -- flight recorder ----------------------------------------------------------


class _Net(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = tnn.Linear(6, 3)

    def forward(self, x):
        return self.fc(x)


def _engine(seed=5, **kw):
    torch.manual_seed(seed)
    m = _Net()
    opt = topt.Adam(learning_rate=0.05, parameters=m.parameters())
    return tengine.Engine(m, opt, lambda o, y: ((o - y) ** 2).mean(),
                          device="cpu", seed=seed, **kw)


def _batch():
    rs = np.random.RandomState(0)
    return (rs.randn(8, 6).astype(np.float32),
            rs.randn(8, 3).astype(np.float32))


def test_flight_ring_is_bounded_and_configurable():
    """The ring keeps exactly the last N records; `configure` re-sizes
    it from FLAGS_flight_recorder_capacity."""
    rec = observe.FlightRecorder(capacity=4)
    for s in range(10):
        rec.record_step(s, loss=float(s))
    assert [r["step"] for r in rec.snapshot()["records"]] == [6, 7, 8, 9]
    flags.set_flags({"FLAGS_flight_recorder_capacity": 3})
    for s in range(5):
        observe.flight.record_step(s)
    observe.recorder.configure()
    assert [r["step"] for r in observe.flight.snapshot()["records"]] == \
        [2, 3, 4]


def test_flight_records_stay_lazy_until_dump():
    """A record holds the very loss and counter tensors (identity); the
    snapshot turns them into their exact float values."""
    eng = _engine(anomaly_guard=True)
    x, y = _batch()
    loss = eng.train_batch(x, y)
    last = observe.flight.last()
    assert last["step"] == 1 and last["loss"] is loss
    assert last["anomaly_bad_steps"] is \
        eng.state.buffers[tengine.ANOMALY_BAD_STEPS_KEY]
    assert "bytes_in_use" not in last        # the CPU has no device pool
    assert isinstance(last["step_ms"], float)
    snap = observe.flight.snapshot()["records"][-1]
    assert snap["loss"] == float(loss) and snap["anomaly_bad_steps"] == 0.0


def test_flight_dump_on_injected_fault():
    """An injected ``train.batch`` raise at step 3 leaves one black box
    whose last record is step 2 (exact), with the fault's note."""
    """An injected ``raise`` at step 3 under `flight_guard` leaves a
    black box whose last record is the last completed step."""
    eng = _engine()
    x, y = _batch()
    with faults.inject("train.batch@3:raise"):
        with pytest.raises(faults.FaultError):
            with observe.flight_guard("train-loop"):
                for _ in range(10):
                    eng.train_batch(x, y)
    dumps = observe.flight.dumps()
    assert len(dumps) == 1
    with open(dumps[0]) as f:
        box = json.load(f)
    assert eng.state.step == 2
    assert box["records"][-1]["step"] == 2
    assert box["reason"].startswith("train-loop:")
    kinds = [n["kind"] for n in box["notes"]]
    assert "fault" in kinds and "exception" in kinds
    note = next(n for n in box["notes"] if n["kind"] == "fault")
    assert note["site"] == "train.batch" and note["hit"] == 3
    assert isinstance(box["records"][-1]["loss"], float)


class _JNet(paddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = paddle.nn.Linear(6, 3)

    def forward(self, x):
        return self.fc(x)


def test_grad_norm_recorded_in_flight_matches_reference():
    """FLAGS_record_grad_norm (latched at construction): the pre-clip
    global gradient norm as a device scalar in ``state.buffers``, in the
    flight record, equal to the reference engine's within rtol 1e-6."""
    flags.set_flags({"FLAGS_record_grad_norm": True})
    jflags.set_flags({"FLAGS_record_grad_norm": True})
    rng = np.random.RandomState(1)
    vals = {"fc.weight": rng.randn(6, 3).astype(np.float32),
            "fc.bias": rng.randn(3).astype(np.float32)}
    jm = _JNet()
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in vals.items()})
    jeng = jengine.Engine(
        jm, paddle.optimizer.Adam(learning_rate=0.05,
                                  parameters=jm.parameters()),
        lambda o, y: paddle.mean((o - y) * (o - y)))
    eng = _engine()
    eng.layer.load_state_dict({k: torch.from_numpy(v)
                               for k, v in vals.items()})
    flags.set_flags({"FLAGS_record_grad_norm": False})   # latched already
    x, y = _batch()
    for _ in range(2):
        jeng.train_batch(x, y)
        eng.train_batch(x, y)
    gn = eng.state.buffers[tengine.GRAD_NORM_KEY]
    assert gn.dtype == torch.float32 and gn.shape == ()
    np.testing.assert_allclose(
        float(gn), float(np.asarray(jeng.state.buffers[
            jengine.GRAD_NORM_KEY])), rtol=1e-6)
    with open(observe.flight.dump("test")) as f:
        last = json.load(f)["records"][-1]
    assert last["grad_norm"] == pytest.approx(float(gn))
    assert tengine.GRAD_NORM_KEY not in _engine().state.buffers


def test_signal_handler_dumps_the_black_box_then_dies(tmp_path):
    """`install_signal_handler` in a child process: SIGTERM writes the
    black box (its reason names the signal, its last record is the one
    recorded), then the default action ends the child by SIGTERM."""
    import subprocess
    import sys

    code = ("import os, signal\n"
            "from paddle_tpu_torch import observe\n"
            "observe.flight.record_step(7, loss=1.5)\n"
            "assert observe.install_signal_handler()\n"
            "os.kill(os.getpid(), signal.SIGTERM)\n")
    env = dict(os.environ, FLAGS_flight_recorder_dir=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == -signal.SIGTERM, out.stderr
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        box = json.load(f)
    assert box["reason"] == f"signal:{int(signal.SIGTERM)}"
    assert box["records"][-1]["step"] == 7 and \
        box["records"][-1]["loss"] == 1.5


# -- site audit ---------------------------------------------------------------

_CALL_RE = re.compile(r"""fault_point\(\s*["']([a-z0-9_.]+)["']""")


def test_every_port_fault_point_is_registered_and_every_site_is_called():
    """The port's ``fault_point`` literals are exactly `SITES`."""
    called = set()
    for path in glob.glob(os.path.join(REPO, "paddle_tpu_torch", "**",
                                       "*.py"), recursive=True):
        with open(path) as f:
            called.update(_CALL_RE.findall(f.read()))
    assert called == set(faults.SITES)


def test_every_port_site_is_fired_by_a_torch_test():
    """Every registered site is scheduled by some tests/test_torch_*.py
    test: a spec (``site@occ:action``) among the arguments of an
    ``inject(...)`` or ``ChaosSchedule(...)`` call."""
    fired = set()
    for path in glob.glob(os.path.join(REPO, "tests", "test_torch_*.py")):
        with open(path) as f:
            for args in re.findall(r"(?:inject|ChaosSchedule)\(([^)]*)\)",
                                   f.read()):
                fired.update(re.findall(
                    r"""["']([a-z0-9_.]+)(?:\[[^\]]*\])?@[\d*]""", args))
    assert set(faults.SITES) <= fired, set(faults.SITES) - fired
