"""Port parity: the SSD KV spill tier (`serving.kvstore`) and KV
migration (`export_prefix_blocks` / `adopt_prefix_blocks`,
`serving.migrate`) of paddle_tpu_torch against paddle_tpu, on the tiny
GPT of tests/torch_parity.py.

- The on-disk record: a record written by either package reads in the
  other with the same tokens and bitwise the same rows, f32 and bf16
  (bf16 travels as raw 16-bit words under the tag ``bfloat16``).
- A torn tail is cut at reopen and a flipped bit makes the record
  absent (`kv_restore_corrupt`): both degrade to re-prefill. `fence`
  makes a generation's records raise `SpillFencedError`; compaction
  keeps exactly the live, unfenced records.
- Engine spill → restore: a second turn restores the first turn's
  blocks from disk (`kv_restored_blocks` > 0) and its tokens are
  bitwise a cold engine's, in f32 and with a bf16 pool, and equal the
  reference engine's; a port engine also resumes from a spill file the
  reference wrote. A ``serving.kv_restore`` fault and a
  ``serving.spill`` fault leak no block and change no token.
- KV adoption: an export of the reference engine adopted by the port's
  engine, and the reverse, continue with the source's tokens;
  `migrate_prefix` over a `KVMailbox` between two port engines too,
  and a ``serving.kv_migrate`` fault aborts the adoption leak-free.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu import serving as jserving

from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.framework import faults
from torch_parity import VOCAB, build_pair, drive, prompt

ENGINE = dict(max_slots=2, block_size=8, prefill_chunk=8)


@pytest.fixture(scope="module")
def pair():
    return build_pair(seed=0)


@pytest.fixture(autouse=True)
def _fresh():
    faults.reset()
    tserving.reset_spill_stores()
    jserving.reset_spill_stores()
    yield
    faults.reset()
    tserving.reset_spill_stores()
    jserving.reset_spill_stores()


def _record(seed, bf16=False, bs=8, n_layers=2, nh=4, hd=16):
    """(digest, tokens, layers as numpy — ml_dtypes bf16 when asked)."""
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, VOCAB, (bs * 2,)).astype(np.int32)
    layers = []
    for _ in range(n_layers):
        kv = [rng.randn(nh, bs, hd).astype(np.float32) for _ in range(2)]
        if bf16:
            kv = [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in kv]
        layers.append(tuple(kv))
    return bytes([seed]) * 20, tokens, layers


def _words(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _tensor(a, bf16):
    """A record's numpy rows as the port's torch rows."""
    if bf16:
        return torch.from_numpy(_words(a).view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("bf16", [False, True])
def test_records_cross_between_packages(tmp_path, bf16):
    digest, tokens, layers = _record(1, bf16)
    jstore = jserving.KVSpillStore(str(tmp_path / "ref.spill"))
    jstore.append(digest, 3, tokens, layers)
    jstore.close()
    rec = tserving.KVSpillStore(str(tmp_path / "ref.spill")).get(digest)
    assert rec["generation"] == 3 and rec["block_size"] == 8
    assert rec["dtype"] == ("bfloat16" if bf16 else "float32")
    np.testing.assert_array_equal(rec["tokens"], tokens)
    for (k, v), (wk, wv) in zip(rec["layers"], layers):
        np.testing.assert_array_equal(k, _words(wk))
        np.testing.assert_array_equal(v, _words(wv))
    # the reverse: the port writes torch tensors (bf16 as its words)
    tlayers = [(_tensor(k, bf16), _tensor(v, bf16)) for k, v in layers]
    tstore = tserving.KVSpillStore(str(tmp_path / "port.spill"))
    n = tstore.append(digest, 4, tokens, tlayers)
    assert n == os.path.getsize(tmp_path / "port.spill")
    tstore.close()
    got = jserving.KVSpillStore(str(tmp_path / "port.spill")).get(digest)
    assert got["generation"] == 4
    for (k, v), (wk, wv) in zip(got["layers"], layers):
        np.testing.assert_array_equal(_words(k), _words(wk))
        np.testing.assert_array_equal(_words(v), _words(wv))
    # the two records differ only in their crc and generation
    a = open(tmp_path / "ref.spill", "rb").read()
    b = open(tmp_path / "port.spill", "rb").read()
    assert len(a) == len(b) and a[4:28] == b[4:28] and a[36:] == b[36:]


def test_torn_tail_and_bit_flip_degrade(tmp_path):
    path = str(tmp_path / "kv.spill")
    store = tserving.KVSpillStore(path, metrics=tserving.ServingMetrics())
    recs = [_record(s) for s in (1, 2, 3)]
    for digest, tokens, layers in recs:
        store.append(digest, 0, tokens, layers)
    store.close()
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size - 100)            # tear the last record
    store = tserving.KVSpillStore(path, metrics=tserving.ServingMetrics())
    assert len(store) == 2 and recs[2][0] not in store
    assert os.path.getsize(path) < size - 100
    # flip a bit inside the first record's rows
    with open(path, "r+b") as f:
        f.seek(200)
        b = f.read(1)
        f.seek(200)
        f.write(bytes([b[0] ^ 0x10]))
    assert store.get(recs[0][0]) is None
    assert store.metrics.get("kv_restore_corrupt") == 1
    assert store.get(recs[1][0]) is not None


def test_fence_and_compaction(tmp_path):
    path = str(tmp_path / "kv.spill")
    store = tserving.KVSpillStore(path)
    for seed, gen in ((1, 0), (2, 0), (3, 1)):
        digest, tokens, layers = _record(seed)
        store.append(digest, gen, tokens, layers)
    assert store.fence(0) == 2
    with pytest.raises(tserving.SpillFencedError) as err:
        store.get(_record(1)[0])
    assert err.value.retriable and err.value.status == 503
    assert store.get(_record(3)[0]) is not None
    before = store.nbytes
    assert store.compact() == 1
    assert store.nbytes < before and len(store) == 1
    reopened = tserving.KVSpillStore(path)
    assert len(reopened) == 1 and reopened.get(_record(3)[0]) is not None
    # a tiny cap compacts on append: superseded records are dropped
    capped = tserving.KVSpillStore(str(tmp_path / "c.spill"), cap_mb=1e-4)
    digest, tokens, layers = _record(4)
    for _ in range(3):
        capped.append(digest, 0, tokens, layers)
    assert len(capped) == 1 and capped.nbytes == capped.append(
        digest, 0, tokens, layers)
    assert tserving.open_spill_store("") is None
    a = tserving.open_spill_store(str(tmp_path))
    assert tserving.open_spill_store(str(tmp_path)) is a


def _turns(eng, p, max_new=8, ext=5):
    """Turn 1 on `p`, drain the cache to disk, then turn 2 on turn 1's
    output extended by `ext` tokens."""
    first = drive(eng, [p], max_new=max_new)[0]
    eng.spill_cache()
    second = np.concatenate([first, prompt(99, ext)])
    return first, second, drive(eng, [second], max_new=max_new)[0]


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_spill_restore_equals_cold_engine_and_reference(pair, tmp_path,
                                                        dtype):
    jm, tm, _ = pair
    eng = tserving.SlotEngine(tm, device="cpu", spill_dir=str(tmp_path),
                              cache_dtype=dtype, **ENGINE)
    eng.warmup()
    first, second, got = _turns(eng, prompt(7, 20))
    # 27 positions written in turn 1: three full blocks went to disk
    assert eng.metrics.get("kv_spilled_blocks") == 3
    assert eng.metrics.get("kv_restored_blocks") == 3
    assert eng.prefix_hit_rate() > 0
    assert eng.metrics.snapshot()["kvstore"]["restored_blocks"] == 3
    assert eng.metrics.snapshot()["latency_s"]["kv_restore"]["count"] == 1
    cold = tserving.SlotEngine(tm, device="cpu", cache_dtype=dtype,
                               prefix_cache=False, **ENGINE)
    np.testing.assert_array_equal(got, drive(cold, [second], max_new=8)[0])
    os.makedirs(tmp_path / "ref")
    ref = jserving.SlotEngine(
        jm, spill_dir=str(tmp_path / "ref"),
        cache_dtype=jnp.bfloat16 if dtype else None, **ENGINE)
    ref.warmup()
    rfirst, rsecond, rgot = _turns(ref, prompt(7, 20))
    assert ref.metrics.get("kv_restored_blocks") == 3
    np.testing.assert_array_equal(rsecond, second)
    np.testing.assert_array_equal(rgot, got)


def test_port_resumes_from_the_reference_spill_file(pair, tmp_path):
    jm, tm, _ = pair
    ref = jserving.SlotEngine(jm, spill_dir=str(tmp_path), **ENGINE)
    ref.warmup()
    _, second, want = _turns(ref, prompt(17, 20))
    jserving.reset_spill_stores()
    eng = tserving.SlotEngine(tm, device="cpu", spill_dir=str(tmp_path),
                              **ENGINE)
    eng.warmup()
    got = drive(eng, [second], max_new=8)[0]
    assert eng.metrics.get("kv_restored_blocks") == 3
    np.testing.assert_array_equal(got, want)


def test_restore_and_spill_faults_are_leak_free(pair, tmp_path):
    _, tm, _ = pair
    eng = tserving.SlotEngine(tm, device="cpu", spill_dir=str(tmp_path),
                              **ENGINE)
    eng.warmup()
    first = drive(eng, [prompt(27, 20)], max_new=8)[0]
    with faults.ChaosSchedule("serving.spill@2:raise") as chaos:
        eng.spill_cache()
        chaos.verify()
    assert eng.metrics.get("kv_spill_errors") == 1
    assert eng.metrics.get("kv_spilled_blocks") == 2
    assert eng.prefix_cache_size == 0 and eng.blocks_in_use == 0
    second = np.concatenate([first, prompt(98, 5)])
    cold = tserving.SlotEngine(tm, device="cpu", prefix_cache=False,
                               **ENGINE)
    want = drive(cold, [second], max_new=8)[0]
    with faults.ChaosSchedule("serving.kv_restore[engine]@1:raise") as chaos:
        got = drive(eng, [second], max_new=8)[0]
        chaos.verify()
    np.testing.assert_array_equal(got, want)
    assert eng.metrics.get("kv_restored_blocks") == 0
    assert eng.blocks_in_use == eng.prefix_cache_size


def test_adoption_crosses_between_packages(pair):
    jm, tm, _ = pair
    p = prompt(37, 20)
    ref = jserving.SlotEngine(jm, **ENGINE)
    ref.warmup()
    eng = tserving.SlotEngine(tm, device="cpu", **ENGINE)
    eng.warmup()
    first = drive(ref, [p], max_new=8)[0]
    second = np.concatenate([first, prompt(97, 5)])
    # reference -> port
    payload = ref.export_prefix_blocks(second)
    assert eng.adopt_prefix_blocks(payload) == 24
    got = drive(eng, [second], max_new=8)[0]
    assert eng.metrics.get("prefix_hit_tokens") >= 24
    np.testing.assert_array_equal(got, drive(ref, [second], max_new=8)[0])
    # port -> reference
    src = tserving.SlotEngine(tm, device="cpu", **ENGINE)
    src.warmup()
    drive(src, [prompt(38, 20)], max_new=8)
    third = np.concatenate([drive(src, [prompt(38, 20)], max_new=8)[0],
                            prompt(96, 5)])
    payload = src.export_prefix_blocks(third)
    assert payload["dtype"] == "float32"
    dst = jserving.SlotEngine(jm, **ENGINE)
    dst.warmup()
    assert dst.adopt_prefix_blocks(payload) == 24
    np.testing.assert_array_equal(drive(dst, [third], max_new=8)[0],
                                  drive(src, [third], max_new=8)[0])


def test_migrate_prefix_over_mailbox_and_fault(pair):
    _, tm, _ = pair
    a = tserving.SlotEngine(tm, device="cpu", name="a", **ENGINE)
    b = tserving.SlotEngine(tm, device="cpu", name="b",
                            cache_dtype=torch.bfloat16, **ENGINE)
    c = tserving.SlotEngine(tm, device="cpu", name="c",
                            cache_dtype=torch.bfloat16, **ENGINE)
    first = drive(a, [prompt(47, 20)], max_new=8)[0]
    second = np.concatenate([first, prompt(95, 5)])
    box = tserving.KVMailbox()
    with faults.ChaosSchedule("serving.kv_migrate[b]@2:raise") as chaos:
        with pytest.raises(faults.FaultError):
            tserving.migrate_prefix(a, b, second, mailbox=box)
        chaos.verify()
    assert b.blocks_in_use == 0 and b.prefix_cache_size == 0
    assert tserving.migrate_prefix(a, b, second, mailbox=box) == 24
    assert b.metrics.get("kv_migrate_blocks") == 3
    assert b.metrics.get("kv_migrate_bytes") == \
        tserving.payload_bytes(a.export_prefix_blocks(second))
    # b's bf16 pool holds a's f32 rows rounded; from bf16 to bf16 the
    # rows cross bit for bit
    assert tserving.migrate_prefix(b, c, second, mailbox=box) == 24
    idx = torch.tensor(b._cache.match(second, second.size - 1)[0])
    jdx = torch.tensor(c._cache.match(second, second.size - 1)[0])
    assert torch.equal(b._ks[1][idx], c._ks[1][jdx])
    np.testing.assert_array_equal(drive(c, [second], max_new=8)[0],
                                  drive(b, [second], max_new=8)[0])
    with pytest.raises(tserving.PeerGoneError):
        box.recv("nobody", timeout=0.01)


def test_concurrent_exports_while_serving_stay_balanced(pair):
    """Exports from eight threads while the serve loop runs (switch
    interval shortened): every payload carries the same rows, every
    request completes, and the allocator ends balanced — a lost
    refcount update would leak or free a block."""
    import sys
    import threading

    _, tm, _ = pair
    eng = tserving.SlotEngine(tm, device="cpu", num_blocks=64, **ENGINE)
    eng.warmup()
    first = drive(eng, [prompt(57, 20)], max_new=8)[0]
    second = np.concatenate([first, prompt(94, 5)])
    want = eng.export_prefix_blocks(second)
    errors = []

    def exporter():
        try:
            for _ in range(10):
                got = eng.export_prefix_blocks(second)
                for (k, v), (wk, wv) in zip(got["layers"], want["layers"]):
                    assert np.array_equal(k, wk) and np.array_equal(v, wv)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        eng.start()
        futs = [eng.submit(prompt(60 + i, 12), max_new_tokens=10,
                           timeout=60.0) for i in range(6)]
        threads = [threading.Thread(target=exporter) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        for f in futs:
            assert np.asarray(f.result(60)).shape == (22,)
    finally:
        sys.setswitchinterval(interval)
        eng.shutdown()
    assert not errors, errors
    assert eng.metrics.get("failed") == 0
    assert eng.blocks_in_use == eng.prefix_cache_size
    assert all(eng._alloc.refcount(b) == 1
               for b in eng._cache._blocks.values())
