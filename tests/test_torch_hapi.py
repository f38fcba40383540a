"""Port parity: io (datasets, samplers, DataLoader), metric, the hapi
callbacks and `paddle_tpu_torch.Model` against paddle_tpu's.

- Under one ``np.random.seed`` the samplers yield the reference's index
  lists (an explicit ``numpy.random.RandomState`` generator the same
  ones as the global state seeded alike), and ``DataLoader`` batches are
  equal to the reference's at ``num_workers`` 0 and 2, shuffled or not.
- `Accuracy` (top-k, on tie-free logits), `Precision`, `Recall`, `Auc`
  and `accuracy` give the reference's values (counts exactly, rates
  within 1e-7).
- The callbacks see the same event sequence in both packages' ``fit``;
  `EarlyStopping`, `ReduceLROnPlateau` and `LRScheduler` reach the same
  state on the same logs; `ModelCheckpoint` and `VisualDL` write the
  same files.
- ``Model.fit`` / ``evaluate`` / ``predict`` on the tiny GPT (AdamW,
  `GPTPretrainingCriterion`, `Accuracy(topk=(1, 5))`, a shuffled
  loader): per-step losses and the evaluation loss within rtol 1e-5,
  the accuracies equal, the predicted logits within 1e-4; the eager
  path (``jit_compile=False``) likewise; ``save`` then ``load`` into a
  fresh model evaluates bit for bit the same, the ``.pdopt`` holds the
  reference's keys, and the reference's files load into the port.
- ``prepare``'s ``amp_configs`` choose the reference's loss scaling.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import io as jio
from paddle_tpu import metric as jmetric
from paddle_tpu.hapi import callbacks as jcb
from paddle_tpu.nn.layer import layers as jlayers
from paddle_tpu.nlp.transformers.gpt import (
    GPTConfig as JConfig, GPTPretrainingCriterion as JCrit,
)

import paddle_tpu_torch as pt
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import metric as tmetric
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.hapi import callbacks as tcb
from paddle_tpu_torch.nn.layer import layers as tlayers
from paddle_tpu_torch.nlp.transformers import gpt as tgpt
from torch_parity import build_pair

TINY = dict(vocab_size=128, hidden_size=32, num_heads=2, num_layers=2,
            max_seq_len=16)


def _np_tree(batch):
    if isinstance(batch, (list, tuple)):
        return [_np_tree(b) for b in batch]
    if isinstance(batch, dict):
        return {k: _np_tree(v) for k, v in batch.items()}
    if isinstance(batch, torch.Tensor):
        return batch.numpy()
    return np.asarray(batch._value) if hasattr(batch, "_value") else batch


def _data(n=22):
    rng = np.random.RandomState(0)
    return (rng.randn(n, 3).astype(np.float32),
            rng.randint(0, 9, (n,)).astype(np.int64))


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("shuffle", [False, True])
def test_dataloader_batches_match_reference(workers, shuffle):
    x, y = _data()
    out = []
    for io, kw in ((jio, {}), (tio, {"places": "cpu"})):
        np.random.seed(7)
        loader = io.DataLoader(io.TensorDataset([x, y]), batch_size=5,
                               shuffle=shuffle, num_workers=workers, **kw)
        out.append([_np_tree(b) for b in loader])
    want, got = out
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


class _WorkerDataset:
    """Samples of a dict tagged with the worker that made them."""

    def __init__(self, io):
        self.io = io

    def __len__(self):
        return 8

    def __getitem__(self, i):
        info = self.io.get_worker_info()
        return {"i": np.int64(i), "w": np.int64(-1 if info is None
                                                  else info.id)}


def test_dataloader_workers_dicts_and_worker_info():
    batches = list(tio.DataLoader(_WorkerDataset(tio), batch_size=2,
                                  num_workers=2, places="cpu"))
    assert [b["i"].tolist() for b in batches] == [[0, 1], [2, 3], [4, 5],
                                                  [6, 7]]
    assert {int(b["w"][0]) for b in batches} == {0, 1}
    assert tio.get_worker_info() is None
    main = list(tio.DataLoader(_WorkerDataset(tio), batch_size=4,
                               use_buffer_reader=False))
    assert main[0]["w"].tolist() == [-1] * 4


def test_dataloader_refuses_tensors_from_workers():
    class Bad(tio.Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            return torch.ones(2)

    with pytest.raises(RuntimeError, match="torch Tensor"):
        list(tio.DataLoader(Bad(), batch_size=2, num_workers=2,
                            places="cpu"))


def test_samplers_match_reference():
    x, y = _data(10)

    def draws(io):
        ds = io.TensorDataset([x, y])
        np.random.seed(3)
        out = [list(io.RandomSampler(ds)),
               list(io.RandomSampler(ds, replacement=True, num_samples=6)),
               list(io.WeightedRandomSampler([1, 2, 3, 4], 8)),
               [s.indices for s in io.random_split(ds, [4, 6])]]
        bs = io.DistributedBatchSampler(ds, batch_size=2, num_replicas=3,
                                        rank=1, shuffle=True)
        bs.set_epoch(2)
        out.append(list(bs))
        out.append(list(io.BatchSampler(ds, shuffle=False, batch_size=4,
                                        drop_last=True)))
        comp = io.ComposeDataset([ds, io.Subset(ds, [3, 1, 2])])
        out.append([len(comp), [np.asarray(v).tolist() for v in comp[1]]])
        chain = io.ChainDataset([[1, 2], [3]])
        out.append(list(iter(chain)))
        return out

    assert draws(tio) == draws(jio)
    np.random.seed(5)
    want = list(jio.RandomSampler(jio.TensorDataset([x])))
    got = list(tio.RandomSampler(tio.TensorDataset([x]),
                                 generator=np.random.RandomState(5)))
    assert got == want


def test_metrics_match_reference():
    rng = np.random.RandomState(1)
    # tie-free logits: a permutation per row
    logits = np.stack([rng.permutation(10) for _ in range(24)]).astype(
        np.float32).reshape(2, 3, 4, 10)
    labels = rng.randint(0, 10, (2, 3, 4))
    for topk in ((1,), (1, 5), (3,)):
        jacc, tacc = jmetric.Accuracy(topk=topk), tmetric.Accuracy(topk=topk)
        for i in range(2):
            jc = jacc.compute(paddle.to_tensor(logits[i]),
                              paddle.to_tensor(labels[i]))
            tc = tacc.compute(torch.from_numpy(logits[i]),
                              torch.from_numpy(labels[i]))
            np.testing.assert_array_equal(tc.numpy(), np.asarray(jc._value))
            assert tacc.update(tc) == jacc.update(jc)
        assert tacc.accumulate() == jacc.accumulate()
        assert tacc.name() == jacc.name()
    want = float(np.asarray(jmetric.accuracy(
        paddle.to_tensor(logits[0]), paddle.to_tensor(labels[0]),
        k=2)._value))
    got = float(tmetric.accuracy(torch.from_numpy(logits[0]),
                                 torch.from_numpy(labels[0]), k=2))
    np.testing.assert_allclose(got, want, rtol=1e-7)
    probs = rng.rand(40).astype(np.float32)
    hits = (rng.rand(40) < 0.5).astype(np.int64)
    for name in ("Precision", "Recall", "Auc"):
        jm_, tm_ = getattr(jmetric, name)(), getattr(tmetric, name)()
        jm_.update(probs, hits)
        tm_.update(torch.from_numpy(probs), torch.from_numpy(hits))
        np.testing.assert_allclose(tm_.accumulate(), jm_.accumulate(),
                                   rtol=1e-7)


def _recorder(cb):
    class Recorder(cb.Callback):
        def __init__(self):
            super().__init__()
            self.events = []
            self.losses = []

        def __getattribute__(self, name):
            attr = object.__getattribute__(self, name)
            if name.startswith("on_"):
                def hook(*args, **kwargs):
                    logs = kwargs.get("logs", args[-1] if args and
                                      isinstance(args[-1], dict) else None)
                    step = args[0] if args and isinstance(args[0], int) \
                        else None
                    self.events.append((name, step))
                    if name == "on_train_batch_end":
                        self.losses.append(logs["loss"])
                    if name == "on_eval_end":
                        self.eval_logs = dict(logs)
                    return attr(*args, **kwargs)
                return hook
            return attr

    return Recorder()


def _gpt_models(seed=0):
    """The tiny GPT in both packages, with the same automatic parameter
    names (the eager `.pdopt` keys): both name counters reset first."""
    jlayers._auto_name_counters.clear()
    tlayers._auto_name_counters.clear()
    jm, tm, _ = build_pair(seed=seed, **TINY)
    jm.train()
    tm.train()
    return jm, tm


def _gpt_data(n, seed):
    ids = np.random.RandomState(seed).randint(0, 128, (n, 17))
    return ids[:, :-1].astype(np.int64), ids[:, 1:].astype(np.int64)


def _prepare(pkg, net, jit=True):
    if pkg == "ref":
        return paddle.Model(net).prepare(
            paddle.optimizer.AdamW(1e-3, parameters=net.parameters(),
                                   weight_decay=0.01),
            JCrit(JConfig(**TINY, use_parallel=False)),
            metrics=jmetric.Accuracy(topk=(1, 5)), jit_compile=jit)
    return pt.Model(net).prepare(
        topt.AdamW(1e-3, parameters=net.parameters(), weight_decay=0.01),
        tgpt.GPTPretrainingCriterion(
            tgpt.GPTConfig(**TINY, use_parallel=False)),
        metrics=tmetric.Accuracy(topk=(1, 5)), jit_compile=jit)


@pytest.mark.parametrize("jit", [True, False], ids=["engine", "eager"])
def test_model_fit_evaluate_predict_match_reference(jit, tmp_path):
    jm, tm = _gpt_models()
    train = _gpt_data(12, 1)
    evald = _gpt_data(8, 2)
    runs = {}
    for pkg, net, io, cb in (("ref", jm, jio, jcb), ("port", tm, tio, tcb)):
        model = _prepare(pkg, net, jit)
        rec = _recorder(cb)
        np.random.seed(11)
        model.fit(io.TensorDataset(list(train)),
                  eval_data=io.TensorDataset(list(evald)), batch_size=4,
                  epochs=2, shuffle=True, verbose=0, callbacks=[rec])
        logs = model.evaluate(io.TensorDataset(list(evald)), batch_size=4,
                              verbose=0)
        pred = model.predict(io.TensorDataset([evald[0]]), batch_size=4,
                             stack_outputs=True)
        runs[pkg] = (rec, logs, pred[0], model)
    (jrec, jlogs, jpred, jmodel), (trec, tlogs, tpred, tmodel) = \
        runs["ref"], runs["port"]
    assert trec.events == jrec.events
    assert len(trec.losses) == 6
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=1e-5)
    assert trec.losses[-1] < trec.losses[0]
    assert sorted(tlogs) == sorted(jlogs) == ["eval_acc_top1",
                                              "eval_acc_top5", "eval_loss"]
    np.testing.assert_allclose(tlogs["eval_loss"], jlogs["eval_loss"],
                               rtol=1e-5)
    assert tlogs["eval_acc_top1"] == jlogs["eval_acc_top1"]
    assert tlogs["eval_acc_top5"] == jlogs["eval_acc_top5"]
    np.testing.assert_allclose(trec.eval_logs["eval_loss"],
                               jrec.eval_logs["eval_loss"], rtol=1e-5)
    np.testing.assert_allclose(tpred, jpred, rtol=1e-4, atol=1e-4)

    # save, then load into a fresh model: bit for bit the same evaluation
    path = str(tmp_path / "port")
    tmodel.save(path)
    jmodel.save(str(tmp_path / "ref"))
    assert sorted(pt.load(path + ".pdopt")) == \
        sorted(paddle.load(str(tmp_path / "ref") + ".pdopt"))
    fresh = _prepare("port", _gpt_models(seed=5)[1], jit)
    fresh.load(path)
    again = fresh.evaluate(tio.TensorDataset(list(evald)), batch_size=4,
                           verbose=0)
    assert again == tlogs
    # the reference's files load into the port
    other = _prepare("port", _gpt_models(seed=6)[1], jit)
    other.load(str(tmp_path / "ref"))
    theirs = other.evaluate(tio.TensorDataset(list(evald)), batch_size=4,
                            verbose=0)
    np.testing.assert_allclose(theirs["eval_loss"], jlogs["eval_loss"],
                               rtol=1e-5)


def test_callbacks_reach_the_reference_state(tmp_path):
    logs = [{"eval_loss": v, "eval_acc": 1 - v}
            for v in (1.0, 0.9, 0.95, 0.97, 0.99, 0.5)]

    class Holder:
        def __init__(self, opt):
            self._optimizer = opt
            self.stop_training = False
            self.saved = []

        def save(self, path):
            self.saved.append(os.path.basename(path))

    states = []
    for cb, opt in ((jcb, paddle.optimizer.SGD(
            paddle.optimizer.lr.StepDecay(0.1, step_size=2))),
                    (tcb, topt.SGD(topt.lr.StepDecay(0.1, step_size=2)))):
        plain = (paddle.optimizer.SGD(0.1) if cb is jcb else topt.SGD(0.1))
        holder, plain_holder = Holder(opt), Holder(plain)
        es = cb.EarlyStopping(monitor="loss", patience=2, verbose=0)
        es.set_model(holder)
        es.set_params({"save_dir": str(tmp_path)})
        rl = cb.ReduceLROnPlateau(monitor="acc", patience=1, verbose=0,
                                  factor=0.5)
        rl.set_model(plain_holder)
        sch = cb.LRScheduler(by_step=True)
        sch.set_model(holder)
        ck = cb.ModelCheckpoint(save_freq=2, save_dir=str(tmp_path))
        ck.set_model(holder)
        vd = cb.VisualDL(log_dir=str(tmp_path / cb.__name__))
        es.on_train_begin()
        for epoch, lg in enumerate(logs):
            es.on_epoch_begin(epoch)
            es.on_eval_end(lg)
            rl.on_eval_end(lg)
            sch.on_train_batch_end(epoch)
            vd.on_train_batch_end(epoch, {"loss": lg["eval_loss"]})
            ck.on_epoch_end(epoch)
        ck.on_train_end()
        with open(tmp_path / cb.__name__ / "scalars.jsonl") as f:
            lines = f.read()
        states.append((es.best, es.wait, es.stopped_epoch,
                       holder.stop_training, plain.get_lr(), opt.get_lr(),
                       holder.saved, lines))
    assert states[0] == states[1]


def test_amp_configs_choose_the_reference_loss_scaling():
    net = tgpt.GPTForPretraining(tgpt.GPTConfig(**TINY, use_parallel=False),
                                 device="cpu")
    for cfg in ("O1", {"level": "O1", "dtype": "float16"},
                {"level": "O1", "init_loss_scaling": 1024.0},
                {"level": "O1", "use_dynamic_loss_scaling": False},
                {"level": "O0"}, "O2", {"level": "O2", "dtype": "float16"}):
        jmod = paddle.Model(None).prepare(amp_configs=cfg)
        tmod = pt.Model(net).prepare(amp_configs=cfg)
        assert (tmod._amp_level, tmod._amp_dtype, tmod._loss_scale) == \
            (jmod._amp_level, jmod._amp_dtype, jmod._loss_scale), cfg
    with pytest.raises(NotImplementedError):
        pt.Model(net).flops()
    assert pt.Model(net).summary()["total_params"] == sum(
        p.numel() for p in net.parameters())
