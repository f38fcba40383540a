"""Streaming metrics (counterpart of paddle_tpu/metric): `Metric`,
`Accuracy` (top-k), `Precision`, `Recall`, `Auc` and the functional
`accuracy`.

`Accuracy.compute` and `accuracy` run on the predictions' device
(``torch.topk``); `update` / `accumulate` read the counts back and give
the reference's host floats. Where two classes tie, ``torch.topk`` and
the reference's ``argsort`` may order them differently. `Precision`,
`Recall` and `Auc` count on the host, as the reference does.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _as_tensor(x, device=None):
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def _topk_correct(pred, label, k):
    """``[..., k]`` float32: whether each of the k best classes is the
    label."""
    pred = _as_tensor(pred)
    label = _as_tensor(label, pred.device)
    if label.dim() == pred.dim() and label.shape[-1] == 1:
        label = label.squeeze(-1)
    order = torch.topk(pred, k, dim=-1).indices
    return (order == label.long()[..., None]).float()


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        return _topk_correct(pred, label, self.maxk)

    def update(self, correct, *args):
        correct = _as_tensor(correct)
        # one host read for every k
        hits = torch.stack([correct[..., :k].sum() for k in self.topk])
        hits = hits.double().cpu().tolist()
        num_samples = int(np.prod(correct.shape[:-1]))
        accs = []
        for i, num_correct in enumerate(hits):
            self.total[i] += num_correct
            self.count[i] += num_samples
            accs.append(float(num_correct) / max(num_samples, 1))
        return accs[0] if len(self.topk) == 1 else accs

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(self.topk) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds_np = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        labels_np = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(np.sum((preds_np == 1) & (labels_np == 1)))
        self.fp += int(np.sum((preds_np == 1) & (labels_np == 0)))

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds_np = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        labels_np = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(np.sum((preds_np == 1) & (labels_np == 1)))
        self.fn += int(np.sum((preds_np == 0) & (labels_np == 1)))

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """Streaming AUC by threshold buckets."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        self._curve = curve
        self._num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def reset(self):
        n = self._num_thresholds + 1
        self._stat_pos = np.zeros(n, dtype=np.int64)
        self._stat_neg = np.zeros(n, dtype=np.int64)

    def update(self, preds, labels):
        preds_np = _np(preds)
        labels_np = _np(labels).reshape(-1)
        pos_prob = preds_np[:, 1] if preds_np.ndim == 2 else \
            preds_np.reshape(-1)
        bins = np.clip((pos_prob * self._num_thresholds).astype(np.int64),
                       0, self._num_thresholds)
        for b, lbl in zip(bins, labels_np):
            if lbl:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def accumulate(self):
        tot_pos = 0.0
        tot_neg = 0.0
        auc = 0.0
        for i in range(self._num_thresholds, -1, -1):
            p = self._stat_pos[i]
            n = self._stat_neg[i]
            auc += n * tot_pos + p * n / 2.0
            tot_pos += p
            tot_neg += n
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        return auc / tot_pos / tot_neg

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """The share of rows whose label is among the k best classes, a
    float32 0-dim tensor on the predictions' device."""
    hit = _topk_correct(input, label, k).amax(dim=-1)
    return hit.mean()
