"""Metrics: the port's own copy of ``paddle_tpu/metric/__init__.py``
(reference: python/paddle/metric/metrics.py - Metric:83, Accuracy:193,
Precision:302, Recall:397, Auc:477).

They accumulate on the host in numpy, as the JAX metrics do; a tensor
argument (on the card or the CPU) is copied to the host first, bfloat16
widened to float32.  ``hapi.Model`` hands them host arrays."""
from __future__ import annotations

import numpy as np

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _host(x) -> np.ndarray:
    """A tensor or array-like as a host numpy array."""
    if hasattr(x, "detach") and hasattr(x, "cpu"):
        x = x.detach()
        if x.dtype.is_floating_point and x.element_size() < 4:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def accuracy(pred, label, k: int = 1):
    """Top-k accuracy of softmax outputs (reference metric/metrics.py:22)."""
    pred = _host(pred)
    label = _host(label)
    if label.ndim == pred.ndim:
        label = label.squeeze(-1)
    topk = np.argsort(-pred, axis=-1)[..., :k]
    correct = (topk == label[..., None]).any(axis=-1)
    return float(correct.mean())


class Metric:
    def reset(self):
        raise NotImplementedError

    def compute(self, *args):
        """Pass-through by default (reference metric/metrics.py:158): the
        trainer calls ``m.update(*to_tuple(m.compute(out, label)))``;
        subclasses override compute to preprocess on the accelerator side."""
        return args

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self.__class__.__name__.lower()


class Accuracy(Metric):
    def __init__(self, topk=(1,), name="acc"):
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self._name = name
        self.reset()

    def reset(self):
        self.correct = np.zeros(len(self.topk))
        self.total = 0

    def compute(self, pred, label):
        """Returns per-sample correctness for each k (paddle compute/update
        split)."""
        pred = _host(pred)
        label = _host(label)
        if label.ndim == pred.ndim:
            label = label.squeeze(-1)
        maxk = max(self.topk)
        topk = np.argsort(-pred, axis=-1)[..., :maxk]
        return (topk == label[..., None])

    def update(self, correct):
        correct = _host(correct)
        for i, k in enumerate(self.topk):
            self.correct[i] += correct[..., :k].any(axis=-1).sum()
        self.total += correct.shape[0]
        return self.correct / max(self.total, 1)

    def accumulate(self):
        acc = (self.correct / max(self.total, 1)).tolist()
        return acc[0] if len(acc) == 1 else acc

    def name(self):
        return self._name


class Precision(Metric):
    def __init__(self, name="precision"):
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = (_host(preds) > 0.5).astype(np.int32).reshape(-1)
        labels = _host(labels).astype(np.int32).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

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
        preds = (_host(preds) > 0.5).astype(np.int32).reshape(-1)
        labels = _host(labels).astype(np.int32).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """Bucketed ROC-AUC (reference metrics.py:477 — same thresholded-bucket
    algorithm as the C++ auc op)."""

    def __init__(self, num_thresholds: int = 4095, name="auc"):
        self.num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def reset(self):
        self._pos = np.zeros(self.num_thresholds + 1, dtype=np.int64)
        self._neg = np.zeros(self.num_thresholds + 1, dtype=np.int64)

    def update(self, preds, labels):
        preds = _host(preds)
        if preds.ndim == 2:
            preds = preds[:, -1]  # P(class=1)
        labels = _host(labels).reshape(-1)
        idx = np.clip((preds * self.num_thresholds).astype(np.int64), 0,
                      self.num_thresholds)
        np.add.at(self._pos, idx[labels == 1], 1)
        np.add.at(self._neg, idx[labels == 0], 1)

    def accumulate(self):
        tot_pos = self._pos[::-1].cumsum()[::-1]
        tot_neg = self._neg[::-1].cumsum()[::-1]
        tp = np.concatenate([tot_pos, [0]])
        fp = np.concatenate([tot_neg, [0]])
        area = -np.trapezoid(tp, fp) if hasattr(np, "trapezoid") else -np.trapz(tp, fp)
        denom = tot_pos[0] * tot_neg[0]
        return float(area / denom) if denom else 0.0

    def name(self):
        return self._name
