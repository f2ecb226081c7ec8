"""paddle.metric: Accuracy, Precision, Recall, Auc and `accuracy`.

Port of paddle_tpu/metric, the same names, state and results. The top-k
of `Accuracy` and `accuracy` is torch's on the prediction's device; the
counts are accumulated on the host in numpy, as the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor


def _data(x):
    return x._data if isinstance(x, Tensor) else torch.as_tensor(x)


def _np(x):
    """A Tensor, torch tensor or array-like as a numpy array."""
    if isinstance(x, Tensor):
        return x.numpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _topk(pred, k, axis=-1):
    """(values, indices) of the top `k` along `axis`, as numpy arrays."""
    vals, idx = torch.topk(_data(pred).detach(), k, dim=axis)
    return vals.cpu().numpy(), idx.cpu().numpy()


class Metric:
    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self.__class__.__name__.lower()

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        _, idx = _topk(pred, self.maxk, axis=-1)
        lab = _np(label)
        if lab.ndim == idx.ndim:
            lab = lab.squeeze(-1) if lab.shape[-1] == 1 else np.argmax(lab, -1)
        correct = idx == lab[..., None]
        return Tensor._wrap(torch.from_numpy(correct.astype(np.float32)))

    def update(self, correct, *args):
        c = _np(correct)
        n = c.shape[0] if c.ndim else 1
        accs = []
        for i, k in enumerate(self.topk):
            num = float(c[..., :k].sum())
            self.total[i] += num
            self.count[i] += n
            accs.append(num / max(n, 1))
        return accs[0] if len(accs) == 1 else accs

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name=None):
        super().__init__()
        self._name = name or "precision"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = _np(preds)
        l = _np(labels)
        pred_pos = (p > 0.5).astype(np.int64).reshape(-1)
        l = l.reshape(-1)
        self.tp += int(((pred_pos == 1) & (l == 1)).sum())
        self.fp += int(((pred_pos == 1) & (l == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name=None):
        super().__init__()
        self._name = name or "recall"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = _np(preds)
        l = _np(labels)
        pred_pos = (p > 0.5).astype(np.int64).reshape(-1)
        l = l.reshape(-1)
        self.tp += int(((pred_pos == 1) & (l == 1)).sum())
        self.fn += int(((pred_pos == 0) & (l == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        super().__init__()
        if curve != "ROC":
            raise ValueError(
                f"Auc: only the ROC curve is implemented (got {curve!r}); "
                "the reference kernel likewise supports ROC only")
        self._name = name or "auc"
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _np(preds)
        l = _np(labels).reshape(-1)
        if p.ndim == 2:
            p = p[:, -1]
        idx = np.minimum((p * self.num_thresholds).astype(np.int64), self.num_thresholds)
        for i, lab in zip(idx, l):
            if lab:
                self._stat_pos[i] += 1
            else:
                self._stat_neg[i] += 1

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if not tot_pos or not tot_neg:
            return 0.0
        # trapezoid over thresholds descending
        pos_cum = np.cumsum(self._stat_pos[::-1])
        neg_cum = np.cumsum(self._stat_neg[::-1])
        tpr = pos_cum / tot_pos
        fpr = neg_cum / tot_neg
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        return float(trapezoid(tpr, fpr))

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    _, idx = _topk(input, k, axis=-1)
    lab = _np(label)
    if lab.ndim == 2 and lab.shape[-1] == 1:
        lab = lab.squeeze(-1)
    corr = (idx == lab[..., None]).any(-1)
    # legacy out-params: when given, they receive the running counts
    # (reference static accuracy op accumulates into them)
    if correct is not None:
        correct.set_value(np.asarray(corr.sum(), np.int64))
    if total is not None:
        total.set_value(np.asarray(corr.size, np.int64))
    return Tensor._wrap(torch.tensor(float(corr.mean()),
                                     dtype=torch.float32))
