"""paddle.metric (port of paddle_tpu/metric/__init__.py).

``accuracy`` runs on the tensors' device; it takes the top k with a
stable sort, as ``jnp.argsort`` does, so ties pick the reference's
indices. The streaming metrics accumulate on the host in numpy with the
reference's code: a tensor (on the card, or bfloat16) is read back as a
float32 or integer numpy array first.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x):
    """A host numpy copy of a tensor (bfloat16 and float16 read as
    float32), or ``np.asarray`` of anything else."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def accuracy(input, label, k=1, correct=None, total=None, name=None):  # noqa: A002
    """The share of rows whose label is among the k largest logits, as a
    0-d float32 tensor on the input's device."""
    topk_idx = torch.argsort(-input, dim=-1, stable=True)[..., :k]
    lab = label
    if lab.dim() == topk_idx.dim() - 1:
        lab = lab.unsqueeze(-1)
    correct_ = (topk_idx == lab).any(dim=-1)
    return correct_.to(torch.float32).mean()


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

    def compute(self, pred, label, *args):
        p = _np(pred)
        l = _np(label)
        idx = np.argsort(-p, axis=-1)[..., :self.maxk]
        if l.ndim == idx.ndim - 1:
            l = l[..., None]
        correct = (idx == l)
        return torch.from_numpy(correct.astype(np.float32))

    def update(self, correct, *args):
        c = _np(correct)
        accs = []
        for k in self.topk:
            num = c[..., :k].sum()
            self.total[self.topk.index(k)] += num
            self.count[self.topk.index(k)] += c.shape[0]
            accs.append(num / c.shape[0])
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / c if c > 0 else 0.0 for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name=None):
        self._name = name or "precision"
        self.reset()

    def update(self, preds, labels):
        p = _np(preds).round().astype(int).reshape(-1)
        l = _np(labels).astype(int).reshape(-1)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fp += int(((p == 1) & (l == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name=None):
        self._name = name or "recall"
        self.reset()

    def update(self, preds, labels):
        p = _np(preds).round().astype(int).reshape(-1)
        l = _np(labels).astype(int).reshape(-1)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fn += int(((p == 0) & (l == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        self._name = name or "auc"
        self.num_thresholds = num_thresholds
        self.reset()

    def update(self, preds, labels):
        p = _np(preds)
        if p.ndim == 2:
            p = p[:, 1]
        l = _np(labels).reshape(-1)
        bins = np.clip((p * self.num_thresholds).astype(int), 0,
                       self.num_thresholds)
        for b, y in zip(bins, l):
            if y:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
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
