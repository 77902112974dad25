"""Metrics (``paddle_tpu/metric/__init__.py``): `Accuracy` (top-k),
`Precision` and `Recall` (binary, at 0.5), `Auc` (a thresholded
histogram) and the functional `accuracy`.  They count on the host in
numpy, as the JAX package's do: a tensor argument is read to the host;
`Accuracy.compute` and `accuracy` answer a float32 tensor on the
prediction's device."""
import numpy as np
import torch


def _host(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _like(values, ref):
    """`values` as a tensor on `ref`'s device (the CPU for an array)."""
    dev = ref.device if isinstance(ref, torch.Tensor) else "cpu"
    return torch.from_numpy(values).to(dev)


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
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    """Top-k accuracy: `compute` marks, per row, whether each of the top
    `maxk` predictions is the label; `update` counts the top-k hits."""

    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        p, l = _host(pred), _host(label)
        pred_topk = np.argsort(-p, axis=-1)[..., : self.maxk]
        if l.ndim == p.ndim and l.shape[-1] == 1:
            l = l.squeeze(-1)
        correct = pred_topk == l[..., None]
        return _like(correct.astype(np.float32), pred)

    def update(self, correct, *args):
        c = _host(correct)
        accs = []
        for k in self.topk:
            num = c[..., :k].sum()
            accs.append(float(num) / max(c.shape[0], 1))
            self.total[self.topk.index(k)] += num
            self.count[self.topk.index(k)] += c.shape[0]
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / c if c else 0.0 for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    """Binary precision: predictions above 0.5 are positive."""

    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p, l = _host(preds), _host(labels)
        p = (p.reshape(-1) > 0.5).astype(np.int32)
        l = l.reshape(-1).astype(np.int32)
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
    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p, l = _host(preds), _host(labels)
        p = (p.reshape(-1) > 0.5).astype(np.int32)
        l = l.reshape(-1).astype(np.int32)
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
    """ROC AUC from `num_thresholds` histogram bins of the positive
    class's score."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self.num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p, l = _host(preds), _host(labels)
        if p.ndim == 2 and p.shape[1] == 2:
            p = p[:, 1]
        p = p.reshape(-1)
        l = l.reshape(-1)
        bins = np.minimum(
            (p * self.num_thresholds).astype(np.int64), self.num_thresholds - 1
        )
        for b, y in zip(bins, l):
            if y:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds, np.int64)
        self._stat_neg = np.zeros(self.num_thresholds, np.int64)

    def accumulate(self):
        tot_pos = 0.0
        tot_neg = 0.0
        auc = 0.0
        for i in range(self.num_thresholds - 1, -1, -1):
            pos = float(self._stat_pos[i])
            neg = float(self._stat_neg[i])
            auc += neg * (tot_pos + pos / 2.0)
            tot_pos += pos
            tot_neg += neg
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        return auc / (tot_pos * tot_neg)

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None):
    """The share of rows whose label is among the top `k` predictions, a
    [1] float32 tensor."""
    p, l = _host(input), _host(label)
    topk = np.argsort(-p, axis=-1)[..., :k]
    if l.ndim == p.ndim and l.shape[-1] == 1:
        l = l.squeeze(-1)
    acc = np.mean((topk == l[..., None]).any(-1).astype(np.float32))
    return _like(np.array([acc], np.float32), input)
