"""Metrics and running averages: the port's own copy of the JAX package's
``trainer/metrics.py``.

The reference's metric objects are fed positive-class probabilities (the
ICA trainer, ``comps/icalstm/__init__.py:64-65``) or hard predictions, with
labels, and give accuracy, F1, precision, recall and AUC; ``Averages``
keeps a running loss mean. ``monitor_metric`` and ``metric_direction``
drive early stopping and best-state selection. The device side only
returns the raw probabilities; the scalars are computed here in numpy
(exact AUC: eval sets are hundreds of subjects).
"""

from __future__ import annotations

import numpy as np


class Averages:
    """Running weighted mean (reference ``new_averages()``)."""

    def __init__(self):
        self.total = 0.0
        self.count = 0.0

    def add(self, value: float, n: float = 1.0):
        self.total += float(value) * float(n)
        self.count += float(n)
        return self

    def merge(self, other: "Averages"):
        self.total += other.total
        self.count += other.count
        return self

    @property
    def avg(self) -> float:
        return self.total / self.count if self.count else 0.0

    def get(self):
        return [round(self.avg, 5)]


class _MetricValues:
    """Shared ``value()``/``get()`` dispatch over the named scalar metrics."""

    def value(self, name: str) -> float:
        name = name.lower()
        fns = {
            "accuracy": self.accuracy,
            "f1": self.f1,
            "precision": self.precision,
            "recall": self.recall,
            "auc": self.auc,
        }
        if name not in fns:
            raise ValueError(f"unknown metric {name!r} (have {sorted(fns)})")
        return fns[name]()

    def get(self, *names) -> list[float]:
        names = names or ("accuracy", "f1")
        return [round(self.value(n), 5) for n in names]


class ClassificationMetrics(_MetricValues):
    """Binary classification metrics from accumulated scores+labels
    (reference ``new_metrics()``). ``scores`` may be hard predictions (0/1)
    or positive-class probabilities — AUC handles both (rank-based)."""

    def __init__(self):
        self.scores: list[np.ndarray] = []
        self.labels: list[np.ndarray] = []

    def add(self, scores, labels, weights=None):
        scores = np.asarray(scores, np.float64).reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        if weights is not None:
            keep = np.asarray(weights).reshape(-1) > 0
            scores, labels = scores[keep], labels[keep]
        self.scores.append(scores)
        self.labels.append(labels.astype(np.int64))
        return self

    def merge(self, other: "ClassificationMetrics"):
        self.scores += other.scores
        self.labels += other.labels
        return self

    def _cat(self):
        if not self.scores:
            return np.zeros(0), np.zeros(0, np.int64)
        return np.concatenate(self.scores), np.concatenate(self.labels)

    # -- scalar metrics --------------------------------------------------

    def accuracy(self) -> float:
        s, y = self._cat()
        if not len(y):
            return 0.0
        return float(((s >= 0.5).astype(np.int64) == y).mean())

    def _counts(self):
        s, y = self._cat()
        p = (s >= 0.5).astype(np.int64)
        tp = int(((p == 1) & (y == 1)).sum())
        fp = int(((p == 1) & (y == 0)).sum())
        fn = int(((p == 0) & (y == 1)).sum())
        tn = int(((p == 0) & (y == 0)).sum())
        return tp, fp, fn, tn

    def precision(self) -> float:
        tp, fp, _, _ = self._counts()
        return tp / (tp + fp) if tp + fp else 0.0

    def recall(self) -> float:
        tp, _, fn, _ = self._counts()
        return tp / (tp + fn) if tp + fn else 0.0

    def f1(self) -> float:
        p, r = self.precision(), self.recall()
        return 2 * p * r / (p + r) if p + r else 0.0

    def auc(self) -> float:
        """Exact ROC-AUC via the Mann-Whitney U statistic (tie-aware)."""
        s, y = self._cat()
        pos = s[y == 1]
        neg = s[y == 0]
        if not len(pos) or not len(neg):
            return 0.0
        order = np.argsort(np.concatenate([pos, neg]), kind="mergesort")
        ranks = np.empty(len(order), np.float64)
        ranks[order] = np.arange(1, len(order) + 1)
        # average ranks for ties
        allv = np.concatenate([pos, neg])
        sorted_v = allv[order]
        i = 0
        while i < len(sorted_v):
            j = i
            while j + 1 < len(sorted_v) and sorted_v[j + 1] == sorted_v[i]:
                j += 1
            if j > i:
                ranks[order[i : j + 1]] = (i + 1 + j + 1) / 2.0
            i = j + 1
        r_pos = ranks[: len(pos)].sum()
        u = r_pos - len(pos) * (len(pos) + 1) / 2.0
        return float(u / (len(pos) * len(neg)))


class MulticlassMetrics(_MetricValues):
    """Metrics for ``num_class > 2`` from accumulated full probability rows.

    The reference only ever evaluates binary heads (AUC on ``prob[:, 1]``,
    ``comps/icalstm/__init__.py:64-65``), but ``num_class`` is a GUI knob —
    this covers the configurable case instead of silently mis-scoring it:
    accuracy from argmax, macro-averaged one-vs-rest precision/recall/F1/AUC.
    Exposes the same ``value()/get()`` interface as ClassificationMetrics.
    """

    def __init__(self):
        self.probs: list[np.ndarray] = []
        self.labels: list[np.ndarray] = []

    def add(self, probs, labels, weights=None):
        probs = np.asarray(probs, np.float64).reshape(-1, np.asarray(probs).shape[-1])
        labels = np.asarray(labels).reshape(-1)
        if weights is not None:
            keep = np.asarray(weights).reshape(-1) > 0
            probs, labels = probs[keep], labels[keep]
        self.probs.append(probs)
        self.labels.append(labels.astype(np.int64))
        return self

    def merge(self, other: "MulticlassMetrics"):
        self.probs += other.probs
        self.labels += other.labels
        return self

    def _cat(self):
        if not self.probs:
            return np.zeros((0, 1)), np.zeros(0, np.int64)
        return np.concatenate(self.probs), np.concatenate(self.labels)

    def accuracy(self) -> float:
        p, y = self._cat()
        return float((p.argmax(-1) == y).mean()) if len(y) else 0.0

    def _ovr(self, name: str) -> float:
        """Macro-average a binary metric one-vs-rest over non-degenerate
        classes. A class absent from the eval set (or, for AUC, one covering
        the whole set) has no defined one-vs-rest score — including it as 0.0
        would deflate the macro average and corrupt best-state selection."""
        p, y = self._cat()
        if not len(y):
            return 0.0
        vals = []
        for c in range(p.shape[-1]):
            pos = y == c
            if not pos.any() or (name == "auc" and pos.all()):
                continue
            m = ClassificationMetrics()
            if name == "auc":
                m.add(p[:, c], pos.astype(np.int64))
            else:
                m.add((p.argmax(-1) == c).astype(np.float64), pos.astype(np.int64))
            vals.append(m.value(name))
        return float(np.mean(vals)) if vals else 0.0

    def precision(self) -> float:
        return self._ovr("precision")

    def recall(self) -> float:
        return self._ovr("recall")

    def f1(self) -> float:
        return self._ovr("f1")

    def auc(self) -> float:
        return self._ovr("auc")


def is_improvement(new: float, best: float | None, direction: str = "maximize") -> bool:
    """``metric_direction`` semantics (``compspec.json:254-255``)."""
    if best is None:
        return True
    return new > best if direction == "maximize" else new < best
