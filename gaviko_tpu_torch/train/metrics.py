"""Evaluation metrics: accuracy, quadratic Cohen's kappa, macro-OVR ROC-AUC.

Port of ``gaviko_tpu/train/metrics.py``, which is numpy only, so this is a
copy. The reference computes these with sklearn (ref: src/eval.py:120-122);
pure numpy keeps the eval path free of an sklearn dependency.
"""

from __future__ import annotations

import numpy as np


def accuracy(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    return float(np.mean(np.asarray(y_true) == np.asarray(y_pred)))


def cohen_kappa_quadratic(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Quadratic-weighted Cohen's kappa over the union of observed labels."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    labels = np.unique(np.concatenate([y_true, y_pred]))
    k = len(labels)
    idx = {v: i for i, v in enumerate(labels)}
    conf = np.zeros((k, k), dtype=np.float64)
    for t, p in zip(y_true, y_pred):
        conf[idx[t], idx[p]] += 1
    w = np.zeros((k, k))
    for i in range(k):
        for j in range(k):
            w[i, j] = (i - j) ** 2 / (k - 1) ** 2 if k > 1 else 0.0
    row = conf.sum(axis=1)
    col = conf.sum(axis=0)
    expected = np.outer(row, col) / max(conf.sum(), 1.0)
    denom = (w * expected).sum()
    if denom == 0:
        return 1.0
    return float(1.0 - (w * conf).sum() / denom)


def _binary_auc(y_true: np.ndarray, score: np.ndarray) -> float:
    """Mann-Whitney AUC with average-rank tie handling."""
    order = np.argsort(score, kind="mergesort")
    s = score[order]
    y = y_true[order]
    n = len(s)
    ranks = np.empty(n, dtype=np.float64)
    i = 0
    while i < n:
        j = i
        while j + 1 < n and s[j + 1] == s[i]:
            j += 1
        ranks[i : j + 1] = 0.5 * (i + j) + 1.0
        i = j + 1
    n_pos = y.sum()
    n_neg = n - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    return float((ranks[y == 1].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def roc_auc_ovr_macro(y_true: np.ndarray, y_proba: np.ndarray) -> float:
    """One-vs-rest macro AUC (sklearn roc_auc_score(multi_class='ovr',
    average='macro') semantics)."""
    y_true = np.asarray(y_true)
    y_proba = np.asarray(y_proba)
    aucs = []
    for c in range(y_proba.shape[1]):
        mask = (y_true == c).astype(np.int64)
        if mask.sum() == 0 or mask.sum() == len(mask):
            continue
        aucs.append(_binary_auc(mask, y_proba[:, c]))
    return float(np.mean(aucs)) if aucs else float("nan")
