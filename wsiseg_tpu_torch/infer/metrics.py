"""Evaluation metrics, pure numpy (sklearn-free) — counterpart (a copy) of
``wsiseg_tpu/infer/metrics.py``.

Implements every metric the reference computes: tumor-bed IoU / masked pixel
accuracy / custom score s / foreground IoU (utils/eval.py:105-135),
classification accuracy + confusion matrix (utils/regiontools.py:174-181,
train_p.py:99-111), binary F1 (utils/eval.py:441-447), regression L1/MSE
(utils/eval.py:343-349), and ROC AUC
(paper_tools/check_for_false_positives.py:80-93).
"""

from __future__ import annotations

import numpy as np


def iou(pred: np.ndarray, gt: np.ndarray, eps: float = 1e-8) -> float:
    """Binary IoU (reference utils/eval.py:105)."""
    pred = np.asarray(pred).astype(bool)
    gt = np.asarray(gt).astype(bool)
    return float((gt & pred).sum() / (eps + (gt | pred).sum()))


def dice_coefficient(pred, gt, eps: float = 1e-8) -> float:
    pred = np.asarray(pred).astype(bool)
    gt = np.asarray(gt).astype(bool)
    return float(2 * (gt & pred).sum() / (eps + gt.sum() + pred.sum()))


def masked_pixel_accuracy(pred_labels, gt_labels) -> float:
    """Mean accuracy over gt>0 pixels (utils/eval.py:108-110)."""
    gt = np.asarray(gt_labels)
    sel = gt > 0
    if not sel.any():
        return float("nan")
    return float(np.mean(np.asarray(pred_labels)[sel] == gt[sel]))


def spie_score(pred_labels, gt_labels, max_class: float = 3.0) -> float:
    """The custom score ``s`` (utils/eval.py:111-112): 1 - Σ|p-g| normalized
    by the worst-case per-pixel error over pixels where either is nonzero."""
    p = np.asarray(pred_labels).astype(np.float64)
    g = np.asarray(gt_labels).astype(np.float64)
    denom = np.sum(np.maximum(np.abs(g - 0), np.abs(g - max_class))
                   * (1 - (1 - (p > 0)) * (1 - (g > 0))))
    if denom == 0:
        return float("nan")
    return float(1 - np.sum(np.abs(p - g)) / denom)


def foreground_iou(pred_labels, gt_labels, eps: float = 1e-8) -> float:
    """IoU of predicted-foreground vs gt-foreground (utils/eval.py:122)."""
    return iou(np.asarray(pred_labels) > 0, np.asarray(gt_labels) > 0, eps)


def confusion_matrix(gts, preds, num_classes: int) -> np.ndarray:
    gts = np.asarray(gts).astype(np.int64)
    preds = np.asarray(preds).astype(np.int64)
    cm = np.zeros((num_classes, num_classes), np.int64)
    np.add.at(cm, (gts, preds), 1)
    return cm


def classwise_accuracy(cm: np.ndarray) -> np.ndarray:
    """diag(cm / row-sums) (utils/regiontools.py:179-180)."""
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.diag(cm / cm.sum(1, keepdims=True))


def accuracy(gts, preds) -> float:
    gts, preds = np.asarray(gts), np.asarray(preds)
    return float(np.mean(gts == preds)) if gts.size else float("nan")


def f1_score(gts, preds) -> float:
    """Binary F1 with positive class 1 (sklearn f1_score default used at
    utils/eval.py:446)."""
    gts = np.asarray(gts).astype(bool)
    preds = np.asarray(preds).astype(bool)
    tp = float((gts & preds).sum())
    fp = float((~gts & preds).sum())
    fn = float((gts & ~preds).sum())
    if 2 * tp + fp + fn == 0:
        return 0.0
    return 2 * tp / (2 * tp + fp + fn)


def precision_recall(gts, preds) -> tuple[float, float]:
    gts = np.asarray(gts).astype(bool)
    preds = np.asarray(preds).astype(bool)
    tp = float((gts & preds).sum())
    fp = float((~gts & preds).sum())
    fn = float((gts & ~preds).sum())
    prec = tp / (tp + fp) if tp + fp else 0.0
    rec = tp / (tp + fn) if tp + fn else 0.0
    return prec, rec


def roc_auc(gts, scores) -> float:
    """AUC via the Mann-Whitney U statistic (ties handled by mid-ranks)."""
    gts = np.asarray(gts).astype(bool)
    scores = np.asarray(scores, dtype=np.float64)
    n_pos, n_neg = int(gts.sum()), int((~gts).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores)
    ranks = np.empty_like(order, dtype=np.float64)
    sorted_scores = scores[order]
    i = 0
    r = 1.0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i:j + 1]] = (r + r + (j - i)) / 2.0
        r += (j - i) + 1
        i = j + 1
    u = ranks[gts].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def regression_report(preds, gts) -> dict:
    preds = np.asarray(preds, np.float64)
    gts = np.asarray(gts, np.float64)
    out = {"l1": float(np.mean(np.abs(preds - gts))),
           "mse": float(np.mean((preds - gts) ** 2))}
    if preds.size > 1 and np.std(preds) > 0 and np.std(gts) > 0:
        out["pearson_r"] = float(np.corrcoef(preds, gts)[0, 1])
    return out
