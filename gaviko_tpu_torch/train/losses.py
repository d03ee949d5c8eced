"""Loss functions: multi-class focal loss (reference-parity + corrected) and CE.

Port of ``gaviko_tpu/train/losses.py``. The reference focal loss
(src/losses/focal_loss.py) applies its clamp-then-softmax ``_process_preds``
twice, i.e. softmax(softmax(clamp(logits))) (PARITY #1). ``parity=True``
reproduces that; ``parity=False`` is the corrected single log-softmax form.

Each loss is a sum over the valid rows divided by their count. A data shard
of a sharded step (``parallel/mesh.py``) passes ``denominator``, the whole
batch's count of valid rows, so the shards' losses and gradients sum to the
whole batch's.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def _process_preds(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Ref focal_loss.py:84-91 (the second, surviving definition)."""
    x = torch.clamp(x, eps, 1.0 - eps)
    if x.shape[-1] == 1:  # binary branch
        return torch.sigmoid(x)
    return torch.softmax(x, dim=-1)


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, gamma: float, *,
               ignore_index: int = -100, eps: float = 1e-16,
               parity: bool = True, denominator=None) -> torch.Tensor:
    """Mean multi-class focal loss over [B, C] logits and int labels [B],
    rows labelled ``ignore_index`` left out."""
    mask = labels == ignore_index
    safe = torch.where(mask, torch.zeros_like(labels), labels)
    if parity:
        x = _process_preds(logits, eps)  # focal_loss.py:94
        x = _process_preds(x, eps)  # focal_loss.py:102 (double apply)
        target = F.one_hot(safe, x.shape[-1]).to(x.dtype)
        pt = (target * x).sum(-1) * (~mask)
        nll = torch.where(mask, torch.zeros_like(pt), -torch.log(eps + pt))
        loss = (1.0 - pt) ** gamma * nll
    else:
        logpt = torch.log_softmax(logits, dim=-1).gather(-1, safe[:, None])[:, 0]
        pt = torch.exp(logpt)
        loss = torch.where(mask, torch.zeros_like(pt), -(1.0 - pt) ** gamma * logpt)
    return loss.sum() / ((~mask).sum() if denominator is None else denominator)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = -100, denominator=None) -> torch.Tensor:
    """Mean CE over non-ignored rows (torch nn.CrossEntropyLoss defaults)."""
    mask = labels == ignore_index
    safe = torch.where(mask, torch.zeros_like(labels), labels)
    nll = -torch.log_softmax(logits, dim=-1).gather(-1, safe[:, None])[:, 0]
    nll = torch.where(mask, torch.zeros_like(nll), nll)
    if denominator is None:
        denominator = (~mask).sum().clamp_min(1)
    return nll.sum() / denominator


def make_criterion(train_cfg: dict) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """loss_fn selection (ref: train.py:176-179; gamma=1.2 hardcoded there)."""
    if train_cfg.get("loss_fn") == "focal_loss":
        parity = train_cfg.get("focal_parity", True)
        return lambda logits, labels, denominator=None: focal_loss(
            logits, labels, gamma=1.2, parity=parity, denominator=denominator)
    return cross_entropy_loss
