"""The eval subset of the JAX package's ``trainer/steps.py``:
:class:`FederatedTask` and :func:`eval_forward`, the one inference forward
that the serving engine runs."""

from __future__ import annotations

import torch


class FederatedTask:
    """Bundles a model with its apply plumbing. The weights and running
    statistics live in the ``nn.Module``."""

    def __init__(self, model):
        self.model = model

    def apply(self, x, train: bool = False, mask=None):
        return self.model(x, train=train, mask=mask)


def eval_forward(task: FederatedTask, x, y=None, w=None):
    """Softmax probabilities of ``x [B, ...]``; ``w [B]`` is the per-row
    valid mask (weight-0 rows are padding). With labels ``y`` it also
    returns the per-example cross-entropy; with ``y=None`` (serving) there
    is no label work at all."""
    with torch.inference_mode():
        logits = task.apply(x, train=False, mask=w)
        probs = torch.softmax(logits, -1)
        if y is None:
            return probs
        ce = -torch.log_softmax(logits, -1).gather(-1, y.long()[..., None])[..., 0]
        return probs, ce
