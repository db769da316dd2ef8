"""Teacher / student distillation (counterpart of
scail_tpu/training/distill.py): both nets run under one module {teacher,
student}, the teacher under no-grad; only the student reaches the
optimizer; the loss is T²·KL(softmax(t/T) ‖ softmax(s/T)) mixed with the
hard-label cross entropy.
"""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

import torch
import torch.nn.functional as F

from scail_tpu_torch.training.prefix_tuning import subtree_optimizer


def distill_forward(tree, teacher_fn, student_fn, *args, **kwargs):
    """(teacher logits, student logits); the teacher runs without autograd,
    so it gets no gradient."""
    with torch.no_grad():
        t = teacher_fn(tree.teacher, *args, **kwargs)
    return t.detach(), student_fn(tree.student, *args, **kwargs)


def student_only_optimizer(make: Callable, named_params: Iterable[Tuple[str, torch.Tensor]]):
    """`make(params)` over the `student` parameters; the teacher frozen."""
    return subtree_optimizer("student", make, named_params)


def kd_loss(student_logits, teacher_logits, labels=None, *, temperature: float = 2.0,
            alpha: float = 0.5):
    """alpha · T² · KL(softmax(t/T) ‖ softmax(s/T)) + (1 - alpha) · CE(s,
    labels), means over every leading position; labels None: the soft term
    alone."""
    T = temperature
    t = F.log_softmax(teacher_logits / T, dim=-1)
    s = F.log_softmax(student_logits / T, dim=-1)
    soft = (t.exp() * (t - s)).sum(-1).mean() * (T * T)
    if labels is None:
        return soft
    hard = F.cross_entropy(student_logits.reshape(-1, student_logits.shape[-1]),
                           labels.reshape(-1))
    return alpha * soft + (1.0 - alpha) * hard
