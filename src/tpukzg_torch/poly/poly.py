"""Evaluation-form barycentric evaluation and opening quotient over Fr
(counterpart of ``tpukzg/poly/poly.py``).

Inversion-free fraction tree:  sum_i e_i w^i / (z - w^i) = N(z) / (z^n - 1)
and p(z) = N(z) / n, in and out of the domain alike.  On the card kernel B4
(``kernels/fractree.py``) folds the whole tree to one pair a blob; on
the CPU the plain leaves fold here.
"""

from __future__ import annotations

import torch

from tpukzg_torch.field.mont import FR
from tpukzg_torch.kernels import fractree


def _fraction_merge(a, b, F=FR):
    """Fold (..., m, L) fraction pairs to one (..., L) numerator by
    pairwise merges (a, b) x (a', b') -> (a b' + a' b, b b')."""
    n = a.shape[-2]
    while n > 1:
        al, ar = a[..., 0::2, :], a[..., 1::2, :]
        bl, br = b[..., 0::2, :], b[..., 1::2, :]
        prod = F.mul(torch.cat([al, ar, bl], -2), torch.cat([br, bl, br], -2))
        m = n // 2
        a = F.add(prod[..., :m, :], prod[..., m:2 * m, :])
        b = prod[..., 2 * m:, :]
        n = m
    return a[..., 0, :]


def barycentric_eval(plan, evals, z, roots=None):
    """p(z) for evaluation-form p: evals (k, n, 16) Montgomery natural
    order, z (k, 16) Montgomery -> (k, 16) Montgomery."""
    if roots is None:
        roots = plan.on(evals.device, "roots")
    a, b = fractree.fractree_partials(evals, z, roots)
    num = _fraction_merge(a, b)
    return FR.mul(num, plan.on(evals.device, "n_inv"))


def eval_form_quotient(plan, evals, z, y, roots=None, F=FR):
    """Witness q(X) = (p(X) - y) / (X - z) in evaluation form: evals
    (..., n, 16), z and y (..., 16) Montgomery -> (..., n, 16).

    q_i = (e_i - y) / (w^i - z), with the inverses batched (``batch_inv``,
    zero -> zero).  Where z = w^m the denominator at m is zero and the
    correction q_m = -z^-1 sum_j (e_j - y) w^j / (w^j - z) is added
    there.  Both branches are computed and blended by the mask, with no
    data-dependent control flow (``tpukzg/poly/poly.py:97-112``)."""
    if roots is None:
        roots = torch.as_tensor(plan.roots, device=evals.device)
    num = F.sub(evals, y[..., None, :])                   # e_i - y
    den = F.sub(roots, z[..., None, :])                   # w^i - z
    mask = F.is_zero(den)                                 # only at m
    q = F.mul(num, F.batch_inv(den, axis=-2))
    s = F.sum_along(F.mul(q, roots), axis=-2)
    corr = F.neg(F.mul(F.inv(z), s))
    return F.add(q, torch.where(mask[..., None], corr[..., None, :],
                                torch.zeros_like(q)))
