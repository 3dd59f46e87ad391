"""KZG commit, open, verify and batch verification (counterpart of
``tpukzg/kzg/core.py:34-44, 48-148, 170-227``).

Commit and open are MSMs against a fixed-base table of the Lagrange
(evaluation form) or monomial (coefficient form) SRS, built once per
basis on the setup's device.  Open is the barycentric eval, the
evaluation-form quotient and one such MSM; the coefficient-form calls go
through the NTT first.

Verify checks e(C - [y]_1 + [z] pi, [1]_2) == e(pi, [tau]_2): the left
point from one G1 ladder over the lanes ([y] G1, [z] pi) and two adds,
then the two pairings on the precomputed lines.

Batch verify folds the k openings by powers of rho into ONE grouped MSM
over 3k+1 points, groups (k, 2k+1), then two pairings on the
precomputed lines:
    e(sum rho^i pi_i, [tau]_2) == e(sum rho^i (C_i - [y_i]_1 + z_i pi_i), [1]_2)

MSM scalars are canonical Fr limbs; field data (evals, coefficients, z,
y) is Montgomery.  Points are (X, Y, Z) tuples of (..., 24) tensors.
"""

from __future__ import annotations

import torch

from tpukzg_torch.curve import g1 as g1m
from tpukzg_torch.curve.weierstrass_lm import G1_LM
from tpukzg_torch.field.mont import FP, FR, upload
from tpukzg_torch.kzg.setup import Setup
from tpukzg_torch.msm.pippenger_lm import (build_fixed_table, default_window,
                                           msm_fixed, msm_grouped)
from tpukzg_torch.pairing.check import pairing_check
from tpukzg_torch.poly.poly import barycentric_eval, eval_form_quotient


class Kzg:
    def __init__(self, setup: Setup):
        self.setup = setup
        self.n = setup.n
        self.device = setup.device
        self.plan = setup.plan
        self.roots = torch.as_tensor(setup.plan.roots, device=self.device)
        self.c_commit = default_window(self.n)
        self._tables: dict = {}

    # -- fixed-base SRS tables ---------------------------------------------

    def table(self, name: str):
        """Window table of the "lag" or "mono" SRS basis, built at first
        use and kept on the device."""
        t = self._tables.get(name)
        if t is None:
            pts = (self.setup.lagrange_g1 if name == "lag"
                   else self.setup.monomial_g1)
            t = self._tables[name] = build_fixed_table(pts, self.c_commit)
        return t

    def _msm_fixed(self, name: str, scalars_mont):
        """(..., n, 16) Montgomery scalars -> points (...)."""
        ks = FR.from_mont(scalars_mont)                  # canonical bits
        batch = ks.shape[:-2]
        out = msm_fixed(self.table(name), ks.reshape(-1, self.n, 16),
                        self.c_commit)
        return tuple(o.reshape(batch + (24,)) for o in out)

    # -- commit / open -----------------------------------------------------

    def commit(self, evals_mont):
        """Evaluation-form commit C = sum e_i [L_i(tau)]_1."""
        return self._msm_fixed("lag", evals_mont)

    def commit_coeff(self, coeffs_mont):
        """Coefficient-form commit C = sum a_i [tau^i]_1."""
        return self._msm_fixed("mono", coeffs_mont)

    def eval_at(self, evals_mont, z_mont):
        """p(z) for evaluation-form p: (..., n, 16), (..., 16) -> (..., 16)."""
        batch = evals_mont.shape[:-2]
        ev = evals_mont.reshape(-1, self.n, 16)
        z = torch.broadcast_to(z_mont, batch + (16,)).reshape(-1, 16)
        return barycentric_eval(self.plan, ev, z, self.roots).reshape(
            batch + (16,))

    def open(self, evals_mont, z_mont):
        """Open at z -> (proof point, y Montgomery)."""
        y = self.eval_at(evals_mont, z_mont)
        q = eval_form_quotient(self.plan, evals_mont, z_mont, y, self.roots)
        return self._msm_fixed("lag", q), y

    def open_coeff(self, coeffs_mont, z_mont):
        """Coefficient form: NTT, then `open`."""
        return self.open(self.to_evals(coeffs_mont), z_mont)

    def interpolate(self, evals_mont):
        """Natural-order evaluations -> coefficients (iNTT)."""
        return self.plan.intt(evals_mont)

    def to_evals(self, coeffs_mont):
        """Coefficients -> natural-order evaluations (NTT)."""
        return self.plan.ntt(coeffs_mont)

    # -- verify ------------------------------------------------------------

    def verify_lhs(self, c_point, z_can, y_can, proof_point):
        """C - [y] G1 + [z] pi for (..., 24) points and (..., 16) canonical
        z, y; batch axes broadcast.  [y] G1 and [z] pi are one ladder
        over a leading axis of two."""
        batch = torch.broadcast_shapes(c_point[0].shape[:-1],
                                       proof_point[0].shape[:-1],
                                       z_can.shape[:-1], y_can.shape[:-1])

        def lm(c):          # limb-major, with every batch axis present
            return c.movedim(-1, 0).reshape(
                (24,) + (1,) * (len(batch) + 1 - c.dim()) + c.shape[:-1])

        gen = [upload(g, self.device).reshape(
            (24,) + (1,) * len(batch)) for g in g1m.GEN_NP]
        bases = tuple(torch.stack(torch.broadcast_tensors(g, lm(c)), 1)
                      for g, c in zip(gen, proof_point))     # (24, 2, ...)
        ks = torch.stack([k.expand(batch + (16,)) for k in (y_can, z_can)])
        prods = G1_LM.scalar_mul(bases, ks)
        y_g = tuple(c[:, 0] for c in prods)
        z_pi = tuple(c[:, 1] for c in prods)
        lhs = G1_LM.add(G1_LM.add(tuple(lm(c) for c in c_point),
                                  G1_LM.neg(y_g)), z_pi)
        return tuple(c.movedim(0, -1) for c in lhs)

    def verify(self, c_point, z_can, y_can, proof_point):
        """Single verify -> (...) bool tensor; z_can, y_can canonical Fr
        limbs (..., 16); batch axes broadcast across all four."""
        lhs = self.verify_lhs(c_point, z_can, y_can, proof_point)
        return self.verify_batch_pair(proof_point, lhs)

    def verify_batch_msm(self, c_points, z_can, y_can, proof_points, rho_can,
                         c: int | None = None):
        """-> (pi_agg, lhs): points as (X, Y, Z) tuples of (24,) tensors;
        c: the MSM's window (None: the default window of 3k + 1)."""
        rho_m = FR.to_mont(rho_can)
        rz = FR.from_mont(FR.mul(rho_m, FR.to_mont(z_can)))
        ry_sum = FR.sum_along(FR.mul(rho_m, FR.to_mont(y_can)), axis=0)
        neg_ys = FR.from_mont(FR.neg(ry_sum))[None]
        gen = [upload(c, self.device)[None] for c in g1m.GEN_NP]
        pts = tuple(torch.cat([pi, pi, c, g], 0)
                    for pi, c, g in zip(proof_points, c_points, gen))
        scalars = torch.cat([rho_can, rz, rho_can, neg_ys], 0)
        k = z_can.shape[0]
        pi_agg, lhs = msm_grouped(pts, scalars, groups=(k, 2 * k + 1),
                                  c=c or default_window(3 * k + 1))
        return pi_agg, lhs

    def verify_batch_pair(self, pi_agg, lhs):
        s = self.setup
        neg_pi = (pi_agg[0], FP.neg(pi_agg[1]), pi_agg[2])
        return pairing_check([(lhs, s.lines_gen), (neg_pi, s.lines_tau)])

    def verify_batch(self, c_points, z_can, y_can, proof_points, rho_can):
        pi_agg, lhs = self.verify_batch_msm(c_points, z_can, y_can,
                                            proof_points, rho_can)
        return self.verify_batch_pair(pi_agg, lhs)

