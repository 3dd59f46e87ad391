"""KZG batch verification (counterpart of ``tpukzg/kzg/core.py:182-227``).

The k openings fold by powers of rho into ONE grouped MSM over 3k+1
points, groups (k, 2k+1), then two pairings on the precomputed lines:
    e(sum rho^i pi_i, [tau]_2) == e(sum rho^i (C_i - [y_i]_1 + z_i pi_i), [1]_2)
MSM scalars are canonical Fr limbs; field data (y) is Montgomery.
"""

from __future__ import annotations

import torch

from tpukzg_torch.curve import g1 as g1m
from tpukzg_torch.field.mont import FP, FR
from tpukzg_torch.kzg.setup import Setup
from tpukzg_torch.msm.pippenger_lm import default_window, msm_grouped
from tpukzg_torch.pairing.check import pairing_check


class Kzg:
    def __init__(self, setup: Setup):
        self.setup = setup
        self.n = setup.n
        self.device = setup.device
        self.plan = setup.plan
        self.roots = torch.as_tensor(setup.plan.roots, device=self.device)

    def verify_batch_msm(self, c_points, z_can, y_can, proof_points, rho_can):
        """-> (pi_agg, lhs): points as (X, Y, Z) tuples of (24,) tensors."""
        rho_m = FR.to_mont(rho_can)
        rz = FR.from_mont(FR.mul(rho_m, FR.to_mont(z_can)))
        ry_sum = FR.sum_along(FR.mul(rho_m, FR.to_mont(y_can)), axis=0)
        neg_ys = FR.from_mont(FR.neg(ry_sum))[None]
        gen = [torch.as_tensor(c, device=self.device)[None]
               for c in g1m.GEN_NP]
        pts = tuple(torch.cat([pi, pi, c, g], 0)
                    for pi, c, g in zip(proof_points, c_points, gen))
        scalars = torch.cat([rho_can, rz, rho_can, neg_ys], 0)
        k = z_can.shape[0]
        pi_agg, lhs = msm_grouped(pts, scalars, groups=(k, 2 * k + 1),
                                  c=default_window(3 * k + 1))
        return pi_agg, lhs

    def verify_batch_pair(self, pi_agg, lhs):
        s = self.setup
        neg_pi = (pi_agg[0], FP.neg(pi_agg[1]), pi_agg[2])
        return pairing_check([(lhs, s.lines_gen), (neg_pi, s.lines_tau)])

    def verify_batch(self, c_points, z_can, y_can, proof_points, rho_can):
        pi_agg, lhs = self.verify_batch_msm(c_points, z_can, y_can,
                                            proof_points, rho_can)
        return self.verify_batch_pair(pi_agg, lhs)

