"""The least work of a G2 MSM, beside work.py's G1 count and against its
peaks (one NVIDIA H100 SXM).

Counted from the operation's shapes, as work.py counts G1:
- an MSM over m points with nonzero scalars takes at least m - 1 point
  additions;
- an addition over Fp2 takes at least ADD_FP2_PRODUCTS products in Fp2
  (work.py's six: the affine addition with its inversion shared over a
  batch), each at least FP_PER_FP2_PRODUCT products in Fp (Karatsuba),
  each work.py's 12 x 12 word products of four operations;
- the bytes: every input read once (an affine G2 point: 192 bytes; a
  scalar: 32 bytes), the output written once (192 bytes).
"""

from __future__ import annotations

from h100bench import work

ADD_FP2_PRODUCTS = 6
FP_PER_FP2_PRODUCT = 3
POINT_BYTES = 192


def msm_g2_work(msms: int, points: int) -> dict:
    """The least work of `msms` G2 MSMs of `points` points each, one
    point list each: additions, integer operations and bytes."""
    adds = msms * max(points - 1, 0)
    return {
        "adds": adds,
        "ops": (adds * ADD_FP2_PRODUCTS * FP_PER_FP2_PRODUCT
                * work.FP_PRODUCT_OPS),
        "bytes": (msms * points * POINT_BYTES
                  + msms * points * work.SCALAR_BYTES + msms * POINT_BYTES),
    }

