"""The benchmark's own yardstick for roofline shares: the least work an
MSM needs, and the published peaks of one NVIDIA H100 SXM.

The work is counted from the operation's shapes, never from how a kernel
of the program does it, so a kernel that is replaced reads against the
same count.  It is a floor that no implementation goes under:
- an MSM sum_i [k_i] P_i over m points with nonzero scalars merges m
  inputs into one output, so it takes at least m - 1 point additions;
- an addition takes at least ADD_PRODUCTS products in Fp: the affine
  addition with its inversion shared over a batch (Montgomery's trick,
  three products an element), lambda, lambda^2 and lambda (x1 - x3);
- a product of two 381-bit numbers in 32-bit words takes at least the
  12 x 12 word products of the schoolbook product (no reduction
  counted), each a 32 x 32 -> 64-bit product, two multiply-adds, four
  operations;
- the bytes: every input read once (a point as affine x, y: 96 bytes;
  a scalar: 32 bytes), every output written once (96 bytes).
Pippenger's algorithm makes some 255 / c + 2^c / m additions a point
(c the window), so a share against this floor reads far below 100 %.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and the 67 TFLOP/s float32
# rate outside the tensor cores taken as the ceiling of 32-bit integer
# multiply-adds counted as two operations each.
HBM_BYTES_S = 3.35e12
INT_OPS_S = 67e12

OPS_PER_WORD_PRODUCT = 4
FP_WORDS = 12
FP_PRODUCT_OPS = FP_WORDS * FP_WORDS * OPS_PER_WORD_PRODUCT
ADD_PRODUCTS = 6
POINT_BYTES = 96
SCALAR_BYTES = 32


def msm_work(msms: int, points: int, shared_points: bool) -> dict:
    """The least work of `msms` MSMs of `points` points each: additions,
    integer operations and bytes.  With shared_points the MSMs read one
    point list (a fixed SRS basis), else one list each."""
    adds = msms * max(points - 1, 0)
    point_lists = 1 if shared_points else msms
    return {
        "adds": adds,
        "ops": adds * ADD_PRODUCTS * FP_PRODUCT_OPS,
        "bytes": (point_lists * points * POINT_BYTES
                  + msms * points * SCALAR_BYTES + msms * POINT_BYTES),
    }


def least_seconds(work: dict) -> float:
    """The larger of the two bounds: operations over the integer peak and
    bytes over the memory bandwidth."""
    return max(work["ops"] / INT_OPS_S, work["bytes"] / HBM_BYTES_S)
