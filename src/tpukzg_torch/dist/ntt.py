"""The four-step (Bailey) NTT over Fr across ranks (counterpart of
``tpukzg/dist/ntt.py``).

n = n1 n2; the vector is the row-major (n1, n2) matrix a[j1 n2 + j2]
and X[k2 n1 + k1] = sum_j a_j w^(j k).  Each rank holds a contiguous
block of n / N elements of the input and of the output, in natural
order.  The steps:

1. `all_to_all`: from a block of rows to a block of n2 / N columns;
2. the column NTTs of size n1 over those columns, one batch (kernel B5
   on the card);
3. the twiddle w^(+-j2 k1) on the rank's columns (one Fr product,
   kernel B1 on the card);
4. `all_to_all`: the transpose, to a block of n1 / N rows;
5. the row NTTs of size n2 (B5);
6. `all_to_all`: to the natural order of the output, X[k2 n1 + k1].

Each exchange is ``lax.all_to_all(split_axis, concat_axis, tiled=True)``
built from ``torch.distributed.all_to_all_single`` on a contiguous
tensor whose leading axis is the split axis cut into N pieces.  The
result is exact: it equals the single-device NTT bit for bit.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpukzg_torch.dist.mesh import MeshConfig
from tpukzg_torch.field.mont import FR, R_MOD, upload
from tpukzg_torch.ntt.ntt import get_plan, omega_for
from tpukzg_torch.utils.config import NttConfig


def _twiddles(n1: int, j0: int, m: int, w: int):
    """The (n1, m) block w^(j2 k1), j2 in [j0, j0 + m), as Montgomery
    limbs (n1 m, 16), by running products of Python ints."""
    vals = []
    step, start, w_j0 = 1, 1, pow(w, j0, R_MOD)   # w^k1, w^(k1 j0)
    for _ in range(n1):
        v = start
        for _ in range(m):
            vals.append(v)
            v = v * step % R_MOD
        step = step * w % R_MOD
        start = start * w_j0 % R_MOD
    return FR.to_mont_host(vals)


def all_to_all(x, split: int, concat: int, mesh):
    """Tiled all_to_all: x cut into N pieces along `split`, piece i sent
    to rank i, and the pieces received, from rank 0 on, joined along
    `concat`."""
    N = mesh.world
    x = x.movedim(split, 0)
    x = x.reshape((N, x.shape[0] // N) + tuple(x.shape[1:])).contiguous()
    if mesh.group is not None:
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=mesh.group)
    else:
        out = x
    out = out.movedim(1, split + 1).movedim(0, concat)
    shape = tuple(out.shape)
    return out.reshape(shape[:concat] + (shape[concat] * shape[concat + 1],)
                       + shape[concat + 2:])


class DistNtt:
    """The four-step NTT / iNTT of size n over a mesh; n1 rows, n2 =
    n / n1 columns, both multiples of the ranks."""

    def __init__(self, n: int, cfg: MeshConfig | None = None, mesh=None,
                 n1: int | None = None):
        if n & (n - 1):
            raise ValueError(f"DistNtt: n = {n} is not a power of two")
        self.n = n
        self.cfg = cfg or MeshConfig()
        self.mesh = mesh if mesh is not None else self.cfg.build()
        N = self.mesh.world
        if n1 is None:
            n1 = NttConfig.from_env().four_step_rows
        self.n1 = n1 or 1 << ((n.bit_length() - 1) // 2)
        self.n2 = n // self.n1
        if self.n1 * self.n2 != n or self.n1 % N or self.n2 % N:
            raise ValueError(f"DistNtt: n1 = {self.n1}, n2 = {self.n2} "
                             f"must divide n = {n} and be multiples of {N}")
        self.plan1, self.plan2 = get_plan(self.n1), get_plan(self.n2)
        omega = omega_for(n)
        m = self.n2 // N
        dev = self.mesh.device
        self._tw = {inv: upload(_twiddles(
            self.n1, self.mesh.rank * m, m,
            pow(omega, R_MOD - 2, R_MOD) if inv else omega), dev).reshape(
                self.n1, m, 16) for inv in (False, True)}

    def ntt(self, vec):
        """This rank's block of the coefficients, (n / N, 16) Montgomery
        on the mesh's device -> its block of the evaluations."""
        return self._run(vec, False)

    def intt(self, vec):
        return self._run(vec, True)

    def _run(self, vec, inverse: bool):
        N, n1, n2, mesh = self.mesh.world, self.n1, self.n2, self.mesh
        if tuple(vec.shape) != (self.n // N, 16):
            raise ValueError(f"DistNtt: block {tuple(vec.shape)}, not "
                             f"({self.n // N}, 16)")
        a = all_to_all(vec.reshape(n1 // N, n2, 16), 1, 0, mesh)
        cols = a.movedim(0, 1)                             # (n2/N, n1, 16)
        cols = self.plan1.intt(cols) if inverse else self.plan1.ntt(cols)
        a = FR.mul(cols.movedim(0, 1), self._tw[inverse])  # (n1, n2/N, 16)
        rows = all_to_all(a, 0, 1, mesh)                   # (n1/N, n2, 16)
        rows = self.plan2.intt(rows) if inverse else self.plan2.ntt(rows)
        out = all_to_all(rows.movedim(0, 1), 0, 1, mesh)   # (n2/N, n1, 16)
        return out.reshape(self.n // N, 16)
