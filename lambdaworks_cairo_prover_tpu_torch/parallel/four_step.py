"""Four-step (Bailey) NTT over a device mesh: the JAX package's
parallel/four_step.py on ``torch.distributed``.

The domain axis of every large transform of ``prove(mesh=...)`` goes
through this module.  Domain tensors are (16, B, N) with the last axis
block-sharded (rank r holds points [r·N/D, (r+1)·N/D)), so Merkle leaves,
constraints and DEEP stay rank-local in natural order downstream.

N = R·C, natural order at both ends:

    view x as M[r, c] = x[r·C + c]   (blocks of rows r = the input layout)
    1. all-to-all #1:  r-blocks -> c-blocks           (transpose)
    2. local NTT of R points along r:   G[c, t]
    3. H1 multiply:    G'[c, t] = G[c, t] · w_N^(c·t)  (this rank's rows c)
    4. all-to-all #2:  c-blocks -> t-blocks           (transpose)
    5. local NTT of C points along c:   H[t, s] = X[s·R + t]
    6. all-to-all #3:  t-blocks -> s-blocks           (natural block order)

``jax.lax.all_to_all(x, split_axis=3, concat_axis=2, tiled=True)`` sends
chunk j of axis 3 to rank j and concatenates what arrives along axis 2 in
source-rank order; ``all_to_all_single`` splits dim 0, so :meth:`_a2a` moves
the chunk axis first, exchanges, and puts the source axis back in front of
axis 2.  The local NTTs are ``ntt/core.py:transform``: H3 + H4 over a batch
of rows on the card, the plain NTT on the CPU.  Below the plan's threshold
a transform is computed whole on every rank and cut back to its block.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..field import device as fd
from ..field.params import N_LIMBS, P, get_primitive_root_of_unity
from ..ntt import core as nttc
from .sharding import full, is_block, mesh_rank, reblock, shard_domain


def four_step_plan(n: int, d: int):
    """N = R·C with D | R and D | C, or None where a transform of n points
    over d ranks is computed whole (d = 1, n < d², n not a power of two, or
    a factor that d does not divide): the JAX package's ``ShardedNTT.plan``."""
    if d == 1 or n < d * d:
        return None
    log = n.bit_length() - 1
    if (1 << log) != n:
        return None
    c = 1 << (log // 2)
    r = n // c
    if c % d or r % d:
        return None
    return r, c


class ShardedNTT:
    """Transforms of block-sharded tensors over one mesh axis; caches the
    inter-factor tables and power tables per size, on ``device``."""

    def __init__(self, mesh, axis: str = "dom", device=None):
        self.mesh = mesh
        self.axis = axis
        self.d = mesh.size()
        self.rank = mesh_rank(mesh)
        self.device = torch.device(device if device is not None
                                   else mesh.device_type)
        self._inter_cache: dict = {}
        self._pow_cache: dict = {}

    # -- planning -----------------------------------------------------------

    def plan(self, n: int):
        return four_step_plan(n, self.d)

    # -- tables -------------------------------------------------------------

    def inter_table(self, n: int, inverse: bool) -> torch.Tensor:
        """(16, C/D, R): this rank's rows c of T[c, t] = w^(c·t), w the
        (inverse) primitive n-th root; built on the device from one powers
        table of w by index."""
        key = (n, inverse)
        if key not in self._inter_cache:
            r, c = self.plan(n)
            w = get_primitive_root_of_unity(n.bit_length() - 1)
            if inverse:
                w = pow(w, P - 2, P)
            k = c // self.d
            rows = torch.arange(self.rank * k, (self.rank + 1) * k,
                                device=self.device)
            cols = torch.arange(r, device=self.device)
            idx = (rows[:, None] * cols[None, :]) % n
            table = fd.powers(w, n, device=self.device)
            self._inter_cache[key] = table.index_select(
                1, idx.reshape(-1)).reshape(N_LIMBS, k, r)
        return self._inter_cache[key]

    def powers(self, base: int, n: int) -> torch.Tensor:
        """This rank's part of the (16, n) table [1, base, base^2, ...],
        cached (the coset offsets and their inverses)."""
        key = (base % P, n)
        if key not in self._pow_cache:
            self._pow_cache[key] = self.block_powers(base, n)
        return self._pow_cache[key]

    def block_powers(self, base: int, n: int) -> torch.Tensor:
        """:meth:`powers`, not cached (a point drawn once)."""
        if not is_block(n, self.mesh):
            return fd.powers(base, n, device=self.device)
        k = n // self.d
        return fd.mul(fd.powers(base, k, device=self.device),
                      fd.from_int(pow(base, self.rank * k, P),
                                  device=self.device))

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's part of a whole (16, ..., N) tensor."""
        return shard_domain(self.mesh, x, self.axis)

    # -- transforms ---------------------------------------------------------

    def _a2a(self, x: torch.Tensor) -> torch.Tensor:
        """(16, B, a, D·b) -> (16, B, D·a, b): chunk j of the last axis goes
        to rank j; what arrives is stacked along axis 2 by source rank."""
        _, b_, a, cb = x.shape
        d = self.d
        send = x.reshape(N_LIMBS, b_, a, d, cb // d).permute(3, 0, 1, 2, 4)
        send = send.contiguous()
        recv = torch.empty_like(send)
        # the group is looked up per call: a cached ShardedNTT must not keep
        # a destroyed process group alive
        dist.all_to_all_single(recv, send,
                               group=self.mesh.get_group(self.axis))
        return recv.permute(1, 2, 0, 3, 4).reshape(N_LIMBS, b_, d * a, cb // d)

    def transform(self, x: torch.Tensor, n: int, inverse: bool) -> torch.Tensor:
        """DFT (no 1/n scaling) of n points along the last axis of this
        rank's part of a (16, B, n) or (16, n) tensor; natural order both
        ends, the same layout out as in."""
        if x.dim() == 2:
            return self.transform(x[:, None, :], n, inverse)[:, 0, :]
        plan = self.plan(n)
        if plan is None:
            return self.shard(nttc.transform(full(x, n, self.mesh), inverse))
        r, c = plan
        d, b_ = self.d, x.shape[1]
        xv = self._a2a(x.reshape(N_LIMBS, b_, r // d, c))   # (16, B, r, c/d)
        xv = nttc.transform(xv.transpose(2, 3), inverse)   # G[c_local, t]
        xv = fd.mul(xv, self.inter_table(n, inverse)[:, None])
        xv = self._a2a(xv)                                 # (16, B, c, r/d)
        xv = nttc.transform(xv.transpose(2, 3), inverse)   # H[t_local, s]
        xv = self._a2a(xv)                                 # (16, B, r, c/d)
        return xv.transpose(2, 3).reshape(N_LIMBS, b_, n // d)

    def interpolate(self, evals: torch.Tensor, n: int) -> torch.Tensor:
        """lambdaworks ``interpolate_fft``: natural-order evals -> coeffs."""
        y = self.transform(evals, n, inverse=True)
        n_inv = fd.from_int(pow(n, P - 2, P), device=y.device)
        return fd.mul(y, n_inv.reshape((N_LIMBS,) + (1,) * (y.dim() - 1)))

    def evaluate_offset(self, coeffs: torch.Tensor, n: int, domain_size: int,
                        offset: int) -> torch.Tensor:
        """Evaluations of the n coefficients' polynomial on the coset
        offset·<w_domain_size>, natural order: lambdaworks
        ``evaluate_offset_fft`` and the reference's step-subsampling
        (prover.rs:106-123) in one, since w_{kN}^{ki} = w_N^i."""
        scaled = fd.mul(coeffs, self.powers(offset, n))
        return self.transform(self._pad(scaled, n, domain_size), domain_size,
                              inverse=False)

    def interpolate_offset(self, evals: torch.Tensor, n: int,
                           offset: int) -> torch.Tensor:
        """Coefficients of the polynomial interpolating evals on offset·<w_n>."""
        coeffs = self.interpolate(evals, n)
        return fd.mul(coeffs, self.powers(pow(offset, P - 2, P), n))

    def _pad(self, x: torch.Tensor, n: int, n_target: int) -> torch.Tensor:
        return reblock(x, n, n_target, self.mesh)
