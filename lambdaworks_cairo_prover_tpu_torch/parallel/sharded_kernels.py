"""Sharded prover kernels: rounds 1-4 of ``prove(mesh=...)``, the JAX
package's parallel/sharded_kernels.py on ``torch.distributed``.

``ShardedProverKernels`` (``shard_axis="domain"``): every (16, ..., N)
domain tensor is block-sharded on its last axis (rank r holds points
[r·N/D, (r+1)·N/D) in natural coset order; a tensor that D does not divide,
a late FRI layer, is replicated).  Under that layout:

  * NTT, iNTT, LDE      -> four-step transforms, 3 all-to-alls each
                           (parallel/four_step.py)
  * domain tables       -> each rank builds its block
  * constraints         -> rank-local, over chunks of the rank's block; the
                           frame's row shifts (by k·blowup) read a halo,
                           past the block's end the first points of the
                           next rank, from one all-gather
  * Merkle trees        -> each rank builds its subtree up to one root; the
                           D roots are all-gathered and the top log2(D)
                           levels are computed on every rank
  * H1/H2 split, folds  -> rank-local (blocks of even length start at an
                           even point); a block of one point is gathered
  * OOD values          -> rank-local partial sums, all-gathered and added
  * openings            -> each rank gathers the points and siblings it
                           owns; an all-gather; every rank selects by owner

``ColumnShardedProverKernels`` (``shard_axis="columns"``): each rank
interpolates and extends its block of trace columns, the blocks are
all-gathered, and everything else runs as on one device on every rank.

Both keep the resident polynomials and LDE packed, as on one device
(``ProverKernels.alloc_buffers``: here a rank's blocks of them), so a rank
gets both halvings, the packing and the 1/D share of the domain.  The
domain-sharded tables stay unpacked (``packed_tables``): a rank's share is
already N/D points.

Challenges enter as the same limb tensors as on one device, so the
transcript, and with it the proof bytes, are those of the single-device
prover for any mesh size.
"""

from __future__ import annotations

import torch

from ..field import device as fd
from ..field.params import N_LIMBS, P, R2
from ..hash import keccak_device as kd
from ..hash.merkle import MerkleTree, tree_levels
from ..ntt import core as nttc
from ..prover.kernels import ProverKernels
from . import sharding as sh
from .four_step import ShardedNTT


def _from_owners(picks: torch.Tensor, owners: list[int], mesh) -> torch.Tensor:
    """picks (M, ...): this rank's values at the M positions it owns (any
    value elsewhere).  Returns the owners' values at every position, the
    same on every rank: one all-gather, then a selection by owner."""
    g = sh.gather_stack(picks, mesh)  # (D, M, ...)
    own = torch.tensor(owners, dtype=torch.int64, device=picks.device)
    return g[own, torch.arange(len(owners), device=picks.device)]


def _owned(n_local: int, rank: int, idxs: list[int]):
    """(owner of each global index, its index in the owner's block, or 0
    where this rank does not own it) for blocks of n_local points."""
    owners = [i // n_local for i in idxs]
    local = [i % n_local if o == rank else 0 for i, o in zip(idxs, owners)]
    return owners, local


class ShardedMerkleTree(MerkleTree):
    """A Merkle tree whose lower levels are block-sharded: ``levels`` holds
    this rank's blocks of the levels below the D subtree roots, then the
    levels from those D roots to the root, whole on every rank.  A tree
    over fewer leaves than ranks is whole on every rank."""

    def __init__(self, levels, mesh):
        super().__init__(levels)
        self.mesh = mesh
        d = mesh.size()
        n_leaves = 1 << (len(levels) - 1)
        # levels[0] holds n_leaves / D leaves where the tree is sharded
        self.n_sharded = (len(levels) - d.bit_length()
                          if levels[0].shape[0] * d == n_leaves else 0)

    def gather_siblings(self, indices: list[int]) -> torch.Tensor:
        """(levels * q, 4) sibling digests, level-major, on every rank."""
        sib = self.sibling_indices(indices)
        k = self.n_sharded
        rank = sh.mesh_rank(self.mesh)
        parts = []
        if k:
            picks, owners = [], []
            for lv, ix in zip(self.levels[:k], sib[:k]):
                own, loc = _owned(lv.shape[0], rank, ix)
                picks.append(lv.index_select(0, torch.tensor(
                    loc, dtype=torch.int64, device=lv.device)))
                owners += own
            parts.append(_from_owners(torch.cat(picks), owners, self.mesh))
        for lv, ix in zip(self.levels[k:-1], sib[k:]):
            parts.append(lv.index_select(0, torch.tensor(
                ix, dtype=torch.int64, device=lv.device)))
        if not parts:
            return torch.zeros((0, 4), dtype=torch.int64,
                               device=self.levels[0].device)
        return torch.cat(parts, dim=0)


class ShardedProverKernels(ProverKernels):
    """The interface of ProverKernels with the LDE domain block-sharded
    over ``mesh``: every method takes and returns this rank's parts."""

    packed_tables = False
    # the FRI layers past the chain fold on the host: K4 takes whole
    # coefficients, and a rank holds a block of them
    supports_fri_tail = False

    def __init__(self, air, domain, mesh, device, axis: str | None = None):
        # the mesh and the transforms must exist before ProverKernels
        # builds the domain tables: its hooks build this rank's block
        self.mesh = mesh
        self.axis = axis or sh.mesh_axis(mesh)
        self.d = mesh.size()
        self.rank = mesh.get_local_rank(self.axis)
        self.sntt = ShardedNTT(mesh, self.axis, device)
        super().__init__(air, domain, device)

    # -- domain tables: this rank's block ----------------------------------

    def _lde_values(self) -> torch.Tensor:
        return self._lde_pow(1)

    def _lde_pow(self, exponent: int) -> torch.Tensor:
        """h^e · (w^e)^i for i in this rank's block of the LDE coset."""
        domain = self.domain
        k = domain.lde_size // self.d
        base = pow(domain.lde_primitive_root, exponent, P)
        scale = (pow(domain.coset_offset, exponent, P)
                 * pow(base, self.rank * k, P) % P)
        return fd.mul(fd.powers(base, k, device=self.device),
                      fd.from_int(scale, device=self.device))

    def _tile(self, row: torch.Tensor) -> torch.Tensor:
        k = self.domain.lde_size // self.d
        idx = torch.arange(self.rank * k, (self.rank + 1) * k,
                           device=self.device) % row.shape[1]
        return row.index_select(1, idx)

    # -- Merkle trees and openings -----------------------------------------

    def _commit(self, leaves: torch.Tensor, n_leaves: int) -> list:
        """Levels of the tree over n_leaves leaf digests (this rank's block
        of them, or all where the tree is replicated)."""
        if not sh.is_block(n_leaves, self.mesh):
            return tree_levels(leaves)
        local = tree_levels(leaves)
        return local[:-1] + tree_levels(sh.gather_rows(local[-1], self.mesh))

    def _commit_rows(self, lde: torch.Tensor, n_points: int) -> list:
        return self._commit(self._row_leaves(lde), n_points)

    def _commit_single(self, evals: torch.Tensor, n_points: int) -> list:
        return self._commit(kd.hash_felt_leaves(fd.from_mont(evals)),
                            n_points)

    def tree(self, levels) -> MerkleTree:
        return ShardedMerkleTree(levels, self.mesh)

    def gather_points(self, src, idxs, length):
        if not sh.is_block(length, self.mesh):
            return super().gather_points(src, idxs, length)
        owners, local = _owned(src.shape[-1], self.rank, idxs)
        picks = src.index_select(-1, torch.tensor(
            local, dtype=torch.int64, device=src.device))
        got = _from_owners(torch.movedim(picks, -1, 0).contiguous(), owners,
                           self.mesh)
        return fd.unpacked(torch.movedim(got, 0, -1))

    def coeffs_to_ints(self, coeffs, length):
        if sh.is_block(length, self.mesh):
            coeffs = sh.fetch(coeffs, self.mesh)
        return fd.to_ints(coeffs)

    # -- round 1 ------------------------------------------------------------

    def alloc_buffers(self, total_cols: int):
        """This rank's blocks of the packed polynomial and LDE buffers."""
        n, N = self.air.trace_length(), self.domain.lde_size
        return tuple(torch.empty((N_LIMBS // 2, total_cols, m // self.d),
                                 dtype=torch.int32, device=self.device)
                     for m in (n, N))

    def _extend(self, data):
        """A chunk of columns through the four-step transforms: this rank's
        blocks of their polynomials and LDE."""
        domain = self.domain
        n, N = self.air.trace_length(), domain.lde_size
        polys = self.sntt.interpolate(self.sntt.shard(data), n)
        lde = self.sntt.evaluate_offset(polys, n, N, domain.coset_offset)
        return polys, lde

    # -- round 2 ------------------------------------------------------------

    def _halo(self, lde_evals: torch.Tensor, h: int) -> torch.Tensor:
        """The h points that follow this rank's block: the first points of
        the next ranks in turn (with wraparound), from one all-gather of
        every rank's first points."""
        m = min(h, lde_evals.shape[2])
        if not m:
            return lde_evals[..., :0]
        firsts = sh.gather_stack(lde_evals[..., :m].contiguous(),
                                 self.mesh)  # (D, 8 | 16, cols, m)
        return torch.cat([firsts[(self.rank + j) % self.d]
                          for j in range(1, -(-h // m) + 1)], dim=-1)[..., :h]

    def _halves(self, x: torch.Tensor, n: int):
        """The even and odd points of a tensor of global length n.  Blocks
        of even length start at an even point, so each rank splits its own;
        a block of one point is gathered first."""
        if sh.is_block(n, self.mesh) and (n // self.d) % 2 == 0:
            return x[..., 0::2].contiguous(), x[..., 1::2].contiguous()
        whole = sh.full(x, n, self.mesh)
        return (self.sntt.shard(whole[..., 0::2].contiguous()),
                self.sntt.shard(whole[..., 1::2].contiguous()))

    def round2(self, lde_evals, boundary_ab, transition_ab, boundary_values,
               rap_arrays):
        domain = self.domain
        N, h = domain.lde_size, domain.coset_offset
        acc = self._constraint_sum(lde_evals, boundary_ab, transition_ab,
                                   boundary_values, rap_arrays)
        h_coeffs = self.sntt.interpolate_offset(acc, N, h)
        h1, h2 = self._halves(h_coeffs, N)
        # evaluated at the N coset points directly: the single-device
        # path's 2x oversample and stride-2 subsample give these values
        h1_lde = self.sntt.evaluate_offset(h1, N // 2, N, h)
        h2_lde = self.sntt.evaluate_offset(h2, N // 2, N, h)
        levels = self._commit_rows(torch.stack([h1_lde, h2_lde], dim=1), N)
        return h1, h2, h1_lde, h2_lde, levels

    # -- round 3 ------------------------------------------------------------

    def powers(self, base: int, n: int) -> torch.Tensor:
        return self.sntt.block_powers(base, n)

    def eval_at_powers(self, coeffs, powers_table):
        """The dot product over every rank's block: each rank's partial sum,
        all-gathered and added on every rank (canonical residues, so the
        order of the additions does not matter)."""
        part = self._dot(coeffs, powers_table)
        parts = sh.gather_stack(part, self.mesh)  # (D, 16 or 8, ...)
        return fd.from_mont(nttc.sum_reduce(torch.movedim(parts, 0, 1),
                                            axis=1), packed=False)

    # -- round 4 ------------------------------------------------------------

    def deep_poly(self, lde_evals, h1_lde, h2_lde, point_arrs, gamma_arr,
                  gammas_hh, ood_rows):
        acc = self._deep_evaluations(lde_evals, h1_lde, h2_lde, point_arrs,
                                     gamma_arr, gammas_hh, ood_rows)
        N = self.domain.lde_size
        coeffs = self.sntt.interpolate_offset(acc, N, self.domain.coset_offset)
        return sh.reblock(coeffs, N, self.air.trace_length(), self.mesh)

    def fri_first_layer(self, coeffs):
        domain = self.domain
        N = domain.lde_size
        evals = self.sntt.evaluate_offset(coeffs, self.air.trace_length(), N,
                                          domain.coset_offset)
        return evals, self._commit_single(evals, N)

    def _fold(self, coeffs, zeta, length):
        even, odd = self._halves(coeffs, length)
        return fd.add(even, fd.mul(odd, zeta))

    def fri_fold_layer(self, coeffs, zeta_arr, offset_int, domain_size):
        # a layer's domain is its coefficients times the blowup
        n_out = domain_size // self.domain.blowup_factor
        folded = self._fold(coeffs, zeta_arr, 2 * n_out)
        evals = self.sntt.evaluate_offset(folded, n_out, domain_size,
                                          offset_int)
        return folded, evals, self._commit_single(evals, domain_size)

    def _chain_tables(self, coeffs, plan, tail=()) -> None:
        n = self.air.trace_length()
        self.sntt.powers(self.domain.coset_offset, n)
        for k, (off, _) in enumerate(plan, start=1):
            self.sntt.powers(off, n >> k)
        fd.constant(1, mont=False, device=self.device)
        fd.constant(R2, mont=False, device=self.device)


class ColumnShardedProverKernels(ProverKernels):
    """Round 1 over column blocks: each rank interpolates and extends its
    block of the trace's columns (zero columns pad the count to a multiple
    of D), the blocks are all-gathered, and the commit and all later rounds
    run as on one device on every rank."""

    def __init__(self, air, domain, mesh, device, axis: str | None = None):
        super().__init__(air, domain, device)
        self.mesh = mesh
        self.axis = axis or sh.mesh_axis(mesh)
        self._lde = sh.sharded_lde_pipeline(
            mesh, domain.blowup_factor, domain.interpolation_domain_size,
            domain.coset_offset, self.axis)

    def _extend(self, data):
        cols = data.shape[1]
        pad = -cols % self.mesh.size()
        if pad:
            data = torch.cat([data, torch.zeros(
                (N_LIMBS, pad, data.shape[2]), dtype=data.dtype,
                device=data.device)], dim=1)
        polys, lde = self._lde(data)
        return (sh.gather_columns(polys, self.mesh)[:, :cols].contiguous(),
                sh.gather_columns(lde, self.mesh)[:, :cols].contiguous())


_SHARDED_CACHE: dict = {}


def get_sharded_kernels(air, domain, mesh, device,
                        shard_axis: str = "domain") -> ProverKernels:
    """Per-(AIR shape, mesh, device, layout) cache, as prover.kernels.get_kernels."""
    device = torch.device(device)
    key = (type(air).__name__, air.trace_length(), air.context.trace_columns,
           air.context.proof_options, tuple(air.context.transition_exemptions),
           air.kernel_cache_key(), mesh, device, shard_axis)
    if key not in _SHARDED_CACHE:
        cls = (ShardedProverKernels if shard_axis == "domain"
               else ColumnShardedProverKernels)
        _SHARDED_CACHE[key] = cls(air, domain, mesh, device)
    return _SHARDED_CACHE[key]
