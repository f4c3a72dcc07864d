"""Prover round computations over whole-domain tensors, cached per
(AIR shape, trace length, device).

The counterpart of the JAX package's prover/kernels.py as plain eager
methods: every round works on the whole LDE domain at once, with no row
chunks, packed buffers or jit caches.  Where a round would stack or expand
every trace column at once (the constraint groups of round 2, the DEEP
quotients of round 4: three temporaries of the LDE's size each, 7 GB at 52
columns of 2^21 points), it goes through the columns ``_COL_CHUNK`` at a
time and adds the partial sums, which gives the same values.  Domain tables (LDE
coset values, degree-adjustment powers, zerofier cycle, exemption
evaluations, boundary zerofier inverses) are built once on the device."""

from __future__ import annotations

import torch

from ..air.frame import DeviceFrame
from ..field import device as fd
from ..field.params import N_LIMBS, P, R2
from ..hash import keccak_device as kd
from ..hash.merkle import MerkleTree, fetch_tree, tree_levels
from ..ntt import core as nttc
from ..ntt import cuda_ntt as cn


_COL_CHUNK = 8  # columns (or constraints) stacked into one temporary


class ProverKernels:
    """Domain tables and round computations for one (air, domain, device)."""

    # fri_commit_chain: prove() may derive the FRI zetas on the device
    supports_fri_chain = True

    def __init__(self, air, domain, device):
        self.air = air
        self.domain = domain
        self.device = torch.device(device)
        dev = self.device
        n = air.trace_length()
        bound = air.composition_poly_degree_bound()
        ctxc = air.context

        # ---- boundary layout (host inspection) ----
        bc_probe = air.boundary_constraints(self._probe_challenges())
        self.boundary_steps = [c.step for c in bc_probe.constraints]
        self.boundary_cols = [c.col for c in bc_probe.constraints]
        self.distinct_steps = list(dict.fromkeys(self.boundary_steps))

        # ---- domain tables (over this device's points: _lde_values,
        # _lde_pow and _tile are where a sharded subclass builds its block) ----
        h = domain.coset_offset
        w = domain.lde_primitive_root
        t = {"lde_values": self._lde_values()}
        for name, e in [("d_adj_boundary", bound - n)] + [
            (f"d_adj_{d}", bound - n * (d - 1))
            for d in sorted(set(ctxc.transition_degrees))
        ]:
            t[name] = self._lde_pow(e)
        blowup = domain.blowup_factor
        hn = pow(h, n, P)
        wb = pow(w, n, P)
        zf = fd.from_ints([pow((hn * pow(wb, j, P) - 1) % P, P - 2, P)
                           for j in range(blowup)], device=dev)
        t["zerofier_inv"] = self._tile(zf)
        n_points = t["lde_values"].shape[1]
        for count in air.transition_exemption_counts():
            prod = None
            for r in air.exemption_roots(count):
                f = fd.sub(t["lde_values"], fd.from_int(r, device=dev))
                prod = f if prod is None else fd.mul(prod, f)
            t[f"exemption_{count}"] = prod
        if self.distinct_steps:
            diffs = [fd.sub(t["lde_values"],
                            fd.from_int(domain.trace_root_pow(s), device=dev))
                     for s in self.distinct_steps]
            inv_big = fd.batch_inverse(torch.cat(diffs, dim=1))
            for i, s in enumerate(self.distinct_steps):
                t[f"bz_inv_{s}"] = inv_big[:, i * n_points:(i + 1) * n_points]
        self.tables = t

    def _lde_values(self) -> torch.Tensor:
        """(16, N) Montgomery limbs of the LDE coset points h·w^i."""
        return self.domain.lde_values(device=self.device)

    def _lde_pow(self, exponent: int) -> torch.Tensor:
        """(16, N) limbs of d_i^exponent over the LDE coset."""
        return self.domain.lde_pow(exponent, device=self.device)

    def _tile(self, row: torch.Tensor) -> torch.Tensor:
        """(16, k) -> (16, N): entry i is row[i mod k] (k divides N)."""
        return row.repeat(1, self.domain.lde_size // row.shape[1])

    def _probe_challenges(self):
        """Dummy rap challenges for structural inspection (boundary layout)."""
        return self.air.build_rap_challenges(_ProbeTranscript())

    # ------------------------------------------------------------------
    # round 1: interpolate columns, LDE, leaf/tree hash
    # ------------------------------------------------------------------

    def interpolate_commit(self, trace_data: torch.Tensor):
        """(16, cols, n) trace -> (polys (16, cols, n), LDE (16, cols, N),
        Merkle levels over the LDE rows)."""
        domain = self.domain
        polys = nttc.interpolate_fft(trace_data)
        lde = nttc.evaluate_on_lde_domain(
            polys, domain.blowup_factor, domain.interpolation_domain_size,
            domain.coset_offset)
        rows = fd.from_mont(lde).permute(0, 2, 1)  # (16, N, cols)
        return polys, lde, tree_levels(kd.hash_felt_rows(rows, rows.shape[2]))

    def gather_columns(self, lde_evals: torch.Tensor, idxs: list[int]) -> torch.Tensor:
        """All-column openings at the query indices: (16, cols, len(idxs))."""
        ix = torch.tensor(idxs, dtype=torch.int64, device=lde_evals.device)
        return lde_evals.index_select(-1, ix)

    def gather_points(self, src: torch.Tensor, idxs: list[int],
                      length: int) -> torch.Tensor:
        """The values of src (16, ..., length) at the points idxs, on this
        device: (16, ..., len(idxs))."""
        return self.gather_columns(src, idxs)

    def tree(self, levels) -> MerkleTree:
        """The Merkle tree over levels that a round returned."""
        return fetch_tree(levels)

    def coeffs_to_ints(self, coeffs: torch.Tensor, length: int) -> list:
        """The ``length`` coefficients of (16, length) limbs as host ints."""
        return fd.to_ints(coeffs)

    # ------------------------------------------------------------------
    # round 2: whole-domain constraint evaluation + H + commit
    # ------------------------------------------------------------------

    def _constraint_sum(self, lde_evals, boundary_ab, transition_ab,
                        boundary_values, rap_arrays) -> torch.Tensor:
        air = self.air
        ctxc = air.context
        tc = self.tables
        acc = None

        def accumulate(term):
            nonlocal acc
            acc = term if acc is None else fd.add(acc, term)

        step_groups: dict = {}
        for i, step in enumerate(self.boundary_steps):
            step_groups.setdefault(step, []).append(i)
        for step, idxs in step_groups.items():
            ix = torch.tensor(idxs, dtype=torch.int64, device=self.device)
            cols = [self.boundary_cols[i] for i in idxs]
            nums = fd.sub(lde_evals[:, cols, :],
                          boundary_values.index_select(1, ix)[:, :, None])
            coeff = fd.add(
                fd.mul(tc["d_adj_boundary"][:, None, :],
                       boundary_ab[0].index_select(1, ix)[:, :, None]),
                boundary_ab[1].index_select(1, ix)[:, :, None])
            summed = nttc.sum_reduce(fd.mul(nums, coeff), axis=1)
            accumulate(fd.mul(summed, tc[f"bz_inv_{step}"]))

        frame = self._frame(lde_evals)
        rap_fv = air.wrap_rap_challenges(frame.ctx, rap_arrays)
        evals = air.compute_transition(frame, rap_fv)
        groups: dict = {}
        for i, (d, e) in enumerate(zip(ctxc.transition_degrees,
                                       ctxc.transition_exemptions)):
            groups.setdefault((d, e), []).append(i)
        n_points = lde_evals.shape[2]
        for (degree, exemption), idxs in sorted(groups.items()):
            summed = None
            for j in range(0, len(idxs), _COL_CHUNK):
                part = idxs[j:j + _COL_CHUNK]
                ix = torch.tensor(part, dtype=torch.int64, device=self.device)
                evs = torch.stack(
                    [evals[i].v.expand(N_LIMBS, n_points) for i in part], dim=1)
                for i in part:
                    evals[i] = None  # stacked: let the evaluation go
                coeff = fd.add(
                    fd.mul(tc[f"d_adj_{degree}"][:, None, :],
                           transition_ab[0].index_select(1, ix)[:, :, None]),
                    transition_ab[1].index_select(1, ix)[:, :, None])
                s = nttc.sum_reduce(fd.mul(evs, coeff), axis=1)
                summed = s if summed is None else fd.add(summed, s)
            summed = fd.mul(summed, tc["zerofier_inv"])
            if exemption > 0:
                summed = fd.mul(summed, tc[f"exemption_{exemption}"])
            accumulate(summed)
        return acc

    def _frame(self, lde_evals: torch.Tensor) -> DeviceFrame:
        """The transition frame: row k is the LDE shifted by k·blowup."""
        return DeviceFrame(lde_evals, self.air.context.transition_offsets,
                           self.domain.blowup_factor)

    def round2(self, lde_evals, boundary_ab, transition_ab, boundary_values,
               rap_arrays):
        """boundary_ab: (alphas, betas), each (16, n_bc); transition_ab:
        (alphas, betas), each (16, n_tc); boundary_values: (16, n_bc);
        rap_arrays: tuple of (16, 1) tensors."""
        air = self.air
        domain = self.domain
        acc = self._constraint_sum(lde_evals, boundary_ab, transition_ab,
                                   boundary_values, rap_arrays)
        h_coeffs = nttc.interpolate_offset_fft(acc, domain.coset_offset)
        h1 = h_coeffs[:, 0::2].contiguous()
        h2 = h_coeffs[:, 1::2].contiguous()
        h1_lde = nttc.evaluate_on_lde_domain(
            h1, domain.blowup_factor, air.trace_length(), domain.coset_offset)
        h2_lde = nttc.evaluate_on_lde_domain(
            h2, domain.blowup_factor, air.trace_length(), domain.coset_offset)
        rows = fd.from_mont(torch.stack([h1_lde, h2_lde], dim=2))
        levels = tree_levels(kd.hash_felt_rows(rows, 2))
        return h1, h2, h1_lde, h2_lde, levels

    # ------------------------------------------------------------------
    # round 3: OOD evaluations via powers-dot
    # ------------------------------------------------------------------

    def powers(self, base: int, n: int) -> torch.Tensor:
        """(16, n) powers [1, base, base^2, ...] for :meth:`eval_at_powers`."""
        return fd.powers(base, n, device=self.device)

    def eval_at_powers(self, coeffs: torch.Tensor, powers_table: torch.Tensor):
        """sum_i coeffs[..., i] * powers[i], out of Montgomery form:
        (16, ...) canonical residues."""
        return fd.from_mont(nttc.sum_reduce(fd.mul(coeffs, powers_table),
                                            axis=-1))

    # ------------------------------------------------------------------
    # round 4: DEEP evaluation-form combination + interpolation
    # ------------------------------------------------------------------

    def deep_poly(self, lde_evals, h1_lde, h2_lde, point_arrs, gamma_arr,
                  gammas_hh, ood_rows):
        """point_arrs: (n_offsets+1, 16, 1) points (z*g^k..., z^2);
        gamma_arr: (16, n_offsets*total_cols) trace gammas;
        gammas_hh: (2, 16, 1); ood_rows: n_offsets (16, total_cols) rows and
        a last (16, 2) row holding H1(z^2), H2(z^2)."""
        acc = self._deep_evaluations(lde_evals, h1_lde, h2_lde, point_arrs,
                                     gamma_arr, gammas_hh, ood_rows)
        coeffs = nttc.interpolate_offset_fft(acc, self.domain.coset_offset)
        return coeffs[:, :self.air.trace_length()].contiguous()

    def _deep_evaluations(self, lde_evals, h1_lde, h2_lde, point_arrs,
                          gamma_arr, gammas_hh, ood_rows) -> torch.Tensor:
        """The DEEP composition's values at this device's LDE points."""
        n_offsets = len(self.air.context.transition_offsets)
        lv = self.tables["lde_values"]
        N = lv.shape[1]
        inv_all = fd.batch_inverse(torch.cat(
            [fd.sub(lv, point_arrs[k]) for k in range(n_offsets + 1)], dim=1))
        acc = None
        for ki in range(n_offsets):
            inv_k = inv_all[:, ki * N:(ki + 1) * N]
            g = gamma_arr[:, ki::n_offsets].contiguous()  # (16, cols)
            for c0 in range(0, lde_evals.shape[1], _COL_CHUNK):
                c1 = c0 + _COL_CHUNK
                terms = fd.mul(
                    fd.sub(lde_evals[:, c0:c1], ood_rows[ki][:, c0:c1, None]),
                    inv_k[:, None, :])
                terms = fd.mul(terms, g[:, c0:c1, None])
                s = nttc.sum_reduce(terms, axis=1)
                acc = s if acc is None else fd.add(acc, s)
        inv_z = inv_all[:, n_offsets * N:]
        for half, h_lde in enumerate((h1_lde, h2_lde)):
            term = fd.mul(fd.mul(fd.sub(h_lde, ood_rows[n_offsets][:, half:half + 1]),
                                 inv_z), gammas_hh[half])
            acc = term if acc is None else fd.add(acc, term)
        return acc

    # ------------------------------------------------------------------
    # FRI layers
    # ------------------------------------------------------------------

    def fri_first_layer(self, coeffs: torch.Tensor):
        domain = self.domain
        evals = nttc.evaluate_offset_fft(coeffs, 1, domain.lde_size,
                                         domain.coset_offset)
        return evals, tree_levels(kd.hash_felt_leaves(fd.from_mont(evals)))

    def _fold(self, coeffs: torch.Tensor, zeta: torch.Tensor,
              length: int) -> torch.Tensor:
        """even + zeta·odd of ``length`` coefficients: length / 2 of them."""
        return fd.add(coeffs[:, 0::2], fd.mul(coeffs[:, 1::2], zeta))

    def fri_fold_layer(self, coeffs, zeta_arr, offset_int, domain_size):
        folded = self._fold(coeffs, zeta_arr, coeffs.shape[-1])
        evals = nttc.evaluate_offset_fft(folded, 1, domain_size, offset_int)
        leaves = kd.hash_felt_leaves(fd.from_mont(evals))
        return folded, evals, tree_levels(leaves)

    def _chain_tables(self, coeffs: torch.Tensor, plan) -> None:
        """Build every table the chain reads (offset powers, twiddles, field
        constants, Keccak's permutation) on the device of ``coeffs``, so
        that queueing the chain copies nothing from the host and so never
        waits for the device."""
        dev, domain, n_coeffs = coeffs.device, self.domain, coeffs.shape[-1]
        nttc.offset_powers(domain.coset_offset, n_coeffs, dev)
        for k, (off, _) in enumerate(plan, start=1):
            nttc.offset_powers(off, n_coeffs >> k, dev)
        if dev.type == "cuda":
            cn.packed_twiddle_table(domain.lde_size.bit_length() - 1, False,
                                    dev)
        fd.constant(1, mont=False, device=dev)
        fd.constant(R2, mont=False, device=dev)
        kd.perm_tables(dev)

    def fri_commit_chain(self, coeffs, state, plan, final_fold=False):
        """The device part of the FRI commit phase, queued without a host
        round trip (the JAX package's ``fri_commit_chain``): the first
        layer's LDE and commit, then for each (offset, domain size) of
        ``plan`` the Fiat-Shamir draw on the device (state' =
        keccak256(state || root), zeta = the 251-bit-masked state, as
        transcript/fiat_shamir.py draws it), the fold, its LDE and commit.
        With ``final_fold`` one more draw and the protocol's last fold.

        coeffs: (16, n) DEEP coefficients; state: (1, 4) int64 lanes of the
        transcript's 32-byte state.  Returns (rows, evals, levels, coeffs):
        rows is one (L + 1, 4) int64 tensor of the layer roots, plus, with
        ``final_fold``, a last row holding the 32-byte little-endian
        encoding of the folded constant (canonical, not Montgomery); the
        caller reads it back once.  Stark252 only."""
        self._chain_tables(coeffs, plan)
        evals, levels = self.fri_first_layer(coeffs)
        rows = [levels[-1]]
        evals_out, levels_out = [evals], [levels]

        def draw(state):
            state = kd.hash_digest_pairs(torch.cat([state, rows[-1]]))
            return state, fd.to_mont(kd.digest_words_to_masked_limbs(state[0]))

        for off, ds in plan:
            state, zeta = draw(state)
            coeffs, evals, levels = self.fri_fold_layer(coeffs, zeta, off, ds)
            rows.append(levels[-1])
            evals_out.append(evals)
            levels_out.append(levels)
        if final_fold:
            _, zeta = draw(state)
            last = fd.from_mont(self._fold(coeffs, zeta, 2))
            # 16 limbs of 16 bits -> 4 lanes of 64 (p < 2^252: no sign bit)
            shifts = torch.arange(0, 64, 16, dtype=torch.int64,
                                  device=coeffs.device)
            lanes = (last.to(torch.int64).reshape(4, 4) << shifts).sum(1)
            rows.append(lanes[None])
        return torch.cat(rows), evals_out, levels_out, coeffs


class _ProbeTranscript:
    """Deterministic stand-in used only to inspect boundary-constraint layout
    (columns/steps) ahead of proving; never used for real challenges."""

    def challenge(self) -> bytes:
        return b"\x01" * 32

    def append(self, data: bytes) -> None:
        pass


_KERNEL_CACHE: dict = {}


def get_kernels(air, domain, device) -> ProverKernels:
    device = torch.device(device)
    key = (type(air).__name__, air.trace_length(), air.context.trace_columns,
           air.context.proof_options, tuple(air.context.transition_exemptions),
           air.kernel_cache_key(), device)
    if key not in _KERNEL_CACHE:
        _KERNEL_CACHE[key] = ProverKernels(air, domain, device)
    return _KERNEL_CACHE[key]
