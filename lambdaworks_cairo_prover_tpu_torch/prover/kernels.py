"""Prover round computations, cached per (AIR shape, trace length,
device): the counterpart of the JAX package's prover/kernels.py as plain
eager methods, with its device-memory layout.

* The resident trace polynomials and LDE are packed (``fd.pack``: two
  16-bit limbs a 32-bit word, half the bytes) in buffers that prove()
  allocates once (:meth:`ProverKernels.alloc_buffers`) for the main and the
  auxiliary columns; round 1 transforms the columns a chunk at a time and
  writes each chunk into them in place, so no whole-domain piece is held
  twice.
* The domain tables (LDE coset values, degree-adjustment powers, zerofier
  cycle, exemption evaluations, boundary zerofier inverses) are built once
  on the device and kept packed where ``packed_tables``: the products that
  make them write packed words.
* Every pass over the LDE walks it in chunks: the row leaves in chunks of
  rows, round 2's constraints and DEEP in chunks of domain points (each
  chunk of round 2 with the frame's halo, the points after it, round the
  domain at its end), the OOD dot products in chunks of coefficients.  H1
  and H2 read the packed LDE, polynomials and tables as they lie; a result
  that the NTT, the scans or Keccak read comes out of its last product or
  sum as limbs (``packed=False``).  The chunk sizes set the transient
  memory and the launch count, never the values.
"""

from __future__ import annotations

import os

import torch

from ..air.frame import HaloFrame, wrap_halo
from ..field import device as fd
from ..field.params import N_LIMBS, P, R2
from ..hash import keccak_device as kd
from ..hash.merkle import MerkleTree, fetch_tree, tree_levels
from ..ntt import core as nttc
from ..ntt import cuda_ntt as cn
from . import fri_tail as ft


# Chunk sizes, by the bytes of the transients that a chunk makes (32 B a
# field element packed, 64 B as limbs); values do not depend on them.
_COL_CHUNK = 8         # columns (or constraints) stacked into one temporary
_LDE_CHUNK = 1 << 26   # columns x LDE points a round-1 transform chunk
                       # (LCP_COL_CHUNK: columns a chunk)
_LEAF_CHUNK = 1 << 23  # felts (rows x columns) a row-leaf hashing chunk
                       # (LCP_LEAF_CHUNK: rows a chunk)
_EVAL_CHUNK = 1 << 20  # domain points a chunk of round 2 and of DEEP
_DOT_CHUNK = 1 << 25   # coefficients x columns a chunk of an OOD dot product


def _env_chunk(name: str) -> int | None:
    env = os.environ.get(name)
    return max(1, int(env)) if env else None


class ProverKernels:
    """Domain tables and round computations for one (air, domain, device)."""

    # fri_commit_chain: prove() may derive the FRI zetas on the device, and
    # with a tail (K4) commit the layers of 2^ft.MAX_LOG points or fewer and
    # make the final fold there too
    supports_fri_chain = True
    supports_fri_tail = True
    # the domain tables are kept as (8, N) packed words, which H1/H2 read in
    # place; the sharded kernels keep theirs as limbs (a rank's share is
    # already N/D points)
    packed_tables = True

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
        t["zerofier_inv"] = self._tile(fd.pack(zf) if self.packed_tables
                                       else zf)
        n_points = t["lde_values"].shape[1]
        for count in air.transition_exemption_counts():
            prod = None
            for r in air.exemption_roots(count):
                f = fd.sub(t["lde_values"], fd.from_int(r, device=dev))
                prod = f if prod is None else fd.mul(prod, f)
            t[f"exemption_{count}"] = prod
        if self.distinct_steps:
            # H5 reads and writes limbs
            diffs = [fd.sub(t["lde_values"],
                            fd.from_int(domain.trace_root_pow(s), device=dev),
                            packed=False)
                     for s in self.distinct_steps]
            inv_big = fd.batch_inverse(torch.cat(diffs, dim=1))
            del diffs
            if self.packed_tables:
                inv_big = fd.pack(inv_big)
            for i, s in enumerate(self.distinct_steps):
                t[f"bz_inv_{s}"] = inv_big[:, i * n_points:(i + 1) * n_points]
            del inv_big
        self.tables = t
        # the domain's tables were build inputs: let them go
        domain.forget(device=dev)

    def _lde_values(self) -> torch.Tensor:
        """The LDE coset points h·w^i, (8, N) packed where packed_tables."""
        return self.domain.lde_values(device=self.device,
                                      packed=self.packed_tables)

    def _lde_pow(self, exponent: int) -> torch.Tensor:
        """d_i^exponent over the LDE coset, (8, N) packed where
        packed_tables."""
        return self.domain.lde_pow(exponent, device=self.device,
                                   packed=self.packed_tables)

    def _tile(self, row: torch.Tensor) -> torch.Tensor:
        """(rows, k) -> (rows, N): entry i is row[i mod k] (k divides N)."""
        return row.repeat(1, self.domain.lde_size // row.shape[1])

    def _table(self, name: str, start: int, stop: int) -> torch.Tensor:
        """Points [start, stop) of a domain table, a view in its layout."""
        return self.tables[name][:, start:stop]

    def _probe_challenges(self):
        """Dummy rap challenges for structural inspection (boundary layout)."""
        return self.air.build_rap_challenges(_ProbeTranscript())

    # ------------------------------------------------------------------
    # round 1: interpolate columns, LDE, leaf/tree hash
    # ------------------------------------------------------------------

    def alloc_buffers(self, total_cols: int):
        """Packed (8, total_cols, n) polynomial and (8, total_cols, N) LDE
        buffers on this device, which successive :meth:`interpolate_commit`
        calls (main trace, then auxiliary trace) fill in place: one resident
        copy of both at half the limb layout's bytes."""
        n = self.air.trace_length()
        N = self.domain.lde_size
        return tuple(torch.empty((N_LIMBS // 2, total_cols, m),
                                 dtype=torch.int32, device=self.device)
                     for m in (n, N))

    def _col_chunk(self, n_cols: int, n_points: int) -> int:
        """Columns a round-1 transform chunk: the fewest balanced chunks of
        at most _LDE_CHUNK columns x points (or LCP_COL_CHUNK columns)."""
        env = _env_chunk("LCP_COL_CHUNK")
        if env:
            return env
        n_chunks = max(1, -(-n_cols * n_points // _LDE_CHUNK))
        return -(-n_cols // n_chunks)

    def _extend(self, data: torch.Tensor):
        """(16, c, n) trace columns -> (polys (16, c, n), LDE (16, c, N))."""
        domain = self.domain
        polys = nttc.interpolate_fft(data)
        lde = nttc.evaluate_on_lde_domain(
            polys, domain.blowup_factor, domain.interpolation_domain_size,
            domain.coset_offset)
        return polys, lde

    def interpolate_commit(self, trace_data: torch.Tensor, bufs=None,
                           col_start: int = 0):
        """Interpolate and extend the columns of ``trace_data`` ((16 or 8,
        cols, n): limbs or packed words) into the packed buffers ``bufs`` at
        column ``col_start``, and commit to this call's columns.

        Returns (polys_buf, lde_buf, Merkle levels over the LDE rows of
        these columns).  With ``bufs=None`` buffers for just these columns
        are allocated."""
        n_cols = trace_data.shape[1]
        if bufs is None:
            bufs, col_start = self.alloc_buffers(n_cols), 0
        polys_buf, lde_buf = bufs
        step = self._col_chunk(n_cols, lde_buf.shape[2])
        for c0 in range(0, n_cols, step):
            polys, lde = self._extend(
                fd.unpacked(trace_data[:, c0:c0 + step]).contiguous())
            self._pack_update(polys_buf, polys, col_start + c0)
            del polys
            self._pack_update(lde_buf, lde, col_start + c0)
            del lde
        leaves = self._row_leaves(lde_buf[:, col_start:col_start + n_cols])
        return polys_buf, lde_buf, self._commit(leaves, self.domain.lde_size)

    def _pack_update(self, buf: torch.Tensor, piece: torch.Tensor,
                     start: int) -> None:
        """Pack a (16, c, points) piece into the resident ``buf`` at column
        ``start``, in place."""
        buf[:, start:start + piece.shape[1]] = fd.pack(piece)

    def _row_leaves(self, cols: torch.Tensor) -> torch.Tensor:
        """Keccak row leaves (points, 4) of LDE columns (16 or 8, c, points),
        out of Montgomery form into limbs (K1 reads limbs) and transposed a
        chunk of rows at a time."""
        n_cols, n_points = cols.shape[1], cols.shape[2]
        step = _env_chunk("LCP_LEAF_CHUNK")
        if not step:  # a multiple of 4 rows: H1 reads each word row 16 B wide
            step = max(4, _LEAF_CHUNK // max(n_cols, 1) // 4 * 4)
        leaves = torch.empty((n_points, 4), dtype=torch.int64,
                             device=cols.device)
        for r0 in range(0, n_points, step):
            rows = fd.from_mont(cols[:, :, r0:r0 + step], packed=False)
            leaves[r0:r0 + step] = kd.hash_felt_rows(rows.permute(0, 2, 1),
                                                     n_cols)
        return leaves

    def _commit(self, leaves: torch.Tensor, n_leaves: int) -> list:
        """Levels of the Merkle tree over ``n_leaves`` leaf digests."""
        return tree_levels(leaves)

    def gather_columns(self, lde_evals: torch.Tensor, idxs: list[int]) -> torch.Tensor:
        """All-column openings at the query indices: (16, cols, len(idxs))
        limbs, out of limbs or packed words (only the opened points are
        unpacked)."""
        ix = torch.tensor(idxs, dtype=torch.int64, device=lde_evals.device)
        return fd.unpacked(lde_evals.index_select(-1, ix))

    def gather_points(self, src: torch.Tensor, idxs: list[int],
                      length: int) -> torch.Tensor:
        """The values of src (16 or 8, ..., length) at the points idxs, on
        this device: (16, ..., len(idxs)) limbs."""
        return self.gather_columns(src, idxs)

    def tree(self, levels) -> MerkleTree:
        """The Merkle tree over levels that a round returned."""
        return fetch_tree(levels)

    def coeffs_to_ints(self, coeffs: torch.Tensor, length: int) -> list:
        """The ``length`` coefficients of (16, length) limbs as host ints."""
        return fd.to_ints(coeffs)

    # ------------------------------------------------------------------
    # round 2: constraint evaluation in domain chunks + H + commit
    # ------------------------------------------------------------------

    def _halo(self, lde_evals: torch.Tensor, h: int) -> torch.Tensor:
        """The h points that follow this device's last LDE point: the first
        points of the domain (the frame wraps round)."""
        return wrap_halo(lde_evals, h)

    def _constraint_sum(self, lde_evals, boundary_ab, transition_ab,
                        boundary_values, rap_arrays) -> torch.Tensor:
        """The constraint composition at this device's LDE points, computed
        _EVAL_CHUNK points at a time into one (16, points) accumulator (H3
        and H4 read limbs)."""
        ctxc = self.air.context
        offsets = ctxc.transition_offsets
        blowup = self.domain.blowup_factor
        n_points = lde_evals.shape[2]
        h = max(offsets) * blowup
        tail = self._halo(lde_evals, h)
        step_groups: dict = {}
        for i, step in enumerate(self.boundary_steps):
            step_groups.setdefault(step, []).append(i)
        groups: dict = {}
        for i, (d, e) in enumerate(zip(ctxc.transition_degrees,
                                       ctxc.transition_exemptions)):
            groups.setdefault((d, e), []).append(i)
        acc = torch.empty((N_LIMBS, n_points), dtype=torch.int32,
                          device=lde_evals.device)
        step = min(n_points, _EVAL_CHUNK)
        for a in range(0, n_points, step):
            b = min(a + step, n_points)
            halo = lde_evals[:, :, b:b + h]
            if halo.shape[2] < h:
                halo = torch.cat([halo, tail[:, :, :h - halo.shape[2]]], dim=2)
            frame = HaloFrame(lde_evals[:, :, a:b], halo, offsets, blowup)
            acc[:, a:b] = self._chunk_sum(
                frame, a, b, step_groups, sorted(groups.items()),
                boundary_ab, transition_ab, boundary_values, rap_arrays)
        return acc

    def _chunk_sum(self, frame, a, b, step_groups, group_list, boundary_ab,
                   transition_ab, boundary_values, rap_arrays) -> torch.Tensor:
        """The composition at points [a, b) of this device's LDE, (16,
        points) limbs: the frame's and the tables' layout up to each term's
        last product, which writes limbs."""
        air = self.air
        n_points = b - a
        rows = frame.data.shape[0]
        acc = None

        def accumulate(term):
            nonlocal acc
            acc = term if acc is None else fd.add(acc, term)

        d_adj = self._table("d_adj_boundary", a, b)
        for step, idxs in step_groups.items():
            ix = torch.tensor(idxs, dtype=torch.int64, device=self.device)
            cols = [self.boundary_cols[i] for i in idxs]
            nums = fd.sub(frame.data[:, cols, :n_points],
                          boundary_values.index_select(1, ix)[:, :, None])
            coeff = fd.add(
                fd.mul(d_adj[:, None, :],
                       boundary_ab[0].index_select(1, ix)[:, :, None]),
                boundary_ab[1].index_select(1, ix)[:, :, None])
            summed = nttc.sum_reduce(fd.mul(nums, coeff), axis=1)
            accumulate(fd.mul(summed, self._table(f"bz_inv_{step}", a, b),
                              packed=False))
        del d_adj

        rap_fv = air.wrap_rap_challenges(frame.ctx, rap_arrays)
        evals = air.compute_transition(frame, rap_fv)
        zerofier = self._table("zerofier_inv", a, b)
        for (degree, exemption), idxs in group_list:
            d_adj = self._table(f"d_adj_{degree}", a, b)
            summed = None
            for j in range(0, len(idxs), _COL_CHUNK):
                part = idxs[j:j + _COL_CHUNK]
                ix = torch.tensor(part, dtype=torch.int64, device=self.device)
                evs = torch.stack(
                    [evals[i].v.expand(rows, n_points) for i in part], dim=1)
                for i in part:
                    evals[i] = None  # stacked: let the evaluation go
                coeff = fd.add(
                    fd.mul(d_adj[:, None, :],
                           transition_ab[0].index_select(1, ix)[:, :, None]),
                    transition_ab[1].index_select(1, ix)[:, :, None])
                s = nttc.sum_reduce(fd.mul(evs, coeff), axis=1)
                summed = s if summed is None else fd.add(summed, s)
            if exemption > 0:
                summed = fd.mul(summed,
                                self._table(f"exemption_{exemption}", a, b))
            accumulate(fd.mul(summed, zerofier, packed=False))
        return acc

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
        del acc
        h1 = h_coeffs[:, 0::2].contiguous()
        h2 = h_coeffs[:, 1::2].contiguous()
        del h_coeffs
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

    def _dot(self, coeffs: torch.Tensor, powers_table: torch.Tensor):
        """sum_i coeffs[..., i] * powers[i] in Montgomery form, in the layout
        of coeffs (16 or 8, ..., L), read _DOT_CHUNK elements at a time and
        the partial sums added."""
        length = coeffs.shape[-1]
        batch = max(1, coeffs[0, ..., 0].numel())
        step = min(length, 1 << max(0, (_DOT_CHUNK // batch).bit_length() - 1))
        acc = None
        for a in range(0, length, step):
            part = nttc.sum_reduce(
                fd.mul(coeffs[..., a:a + step], powers_table[..., a:a + step]),
                axis=-1)
            acc = part if acc is None else fd.add(acc, part)
        return acc

    def eval_at_powers(self, coeffs: torch.Tensor, powers_table: torch.Tensor):
        """sum_i coeffs[..., i] * powers[i], out of Montgomery form:
        (16, ...) canonical residues."""
        return fd.from_mont(self._dot(coeffs, powers_table), packed=False)

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
        """The DEEP composition's values at this device's LDE points, a chunk
        of _EVAL_CHUNK points and _COL_CHUNK columns at a time, (16, N)
        limbs (H3 and H4 read limbs), the LDE read in its layout."""
        n_offsets = len(self.air.context.transition_offsets)
        N = lde_evals.shape[2]
        lv = self._table("lde_values", 0, N)
        inv_all = fd.batch_inverse(torch.cat(  # H5 reads limbs
            [fd.sub(lv, point_arrs[k], packed=False)
             for k in range(n_offsets + 1)], dim=1))
        del lv
        gammas = [gamma_arr[:, ki::n_offsets].contiguous()  # (16, cols)
                  for ki in range(n_offsets)]
        acc = torch.empty((N_LIMBS, N), dtype=torch.int32,
                          device=lde_evals.device)
        step = min(N, _EVAL_CHUNK)
        for a in range(0, N, step):
            b = min(a + step, N)
            s = None
            for c0 in range(0, lde_evals.shape[1], _COL_CHUNK):
                c1 = c0 + _COL_CHUNK
                cols = lde_evals[:, c0:c1, a:b]
                for ki in range(n_offsets):
                    terms = fd.mul(
                        fd.sub(cols, ood_rows[ki][:, c0:c1, None]),
                        inv_all[:, ki * N + a:ki * N + b][:, None, :])
                    terms = fd.mul(terms, gammas[ki][:, c0:c1, None])
                    part = nttc.sum_reduce(terms, axis=1)
                    s = part if s is None else fd.add(s, part)
            inv_z = inv_all[:, n_offsets * N + a:n_offsets * N + b]
            for half, h_lde in enumerate((h1_lde, h2_lde)):
                term = fd.mul(fd.mul(
                    fd.sub(h_lde[:, a:b], ood_rows[n_offsets][:, half:half + 1]),
                    inv_z), gammas_hh[half])
                s = fd.add(s, term, packed=False)
            acc[:, a:b] = s
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

    def _chain_tables(self, coeffs: torch.Tensor, plan, tail=()) -> None:
        """Build every table the chain and K4 read (offset powers, twiddles,
        field constants) on the device of ``coeffs``, so that queueing the
        chain copies nothing from the host and so never waits for the
        device.  Keccak needs none: K1 and K2 take their constants from the
        kernel, and the plain version's tables serve CPU tensors only."""
        dev, domain, n_coeffs = coeffs.device, self.domain, coeffs.shape[-1]
        nttc.offset_powers(domain.coset_offset, n_coeffs, dev)
        for k, (off, _) in enumerate(plan, start=1):
            nttc.offset_powers(off, n_coeffs >> k, dev)
        if dev.type == "cuda":
            cn.packed_twiddle_table(domain.lde_size.bit_length() - 1, False,
                                    dev)
            if tail:
                ft.tail_powers(tail, dev)
        fd.constant(1, mont=False, device=dev)
        fd.constant(R2, mont=False, device=dev)

    def fri_commit_chain(self, coeffs, state, plan, final_fold=False,
                         tail=()):
        """The device part of the FRI commit phase, queued without a host
        round trip (the JAX package's ``fri_commit_chain``): the first
        layer's LDE and commit, then for each (offset, domain size) of
        ``plan`` the Fiat-Shamir draw on the device (state' =
        keccak256(state || root), zeta = the 251-bit-masked state, as
        transcript/fiat_shamir.py draws it), the fold, its LDE and commit.
        With ``final_fold`` one more draw and the protocol's last fold.
        With ``tail``, the (offset, domain size) of every layer after
        ``plan``'s, K4 (:func:`.fri_tail.fri_tail`) commits those layers and
        makes the last fold, in the same queue.

        coeffs: (16, n) DEEP coefficients; state: (1, 4) int64 lanes of the
        transcript's 32-byte state.  Returns (rows, evals, levels, coeffs):
        rows is one (L + 1, 4) int64 tensor of the layer roots, plus, with
        ``final_fold``, a last row holding the 32-byte little-endian
        encoding of the folded constant (canonical, not Montgomery); the
        caller reads it back once.  With ``tail``, rows goes on with the
        tail's roots and that last row, and the fourth item is the
        :class:`.fri_tail.FriTail` in place of the coefficients.  Stark252
        only."""
        self._chain_tables(coeffs, plan, tail)
        evals, levels = self.fri_first_layer(coeffs)
        rows = [levels[-1]]
        evals_out, levels_out = [evals], [levels]
        for off, ds in plan:
            state, zeta = ft.draw(state, rows[-1])
            coeffs, evals, levels = self.fri_fold_layer(coeffs, zeta, off, ds)
            rows.append(levels[-1])
            evals_out.append(evals)
            levels_out.append(levels)
        if tail:
            done = ft.fri_tail(coeffs, state, rows[-1], tail)
            rows.append(done.rows)
            return torch.cat(rows), evals_out, levels_out, done
        if final_fold:
            _, zeta = ft.draw(state, rows[-1])
            rows.append(ft.value_lanes(fd.from_mont(
                self._fold(coeffs, zeta, 2))))
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
