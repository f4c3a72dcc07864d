"""The STARK verifier (reference src/starks/verifier.rs:559-657).

Runs entirely on host with exact python-int field arithmetic — verification
is O(queries * log n) hashes plus O(columns) field ops, so there is nothing
for the GPU to accelerate, and a host verifier doubles as the
cross-implementation compatibility oracle."""

from __future__ import annotations

from dataclasses import dataclass

from ..air.frame import HostFrame
from ..field import host as fh
from ..field.params import P, get_primitive_root_of_unity
from ..hash.keccak_host import keccak256, keccak256_batch, merkle_fold_batch
from ..proof.options import ProofOptions
from ..proof.stark import StarkProof
from ..prover.domain import Domain
from ..prover.grinding import leading_zeros_of_nonce
from ..transcript import (
    DefaultTranscript,
    batch_sample_challenges,
    transcript_to_field,
    transcript_to_usize,
)


@dataclass
class Challenges:
    z: int
    boundary_coeffs: list
    transition_coeffs: list
    trace_term_coeffs: list  # [col][offset]
    gamma_even: int
    gamma_odd: int
    zetas: list
    iotas: list
    rap_challenges: object
    leading_zeros_count: int


def _sample_z_ood(domain: Domain, transcript) -> int:
    while True:
        z = transcript_to_field(transcript)
        if not domain.contains_in_lde_coset(z) and not domain.contains_in_trace_roots(z):
            return z


def _step_1_replay_rounds(air, proof: StarkProof, domain: Domain, transcript):
    transcript.append(proof.lde_trace_merkle_roots[0])
    rap_challenges = air.build_rap_challenges(transcript)
    if len(proof.lde_trace_merkle_roots) > 1:
        transcript.append(proof.lde_trace_merkle_roots[1])

    n_boundary = len(air.boundary_constraints(rap_challenges).constraints)
    boundary_alphas = batch_sample_challenges(n_boundary, transcript)
    boundary_betas = batch_sample_challenges(n_boundary, transcript)
    transition_alphas = batch_sample_challenges(
        air.context.num_transition_constraints, transcript
    )
    transition_betas = batch_sample_challenges(
        air.context.num_transition_constraints, transcript
    )

    transcript.append(proof.composition_poly_root)
    z = _sample_z_ood(domain, transcript)

    transcript.append(fh.to_bytes_be(proof.composition_poly_even_ood_evaluation))
    transcript.append(fh.to_bytes_be(proof.composition_poly_odd_ood_evaluation))
    for row in proof.trace_ood_frame_evaluations:
        for el in row:
            transcript.append(fh.to_bytes_be(el))

    gamma_even = transcript_to_field(transcript)
    gamma_odd = transcript_to_field(transcript)
    total_columns = air.context.trace_columns
    n_offsets = len(air.context.transition_offsets)
    trace_term_coeffs = [
        [transcript_to_field(transcript) for _ in range(n_offsets)]
        for _ in range(total_columns)
    ]

    zetas = []
    for root in proof.fri_layers_merkle_roots:
        transcript.append(root)
        zetas.append(transcript_to_field(transcript))

    transcript.append(fh.to_bytes_be(proof.fri_last_value))

    transcript_challenge = transcript.challenge()
    leading_zeros_count = leading_zeros_of_nonce(transcript_challenge, proof.nonce)
    transcript.append(proof.nonce.to_bytes(8, "big"))

    iota_max = 1 << domain.lde_root_order
    iotas = [
        transcript_to_usize(transcript) % iota_max
        for _ in range(air.options().fri_number_of_queries)
    ]

    return Challenges(
        z=z,
        boundary_coeffs=list(zip(boundary_alphas, boundary_betas)),
        transition_coeffs=list(zip(transition_alphas, transition_betas)),
        trace_term_coeffs=trace_term_coeffs,
        gamma_even=gamma_even,
        gamma_odd=gamma_odd,
        zetas=zetas,
        iotas=iotas,
        rap_challenges=rap_challenges,
        leading_zeros_count=leading_zeros_count,
    )


def _step_2_verify_composition_poly(air, proof, domain, challenges) -> bool:
    z = challenges.z
    bc = air.boundary_constraints(challenges.rap_challenges)
    trace_length = air.trace_length()
    bound = air.composition_poly_degree_bound()
    boundary_adj = bound - trace_length

    nums, dens = [], []
    first_row = proof.trace_ood_frame_evaluations[0]
    for c in bc.constraints:
        point = domain.trace_root_pow(c.step)
        nums.append((first_row[c.col] - c.value) % P)
        dens.append((z - point) % P)
    dens_inv = fh.batch_inverse(dens)

    boundary_degree_z = pow(z, boundary_adj, P)
    boundary_sum = 0
    for num, den_inv, (alpha, beta) in zip(nums, dens_inv, challenges.boundary_coeffs):
        boundary_sum = (
            boundary_sum + num * den_inv % P * ((alpha * boundary_degree_z + beta) % P)
        ) % P

    frame = HostFrame(proof.trace_ood_frame_evaluations)
    rap_fv = air.wrap_rap_challenges(frame.ctx, challenges.rap_challenges)
    transition_evals = air.compute_transition(frame, rap_fv)
    transition_evals = [fv.v for fv in transition_evals]

    denominator_inv = fh.finv((pow(z, trace_length, P) - 1) % P)

    ctx = air.context
    transition_sum = 0
    for ev, degree, exemption, (alpha, beta) in zip(
        transition_evals, ctx.transition_degrees, ctx.transition_exemptions,
        challenges.transition_coeffs,
    ):
        adj = pow(z, bound - trace_length * (degree - 1), P)
        exemption_eval = (
            air.exemption_eval_at(exemption, z) if exemption > 0 else 1
        )
        transition_sum = (
            transition_sum
            + denominator_inv * ev % P * ((alpha * adj + beta) % P) * exemption_eval
        ) % P

    computed = (boundary_sum + transition_sum) % P
    claimed = (
        proof.composition_poly_even_ood_evaluation
        + z * proof.composition_poly_odd_ood_evaluation
    ) % P
    return computed == claimed


def _step_3_verify_fri(proof, domain, challenges) -> bool:
    """FRI openings + colinearity (reference verifier.rs:319-356, 443-523).

    Merkle verification batches per LAYER across all queries (value +
    symmetric openings in one native fold call — see
    keccak_host.merkle_fold_batch); the colinearity recursion stays per
    query (tiny field math)."""
    eval_points = [domain.lde_point(iota) for iota in challenges.iotas]
    eval_points_inv = fh.batch_inverse(eval_points)
    num_layers = len(proof.fri_layers_merkle_roots)
    two_inv = fh.finv(2)
    ok = True
    for k in range(num_layers):
        merkle_root = proof.fri_layers_merkle_roots[k]
        domain_length = 1 << (domain.lde_root_order - k)
        leaf_msgs, paths, idxs = [], [], []
        for iota, dec in zip(challenges.iotas, proof.query_list):
            leaf_msgs.append(fh.to_bytes_be(dec.layers_evaluations[k]))
            paths.append(dec.layers_auth_paths[k])
            idxs.append(iota % domain_length)
            leaf_msgs.append(fh.to_bytes_be(dec.layers_evaluations_sym[k]))
            paths.append(dec.layers_auth_paths_sym[k])
            idxs.append((iota + domain_length // 2) % domain_length)
        roots = merkle_fold_batch(keccak256_batch(leaf_msgs), paths, idxs)
        ok &= all(r == merkle_root for r in roots)
    for dec, iota, ep_inv in zip(
        proof.query_list, challenges.iotas, eval_points_inv
    ):
        v = dec.layers_evaluations[0]
        epi = ep_inv
        for k in range(num_layers):
            evaluation_sym = dec.layers_evaluations_sym[k]
            beta = challenges.zetas[k]
            v = (
                (v + evaluation_sym) * two_inv
                + beta * ((v - evaluation_sym) % P) % P * two_inv % P * epi
            ) % P
            if k < num_layers - 1:
                ok &= v == dec.layers_evaluations[k + 1]
            else:
                ok &= v == proof.fri_last_value
            epi = epi * epi % P
    return bool(ok)


def _step_4_verify_deep_composition(air, proof, domain, challenges) -> bool:
    g = get_primitive_root_of_unity(domain.root_order)
    z2 = challenges.z * challenges.z % P
    denom_invs = fh.batch_inverse(
        [(domain.lde_point(iota) - z2) % P for iota in challenges.iotas]
    )
    num_main = air.context.trace_columns - air.number_auxiliary_rap_columns()

    ok = True
    # batched Merkle verification: one native fold call for the composition
    # tree and one per trace tree, over all queries
    comp_roots = merkle_fold_batch(
        keccak256_batch(
            [fh.to_bytes_be(o.lde_composition_poly_even_evaluation)
             + fh.to_bytes_be(o.lde_composition_poly_odd_evaluation)
             for o in proof.deep_poly_openings]),
        [o.lde_composition_poly_proof for o in proof.deep_poly_openings],
        list(challenges.iotas),
    )
    ok &= (len(comp_roots) == len(challenges.iotas)
           and all(r == proof.composition_poly_root for r in comp_roots))
    for t, root in enumerate(proof.lde_trace_merkle_roots):
        col_slice = (slice(None, num_main) if t == 0
                     else slice(num_main, None))
        got = merkle_fold_batch(
            keccak256_batch(
                [b"".join(fh.to_bytes_be(v)
                          for v in o.lde_trace_evaluations[col_slice])
                 for o in proof.deep_poly_openings
                 if t < len(o.lde_trace_merkle_proofs)]),
            [o.lde_trace_merkle_proofs[t] for o in proof.deep_poly_openings
             if t < len(o.lde_trace_merkle_proofs)],
            [iota for iota, o in zip(challenges.iotas,
                                     proof.deep_poly_openings)
             if t < len(o.lde_trace_merkle_proofs)],
        )
        ok &= (len(got) == len(challenges.iotas)
               and all(r == root for r in got))

    # z*g^row are query-invariant; all trace divisors invert in ONE batch
    # (one Fermat inversion total instead of one per query)
    n_rows = len(proof.trace_ood_frame_evaluations)
    zg = [challenges.z * pow(g, row, P) % P for row in range(n_rows)]
    xs = [domain.lde_point(iota) for iota in challenges.iotas]
    all_divisors = fh.batch_inverse(
        [(x - zg[row]) % P for x in xs for row in range(n_rows)]
    )
    for i, (iota, opening, denom_inv) in enumerate(
        zip(challenges.iotas, proof.deep_poly_openings, denom_invs)
    ):
        divisors = all_divisors[i * n_rows: (i + 1) * n_rows]
        # reconstruct Deep(x)
        trace_term = 0
        n_cols = len(proof.trace_ood_frame_evaluations[0])
        for col in range(n_cols):
            coeff_row = challenges.trace_term_coeffs[col]
            for row in range(n_rows):
                poly_eval = (
                    (
                        opening.lde_trace_evaluations[col]
                        - proof.trace_ood_frame_evaluations[row][col]
                    )
                    * divisors[row]
                ) % P
                trace_term = (trace_term + poly_eval * coeff_row[row]) % P
        h1_term = (
            (
                opening.lde_composition_poly_even_evaluation
                - proof.composition_poly_even_ood_evaluation
            )
            * denom_inv
        ) % P
        h2_term = (
            (
                opening.lde_composition_poly_odd_evaluation
                - proof.composition_poly_odd_ood_evaluation
            )
            * denom_inv
        ) % P
        deep_eval = (
            trace_term
            + h1_term * challenges.gamma_even
            + h2_term * challenges.gamma_odd
        ) % P
        ok &= deep_eval == proof.query_list[i].layers_evaluations[0]
    return bool(ok)


def verify(
    proof: StarkProof, pub_inputs, proof_options: ProofOptions, air_class,
    instrument: bool = False,
    transcript_factory=DefaultTranscript,
) -> bool:
    """Verify a proof.  With ``instrument`` prints per-step time fractions
    (the reference's `instruments` feature, verifier.rs:644-654)."""
    import time

    if len(proof.query_list) < proof_options.fri_number_of_queries:
        return False
    if len(proof.deep_poly_openings) < proof_options.fri_number_of_queries:
        return False

    transcript = transcript_factory()
    air = air_class(proof.trace_length, pub_inputs, proof_options)
    domain = Domain(air)

    times = []
    t = time.perf_counter()
    challenges = _step_1_replay_rounds(air, proof, domain, transcript)
    times.append(time.perf_counter() - t)

    ok = challenges.leading_zeros_count >= proof_options.grinding_factor
    if ok:
        t = time.perf_counter()
        ok = _step_2_verify_composition_poly(air, proof, domain, challenges)
        times.append(time.perf_counter() - t)
    if ok:
        t = time.perf_counter()
        ok = _step_3_verify_fri(proof, domain, challenges)
        times.append(time.perf_counter() - t)
    if ok:
        t = time.perf_counter()
        ok = _step_4_verify_deep_composition(air, proof, domain, challenges)
        times.append(time.perf_counter() - t)

    if instrument and times:
        total = sum(times) or 1.0
        fractions = " ".join(f"{x / total:.4f}" for x in times)
        print(f"Fraction of verifying time per step: {fractions}")
    return bool(ok)
