"""The STARK prover (reference src/starks/prover.rs:532-766).

Host python orchestrates the protocol rounds and the Fiat-Shamir transcript;
the bulk math runs on the device of the caller's choice through
prover/kernels.py.  The transcript interaction order is normative and
matches the reference (and the JAX package) exactly, so proofs are
byte-identical to the JAX package's."""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..air.trace import TraceTable
from ..field import device as fd
from ..field import host as fh
from ..field.params import (FIELD_BIT_SIZE, N_LIMBS, P,
                            get_primitive_root_of_unity)
from ..hash.keccak_host import keccak256_batch
from ..hash.merkle import MerkleTree
from ..hash import keccak_device as kd
from ..proof.options import ProofOptions
from ..proof.stark import DeepPolynomialOpenings, FriDecommitment, StarkProof
from ..transcript import (
    DefaultTranscript,
    batch_sample_challenges,
    transcript_to_field,
    transcript_to_usize,
)
from .domain import Domain
from .grinding import generate_nonce_with_grinding
from .kernels import get_kernels


class ProvingError(Exception):
    """Typed prover failure (reference prover.rs:40-43 `ProvingError`)."""


_HOST_FRI_THRESHOLD = 4096  # fold FRI layers of this size or less on host
# LDE domains up to 2^this run every FRI layer and the final fold in the
# device chain (fri_last_value rides the roots readback, no host tail); the
# JAX package's variable and default, so that both take the same route
_FULL_CHAIN_MAX_LOG = int(os.environ.get("LCP_FULL_FRI_CHAIN_MAX_LOG", "16"))


def _host_fold(coeffs: list[int], zeta: int) -> list[int]:
    """even + zeta*odd, keeping the length (= next domain size)."""
    return [
        (coeffs[2 * i] + zeta * coeffs[2 * i + 1]) % P
        for i in range(len(coeffs) // 2)
    ]


def _host_evaluate_offset_fft(coeffs: list[int], domain_size: int,
                              offset: int) -> list[int]:
    """lambdaworks `evaluate_offset_fft` semantics for the host tail
    (blowup 1): scale by offset powers, pad to domain_size, radix-2 FFT."""
    scaled = []
    o = 1
    for c in coeffs:
        scaled.append(c * o % P)
        o = o * offset % P
    scaled.extend([0] * (domain_size - len(scaled)))
    return _host_fft(scaled,
                     get_primitive_root_of_unity(domain_size.bit_length() - 1))


def _host_fft(a: list[int], w: int) -> list[int]:
    n = len(a)
    if n == 1:
        return a
    even = _host_fft(a[0::2], w * w % P)
    odd = _host_fft(a[1::2], w * w % P)
    out = [0] * n
    x = 1
    for i in range(n // 2):
        t = x * odd[i] % P
        out[i] = (even[i] + t) % P
        out[i + n // 2] = (even[i] - t) % P
        x = x * w % P
    return out


class _HostMerkle:
    """Host Merkle tree over precomputed leaf digests; same node rule and
    proof API as hash.merkle.MerkleTree (node = keccak(left || right))."""

    def __init__(self, leaf_digests: list[bytes]):
        levels = [leaf_digests]
        cur = leaf_digests
        while len(cur) > 1:
            cur = keccak256_batch(
                [cur[i] + cur[i + 1] for i in range(0, len(cur), 2)]
            )
            levels.append(cur)
        self.levels = levels

    @property
    def root(self) -> bytes:
        return self.levels[-1][0]

    def get_proofs(self, indices: list[int]) -> list[list[bytes]]:
        paths = [[] for _ in indices]
        idxs = list(indices)
        for level in self.levels[:-1]:
            for q, i in enumerate(idxs):
                paths[q].append(level[i ^ 1])
            idxs = [i >> 1 for i in idxs]
        return paths


def _fri_commit(kern, domain: Domain, deep_coeffs: torch.Tensor, transcript,
                device) -> tuple:
    """The FRI layers [(evaluations, tree, domain size)] and the last value.

    The layers whose halved domain stays above _HOST_FRI_THRESHOLD (all of
    them, and the final fold, when the LDE domain is at most
    2^_FULL_CHAIN_MAX_LOG points) go through ``kern.fri_commit_chain``,
    which derives their zetas on the device, and their roots come back in
    one copy; the host transcript replays each draw.  The rest fold layer
    by layer, with the zeta drawn on the host after each root: all layers
    where the chain's rule may not hold (a transcript of another type, a
    field other than the 252-bit one) and the tail below the threshold,
    which folds on the host.  The JAX package takes the same routes
    (prover/prove.py), and either gives the same bytes."""
    N = domain.lde_size
    number_layers = domain.root_order
    full_chain = N <= 1 << _FULL_CHAIN_MAX_LOG
    plan = []
    off_p, ds_p = domain.coset_offset, N
    for _ in range(1, number_layers):
        off_p = off_p * off_p % P
        ds_p //= 2
        if not full_chain and ds_p <= _HOST_FRI_THRESHOLD:
            break
        plan.append((off_p, ds_p))
    buf = getattr(transcript, "_buf", None)
    # exact type: a DefaultTranscript subclass may change the append and
    # challenge rule that the chain hard-codes; the chain's draw masks to the
    # 252-bit field's 251 bits
    use_chain = (type(transcript) is DefaultTranscript and plan
                 and buf is not None and len(buf) == 32
                 and FIELD_BIT_SIZE == 252 and kern.supports_fri_chain)
    full_chain = full_chain and use_chain and len(plan) == number_layers - 1

    fri_layers = []
    coeffs = deep_coeffs
    n_coeffs = domain.interpolation_domain_size  # the global length of coeffs
    offset_int, domain_size = domain.coset_offset, N
    if use_chain:
        state = torch.from_numpy(
            np.frombuffer(bytes(buf), dtype="<i8").copy()).to(device)[None]
        rows_dev, evals_l, levels_l, coeffs = kern.fri_commit_chain(
            deep_coeffs, state, plan, final_fold=full_chain)
        rows = rows_dev.cpu().numpy()  # the one readback of the chain
        for i, (evals, levels) in enumerate(zip(evals_l, levels_l)):
            if i > 0:
                transcript_to_field(transcript)  # the device drew this zeta
                domain_size //= 2
            tree = kern.tree(levels)
            tree._root_bytes = kd.digest_to_bytes(rows[i])
            fri_layers.append((evals, tree, domain_size))
            transcript.append(tree.root)
        offset_int, domain_size = plan[-1]
        n_coeffs >>= len(plan)
        if full_chain:
            transcript_to_field(transcript)  # the final fold's zeta
            fri_last_value = int.from_bytes(rows[-1].tobytes(), "little")
            transcript.append(fh.to_bytes_be(fri_last_value))
            return fri_layers, fri_last_value
    else:
        evals0, levels0 = kern.fri_first_layer(deep_coeffs)
        tree0 = kern.tree(levels0)
        fri_layers.append((evals0, tree0, N))
        transcript.append(tree0.root)

    host_coeffs = None  # once small enough, fold/hash layers on host
    for _ in range(len(fri_layers), number_layers):
        zeta = transcript_to_field(transcript)
        offset_int = offset_int * offset_int % P
        domain_size //= 2
        if host_coeffs is None and domain_size <= _HOST_FRI_THRESHOLD:
            host_coeffs = kern.coeffs_to_ints(coeffs, n_coeffs)
        if host_coeffs is not None:
            host_coeffs = _host_fold(host_coeffs, zeta)
            evals = _host_evaluate_offset_fft(host_coeffs, domain_size,
                                              offset_int)
            tree = _HostMerkle(keccak256_batch(
                [fh.to_bytes_be(v) for v in evals]))
        else:
            coeffs, evals, levels = kern.fri_fold_layer(
                coeffs, fd.from_int(zeta, device=device), offset_int,
                domain_size)
            n_coeffs //= 2
            tree = kern.tree(levels)
        fri_layers.append((evals, tree, domain_size))
        transcript.append(tree.root)

    zeta = transcript_to_field(transcript)
    # final fold on host: the remaining polynomial is tiny
    last_coeffs = (host_coeffs if host_coeffs is not None
                   else kern.coeffs_to_ints(coeffs, n_coeffs))
    folded_host = _host_fold(last_coeffs, zeta)
    fri_last_value = folded_host[0] if folded_host else 0
    transcript.append(fh.to_bytes_be(fri_last_value))
    return fri_layers, fri_last_value


def _mem(tag: str, device=None) -> None:
    """Device-memory telemetry under LCP_DEBUG_MEM=1 (the JAX package's
    prover/prove.py:_mem): after a synchronize, the bytes that the caching
    allocator has handed out now and at most since the last reset of the
    peak, the bytes it holds, and the six largest CUDA tensors alive (a scan
    of the garbage collector's objects), so that a phase that runs out of
    memory can be found.  Without a CUDA device it prints "unavailable"."""
    if not os.environ.get("LCP_DEBUG_MEM"):
        return
    if device is not None and torch.device(device).type != "cuda":
        print(f"[mem {tag}] unavailable: the prove runs on "
              f"{torch.device(device)}", flush=True)
        return
    if not torch.cuda.is_available():
        print(f"[mem {tag}] unavailable: no CUDA device", flush=True)
        return
    import gc

    torch.cuda.synchronize()
    live = {}
    for obj in gc.get_objects():
        try:
            if isinstance(obj, torch.Tensor) and obj.is_cuda:
                storage = obj.untyped_storage()
                live[storage.data_ptr()] = (storage.nbytes(), tuple(obj.shape))
        except (ReferenceError, RuntimeError):
            continue  # a dead weak proxy, or a tensor without a storage
    top = sorted(live.values(), key=lambda t: -t[0])[:6]
    tops = ", ".join(f"{shape}:{nbytes / 1e9:.2f}" for nbytes, shape in top)
    print(f"[mem {tag}] allocated={torch.cuda.memory_allocated() / 1e9:.2f}GB "
          f"peak={torch.cuda.max_memory_allocated() / 1e9:.2f}GB "
          f"reserved={torch.cuda.memory_reserved() / 1e9:.2f}GB "
          f"top=[{tops}]", flush=True)


def _sample_z_ood(domain: Domain, transcript) -> int:
    while True:
        z = transcript_to_field(transcript)
        if not domain.contains_in_lde_coset(z) and not domain.contains_in_trace_roots(z):
            return z


def proving_device(device) -> torch.device:
    """``device`` as a torch.device; raises where it names a CUDA device and
    there is none (nothing moves to the CPU by itself)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise ProvingError("a CUDA device was requested but "
                           "torch.cuda.is_available() is false")
    return device


def _sync(device: torch.device) -> None:
    """Wait for queued device work, so a round's host time includes it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prove(
    main_trace: TraceTable,
    pub_inputs,
    proof_options: ProofOptions,
    air_class,
    *,
    device,
    mesh=None,
    shard_axis: str = "domain",
    instrument: bool = False,
    transcript_factory=DefaultTranscript,
    donate_trace: bool = False,
) -> StarkProof:
    """Generate a STARK proof on ``device`` ("cpu", "cuda", "cuda:1", ...).

    The trace is moved to ``device`` and every table is built there.  A CUDA
    device runs the field and NTT math through the hand-written kernels; a
    CPU device runs their plain PyTorch versions.  The proof's per-round
    host times (seconds, device work included) are on ``proof._timings``;
    ``round1_aux_build`` (the RAP auxiliary trace, where the AIR has one) is
    part of ``round1``, the ``round4_*`` entries are parts of ``round4``.

    With ``mesh`` (``parallel.sharding.make_mesh``: one axis over the
    default process group) every rank calls ``prove`` with the same
    arguments and its own device, of the mesh's device type, and the ranks
    prove together (SPMD); ``shard_axis`` selects the layout:

    * ``"domain"`` — the LDE-domain axis of every round-1..4 tensor is
      block-sharded over the ranks; NTT, iNTT and LDE run as four-step
      transforms whose transposes are all-to-alls (parallel/four_step.py);
      constraints, DEEP and Merkle leaves are rank-local; the trace needs
      at least as many rows as the mesh has ranks.
    * ``"columns"`` — each rank interpolates and extends its block of trace
      columns with no communication, the blocks are all-gathered, and the
      rest runs as on one device on every rank, the domain replicated.

    Every rank returns the same proof, byte-equal to the single-device
    proof for any mesh size and either layout.

    With ``donate_trace`` the caller gives up ``main_trace``: its ``data``
    is None from the call on, and the prover frees the trace on the device
    once the auxiliary trace is built (the AIR may free it earlier, as
    soon as it has read the columns it needs).  ``LCP_AUX_HOST=1`` builds
    the auxiliary trace with the AIR's host oracle
    (``build_auxiliary_trace_host``, where it has one) instead of on the
    device; ``LCP_DEBUG_MEM=1`` prints the device memory after each phase
    (:func:`_mem`).  Neither changes a byte of the proof."""
    if shard_axis not in ("domain", "columns"):
        raise ProvingError(f"unknown shard_axis {shard_axis!r}; expected "
                           f"'domain' or 'columns'")
    if mesh is not None and torch.device(device).type != mesh.device_type:
        raise ProvingError(f"device {device} is not of the mesh's device "
                           f"type {mesh.device_type!r}")
    device = proving_device(device)
    timings = {}
    t0 = time.perf_counter()

    if main_trace.n_rows == 0 or main_trace.n_rows & (main_trace.n_rows - 1):
        raise ProvingError(
            f"trace length must be a power of two, got {main_trace.n_rows}"
        )
    if (mesh is not None and shard_axis == "domain"
            and main_trace.n_rows % mesh.size()):
        raise ProvingError(f"a trace of {main_trace.n_rows} rows cannot be "
                           f"domain-sharded over {mesh.size()} ranks")
    if donate_trace:
        # the prover's TraceTable holds the only reference from here on, so
        # that releasing it frees the device memory
        data, main_trace.data = main_trace.data, None
        main_trace = TraceTable(data.to(device))
        del data
    else:
        main_trace = main_trace.to(device)
    air = air_class(main_trace.n_rows, pub_inputs, proof_options)
    domain = Domain(air)
    if domain.lde_size > 1 << ProofOptions.NUM_BITS_MAX_DOMAIN_SIZE:
        raise ProvingError(
            f"LDE domain size 2^{domain.lde_size.bit_length() - 1} exceeds "
            f"the maximum 2^{ProofOptions.NUM_BITS_MAX_DOMAIN_SIZE}"
        )
    if mesh is None:
        kern = get_kernels(air, domain, device)
    else:
        from ..parallel.sharded_kernels import get_sharded_kernels

        kern = get_sharded_kernels(air, domain, mesh, device, shard_axis)

    def arr(ints) -> torch.Tensor:
        return fd.from_ints(list(ints), device=device)

    transcript = transcript_factory()
    n = air.trace_length()
    N = domain.lde_size
    g = domain.trace_primitive_root
    offsets = air.context.transition_offsets
    _sync(device)
    timings["round0"] = time.perf_counter() - t0
    _mem("round0: kernels+tables built", device)

    # ======================= Round 1: RAP =================================
    t1 = time.perf_counter()
    # one packed (8, main + aux columns, n | N) buffer pair for the whole
    # trace; both commits write into it in place (prover/kernels.py)
    n_main_cols = main_trace.n_cols
    n_aux_cols = air.number_auxiliary_rap_columns()
    trace_polys, lde_evals, main_levels = kern.interpolate_commit(
        main_trace.data, bufs=kern.alloc_buffers(n_main_cols + n_aux_cols),
        col_start=0)
    _mem("round1: main trace committed", device)
    main_tree = kern.tree(main_levels)
    transcript.append(main_tree.root)
    lde_trace_merkle_roots = [main_tree.root]
    lde_trace_merkle_trees = [main_tree]

    rap_challenges = air.build_rap_challenges(transcript)
    validate = os.environ.get("LCP_VALIDATE_TRACE")
    if donate_trace and not validate:
        # the AIR may free the trace as soon as it has read the columns it
        # needs (the auxiliary build's transients then reuse that memory);
        # the oracle below reads the whole trace, so not under it
        main_trace._release_after_read = True
    t1a = time.perf_counter()
    if (os.environ.get("LCP_AUX_HOST") == "1"
            and hasattr(air, "build_auxiliary_trace_host")):
        # the host oracle (same values): no device transients beyond the
        # upload of the finished columns
        aux_trace = air.build_auxiliary_trace_host(main_trace, rap_challenges)
    else:
        aux_trace = air.build_auxiliary_trace(main_trace, rap_challenges)
    if not aux_trace.is_empty():
        _sync(device)
        timings["round1_aux_build"] = time.perf_counter() - t1a
    _mem("round1: aux trace built", device)
    if validate:
        # Reference prover.rs:573-580 runs the pointwise constraint oracle on
        # every debug-build prove; here it is env-gated (it is O(n·constraints)
        # host work) and a failure aborts with a typed error instead of
        # letting a faulty AIR or trace surface only as a failed verify.
        from .debug import validate_trace

        if not validate_trace(air, main_trace, aux_trace, rap_challenges):
            raise ProvingError("trace does not satisfy the AIR constraints")
    if donate_trace:
        main_trace.data = None  # the last reference: the trace is freed
    if aux_trace.n_cols != n_aux_cols:
        raise ProvingError(f"the AIR built {aux_trace.n_cols} auxiliary "
                           f"columns but declares {n_aux_cols}")
    if n_aux_cols:
        trace_polys, lde_evals, aux_levels = kern.interpolate_commit(
            aux_trace.data.to(device), bufs=(trace_polys, lde_evals),
            col_start=n_main_cols)
        aux_tree = kern.tree(aux_levels)
        transcript.append(aux_tree.root)
        lde_trace_merkle_roots.append(aux_tree.root)
        lde_trace_merkle_trees.append(aux_tree)
    aux_trace = None  # committed: the (16, aux columns, n) build goes
    total_cols = trace_polys.shape[1]
    timings["round1"] = time.perf_counter() - t1
    _mem("round1: aux committed", device)

    # ======================= Round 2: composition poly ====================
    t2 = time.perf_counter()
    bc = air.boundary_constraints(rap_challenges)
    n_boundary = len(bc.constraints)
    boundary_alphas = batch_sample_challenges(n_boundary, transcript)
    boundary_betas = batch_sample_challenges(n_boundary, transcript)
    transition_alphas = batch_sample_challenges(
        air.context.num_transition_constraints, transcript
    )
    transition_betas = batch_sample_challenges(
        air.context.num_transition_constraints, transcript
    )

    boundary_ab = (arr(boundary_alphas), arr(boundary_betas))
    transition_ab = (arr(transition_alphas), arr(transition_betas))
    boundary_values = arr([c.value for c in bc.constraints])
    rap_arrays = tuple(fd.from_int(v, device=device) for v in rap_challenges)

    h1_coeffs, h2_coeffs, h1_lde, h2_lde, comp_levels = kern.round2(
        lde_evals, boundary_ab, transition_ab, boundary_values, rap_arrays
    )
    composition_tree = kern.tree(comp_levels)
    transcript.append(composition_tree.root)
    timings["round2"] = time.perf_counter() - t2
    _mem("round2: composition committed", device)

    # ======================= Round 3: OOD evaluations =====================
    t3 = time.perf_counter()
    z = _sample_z_ood(domain, transcript)
    z2 = z * z % P

    pw_z2 = kern.powers(z2, N // 2)  # H1, H2: N/2 coefficients each
    h1_dev = kern.eval_at_powers(h1_coeffs, pw_z2)
    h2_dev = kern.eval_at_powers(h2_coeffs, pw_z2)
    ood_dev = []
    for k in offsets:
        pw = kern.powers(z * pow(g, k, P) % P, n)
        ood_dev.append(kern.eval_at_powers(trace_polys, pw))  # (16, total_cols)
    # one copy to the host for all round-3 values
    r3_flat = fd.to_ints(torch.cat(
        [h1_dev.reshape(N_LIMBS, 1), h2_dev.reshape(N_LIMBS, 1)]
        + [o.reshape(N_LIMBS, -1) for o in ood_dev], dim=1), mont=False)
    h1_z2, h2_z2 = r3_flat[0], r3_flat[1]
    ood_flat = r3_flat[2:]
    trace_ood_rows = [
        ood_flat[i * total_cols:(i + 1) * total_cols]
        for i in range(len(offsets))
    ]

    transcript.append(fh.to_bytes_be(h1_z2))
    transcript.append(fh.to_bytes_be(h2_z2))
    for row in trace_ood_rows:
        for el in row:
            transcript.append(fh.to_bytes_be(el))
    timings["round3"] = time.perf_counter() - t3
    _mem("round3: OOD evaluations", device)

    # ======================= Round 4: DEEP + FRI ==========================
    t4 = time.perf_counter()
    gamma_even = transcript_to_field(transcript)
    gamma_odd = transcript_to_field(transcript)
    trace_gammas = batch_sample_challenges(len(offsets) * total_cols, transcript)

    points = [z * pow(g, k, P) % P for k in offsets] + [z2]
    point_arrs = torch.stack([fd.from_int(p_, device=device) for p_ in points])
    gammas_hh = torch.stack([fd.from_int(gamma_even, device=device),
                             fd.from_int(gamma_odd, device=device)])
    ood_tuple = tuple(arr(row) for row in trace_ood_rows) + (arr([h1_z2, h2_z2]),)

    deep_coeffs = kern.deep_poly(
        lde_evals, h1_lde, h2_lde, point_arrs, arr(trace_gammas), gammas_hh,
        ood_tuple
    )
    _sync(device)
    timings["round4_deep"] = time.perf_counter() - t4
    _mem("round4: deep poly", device)

    # FRI commit phase (reference fri/mod.rs:20-72)
    t4b = time.perf_counter()
    fri_layers, fri_last_value = _fri_commit(kern, domain, deep_coeffs,
                                             transcript, device)
    _sync(device)
    timings["round4_fri_commit"] = time.perf_counter() - t4b
    _mem("round4: FRI committed", device)

    # grinding (reference prover.rs:380-385)
    t4c = time.perf_counter()
    nonce = generate_nonce_with_grinding(
        transcript.challenge(), proof_options.grinding_factor, device
    )
    transcript.append(nonce.to_bytes(8, "big"))
    timings["round4_grinding"] = time.perf_counter() - t4c

    # FRI query phase (reference fri/mod.rs:74-127)
    t4d = time.perf_counter()
    iotas = [
        transcript_to_usize(transcript) % N
        for _ in range(proof_options.fri_number_of_queries)
    ]
    query_list = [FriDecommitment([], [], [], []) for _ in iotas]
    nq = len(iotas)
    open_idxs = [iota % N for iota in iotas]

    # Every device-side opening (FRI layer values at iota/iota_sym, H1/H2
    # and trace-row values) and every Merkle sibling of every device tree
    # is gathered on the device and copied to the host once.
    limb_parts, limb_off = [], [0]
    dig_parts, dig_off, dig_levels = [], [0], []

    def queue_limbs(src: torch.Tensor, idxs: list[int], length: int) -> int:
        part = kern.gather_points(src, idxs, length).reshape(N_LIMBS, -1)
        limb_parts.append(part)
        limb_off.append(limb_off[-1] + part.shape[1])
        return len(limb_parts) - 1

    def queue_tree(tree: MerkleTree, idxs: list[int]) -> int:
        part = tree.gather_siblings(idxs)
        dig_parts.append(part)
        dig_off.append(dig_off[-1] + part.shape[0])
        dig_levels.append(len(tree.levels) - 1)
        return len(dig_parts) - 1

    layer_plans = []
    for evals, tree, ds in fri_layers:
        both_idx = ([iota % ds for iota in iotas]
                    + [(iota + ds // 2) % ds for iota in iotas])
        if isinstance(evals, list):  # host-tail layer
            layer_plans.append(("host", [evals[i] for i in both_idx],
                                tree.get_proofs(both_idx)))
        else:
            layer_plans.append(("dev", queue_limbs(evals, both_idx, ds),
                                queue_tree(tree, both_idx)))
    h1_pos = queue_limbs(h1_lde, open_idxs, N)
    h2_pos = queue_limbs(h2_lde, open_idxs, N)
    rows_pos = queue_limbs(lde_evals, open_idxs, N)  # (16, cols * nq), col-major
    comp_pos = queue_tree(composition_tree, open_idxs)
    trace_pos = [queue_tree(t, open_idxs) for t in lde_trace_merkle_trees]

    all_ints = fd.to_ints(torch.cat(limb_parts, dim=1))
    digs_np = torch.cat(dig_parts, dim=0).cpu().numpy()

    def limbs_at(pos):
        return all_ints[limb_off[pos]: limb_off[pos + 1]]

    def tree_paths(tpos, k):
        base, n_levels = dig_off[tpos], dig_levels[tpos]
        return [
            [kd.digest_to_bytes(digs_np[base + li * k + q])
             for li in range(n_levels)]
            for q in range(k)
        ]

    for plan in layer_plans:
        if plan[0] == "host":
            _, vals_both, paths_both = plan
        else:
            _, lpos, tpos = plan
            vals_both = limbs_at(lpos)
            paths_both = tree_paths(tpos, 2 * nq)
        vals, vals_sym = vals_both[:nq], vals_both[nq:]
        paths, paths_sym = paths_both[:nq], paths_both[nq:]
        for q in range(nq):
            query_list[q].layers_evaluations.append(vals[q])
            query_list[q].layers_evaluations_sym.append(vals_sym[q])
            query_list[q].layers_auth_paths.append(paths[q])
            query_list[q].layers_auth_paths_sym.append(paths_sym[q])

    # DEEP openings (reference prover.rs:484-529)
    h1_open, h2_open = limbs_at(h1_pos), limbs_at(h2_pos)
    trace_rows_ints = limbs_at(rows_pos)
    comp_paths = tree_paths(comp_pos, nq)
    trace_paths_per_tree = [tree_paths(tp, nq) for tp in trace_pos]
    deep_poly_openings = []
    for q in range(nq):
        row = [trace_rows_ints[j * nq + q] for j in range(total_cols)]
        deep_poly_openings.append(
            DeepPolynomialOpenings(
                lde_composition_poly_proof=comp_paths[q],
                lde_composition_poly_even_evaluation=h1_open[q],
                lde_composition_poly_odd_evaluation=h2_open[q],
                lde_trace_merkle_proofs=[tp[q] for tp in trace_paths_per_tree],
                lde_trace_evaluations=row,
            )
        )
    timings["round4_queries"] = time.perf_counter() - t4d
    timings["round4"] = time.perf_counter() - t4
    _mem("round4: queries gathered", device)

    if instrument:
        # whole rounds only: the round1_* and round4_* parts lie inside them
        total = sum(timings[k] for k in ["round1", "round2", "round3", "round4"])
        fractions = " ".join(
            f"{timings[k] / total:.4f}"
            for k in ["round0", "round1", "round2", "round3", "round4"]
        )
        print(f"Fraction of proving time per round: {fractions}")

    proof = StarkProof(
        lde_trace_merkle_roots=lde_trace_merkle_roots,
        trace_ood_frame_evaluations=trace_ood_rows,
        composition_poly_root=composition_tree.root,
        composition_poly_even_ood_evaluation=h1_z2,
        composition_poly_odd_ood_evaluation=h2_z2,
        fri_layers_merkle_roots=[layer[1].root for layer in fri_layers],
        fri_last_value=fri_last_value,
        query_list=query_list,
        deep_poly_openings=deep_poly_openings,
        nonce=nonce,
        trace_length=n,
    )
    proof._timings = timings
    return proof
