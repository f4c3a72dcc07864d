"""STARK proof containers (reference src/starks/proof/stark.rs:18-51).

Field elements are canonical python ints; commitments/digests are 32-byte
``bytes``.  The bit-exact wire format lives in proof/serde.py."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class FriDecommitment:
    layers_auth_paths_sym: list  # list[list[bytes]]
    layers_evaluations_sym: list  # list[int]
    layers_evaluations: list  # list[int]
    layers_auth_paths: list  # list[list[bytes]]


@dataclass
class DeepPolynomialOpenings:
    lde_composition_poly_proof: list  # list[bytes]
    lde_composition_poly_even_evaluation: int
    lde_composition_poly_odd_evaluation: int
    lde_trace_merkle_proofs: list  # list[list[bytes]] (one per trace tree)
    lde_trace_evaluations: list  # list[int] (row of all trace columns)


@dataclass
class StarkProof:
    lde_trace_merkle_roots: list  # list[bytes]
    trace_ood_frame_evaluations: list  # list[list[int]] rows x columns
    composition_poly_root: bytes
    composition_poly_even_ood_evaluation: int
    composition_poly_odd_ood_evaluation: int
    fri_layers_merkle_roots: list  # list[bytes]
    fri_last_value: int
    query_list: list  # list[FriDecommitment]
    deep_poly_openings: list  # list[DeepPolynomialOpenings]
    nonce: int
    trace_length: int
