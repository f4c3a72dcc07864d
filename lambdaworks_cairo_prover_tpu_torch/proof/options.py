"""Proof options and security presets (reference src/starks/proof/options.rs)."""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

from ..field.params import FIELD_BIT_SIZE


class InsecureOptionError(Exception):
    pass


class SecurityLevel(Enum):
    Conjecturable80Bits = "conjecturable_80"
    Conjecturable100Bits = "conjecturable_100"
    Conjecturable128Bits = "conjecturable_128"
    Provable80Bits = "provable_80"
    Provable100Bits = "provable_100"
    Provable128Bits = "provable_128"


_PRESETS = {
    SecurityLevel.Conjecturable80Bits: (4, 31, 20),
    SecurityLevel.Conjecturable100Bits: (4, 41, 20),
    SecurityLevel.Conjecturable128Bits: (4, 55, 20),
    SecurityLevel.Provable80Bits: (4, 80, 20),
    SecurityLevel.Provable100Bits: (4, 104, 20),
    SecurityLevel.Provable128Bits: (4, 140, 20),
}


@dataclass(frozen=True)
class ProofOptions:
    blowup_factor: int
    fri_number_of_queries: int
    coset_offset: int
    grinding_factor: int

    EXTENSION_DEGREE = 1
    NUM_BITS_MAX_DOMAIN_SIZE = 40

    @classmethod
    def new_secure(cls, level: SecurityLevel, coset_offset: int) -> "ProofOptions":
        blowup, queries, grinding = _PRESETS[level]
        return cls(blowup, queries, coset_offset, grinding)

    @classmethod
    def new_with_checked_security(
        cls, blowup_factor, fri_number_of_queries, coset_offset, grinding_factor,
        security_target,
    ) -> "ProofOptions":
        cls._check_field_security(security_target)
        num_bits_blowup = _trailing_zeros(blowup_factor)
        if security_target >= (
            grinding_factor + num_bits_blowup * fri_number_of_queries - 1
        ):
            raise InsecureOptionError("security bits")
        return cls(blowup_factor, fri_number_of_queries, coset_offset, grinding_factor)

    @classmethod
    def new_with_checked_provable_security(
        cls, blowup_factor, fri_number_of_queries, coset_offset, grinding_factor,
        security_target,
    ) -> "ProofOptions":
        cls._check_field_security(security_target)
        # mirrors the reference formula (options.rs:114-118), including its use
        # of leading_zeros of the u8 blowup factor
        num_bits_blowup = 8 - blowup_factor.bit_length()
        if security_target < grinding_factor + num_bits_blowup * fri_number_of_queries // 2:
            raise InsecureOptionError("security bits")
        return cls(blowup_factor, fri_number_of_queries, coset_offset, grinding_factor)

    @classmethod
    def _check_field_security(cls, security_target: int) -> None:
        if FIELD_BIT_SIZE * cls.EXTENSION_DEGREE <= (
            security_target + cls.NUM_BITS_MAX_DOMAIN_SIZE
        ):
            raise InsecureOptionError("field size")

    @classmethod
    def default_test_options(cls) -> "ProofOptions":
        return cls(blowup_factor=4, fri_number_of_queries=3, coset_offset=3,
                   grinding_factor=1)


def _trailing_zeros(x: int) -> int:
    return (x & -x).bit_length() - 1 if x else 0
