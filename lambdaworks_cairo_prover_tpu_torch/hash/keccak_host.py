"""Pure-python Keccak-256 (original Keccak padding 0x01, as in the `sha3`
Rust crate's `Keccak256`).  Used for the host-side Fiat-Shamir transcript and
verifier (tiny data; reference: src/starks/grinding.rs:1, lambdaworks-crypto
DefaultTranscript)."""

from __future__ import annotations

_ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_ROTATIONS = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_MASK = (1 << 64) - 1


def _rotl(x: int, n: int) -> int:
    n %= 64
    return ((x << n) | (x >> (64 - n))) & _MASK


def keccak_f(state: list[int]) -> list[int]:
    """keccak-f[1600] on a 25-lane state (state[x + 5*y])."""
    a = state
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(a[x + 5 * y], _ROTATIONS[x][y])
        # chi
        a = [
            b[i] ^ ((~b[(i % 5 + 1) % 5 + 5 * (i // 5)]) & b[(i % 5 + 2) % 5 + 5 * (i // 5)])
            for i in range(25)
        ]
        a = [v & _MASK for v in a]
        # iota
        a[0] ^= rc
    return a


_RATE = 136  # bytes, for 256-bit output


def _load_native():
    """ctypes handle to native/libkeccak256.so, or None (python fallback)."""
    import ctypes
    import os

    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "native", "libkeccak256.so")
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    lib.keccak256.restype = None
    lib.keccak256.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                              ctypes.c_char_p]
    if hasattr(lib, "keccak256_merkle_fold"):
        lib.keccak256_merkle_fold.restype = None
        lib.keccak256_merkle_fold.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_uint64, ctypes.c_char_p,
        ]
    if hasattr(lib, "keccak256_merkle_fold_batch"):
        lib.keccak256_merkle_fold_batch.restype = None
        lib.keccak256_merkle_fold_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_size_t,
            ctypes.c_char_p,
        ]
    if hasattr(lib, "keccak256_batch"):
        lib.keccak256_batch.restype = None
        lib.keccak256_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_char_p,
        ]
    return lib


_NATIVE = _load_native()


def keccak256(data: bytes) -> bytes:
    if _NATIVE is not None:
        out = bytes(32)
        _NATIVE.keccak256(data, len(data), out)
        return out
    return _keccak256_py(data)


def merkle_fold(leaf_hash: bytes, path: list[bytes], index: int) -> bytes:
    """Fold an authentication path to its root digest (lambdaworks
    `Proof::verify` rule) — one native call per path instead of one ctypes
    round trip per level."""
    if (_NATIVE is not None and hasattr(_NATIVE, "keccak256_merkle_fold")
            and len(leaf_hash) == 32
            and all(len(s) == 32 for s in path)):
        out = bytes(32)
        _NATIVE.keccak256_merkle_fold(leaf_hash, b"".join(path), len(path),
                                      index, out)
        return out
    # python fallback — also the safe path for malformed (non-32-byte)
    # sibling entries in adversarial proofs
    h = leaf_hash
    for sibling in path:
        h = keccak256(h + sibling) if index % 2 == 0 else keccak256(sibling + h)
        index >>= 1
    return h


def keccak256_batch(msgs: list[bytes]) -> list[bytes]:
    """Hash a batch of equal-length messages in one native call (falls back
    to per-message hashing for ragged batches or without the .so)."""
    n = len(msgs)
    if n == 0:
        return []
    length = len(msgs[0])
    if (_NATIVE is not None and hasattr(_NATIVE, "keccak256_batch")
            and all(len(m) == length for m in msgs)):
        out = bytes(32 * n)
        _NATIVE.keccak256_batch(b"".join(msgs), length, n, out)
        return [out[32 * i: 32 * i + 32] for i in range(n)]
    return [keccak256(m) for m in msgs]


def merkle_fold_batch(leaf_hashes: list[bytes], paths: list[list[bytes]],
                      indices: list[int]) -> list[bytes]:
    """Fold a batch of equal-depth authentication paths — one native call
    per TREE instead of one per path (the verifier's hot loop: Q queries x
    FRI layers x 2 openings)."""
    n = len(leaf_hashes)
    if n == 0:
        return []
    depth = len(paths[0])
    # the native fast path requires a perfectly regular batch (equal counts,
    # equal depths, 32-byte digests); adversarial proofs fall back to the
    # memory-safe python loop
    native_ok = (_NATIVE is not None
                 and hasattr(_NATIVE, "keccak256_merkle_fold_batch")
                 and len(paths) == n and len(indices) == n
                 and all(len(lh) == 32 for lh in leaf_hashes)
                 and all(len(p) == depth for p in paths)
                 and all(len(s) == 32 for p in paths for s in p))
    if native_ok:
        import ctypes

        out = bytes(32 * n)
        idx_arr = (ctypes.c_uint64 * n)(*indices)
        _NATIVE.keccak256_merkle_fold_batch(
            b"".join(leaf_hashes),
            b"".join(b"".join(p) for p in paths),
            depth, idx_arr, n, out,
        )
        return [out[32 * i: 32 * i + 32] for i in range(n)]
    return [merkle_fold(lh, p, i)
            for lh, p, i in zip(leaf_hashes, paths, indices)]


def _keccak256_py(data: bytes) -> bytes:
    state = [0] * 25
    # pad: 0x01 ... 0x80 (original Keccak; SHA3 would use 0x06)
    padlen = _RATE - (len(data) % _RATE)
    padded = data + b"\x01" + b"\x00" * (padlen - 2) + b"\x80" if padlen >= 2 else (
        data + b"\x81"
    )
    for off in range(0, len(padded), _RATE):
        block = padded[off : off + _RATE]
        for i in range(_RATE // 8):
            state[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        state = keccak_f(state)
    out = b"".join(state[i].to_bytes(8, "little") for i in range(4))
    return out
