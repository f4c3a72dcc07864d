"""Keccak-256 (the original padding, 0x01 ... 0x80) over batches of
equal-length messages, in NumPy uint64 lanes: the reference's hash for
Merkle paths and the Fiat-Shamir transcript.

Written from the Keccak specification (FIPS 202's Keccak-f[1600] with the
pre-standard padding of the `sha3` crate's `Keccak256`); it shares no code
with the prover."""

from __future__ import annotations

import numpy as np

RATE = 136  # bytes: 1600 - 2 * 256 bits

_RC = np.array([
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
], dtype=np.uint64)
_RC_INTS = [int(v) for v in _RC]

# rho offsets r[x][y] of lane (x, y), which lives at index x + 5 y
_RHO = [[0, 36, 3, 41, 18], [1, 44, 10, 45, 2], [62, 6, 43, 15, 61],
        [28, 55, 25, 21, 56], [27, 20, 39, 8, 14]]
# pi: lane (x, y) moves to (y, 2x + 3y)
_PI = [(x + 5 * y, y + 5 * ((2 * x + 3 * y) % 5), _RHO[x][y])
       for x in range(5) for y in range(5)]


_SHIFTS = [(np.uint64(n), np.uint64(64 - n)) for n in range(64)]
_MASK = (1 << 64) - 1


def _rotl(v: np.ndarray, n: int) -> np.ndarray:
    if n == 0:
        return v
    left, right = _SHIFTS[n]
    return (v << left) | (v >> right)


def _keccak_f_ints(a: list[int]) -> list[int]:
    """The same permutation on one state of Python ints (a single message
    is faster so than as a batch of one)."""
    for rc in _RC_INTS:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20]
             for x in range(5)]
        d = [c[x - 1] ^ (((c[(x + 1) % 5] << 1) | (c[(x + 1) % 5] >> 63))
                         & _MASK) for x in range(5)]
        b = [0] * 25
        for src, dst, r in _PI:
            v = a[src] ^ d[src % 5]
            b[dst] = ((v << r) | (v >> (64 - r))) & _MASK if r else v
        a = [b[i] ^ (~b[i - i % 5 + (i + 1) % 5] & b[i - i % 5 + (i + 2) % 5])
             for i in range(25)]
        a[0] ^= rc
    return a


def keccak_f(a: np.ndarray) -> np.ndarray:
    """Keccak-f[1600] on (25, B) uint64 states, lane (x, y) at x + 5 y."""
    for rc in _RC:
        c = a[0:5] ^ a[5:10] ^ a[10:15] ^ a[15:20] ^ a[20:25]
        d = np.roll(c, 1, axis=0) ^ _rotl(np.roll(c, -1, axis=0), 1)
        a = a ^ np.tile(d, (5, 1))
        b = np.empty_like(a)
        for src, dst, r in _PI:
            b[dst] = _rotl(a[src], r)
        rows = b.reshape(5, 5, -1)  # [y][x]
        a = (rows ^ (~np.roll(rows, -1, axis=1) & np.roll(rows, -2, axis=1))
             ).reshape(25, -1)
        a[0] ^= rc
    return a


def keccak256_batch(msgs: list[bytes]) -> list[bytes]:
    """Digests of messages that all have the same length."""
    if not msgs:
        return []
    length = len(msgs[0])
    if any(len(m) != length for m in msgs):
        raise ValueError("keccak256_batch takes messages of one length")
    pad = RATE - length % RATE
    tail = b"\x81" if pad == 1 else b"\x01" + b"\x00" * (pad - 2) + b"\x80"
    blob = b"".join(m + tail for m in msgs)
    blocks = (length + pad) // RATE
    lanes = np.frombuffer(blob, dtype="<u8").reshape(len(msgs), blocks,
                                                       RATE // 8)
    if len(msgs) == 1:
        st = [0] * 25
        for k in range(blocks):
            for i, v in enumerate(lanes[0, k].tolist()):
                st[i] ^= v
            st = _keccak_f_ints(st)
        return [b"".join(v.to_bytes(8, "little") for v in st[:4])]
    state = np.zeros((25, len(msgs)), dtype=np.uint64)
    for k in range(blocks):
        state[:RATE // 8] ^= lanes[:, k, :].T
        state = keccak_f(state)
    out = state[:4].T.astype("<u8").tobytes()
    return [out[32 * i:32 * i + 32] for i in range(len(msgs))]


def keccak256(msg: bytes) -> bytes:
    return keccak256_batch([msg])[0]


def merkle_roots(leaf_hashes: list[bytes], paths: list[list[bytes]],
                 indices: list[int]) -> list[bytes]:
    """Fold authentication paths of one depth to their roots: at each level
    the node is hashed with its sibling, on the left where its index is
    even.  A path of another depth or a node that is not 32 bytes gives
    ``None`` for that path."""
    n = len(leaf_hashes)
    if n == 0:
        return []
    depth = len(paths[0])
    good = [len(p) == depth and all(len(s) == 32 for s in p)
            and len(h) == 32 for h, p in zip(leaf_hashes, paths)]
    nodes = [h if ok else bytes(32) for h, ok in zip(leaf_hashes, good)]
    idx = list(indices)
    for level in range(depth):
        msgs = []
        for i in range(n):
            sib = paths[i][level] if good[i] else bytes(32)
            msgs.append(nodes[i] + sib if idx[i] % 2 == 0 else sib + nodes[i])
            idx[i] >>= 1
        nodes = keccak256_batch(msgs)
    return [h if ok else None for h, ok in zip(nodes, good)]
