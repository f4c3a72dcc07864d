"""Batched Keccak-256: Merkle leaves and nodes, grinding nonces.

The public functions take CUDA tensors (or a CUDA device) to the Keccak
kernels of :mod:`.cuda_keccak` (K1 ``keccak_rows``, K2 ``keccak_pairs`` over
one level and ``keccak_tree`` over a tree, K3 ``keccak_grind``) and CPU ones
to their plain versions here (``*_plain``), which the tests and the chip
check hold the kernels against.

The plain versions run keccak-f[1600] over a batch of messages at once.
The state is a (25, n) int64 tensor, one row per 64-bit lane (lane x + 5y),
each round a few whole-state ops: theta and chi as rolls over a (5, 5, n)
view, rho as one per-lane shift, pi as one row gather.  int64 is
two's-complement, so xor/and/not/left shift act on the 64 bits as on u64;
a logical right shift masks after the arithmetic one.

Digests are (n, 4) int64 tensors: lane j of the final state, i.e. digest
bytes 8j..8j+8 little-endian (the JAX package keeps the same bytes as (n, 8)
uint32 words).
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_keccak as ck

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_RATE_LANES = 17  # 136 bytes
_MAX_POS = (1 << 63) - 1
# the plain versions' passes: the state and the temporaries of a round take
# some 2 KB a message (16 GiB for the 2^23 single-felt leaves of a 2^21-row
# trace's first FRI layer in one pass), the byte expansion of a row some 40
# int64 words a felt
_LEAF_CHUNK_FELTS = 1 << 23  # felts hashed per pass of hash_felt_rows_plain
_ABSORB_CHUNK = 1 << 21  # messages absorbed per pass


def _signed(v: int) -> int:
    """u64 -> the int64 with the same bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


_RC_I64 = [_signed(v) for v in _RC]
# rho amount of lane i, and pi: b[_PI_DST[i]] = rotl(a[i], _RHO[i])
_RHO = [_ROT[i % 5][i // 5] for i in range(25)]
_PI_DST = [(i // 5) + 5 * ((2 * (i % 5) + 3 * (i // 5)) % 5) for i in range(25)]
_PI_SRC = [0] * 25
for _i, _d in enumerate(_PI_DST):
    _PI_SRC[_d] = _i


def _shr(x: torch.Tensor, k) -> torch.Tensor:
    """Logical right shift of int64 bits by k in [1, 64] (k may be a tensor)."""
    return ((x >> 1) & _MAX_POS) >> (k - 1)


_perm_cache: dict = {}  # device -> (rho, 64 - rho, pi source rows)


def _perm_tables(dev: torch.device) -> tuple:
    """The rho amounts and pi rows on ``dev``, copied there once (a copy
    in every call would wait for the device each time)."""
    if dev not in _perm_cache:
        rho = torch.tensor(_RHO, dtype=torch.int64, device=dev)[:, None]
        _perm_cache[dev] = (rho, 64 - rho, torch.tensor(
            _PI_SRC, dtype=torch.int64, device=dev))
    return _perm_cache[dev]


def _keccak_f(state: torch.Tensor) -> torch.Tensor:
    """keccak-f[1600] on a (25, n) int64 state."""
    rho, rho_r, pi_src = _perm_tables(state.device)
    a = state
    for rc in _RC_I64:
        a5 = a.reshape(5, 5, -1)  # [y][x]
        c = a5[0] ^ a5[1] ^ a5[2] ^ a5[3] ^ a5[4]
        c1 = torch.roll(c, -1, 0)
        d = torch.roll(c, 1, 0) ^ ((c1 << 1) | _shr(c1, 63))
        a = (a5 ^ d[None]).reshape(25, -1)
        rot = (a << rho) | _shr(a, rho_r)
        b5 = rot.index_select(0, pi_src).reshape(5, 5, -1)
        a5 = b5 ^ (~torch.roll(b5, -1, 1) & torch.roll(b5, -2, 1))
        a5[0, 0] ^= rc
        a = a5.reshape(25, -1)
    return a


def _absorb(lanes: torch.Tensor) -> torch.Tensor:
    """Pre-padded messages (n, L) int64 lanes, L a multiple of 17 -> (n, 4),
    _ABSORB_CHUNK messages at a time."""
    n, total = lanes.shape
    if n > _ABSORB_CHUNK:
        out = torch.empty((n, 4), dtype=torch.int64, device=lanes.device)
        for r0 in range(0, n, _ABSORB_CHUNK):
            out[r0:r0 + _ABSORB_CHUNK] = _absorb(lanes[r0:r0 + _ABSORB_CHUNK])
        return out
    state = torch.zeros((25, n), dtype=torch.int64, device=lanes.device)
    for blk in range(total // _RATE_LANES):
        block = lanes[:, blk * _RATE_LANES:(blk + 1) * _RATE_LANES]
        state = state.clone()
        state[:_RATE_LANES] ^= block.T
        state = _keccak_f(state)
    return state[:4].T.contiguous()


def _pad_bytes(msg: torch.Tensor) -> torch.Tensor:
    """(n, len) uint8 messages -> (n, L) int64 lanes with Keccak padding
    (0x01 ... 0x80, rate 136 bytes)."""
    n, length = msg.shape
    total = (length // 136 + 1) * 136
    buf = torch.zeros((n, total), dtype=torch.uint8, device=msg.device)
    buf[:, :length] = msg
    buf[:, length] ^= 0x01
    buf[:, total - 1] ^= 0x80
    return buf.view(torch.int64)


def felts_to_be_bytes(limbs: torch.Tensor) -> torch.Tensor:
    """(16, ...) canonical limbs -> (..., 32) uint8, the 32-byte big-endian
    encoding of each element."""
    x = torch.movedim(limbs.to(torch.int64), 0, -1)  # (..., 16) LE limbs
    le = torch.stack([x & 0xFF, x >> 8], dim=-1).reshape(x.shape[:-1] + (32,))
    return le.flip(-1).to(torch.uint8)


def hash_felt_rows(limbs: torch.Tensor, n_cols: int) -> torch.Tensor:
    """Hash each row of felts: limbs (16, n_rows, n_cols) -> (n_rows, 4).

    lambdaworks `BatchKeccak256Tree` leaf hashing: Keccak256 of the
    concatenated 32-byte BE encodings of the row's (non-Montgomery)
    elements.  A CUDA tensor goes to K1 as the (16, n_cols, n_rows) view
    of the same storage, whatever its strides."""
    if limbs.device.type == "cpu":
        return hash_felt_rows_plain(limbs, n_cols)
    if limbs.dim() != 3 or limbs.shape[2] != n_cols:
        raise ValueError(f"hash_felt_rows: expected (16, n_rows, {n_cols}) "
                         f"limbs, got shape {tuple(limbs.shape)}")
    return ck.keccak_rows(limbs.transpose(1, 2))


def hash_felt_rows_plain(limbs: torch.Tensor, n_cols: int) -> torch.Tensor:
    """K1's plain version: :func:`hash_felt_rows` in whole-state ops, rows in
    passes of about 2^23 felts (values do not depend on the pass)."""
    n_rows = limbs.shape[1]
    step = max(1, _LEAF_CHUNK_FELTS // max(n_cols, 1))
    out = []
    for r0 in range(0, n_rows, step):
        part = limbs[:, r0:r0 + step]
        msg = felts_to_be_bytes(part).reshape(part.shape[1], n_cols * 32)
        out.append(_absorb(_pad_bytes(msg)))
    return out[0] if len(out) == 1 else torch.cat(out, dim=0)


def hash_felt_leaves(limbs: torch.Tensor) -> torch.Tensor:
    """Hash single-felt leaves: (16, n) -> (n, 4) (lambdaworks `Keccak256Tree`)."""
    return hash_felt_rows(limbs[:, :, None], 1)


def hash_digest_pairs(digests: torch.Tensor) -> torch.Tensor:
    """Parent nodes: (2k, 4) -> (k, 4), Keccak256(left || right)."""
    if digests.device.type == "cpu":
        return hash_digest_pairs_plain(digests)
    return ck.keccak_pairs(digests)


def hash_digest_pairs_plain(digests: torch.Tensor) -> torch.Tensor:
    """K2's plain version of :func:`hash_digest_pairs`."""
    k = digests.shape[0] // 2
    msg = digests.reshape(k, 8).contiguous().view(torch.uint8)  # (k, 64)
    return _absorb(_pad_bytes(msg))


def tree_level_sizes(n: int) -> list:
    """Rows of each level above n leaves, level 1 first and the root last
    ([] for n <= 1)."""
    sizes = []
    while n > 1:
        n //= 2
        sizes.append(n)
    return sizes


def hash_tree(leaves: torch.Tensor) -> torch.Tensor:
    """Every level of the Merkle tree above (n, 4) leaf digests: one (n - 1,
    4) tensor, the levels of :func:`tree_level_sizes` one after the other.
    A CUDA tensor goes to K2 (``keccak_tree``: one launch)."""
    if leaves.device.type == "cpu":
        return hash_tree_plain(leaves)
    return ck.keccak_tree(leaves)


def hash_tree_plain(leaves: torch.Tensor) -> torch.Tensor:
    """K2's plain version of :func:`hash_tree`: a level at a time, each by
    :func:`hash_digest_pairs_plain`."""
    sizes = tree_level_sizes(leaves.shape[0])
    buf = torch.empty((sum(sizes), 4), dtype=torch.int64, device=leaves.device)
    cur, off = leaves, 0
    for size in sizes:
        buf[off:off + size] = hash_digest_pairs_plain(cur)
        cur = buf[off:off + size]
        off += size
    return buf


def digest_words_to_masked_limbs(digest: torch.Tensor) -> torch.Tensor:
    """(4,) int64 digest lanes -> (16, 1) RAW (non-Montgomery) limbs of the
    251-bit-masked big-endian integer: the tensor twin of
    transcript_to_field (field/host.py::randomness_to_field) for the
    252-bit Stark252 field only (the FRI chain's gate checks the field).
    Bytes are widened from uint8, so no arithmetic shift is involved."""
    be = digest.contiguous().view(torch.uint8).to(torch.int64)  # 32 bytes
    le = be.flip(0)
    limbs = le[0::2] | (le[1::2] << 8)
    limbs[15] &= 0x7FF  # clear the top 5 of 256 bits
    return limbs.to(torch.int32)[:, None]


def digest_to_bytes(digest_row) -> bytes:
    """(4,) int64 lanes -> 32 bytes."""
    if isinstance(digest_row, torch.Tensor):
        digest_row = digest_row.detach().cpu().numpy()
    return np.asarray(digest_row, dtype="<i8").tobytes()


def grinding_batch(challenge: bytes, start: int, size: int,
                   grinding_factor: int, device):
    """Search the candidate u64 nonces [start, start + size).

    Message = challenge || nonce_le_u64 (40 bytes; reference grinding.rs:21-28);
    condition: trailing_zeros(first 8 digest bytes read as BE u64) >= factor.
    Returns (found, index in the batch of the first hit, else ``size``) as
    0-d tensors, without waiting for the device."""
    if torch.device(device).type == "cpu":
        return grinding_batch_plain(challenge, start, size, grinding_factor,
                                    device)
    lanes = np.frombuffer(challenge, dtype="<u8")
    return ck.keccak_grind(lanes.tolist(), start, size, grinding_factor,
                           device)


def grinding_batch_plain(challenge: bytes, start: int, size: int,
                         grinding_factor: int, device):
    """K3's plain version of :func:`grinding_batch`."""
    if start < 0 or start + size > 1 << 63:
        raise ValueError("nonce batch outside [0, 2^63)")
    words = np.frombuffer(challenge, dtype="<i8")
    lanes = torch.zeros((size, _RATE_LANES), dtype=torch.int64, device=device)
    lanes[:, :4] = torch.from_numpy(words.copy()).to(device)
    lanes[:, 4] = torch.arange(start, start + size, dtype=torch.int64,
                               device=device)
    lanes[:, 5] = 0x01  # byte 40
    lanes[:, 16] = _signed(0x80 << 56)  # byte 135
    lane0 = _absorb(lanes)[:, 0]
    ok = (lane0 & _signed(ck.lane0_mask(grinding_factor))) == 0
    idx = torch.arange(size, dtype=torch.int64, device=device)
    first = torch.where(ok, idx, torch.full_like(idx, size)).min()
    return first < size, first
