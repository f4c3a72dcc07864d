"""K4 `fri_tail`: the FRI commit phase's layers of at most 2^MAX_LOG points
and its final fold in one launch of one cluster of blocks
(csrc/fri_tail.cu), its plain PyTorch version, and what both leave on the
device (:class:`FriTail`).

K4 replaces the host tail of the JAX package's FRI commit (prover/prove.py:
``_host_fold``, ``_host_evaluate_offset_fft``, ``_HostMerkle``), which the
port's prove still takes where the kernels or the transcript rule out this
route.  The plain version is the FRI chain's per-layer arithmetic
(:func:`draw`, the fold, ``evaluate_offset_fft``, the leaf and tree hashes)
on the fd, NTT and Keccak functions, which CPU tensors take to their own
plain versions.  :func:`fri_tail` sends a CPU tensor, or any tensor of a
toy field, to the plain version and a CUDA tensor to K4.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import cuda_lib
from ..field import device as fd
from ..field.params import N_LIMBS, SPARSE_P
from ..hash import keccak_device as kd
from ..hash.merkle import tree_levels
from ..ntt import core as nttc
from ..ntt import cuda_ntt as cn

MAX_LOG = 12  # kTailMaxLog in csrc/fri_tail.cu: the first layer's points
# blocks of K4's cluster, which share the leaves and subtrees of each
# layer: the largest portable cluster (an H100, the cells' tail: 1.15 ms
# with 1 block, 0.73 with 4, 0.65 with 8, 0.61 with 16, which needs a
# non-portable cluster)
CLUSTER = 8


class FriTail(NamedTuple):
    """The tail's layers on the device, one after the other.

    rows: (L + 1, 4) int64, each layer's Merkle root, then the last value's
      32 little-endian bytes (canonical);
    states: (L + 1, 4) int64, the transcript state after each draw;
    evals: (16, sum of sizes) int32, each layer's evaluations in Montgomery
      limbs;
    levels: (sum of 2 size - 1, 4) int64, each layer's leaf digests and then
      its tree's levels up to the root;
    sizes: each layer's points."""

    rows: torch.Tensor
    states: torch.Tensor
    evals: torch.Tensor
    levels: torch.Tensor
    sizes: tuple

    def layer_evals(self, k: int) -> torch.Tensor:
        """Layer k's (16, size) evaluations, a view."""
        start = sum(self.sizes[:k])
        return self.evals[:, start:start + self.sizes[k]]

    def layer_levels(self, k: int) -> list:
        """Layer k's [leaves, level 1, ..., root], views (as ``tree_levels``
        returns them)."""
        start = sum(2 * s - 1 for s in self.sizes[:k])
        out, size = [], self.sizes[k]
        while size:
            out.append(self.levels[start:start + size])
            start += size
            size //= 2
        return out

    def gather(self, idxs: list) -> tuple:
        """The openings of every layer at its points ``idxs[k]``, in one
        index_select for the values and one for the Merkle siblings:
        ((16, sum of len(idxs[k])) Montgomery limbs, layer after layer;
        (sum of levels_k * len(idxs[k]), 4) digests, each layer's level-major
        as ``MerkleTree.gather_siblings`` gives them)."""
        values, siblings = [], []
        e_off = l_off = 0
        for size, ix in zip(self.sizes, idxs):
            ix = np.asarray(ix, dtype=np.int64)
            values.append(e_off + ix)
            start = 0
            for li in range(size.bit_length() - 1):
                siblings.append(l_off + start + ((ix >> li) ^ 1))
                start += size >> li
            e_off += size
            l_off += 2 * size - 1
        n_values = sum(len(v) for v in values)
        pos = torch.from_numpy(np.concatenate(values + siblings)).to(
            self.evals.device)
        return (self.evals.index_select(1, pos[:n_values]),
                self.levels.index_select(0, pos[n_values:]))


def draw(state: torch.Tensor, root: torch.Tensor) -> tuple:
    """The FRI layers' Fiat-Shamir draw on the device, as
    transcript/fiat_shamir.py draws after appending the root: state' =
    keccak256(state || root), zeta = state' as a big-endian integer masked
    to 251 bits (Stark252 only), in Montgomery form.  (1, 4) digests ->
    ((1, 4) state', (16, 1) zeta)."""
    state = kd.hash_digest_pairs(torch.cat([state, root]))
    return state, fd.to_mont(kd.digest_words_to_masked_limbs(state[0]))


def value_lanes(value: torch.Tensor) -> torch.Tensor:
    """(16, 1) canonical limbs -> (1, 4) int64, the value's 32 little-endian
    bytes (16-bit limbs into 64-bit lanes; p < 2^252 leaves the sign bit
    clear)."""
    shifts = torch.arange(0, 64, 16, dtype=torch.int64, device=value.device)
    return (value.to(torch.int64).reshape(4, 4) << shifts).sum(1)[None]


def _sizes(coeffs: torch.Tensor, layers) -> tuple:
    """The layers' sizes, after checking that they halve and that the
    coefficients fold to the final fold's two."""
    sizes = tuple(ds for _, ds in layers)
    if not sizes or any(b * 2 != a for a, b in zip(sizes, sizes[1:])):
        raise ValueError(f"fri_tail: layer sizes {sizes} do not halve")
    n = len(sizes)
    if coeffs.dim() != 2 or coeffs.shape[1] != 2 << n:
        raise ValueError(f"fri_tail: {n} layers fold 2^{n + 1} coefficients "
                         f"to the final fold's two, got shape "
                         f"{tuple(coeffs.shape)}")
    if sizes[0] < 1 << n:
        raise ValueError(f"fri_tail: a layer of {sizes[0]} points cannot "
                         f"hold its {1 << n} coefficients")
    return sizes


def fri_tail(coeffs: torch.Tensor, state: torch.Tensor, root: torch.Tensor,
             layers) -> FriTail:
    """Commit the FRI layers ``layers`` ((offset, points) each, the points
    halving) after the layer whose root is ``root``, and make the final
    fold: for each layer a draw from the state, the fold of the
    coefficients, their evaluations on the layer's coset and its Merkle
    tree; then a draw and the fold of the two coefficients left.

    coeffs: (16, 2^(L + 1)) Montgomery limbs, the coefficients the first
    layer folds; state, root: (1, 4) int64 digests, the transcript state
    before the first draw and the root it appends.  Nothing is read back."""
    if coeffs.device.type == "cpu" or not SPARSE_P:
        return fri_tail_plain(coeffs, state, root, layers)
    return fri_tail_cuda(coeffs, state, root, layers)


def fri_tail_plain(coeffs, state, root, layers) -> FriTail:
    """K4's plain version of :func:`fri_tail`: a layer at a time."""
    sizes = _sizes(coeffs, layers)
    rows, states, evals, levels = [], [], [], []
    for off, ds in layers:
        state, zeta = draw(state, root)
        coeffs = fd.add(coeffs[:, 0::2], fd.mul(coeffs[:, 1::2], zeta))
        ev = nttc.evaluate_offset_fft(coeffs, 1, ds, off)
        lv = tree_levels(kd.hash_felt_leaves(fd.from_mont(ev)))
        root = lv[-1]
        rows.append(root)
        states.append(state)
        evals.append(ev)
        levels.extend(lv)
    state, zeta = draw(state, root)
    states.append(state)
    last = fd.add(coeffs[:, 0:1], fd.mul(coeffs[:, 1:2], zeta))
    rows.append(value_lanes(fd.from_mont(last)))
    return FriTail(torch.cat(rows), torch.cat(states), torch.cat(evals, dim=1),
                   torch.cat(levels), sizes)


_powers_cache: dict = {}  # (layers, device) -> packed (n, 8) offset powers


def tail_powers(layers, device) -> torch.Tensor:
    """The packed (sum of the coefficients, 8) table of each layer's offset
    powers, layer after layer, which K4 reads: 2^(L - k) of them for layer
    k.  Cached; built from ``nttc.offset_powers``."""
    key = (tuple(layers), torch.device(device))
    if key not in _powers_cache:
        n = len(layers)
        parts = [nttc.offset_powers(off, 1 << (n - k), device)
                 for k, (off, _) in enumerate(layers)]
        _powers_cache[key] = cn.pack_twiddles(torch.cat(parts, dim=1))
    return _powers_cache[key]


def _check(what: str, x, dtype, shape) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"fri_tail: {what} must be a tensor")
    if x.device.type != "cuda":
        raise ValueError(f"fri_tail: the CUDA kernel takes CUDA tensors, got "
                         f"{what} on {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"fri_tail: {what} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"fri_tail: {what} must have shape {shape}, got "
                         f"{tuple(x.shape)}")


def fri_tail_cuda(coeffs, state, root, layers,
                  cluster: int = CLUSTER) -> FriTail:
    """K4: :func:`fri_tail` on CUDA tensors in one launch of one cluster of
    ``cluster`` blocks (1, 2, 4, 8 or 16), on the current stream; the first
    layer has at most 2^MAX_LOG points."""
    if not SPARSE_P:
        raise ValueError("fri_tail: the CUDA kernel bakes the Stark252 prime")
    sizes = _sizes(coeffs, layers)
    n = len(sizes)
    log_ds0 = sizes[0].bit_length() - 1
    if log_ds0 > MAX_LOG:
        raise ValueError(f"fri_tail: a first layer of 2^{log_ds0} points "
                         f"(at most 2^{MAX_LOG})")
    _check("coeffs", coeffs, torch.int32, (N_LIMBS, 2 << n))
    _check("state", state, torch.int64, (1, 4))
    _check("root", root, torch.int64, (1, 4))
    dev = coeffs.device
    if state.device != dev or root.device != dev:
        raise ValueError("fri_tail: coeffs, state and root on different "
                         "devices")
    coeffs, state, root = (coeffs.contiguous(), state.contiguous(),
                           root.contiguous())
    powers = tail_powers(layers, dev)
    twiddles = cn.packed_twiddle_table(log_ds0, False, dev)
    n_evals = sum(sizes)
    evals = torch.empty((N_LIMBS, n_evals), dtype=torch.int32, device=dev)
    levels = torch.empty((2 * n_evals - n, 4), dtype=torch.int64, device=dev)
    rows = torch.empty((n + 1, 4), dtype=torch.int64, device=dev)
    states = torch.empty((n + 1, 4), dtype=torch.int64, device=dev)
    lib = cuda_lib.library()
    with torch.cuda.device(dev):
        code = lib.lcp_fri_tail(
            coeffs.data_ptr(), coeffs.stride(0), state.data_ptr(),
            root.data_ptr(), powers.data_ptr(), twiddles.data_ptr(), n,
            log_ds0, cluster, evals.data_ptr(), levels.data_ptr(),
            rows.data_ptr(),
            states.data_ptr(), torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(code, "fri_tail")
    fri_tail_cuda.launches += 1
    return FriTail(rows, states, evals, levels, sizes)


fri_tail_cuda.launches = 0
