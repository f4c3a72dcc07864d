"""Merkle trees over batched Keccak-256 (lambdaworks-crypto `MerkleTree`).

Backends as in the reference (config.rs:10-20):
  * ``build_single``  — `Keccak256Tree`: leaf = Keccak256(felt BE bytes)
  * ``build_batch``   — `BatchKeccak256Tree`: leaf = Keccak256(row of felts, BE)
Inner node = Keccak256(left_digest || right_digest).  Proof verification uses
the index-parity rule (even index -> value on the left), matching
lambdaworks `Proof::verify`.

Levels stay on the tensor's device; ``root`` copies 32 bytes to the host and
``get_proofs`` gathers every queried sibling of every level in one copy.
"""

from __future__ import annotations

import torch

from . import keccak_device as kd
from .keccak_host import keccak256, merkle_fold


def tree_levels(leaves: torch.Tensor) -> list:
    """[leaves (n, 4), level 1, ..., root (1, 4)]: the levels above the
    leaves are views into the one (n - 1, 4) tensor of ``hash_tree``."""
    buf = kd.hash_tree(leaves)
    levels, off = [leaves], 0
    for size in kd.tree_level_sizes(leaves.shape[0]):
        levels.append(buf[off:off + size])
        off += size
    return levels


class MerkleTree:
    def __init__(self, levels):
        # levels[0] = leaf digests (n, 4) ... levels[-1] = root (1, 4)
        self.levels = list(levels)
        self._root_bytes = None

    @classmethod
    def build_batch(cls, limbs: torch.Tensor, n_cols: int) -> "MerkleTree":
        """limbs: (16, n_rows, n_cols) row-leaf tree (non-Montgomery)."""
        return cls(tree_levels(kd.hash_felt_rows(limbs, n_cols)))

    @classmethod
    def build_single(cls, limbs: torch.Tensor) -> "MerkleTree":
        """limbs: (16, n) single-felt-leaf tree (non-Montgomery)."""
        return cls(tree_levels(kd.hash_felt_leaves(limbs)))

    @property
    def root(self) -> bytes:
        if self._root_bytes is None:
            self._root_bytes = kd.digest_to_bytes(self.levels[-1][0])
        return self._root_bytes

    def sibling_indices(self, indices: list[int]) -> list[list[int]]:
        """Per level below the root, the sibling index of each query."""
        out = []
        idxs = list(indices)
        for _ in self.levels[:-1]:
            out.append([i ^ 1 for i in idxs])
            idxs = [i >> 1 for i in idxs]
        return out

    def gather_siblings(self, indices: list[int]) -> torch.Tensor:
        """(levels * q, 4) sibling digests, level-major, on the tree's device."""
        parts = [
            lv.index_select(0, torch.tensor(ix, dtype=torch.int64,
                                            device=lv.device))
            for lv, ix in zip(self.levels[:-1], self.sibling_indices(indices))
        ]
        if not parts:
            return torch.zeros((0, 4), dtype=torch.int64,
                               device=self.levels[0].device)
        return torch.cat(parts, dim=0)

    def get_proof(self, index: int) -> list[bytes]:
        return self.get_proofs([index])[0]

    def get_proofs(self, indices: list[int]) -> list[list[bytes]]:
        """Authentication paths (sibling digests leaf->root) for each index."""
        q = len(indices)
        if q == 0:
            return []
        sibs = self.gather_siblings(indices).cpu().numpy()
        n_levels = len(self.levels) - 1
        return [[kd.digest_to_bytes(sibs[li * q + qi]) for li in range(n_levels)]
                for qi in range(q)]


def verify_proof(root: bytes, index: int, leaf_hash: bytes, path: list[bytes]) -> bool:
    """Host-side path verification (lambdaworks `Proof::verify` semantics)."""
    return merkle_fold(leaf_hash, path, index) == root


def hash_leaf_felts_host(felt_ints: list[int]) -> bytes:
    """Host leaf hash of a row of felts (BE bytes concatenated)."""
    return keccak256(b"".join(v.to_bytes(32, "big") for v in felt_ints))


def fetch_tree(levels) -> MerkleTree:
    """A MerkleTree over level tensors left where they are: nothing is
    copied until ``root`` or ``get_proofs`` is read."""
    return MerkleTree(levels)
