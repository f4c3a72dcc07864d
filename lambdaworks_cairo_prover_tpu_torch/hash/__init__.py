from . import keccak_device, keccak_host, merkle
from .keccak_host import keccak256
from .merkle import MerkleTree, verify_proof
