"""Multi-device sharding of the prover's bulk math over ``torch.distributed``.

The counterpart of the JAX package's parallel/sharding.py.  One process
runs on each device (SPMD): every rank runs the same host protocol (VM,
trace build, transcript, verifier) and holds its block of every sharded
tensor as a plain local tensor.  The mesh is a one-dimensional
``DeviceMesh`` over the default process group (NCCL on the cards, gloo on
the CPU); the collectives are explicit calls on its group, so each
all-to-all and all-gather of the design is a line of code.

Layout: a domain tensor ``(16, ..., N)`` is block-sharded on its last axis
when D divides N (rank r holds global points [r·N/D, (r+1)·N/D) in natural
order) and replicated otherwise, the rule of the JAX package's
``ShardedNTT.shard``.  A local tensor does not show which of the two it is,
so the functions here take the global length where it matters.

Every rank must call the same collectives in the same order: no function
here branches on the rank around a collective.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ntt import core as nttc


def make_mesh(n_devices: int | None = None, axis: str = "dom",
              device_type: str = "cuda"):
    """A one-axis ``DeviceMesh`` named ``axis`` over all ranks of the default
    process group, which the caller has initialised (``init_process_group``
    with its store or address, world size and rank).  ``n_devices``, where
    given, must be that world size."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialise the default process group "
                           "first (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh: {n_devices} devices asked for, the "
                         f"process group has {world} ranks")
    return init_device_mesh(device_type, (world,), mesh_dim_names=(axis,))


def mesh_axis(mesh) -> str:
    return mesh.mesh_dim_names[0]


def mesh_rank(mesh) -> int:
    """This rank's position along the mesh axis."""
    return mesh.get_local_rank(mesh_axis(mesh))


def is_block(n: int, mesh) -> bool:
    """Whether a tensor of global length n is block-sharded (else replicated)."""
    return n % mesh.size() == 0


def shard_columns(mesh, data: torch.Tensor, axis: str = "dom") -> torch.Tensor:
    """This rank's block of columns of a full (16, cols, n) tensor; D must
    divide cols."""
    d = mesh.size()
    cols = data.shape[1]
    if cols % d:
        raise ValueError(f"shard_columns: {cols} columns over {d} ranks")
    k = cols // d
    r = mesh.get_local_rank(axis)
    return data[:, r * k:(r + 1) * k].contiguous()


def shard_domain(mesh, data: torch.Tensor, axis: str = "dom") -> torch.Tensor:
    """This rank's block of the last axis of a full (16, ..., N) tensor, or
    the whole tensor where D does not divide N (replicated)."""
    n = data.shape[-1]
    d = mesh.size()
    if n % d:
        return data
    k = n // d
    r = mesh.get_local_rank(axis)
    return data[..., r * k:(r + 1) * k].contiguous()


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """(D·k, ...) on every rank: the ranks' (k, ...) tensors in rank order."""
    x = x.contiguous()
    out = torch.empty((mesh.size() * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=mesh.get_group(mesh_axis(mesh)))
    return out


def gather_stack(x: torch.Tensor, mesh) -> torch.Tensor:
    """(D, ...) on every rank: the ranks' tensors of one shape, stacked."""
    return gather_rows(x.unsqueeze(0), mesh)


def gather_domain(x: torch.Tensor, mesh) -> torch.Tensor:
    """The whole (16, ..., N) tensor on every rank from its blocks."""
    g = gather_stack(x, mesh)  # (D, 16, ..., N/D)
    return torch.movedim(g, 0, -2).reshape(tuple(x.shape[:-1]) + (-1,))


def gather_columns(x: torch.Tensor, mesh) -> torch.Tensor:
    """The whole (16, cols, ...) tensor on every rank from its column blocks."""
    return gather_rows(x.transpose(0, 1), mesh).transpose(0, 1).contiguous()


def fetch(x: torch.Tensor, mesh) -> torch.Tensor:
    """Host copy of the whole of a block-sharded tensor, the same on every
    rank (the JAX package's ``fetch_np``): an all-gather over the mesh,
    then one copy to the host, so that the host work stays in lockstep."""
    return gather_domain(x, mesh).cpu()


def full(x: torch.Tensor, n: int, mesh) -> torch.Tensor:
    """The whole of a tensor of global length n, on every rank."""
    return gather_domain(x, mesh) if is_block(n, mesh) else x


def reblock(x: torch.Tensor, n_old: int, n_new: int, mesh) -> torch.Tensor:
    """This rank's part of the global (16, ..., n_new) tensor that keeps the
    first min(n_old, n_new) points of the global (16, ..., n_old) tensor
    whose part ``x`` is, and is zero beyond them: a truncation or a
    zero-pad along the last axis, from one layout to the other.  Where both
    are block-sharded, one ``all_to_all_single`` with split sizes moves
    each point to its new owner (a zero-pad by the LDE blowup sends every
    coefficient to rank 0); where the old tensor is replicated each rank
    cuts its part out, and where the new one is replicated the old one is
    gathered."""
    if n_old == n_new:
        return x
    m = min(n_old, n_new)
    if not is_block(n_old, mesh) or not is_block(n_new, mesh):
        whole = full(x, n_old, mesh)[..., :m]
        pad = torch.zeros(tuple(x.shape[:-1]) + (n_new - m,), dtype=x.dtype,
                          device=x.device)
        return shard_domain(mesh, torch.cat([whole, pad], dim=-1),
                            mesh_axis(mesh))
    d, r = mesh.size(), mesh_rank(mesh)
    a, b = n_old // d, n_new // d

    def overlap(lo0, hi0, lo1, hi1):
        return max(0, min(hi0, hi1) - max(lo0, lo1))

    # points [r·a, r·a + sent) go out, to the owners of their new blocks;
    # points [r·b, r·b + got) come in, from the owners of their old blocks
    send = [overlap(r * a, min((r + 1) * a, m), j * b, (j + 1) * b)
            for j in range(d)]
    recv = [overlap(r * b, min((r + 1) * b, m), s * a, (s + 1) * a)
            for s in range(d)]
    inp = torch.movedim(x[..., :sum(send)], -1, 0).contiguous()
    out = torch.empty((sum(recv),) + tuple(inp.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_to_all_single(out, inp, recv, send,
                           group=mesh.get_group(mesh_axis(mesh)))
    got = torch.movedim(out, 0, -1)
    pad = torch.zeros(tuple(x.shape[:-1]) + (b - got.shape[-1],),
                      dtype=x.dtype, device=x.device)
    return torch.cat([got, pad], dim=-1)


def sharded_lde_pipeline(mesh, blowup: int, domain_size: int, offset: int,
                         axis: str = "dom"):
    """The column-sharded interpolate + LDE: a function of a full
    (16, cols, n) trace (D dividing cols) that returns this rank's column
    block of its (polys, LDE), each column's values as the single-device
    prover computes them.  Columns are independent: no communication."""

    def pipeline(data: torch.Tensor):
        polys = nttc.interpolate_fft(shard_columns(mesh, data, axis))
        return polys, nttc.evaluate_on_lde_domain(polys, blowup, domain_size,
                                                  offset)

    return pipeline
