"""Collectives over one axis of a ``Mesh``: JAX's ``pmin``, ``pmax``,
``psum``, ``ppermute`` (the halo ring) and ``all_gather``.

Each takes the tensor of this rank and returns the merged tensor on every
rank of the axis; over an axis of size 1 it returns its input. ``pmin``,
``pmax`` and integer ``psum`` are one ``all_reduce`` on the axis's group
(exact in any order). A floating ``psum`` gathers the parts and adds them in
axis order: every rank then holds the same bits on any
backend, which keeps replicated parameters equal, and the shards' f32 sums
add in rank order as the JAX package's do.

Backends: NCCL takes CUDA tensors everywhere. gloo takes CUDA tensors for
``all_reduce``, ``broadcast`` and ``all_gather`` (it copies through the host
itself) but reads a send or receive buffer as host memory, so
``ppermute_ring`` stages its buffers through ``.cpu()`` under gloo: that is
the backend's requirement, not a fallback, and NCCL never takes it.

``psum_autograd`` is ``psum`` with a backward that ``psum``s the gradient,
for BatchNorm statistics over a batch-sharded batch (``ops/bn_train.py``).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from rtnr_tpu_torch.parallel.mesh import Mesh


def _reduce(x: torch.Tensor, mesh: Mesh, axis: Optional[str], op) -> torch.Tensor:
    if mesh.size(axis) == 1:
        return x
    y = x.contiguous().clone()
    dist.all_reduce(y, op=op, group=mesh.group(axis))
    return y


def pmin(x: torch.Tensor, mesh: Mesh, axis: Optional[str]) -> torch.Tensor:
    """Elementwise minimum over ``axis`` (one ``all_reduce``)."""
    return _reduce(x, mesh, axis, dist.ReduceOp.MIN)


def pmax(x: torch.Tensor, mesh: Mesh, axis: Optional[str]) -> torch.Tensor:
    """Elementwise maximum over ``axis`` (one ``all_reduce``)."""
    return _reduce(x, mesh, axis, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, mesh: Mesh, axis: Optional[str]) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` along ``axis``, in axis order."""
    if mesh.size(axis) == 1:
        return x[None]
    if x.dtype == torch.bool:  # gathered as bytes: gloo has no bool type
        return all_gather(x.to(torch.uint8), mesh, axis).to(torch.bool)
    x = x.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(x) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, x, group=mesh.group(axis))
    return torch.stack(parts)


def psum(x: torch.Tensor, mesh: Mesh, axis: Optional[str]) -> torch.Tensor:
    """Sum over ``axis``: one ``all_reduce`` for integers; for floats the
    parts added in axis order on every rank (module doc)."""
    if mesh.size(axis) == 1:
        return x
    if not x.is_floating_point():
        return _reduce(x, mesh, axis, dist.ReduceOp.SUM)
    parts = all_gather(x, mesh, axis)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


class _PsumAutograd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return psum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return psum(g.contiguous(), ctx.mesh, ctx.axis), None, None


def psum_autograd(x: torch.Tensor, mesh: Mesh, axis: Optional[str]) -> torch.Tensor:
    """``psum`` whose gradient is the ``psum`` of the output's gradient: the
    loss is the sum of every rank's loss, and each rank's part of the sum
    feeds every rank's output."""
    if mesh.size(axis) == 1:
        return x
    return _PsumAutograd.apply(x, mesh, axis)


def ppermute_ring(x: torch.Tensor, mesh: Mesh, axis: str, shift: int) -> torch.Tensor:
    """The ring exchange of ``jax.lax.ppermute`` with the permutation
    ``[((i - shift) % n, i)]``: rank i sends ``x`` to i + shift and returns
    what i - shift sent (its own ``x`` on an axis of size 1). gloo stages
    the buffers on the host (module doc)."""
    n = mesh.size(axis)
    if n == 1 or shift % n == 0:
        return x
    ranks = mesh.group_ranks(axis)
    i = mesh.axis_index(axis)
    dst, src = ranks[(i + shift) % n], ranks[(i - shift) % n]
    host = mesh.backend() == "gloo" and x.device.type != "cpu"
    send = (x.cpu() if host else x).contiguous()
    recv = torch.empty_like(send)
    group = mesh.group(axis)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, dst, group),
                                   dist.P2POp(dist.irecv, recv, src, group)])
    for r in reqs:
        r.wait()
    return recv.to(x.device) if host else recv


def shard_rows(array, mesh: Mesh, axis: Optional[str]):
    """This rank's contiguous block of ``array``'s first dimension on
    ``axis`` (the split of JAX's ``P(axis)``, in mesh order); the whole
    array for no axis or an axis of size 1. Works on numpy arrays and
    tensors, so each rank uploads only its part."""
    n = mesh.size(axis)
    if n == 1:
        return array
    rows = array.shape[0]
    if rows % n:
        raise ValueError(f"{rows} rows do not split into {n} blocks over {axis!r}")
    b = rows // n
    i = mesh.axis_index(axis)
    return array[i * b:(i + 1) * b]


def gather_frames(x: torch.Tensor, mesh: Mesh, batch_axis: Optional[str] = "batch"):
    """The full (F, ...) frames from every rank's (F_local, ...) frames
    along ``batch_axis``, in frame order, on every rank."""
    if mesh.size(batch_axis) == 1:
        return x
    g = all_gather(x, mesh, batch_axis)
    return g.reshape((-1,) + tuple(x.shape[1:]))
