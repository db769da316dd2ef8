"""Explicit collectives over the mesh's groups, with their gradients.

The JAX package states shardings and lets XLA insert the collectives; each
collective here is a call, made by the module that needs it, and counted:
`COLLECTIVES` holds the calls by kind and `COLLECTIVE_BYTES` the bytes this
rank sent in them, beside ops.attention.LAUNCHES.  A collective over an axis
of size 1 is the identity and issues (and counts) nothing.

The autograd operators are Megatron's (the reference's sat/mpu/mappings.py):

  * `copy_to`     identity forward, all-reduce backward ('f'): the
                  replicated input of a column-parallel block, whose ranks
                  each return a partial gradient;
  * `reduce_from` all-reduce forward, identity backward ('g'): the partial
                  outputs of a row-parallel block, used replicated after it;
  * `all_reduce`  all-reduce both ways: a sum whose result every rank uses
                  in its own way (the squares of a model-sharded RMS norm);
  * `gather`      all-gather forward; backward the rank's slice when what
                  follows is replicated (`replicated=True`), else a
                  reduce-scatter (each rank used the whole in its own way);
  * `split`       the rank's slice forward, all-gather backward;
  * `all_to_all`  the Ulysses exchange; its backward is the inverse exchange.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# calls by kind, and the bytes this rank sent in them (plain ints; reset with
# reset_collective_counts)
COLLECTIVES = {"all_to_all": 0, "all_reduce": 0, "all_gather": 0, "reduce_scatter": 0,
               "p2p": 0, "broadcast": 0}
COLLECTIVE_BYTES = dict.fromkeys(COLLECTIVES, 0)


def reset_collective_counts() -> None:
    for name in COLLECTIVES:
        COLLECTIVES[name] = 0
        COLLECTIVE_BYTES[name] = 0


def _count(kind: str, nbytes: int) -> None:
    COLLECTIVES[kind] += 1
    COLLECTIVE_BYTES[kind] += int(nbytes)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


# --------------------------------------------------------------------------
# Raw collectives (no gradient)
# --------------------------------------------------------------------------
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def all_reduce_(x, mesh, axis, op: str = "sum"):
    """In-place all-reduce of x over `axis` (op 'sum' | 'max' | 'min')."""
    if mesh.size(axis) == 1:
        return x
    p = mesh.size(axis)
    dist.all_reduce(x, op=_OPS[op], group=mesh.group(axis))
    # a ring all-reduce sends 2 (p - 1) / p of the tensor
    _count("all_reduce", 2 * (p - 1) * _nbytes(x) // p)
    return x


def broadcast_(x, mesh, axis, src: int = 0):
    """In-place broadcast of x over `axis` from the group's rank `src`; the
    call counts on every rank, the bytes on the source (p - 1 copies)."""
    p = mesh.size(axis)
    if p == 1:
        return x
    group = mesh.group(axis)
    dist.broadcast(x, src=dist.get_global_rank(group, src), group=group)
    _count("broadcast", (p - 1) * _nbytes(x) if dist.get_group_rank(group, dist.get_rank())
           == src else 0)
    return x


def all_gather(x, mesh, axis, dim: int):
    """The ranks' x concatenated along `dim` in rank order."""
    p = mesh.size(axis)
    if p == 1:
        return x
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((p * xt.shape[0],) + tuple(xt.shape[1:]))
    dist.all_gather_into_tensor(out, xt, group=mesh.group(axis))
    _count("all_gather", (p - 1) * _nbytes(xt))
    return out.movedim(0, dim)


def reduce_scatter(x, mesh, axis, dim: int):
    """The sum of the ranks' x, this rank's slice of `dim`."""
    p = mesh.size(axis)
    if p == 1:
        return x
    xt = x.movedim(dim, 0).contiguous()
    if xt.shape[0] % p:
        raise ValueError(f"reduce_scatter over {axis!r}: dim {dim} of {tuple(x.shape)} does "
                         f"not divide by {p}")
    out = xt.new_empty((xt.shape[0] // p,) + tuple(xt.shape[1:]))
    dist.reduce_scatter_tensor(out, xt, group=mesh.group(axis))
    _count("reduce_scatter", (p - 1) * _nbytes(out))
    return out.movedim(0, dim)


def local_slice(x, mesh, axis, dim: int):
    """This rank's contiguous 1/p of `dim`."""
    p = mesh.size(axis)
    if p == 1:
        return x
    if x.shape[dim] % p:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide over {p} {axis!r} "
                         "ranks")
    n = x.shape[dim] // p
    return x.narrow(dim, mesh.rank(axis) * n, n)


def all_to_all_raw(x, mesh, axis, scatter_dim: int, gather_dim: int):
    """Split `scatter_dim` into p chunks, chunk j to rank j; concatenate the
    chunks received along `gather_dim` in rank order."""
    p = mesh.size(axis)
    if p == 1:
        return x
    if x.shape[scatter_dim] % p:
        raise ValueError(f"all_to_all over {axis!r}: dim {scatter_dim} of {tuple(x.shape)} "
                         f"does not divide by {p}")
    # (p, ...x with scatter_dim cut to 1/p): chunk j is the j-th contiguous block
    xs = x.unflatten(scatter_dim, (p, x.shape[scatter_dim] // p)).movedim(scatter_dim, 0)
    xs = xs.contiguous()
    out = torch.empty_like(xs)
    dist.all_to_all_single(out, xs, group=mesh.group(axis))
    _count("all_to_all", (p - 1) * _nbytes(xs) // p)
    # out[i] came from rank i: put the rank index in front of gather_dim, merge
    return out.movedim(0, gather_dim).flatten(gather_dim, gather_dim + 1)


def exchange(sends, recvs, mesh, axis):
    """One batch of point-to-point transfers in `axis`'s group: sends and
    recvs are lists of (tensor, peer coordinate on the axis).  Returns the
    requests; wait on each before reading a received tensor."""
    if not sends and not recvs:
        return []
    group = mesh.group(axis)
    ops = [dist.P2POp(dist.isend, t.contiguous(), dist.get_global_rank(group, peer), group)
           for t, peer in sends]
    ops += [dist.P2POp(dist.irecv, t, dist.get_global_rank(group, peer), group)
            for t, peer in recvs]
    _count("p2p", sum(_nbytes(t) for t, _ in sends))
    return dist.batch_isend_irecv(ops)


# --------------------------------------------------------------------------
# Autograd operators
# --------------------------------------------------------------------------
class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.mesh, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce_(x.contiguous().clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_reduce_(x.contiguous().clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.mesh, ctx.axis), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, replicated):
        ctx.mesh, ctx.axis, ctx.dim, ctx.replicated = mesh, axis, dim, replicated
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.replicated:
            gx = local_slice(g, ctx.mesh, ctx.axis, ctx.dim)
        else:
            gx = reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim)
        return gx, None, None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return local_slice(x, mesh, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, scatter_dim, gather_dim):
        ctx.mesh, ctx.axis, ctx.dims = mesh, axis, (scatter_dim, gather_dim)
        return all_to_all_raw(x, mesh, axis, scatter_dim, gather_dim)

    @staticmethod
    def backward(ctx, g):
        scatter_dim, gather_dim = ctx.dims
        return (all_to_all_raw(g, ctx.mesh, ctx.axis, gather_dim, scatter_dim),
                None, None, None, None)


def _trivial(mesh, axis) -> bool:
    return mesh is None or mesh.size(axis) == 1


def copy_to(x, mesh, axis):
    return x if _trivial(mesh, axis) else _CopyTo.apply(x, mesh, axis)


def reduce_from(x, mesh, axis):
    return x if _trivial(mesh, axis) else _ReduceFrom.apply(x, mesh, axis)


def all_reduce(x, mesh, axis):
    return x if _trivial(mesh, axis) else _AllReduce.apply(x, mesh, axis)


def gather(x, mesh, axis, dim: int, *, replicated: bool):
    return x if _trivial(mesh, axis) else _Gather.apply(x, mesh, axis, dim, replicated)


def split(x, mesh, axis, dim: int):
    return x if _trivial(mesh, axis) else _Split.apply(x, mesh, axis, dim)


def all_to_all(x, mesh, axis, scatter_dim: int, gather_dim: int):
    if _trivial(mesh, axis):
        return x
    return _AllToAll.apply(x, mesh, axis, scatter_dim, gather_dim)
