"""Collectives over a ``torch.distributed`` process group.

The JAX package drives every device from one controller and shards
arrays over a mesh axis; here each device has a process of its own and
an explicit process group takes the place of the ``Mesh``:

* ``jax.lax.psum`` over the axis is ``all_reduce`` (a sum, in place);
* an output sharded ``P(axis)`` comes back whole through ``all_gather``;
* ``shard_map``'s ``P(axis)`` split of an input is ``block``: each rank
  takes its own contiguous block, rank after rank.

A group of one process, or none, is no group: ``active`` returns None
for it, and every caller then takes its one-process path, as the JAX code
does on one device.

``pack`` / ``unpack`` flatten a tree of tensors (tuples, lists,
NamedTuples such as ``BAProblem``) into one byte buffer and a picklable
spec, so that a problem crosses the group in one transfer. The buffer
lies where the group's backend moves it (``wire``): on this process's
card under NCCL, one card a process; on the host under gloo, which runs
several processes on one card (NCCL refuses two ranks on one device) and
on the CPU, and reduces CUDA tensors but broadcasts and gathers only host
tensors.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def world_size(group) -> int:
    """The group's size; 1 for no group or no initialised process group."""
    if group is None or not dist.is_available() or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def active(group):
    """group if it spans more than one process, else None."""
    return group if world_size(group) > 1 else None


def rank(group) -> int:
    """This process's rank in the group (0 without one)."""
    return dist.get_rank(group) if active(group) is not None else 0


def root(group) -> int:
    """The global rank of the group's rank 0: the source of broadcasts."""
    return dist.get_global_rank(group, 0)


def block(n: int, group) -> slice:
    """This rank's contiguous block of n rows (n a multiple of the world
    size, as ``shard_map`` requires of a sharded axis)."""
    w = world_size(active(group))
    if n % w:
        raise ValueError(f"{n} rows do not split over {w} processes: pad "
                         f"them to a multiple of the world size")
    r = rank(group)
    return slice(r * (n // w), (r + 1) * (n // w))


def wire(group) -> torch.device:
    """The device of the group's byte buffers: this process's card under
    NCCL, the host under any other backend."""
    if dist.get_backend(group) == dist.Backend.NCCL:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum t over the group, in place; returns t."""
    dist.all_reduce(t, group=group)
    return t


def pack(tree, device="cpu"):
    """(spec, bytes [n] uint8 on device) of a tree of tensors; leaves
    that are not tensors ride in the spec."""
    leaves = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x.detach().reshape(-1).contiguous().to(device)
                          .view(torch.uint8))
            return ("T", tuple(x.shape), x.dtype)
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return ("N", type(x), [walk(v) for v in x])
        if isinstance(x, (tuple, list)):
            return ("L", [walk(v) for v in x])
        return ("V", x)

    spec = walk(tree)
    data = (torch.cat(leaves) if leaves
            else torch.zeros(0, dtype=torch.uint8, device=device))
    return spec, data


def nbytes(spec) -> int:
    """The length of the byte buffer that ``pack`` makes for spec."""
    kind = spec[0]
    if kind == "T":
        n = 1
        for d in spec[1]:
            n *= d
        return n * torch.empty((), dtype=spec[2]).element_size()
    if kind in ("N", "L"):
        return sum(nbytes(s) for s in spec[-1])
    return 0


def unpack(spec, data: torch.Tensor, device):
    """The tree that ``pack`` flattened, its tensors on device."""
    data = data.to(device)
    pos = [0]

    def build(s):
        kind = s[0]
        if kind == "T":
            n = nbytes(s)
            # a copy of its own, aligned for the wider type
            t = data[pos[0]:pos[0] + n].clone().view(s[2]).reshape(s[1])
            pos[0] += n
            return t
        if kind == "N":
            return s[1](*[build(c) for c in s[2]])
        if kind == "L":
            return tuple(build(c) for c in s[1])
        return s[1]

    return build(spec)


def all_gather_tree(tree, group, device):
    """Every rank's tree (the same spec on each), each tensor concatenated
    along dim 0 in rank order: an output sharded ``P(axis)`` made whole.
    One collective of the packed bytes (``wire``)."""
    spec, data = pack(tree, wire(group))
    w = world_size(group)
    parts = [torch.empty_like(data) for _ in range(w)]
    dist.all_gather(parts, data, group=group)
    trees = [unpack(spec, p, device) for p in parts]
    return _cat_trees(trees)


def _cat_trees(trees):
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(trees)
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*[_cat_trees(list(c)) for c in zip(*trees)])
    if isinstance(first, (tuple, list)):
        return tuple(_cat_trees(list(c)) for c in zip(*trees))
    return first


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's t concatenated along dim 0 in rank order."""
    return all_gather_tree(t, group, t.device)
