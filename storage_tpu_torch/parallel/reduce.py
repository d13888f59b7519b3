"""Cross-rank reductions of the path-parallel engine: the JAX package's
``_psum``, ``_pmean`` and ``_global_mean_over_sims``
(storage_tpu/engines/lsmc.py:105-122) over a ``torch.distributed`` process
group instead of a mesh axis.

A group holds one rank per card, each rank an equal block of the paths, so a
global count is the local one times the group's size.  ``None``, or a group
of one rank, makes every function here the identity (``active``): a run with
no group keeps its bits and makes no collective call.

A collective is queued behind the kernels already launched on the caller's
current stream: NCCL's stream waits for it, and the current stream then
waits for NCCL (gloo, on CUDA tensors, copies through the host after the
same wait).  So a sum of a kernel's outputs needs no synchronisation here.
"""
from __future__ import annotations

import typing as tp

import torch
import torch.distributed as dist


def active(group):
    """``group`` where it spans more than one rank, else None."""
    if group is None or dist.get_world_size(group) == 1:
        return None
    return group


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def comm_device(group) -> torch.device:
    """Where a group's host values (flags, shapes) are reduced: the current
    card under NCCL, which takes no CPU tensor, the host otherwise."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def psum_many(tensors: tp.Sequence[torch.Tensor], group) -> tp.List[torch.Tensor]:
    """Every rank's sum of each tensor, by one all-reduce of one buffer (the
    tensors share a dtype and a device); the inputs as they are without an
    active group."""
    group = active(group)
    if group is None:
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def psum(x: torch.Tensor, group) -> torch.Tensor:
    return psum_many([x], group)[0]


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean over the ranks: the sum over the group's size."""
    if active(group) is None:
        return x
    return psum(x, group) / size(group)


def global_mean_over_sims(x: torch.Tensor, group) -> torch.Tensor:
    """Mean over the sims axis (the last), reduced across the group: every
    rank's sum over its count times the group's size (equal blocks)."""
    if active(group) is None:
        return x.mean() if x.dim() == 1 else x.mean(dim=-1)
    return psum(x.sum(dim=-1), group) / (x.shape[-1] * size(group))


def any_rank(flag: bool, group) -> bool:
    """Whether ``flag`` holds on any rank (an all-reduce MAX), so that every
    rank takes the same branch; ``flag`` itself without an active group."""
    group = active(group)
    if group is None:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=comm_device(group))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


def gather_ints(values: tp.Sequence[int], group) -> torch.Tensor:
    """Every rank's ``values`` as a [ranks, k] int64 host tensor (one
    all-gather; through the host under gloo)."""
    if active(group) is None:
        return torch.tensor([list(values)], dtype=torch.int64)
    t = torch.tensor(list(values), dtype=torch.int64, device=comm_device(group))
    out = [torch.empty_like(t) for _ in range(size(group))]
    dist.all_gather(out, t, group=group)
    return torch.stack(out).cpu()
