"""The ("data", "model") device mesh on ``torch.distributed``.

Port of ``calodiffusion_tpu/parallel/mesh.py``.  The JAX package runs one
SPMD program over a ``jax.sharding.Mesh`` and lets XLA place the
collectives; PyTorch runs one process a rank, so the port spells them out:

- axis "data": each rank holds a contiguous equal share of every global
  batch's rows (what ``NamedSharding(P("data"))`` gives a device) and the
  gradients are all-reduced by ``DistributedDataParallel``.
- axis "model": the weights are sharded over the axis by FSDP2
  (``fully_shard`` on the 2-D mesh: replicated over "data", sharded over
  "model").  FSDP2 all-gathers each weight before the forward and
  reduce-scatters its gradient after the backward, the arithmetic of XLA's
  placement of the weights' output features (JAX ``shard_params_tp``);
  torch shards dim 0 of every tensor, padded, where JAX shards the last dim
  of the weights it divides.  The ranks of one "model" group take the same
  rows, as the devices of one "model" column do in JAX.

With no process group initialised the mesh is ``None``, the mesh of one
process, and every function here is the identity of one rank.

Under ``torchrun`` one host is one node: the ranks of a node read the same
batches from the loader and split each one, as JAX splits a process's
batch over its devices (``process_index`` is the node's index, the
counterpart of ``jax.process_index()``).  The random draws of a step are
the global batch's, sliced (``row_draws``), so N ranks train and sample as
one process does.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from calodiffusion_tpu_torch.samplers.base import row_shard


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> tuple[int, int]:
    """(rank, world size) of the process group, else (0, 1)."""
    if initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_index() -> tuple[int, int]:
    """(node index, node count): the counterpart of ``jax.process_index()``
    and ``jax.process_count()``.  A node is ``LOCAL_WORLD_SIZE`` consecutive
    ranks (torchrun sets it; one node where it is unset)."""
    rank, size = world()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", size) or size)
    return rank // local, max(size // local, 1)


def is_writer() -> bool:
    """Whether this rank writes the run's files (rank 0)."""
    return world()[0] == 0


def barrier() -> None:
    if initialized():
        dist.barrier()


def make_mesh(data: Optional[int] = None, model: int = 1, device_type: str = "cuda"):
    """A ``DeviceMesh`` of shape (data, model) over every rank, dims named
    ("data", "model"); ``None`` without a process group (one rank).  Raises
    where data x model is not the world size."""
    _, n = world()
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    if not initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))


def axis(mesh, name: str) -> tuple[int, int]:
    """(this rank's index, size) on the mesh axis ``name``; (0, 1) without a mesh."""
    if mesh is None:
        return 0, 1
    return mesh.get_local_rank(name), mesh[name].size()


def data_group(mesh):
    """The process group of this rank's "data" axis; None where it has one rank."""
    if axis(mesh, "data")[1] == 1:
        return None
    return mesh.get_group("data")


def node_share(mesh) -> tuple[int, int]:
    """(index, count) of this rank among the data ranks of its node, which
    split the node's batches."""
    r, n = axis(mesh, "data")
    per_node = max(n // process_index()[1], 1)
    return r % per_node, per_node


def pad_batch_to_multiple(arrays: tuple, multiple: int):
    """Pad the batch dim so it divides ``multiple`` by repeating the last
    row; returns (arrays, n_real).  ``None`` entries pass through."""
    n = arrays[0].shape[0]
    rem = n % multiple
    if rem == 0:
        return arrays, n
    pad = multiple - rem
    padded = tuple(
        np.concatenate([a, np.repeat(a[-1:], pad, axis=0)], axis=0) if a is not None else None
        for a in arrays
    )
    return padded, n


def shard_batch(mesh, x, chunks: int = 1):
    """This rank's rows of the node's batch ``x`` (numpy or tensor, rows a
    multiple of the node's data ranks): a contiguous share of each of its
    ``chunks`` equal chunks (the microbatches), concatenated.  With one
    chunk that is the rank's contiguous rows; ``None`` passes through."""
    r, n = node_share(mesh)
    if x is None or n == 1:
        return x
    rows = x.shape[0]
    if rows % (n * chunks):
        raise ValueError(f"{rows} rows do not split into {chunks} chunks over {n} ranks")
    s = rows // chunks // n
    parts = [x[i * s * n + r * s: i * s * n + (r + 1) * s] for i in range(chunks)]
    if len(parts) == 1:
        return parts[0]
    return torch.cat(parts) if isinstance(x, torch.Tensor) else np.concatenate(parts)


def row_range(mesh, rows: int) -> tuple[int, int]:
    """[lo, hi) of this rank's rows in a batch of ``rows`` rows that the
    data axis splits (``rows`` a multiple of its size)."""
    r, n = axis(mesh, "data")
    if rows % n:
        raise ValueError(f"{rows} rows do not split over {n} data ranks")
    s = rows // n
    return r * s, (r + 1) * s


def row_draws(mesh, local_rows: int, rows: Optional[int] = None):
    """Context in which the random draws of a batch of ``local_rows`` rows
    (this rank's share of the data axis's global batch) are the global
    batch's draws, sliced to this rank's rows (``samplers.base.row_shard``);
    a null context on one data rank.  ``rows``: the global batch's real
    rows where it was padded (a masked val batch): one process draws for
    those alone, and the repeats take the last real row's draw."""
    r, n = axis(mesh, "data")
    if n == 1:
        return contextlib.nullcontext()
    return row_shard(r * local_rows, (r + 1) * local_rows,
                     n * local_rows if rows is None else rows)


def replicate(mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast the module's parameters and buffers from rank 0, in place."""
    if mesh is None or not initialized():
        return module
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module


def shard_params_tp(mesh, module: torch.nn.Module) -> torch.nn.Module:
    """The "model" axis: FSDP2 ``fully_shard`` on the 2-D mesh (replicated
    over "data", each tensor's dim 0 sharded over "model"), in place;
    ``replicate`` where the axis has one rank."""
    if axis(mesh, "model")[1] == 1:
        return replicate(mesh, module)
    from torch.distributed.fsdp import fully_shard

    fully_shard(module, mesh=mesh)
    return module


def wrap(mesh, module: torch.nn.Module) -> torch.nn.Module:
    """The module a train step calls: ``DistributedDataParallel`` over
    "data" where the mesh has no "model" axis (it broadcasts rank 0's
    weights; on one rank its all-reduce leaves the gradients as they are),
    the module sharded in place by ``shard_params_tp`` where it has one,
    the module itself without a mesh."""
    if mesh is None:
        return module
    if axis(mesh, "model")[1] > 1:
        return shard_params_tp(mesh, module)
    from torch.nn.parallel import DistributedDataParallel

    dev = next(module.parameters()).device
    return DistributedDataParallel(
        module, device_ids=[dev] if dev.type == "cuda" else None,
        process_group=data_group(mesh), broadcast_buffers=False)


def no_sync(module):
    """``module.no_sync()`` for a DDP module (no gradient all-reduce in the
    backward passes inside), else a null context."""
    sync = getattr(module, "no_sync", None)
    return sync() if sync is not None else contextlib.nullcontext()


def all_reduce_mean(mesh, t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the data axis (``t`` itself on one rank)."""
    group = data_group(mesh)
    if group is None:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=group)
    return t / dist.get_world_size(group)


def agree_min(mesh, n: int) -> int:
    """The least ``n`` over every rank (an epoch's batch count, which ranks
    of different nodes may read differently); ``n`` on one rank."""
    if mesh is None or mesh.size() == 1:
        return n
    t = torch.tensor([n], dtype=torch.int64, device=mesh.device_type)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t.item())


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _whole(t) -> torch.Tensor:
    """A DTensor gathered whole.  FSDP2's placement (dim 0 in torch.chunk's
    chunks over one mesh dim, replicated over the others) goes through one
    ``all_gather_into_tensor`` of the chunks padded to the largest: gloo
    carries that on CUDA tensors, where its DTensor ``full_tensor`` path
    (functional collectives) ends the process."""
    shards = [i for i, p in enumerate(t.placements) if p.is_shard()]
    if len(shards) != 1 or t.placements[shards[0]].dim != 0 or t.ndim == 0:
        return t.full_tensor()
    group = t.device_mesh.get_group(shards[0])
    n = dist.get_world_size(group)
    rows = -(-t.shape[0] // n)
    local = t.to_local()
    padded = local.new_zeros((rows, *t.shape[1:]))
    padded[:local.shape[0]] = local
    out = local.new_empty((rows * n, *t.shape[1:]))
    dist.all_gather_into_tensor(out, padded, group=group)
    return out[:t.shape[0]]


def full_state(tree: Any) -> Any:
    """``tree`` (nested dicts and lists of tensors, as a state_dict or an
    optimizer's) with each DTensor gathered whole, a collective every rank
    joins; identity without DTensors."""
    if isinstance(tree, dict):
        return {k: full_state(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(full_state(v) for v in tree)
    if isinstance(tree, torch.Tensor) and _is_dtensor(tree):
        return _whole(tree)
    return tree


def shard_like(state: dict, live: dict) -> dict:
    """Each whole tensor of ``state`` placed as its counterpart in ``live``
    (a state_dict whose tensors may be FSDP2's DTensors) is placed."""
    from torch.distributed.tensor import distribute_tensor

    out = {}
    for k, v in state.items():
        ref = live.get(k)
        if ref is not None and _is_dtensor(ref) and not _is_dtensor(v):
            v = distribute_tensor(v.to(ref.device_mesh.device_type), ref.device_mesh,
                                  ref.placements)
        out[k] = v
    return out


def shard_optimizer_state(opt: torch.optim.Optimizer) -> None:
    """After ``opt.load_state_dict`` of whole tensors: place each state
    tensor as its parameter (an FSDP2 DTensor) is placed."""
    from torch.distributed.tensor import distribute_tensor

    for p, st in opt.state.items():
        if not _is_dtensor(p):
            continue
        for k, v in st.items():
            if isinstance(v, torch.Tensor) and not _is_dtensor(v) and v.shape == p.shape:
                st[k] = distribute_tensor(v.to(p.device), p.device_mesh, p.placements)
