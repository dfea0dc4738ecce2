"""The DiT under FSDP2, and the batch and state across ranks (counterpart
of `f_lite_tpu/parallel/sharding.py`).

- `shard_dit`: `fully_shard` on each block, then on the root, the
  reference's grouping (`distributed.py:83-100`), over the data mesh
  (`("dp", "fsdp")`). There FSDP2 runs HSDP: shards over fsdp, replicas
  over dp (at fsdp 1, replicated parameters and all-reduced gradients). On
  a DiT that `parallel.tensor.parallelize_dit` split over the tp sub-mesh
  first, it is 2-D FSDP2 + TP. The DiT keeps its own casts (fp32 master
  weights, compute in `config.dtype`): no `MixedPrecisionPolicy`, so the
  all-gathers move fp32.
- `rank_rows` / `local_rows`: this rank's rows of a step's batch, the
  counterpart of `put_global_batch` and `batch_sharding`: each node loads
  the batch a JAX host loads, and each of its data replicas (its ranks /
  tp) keeps a contiguous share of it, so replica r holds block r of the
  global batch; the ranks of one tp group take the same rows.
- `full_tensor`, `full_state_dict`: whole tensors (one DTensor gathered
  at a time) in the reference layout, on the CPU of rank 0 for a
  checkpoint or an export; `copy_full_`, `load_full_state_dict`: each rank
  keeps its shard of a whole tensor in the reference layout. The names say
  which tensors `parallelize_dit` holds in another layout
  (`parallel.tensor.head_layout`).

`infer_param_shardings`, `shard_params` and `replicated` have no
counterpart: JAX places a parameter tree by the logical axes its
initializer declares; FSDP2 owns each parameter as a DTensor from
`fully_shard` on, and collectives move it where a forward needs it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from f_lite_tpu_torch.parallel.tensor import memory_layout, reference_layout, tp_size


def shard_dit(model: nn.Module, mesh) -> nn.Module:
    """`fully_shard` the DiT in place: each block (and, with per-block
    AdaLN, the block's head first: the DiT calls it outside the block's
    forward), then the root; each group frees its whole parameters after
    its forward and gathers them again for the backward. `mesh` is
    `create_mesh`'s (its data sub-mesh is used) or a data mesh: a 1-D mesh,
    or dp 1, shards over fsdp; dp > 1 is HSDP. A pipeline stage
    (`parallel.pipeline.DiTStage`) shards the blocks it holds. Returns
    `model`."""
    from torch.distributed.fsdp import fully_shard

    from f_lite_tpu_torch.parallel.pipeline import HeldElsewhere

    if mesh.ndim == 4:
        mesh = mesh["dp", "fsdp"]
    if mesh.ndim == 2 and mesh.size(0) == 1:
        mesh = mesh["fsdp"]
    for block in model.blocks:
        if isinstance(block, HeldElsewhere):
            continue
        head = getattr(block, "adaLN_modulation", None)
        if head is not None:
            fully_shard(head, mesh=mesh)
        fully_shard(block, mesh=mesh)
    fully_shard(model, mesh=mesh)
    return model


def local_rows(x, local_world: int, local_rank: int):
    """Rank `local_rank`'s contiguous 1/`local_world` of `x`'s rows."""
    n = len(x)
    if n % local_world:
        raise ValueError(f"a batch of {n} rows does not divide over "
                         f"{local_world} local ranks")
    k = n // local_world
    return x[local_rank * k:(local_rank + 1) * k]


def rank_rows(node_batch: int, *, world: int = 1, rank: int = 0,
              local_world: int = 1, multiplicity: int = 1, tp: int = 1,
              pp: int = 1, fsdp: int = 1):
    """This rank's share of a step whose node batch has `node_batch` rows,
    each repeated `multiplicity` times (`--batch_multiplicity` tiles the
    node batch), on the (dp, pp, fsdp, tp) mesh (`fsdp` matters only where
    pp > 1): (the node rows it takes, repeats included; its first row of
    the global batch; the global batch's size). The batch splits over the
    data replicas, world / (pp x tp) of them, local_world / (pp x tp) a
    node; replica d x fsdp + f takes block d x fsdp + f, so pp and tp
    peers take the same rows and draw the same values
    (`train.loss.LossDraws.rows` at those bounds)."""
    replicas, local = world // (tp * pp), local_world // (tp * pp)
    coords = rank // tp  # (d, p, f) flattened
    replica = coords // (fsdp * pp) * fsdp + coords % fsdp
    n_node = node_batch * multiplicity
    rows = local_rows(np.arange(n_node), local, replica % local) % node_batch
    return rows, replica * len(rows), len(rows) * replicas


def full_tensor(t: torch.Tensor, name: str = "") -> torch.Tensor:
    """The whole of `t` in the reference layout: a DTensor all-gathered
    (every rank of its mesh must call this) and, where `name` is a fused
    projection's split over tp, its rows put back in the reference order;
    a plain tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    return reference_layout(t.full_tensor(), name, tp_size(t))


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's part of `t` (a DTensor's local shard, which shares its
    storage; a plain tensor itself). Call it under `torch.no_grad()` to
    update the shard in place."""
    return t.to_local() if isinstance(t, DTensor) else t


def full_state_dict(module_or_tensors, stages=None) -> dict:
    """{name: whole tensor on the CPU} on rank 0 and {} on the others,
    gathering one tensor at a time (so at most one whole tensor a rank is
    on the device at once). Takes a module (its `state_dict()`) or a
    {name: tensor} dict; every rank must call it with the same names, or
    with its pipeline stage's under `stages` (`parallel.pipeline.
    StageGroup`: rank 0 gets every stage's)."""
    tensors = (module_or_tensors.state_dict()
               if isinstance(module_or_tensors, nn.Module) else module_or_tensors)
    gather = full_tensor
    if stages is not None:
        tensors, gather = stages.view(tensors), stages.whole
    rank = dist.get_rank() if dist.is_initialized() else 0
    out = {}
    for name, t in tensors.items():
        whole = gather(t.detach(), name)
        if rank == 0:
            out[name] = whole.to("cpu", copy=True)
        del whole
    return out


@torch.no_grad()
def copy_full_(dst: torch.Tensor, whole: torch.Tensor, name: str = "") -> None:
    """Copy a whole tensor in the reference layout into `dst`: into this
    rank's shard where `dst` is a DTensor (cut from `whole` on each rank, no
    collective; a fused projection's rows named by `name` rank-major
    first)."""
    if whole.shape != dst.shape:
        raise ValueError(f"a whole tensor of shape {tuple(whole.shape)} does not "
                         f"fit {tuple(dst.shape)}")
    if isinstance(dst, DTensor):
        whole = memory_layout(whole, name, tp_size(dst))
        whole = distribute_tensor(whole, dst.device_mesh, dst.placements, src_data_rank=None)
    local(dst).copy_(local(whole))


def load_full_state_dict(tensors: dict, whole) -> None:
    """`copy_full_` each of `tensors` ({name: tensor or DTensor}) from
    `whole[name]` ({name: whole tensor}, read one at a time)."""
    for name, t in tensors.items():
        copy_full_(t, whole[name], name)
