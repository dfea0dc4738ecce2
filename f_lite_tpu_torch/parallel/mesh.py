"""Process group and device mesh (counterpart of
`f_lite_tpu/parallel/mesh.py`).

JAX runs one process per host, driving all of its chips; PyTorch runs one
process per GPU, started by `torchrun`, which sets `WORLD_SIZE`, `RANK`,
`LOCAL_RANK`, `LOCAL_WORLD_SIZE`, `MASTER_ADDR` and `MASTER_PORT`. A JAX
process is a port node: `num_nodes = WORLD_SIZE // LOCAL_WORLD_SIZE`,
`node_rank = RANK // LOCAL_WORLD_SIZE`. Without those variables the world
is one rank and no process group is formed; under `torchrun` a group is
formed at every world size, one rank included (NCCL on the card, gloo on
the CPU, as the caller's device says).

The mesh is `("dp", "pp", "fsdp", "tp")`, JAX's order: `dp` replicates
(the reference's inter-node `replicate` axis), `pp` splits the blocks
into pipeline stages (`parallel/pipeline.py`), `fsdp` shards the
parameters (its intra-node `shard` axis, `distributed.py:46-100`; both
dp and fsdp above 1 is HSDP), and `tp` splits heads and the MLP width
(Megatron, `parallel/tensor.py`). tp is innermost, so a tp group is
consecutive ranks, inside one node. The data replicas are dp x fsdp: the
ranks of one pp group and of one tp group see the same rows.

`LOGICAL_RULES`, `SP_RULES`, `mesh_rules` and `use_mesh_rules` have no
counterpart: PyTorch places each tensor by the module's plans
(`parallel/tensor.py` `parallelize_dit` on the tp sub-mesh, then
`parallel/sharding.py` `shard_dit` on the data sub-mesh), not by logical
axes read while a program is traced; sequence parallelism is
`parallelize_dit(sequence_parallel=True)`.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

TORCHRUN_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                 "MASTER_ADDR", "MASTER_PORT")


def under_torchrun() -> bool:
    """Whether `torchrun`'s variables are set."""
    return all(v in os.environ for v in TORCHRUN_VARS)


def launch_info() -> tuple[int, int, int, int]:
    """(world, rank, local_world, local_rank) from `torchrun`'s variables;
    (1, 0, 1, 0) without them."""
    if not under_torchrun():
        return 1, 0, 1, 0
    world, rank, local_world, local_rank = (
        int(os.environ[v]) for v in ("WORLD_SIZE", "RANK", "LOCAL_WORLD_SIZE",
                                     "LOCAL_RANK"))
    if local_world < 1 or world % local_world or not 0 <= rank < world \
            or not 0 <= local_rank < local_world:
        raise ValueError(f"inconsistent torchrun variables: WORLD_SIZE={world} "
                         f"RANK={rank} LOCAL_WORLD_SIZE={local_world} "
                         f"LOCAL_RANK={local_rank}")
    return world, rank, local_world, local_rank


def process_replica_info() -> tuple[int, int]:
    """(num_nodes, node_rank): the data loader's replicas, one a node, as
    JAX's `process_replica_info` gives one a host. (1, 0) without
    `torchrun`."""
    world, rank, local_world, _ = launch_info()
    return world // local_world, rank // local_world


def init_distributed(device) -> tuple[int, int, int, int]:
    """Form the process group from `torchrun`'s variables: on `cuda` bind
    this process to GPU `LOCAL_RANK` and use NCCL, on `cpu` use gloo.
    Returns (world, rank, local_world, local_rank). Without `torchrun`'s
    variables it forms no group and returns (1, 0, 1, 0). A group that
    fails to form raises: no rank carries on alone."""
    info = launch_info()
    if not under_torchrun() or dist.is_initialized():
        return info
    world, rank, _, local_rank = info
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(local_rank)
        dist.init_process_group("nccl", world_size=world, rank=rank,
                                device_id=torch.device("cuda", local_rank))
    elif device.type == "cpu":
        dist.init_process_group("gloo", world_size=world, rank=rank)
    else:
        raise ValueError(f"no process group for device {device}")
    return info


def host_group():
    """A group for host-side values (stop flags, counts, barriers): gloo,
    so that agreeing on a Python value never waits for the device. The
    default group where it is gloo already (created once per call: call
    it once and keep it)."""
    if dist.get_backend() == "gloo":
        return dist.group.WORLD
    return dist.new_group(backend="gloo", timeout=datetime.timedelta(minutes=30))


def host_all_reduce(values, op=dist.ReduceOp.SUM, group=None) -> list[float]:
    """`values` (floats) reduced over `group`'s ranks on the host."""
    t = torch.tensor(list(values), dtype=torch.float64)
    dist.all_reduce(t, op=op, group=group)
    return t.tolist()


def _mesh_text(dp, pp, fsdp, tp) -> tuple[str, str]:
    if pp == 1:
        return f"dp={dp} x fsdp={fsdp} x tp={tp} = {dp * fsdp * tp}", "dp x fsdp x tp"
    return (f"dp={dp} x pp={pp} x fsdp={fsdp} x tp={tp} = {dp * pp * fsdp * tp}",
            "dp x pp x fsdp x tp")


def resolve_mesh(dp: int, fsdp: int, world: int, tp: int = 1,
                 pp: int = 1) -> tuple[int, int]:
    """(dp, fsdp) for a world of `world` ranks at `tp` and `pp`: `fsdp` 0
    takes every rank that dp x pp x tp leaves (JAX's `fsdp = args.fsdp or
    n_dev // (dp * tp * pp)`). dp x pp x fsdp x tp must equal the world
    (JAX's rule may leave chips idle; here a rank left out would have
    nothing to do)."""
    if dp < 1 or fsdp < 0 or tp < 1 or pp < 1:
        raise ValueError(f"--dp {dp} --fsdp {fsdp} --tp {tp} --pp {pp}: dp, tp and pp "
                         "must be >= 1, fsdp >= 0")
    others = dp * tp * pp
    if fsdp == 0:
        if world % others:
            what = f"--dp {dp} x --tp {tp}" + (f" x --pp {pp}" if pp > 1 else "")
            raise ValueError(f"{what} does not divide the world of "
                             f"{world} ranks, so --fsdp 0 cannot fill it")
        fsdp = world // others
    if others * fsdp != world:
        text, product = _mesh_text(dp, pp, fsdp, tp)
        raise ValueError(f"mesh {text} != {world} ranks: {product} must equal "
                         f"WORLD_SIZE ({world})")
    return dp, fsdp


def create_mesh(dp: int = 1, fsdp: int = 1, tp: int = 1, pp: int = 1, *,
                device_type: str):
    """The `("dp", "pp", "fsdp", "tp")` device mesh over the process group's
    ranks (dp outermost: across nodes where it spans them; tp innermost,
    inside a node; `fsdp` 0 as in `resolve_mesh`). `mesh["tp"]` is the
    tensor-parallel sub-mesh, `mesh["pp"]` the pipeline's, `mesh["dp",
    "fsdp"]` the data one."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    dp, fsdp = resolve_mesh(dp, fsdp, world, tp, pp)
    return init_device_mesh(device_type, (dp, pp, fsdp, tp),
                            mesh_dim_names=("dp", "pp", "fsdp", "tp"))


def stage_of(mesh) -> tuple[int, int]:
    """(this rank's pipeline stage, the stage count) on `create_mesh`'s
    mesh: its place in its pp group, the ranks that share its dp, fsdp
    and tp coordinates (`mesh["pp"].get_group()`)."""
    return mesh["pp"].get_local_rank(), mesh["pp"].size()


def data_group(mesh):
    """The group of this rank's data replicas (the ranks of its pp and tp
    coordinates across dp x fsdp): the loss and the decile sums add up
    over it. The default group where pp and tp are 1. Every rank must call
    this."""
    pp, tp = mesh["pp"].size(), mesh["tp"].size()
    if pp * tp == 1:
        return None
    ranks = mesh.mesh.permute(1, 3, 0, 2).reshape(pp * tp, -1)
    group, _ = dist.new_subgroups_by_enumeration([r.tolist() for r in ranks])
    return group
