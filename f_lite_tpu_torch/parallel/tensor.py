"""Tensor and sequence parallelism of the DiT (counterpart of the `tp` axis
of `f_lite_tpu/parallel/mesh.py` `LOGICAL_RULES` / `SP_RULES` and of
`_constrain` / `HeadProj` in `f_lite_tpu/models/dit.py`).

`parallelize_dit(model, tp_mesh, sequence_parallel=...)` splits the DiT
over the ranks of a 1-D `tp` mesh, Megatron style:
- column-parallel (output rows split): `qkv`, `q`, `context_kv`,
  `gate_proj`, `up_proj`; their biases, int8 weights and scales with them;
- row-parallel (input columns split): `proj`, `down_proj`; an int8 layer's
  scales and a bias stay whole;
- replicated: the norms, AdaLN heads, embedders, `context_proj`, the final
  layer and `lambda_v`.
LoRA factors split with their weight: a column layer's `lora_b` by its
output columns, a row layer's `lora_a` by its input rows.

What DTensor does and what the port does:
- DTensor holds every parameter and buffer (`parallelize_module` with the
  port's `_Placed` styles: `Shard(0)` column, `Shard(1)` row,
  `Replicate()` the rest). FSDP2 composes with that (2-D: `fully_shard`
  over the data mesh after this), and the optimizer's norm, the
  checkpoints and the exports read the placements.
- The activations never become DTensors. Every layer computes on its local
  shards (`parallel.sharding.local`), and the port's own autograd collectives
  below move the activations. DTensor's `ColwiseParallel` /
  `RowwiseParallel` plans are not used, because they make each layer's
  input and output a DTensor:
  - the int8 kernels and the flash kernels read raw pointers;
  - the fused `qkv` / `context_kv` rows are (which, head, dim)-major, so
    an even `Shard(0)` of the reference layout gives rank 0 all of q and
    none of v. Here those rows are held rank-major in memory, (tp, which,
    heads / tp, dim): each rank's `Shard(0)` block is its heads' q, k and
    v in the reference order, so the forward reshapes it as a one-rank
    layer of fewer heads. `reference_layout` / `memory_layout` convert
    whole tensors, and the state dict, checkpoints and exports keep the
    reference layout;
  - sequence parallelism falls back to a replicated stream for a forward
    whose L does not divide over tp (as JAX drops the hint, logged once),
    which a static plan cannot.

The collectives, each an autograd Function (forward / backward):
- `copy_to_tp`: identity / all-reduce (Megatron's f): a replicated tensor
  entering a rank's share of the work, whose gradient is partial;
- `enter_columns`: the input of the column-parallel products:
  `copy_to_tp`, or under sequence parallelism an all-gather along L /
  a reduce-scatter;
- `exit_rows`: the output of the row-parallel products: an all-reduce /
  identity (Megatron's g), or under sequence parallelism a reduce-scatter
  along L / an all-gather;
- `split_sequence` / `gather_sequence`: the stream into this rank's L / tp
  rows (a slice / an all-gather) before the blocks, and whole again (an
  all-gather / a slice) for the final layer.
So a block under plain TP all-reduces once after each attention and once
after the MLP (3 a cross-attention block, 2 a self-only block), and under
sequence parallelism reduce-scatters and all-gathers in place of each
all-reduce; `collective_log` records them.

Replicated parameters whose gradient is partial on a rank get the f
operator on the way in: `lambda_v` (it mixes the rank's heads), the
cross-attention context, and under sequence parallelism the modulation
and the norm weights (the embedders and registers are computed whole
before `split_sequence`, whose backward gathers their gradient).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.parallel import ParallelStyle, parallelize_module

logger = logging.getLogger(__name__)

COLUMN = ("qkv", "q", "context_kv", "gate_proj", "up_proj")
ROW = ("proj", "down_proj")
# the fused projections' outputs: (which, head, dim)-major rows
HEAD_SPLITS = {"qkv": 3, "context_kv": 2}


@dataclasses.dataclass(frozen=True, eq=False)
class TPContext:
    """What the DiT's modules read: the tp group, its size, this rank's
    place in it, and whether the residual stream is split along L."""

    group: object
    size: int
    rank: int
    sequence_parallel: bool = False


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

_LOG: list | None = None


@contextlib.contextmanager
def collective_log():
    """Record every forward collective of `parallel.tensor` (and the int8
    amax all-reduce) in the list this yields, as (kind, the group's
    ranks)."""
    global _LOG
    saved, _LOG = _LOG, []
    try:
        yield _LOG
    finally:
        _LOG = saved


def _note(kind: str, tp: TPContext) -> None:
    if _LOG is not None:
        _LOG.append((kind, tuple(dist.get_process_group_ranks(tp.group))))


def _all_reduce(x, tp, op=dist.ReduceOp.SUM):
    x = x.contiguous().clone()
    dist.all_reduce(x, op=op, group=tp.group)
    return x


def _all_gather_seq(x, tp):
    """(B, L / tp, ...) on each rank -> (B, L, ...), the ranks' rows in
    rank order."""
    x = x.contiguous()
    out = x.new_empty((tp.size * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=tp.group)
    out = out.unflatten(0, (tp.size, x.shape[0])).transpose(0, 1)
    return out.flatten(1, 2)


def _reduce_scatter_seq(x, tp):
    """(B, L, ...) partial sums on each rank -> this rank's (B, L / tp,
    ...) rows of their sum."""
    b, n = x.shape[:2]
    x = x.unflatten(1, (tp.size, n // tp.size)).transpose(0, 1).contiguous()
    out = x.new_empty((b, n // tp.size, *x.shape[3:]))
    dist.reduce_scatter_tensor(out, x.flatten(0, 1), group=tp.group)
    return out


def _slice_seq(x, tp):
    n = x.shape[1] // tp.size
    return x[:, tp.rank * n:(tp.rank + 1) * n].contiguous()


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        _note("all_reduce", tp)
        return _all_reduce(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherForColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        _note("all_gather", tp)
        return _all_gather_seq(x, tp)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_seq(g, ctx.tp), None


class _ScatterFromRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        _note("reduce_scatter", tp)
        return _reduce_scatter_seq(x, tp)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_seq(g, ctx.tp), None


class _SplitSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _slice_seq(x, tp)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_seq(g, ctx.tp), None


class _GatherSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        _note("all_gather", tp)
        return _all_gather_seq(x, tp)

    @staticmethod
    def backward(ctx, g):
        return _slice_seq(g, ctx.tp), None


def copy_to_tp(x, tp: TPContext):
    """x as it is; its gradient summed over the tp group."""
    return _CopyToTP.apply(x, tp)


def enter_columns(x, tp: TPContext, seq: bool):
    """The input of a column-parallel product: x whole (gathered along L
    where `seq`)."""
    return _GatherForColumns.apply(x, tp) if seq else _CopyToTP.apply(x, tp)


def exit_rows(y, tp: TPContext, seq: bool):
    """The output of a row-parallel product: the ranks' partial sums added
    (and this rank's L / tp rows of the sum where `seq`)."""
    return _ScatterFromRows.apply(y, tp) if seq else _ReduceFromTP.apply(y, tp)


def split_sequence(x, tp: TPContext):
    """This rank's contiguous L / tp rows of a replicated (B, L, D)."""
    return _SplitSequence.apply(x, tp)


def gather_sequence(x, tp: TPContext):
    """The whole (B, L, D) from each rank's rows, for replicated work."""
    return _GatherSequence.apply(x, tp)


def all_reduce_max(x, tp: TPContext):
    """The elementwise maximum of x over the tp group (no gradient)."""
    _note("all_reduce_max", tp)
    return _all_reduce(x, tp, dist.ReduceOp.MAX)


_WARNED: set = set()


def shards_sequence(tp: TPContext, length: int) -> bool:
    """Whether this forward splits its stream of `length` tokens: under
    sequence parallelism, where `length` divides over the ranks. Otherwise
    the stream stays replicated, logged once a (length, tp), as JAX drops
    the `act_seq` hint (`f_lite_tpu/models/dit.py` `_constrain`)."""
    if not tp.sequence_parallel:
        return False
    if length % tp.size == 0:
        return True
    if (length, tp.size) not in _WARNED:
        _WARNED.add((length, tp.size))
        logger.warning("sequence parallelism off for this forward: %d tokens do "
                       "not divide over tp %d ranks, the residual stream stays "
                       "replicated", length, tp.size)
    return False


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------

def head_layout(name: str):
    """(dim, split) of a tensor named `name` whose `dim` holds a fused
    projection's (which, head, dim)-major outputs (`qkv`: 3, `context_kv`:
    2), or None. Takes the state dict's names, those under a LoRA
    parametrization, the factor trees' (`blocks_0.self_attn.qkv.lora_b`)
    and the checkpoint's (`opt.mu/...`)."""
    parts = name.replace("/", ".").split(".")
    for owner, split in HEAD_SPLITS.items():
        if owner in parts[:-1]:
            leaf = parts[-1]
            if leaf == "lora_a":
                return None
            return (1, split) if leaf == "lora_b" else (0, split)
    return None


def tp_size(t) -> int:
    """The tp ranks `t` is placed over (1 for a plain tensor, or a DTensor
    whose mesh has no `tp` dim)."""
    if not isinstance(t, DTensor):
        return 1
    names = t.device_mesh.mesh_dim_names or ()
    return t.device_mesh.size(names.index("tp")) if "tp" in names else 1


def _regroup(t, dim: int, a: int, b: int):
    n = t.shape[dim]
    t = t.unflatten(dim, (a, b, n // (a * b))).transpose(dim, dim + 1)
    return t.flatten(dim, dim + 2).contiguous()


def memory_layout(whole: torch.Tensor, name: str, tp: int) -> torch.Tensor:
    """A whole tensor in the reference layout -> the layout `parallelize_dit`
    holds at `tp` ranks: a fused projection's rows rank-major, (tp, which,
    heads / tp, dim). Anything else, or tp 1, as it is."""
    layout = head_layout(name)
    if layout is None or tp == 1:
        return whole
    dim, split = layout
    return _regroup(whole, dim, split, tp)


def reference_layout(whole: torch.Tensor, name: str, tp: int) -> torch.Tensor:
    """The inverse of `memory_layout`."""
    layout = head_layout(name)
    if layout is None or tp == 1:
        return whole
    dim, split = layout
    return _regroup(whole, dim, tp, split)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def _leaf(module: nn.Module, name: str) -> str:
    """A parameter's role in its layer: "weight" for a parametrization's
    original, the factor's name for a LoRA factor, else its own name."""
    from torch.nn.utils.parametrize import ParametrizationList

    if isinstance(module, ParametrizationList) and name == "original":
        return "weight"
    return name


def _placement(kind: str, leaf: str):
    if kind == "column":
        return Replicate() if leaf == "lora_a" else Shard(1 if leaf == "lora_b" else 0)
    if kind == "row" and leaf in ("weight", "w8"):
        return Shard(1)
    if kind == "row" and leaf == "lora_a":
        return Shard(0)
    return Replicate()


def _distribute(module: nn.Module, name: str, placement, mesh, split) -> None:
    """Replace `module`'s parameter or buffer `name` by a DTensor of
    `placement` on `mesh`, cut from the local whole tensor (no
    collective); the rows of a fused projection rank-major first."""
    params = module._parameters
    t = params[name] if name in params else module._buffers[name]
    if t is None or isinstance(t, DTensor):
        return
    data = t.detach()
    if split is not None:
        dim, n = split
        data = _regroup(data, dim, n, mesh.size())
    dt = distribute_tensor(data, mesh, [placement], src_data_rank=None)
    if name in params:
        params[name] = nn.Parameter(dt, requires_grad=t.requires_grad)
    else:
        module._buffers[name] = dt


class _Placed(ParallelStyle):
    """Place a layer's tensors (its weight, bias, int8 buffers and LoRA
    factors) as a column- or row-parallel layer; no hooks: the layer
    computes on its local shards."""

    def __init__(self, kind: str, heads: int | None = None):
        self.kind, self.heads = kind, heads

    def _apply(self, module: nn.Module, device_mesh) -> nn.Module:
        for sub in module.modules():
            for name in [*sub._parameters, *sub._buffers]:
                leaf = _leaf(sub, name)
                split = None
                if self.heads and leaf in ("weight", "w8", "bias", "scale"):
                    split = (0, self.heads)
                elif self.heads and leaf == "lora_b":
                    split = (1, self.heads)
                _distribute(sub, name, _placement(self.kind, leaf), device_mesh, split)
        return module


def check_tp(cfg, tp: int) -> None:
    """Raise ValueError where `tp` does not divide the attention heads the
    DiT computes with or its MLP width."""
    inter = int(cfg.hidden_size * cfg.mlp_ratio)
    if cfg.compute_heads % tp or inter % tp:
        raise ValueError(
            f"tp {tp} does not divide the DiT's {cfg.compute_heads} attention "
            f"heads and its MLP width {inter}: tensor parallelism splits both "
            "evenly (serving pads heads at load: from_pretrained(pad_heads_to=))")


def parallelize_dit(model: nn.Module, tp_mesh, *, sequence_parallel: bool = False):
    """Split the DiT in place over the ranks of the 1-D `tp_mesh` (see the
    module docstring); applied at every size, one rank included. Every
    parameter and buffer becomes a DTensor on `tp_mesh`. Call it after
    `attach_lora` and `quantize_dit`, before `fully_shard`. Returns
    `model`."""
    from f_lite_tpu_torch.models.dit import (
        Attention,
        DiT,
        DiTBlock,
        QuantDense,
        SwiGLUMLP,
    )

    if tp_mesh.ndim != 1:
        raise ValueError(f"parallelize_dit takes a 1-D tp mesh, got {tp_mesh.ndim}-D")
    check_tp(model.config, tp_mesh.size())
    ctx = TPContext(tp_mesh.get_group(), tp_mesh.size(), tp_mesh.get_local_rank(),
                    sequence_parallel)
    plan = {}
    for name, mod in model.named_modules():
        owner = name.rsplit(".", 1)[-1]
        if name.startswith("blocks.") and owner in COLUMN:
            plan[name] = _Placed("column", HEAD_SPLITS.get(owner))
        elif name.startswith("blocks.") and owner in ROW:
            plan[name] = _Placed("row")
            if isinstance(mod, QuantDense):
                mod.tp_amax = ctx
    parallelize_module(model, tp_mesh, plan)
    for sub in model.modules():
        for name in [*sub._parameters, *sub._buffers]:
            _distribute(sub, name, Replicate(), tp_mesh, None)
        if isinstance(sub, (DiT, DiTBlock, Attention, SwiGLUMLP)):
            sub.tp = ctx
    return model
