"""Pipeline parallelism of the DiT (counterpart of
`f_lite_tpu/parallel/pipeline.py` and of `PipelineTrunk`,
`f_lite_tpu/models/dit.py:751-860`).

JAX vmaps the pipelined region's scan units over a `stage` axis and runs
GSPMD's tick loop (`_PipeStep`): every device computes its stage each
tick and XLA shifts the states with a collective-permute. Here the same
schedule is explicit: each rank holds one stage (`DiTStage`, a DiT that
keeps only its own modules, under their reference names) and
`torch.distributed.pipelining` runs GPipe over a process group per
pipeline (`mesh["pp"]`): every microbatch's forward through the stages,
then every backward, the gradients summed over the microbatches.

What a stage holds (`stage_blocks`): only the uniform region is split,
`blocks_all`'s units for v2 (`cross_attn_all`) or v1's periodic
`blocks_rest`; stage s holds scan units [s * ups, (s + 1) * ups), ups =
units / pp. Stage 0 also holds the embedders, the registers, the context
projection, the shared AdaLN head and v1's front blocks; the last stage
holds the final layer. JAX keeps v1's front blocks (and the embedders) on
every pp device and computes them there; the math is the same either way.
A v1 model whose depth leaves no periodic region has nothing to pipeline:
every stage then holds and runs the whole model (JAX does not raise
there either).

Between stages travel the tensors the later blocks read (`DiTStage`):
the tokens (this rank's share under sequence parallelism), residual_v's
`v_first`, the projected and normed context (its gradient reaches
`context_proj`), the context's key counts, `t_emb` and, in shared AdaLN,
the modulation. Each later stage builds its rope tables from the patch
grid (`DiTStage.grid`, set for each shape) and its global block indices
drive remat and residual_v's block-0 rule.

Samples go to microbatches as in JAX (`:813-826`): sample i to microbatch
i % num_mb, the inverse restoring the order. A batch that num_mb does not
divide degrades to the largest divisor, with JAX's warning (`:789-811`);
eval and sampling batches rely on that. A stage's shapes are given to
`PipelineStage` for each input shape (aspect buckets change L, eval and
sampling batches their size), so no shape is inferred at run time.

Checkpoints and exports stay whole and in the reference layout:
`StageGroup` lists every stage's tensors on every rank (meta tensors for
another stage's) and hands each whole tensor to rank 0 (gathered in its
stage, then sent by the stage's first rank), one at a time.

`scan_to_pipeline_params` / `pipeline_to_scan_params` are the lossless
reshapes between JAX's plain-scan and pipeline parameter layouts, on
nested dicts of arrays or tensors.
"""

from __future__ import annotations

import logging

import torch
import torch.distributed as dist
from torch import nn

from f_lite_tpu_torch.models.dit import DiT, Stream

logger = logging.getLogger(__name__)

_TRUNKS = ("blocks_all", "blocks_rest")


# ---------------------------------------------------------------------------
# the parameter layouts
# ---------------------------------------------------------------------------

def _flatten(tree: dict, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def scan_to_pipeline_params(params: dict, pp: int) -> dict:
    """Plain-scan param tree -> pipeline layout for `pp` stages: each
    trunk's leaves (n_units, ...) become (pp, n_units / pp, ...) under
    `<trunk>.pipe.stages.blocks`."""
    out = dict(params["params"])
    for name in _TRUNKS:
        if name not in out:
            continue
        if "pipe" in out[name]:
            raise ValueError(f"{name} is already in pipeline layout")
        sub = _flatten(out[name])
        for k, v in sub.items():
            if v.shape[0] % pp:
                raise ValueError(
                    f"{name}/{'/'.join(k)}: {v.shape[0]} scan units not "
                    f"divisible by pipeline_stages={pp}")
        sub = {k: v.reshape(pp, v.shape[0] // pp, *v.shape[1:]) for k, v in sub.items()}
        out[name] = {"pipe": {"stages": {"blocks": _unflatten(sub)}}}
    rest = {k: v for k, v in params.items() if k != "params"}
    return {"params": out, **rest}


def pipeline_to_scan_params(params: dict) -> dict:
    """Pipeline param tree -> plain-scan layout (the stage axis folded
    back)."""
    out = dict(params["params"])
    for name in _TRUNKS:
        if name not in out or "pipe" not in out[name]:
            continue
        sub = _flatten(out[name]["pipe"]["stages"]["blocks"])
        sub = {k: v.reshape(v.shape[0] * v.shape[1], *v.shape[2:]) for k, v in sub.items()}
        out[name] = _unflatten(sub)
    rest = {k: v for k, v in params.items() if k != "params"}
    return {"params": out, **rest}


# ---------------------------------------------------------------------------
# what each stage holds
# ---------------------------------------------------------------------------

def pipeline_region(cfg) -> tuple[int, int, int]:
    """(the region's first block, its scan units, blocks a unit): v2's
    `blocks_all` (every block a unit) or v1's periodic `blocks_rest` behind
    the `min(first_n, depth)` front blocks. Raises JAX's ValueError where
    the scan layout cannot hold a v1 config."""
    if cfg.cross_attn_all:
        return 0, cfg.depth, 1
    first_n = min(cfg.cross_attn_first_n, cfg.depth)
    rest = cfg.depth - first_n
    if rest % cfg.cross_attn_period != 0:
        raise ValueError("scan_layers requires (depth - first_n) divisible "
                         "by cross_attn_period")
    return first_n, rest // cfg.cross_attn_period, cfg.cross_attn_period


def stage_blocks(cfg, pp: int, *, scan_layers: bool = True) -> list[range] | None:
    """The global blocks each of `pp` stages holds (stage 0 also v1's front
    blocks), or None where the region is empty (v1 with depth <=
    first_n: nothing to pipeline, every stage holds the whole model).
    Raises JAX's ValueErrors: a pipeline needs the scan layout, and `pp`
    must divide the region's units."""
    if pp > 1 and not scan_layers:
        raise ValueError("pipeline_stages > 1 requires scan_layers")
    front, units, per_unit = pipeline_region(cfg)
    if units == 0:
        return None
    if units % pp:
        raise ValueError(f"pipeline_stages={pp} must divide the pipelined region's "
                         f"{units} scan units")
    step = units // pp * per_unit
    return [range(0 if s == 0 else front + s * step, front + (s + 1) * step)
            for s in range(pp)]


_DEGRADED: set = set()  # (batch, microbatches) warned of


def microbatch_count(batch: int, microbatches: int) -> int:
    """The microbatches a batch of `batch` rows runs in: `microbatches`, or
    where it does not divide the batch the largest count that does, with
    JAX's warning (once a shape)."""
    if batch % microbatches == 0:
        return microbatches
    n = next(k for k in range(min(microbatches, batch), 0, -1) if batch % k == 0)
    if (batch, microbatches) not in _DEGRADED:
        _DEGRADED.add((batch, microbatches))
        logger.warning(
            "batch %d not divisible by pipeline_microbatches=%d — degrading this "
            "program to %d microbatch(es); expected for init/eval shapes, a "
            "misconfigured recipe if it is the training step", batch, microbatches, n)
    return n


def strided_order(batch: int, n_mb: int) -> torch.Tensor:
    """The row order whose contiguous microbatches are JAX's strided ones:
    microbatch m holds samples m, m + n_mb, m + 2 n_mb, ..."""
    return torch.arange(batch).reshape(batch // n_mb, n_mb).t().reshape(-1)


# ---------------------------------------------------------------------------
# the stage module
# ---------------------------------------------------------------------------

class HeldElsewhere(nn.Module):
    """A place in `DiT.blocks` for a block another stage holds."""

    def forward(self, *args, **kwargs):
        raise RuntimeError("this block is held by another pipeline stage")


_FIRST_ONLY = ("context_proj", "context_norm", "patch_embed", "register_tokens",
               "positional_embedding", "time_embed", "adaLN_modulation")
_LAST_ONLY = ("final_modulation", "final_norm", "final_proj")


class DiTStage(DiT):
    """Stage `stage` of `n_stages` of the DiT: the blocks of `blocks` (the
    others `HeldElsewhere`), stage 0's embedders and the last stage's final
    layer, under the whole DiT's names. Its forward is what
    `PipelineStage` runs on one microbatch: stage 0 takes the DiT's inputs
    (x, context, context_mask, t), a later stage the tensors the one
    before sends (`carry_names`); the last stage returns the velocity.
    `grid` (the patch grid) is set for each input shape. Build it on the
    meta device (`build_stage` materializes it)."""

    def __init__(self, cfg, stage: int, n_stages: int, blocks: range):
        super().__init__(cfg)
        self.stage, self.n_stages, self.held = stage, n_stages, blocks
        self.grid = None
        for i in range(cfg.depth):
            if i not in blocks:
                self.blocks[i] = HeldElsewhere()
        for name in (_FIRST_ONLY if stage > 0 else ()) + (
                _LAST_ONLY if stage < n_stages - 1 else ()):
            if hasattr(self, name):
                delattr(self, name)

    @property
    def is_first(self) -> bool:
        return self.stage == 0

    @property
    def is_last(self) -> bool:
        return self.stage == self.n_stages - 1

    def carry_names(self) -> tuple[str, ...]:
        """The tensors a stage sends the next, in order."""
        cfg = self.config
        return (("tokens",) + (("v_first",) if cfg.residual_v else ())
                + ("context", "kv_lens", "t_emb")
                + (("modulation",) if cfg.adaln_mode == "shared" else ()))

    def forward(self, *args):
        if self.is_first:
            s = self.embed(*args)
        else:
            s = self._received(args)
        s = self.run_blocks(s, self.held.start, self.held.stop)
        return self.head(s) if self.is_last else self._sent(s)

    def _sent(self, s: Stream) -> tuple:
        # the context's mask is prefix-form here: it travels as the key
        # counts, in fp32 (a received tensor is a float that can carry a
        # gradient)
        kv_lens = s.context_mask.sum(-1, dtype=torch.int32).float()
        out = {"tokens": s.tokens, "v_first": s.v_first, "context": s.context,
               "kv_lens": kv_lens, "t_emb": s.t_emb, "modulation": s.modulation}
        # contiguous: a send takes the tensor's storage as it is
        return tuple(out[k].contiguous() for k in self.carry_names())

    def _received(self, args) -> Stream:
        got = dict(zip(self.carry_names(), args, strict=True))
        kv_lens = got["kv_lens"]
        # the key counts join the graph (as zeros) so that every received
        # tensor has a gradient to send back, which a stage that received
        # it waits for
        t_emb = got["t_emb"] + kv_lens[:, None].to(got["t_emb"].dtype) * 0
        lk = got["context"].shape[1]
        mask = torch.arange(lk, device=kv_lens.device)[None] < kv_lens.long()[:, None]
        length = self.config.n_register_tokens + self.grid[0] * self.grid[1]
        return Stream(got["tokens"], got["context"], mask, t_emb, got.get("modulation"),
                      self.rope(self.grid, kv_lens.device), self.grid,
                      self.splits_sequence(length), v_first=got.get("v_first"))

    def carry_metas(self, batch: int, grid, context_len: int, dtype) -> tuple:
        """Meta tensors of what a stage sends for a microbatch of `batch`
        rows on a `grid` patch grid with `context_len` context keys."""
        cfg = self.config
        length = cfg.n_register_tokens + grid[0] * grid[1]
        tp = self.tp.size if self.tp is not None else 1
        local = length // tp if self.splits_sequence(length) else length
        shapes = {"tokens": (batch, local, cfg.hidden_size),
                  "v_first": (batch, cfg.compute_heads // tp, length, cfg.head_dim),
                  "context": (batch, context_len, cfg.hidden_size),
                  "kv_lens": (batch,), "t_emb": (batch, cfg.hidden_size),
                  "modulation": (batch, 9, cfg.hidden_size)}
        return tuple(_meta(shapes[k], torch.float32 if k == "kv_lens" else dtype)
                     for k in self.carry_names())


def _meta(shape, dtype, requires_grad=True) -> torch.Tensor:
    t = torch.empty(shape, dtype=dtype, device="meta")
    return t.requires_grad_(requires_grad and t.is_floating_point())


def build_stage(cfg, stage: int, n_stages: int, blocks: range, device) -> DiTStage:
    """Stage `stage` of the DiT, its tensors allocated on `device` and not
    initialized (`DiT.init_weights` or a state dict's values next)."""
    with torch.device("meta"):
        module = DiTStage(cfg, stage, n_stages, blocks)
    return module.to_empty(device=device)


# ---------------------------------------------------------------------------
# the schedules
# ---------------------------------------------------------------------------

class PipelinedDiT:
    """This rank's stage of the DiT in a pipeline over `group` (the ranks
    that share its dp, fsdp and tp coordinates, one a stage in stage
    order), run by GPipe schedules of `microbatches` microbatches.

    Called like the DiT (x, context, context_mask, t) it runs the forward
    only, without gradients, through every stage, and returns the
    velocity on every rank of the group (eval and sampling; a batch that
    the microbatches do not divide degrades, `microbatch_count`).
    `train_microbatches` runs one training step's forwards and backwards.
    Every rank of the group calls each with the same inputs. A schedule
    is built for each input shape and kept (the newest `KEEP`)."""

    KEEP = 4

    def __init__(self, module: DiTStage, group, microbatches: int, device):
        self.module, self.group, self.microbatches = module, group, microbatches
        self.device = torch.device(device)
        self._schedules: dict = {}
        self._loss = None

    @property
    def config(self):
        return self.module.config

    def parameters(self):
        return self.module.parameters()

    def named_parameters(self):
        return self.module.named_parameters()

    def _last_rank(self) -> int:
        return dist.get_global_rank(self.group, self.module.n_stages - 1)

    def _schedule(self, train: bool, args: tuple, n_mb: int):
        from torch.distributed.pipelining import PipelineStage, ScheduleGPipe

        x, context = args[0], args[1]
        grid = (x.shape[1] // self.config.patch_size, x.shape[2] // self.config.patch_size)
        key = (train, n_mb, grid, *((tuple(a.shape), a.dtype) for a in args))
        if key in self._schedules:
            self._schedules[key] = self._schedules.pop(key)  # the newest last
            return self._schedules[key]
        m = self.module
        bmb = x.shape[0] // n_mb
        dtype = m.dtype
        carried = m.carry_metas(bmb, grid, context.shape[1], dtype)
        inputs = (tuple(_meta((bmb, *a.shape[1:]), a.dtype, False) for a in args)
                  if m.is_first else carried)
        outputs = (_meta((bmb, *x.shape[1:3], self.config.in_channels), dtype)
                   if m.is_last else carried)
        stage = PipelineStage(m, m.stage, m.n_stages, self.device, input_args=inputs,
                              output_args=outputs, group=self.group)
        schedule = ScheduleGPipe(stage, n_mb, loss_fn=self._loss_fn if train else None,
                                 scale_grads=False)
        self._schedules[key] = (schedule, grid)
        while len(self._schedules) > self.KEEP:
            self._schedules.pop(next(iter(self._schedules)))
        return schedule, grid

    def _loss_fn(self, output, target):
        return self._loss(output, target)

    def _run(self, train: bool, args: tuple, n_mb: int, target=None):
        """Run one schedule on `args` (the DiT's inputs, rows in the
        strided order): the last stage's merged output (None elsewhere)."""
        schedule, grid = self._schedule(train, args, n_mb)
        self.module.grid = grid
        m = self.module
        kwargs = {}
        if m.is_last and target is not None:
            kwargs = {"target": target, "losses": []}
        return schedule.step(*(args if m.is_first else ()), **kwargs)

    def _inputs(self, x, context, context_mask, t, n_mb):
        if context_mask is None:  # every key real: the same attention
            context_mask = torch.ones(context.shape[:2], dtype=torch.bool,
                                      device=context.device)
        order = strided_order(x.shape[0], n_mb).to(x.device)
        return order, tuple(a.index_select(0, order) for a in (x, context, context_mask, t))

    @torch.no_grad()
    def __call__(self, x, context, context_mask, t, token_indices=None):
        if token_indices is not None:
            raise ValueError("pipeline_stages > 1 is incompatible with sequence "
                             "dropout (token_indices) — rope becomes per-sample")
        n_mb = microbatch_count(x.shape[0], self.microbatches)
        order, args = self._inputs(x, context, context_mask, t, n_mb)
        out = self._run(False, args, n_mb)
        if not self.module.is_last:
            out = torch.empty((*x.shape[:3], self.config.in_channels),
                              dtype=self.module.dtype, device=x.device)
        else:
            out = torch.empty_like(out).index_copy_(0, order, out)
        if self.module.n_stages > 1:
            dist.broadcast(out, src=self._last_rank(), group=self.group)
        return out

    def train_microbatches(self, x, context, context_mask, t, target, loss) -> None:
        """One training step's forwards and backwards: `loss(prediction,
        target)` (each microbatch's rows of `target`, a (B, ...) tensor)
        runs on the last stage for each microbatch, and its gradients add
        up in the parameters' `.grad` (no scaling by the microbatch count).
        The microbatches are JAX's strided ones; `target`'s rows follow
        the batch's."""
        n_mb = microbatch_count(x.shape[0], self.microbatches)
        order, args = self._inputs(x, context, context_mask, t, n_mb)
        self._loss = loss
        try:
            self._run(True, args, n_mb, target.index_select(0, order))
        finally:
            self._loss = None
        return order

    def broadcast_from_last(self, values: torch.Tensor) -> torch.Tensor:
        """`values` of the last stage on every rank of the group (the same
        shape and dtype everywhere)."""
        if self.module.n_stages > 1:
            dist.broadcast(values, src=self._last_rank(), group=self.group)
        return values


# ---------------------------------------------------------------------------
# whole tensors across the stages
# ---------------------------------------------------------------------------

class StageGroup:
    """The pp group of this rank and its stage's place in it, for whole
    tensors of every stage: `view` lists each stage's tensors on every rank
    (another stage's as meta tensors of its whole shape and dtype), and
    `whole` gives a tensor whole on rank 0 (gathered in its stage, then
    sent by the stage's first rank). `leader`: this rank shares rank 0's
    dp, fsdp and tp coordinates."""

    def __init__(self, group, stage: int, leader: bool):
        self.group, self.stage, self.leader = group, stage, leader
        self.owner: dict = {}

    def view(self, tensors: dict) -> dict:
        """{name: tensor} of every stage (every rank of the group calls
        this with its own stage's tensors)."""
        mine = {name: (tuple(t.shape), t.dtype) for name, t in tensors.items()}
        listed = [None] * dist.get_world_size(self.group)
        dist.all_gather_object(listed, mine, group=self.group)
        out = {}
        for stage, entries in enumerate(listed):
            for name, (shape, dtype) in entries.items():
                self.owner[name] = stage
                out[name] = (tensors[name] if stage == self.stage
                             else torch.empty(shape, dtype=dtype, device="meta"))
        return out

    def whole(self, t: torch.Tensor, name: str):
        """`t` whole on rank 0 (every rank of every stage calls this, for
        each name of `view` in one order); None on the others."""
        from f_lite_tpu_torch.parallel.sharding import full_tensor

        owner, rank = self.owner[name], dist.get_rank()
        if owner == self.stage:
            w = full_tensor(t.detach(), name)
            if owner != 0 and self.leader:
                dist.send(w.contiguous(), dst=0)
            return w if rank == 0 else None
        if rank == 0:
            w = torch.empty(t.shape, dtype=t.dtype, device=_peer_device())
            dist.recv(w, src=dist.get_global_rank(self.group, owner))
            return w
        return None


def _peer_device() -> torch.device:
    """Where point-to-point tensors of the default group live: the bound
    GPU under NCCL, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")
