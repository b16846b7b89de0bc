"""The 2-D (data, model) training mode over ``torch.distributed``
(``crnerf_tpu/parallel/tp.py``).

The JAX package runs the ordinary one-device train step under one
``jax.jit`` on a ``('data', 'model')`` mesh, with every parameter and
optimizer leaf of rank >= 2 split along its last (flax) dimension over
'model' and the batch's grids split over 'data'; XLA's partitioner inserts
the collectives. Here ``n_data * n_model`` processes each drive one device
and the split is written by hand, as Megatron's column-parallel layer with
its output gathered:

- ``make_mesh_2d`` joins the launcher's group and makes every rank's two
  subgroups: the data group (the ranks of this rank's model index) and the
  model group (the ranks of this rank's data index). Global rank
  ``d * n_model + m``: the model axis is minor, as in the JAX mesh.
- ``split_dim`` is the split rule, ``_last_dim_spec`` read through the
  port's layout (``utils/weights.py``): a flax kernel's last dimension is
  torch's dim 0, for ``Linear`` (out, in) and ``Conv2d`` (out, in, kh, kw)
  alike. Model rank m holds rows ``[m out / n, (m + 1) out / n)`` of a split
  leaf, the blocks a ``NamedSharding`` gives. Everything else is replicated.
- ``shard_state_tp`` cuts a one-process state to this rank's blocks, in
  place; the optimizer's state (Adam's moments, RAdam's and Ranger's) is
  cut with its leaves. ``gather_state_tp`` assembles the one-process state
  again on every rank.
- ``shard_train_step_tp`` is the train step of ``train/step.py`` with the
  data group as its group: each data rank steps on ``G / n_data`` of the
  step's G grids, the gradients and CGNet's statistics are averaged and
  the cache rows gathered over the data group, and the model ranks of one
  data index draw the same numbers.
- ``columns`` is what every weight reader of the models calls
  (``nerf_mlp.dense`` and ``split_dense``, ``common.conv``, ``conv1x1``,
  ``IEEEConv2d``, ``common.linear``, StyleNet's ``fc``, the sigma heads).
  For a split weight the reader's product runs on this rank's rows, from
  the replicated input, and the output columns are gathered: the
  activations after a layer are replicated, so every layer that is not
  split runs as in one process. The input's gradient is summed over the
  model ranks in the backward. With one process, or an unsplit weight, the
  reader's product runs as it is.

Each reader keeps its rounding order: the product is rounded to its dtype,
gathered, and the replicated bias added after, where the reader adds it
after; where the bias is fused into the product, this rank's rows of it
are (``local_rows``). The mode runs the module route only
(``pallas_train=False``): the hand kernels read whole weight matrices.

On gloo a CUDA tensor goes through the host (``mesh._via_host``), the case
of several ranks on one card. ``COLLECTIVE_BYTES`` counts the bytes the
model group's collectives produce on this rank.
"""

from __future__ import annotations

import dataclasses
import os
from typing import TYPE_CHECKING, Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from crnerf_tpu_torch.parallel import mesh

if TYPE_CHECKING:   # the models import this module: no cycle at run time
    from crnerf_tpu_torch.render.system import CrNerfSystem
    from crnerf_tpu_torch.train.state import TrainState

MODEL_AXIS = "model"

# bytes of the tensors that the model group's collectives produce on this
# rank: "gather_from_model" the gathered outputs (forward, and again in a
# recompute; and ``gather_state_tp``'s leaves), "copy_to_model" the input
# gradients summed in the backward
COLLECTIVE_BYTES: Dict[str, int] = {"gather_from_model": 0,
                                    "copy_to_model": 0}

# the attribute of a split parameter that names its model split
_SPLIT = "tp_split"


@dataclasses.dataclass(frozen=True)
class Split:
    """A parameter's model split: this rank holds block ``index`` of
    ``n`` along dim 0; ``group`` is the model group."""
    group: dist.ProcessGroup
    n: int
    index: int


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """This rank's place in the (data, model) mesh: its indices, the
    sizes, its data group (the ranks of its model index; None when
    ``n_data`` is 1) and model group (the ranks of its data index; None
    when ``n_model`` is 1), and its device."""
    n_data: int
    n_model: int
    data: int
    model: int
    data_group: Optional[dist.ProcessGroup]
    model_group: Optional[dist.ProcessGroup]
    device: torch.device


def make_mesh_2d(n_data: int, n_model: int, device="cuda",
                 backend: Optional[str] = None) -> Mesh2D:
    """Join the launcher's group (``mesh.init_distributed``; an existing
    group is kept) and make the mesh's subgroups. Every rank creates every
    subgroup in the same order, as ``dist.new_group`` asks. The world must
    hold ``n_data * n_model`` ranks; one process without a launcher is the
    1 x 1 mesh. ``device``: the card unless the caller names the CPU."""
    if n_data < 1 or n_model < 1:
        raise ValueError(f"mesh ({n_data}, {n_model}): sizes must be >= 1")
    if dist.is_initialized():
        world = dist.get_world_size()
    else:
        world = int(os.environ["WORLD_SIZE"]) if mesh.launched() else 1
    if world != n_data * n_model:
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs "
                         f"{n_data * n_model} ranks, the world has {world}")
    device = torch.device(device)
    if world == 1 and not dist.is_initialized():
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("make_mesh_2d: no CUDA device")
            device = torch.device("cuda", torch.cuda.current_device())
        return Mesh2D(1, 1, 0, 0, None, None, device)
    if not dist.is_initialized():
        device, _ = mesh.init_distributed(device, backend)
    elif device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    d, m = divmod(dist.get_rank(), n_model)
    data_groups = [dist.new_group([i * n_model + j for i in range(n_data)])
                   for j in range(n_model)]
    model_groups = [dist.new_group([i * n_model + j for j in range(n_model)])
                    for i in range(n_data)]
    return Mesh2D(n_data, n_model, d, m,
                  data_groups[m] if n_data > 1 else None,
                  model_groups[d] if n_model > 1 else None, device)


def split_dim(name: str, shape: Sequence[int], n_model: int
              ) -> Optional[int]:
    """The dim of the port's parameter ``name`` of ``shape`` that the model
    axis splits, or None where it is replicated. JAX's rule on a params or
    opt_state leaf of rank >= 2: its last (flax) dim, where that divides by
    ``n_model`` and is at least ``2 n_model``; in the port's layout that
    dim is 0 (a kernel is ``weight``, out first). Biases, norm and PReLU
    weights (rank 1) and heads too narrow to split stay replicated, as
    does every leaf at ``n_model`` 1."""
    if n_model <= 1 or len(shape) < 2:
        return None
    if not name.endswith("weight"):
        raise ValueError(f"{name}: a parameter of rank {len(shape)} that is "
                         "not a kernel has no rule")
    out = shape[0]
    return 0 if out % n_model == 0 and out >= 2 * n_model else None


def split_of(weight: torch.Tensor) -> Optional[Split]:
    """The model split of a parameter, None where it is whole."""
    return getattr(weight, _SPLIT, None)


def _rows(n_rows: int, split: Split) -> slice:
    c = n_rows // split.n
    return slice(split.index * c, (split.index + 1) * c)


def _all_reduce_sum(t: torch.Tensor, split: Split) -> torch.Tensor:
    t = t.contiguous()
    COLLECTIVE_BYTES["copy_to_model"] += t.numel() * t.element_size()
    if mesh._via_host(split.group, t):
        host = t.cpu()
        dist.all_reduce(host, group=split.group)
        return host.to(t.device)
    t = t.clone()
    dist.all_reduce(t, group=split.group)
    return t


def _all_gather_cat(t: torch.Tensor, split: Split, dim: int
                    ) -> torch.Tensor:
    src = t.contiguous()
    COLLECTIVE_BYTES["gather_from_model"] += (split.n * src.numel()
                                              * src.element_size())
    host = mesh._via_host(split.group, src)
    x = src.cpu() if host else src
    parts = [torch.empty_like(x) for _ in range(split.n)]
    dist.all_gather(parts, x, group=split.group)
    out = torch.cat(parts, dim)
    return out.to(t.device) if host else out


class _CopyToModel(torch.autograd.Function):
    """The identity forward; the gradient summed over the model ranks."""

    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_sum(g, ctx.split), None


class _GatherFromModel(torch.autograd.Function):
    """Every model rank's output columns along ``dim``, in rank order; the
    backward keeps this rank's columns of the gradient."""

    @staticmethod
    def forward(ctx, y, split, dim):
        ctx.split, ctx.dim = split, dim
        return _all_gather_cat(y, split, dim)

    @staticmethod
    def backward(ctx, g):
        c = g.shape[ctx.dim] // ctx.split.n
        return (g.narrow(ctx.dim, ctx.split.index * c, c).contiguous(),
                None, None)


def columns(product: Callable[..., torch.Tensor], weight: torch.Tensor,
            *inputs: torch.Tensor, dim: int = -1,
            grouped: bool = False) -> torch.Tensor:
    """``product(weight, *inputs)``, a layer's output before any bias
    added after it, with the weight's model split: on a split weight the
    product of this rank's rows, its columns gathered along the feature
    ``dim`` of the output (last for (..., C), 1 for NCHW). ``grouped``: a
    grouped convolution whose groups split with the weight, which reads
    this rank's input channels (along ``dim``) only."""
    split = split_of(weight)
    if split is None:
        return product(weight, *inputs)
    xs = [_CopyToModel.apply(x, split) for x in inputs]
    if grouped:
        xs = [x[(slice(None),) * (dim % x.dim()) + (_rows(x.shape[dim],
                                                          split),)]
              for x in xs]
    return _GatherFromModel.apply(product(weight, *xs), split, dim)


def local_rows(t: Optional[torch.Tensor], weight: torch.Tensor
               ) -> Optional[torch.Tensor]:
    """This rank's rows of a replicated ``t`` that runs along the split dim
    of ``weight`` (a bias fused into the product); its gradient is summed
    over the model ranks, so every rank holds the whole one. ``t`` itself
    where the weight is whole."""
    split = split_of(weight)
    if t is None or split is None:
        return t
    return _CopyToModel.apply(t, split)[_rows(t.shape[0], split)]


def local_groups(weight: torch.Tensor, groups: int) -> int:
    """The groups of this rank's part of a grouped convolution."""
    split = split_of(weight)
    if split is None or groups == 1:
        return groups
    if groups % split.n:
        raise ValueError(f"groups={groups} do not split over {split.n} "
                         "model ranks")
    return groups // split.n


def _split_params(system: CrNerfSystem, n_model: int):
    """-> [(name, parameter)] of the parameters the rule splits."""
    return [(k, p) for k, p in system.named_parameters()
            if split_dim(k, p.shape, n_model) is not None]


def shard_state_tp(state: TrainState, mesh2d: Mesh2D) -> TrainState:
    """This rank's state of the 2-D mode from a one-process ``state``
    (from ``state_dict_from_flax``, a checkpoint, or a seeded init; the
    same on every rank), cut in place: every split leaf keeps this rank's
    rows and is marked with its split, and so does the optimizer's state of
    that leaf. The cache, the generator, the step and the BatchNorm
    statistics stay whole."""
    n = mesh2d.n_model
    if n == 1:
        return state
    split = Split(mesh2d.model_group, n, mesh2d.model)
    for _, p in _split_params(state.system, n):
        if split_of(p) is not None:
            raise ValueError("shard_state_tp: the state is already split")
        full = tuple(p.shape)
        rows = _rows(full[0], split)
        with torch.no_grad():
            p.data = p.data[rows].clone()
        p.grad = None
        setattr(p, _SPLIT, split)
        st = state.optimizer.state.get(p, {})
        for k, v in st.items():
            if isinstance(v, torch.Tensor) and tuple(v.shape) == full:
                st[k] = v[rows].clone()
    return state


def gather_state_tp(state: TrainState) -> TrainState:
    """The one-process state of a rank's ``state`` on every rank: a new
    system on this rank's device with the whole parameters and statistics,
    a new optimizer of the same kind over it with the whole state, and
    copies of the cache, its validity, the generator and the step. What
    ``flax_from_state_dict`` and ``utils/checkpoint.py`` take. Every rank
    of the model group calls it."""
    from crnerf_tpu_torch.render.system import CrNerfSystem

    src = state.system
    system = CrNerfSystem(src.cfg).to(next(src.parameters()).device)
    own, bufs = dict(system.named_parameters()), dict(system.named_buffers())
    name_of = {id(p): k for k, p in src.named_parameters()}
    with torch.no_grad():
        for k, p in src.named_parameters():
            split = split_of(p)
            own[k].copy_(p if split is None
                         else _all_gather_cat(p.detach(), split, 0))
        for k, b in src.named_buffers():
            bufs[k].copy_(b)
    opt = state.optimizer
    groups = [{**{k: v for k, v in g.items() if k != "params"},
               "params": [own[name_of[id(p)]] for p in g["params"]]}
              for g in opt.param_groups]
    new_opt = type(opt)(groups, **opt.defaults)
    sd = opt.state_dict()
    flat = [p for g in opt.param_groups for p in g["params"]]
    for i, p in enumerate(flat):
        split = split_of(p)
        if split is None or i not in sd["state"]:
            continue
        sd["state"][i] = {
            k: (_all_gather_cat(v, split, 0)
                if isinstance(v, torch.Tensor) and v.shape == p.shape
                else v)
            for k, v in sd["state"][i].items()}
    new_opt.load_state_dict(sd)
    gen = None
    if state.generator is not None:
        gen = torch.Generator(device=state.generator.device)
        gen.set_state(state.generator.get_state())
    return dataclasses.replace(
        state, system=system, optimizer=new_opt,
        embedding_cache=state.embedding_cache.clone(),
        embedding_valid=state.embedding_valid.clone(), generator=gen)


def shard_train_step_tp(state: TrainState,
                        lr_sched: Callable[[int], float], mesh2d: Mesh2D,
                        grids_per_step: int = 1,
                        grad_accum_chunks: int = 1) -> Callable:
    """The train step of the 2-D mode over ``state`` (this rank's, from
    ``shard_state_tp``) -> ``step(state, batch, draws=None)``, which takes
    the step's whole batch of ``grids_per_step`` G grids (and its draws,
    with a leading G axis), the same on every rank, and steps on its data
    index's ``G / n_data``. Returns the state, updated in place, and the
    data rank's metrics (``train.step.reduce_metrics`` over
    ``mesh2d.data_group`` averages them)."""
    from crnerf_tpu_torch.train.step import make_train_step

    cfg = state.system.cfg
    if cfg.pallas_train:
        raise ValueError("the 2-D mode runs the module route "
                         "(pallas_train=False): the hand kernels of the "
                         "fused routes read whole weight matrices")
    g_total, n_data = grids_per_step, mesh2d.n_data
    if g_total % n_data:
        raise ValueError(f"grids_per_step={g_total} does not split over "
                         f"{n_data} data ranks")
    for k, p in _split_params(state.system, mesh2d.n_model):
        split = split_of(p)
        if split is None or split.group is not mesh2d.model_group:
            raise ValueError(f"{k}: not split over this mesh's model group "
                             "(shard_state_tp first)")
    g_local = g_total // n_data
    sl = slice(mesh2d.data * g_local, (mesh2d.data + 1) * g_local)
    inner = make_train_step(state.system, state.optimizer, lr_sched,
                            g_local, grad_accum_chunks,
                            group=mesh2d.data_group)

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             draws: Optional[Dict[str, torch.Tensor]] = None):
        if batch["rays"].dim() == 2:
            batch = {k: v[None] for k, v in batch.items()}
        if batch["rays"].shape[0] != g_total:
            raise ValueError(f"batch of {batch['rays'].shape[0]} grids, "
                             f"step built for {g_total}")
        local = {k: v[sl] for k, v in batch.items()}
        local_draws = ({k: v[sl] for k, v in draws.items()}
                       if draws is not None else None)
        return inner(state, local, local_draws)

    return step
