"""The rank side of tests/test_torch_tp.py: what each spawned rank of the
port's 2-D mode runs, and the helpers the test's own process shares with
it. Imports torch and the port only, so that a rank starts without jax.
"""

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from crnerf_tpu_torch.parallel import tp
from crnerf_tpu_torch.render.system import CrNerfSystem
from crnerf_tpu_torch.train.optim import make_optimizer
from crnerf_tpu_torch.train.state import TrainState
from crnerf_tpu_torch.train.step import reduce_metrics
from crnerf_tpu_torch.utils import weights as bridge


def port_state(cfg, sd):
    """A one-process TrainState of ``cfg`` holding the state dict ``sd``,
    Adam from the config, and its schedule."""
    system = CrNerfSystem(cfg)
    system.load_state_dict(sd)
    opt, sched = make_optimizer(cfg, 10, system.parameters())
    return TrainState.create(system, opt, cfg.N_vocab, 32,
                             cfg.nerf_out_dim), sched


def gathered_out(state, metrics):
    """What the comparisons read of a one-process state (a gathered one on
    a rank): flax-layout parameters and statistics, Adam's first moment in
    the flax layout, the cache, the metrics."""
    v = bridge.flax_from_state_dict(state.system)
    probe = CrNerfSystem(state.system.cfg)
    with torch.no_grad():
        for p, q in zip(state.system.parameters(), probe.parameters()):
            q.grad = state.optimizer.state[p]["exp_avg"].clone()
    mu = bridge.flatten(bridge.flax_from_state_dict(probe, grads=True)
                        ["params"])
    return dict(params=bridge.flatten(v["params"]),
                stats=bridge.flatten(v["batch_stats"]), mu=mu,
                cache=state.embedding_cache.clone(),
                valid=state.embedding_valid.clone(), metrics=metrics)


def local_out(state):
    """This rank's own tensors: its state dict, the optimizer's state by
    parameter name, the cache, its validity."""
    opt = {}
    for k, p in state.system.named_parameters():
        for name, v in state.optimizer.state[p].items():
            if isinstance(v, torch.Tensor):
                opt[f"{k}.{name}"] = v.clone()
    return dict(sd={k: v.clone() for k, v in
                    state.system.state_dict().items()},
                opt=opt, cache=state.embedding_cache.clone(),
                valid=state.embedding_valid.clone())


class SplitFlops(TorchDispatchMode):
    """FlopCounterMode's count of every matmul and convolution, split by
    whether an operand shares its storage with one of ``params`` (a view
    of the weight, or the weight itself)."""

    def __init__(self, params):
        super().__init__()
        self.ptrs = {p.untyped_storage().data_ptr() for p in params}
        self.split = self.other = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            n = count(*args, **kwargs, out_val=out)
            if any(isinstance(a, torch.Tensor)
                   and a.untyped_storage().data_ptr() in self.ptrs
                   for a in tree_leaves((args, kwargs))):
                self.split += n
            else:
                self.other += n
        return out


def forward_flops(system, batch, draws, split_params):
    """(FlopCounterMode's total, the split and the other FLOPs) of one
    training forward of ``system`` on ``batch`` (its grids) and ``draws``,
    without gradient."""
    g = batch["rays"].shape[0]
    d = {k: v.flatten(0, 1) for k, v in draws.items() if k != "sel_idx"}
    a_rand = torch.zeros((g, 32, 32, system.cfg.nerf_out_dim))
    system.train()
    with torch.no_grad(), FlopCounterMode(display=False) as fc, \
            SplitFlops(split_params) as sf:
        system.forward_train(batch, a_embedded_random=a_rand,
                             random_has_any=False, draws=d)
    for m in system.implicit_mask.norms():
        m.pending = None
    return fc.get_total_flops(), sf.split, sf.other


def rank_job(path):
    """One rank of the job's (n_data, n_model) mesh (run by mesh.spawn):
    the FLOPs of a training forward on its grids beside one process's,
    then the job's steps, each followed by the gathered state, and one
    Ranger step of ``ranger_cfg``; writes what it measured beside
    ``path``."""
    job = torch.load(path, weights_only=False)
    cfg, (n_data, n_model), g = job["cfg"], job["mesh"], job["grids"]
    m2 = tp.make_mesh_2d(n_data, n_model, "cpu")
    r = torch.distributed.get_rank()
    out = {"mesh": (m2.data, m2.model)}

    sl = slice(m2.data * g // n_data, (m2.data + 1) * g // n_data)
    b0 = {k: v[sl] for k, v in job["batches"][0].items()}
    d0 = {k: v[sl] for k, v in job["draws"][0].items()}
    one, _ = port_state(cfg, job["sd"])
    names = [k for k, p in one.system.named_parameters()
             if tp.split_dim(k, p.shape, n_model) is not None]
    one_p = dict(one.system.named_parameters())
    out["flops_one"] = forward_flops(one.system, b0, d0,
                                     [one_p[k] for k in names])

    state, sched = port_state(cfg, job["sd"])
    state = tp.shard_state_tp(state, m2)
    own = dict(state.system.named_parameters())
    out["flops_rank"] = forward_flops(state.system, b0, d0,
                                      [own[k] for k in names])
    step = tp.shard_train_step_tp(state, sched, m2, grids_per_step=g)
    out["steps"] = []
    with torch.backends.mkldnn.flags(enabled=False):
        for b, d in zip(job["batches"], job["draws"]):
            state, m = step(state, b, d)
            full = tp.gather_state_tp(state)
            out["steps"].append(gathered_out(
                full, reduce_metrics(m, m2.data_group)))
            if len(out["steps"]) == 1:
                out["shapes"] = {
                    k: tuple(tuple(t.shape) for t in (
                        p, state.optimizer.state[p]["exp_avg"],
                        state.optimizer.state[p]["exp_avg_sq"]))
                    for k, p in state.system.named_parameters()}
    out["local"] = local_out(state)
    # one Ranger step: its centralisation groups by output unit
    rstate, rsched = port_state(job["ranger_cfg"], job["sd"])
    rstate = tp.shard_state_tp(rstate, m2)
    rstep = tp.shard_train_step_tp(rstate, rsched, m2, grids_per_step=g)
    with torch.backends.mkldnn.flags(enabled=False):
        rstate, _ = rstep(rstate, job["batches"][0], job["draws"][0])
    out["ranger"] = gathered_out(tp.gather_state_tp(rstate), {})
    torch.save(out, path + f".rank{r}")
    torch.distributed.destroy_process_group()


def tiny_state(cfg, **kw):
    """A seeded one-process state of ``cfg`` with ``kw`` replaced."""
    torch.manual_seed(0)
    system = CrNerfSystem(dataclasses.replace(cfg, **kw))
    opt, sched = make_optimizer(system.cfg, 10, system.parameters())
    return TrainState.create(system, opt, cfg.N_vocab, 32,
                             cfg.nerf_out_dim), sched
