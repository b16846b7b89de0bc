"""The port's RAdam and Ranger (``crnerf_tpu_torch/train/optim.py``)
against the JAX package's ``make_optimizer`` (optax's radam; its own
ranger: gradient centralisation, Ranger's RAdam, decoupled weight decay,
slow-weight Lookahead), the schedule's warmup rule, and a resume across a
Lookahead sync. One system step with Ranger against the JAX step is in
tests/test_torch_encode_c.py, beside the other JAX steps.

The trajectories run on the same gradients in both packages, each leaf in
its own framework's layout: flax's (in, out) and HWIO kernels on the JAX
side, their ``state_dict_from_flax`` transposes here.
"""

import inspect
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_encode_c import _batch, _tiny, _tiny_run

from crnerf_tpu.config import Config as JaxConfig
from crnerf_tpu.train import optim as jax_optim
from crnerf_tpu_torch import Config
from crnerf_tpu_torch.render.system import CrNerfSystem
from crnerf_tpu_torch.train import optim
from crnerf_tpu_torch.utils import weights as bridge
from crnerf_tpu_torch.utils.checkpoint import restore_state, state_payload

torch.set_num_threads(2)

N_UPDATES = 25   # Lookahead syncs at 6, 12, 18 and 24
ITERS = 10       # steps an epoch: the cosine rate moves at 10 and 20


def _tree(rng):
    """A flax params tree with every layout the system has: Dense and
    Conv kernels (GC applies), biases and scales (it does not)."""
    return {"dense": {"kernel": rng.normal(size=(5, 3)),
                      "bias": rng.normal(size=(3,))},
            "conv": {"kernel": rng.normal(size=(3, 3, 2, 4)),
                     "bias": rng.normal(size=(4,))},
            "norm": {"scale": rng.normal(size=(4,))}}


def _to_torch(tree, dtype):
    """flax tree -> {state_dict name: tensor} at ``dtype``, in
    ``state_dict_from_flax``'s layouts (its float32 values are checked
    against these)."""
    sd32 = bridge.state_dict_from_flax({"params": tree})
    out = {}
    for name, leaf in bridge.flatten(tree).items():
        *path, kind = name.split(".")
        t = torch.from_numpy(np.array(leaf, np.float64))
        if kind == "kernel":
            t = t.T if t.dim() == 2 else t.permute(3, 2, 0, 1)
        key = ".".join(path + [bridge._TO_TORCH[kind]])
        assert torch.equal(t.float().contiguous(), sd32[key]), key
        out[key] = t.to(dtype).contiguous()
    return out


def _updates(seed=0):
    rng = np.random.default_rng(seed)
    return _tree(rng), [_tree(rng) for _ in range(N_UPDATES)]


def _jax_trajectory(name, wd, x64):
    """The JAX package's optimizer over ``_updates`` -> (the params after
    each update in the torch layout at float64, the rate of each update).
    Its schedule computes in float32 (``jnp.asarray(step, jnp.float32)``)
    also under x64."""
    p0, grads = _updates()
    jdt = jnp.float64 if x64 else jnp.float32
    cfg = JaxConfig(optimizer=name, weight_decay=wd, lr=0.01, num_epochs=3)
    traj = []
    with jax.enable_x64(x64):
        tx, sched = jax_optim.make_optimizer(cfg, ITERS)
        params = jax.tree.map(lambda a: jnp.asarray(a, jdt), p0)
        st = tx.init(params)
        for g in grads:
            u, st = tx.update(jax.tree.map(lambda a: jnp.asarray(a, jdt), g),
                              st, params)
            params = jax.tree.map(lambda a, b: a + b, params, u)
            traj.append(_to_torch(jax.tree.map(np.asarray, params),
                                  torch.float64))
        lrs = [float(sched(i)) for i in range(N_UPDATES)]
    return traj, lrs


def _port_trajectory(name, wd, dtype, lrs):
    """The port's optimizer over ``_updates`` at ``dtype``, each update at
    the rate given -> the params after each update, at float64."""
    p0, grads = _updates()
    params = {k: torch.nn.Parameter(v)
              for k, v in _to_torch(p0, dtype).items()}
    cfg = Config(optimizer=name, weight_decay=wd, lr=0.01, num_epochs=3)
    opt, _ = optim.make_optimizer(cfg, ITERS, params.values())
    assert type(opt) is {"radam": optim.RAdam, "ranger": optim.Ranger}[name]
    traj = []
    for g, lr in zip(grads, lrs):
        for k, v in _to_torch(g, dtype).items():
            params[k].grad = v
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        traj.append({k: v.detach().double().clone()
                     for k, v in params.items()})
    return traj


@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("name", ["radam", "ranger"])
def test_trajectory_matches_jax_at_float64(name, wd):
    """Both packages at float64 on the same gradients and rates: every
    parameter after every update within rtol 1e-10 (atol 1e-12), across
    the cosine schedule's epoch steps and Ranger's Lookahead syncs."""
    want, lrs = _jax_trajectory(name, wd, True)
    for i, got in enumerate(_port_trajectory(name, wd, torch.float64, lrs)):
        for k in want[i]:
            np.testing.assert_allclose(got[k].numpy(), want[i][k].numpy(),
                                       rtol=1e-10, atol=1e-12,
                                       err_msg=f"update {i + 1} {k}")


@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("name", ["radam", "ranger"])
def test_trajectory_matches_jax_at_float32(name, wd):
    """The port at float32 against the JAX trajectory at float64: rtol
    1e-6, atol 1e-7 (measured 4.2e-7 of |p| + 0.1). The JAX package at
    float32 is not held to it: optax computes the step's scalars at
    float32, and rho = rho_inf - 2 t b2^t / (1 - b2^t) cancels 1999 against
    ~1993 at the first rectified steps, so its float32 trajectory leaves
    its float64 one by more than 1e-5 (measured 4.1e-5); the port computes
    the scalars on the host at float64."""
    want, lrs = _jax_trajectory(name, wd, True)
    for i, got in enumerate(_port_trajectory(name, wd, torch.float32, lrs)):
        for k in want[i]:
            np.testing.assert_allclose(got[k].numpy(), want[i][k].numpy(),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"update {i + 1} {k}")
    jax32, _ = _jax_trajectory(name, wd, False)
    worst = max(float(np.max(np.abs(a[k].numpy() - b[k].numpy())
                             / (np.abs(b[k].numpy()) + 0.1)))
                for a, b in zip(jax32, want) for k in b)
    assert worst > 1e-5


def test_torch_radam_is_another_function():
    """``torch.optim.RAdam`` is not optax's radam (eps placement, the
    rectifier's threshold): on gradients of rounding-noise size it moves
    the parameters elsewhere, which is why the port has its own."""
    p0 = torch.zeros(4, dtype=torch.float64)
    g = torch.tensor([1e-9, -3e-9, 2e-10, 5e-9], dtype=torch.float64)
    outs = []
    for cls in (optim.RAdam, torch.optim.RAdam):
        p = torch.nn.Parameter(p0.clone())
        opt = cls([p], lr=0.01, eps=1e-8)
        for _ in range(8):
            p.grad = g.clone()
            opt.step()
        outs.append(p.detach().clone())
    assert not torch.allclose(outs[0], outs[1], rtol=1e-3, atol=0)


def test_lookahead_sync_behavior():
    """The numbers of the JAX package's test of its lookahead: k = 3,
    alpha 0.5, an inner update of +1 a step, slow weights from the start:
    1, 2, sync(0 + .5 (3 - 0)) = 1.5, 2.5, 3.5, sync(1.5 + .5 (4.5 - 1.5))
    = 3."""
    p = [torch.zeros(2, dtype=torch.float64)]
    slow = [p[0].clone()]
    seen = []
    for count in range(1, 7):
        p[0] += 1.0
        if count % 3 == 0:
            optim.lookahead_(p, slow, 0.5)
        seen.append(float(p[0][0]))
    assert seen == [1.0, 2.0, 1.5, 2.5, 3.5, 3.0]
    assert slow[0].tolist() == [3.0, 3.0]
    # the port's constants are the defaults of the JAX package's ranger
    # and its parts (no Config option sets them)
    want = {**_defaults(jax_optim.scale_by_ranger_radam),
            **_defaults(jax_optim.ranger)}
    assert (optim.LOOKAHEAD_K, optim.LOOKAHEAD_ALPHA, optim.RANGER_BETAS,
            optim.RECTIFY_AT) == (want["k"], want["alpha"],
                                  (want["b1"], want["b2"]),
                                  want["threshold"]) == (6, 0.5, (0.95, 0.999),
                                                         5.0)


def _defaults(fn):
    return {k: v.default for k, v in inspect.signature(fn).parameters.items()
            if v.default is not inspect.Parameter.empty}


@pytest.mark.parametrize("name", ["sgd", "adam", "radam", "ranger"])
def test_schedule_matches_jax_across_a_warmup(name):
    """Two warmup epochs of multiplier 4 then cosine: the JAX package's
    rate at every step of 7 epochs of 10 steps (float32 there: rtol 1e-6).
    radam and ranger skip the warmup (their rectifier is one)."""
    kw = dict(optimizer=name, warmup_epochs=2, warmup_multiplier=4.0,
              num_epochs=5, lr=5e-4)
    want = jax_optim.make_lr_schedule(JaxConfig(**kw), ITERS)
    got = optim.make_lr_schedule(Config(**kw), ITERS)
    plain = optim.make_lr_schedule(Config(**{**kw, "warmup_epochs": 0}),
                                   ITERS)
    for step in range(70):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   err_msg=f"step {step}")
        if name in ("radam", "ranger"):
            assert got(step) == plain(step)
    assert (got(15) == plain(15)) == (name in ("radam", "ranger"))


def test_centralisation_groups_every_system_parameter_as_flax_does():
    """Every parameter of a system with every head (content heads and
    CGNet too): the port's centralisation of gradients in the torch
    layout equals the JAX package's ``gradient_centralization`` of the
    same gradients in the flax layout, carried by ``state_dict_from_flax``
    (1e-6 at float32)."""
    cfg = Config(batch_size=64, N_samples=4, N_importance=4, netdepth=2,
                 netwidth=16, nerf_out_dim=8, appearance_wh=(32, 24),
                 encode_c=True)
    system = CrNerfSystem(cfg)
    tree = bridge.flax_from_state_dict(system)["params"]
    rng = np.random.default_rng(1)
    grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
        np.float32), tree)
    tx = jax_optim.gradient_centralization()
    want, _ = tx.update(jax.tree.map(jnp.asarray, grads), tx.init(None))
    want = bridge.state_dict_from_flax(
        {"params": jax.tree.map(np.asarray, want)})
    tgrads = bridge.state_dict_from_flax({"params": grads})
    names = [n for n, _ in system.named_parameters()]
    assert set(names) == set(tgrads)
    got = optim.centralize([tgrads[n] for n in names])
    assert sum(g.dim() > 1 for g in got) > 40
    for n, g in zip(names, got):
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), atol=1e-6,
                                   err_msg=n)


def test_resume_across_a_lookahead_sync_keeps_the_bits():
    """Seven Ranger steps straight against four, a checkpoint through
    torch.save, a restore into a fresh state and three more (the sync at
    step 6 after the restore): the same bits in every parameter, moment,
    slow weight and count."""
    cfg = _tiny(optimizer="ranger")
    a, step_a, pipe = _tiny_run(cfg)
    for i in range(7):
        a, _ = step_a(a, _batch(pipe, i))
    b, step_b, _ = _tiny_run(cfg)
    for i in range(4):
        b, _ = step_b(b, _batch(pipe, i))
    buf = io.BytesIO()
    torch.save(state_payload(b), buf)
    buf.seek(0)
    c, step_c, _ = _tiny_run(cfg, seed=5)
    restore_state(c, torch.load(buf, weights_only=False))
    for i in range(4, 7):
        c, _ = step_c(c, _batch(pipe, i))
    for k, v in a.system.state_dict().items():
        assert torch.equal(v, c.system.state_dict()[k]), k
    sa, sc = a.optimizer.state_dict(), c.optimizer.state_dict()
    assert sa["state"].keys() == sc["state"].keys()
    for i, st in sa["state"].items():
        assert set(st) == {"step", "exp_avg", "exp_avg_sq", "slow_buffer"}
        assert st["step"] == sc["state"][i]["step"] == 7
        for k in ("exp_avg", "exp_avg_sq", "slow_buffer"):
            assert torch.equal(st[k], sc["state"][i][k]), (i, k)
    assert torch.equal(a.embedding_cache, c.embedding_cache)
