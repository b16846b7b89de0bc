"""One whole training step of the port's make_train_step on each of the two
per-point routes against the JAX package's step, from the same weights
(carried through the bridge), the same batch and the same random draws, at
a tiny fp32 config:

  pallas_render=False   the fused MLP pair (forward kernel, weight-gradient
                        backward kernel) per pass, compositing under
                        autograd; the JAX step runs its Pallas fused-MLP
                        kernels in interpret mode
  pallas_train=False    the NerfMLP module under autograd with remat; the
                        JAX step runs its flax module

The draws are replayed from the JAX state's key as
tests/test_torch_train_step.py does (which also says why N_emb_xyz=10), and
the bounds are that file's: metrics 1e-4 relative (PSNR 1e-3 dB), per-leaf
gradients 2e-3 of the leaf's largest plus 1e-7, CGNet's leaves 5e-2.
tests/test_torch_fused_mlp.py holds the kernels' math at 15 octaves."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_step import B, CFG, G, _flat, replay_draws

from crnerf_tpu.data.pipeline import TrainPipeline as JaxPipeline
from crnerf_tpu.data.synthetic import make_synthetic_scene as jax_scene
from crnerf_tpu.render.system import CrNerfSystem as JaxSystem
from crnerf_tpu.train.optim import make_optimizer as jax_make_optimizer
from crnerf_tpu.train.state import TrainState as JaxTrainState
from crnerf_tpu.train.step import make_train_step as jax_make_train_step
from crnerf_tpu_torch import Config as PortConfig
from crnerf_tpu_torch.ops import fused_mlp, fused_render
from crnerf_tpu_torch.render import renderer
from crnerf_tpu_torch.render.system import CrNerfSystem
from crnerf_tpu_torch.train.optim import make_optimizer
from crnerf_tpu_torch.train.state import TrainState
from crnerf_tpu_torch.train.step import make_train_step
from crnerf_tpu_torch.utils import weights as bridge

torch.set_num_threads(2)

# CFG, G, B and the replay of the JAX step's draws are that file's
ROUTES = {"pallas_render_off": dict(pallas_render=False),
          "pallas_render_off_pertube": dict(pallas_render=False,
                                            pertube_cord=True),
          "pallas_train_off": dict(pallas_train=False)}


@pytest.fixture(scope="module", params=list(ROUTES))
def route(request):
    """One step of both packages on a per-point route; the port's calls of
    the fused MLP pair, of the fused render and of the module are
    counted."""
    cfg = dataclasses.replace(CFG, **ROUTES[request.param])
    tcfg = PortConfig(**{f.name: getattr(cfg, f.name)
                         for f in dataclasses.fields(PortConfig)})
    assert (tcfg.pallas_render, tcfg.pallas_train, tcfg.remat) == (
        cfg.pallas_render, cfg.pallas_train, cfg.remat)
    scene = jax_scene(n_train=4, n_test=1, img_wh=(24, 18),
                      appearance_wh=cfg.appearance_wh)
    pipe = JaxPipeline(scene, batch_size=B)
    batch = pipe.make_global_batch(0, 0, G)
    jsys = JaxSystem(cfg)
    variables = jsys.init(jax.random.PRNGKey(0))
    tx, sched = jax_make_optimizer(cfg, pipe.iterations)
    jstate = JaxTrainState.create(
        variables, tx.init(variables["params"]), n_vocab=cfg.N_vocab,
        embed_hw=32, embed_c=cfg.nerf_out_dim, rng=jax.random.PRNGKey(1))
    jstep = jax.jit(jax_make_train_step(jsys, tx, sched, grids_per_step=G,
                                        grad_accum_chunks=1))
    draws = replay_draws(jstate.rng, jstate.embedding_valid,
                         cfg.pertube_cord)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()
                                if k != "image_idx"})
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    system = bridge.load_into(CrNerfSystem(tcfg),
                              jax.tree.map(np.asarray, variables))
    opt, psched = make_optimizer(tcfg, pipe.iterations, system.parameters())
    state = TrainState.create(system, opt, tcfg.N_vocab, 32,
                              tcfg.nerf_out_dim)
    calls = {"mlp_fwd": [], "mlp_bwd": [], "render_fwd": 0, "module": 0,
             "mlp_fwd_variant": []}
    with pytest.MonkeyPatch.context() as mp:
        real_fwd, real_bwd = (fused_mlp.mlp_fwd, fused_mlp.fused_mlp_bwd)
        real_render, real_module = (fused_render.render_fwd,
                                    renderer._module_points)

        def count_fwd(mkw, xyz, dirs, exact, dir_rep, p_base=0,
                      variant=None):
            calls["mlp_fwd"].append((tuple(xyz.shape), tuple(dirs.shape),
                                     dir_rep))
            calls["mlp_fwd_variant"].append(variant)
            return real_fwd(mkw, xyz, dirs, exact, dir_rep, p_base, variant)

        def count_bwd(mkw, xyz, dirs, g_feat, g_sigma, *a):
            calls["mlp_bwd"].append((tuple(g_feat.shape),
                                     tuple(g_sigma.shape)))
            return real_bwd(mkw, xyz, dirs, g_feat, g_sigma, *a)

        def count_render(*a, **k):
            calls["render_fwd"] += 1
            return real_render(*a, **k)

        def count_module(*a, **k):
            calls["module"] += 1
            return real_module(*a, **k)

        mp.setattr(fused_mlp, "mlp_fwd", count_fwd)
        mp.setattr(fused_mlp, "fused_mlp_bwd", count_bwd)
        mp.setattr(fused_render, "render_fwd", count_render)
        mp.setattr(renderer, "_module_points", count_module)
        state, pm = make_train_step(system, opt, psched, G, 1)(state, tb,
                                                               draws)
    return dict(
        cfg=cfg, calls=calls,
        port_metrics={k: float(v) for k, v in pm.items()},
        port_grads=bridge.flatten(bridge.flax_from_state_dict(
            system, grads=True)["params"]),
        jax_metrics={k: float(v) for k, v in jm.items()},
        # Adam's first moment after step 1 is (1 - b1) g
        jax_grads={k: v / 0.1
                   for k, v in _flat(jstate.opt_state[0].mu).items()})


def test_route_metrics_match(route):
    jm, pm = route["jax_metrics"], route["port_metrics"]
    assert set(jm) == set(pm)
    for k in jm:
        tol = dict(rtol=1e-4, atol=1e-3) if k == "psnr" else dict(
            rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(pm[k], jm[k], err_msg=k, **tol)


def test_route_per_leaf_gradients_match(route):
    jg, pg = route["jax_grads"], route["port_grads"]
    assert set(jg) == set(pg)
    for k in jg:
        scale = np.abs(jg[k]).max()
        rel = 5e-2 if k.startswith("implicit_mask.") else 2e-3
        np.testing.assert_allclose(pg[k], jg[k], atol=rel * scale + 1e-7,
                                   err_msg=k)
    nerf = [k for k in jg if k.startswith(("nerf_coarse.", "nerf_fine."))]
    assert len(nerf) >= 40
    assert all(float(np.abs(jg[k]).max()) > 0 for k in nerf)


def test_route_runs_what_the_config_selects(route):
    """pallas_render=False: one fused-MLP forward (naming the backward's
    variant, whose stash form the backward recomputes: mma.sync at this
    fp32 config) and one backward per
    pass, per point over all G*B rays with one direction per ray, and no
    fused render; pallas_train=False: the module twice and no kernel
    wrapper at all."""
    calls, cfg = route["calls"], route["cfg"]
    s, i, c = cfg.N_samples, cfg.N_importance, cfg.nerf_out_dim
    n = G * B
    assert calls["render_fwd"] == 0
    if cfg.pallas_train:
        assert calls["module"] == 0
        assert calls["mlp_fwd"] == [((n * s, 3), (n, 3), s),
                                    ((n * (s + i), 3), (n, 3), s + i)]
        assert calls["mlp_fwd_variant"] == ["mma", "mma"]
        assert sorted(calls["mlp_bwd"]) == [((n * s, c), (n * s,)),
                                            ((n * (s + i), c),
                                             (n * (s + i),))]
    else:
        assert calls["module"] == 2
        assert calls["mlp_fwd"] == [] and calls["mlp_bwd"] == []
