"""The content-constraint heads (``Config.encode_c``): the port's training
step against the JAX package's, the inference path that never runs them,
their weights through checkpoints, resume and the Lightning converter,
and one system step with Ranger against the JAX package's.

The steps run as tests/test_torch_train_step.py runs them (its config,
its replay of the JAX step's draws, the JAX step on its Pallas route in
interpret mode), with ``encode_c`` on, once with the style decode
(``encode_a``) and once without: there the unstyled decode is the fine
decode itself, so the term and enc_cont's gradient are exactly 0 on both
sides. The Ranger step is here too: a JAX step in a process that has
traced one already costs a fifth of the first.
"""

import dataclasses
import io
import json
import os

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
from crnerf_tpu.utils.checkpoint import save_weights_only
from crnerf_tpu.utils.torch_port import convert_state_dict as jax_convert
from crnerf_tpu_torch import Config as PortConfig
from crnerf_tpu_torch.render.inference import Renderer
from crnerf_tpu_torch.render.system import CrNerfSystem
from crnerf_tpu_torch.train.optim import make_optimizer
from crnerf_tpu_torch.train.state import TrainState
from crnerf_tpu_torch.train.step import make_train_step
from crnerf_tpu_torch.utils import weights as bridge
from crnerf_tpu_torch.utils.checkpoint import restore_state, state_payload
from crnerf_tpu_torch.utils.torch_port import convert_state_dict

torch.set_num_threads(2)

CASES = {"encode_a": dict(encode_c=True),
         "no_encode_a": dict(encode_c=True, encode_a=False)}
# the term is weightcontent (1e-4) x a mean square of embedding
# differences, ~1e-9 here, under the metrics' atol of 1e-7: held on its
# own, relative to its size, as the other terms are (1e-4 after step 1,
# 1e-3 after step 2)
CONTENT_RTOL = (1e-4, 1e-3)


def port_cfg(cfg):
    return PortConfig(**{f.name: getattr(cfg, f.name)
                         for f in dataclasses.fields(PortConfig)})


@pytest.fixture(scope="module", params=list(CASES))
def run(request):
    """Two steps of both packages at encode_c from the same weights,
    batches and draws; per step the metrics and, after step 1, both
    packages' gradients."""
    cfg = dataclasses.replace(CFG, **CASES[request.param])
    tcfg = port_cfg(cfg)
    scene = jax_scene(n_train=4, n_test=1, img_wh=(24, 18),
                      appearance_wh=cfg.appearance_wh)
    pipe = JaxPipeline(scene, batch_size=B)
    batches = [pipe.make_global_batch(0, i, G) for i in range(2)]
    jsys = JaxSystem(cfg)
    variables = jsys.init(jax.random.PRNGKey(0))
    assert "enc_cont" in variables["params"]
    tx, sched = jax_make_optimizer(cfg, pipe.iterations)
    jstate = JaxTrainState.create(
        variables, tx.init(variables["params"]), n_vocab=cfg.N_vocab,
        embed_hw=32, embed_c=cfg.nerf_out_dim, rng=jax.random.PRNGKey(1))
    jstep = jax.jit(jax_make_train_step(jsys, tx, sched, grids_per_step=G,
                                        grad_accum_chunks=1))
    system = bridge.load_into(CrNerfSystem(tcfg),
                              jax.tree.map(np.asarray, variables))
    opt, psched = make_optimizer(tcfg, pipe.iterations, system.parameters())
    pstate = TrainState.create(system, opt, tcfg.N_vocab, 32,
                               tcfg.nerf_out_dim)
    pstep = make_train_step(system, opt, psched, G, 1)
    steps = []
    for b in batches:
        draws = replay_draws(jstate.rng, jstate.embedding_valid)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()
                                    if k != "image_idx"})
        tb = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
        pstate, pm = pstep(pstate, tb, draws)
        steps.append(dict(
            jax_metrics={k: float(v) for k, v in jm.items()},
            port_metrics={k: float(v) for k, v in pm.items()},
            # Adam's first moment after step 1 is 0.1 g
            jax_grads={k: v / 0.1
                       for k, v in _flat(jstate.opt_state[0].mu).items()},
            port_grads=bridge.flatten(bridge.flax_from_state_dict(
                system, grads=True)["params"])))
    return dict(name=request.param, steps=steps, variables=variables,
                cfg=cfg)


@pytest.mark.parametrize("i", range(2))
def test_metrics_match(run, i):
    """Every metric of steps 1 and 2 under test_torch_train_step's bounds
    (1e-4 relative + 1e-7 after step 1, 1e-3 after step 2; PSNR 10x the
    relative bound in dB), and loss/content_constraint under
    ``CONTENT_RTOL`` alone."""
    jm, pm = run["steps"][i]["jax_metrics"], run["steps"][i]["port_metrics"]
    assert set(jm) == set(pm) and "loss/content_constraint" in pm
    rtol = 1e-4 if i == 0 else 1e-3
    for k in jm:
        tol = dict(rtol=rtol, atol=10 * rtol) if k == "psnr" else dict(
            rtol=rtol, atol=1e-7)
        np.testing.assert_allclose(pm[k], jm[k], err_msg=k, **tol)
    want, got = jm["loss/content_constraint"], pm["loss/content_constraint"]
    if run["name"] == "no_encode_a":
        assert want == got == 0.0
    else:
        assert want > 0
        np.testing.assert_allclose(got, want, rtol=CONTENT_RTOL[i], atol=0)


def test_per_leaf_gradients_match(run):
    """Step 1, per leaf: 2e-3 of the leaf's largest gradient plus 1e-7,
    CGNet's leaves 5e-2 (test_torch_train_step's bounds, whose docstring
    says why). enc_cont's gradients are of order weightcontent (its
    largest 2e-7), under that 1e-7: each of its leaves is held to 2e-3 of
    its own largest plus 1e-4 of enc_cont's largest, for conv7's bias,
    whose gradient is a cancellation at 1e-12 (measured: 1.5e-5 of a
    leaf's largest elsewhere, 6.5e-6 of enc_cont's largest there)."""
    jg, pg = run["steps"][0]["jax_grads"], run["steps"][0]["port_grads"]
    assert set(jg) == set(pg)
    enc = [k for k in jg if k.startswith("enc_cont.")]
    assert len(enc) == 14
    enc_scale = max(np.abs(jg[k]).max() for k in enc)
    for k in jg:
        assert jg[k].shape == pg[k].shape, k
        scale = np.abs(jg[k]).max()
        if k.startswith("enc_cont."):
            if run["name"] == "no_encode_a":
                assert scale == 0.0 and np.abs(pg[k]).max() == 0.0, k
                continue
            assert scale > 0, k
            np.testing.assert_allclose(
                pg[k], jg[k], atol=2e-3 * scale + 1e-4 * enc_scale, rtol=0,
                err_msg=k)
            continue
        rel = 5e-2 if k.startswith("implicit_mask.") else 2e-3
        np.testing.assert_allclose(pg[k], jg[k], atol=rel * scale + 1e-7,
                                   err_msg=k)


def _tiny(**kw):
    base = dict(batch_size=64, grids_per_step=2, N_samples=4, N_importance=4,
                netdepth=2, netwidth=16, nerf_out_dim=8, N_vocab=8,
                appearance_wh=(32, 24), chunk=256, encode_c=True)
    return PortConfig(**{**base, **kw})


def _tiny_run(cfg, seed=0):
    """A seeded system, optimizer and state on the CPU -> (state, step
    fn, the synthetic scene's pipeline)."""
    from crnerf_tpu_torch.data.pipeline import TrainPipeline
    from crnerf_tpu_torch.data.synthetic import make_synthetic_scene

    scene = make_synthetic_scene(n_train=4, n_test=1, img_wh=(24, 18),
                                 appearance_wh=cfg.appearance_wh)
    pipe = TrainPipeline(scene, batch_size=cfg.batch_size)
    torch.manual_seed(seed)
    system = CrNerfSystem(cfg)
    opt, sched = make_optimizer(cfg, pipe.iterations, system.parameters())
    state = TrainState.create(system, opt, cfg.N_vocab, 32, cfg.nerf_out_dim,
                              torch.Generator().manual_seed(seed + 1))
    step = make_train_step(system, opt, sched, cfg.grids_per_step, 1)
    return state, step, pipe


def _batch(pipe, i, g=2):
    return {k: torch.from_numpy(v)
            for k, v in pipe.make_global_batch(0, i, g).items()}


def test_inference_never_runs_the_content_heads():
    """``forward_eval`` and the Renderer give the same bits with encode_c
    on and off from the same weights, and enc_cont is not called."""
    on, off = _tiny(), _tiny(encode_c=False)
    torch.manual_seed(3)
    src = CrNerfSystem(on)
    variables = bridge.flax_from_state_dict(src)
    assert "enc_cont" in variables["params"]
    calls = []
    src.enc_cont.register_forward_hook(lambda *a: calls.append(1))
    other = bridge.load_into(CrNerfSystem(off), variables)
    assert other.enc_cont is None
    rng = np.random.default_rng(0)
    h, w = 6, 7
    rays = np.concatenate([rng.normal(0, 0.1, (h * w, 3)),
                           rng.normal(0, 1, (h * w, 3)),
                           np.full((h * w, 1), 2.0),
                           np.full((h * w, 1), 6.0)], 1).astype(np.float32)
    style = rng.uniform(-1, 1, (1, 24, 32, 3)).astype(np.float32)
    outs = [Renderer(c, s).render_frame(rays, style, (h, w))
            for c, s in ((on, src), (off, other))]
    assert outs[0].keys() == outs[1].keys() >= {"rgb", "depth", "mask"}
    for k in outs[0]:
        assert np.array_equal(outs[0][k], outs[1][k]), k
    assert calls == []


def test_weights_npz_holds_what_the_jax_bundle_holds(tmp_path):
    """The Trainer's inference bundle has the leaves of the JAX package's
    ``save_weights_only`` for the same config: enc_cont's too (the JAX
    bundle holds every parameter), and a system without the content heads
    loads it, leaving them out."""
    from crnerf_tpu_torch.data.synthetic import make_synthetic_scene
    from crnerf_tpu_torch.train.loop import Trainer

    cfg = _tiny(num_epochs=1, testit=True, save_dir=str(tmp_path),
                val_every_epochs=0)
    trainer = Trainer(cfg, make_synthetic_scene(
        n_train=2, n_test=1, img_wh=(16, 16),
        appearance_wh=cfg.appearance_wh), device="cpu")
    trainer.fit()
    path = os.path.join(trainer.ckpt.directory, "weights.npz")
    jcfg = dataclasses.replace(
        CFG, batch_size=64, N_samples=4, N_importance=4, netdepth=2,
        netwidth=16, nerf_out_dim=8, N_emb_xyz=15, appearance_wh=(32, 24),
        encode_c=True)
    jvars = JaxSystem(jcfg).init(jax.random.PRNGKey(0))
    jpath = str(tmp_path / "jax_weights.npz")
    save_weights_only(type("S", (), dict(params=jvars["params"],
                                         batch_stats=jvars["batch_stats"])),
                      jpath)
    with np.load(path) as got, np.load(jpath) as want:
        assert set(got.files) == set(want.files)
        assert any(k.startswith("params.enc_cont.") for k in got.files)
        for k in want.files:
            assert got[k].shape == want[k].shape, k
    sys_off = bridge.load_into(CrNerfSystem(_tiny(encode_c=False)), path)
    assert sys_off.enc_cont is None


def test_stop_and_restore_give_the_unstopped_bits():
    """Three steps straight against one step, a checkpoint payload through
    torch.save, a restore into a fresh state, and two more steps: the
    same bits in every parameter (enc_cont's included), Adam moment,
    cache row and the generator."""
    cfg = _tiny()
    a, step_a, pipe = _tiny_run(cfg)
    for i in range(3):
        a, _ = step_a(a, _batch(pipe, i))
    b, step_b, _ = _tiny_run(cfg)
    b, _ = step_b(b, _batch(pipe, 0))
    buf = io.BytesIO()
    torch.save(state_payload(b), buf)
    c, step_c, _ = _tiny_run(cfg, seed=9)
    buf.seek(0)
    restore_state(c, torch.load(buf, weights_only=False))
    assert c.step == 1
    for i in (1, 2):
        c, _ = step_c(c, _batch(pipe, i))
    pa, pc = a.system.state_dict(), c.system.state_dict()
    assert any(k.startswith("enc_cont.") for k in pa)
    for k in pa:
        assert torch.equal(pa[k], pc[k]), k
    sa, sc = a.optimizer.state_dict()["state"], c.optimizer.state_dict()[
        "state"]
    for i in sa:
        for k in sa[i]:
            assert torch.equal(torch.as_tensor(sa[i][k]),
                               torch.as_tensor(sc[i][k])), (i, k)
    assert torch.equal(a.embedding_cache, c.embedding_cache)
    assert torch.equal(a.generator.get_state(), c.generator.get_state())


def test_enc_cont_gradients_join_the_one_all_reduce(monkeypatch):
    """With a group the step averages every gradient, enc_cont's included,
    in one call of the flat all-reduce, and runs the content heads over
    the rank's G grids in one pass each (no per-grid loop): one decoder
    call and one enc_cont call a step."""
    from crnerf_tpu_torch.parallel import mesh

    cfg = _tiny()
    state, _, pipe = _tiny_run(cfg)
    calls, enc_calls = [], []
    monkeypatch.setattr(mesh, "world_size", lambda group: 1)
    monkeypatch.setattr(mesh, "rank", lambda group: 0)
    monkeypatch.setattr(mesh, "all_gather_rows", lambda x, group: x)
    monkeypatch.setattr(mesh, "all_reduce_mean_",
                        lambda ts, group: calls.append(list(ts)))
    state.system.enc_cont.register_forward_hook(
        lambda m, i, o: enc_calls.append(tuple(i[0].shape)))
    dec_calls = []
    state.system.decoder.decoder.register_forward_hook(
        lambda m, i, o: dec_calls.append(tuple(i[0].shape)))
    step = make_train_step(state.system, state.optimizer,
                           lambda s: cfg.lr, 2, 1, group=object())
    step(state, _batch(pipe, 0))
    assert len(calls) == 1
    grads = {id(t) for t in calls[0]}
    enc = [p for n, p in state.system.named_parameters()
           if n.startswith("enc_cont.")]
    assert len(enc) == 14 and all(id(p.grad) in grads for p in enc)
    # the coarse, fine, random and content maps of both grids in one
    # decode; the styled and unstyled fine images of both in one encode
    assert dec_calls == [(8, 8, 8, 8)]
    assert enc_calls == [(4, 8, 8, 3)]


def test_a_lightning_checkpoint_with_enc_cont_converts():
    """A reference state dict with an ``enc_cont`` prefix: the port's
    converter gives the JAX converter's tree, which loads into the port's
    content encoder weight for weight."""
    torch.manual_seed(4)
    src = CrNerfSystem(_tiny())
    sd = {}
    for k, v in src.enc_cont.state_dict().items():
        sd["enc_cont." + k.replace(".Conv_0.", ".")] = v.clone()
    params, stats = convert_state_dict(sd, netdepth=2)
    jparams, _ = jax_convert(sd, netdepth=2)
    got, want = bridge.flatten(params), bridge.flatten(jparams)
    assert got.keys() == want.keys() and not stats
    for k in got:
        assert np.array_equal(got[k], want[k]), k
    loaded = bridge.state_dict_from_flax({"params": params})
    for k, v in src.enc_cont.state_dict().items():
        assert torch.equal(loaded["enc_cont." + k], v), k


def test_train_cli_logs_the_content_term(tmp_path):
    """``python -m crnerf_tpu_torch train --encode_c`` on a tiny synthetic
    scene: every logged training row carries a finite
    loss/content_constraint, and the run ends with a final validation."""
    from crnerf_tpu_torch.apps import train as train_app

    argv = ["--device", "cpu", "--dataset_name", "synthetic",
            "--batch_size", "64", "--grids_per_step", "2", "--N_samples",
            "4", "--N_importance", "4", "--netdepth", "2", "--netwidth",
            "16", "--nerf_out_dim", "8", "--N_vocab", "10",
            "--appearance_wh", "32", "24", "--num_epochs", "1", "--chunk",
            "256", "--val_chunk", "256", "--save_dir", str(tmp_path),
            "--exp_name", "c", "--log_every", "2", "--encode_a", "--encode_c",
            "--encode_random", "--use_mask"]
    state = train_app.main(argv)
    assert state.system.enc_cont is not None and state.step > 2
    with open(tmp_path / "logs" / "c" / "metrics.jsonl") as f:
        rows = [json.loads(x) for x in f]
    train_rows = [r for r in rows if "train/loss" in r]
    assert train_rows
    for r in train_rows:
        v = r["loss/content_constraint"]
        assert np.isfinite(v) and v >= 0
    assert any("val/psnr" in r for r in rows)


@pytest.fixture(scope="module")
def ranger_step():
    """One step of both packages with Ranger, from the same weights, batch
    and draws (in this module: its JAX step shares the process's warm
    Pallas traces with ``run``'s)."""
    cfg = dataclasses.replace(CFG, optimizer="ranger")
    tcfg = port_cfg(cfg)
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
    draws = replay_draws(jstate.rng, jstate.embedding_valid)
    before = _flat(jstate.params)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()
                                if k != "image_idx"})
    system = bridge.load_into(CrNerfSystem(tcfg),
                              jax.tree.map(np.asarray, variables))
    opt, psched = make_optimizer(tcfg, pipe.iterations,
                                 system.parameters())
    state = TrainState.create(system, opt, tcfg.N_vocab, 32,
                              tcfg.nerf_out_dim)
    state, pm = make_train_step(system, opt, psched, G, 1)(
        state, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()},
        draws)
    mu = {n: opt.state[p]["exp_avg"] for n, p in system.named_parameters()}
    grads = {n: p.grad for n, p in system.named_parameters()}
    return dict(
        lr=float(sched(0)), before=before, jax_params=_flat(jstate.params),
        jax_mu=_flat(jstate.opt_state[1].mu),
        port_params=bridge.flatten(bridge.flax_from_state_dict(
            system)["params"]),
        port_mu=bridge.flatten(bridge.flax_from_state_dict(
            _with_params(system, mu))["params"]),
        port_grads=bridge.flatten(bridge.flax_from_state_dict(
            _with_params(system, grads))["params"]),
        jax_metrics={k: float(v) for k, v in jm.items()},
        port_metrics={k: float(v) for k, v in pm.items()})


def _with_params(system, values):
    """A copy of ``system`` whose parameters hold ``values`` (by name)."""
    import copy

    other = copy.deepcopy(system)
    with torch.no_grad():
        for n, p in other.named_parameters():
            p.copy_(values[n])
    return other


def test_ranger_system_step_matches_jax(ranger_step):
    """Step 1 with Ranger: the rectifier is off (rho 1 < 5), so the update
    is -lr times the centralised gradient, and Ranger's first moment is
    0.05 of it. Per leaf, both within 4e-3 of the leaf's largest raw
    gradient plus 2e-7 (twice test_torch_train_step's gradient bound: a
    centralised gradient is a difference of two gradients), CGNet's 1e-1;
    the metrics within 1e-4 relative. The parameter deltas, lr times that,
    plus two float32 ulps of the leaf's largest parameter (each delta is a
    difference of two rounded parameters)."""
    r = ranger_step
    jm, pm = r["jax_metrics"], r["port_metrics"]
    assert set(jm) == set(pm)
    for k in jm:
        tol = dict(rtol=1e-4, atol=1e-3) if k == "psnr" else dict(
            rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(pm[k], jm[k], err_msg=k, **tol)
    lr = r["lr"]
    assert set(r["jax_mu"]) == set(r["port_mu"])
    for k, want in r["jax_mu"].items():
        scale = np.abs(r["port_grads"][k]).max()
        rel = 1e-1 if k.startswith("implicit_mask.") else 4e-3
        bound = rel * scale + 2e-7
        np.testing.assert_allclose(r["port_mu"][k] / 0.05, want / 0.05,
                                   atol=bound, err_msg=k)
        d_j = r["jax_params"][k] - r["before"][k]
        d_p = r["port_params"][k] - r["before"][k]
        ulps = 2 * np.finfo(np.float32).eps * np.abs(r["before"][k]).max()
        np.testing.assert_allclose(d_p, d_j, atol=lr * bound + ulps,
                                   err_msg=k)
        if k.startswith(("nerf_coarse.", "nerf_fine.")) and want.ndim > 1:
            # centralised: zero mean over every axis but the output one
            assert np.abs(want.mean(axis=tuple(range(want.ndim - 1)))).max(
            ) <= 1e-6 * np.abs(want).max() + 1e-12, k
