"""The renderer's two per-point routes (crnerf_tpu_torch.render.renderer):
the fused MLP + composite, and the NerfMLP module + composite, against the
JAX package's render_rays on its matching branches (``fused_opts`` with
``full`` off and the Pallas fused-MLP kernels in interpret mode;
``fused_opts=None``, the flax module), at test time and in training with
the JAX key's draws replayed and injected, ``pertube_cord`` on and off; and
one served frame with ``pallas_render=False`` (and ``use_pallas=False``)
against the JAX slice.

N_emb_xyz=10, as tests/test_torch_slice.py (which says why): the two
frameworks round o + d*z one ulp apart. Tolerances: test time, the JAX
package's own for its fused route against its flax route
(tests/test_ops.py TestFusedRendererPath: features 2e-5, depth 5e-4; weights
2e-5); training outputs the same; gradients 2e-3 of each leaf's largest
plus 1e-7, as the step tests."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnerf_tpu.config import Config
from crnerf_tpu.core.rays import get_ray_directions, make_ray_buffer
from crnerf_tpu.models.nerf_mlp import NerfMLP as FlaxNerfMLP
from crnerf_tpu.render.inference import Renderer as JaxRenderer
from crnerf_tpu.render.renderer import render_rays as jax_render_rays
from crnerf_tpu.render.system import CrNerfSystem as JaxSystem
from crnerf_tpu_torch import Config as PortConfig
from crnerf_tpu_torch.models.nerf_mlp import NerfMLP
from crnerf_tpu_torch.ops import fused_mlp, fused_render
from crnerf_tpu_torch.render.camera_path import fov_intrinsics
from crnerf_tpu_torch.render.inference import Renderer
from crnerf_tpu_torch.render.renderer import render_rays, render_rays_train
from crnerf_tpu_torch.render.system import CrNerfSystem
from crnerf_tpu_torch.utils import weights as bridge
from crnerf_tpu_torch.utils.weights import load_into

torch.set_num_threads(2)

N, S, I = 40, 8, 8
F_XYZ, DEPTH, WIDTH, C = 10, 6, 32, 16
FEAT_TOL, DEPTH_TOL = 2e-5, 5e-4
KEYS = ("weights_coarse", "feature_coarse", "depth_coarse", "weights_fine",
        "feature_fine", "depth_fine")


@pytest.fixture(scope="module")
def nets():
    """Two flax MLPs (coarse, fine) with non-zero biases, and the port's
    modules carrying the same weights."""
    rng = np.random.default_rng(0)
    mlp = FlaxNerfMLP(depth=DEPTH, width=WIDTH, out_dim=C)
    params, modules = {}, {}
    for i, name in enumerate(("coarse", "fine")):
        v = mlp.init(jax.random.PRNGKey(i), jnp.zeros((1, 3 + 6 * F_XYZ)),
                     jnp.zeros((1, 27)))
        p = jax.tree.map(np.asarray, v["params"])
        for layer in p.values():
            layer["bias"] = rng.uniform(-0.3, 0.3, layer["bias"].shape
                                        ).astype(np.float32)
        params[name] = p
        modules[name] = load_into(
            NerfMLP(depth=DEPTH, width=WIDTH, out_dim=C,
                    in_channels_xyz=3 + 6 * F_XYZ), {"params": p})
    apply_fn = lambda p, x, d: mlp.apply({"params": p}, x, d)  # noqa: E731
    return apply_fn, params, modules


@pytest.fixture(scope="module")
def rays():
    rng = np.random.default_rng(1)
    o = rng.normal(size=(N, 3)) * 0.3
    d = rng.normal(size=(N, 3))
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([o, d, np.full((N, 1), 0.5), np.full((N, 1), 4.0)],
                          -1).astype(np.float32)


def _jax_fused_opts(train):
    return {"n_emb_dir": 4, "depth": DEPTH, "tile": 64, "interpret": True,
            "train": train, "full": False}


def _port_weights(route, modules, train):
    """What selects the route in the port: laid-out fused-MLP weights or
    live parameter views, or the modules."""
    out = {}
    for name, m in modules.items():
        if route == "module":
            out[name] = m
        elif train:
            out[name] = fused_render.mlp_params_from_module(m, detach=False)
        else:
            out[name] = fused_mlp.prepare_mlp_weights(
                fused_render.mlp_params_from_module(m), F_XYZ, 4,
                torch.float32, m.skips)
    return out


def _close(got, want):
    for k in KEYS:
        tol = DEPTH_TOL if k.startswith("depth") else FEAT_TOL
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), atol=tol, err_msg=k)


@pytest.mark.parametrize("route", ["mlp", "module"])
def test_render_rays_at_test_time_matches_jax(nets, rays, route):
    apply_fn, params, modules = nets
    want = jax_render_rays(
        apply_fn, apply_fn, params, jnp.asarray(rays), jax.random.PRNGKey(0),
        n_samples=S, n_importance=I, n_emb_xyz=F_XYZ, test_time=True,
        perturb=0.0, noise_std=0.0,
        fused_opts=_jax_fused_opts(False) if route == "mlp" else None)
    w = _port_weights(route, modules, train=False)
    with torch.no_grad():
        got = render_rays(w["coarse"], w["fine"], torch.from_numpy(rays),
                          n_samples=S, n_importance=I)
    _close(got, want)
    assert got["z_fine"].shape == (N, S + I)


def _replay(key, pertube):
    kz, kn_c, kn_f, kpdf, kp_c, kp_f = jax.random.split(key, 6)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    draws = {
        "z_u": t(jax.random.uniform(kz, (N, S), jnp.float32)),
        "noise_coarse": t(jax.random.normal(kn_c, (N, S), jnp.float32)),
        "noise_fine": t(jax.random.normal(kn_f, (N, S + I), jnp.float32)),
        "pdf_e": t(jax.random.exponential(kpdf, (N, I + 1),
                                          dtype=jnp.float32)),
    }
    if pertube:
        draws["pertube_coarse"] = t(jax.random.uniform(kp_c, (N, S, 3),
                                                       jnp.float32))
        draws["pertube_fine"] = t(jax.random.uniform(kp_f, (N, S + I, 3),
                                                     jnp.float32))
    return draws


@pytest.mark.parametrize("pertube", [False, True])
@pytest.mark.parametrize("route", ["mlp", "module"])
def test_render_rays_train_matches_jax_with_injected_draws(nets, rays, route,
                                                           pertube):
    """Outputs and the gradient of a loss that reads every output (the
    feature maps, the depths and the weights of both passes), with the
    sigma noise, the z perturbation, the resampling and (``pertube``) the
    coordinate jitter all drawn from the JAX key."""
    apply_fn, params, modules = nets
    key = jax.random.PRNGKey(5)
    rng = np.random.default_rng(2)
    cot = {k: (rng.normal(size=(N, *sh)) * 0.1).astype(np.float32)
           for k, sh in zip(KEYS, ((S,), (C,), (), (S + I,), (C,), ()))}

    def jax_loss(p):
        out = jax_render_rays(
            apply_fn, apply_fn, p, jnp.asarray(rays), key, n_samples=S,
            n_importance=I, n_emb_xyz=F_XYZ, pertube_cord=pertube,
            fused_opts=_jax_fused_opts(True) if route == "mlp" else None)
        return sum(jnp.sum(out[k] * cot[k]) for k in KEYS), out

    (_, want), g_want = jax.value_and_grad(jax_loss, has_aux=True)(params)
    for m in modules.values():
        m.zero_grad()
    w = _port_weights(route, modules, train=True)
    got = render_rays_train(
        w["coarse"], w["fine"], torch.from_numpy(rays), n_samples=S,
        n_importance=I, n_emb_xyz=F_XYZ, full=False, pertube_cord=pertube,
        draws=_replay(key, pertube))
    _close(got, want)
    sum((got[k] * torch.from_numpy(cot[k])).sum() for k in KEYS).backward()
    for name, m in modules.items():
        g_got = bridge.flatten(bridge.flax_from_state_dict(
            m, grads=True)["params"])
        g_ref = bridge.flatten(g_want[name])
        assert set(g_got) == set(g_ref)
        for k, a in g_ref.items():
            a = np.asarray(a)
            assert np.abs(a).max() > 0, (name, k)
            np.testing.assert_allclose(
                g_got[k], a, atol=2e-3 * np.abs(a).max() + 1e-7,
                err_msg=f"{name}.{k}")


def test_the_three_routes_agree_at_fp32(nets, rays):
    """At fp32 with the exact encode the three routes compute one
    function: full (fused render), fused MLP + composite, module +
    composite, from the same draws."""
    _, _, modules = nets
    draws = _replay(jax.random.PRNGKey(9), False)
    outs = []
    for route, full in (("mlp", True), ("mlp", False), ("module", False)):
        w = _port_weights(route, modules, train=True)
        outs.append(render_rays_train(
            w["coarse"], w["fine"], torch.from_numpy(rays), n_samples=S,
            n_importance=I, n_emb_xyz=F_XYZ, full=full, draws=draws))
    for other in outs[1:]:
        _close(other, {k: outs[0][k].detach().numpy() for k in KEYS})


# ---------------------------------------------------------- served frame
CFG = Config(
    N_samples=8, N_importance=8, netdepth=6, netwidth=32, nerf_out_dim=16,
    N_emb_xyz=10, appearance_wh=(64, 48), chunk=512, noise_std=0.0,
    encode_random=False, use_mask=True, compute_dtype="float32",
    pallas_interpret=True,
)
HW = (24, 32)
C2W = np.array([[1, 0, 0, 0.1], [0, 1, 0, -0.05], [0, 0, 1, 1.5]],
               np.float32)
# as tests/test_torch_slice.py: rgb in [0, 1], depth ~1.5
RGB_TOL, FRAME_DEPTH_TOL, MASK_TOL = 5e-4, 1e-3, 1e-5


@pytest.mark.parametrize("off", ["pallas_render", "use_pallas"])
def test_served_frame_matches_the_jax_slice(off):
    cfg = CFG.replace(**{off: False})
    tcfg = PortConfig(**{f.name: getattr(cfg, f.name)
                         for f in dataclasses.fields(PortConfig)})
    assert getattr(tcfg, off) is False
    variables = jax.tree.map(np.asarray,
                             JaxSystem(cfg).init(jax.random.PRNGKey(0)))
    wa, ha = cfg.appearance_wh
    style = np.random.default_rng(0).uniform(-1, 1, (1, ha, wa, 3)).astype(
        np.float32)
    K = fov_intrinsics((HW[1], HW[0]))
    frame_rays = make_ray_buffer(get_ray_directions(*HW, K), C2W, 0.5, 2.5,
                                 0)[:, :8]
    want = JaxRenderer(cfg, variables).render_frame(frame_rays, style, HW)
    system = load_into(CrNerfSystem(tcfg), variables).eval()
    r = Renderer(tcfg, system)
    kinds = {type(v).__name__ for v in r.kernel_weights().values()}
    assert kinds == ({"MlpKernelWeights"} if off == "pallas_render"
                     else {"NerfMLP"})
    got = r.render_frame(frame_rays, style, HW)
    np.testing.assert_allclose(got["rgb"], want["rgb"], atol=RGB_TOL)
    np.testing.assert_allclose(got["depth"], want["depth"],
                               atol=FRAME_DEPTH_TOL)
    np.testing.assert_allclose(got["mask"], want["mask"], atol=MASK_TOL)
