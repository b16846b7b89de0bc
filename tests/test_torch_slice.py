"""The serving slice end to end: the port's Renderer and RenderService
against crnerf_tpu's, from the same weights (carried through the bridge),
at a tiny fp32 config. The JAX side runs twice: on its plain path and
through the Pallas render kernel in interpret mode."""

import base64
import dataclasses
import io
import threading

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from crnerf_tpu.apps.serve import RenderService as JaxRenderService
from crnerf_tpu.config import Config
from crnerf_tpu.core.rays import get_ray_directions, make_ray_buffer
from crnerf_tpu.render.inference import Renderer as JaxRenderer
from crnerf_tpu.render.system import CrNerfSystem as JaxSystem
from crnerf_tpu_torch import Config as PortConfig
from crnerf_tpu_torch.apps.serve import RenderService, Server, png_bytes, request
from crnerf_tpu_torch.ops import fused_render
from crnerf_tpu_torch.render.camera_path import fov_intrinsics
from crnerf_tpu_torch.render.inference import Renderer
from crnerf_tpu_torch.render.system import CrNerfSystem
from crnerf_tpu_torch.utils.weights import load_into

torch.set_num_threads(2)

# N_emb_xyz=10: at the default 15 the top octave multiplies x by 2^14, and
# the two frameworks' one-ulp differences in x (XLA rewrites o + d*z and
# linspace's division) become ~1e-2 in sin(2^14 x) and ~3e-3 in depth.
# tests/test_torch_fused_render.py holds the kernel's math to the JAX
# kernel at 15 octaves on inputs where x is exact.
CFG = Config(
    N_samples=8, N_importance=8, netdepth=6, netwidth=32, nerf_out_dim=16,
    N_emb_xyz=10, appearance_wh=(64, 48), chunk=512, noise_std=0.0,
    encode_random=False, use_mask=True, compute_dtype="float32",
)
HW = (24, 32)                     # (h, w): 768 rays, two port tiles
C2W = np.array([[1, 0, 0, 0.1], [0, 1, 0, -0.05], [0, 0, 1, 1.5]],
               np.float32)
NEAR, FAR = 0.5, 2.5
# rgb in [0, 1]: 5e-4 covers fp32 summation order through the MLP, the
# compositing and the style statistics; depth (~1.5) 1e-3; u8 frames
# differ by at most one level (truncation at a boundary).
RGB_TOL, DEPTH_TOL, MASK_TOL = 5e-4, 1e-3, 1e-5


def port_cfg(cfg: Config) -> PortConfig:
    """The port's Config with the JAX Config's values for its fields."""
    return PortConfig(**{f.name: getattr(cfg, f.name)
                         for f in dataclasses.fields(PortConfig)})


TCFG = port_cfg(CFG)


@pytest.fixture(scope="module")
def variables():
    v = JaxSystem(CFG).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, v)


@pytest.fixture(scope="module")
def style():
    wa, ha = CFG.appearance_wh
    return np.random.default_rng(0).uniform(-1, 1, (1, ha, wa, 3)).astype(
        np.float32)


@pytest.fixture(scope="module")
def system(variables):
    return load_into(CrNerfSystem(TCFG), variables).eval()


def _jax_cfgs():
    return {"plain": CFG, "pallas": CFG.replace(pallas_interpret=True)}


@pytest.fixture(scope="module")
def jax_frames(variables, style):
    """Full-output renders of the host-ray frame on both JAX paths."""
    K = fov_intrinsics((HW[1], HW[0]))
    rays = make_ray_buffer(get_ray_directions(*HW, K), C2W, NEAR, FAR,
                           0)[:, :8]
    out = {name: JaxRenderer(cfg, variables).render_frame(rays, style, HW)
           for name, cfg in _jax_cfgs().items()}
    return rays, out


def test_render_frame_matches_jax(system, style, jax_frames):
    rays, ref = jax_frames
    before = fused_render.LAUNCH_COUNTS["fused_render_fwd"]
    got = Renderer(TCFG, system).render_frame(rays, style, HW)
    assert fused_render.LAUNCH_COUNTS["fused_render_fwd"] == before
    assert got["rgb"].shape == (*HW, 3) and got["mask"].shape == HW
    for name, r in ref.items():
        np.testing.assert_allclose(got["rgb"], r["rgb"], atol=RGB_TOL,
                                   err_msg=name)
        np.testing.assert_allclose(got["depth"], r["depth"],
                                   atol=DEPTH_TOL, err_msg=name)
        np.testing.assert_allclose(got["mask"], r["mask"], atol=MASK_TOL,
                                   err_msg=name)


# The served compute dtype. N_emb_xyz=4: with fewer octaves a one-ulp
# difference in x no longer flips bf16 roundings of the encode. The JAX
# side runs in its own process with XLA's excess precision off: by default
# XLA on the CPU drops a bf16 rounding where a bf16 result is next widened
# to fp32 (the StyleNet decode has several), which moves rgb by ~2e-4, as
# much as computing the port at fp32 does. It takes the Pallas route, whose
# dtype policy the port's kernel follows (the plain flax route keeps sigma
# at fp32 and is another computation at bf16).
CFG_BF16 = CFG.replace(compute_dtype="bfloat16", N_emb_xyz=4,
                       pallas_interpret=True)
_JAX_RENDER = """
import sys
import numpy as np
from crnerf_tpu.config import Config
from crnerf_tpu.render.inference import Renderer
from crnerf_tpu.utils.checkpoint import load_weights_only
cfg = Config.from_json(open(sys.argv[1]).read())
inp = np.load(sys.argv[2])
out = Renderer(cfg, load_weights_only(sys.argv[3])).render_frame(
    inp["rays"], inp["style"], tuple(inp["hw"]))
np.savez(sys.argv[4], **out)
"""


@pytest.fixture(scope="module")
def bf16_case(tmp_path_factory, style, jax_frames):
    import os
    import subprocess
    import sys

    from crnerf_tpu_torch.utils import weights as bridge

    d = tmp_path_factory.mktemp("bf16")
    v = jax.tree.map(np.asarray,
                     JaxSystem(CFG_BF16).init(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(7)
    flat = bridge.flatten(v)
    for k, a in flat.items():   # flax initialises biases to zero
        if k.endswith("bias"):
            flat[k] = rng.uniform(-0.3, 0.3, a.shape).astype(np.float32)
    weights = str(d / "weights.npz")
    bridge.save_npz(bridge.unflatten(flat), weights)
    rays = jax_frames[0]
    (d / "cfg.json").write_text(CFG_BF16.to_json())
    np.savez(d / "in.npz", rays=rays, style=style, hw=np.asarray(HW))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_allow_excess_precision=false"))
    out = subprocess.run(
        [sys.executable, "-c", _JAX_RENDER, str(d / "cfg.json"),
         str(d / "in.npz"), weights, str(d / "out.npz")],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return weights, rays, dict(np.load(d / "out.npz"))


def _port_frame(weights, rays, style, compute_dtype):
    cfg = port_cfg(CFG_BF16.replace(compute_dtype=compute_dtype))
    system = load_into(CrNerfSystem(cfg), weights).eval()
    return Renderer(cfg, system).render_frame(rays, style, HW)


def _mean_max(a, b):
    d = np.abs(a - b)
    return d.mean(), d.max()


def test_render_frame_bf16_matches_jax(bf16_case, style):
    """Measured: rgb mean 2.6e-5, max 1.6e-3; depth mean 5.1e-7, max
    5.9e-5 at bf16. The port computed at fp32 against the same bf16 frame:
    rgb mean 3.1e-4, max 1.5e-3; depth mean 1.4e-4, max 5.2e-4. The mean
    bounds and the depth max bound separate the two; the rgb max bound is
    a ceiling."""
    weights, rays, ref = bf16_case
    got = _port_frame(weights, rays, style, "bfloat16")
    rgb_mean, rgb_max = _mean_max(got["rgb"], ref["rgb"])
    depth_mean, depth_max = _mean_max(got["depth"], ref["depth"])
    assert rgb_mean <= 1e-4 and rgb_max <= 3e-3, (rgb_mean, rgb_max)
    assert depth_mean <= 1e-5 and depth_max <= 2e-4, (depth_mean, depth_max)
    np.testing.assert_allclose(got["mask"], ref["mask"], atol=MASK_TOL)


def _decode_png(b64: str) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def _render_req(**extra):
    return {"op": "render", "wh": [HW[1], HW[0]], "c2w": C2W.tolist(),
            "fov": 60.0, "near": NEAR, "far": FAR, "style_id": "s",
            **extra}


@pytest.fixture(scope="module")
def service(system, style):
    svc = RenderService(TCFG, system)
    svc.styles["s"] = style
    return svc


def test_service_render_inline_matches_jax(service, variables, style):
    r = service.handle(_render_req(inline=True))
    assert r["ok"], r
    img = _decode_png(r["png_b64"])
    assert img.shape == (*HW, 3) and img.dtype == np.uint8
    # the PNG holds exactly the renderer's u8 frame
    u8 = service.renderer.fetch(service.renderer.render_frame_cam_async(
        C2W, fov_intrinsics((HW[1], HW[0])), NEAR, FAR, HW, style,
        outputs="rgb_u8"))["rgb_u8"]
    np.testing.assert_array_equal(img, u8)
    for name, cfg in _jax_cfgs().items():
        jsvc = JaxRenderService(cfg, variables)
        jsvc.styles["s"] = style
        jr = jsvc.handle(_render_req(inline=True))
        assert jr["ok"], jr
        diff = np.abs(img.astype(int) - _decode_png(jr["png_b64"]))
        assert diff.max() <= 1, (name, diff.max())


def test_service_ops(service, tmp_path):
    ping = service.handle({"op": "ping"})
    assert ping["ok"] and ping["device"] == "cpu" and ping["styles"] == ["s"]
    out = tmp_path / "f.png"
    r = service.handle(_render_req(out_path=str(out)))
    assert r["ok"] and r["wh"] == [HW[1], HW[0]] and r["ms"] > 0
    assert np.asarray(Image.open(out)).shape == (*HW, 3)
    st = service.handle({"op": "stats"})
    assert st["ok"] and st["renders"] >= 1 and st["p50_ms"] > 0
    for bad, msg in [({"op": "nope"}, "unknown op"),
                     (_render_req(), "inline"),
                     (_render_req(inline=True, style_id="x"), "style_id"),
                     (_render_req(inline=True, c2w=[[1, 0]]), "c2w")]:
        resp = service.handle(bad)
        assert not resp["ok"] and msg in resp["error"], resp


def test_sandbox_refuses_escaping_paths(system, style, tmp_path):
    svc = RenderService(TCFG, system, root=str(tmp_path))
    svc.styles["s"] = style
    r = svc.handle(_render_req(out_path=str(tmp_path.parent / "x.png")))
    assert not r["ok"] and "escapes" in r["error"]


def test_tcp_round_trip_and_shutdown(service):
    server = Server(service, "127.0.0.1", 0)
    host, port = server.server_address
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        assert request(host, port, {"op": "ping"})["ok"]
        assert request(host, port, {"op": "shutdown"})["shutting_down"]
        t.join(timeout=30)
        assert not t.is_alive()
    finally:
        server.server_close()
        service._shutdown.clear()


def test_png_writer_round_trip():
    rgb = np.random.default_rng(1).integers(0, 256, (7, 5, 3), np.uint8)
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(png_bytes(rgb)))), rgb)


def test_cli_serves_a_weights_npz(tmp_path):
    """python -m crnerf_tpu_torch serve: load a weights.npz through the
    bridge, answer encode_style / render / shutdown over TCP."""
    import os
    import subprocess
    import sys

    from crnerf_tpu_torch.utils.weights import flax_from_state_dict, save_npz

    args = ["--N_samples", "8", "--N_importance", "8", "--netdepth", "2",
            "--netwidth", "32", "--nerf_out_dim", "16", "--appearance_wh",
            "64", "48", "--compute_dtype", "float32"]
    cfg = PortConfig(N_samples=8, N_importance=8, netdepth=2, netwidth=32,
                     nerf_out_dim=16, appearance_wh=(64, 48), use_mask=False)
    torch.manual_seed(0)
    ckpt = str(tmp_path / "weights.npz")
    save_npz(flax_from_state_dict(CrNerfSystem(cfg)), ckpt)
    style_png = tmp_path / "style.png"
    style_png.write_bytes(png_bytes(np.random.default_rng(2).integers(
        0, 256, (48, 64, 3), np.uint8)))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "crnerf_tpu_torch", "serve", "--ckpt_path",
         ckpt, "--port", "0", "--device", "cpu", *args],
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on"), (line, proc.stderr.read())
        host, port = line.split()[2].rsplit(":", 1)
        r = request(host, int(port), {"op": "encode_style", "id": "a",
                                      "image_path": str(style_png)})
        assert r["ok"] and r["styles"] == ["a"], r
        r = request(host, int(port), {"op": "render", "wh": [16, 12],
                                      "c2w": C2W.tolist(), "style_id": "a",
                                      "inline": True})
        assert r["ok"] and _decode_png(r["png_b64"]).shape == (12, 16, 3)
        assert request(host, int(port), {"op": "shutdown"})["ok"]
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
