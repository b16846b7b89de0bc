"""The port's CUDA kernel on the card, against its plain PyTorch version,
at small shapes. Skipped without a CUDA device. The card has no jax, and
tests/conftest.py imports it, so run these there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from crnerf_tpu_torch.models.nerf_mlp import NerfMLP
from crnerf_tpu_torch.ops import fused_render as fr

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(dev, n, s, seed=0):
    g = torch.Generator().manual_seed(seed)
    o = torch.randn(n, 3, generator=g) * 0.5
    d = torch.randn(n, 3, generator=g)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    z = torch.sort(torch.rand(n, s, generator=g) * 4 + 0.5, -1).values
    noise = torch.randn(n, s, generator=g)
    return [t.to(dev) for t in (o, d, z, noise)]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("depth,width,c,s", [
    (6, 64, 16, 8), (6, 64, 16, 100), (8, 256, 64, 64), (2, 48, 24, 130),
])
def test_kernel_matches_plain(dev, dt, exact, depth, width, c, s):
    """S not a multiple of 64 exercises the partial last chunk; width 48
    and C 24 the zero padding to the kernel's 32-granules."""
    torch.manual_seed(1)
    params = fr.mlp_params_from_module(
        NerfMLP(depth=depth, width=width, out_dim=c).to(dev))
    o, d, z, noise = _inputs(dev, 37, s)
    kw = fr.prepare_kernel_weights(params, 15, 4, dt)
    before = fr.LAUNCH_COUNTS["fused_render_fwd"]
    blk_k, w_k = fr.fused_render_apply(kw, o, d, z, noise, exact)
    blk_p, w_p = fr.render_fwd_plain(params, o, d, z, noise,
                                     compute_dtype=dt, exact_encode=exact)
    torch.cuda.synchronize()
    assert fr.LAUNCH_COUNTS["fused_render_fwd"] == before + 1
    tw, tf, td = fr.KERNEL_TOL[dt]
    assert float((w_k - w_p).abs().max()) <= tw
    assert float((blk_k[:, :c] - blk_p[:, :c]).abs().max()) <= tf
    assert float((blk_k[:, c] - blk_p[:, c]).abs().max()) <= td
    assert torch.all(blk_k[:, c + 1:] == 0)


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    torch.manual_seed(2)
    kw = fr.prepare_kernel_weights(fr.mlp_params_from_module(
        NerfMLP(depth=4, width=32, out_dim=16).to(dev)))
    o, d, z, noise = _inputs(dev, 8, 16)
    with pytest.raises(ValueError, match="float32"):
        fr.fused_render_apply(kw, o, d, z.double(), noise)
    with pytest.raises(ValueError, match="contiguous"):
        fr.fused_render_apply(kw, o, d, z.T.contiguous().T, noise)
    with pytest.raises(ValueError, match="on cpu"):
        fr.fused_render_apply(kw, o.cpu(), d, z, noise)


def test_renderer_on_card_matches_cpu(dev):
    """The whole slice at a small fp32 config: the card (kernel, cuDNN)
    against the CPU (plain versions); rgb in [0, 1]."""
    from crnerf_tpu_torch.config import Config
    from crnerf_tpu_torch.render.inference import Renderer
    from crnerf_tpu_torch.render.system import CrNerfSystem

    cfg = Config(N_samples=16, N_importance=16, netdepth=6, netwidth=64,
                 nerf_out_dim=16, appearance_wh=(64, 48), chunk=256,
                 N_emb_xyz=10)
    torch.manual_seed(3)
    cpu_sys = CrNerfSystem(cfg).eval()
    card_sys = CrNerfSystem(cfg).eval()
    card_sys.load_state_dict(cpu_sys.state_dict())
    card_sys.to(dev)
    style = np.random.default_rng(0).uniform(-1, 1, (1, 48, 64, 3)).astype(
        np.float32)
    c2w = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 1.5]], np.float32)
    K = np.array([[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]], np.float32)
    out = {}
    for name, system in (("cpu", cpu_sys), ("card", card_sys)):
        r = Renderer(cfg, system)
        out[name] = r.fetch(r.render_frame_cam_async(c2w, K, 0.5, 2.5,
                                                     (24, 32), style))
    for k in ("rgb", "depth", "mask"):
        assert np.isfinite(out["card"][k]).all()
    np.testing.assert_allclose(out["card"]["rgb"], out["cpu"]["rgb"],
                               atol=1e-3)
    np.testing.assert_allclose(out["card"]["mask"], out["cpu"]["mask"],
                               atol=1e-4)
