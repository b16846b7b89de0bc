"""The frozen plain reference against crnerf_tpu_torch's plain route (the
kernels' plain versions on the CPU) at a tiny size in float32: three
training steps from the same weights, batches and draws, and a served
frame. The test imports both; the reference imports nothing of the
port."""

import dataclasses
import statistics

import numpy as np
import torch

from crbench import camera
from crbench.reference.frame import frame_u8
from crbench.reference.train import train_steps
from crbench.weights import floating_shapes, load_into, seeded_entries

from tinycell import TINY_RENDER, TINY_TRAIN


def port_config(**kw):
    from crnerf_tpu_torch import Config

    base = dict(encode_c=True, N_vocab=10, num_epochs=20, lr=5e-4)
    base.update({k: tuple(v) if isinstance(v, list) else v
                 for k, v in kw.items()})
    return Config(**base)


def test_three_training_steps_agree():
    from crnerf_tpu_torch.render.system import CrNerfSystem
    from crnerf_tpu_torch.train.optim import make_optimizer
    from crnerf_tpu_torch.train.state import TrainState
    from crnerf_tpu_torch.train.step import make_train_step

    cfg = port_config(**TINY_TRAIN)
    system = CrNerfSystem(cfg)
    w0 = seeded_entries(floating_shapes(system), 11, "cpu")
    load_into(system, w0)
    opt, sched = make_optimizer(cfg, 100, system.parameters())
    state = TrainState.create(system, opt, cfg.N_vocab, 32, 64,
                              generator=torch.Generator().manual_seed(1))
    step = make_train_step(system, opt, sched, grids_per_step=2)
    g, b = 2, 64
    gen = torch.Generator().manual_seed(3)
    batches, draws, losses = [], [], []
    for k in range(3):
        o = torch.randn(g, b, 3, generator=gen) * 0.1 + torch.tensor(
            [0.0, 0.0, 3.0])
        d = torch.nn.functional.normalize(
            torch.randn(g, b, 3, generator=gen) * 0.1
            + torch.tensor([0.0, 0.0, -1.0]), dim=-1)
        rays = torch.cat([o, d, torch.full((g, b, 1), 0.5),
                          torch.full((g, b, 1), 5.0)], -1)
        batch = dict(rays=rays,
                     ts=torch.tensor([[k] * b, [k + 3] * b]).int(),
                     rgbs=torch.rand(g, b, 3, generator=gen),
                     whole_img=torch.rand(g, 1, 48, 64, 3,
                                          generator=gen) * 2 - 1,
                     uv_pix=torch.rand(g, b, 2, generator=gen))
        dr = dict(z_u=torch.rand(g, b, 8, generator=gen),
                  noise_coarse=torch.randn(g, b, 8, generator=gen),
                  noise_fine=torch.randn(g, b, 16, generator=gen),
                  pdf_e=torch.empty(g, b, 9).exponential_(generator=gen),
                  sel_idx=torch.tensor([0, 3]))
        batches.append(batch)
        draws.append(dr)
        state, m = step(state, batch, dict(dr))
        losses.append(float(m["loss"]))
        if k == 0:
            grad1 = {n: opt.state[p]["exp_avg"] / 0.1
                     for n, p in system.named_parameters()}
    ref = train_steps(
        {k: v.clone() for k, v in w0.items()}, dataclasses.asdict(cfg),
        [dict(rays=x["rays"], rgbs=x["rgbs"], whole=x["whole_img"][:, 0],
              uv=x["uv_pix"], ts=x["ts"][:, 0].long()) for x in batches],
        draws, 100, cfg.N_vocab)
    # step 1 from the same weights: summation order only
    assert abs(losses[0] - ref["losses"][0]) <= 1e-5 * ref["losses"][0]
    for a, r in zip(losses, ref["losses"]):
        assert abs(a - r) <= 1e-3 * r
    gr = {n: float(v.norm()) for n, v in ref["grad1"].items()}
    med = statistics.median(gr.values())
    worst = max(float((grad1[n] - ref["grad1"][n]).norm()) / max(gr[n], med)
                for n in gr)
    # with 8 + 8 samples a ray the fine pass's gradient swings with the
    # rounding of the coarse weights it resamples from: both fp32 sides
    # sit ~13% from a float64 reference at the fine trunk's leaves, and
    # 1.03e-2 from each other (measured); the coarse leaves agree to 1e-4
    assert worst <= 3e-2
    # Adam moves an entry by about lr whatever its gradient's size, so the
    # parameters are compared as the harness compares them: by the gap of
    # each leaf's change norm
    from crbench.traffic.trainer import readings

    got = readings(losses, grad1, dict(system.named_parameters()), ref, w0)
    # measured 1.55e-2 at nerf_fine.sigma.weight (256 entries: a few
    # entries whose gradient sits at rounding flip the sign of their move)
    assert got["change_gap"][0] <= 3e-2


def test_a_served_frame_agrees():
    from crnerf_tpu_torch.render.inference import Renderer
    from crnerf_tpu_torch.render.system import CrNerfSystem

    cfg = port_config(**TINY_RENDER)
    system = CrNerfSystem(cfg)
    w0 = seeded_entries(floating_shapes(system), 5, "cpu")
    load_into(system, w0)
    wh, hw = (32, 24), (24, 32)
    pose = camera.path_poses(240)[17]
    K = camera.fov_k(wh)
    style = np.random.default_rng(0).uniform(-1, 1, (48, 64, 3)).astype(
        np.float32)
    r = Renderer(cfg, system)
    got = r.fetch(r.render_frame_cam_async(pose, K, 0.0, 5.0, hw,
                                           style[None], outputs="rgb_u8"))
    want = frame_u8(w0, dataclasses.asdict(cfg), pose, K, 0.0, 5.0, hw,
                    style, "cpu")
    diff = np.abs(got["rgb_u8"].astype(int) - want.astype(int))
    assert diff.max() <= 1 and diff.mean() <= 0.02
    assert want.std() > 2.0     # the frame is not flat
