"""The training slice through the Trainers: crnerf_tpu's Trainer and the
port's, from the same weights (carried through the bridge), fit for two
steps on the same scene, their logged metrics and their validation held
to each other. The JAX step takes its Pallas route in interpret mode.

The steps' random draws are fixed by the config and the scene, so that no
injection is needed: ``perturb=0`` (deterministic z and ``sample_pdf``),
``noise_std=0``, and one training image, so that the random-appearance
branch can only choose that image's cache row (the first step, with an
empty cache, uses the live embedding in both). ``crnerf_tpu/train/step.py``
draws nothing else. N_emb_xyz=10, as in tests/test_torch_train_step.py.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from crnerf_tpu.config import Config as JaxConfig
from crnerf_tpu.data.synthetic import make_synthetic_scene as jax_scene
from crnerf_tpu.train.loop import Trainer as JaxTrainer
from crnerf_tpu.utils.logging import MetricLogger as JaxLogger
from crnerf_tpu_torch import Config
from crnerf_tpu_torch.data.synthetic import make_synthetic_scene
from crnerf_tpu_torch.train.loop import Trainer
from crnerf_tpu_torch.utils.logging import MetricLogger
from crnerf_tpu_torch.utils.weights import load_into

torch.set_num_threads(2)

CFG = JaxConfig(
    batch_size=64, grids_per_step=2, N_samples=8, N_importance=8,
    netdepth=2, netwidth=32, nerf_out_dim=16, N_emb_xyz=10, N_vocab=8,
    appearance_wh=(64, 48), compute_dtype="float32", pallas_interpret=True,
    num_epochs=1, num_devices=1, perturb=0.0, noise_std=0.0, log_every=1,
    val_chunk=512, chunk=512,
)
# one 16x16 image: 256 rays, 4 grids of 64, 2 steps of 2 grids an epoch
SCENE = dict(n_train=1, n_test=1, img_wh=(16, 16), appearance_wh=(64, 48))
N_STEPS = 2


def _rows(d, exp):
    with open(os.path.join(d, "logs", exp, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("slice"))
    cfg = CFG.replace(save_dir=d)
    jtr = JaxTrainer(cfg.replace(exp_name="jax"), jax_scene(**SCENE),
                     logger=JaxLogger(os.path.join(d, "logs"), "jax"))
    assert jtr.iters_per_epoch == N_STEPS
    variables = jax.tree.map(np.asarray, {"params": jtr.state.params,
                                          "batch_stats":
                                              jtr.state.batch_stats})
    pcfg = Config(**{f.name: getattr(cfg, f.name)
                     for f in dataclasses.fields(Config)})
    ptr = Trainer(pcfg.replace(exp_name="port"), make_synthetic_scene(
        **SCENE), logger=MetricLogger(os.path.join(d, "logs"), "port"),
        device="cpu")
    load_into(ptr.system, variables)
    jtr.fit()
    ptr.fit()
    jtr.logger.close()
    ptr.logger.close()
    return _rows(d, "jax"), _rows(d, "port")


def _train_row(rows, step):
    (row,) = [r for r in rows if r["step"] == step and "train/loss" in r]
    return {k: v for k, v in row.items() if k not in ("step", "time")}


@pytest.mark.parametrize("i", range(N_STEPS))
def test_logged_step_metrics_match(logs, i):
    """tests/test_torch_train_step.py's bounds: 1e-4 relative at step 1
    (PSNR 1e-3 dB), 1e-3 at step 2, which starts from parameters that
    already differ by Adam's sign of rounding noise."""
    jm, pm = (_train_row(r, i + 1) for r in logs)
    assert set(jm) == set(pm)
    rtol = 1e-4 if i == 0 else 1e-3
    for k in jm:
        tol = dict(rtol=rtol, atol=10 * rtol) if k == "train/psnr" else \
            dict(rtol=rtol, atol=1e-7)
        np.testing.assert_allclose(pm[k], jm[k], err_msg=k, **tol)


def test_validation_matches(logs):
    (jv,), (pv,) = ([r for r in rows if "val/psnr" in r] for rows in logs)
    assert jv["step"] == pv["step"] == N_STEPS
    assert abs(pv["val/psnr"] - jv["val/psnr"]) <= 1e-3
    assert abs(pv["val/ssim"] - jv["val/ssim"]) <= 1e-3


def test_epoch_rows(logs):
    for rows in logs:
        (ep,) = [r for r in rows if "train/epoch" in r]
        assert ep["train/epoch"] == 0 and ep["train/rays_per_sec"] > 0
