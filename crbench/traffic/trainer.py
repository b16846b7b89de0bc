"""Training traffic: ``Trainer.fit`` of ``crnerf_tpu_torch`` on the seeded
synthetic scene, a closed loop of one step at a time.

The benchmark wraps the Trainer's ``step_fn`` (set on the object; the
program is not edited) and drives everything from inside it:
- the first ``checked_steps`` steps take random draws that the benchmark
  makes (the step's ``draws=``), and their batch, loss, first gradient
  (from Adam's first moment after step 1) and parameters after the last
  of them are kept for the reference;
- ``warmup_steps`` more steps draw from the Trainer's own generator;
- then the window: a synchronise, ``seconds`` of steps, a synchronise
  after the step that passes the deadline, and ``request_stop``, so that
  ``fit`` checkpoints (under the run's TMPDIR) outside the window.
The traced run profiles ``trace_steps`` steps from ``trace_from`` of the
window on, between two synchronisations.
"""

from __future__ import annotations

import gc
import json
import os
import statistics
import sys
import time
from typing import Dict, List

import numpy as np

from crbench import scene as bench_scene
from crbench.harness import Check, Run, Stretch, sync


def step_draws(fields: Dict, g: int, b: int, valid: List[int], gen,
               device) -> Dict:
    """A checked step's random draws for ``g`` grids of ``b`` rays, from
    the generator ``gen``: the renderer's ``z_u``, ``noise_coarse``,
    ``noise_fine`` and ``pdf_e``, and ``sel_idx``, the cache rows of the
    random-appearance branch, among the image ids ``valid`` that earlier
    steps cached (row 0 while none has)."""
    import torch

    ns, ni = fields["N_samples"], fields["N_importance"]
    kw = dict(device=device, generator=gen)
    sel = (torch.tensor(valid, device=device)[
        torch.randint(len(valid), (g,), **kw)] if valid
        else torch.zeros((g,), dtype=torch.int64, device=device))
    return dict(
        z_u=torch.rand((g, b, ns), **kw),
        noise_coarse=fields["noise_std"] * torch.randn((g, b, ns), **kw),
        noise_fine=fields["noise_std"] * torch.randn((g, b, ns + ni), **kw),
        pdf_e=torch.empty((g, b, ni + 1), device=device
                          ).exponential_(generator=gen),
        sel_idx=sel)


class StepProbe:
    """The wrapper set on ``trainer.step_fn``."""

    def __init__(self, trainer, r: Run, gen):
        import torch

        self.torch = torch
        self.trainer = trainer
        self.inner = trainer.step_fn
        trainer.step_fn = self
        self.r, self.gen = r, gen
        w = r.workload
        self.n_check, self.n_warm = w["checked_steps"], w["warmup_steps"]
        self.calls = 0
        self.checked: List[Dict] = []     # per checked step
        self.grad1 = self.params = None
        self.t0 = self.t_end = None
        self.t_exit = None
        self.window_steps = 0
        self.outside_ms: List[float] = []
        self.stretch = Stretch() if r.trace else None
        self.stretch_at = None            # window steps before the stretch
        self.stretch_t = None             # its start, perf_counter
        self.stretch_steps = 0
        self.spans = None

    def draws(self, batch) -> Dict:
        g, b = batch["rays"].shape[:2]
        valid = sorted({int(t) for c in self.checked for t in c["ts"]})
        return step_draws(self.r.fields, g, b, valid, self.gen,
                          batch["rays"].device)

    def __call__(self, state, batch, draws=None):
        self.calls += 1
        i = self.calls
        if i <= self.n_check:
            # a step of one grid comes without the grids' axis
            grids = (batch if batch["rays"].dim() == 3
                     else {k: v[None] for k, v in batch.items()})
            d = self.draws(grids)
            state, m = self.inner(state, batch, dict(d))
            self.checked.append(dict(
                ts=grids["ts"][:, 0].cpu().numpy(),
                uv=grids["uv_pix"].cpu().numpy(), draws=d,
                loss=float(m["loss"])))
            named = dict(self.trainer.system.named_parameters())
            if i == 1:
                opt = self.trainer.state.optimizer
                b1 = opt.param_groups[0]["betas"][0]
                self.grad1 = {k: opt.state[p]["exp_avg"].detach() / (1 - b1)
                              for k, p in named.items() if p in opt.state}
            if i == self.n_check:
                self.params = {k: p.detach().clone()
                               for k, p in named.items()}
            return state, m
        if i == self.n_check + self.n_warm + 1:
            sync(self.r.device)
            self.t0 = time.perf_counter()
        if self.t0 is None or self.t_end is not None:
            return self.inner(state, batch)
        return self._window_step(state, batch)

    def _profiling(self) -> bool:
        return (self.stretch_t is not None
                and self.stretch_steps < self.r.workload["trace_steps"])

    def _window_step(self, state, batch):
        torch, r = self.torch, self.r
        t_in = time.perf_counter()
        if self.stretch is not None and self.stretch_t is None and (
                t_in - self.t0 >= r.workload["trace_from"] * r.seconds):
            sync(r.device)
            self.stretch_at = self.window_steps
            self.stretch_t = time.perf_counter()
            self.stretch.start()
        elif self.t_exit is not None and self.stretch_t is None:
            # host time between two steps: the batch's wait and copy (before
            # the profiled stretch: its hooks slow the host to the end)
            self.outside_ms.append(1e3 * (t_in - self.t_exit))
        if self._profiling():
            if self.spans is not None:       # the span since the last step
                self.spans.__exit__(None, None, None)
                self.spans = None
            with torch.profiler.record_function("crbench.step"):
                out = self.inner(state, batch)
            self.stretch_steps += 1
            if self._profiling():
                self.spans = torch.profiler.record_function(
                    "crbench.outside_step")
                self.spans.__enter__()
            else:
                sync(r.device)
                self.stretch.stop()
        else:
            out = self.inner(state, batch)
        self.window_steps += 1
        self.t_exit = time.perf_counter()
        if time.perf_counter() - self.t0 >= r.seconds and \
                not self._profiling():
            sync(r.device)
            self.t_end = time.perf_counter()
            self.trainer.request_stop()
        return out


def make_scene(r: Run):
    from crnerf_tpu_torch.data.scene import Scene, SceneImage

    s = r.workload["scene"]
    images = bench_scene.make_images(
        s["n_images"], tuple(s["img_wh"]), tuple(r.fields["appearance_wh"]),
        r.seed)
    port = Scene(name="crbench", appearance_wh=tuple(r.fields["appearance_wh"]),
                 images=[SceneImage(id=im.id, name=f"{im.id:03d}.png",
                                    K=im.K, c2w=im.c2w, near=im.near,
                                    far=im.far, wh=im.wh, rgbs=im.rgbs,
                                    appearance=im.appearance)
                         for im in images])
    return images, port


def reference_batches(images, checked: List[Dict], device) -> List[Dict]:
    """The checked steps' batches worked out from the scene: each grid's
    image (its ts) and pixels (its pixel-centre uv) give its rays, colours
    and style image."""
    import torch

    out = []
    for c in checked:
        rays, rgbs, whole = [], [], []
        for g, ts in enumerate(c["ts"]):
            im = images[int(ts)]
            w, h = im.wh
            rows = np.floor(c["uv"][g, :, 0].astype(np.float64) * h
                            ).astype(np.int64)
            cols = np.floor(c["uv"][g, :, 1].astype(np.float64) * w
                            ).astype(np.int64)
            rays.append(bench_scene.grid_rays(im, rows, cols))
            rgbs.append(im.rgbs[rows * w + cols])
            whole.append(im.appearance)
        t = lambda a: torch.as_tensor(np.stack(a), device=device)  # noqa
        out.append(dict(rays=t(rays), rgbs=t(rgbs), whole=t(whole),
                        uv=torch.as_tensor(c["uv"], device=device),
                        ts=torch.as_tensor(c["ts"].astype(np.int64),
                                           device=device)))
    return out


def _norms(d: Dict) -> Dict[str, float]:
    return {k: float(v.float().norm()) for k, v in d.items()}


def readings(losses: List[float], grad1: Dict, params: Dict, ref: Dict,
             w0: Dict) -> Dict[str, tuple]:
    """A run's checked steps (each step's loss, the gradient of step 1 as
    the optimizer got it, the parameters after the last) against the
    reference's -> name -> (value, where). Losses by their relative gap
    (step 1's, and the worst step's); the gradient and the parameters'
    change by each leaf's gap of norms over the larger of its reference
    norm and the median leaf's, at the worst leaf and at the median leaf.
    Leaves whose reference gradient is nought to rounding (under a
    thousandth of the median leaf's) move under Adam by round-off alone
    and are left out of the change."""
    loss = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    gr, gp = _norms(ref["grad1"]), _norms(grad1)
    med_g = statistics.median(gr.values())
    grad = {k: abs(gp.get(k, 0.0) - gr[k]) / max(gr[k], med_g) for k in gr}
    moved = [k for k in gr if gr[k] >= 1e-3 * med_g]
    dr = {k: float((ref["params"][k] - w0[k]).norm()) for k in moved}
    dp = {k: float((params[k].float() - w0[k]).norm()) for k in moved}
    med_d = statistics.median(dr.values())
    change = {k: abs(dp[k] - dr[k]) / max(dr[k], med_d) for k in moved}

    def worst(d):
        k = max(d, key=d.get)
        return d[k], k

    return {"loss1_gap": (loss[0], "step 1"),
            "loss_gap": (max(loss), f"step {loss.index(max(loss)) + 1}"),
            "grad_gap": worst(grad),
            "grad_gap_median": (statistics.median(grad.values()),
                                "median leaf"),
            "change_gap": worst(change),
            "change_gap_median": (statistics.median(change.values()),
                                  "median leaf")}


def compare(got: Dict[str, tuple], limits: Dict) -> List[Check]:
    """The readings that the workload gives a limit, as checks; all of
    them printed."""
    print("readings " + json.dumps({k: v[0] for k, v in got.items()}),
          file=sys.stderr, flush=True)
    return [Check(k, got[k][0], limits[k], got[k][1]) for k in limits]


def run(r: Run) -> Dict:
    import torch

    from crbench.reference.train import train_steps
    from crbench.weights import floating_shapes, load_into, seeded_entries
    from crbench.yardstick import step_flops
    from crnerf_tpu_torch import Config
    from crnerf_tpu_torch.train.loop import Trainer

    fields = r.fields
    images, scene = make_scene(r)
    cfg = Config(**{k: tuple(v) if isinstance(v, list) else v
                    for k, v in fields.items()},
                 seed=r.seed, save_dir=os.path.join(r.tmp, "train"),
                 exp_name=r.name)
    trainer = Trainer(cfg, scene, logger=None, device=r.device)
    w0 = seeded_entries(floating_shapes(trainer.system), r.seed, r.device)
    load_into(trainer.system, w0)
    gen = torch.Generator(device=r.device).manual_seed(r.seed + 2)
    probe = StepProbe(trainer, r, gen)
    trainer.fit()
    if probe.t_end is None:
        raise RuntimeError("the Trainer ended before the window closed")
    peak = (torch.cuda.max_memory_allocated(r.device)
            if r.device.type == "cuda" else 0)
    iters = trainer.iters_per_epoch
    n_vocab = cfg.N_vocab
    trainer.state = trainer.step_fn = probe.inner = None
    del trainer
    gc.collect()
    if r.device.type == "cuda":
        torch.cuda.empty_cache()

    window_s = probe.t_end - probe.t0
    rays = probe.window_steps * fields["grids_per_step"] * fields["batch_size"]
    w0_ref = {k: v.clone() for k, v in w0.items()}
    ref = train_steps(w0_ref, fields,
                      reference_batches(images, probe.checked, r.device),
                      [c["draws"] for c in probe.checked], iters, n_vocab)
    checks = compare(readings([c["loss"] for c in probe.checked],
                              probe.grad1, probe.params, ref, w0),
                     r.workload["limits"])
    data = dict(kind="train", fields=fields, steps=probe.window_steps,
                window_s=window_s, outside_ms=probe.outside_ms,
                flops_per_step=step_flops(fields))
    if probe.stretch is not None and probe.stretch_t is not None:
        data.update(trace=probe.stretch.summary(),
                    stretch_steps=probe.stretch_steps,
                    pre_steps=probe.stretch_at,
                    pre_s=probe.stretch_t - probe.t0)
    return dict(attempted=probe.window_steps, failed=0,
                e2e={"train_rays_per_s": rays / window_s,
                     "train_peak_gib": peak / 2 ** 30,
                     "setup_s": probe.t0 - r.t_process},
                memory_peak_bytes=peak, checks=checks, data=data)
