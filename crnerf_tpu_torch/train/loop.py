"""The training loop (``crnerf_tpu/train/loop.py`` ``Trainer``): epochs of
grid batches through ``make_train_step``, validation renders, checkpoints,
metric logging, a graceful stop and an exact resume, on one device or on
each rank of a process group (``parallel/mesh.py``).

- The state is the port's ``TrainState`` (system, Adam, embedding cache,
  generator, step), updated in place by the step; ``fit`` runs the epochs
  from the one its step falls in, the first of them from its step within
  the epoch: batches are a pure function of (epoch, step), so a resumed
  run replays the exact remaining sequence.
- A checkpoint holds the whole state (``utils/checkpoint.py``), so a
  restored run continues with the same numbers; ``weights.npz`` beside it
  is the inference bundle the eval and serve apps read.
- Validation renders through the port's ``Renderer``, a new one each time
  (it puts the system in eval mode and keeps a layout of the weights as
  they are), and scores the float rgb with PSNR and SSIM.
- Every ``img_panel_every`` steps the step's first grid is rendered again
  by a no-grad training-mode forward and logged as gt / pred /
  pred_random / mask panels; the state is left as the step left it (the
  generator's state and CGNet's pending batch statistics are put back).
- ``Config.profile``: a ``torch.profiler`` trace of the global steps
  ``[profile_steps[0], profile_steps[1])``, in Chrome format under
  ``save_dir/traces/exp_name``.

With a group of D ranks (the JAX Trainer over a mesh):
- a step takes D G grids, each rank its own G (``TrainPipeline``), so an
  epoch is ``iterations // (D G)`` steps and a step trains
  ``batch_size D G`` rays;
- rank 0 alone logs (the logged metrics are the ranks' mean), renders the
  panels, opens the profiler window and writes the checkpoint and
  ``weights.npz``, between two barriers; every rank restores onto its own
  device;
- a stop is agreed: each rank's flag (``request_stop``, from its signal
  handler) goes into a MAX all-reduce launched after each step and read
  after the next step's dispatch, so every rank stops after the same step
  and checkpoints it, with no wait added to a step (``_should_stop``'s
  sync point in the JAX package);
- validation renders are sharded over the ranks (``Renderer(group=)``).

Left in the JAX package: its duplicate per-resolution renderer and slab
dispatch (for a TPU behind a high-latency link).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from crnerf_tpu_torch.config import Config
from crnerf_tpu_torch.data.pipeline import TrainPipeline, full_image_batch
from crnerf_tpu_torch.data.scene import Scene
from crnerf_tpu_torch.parallel import mesh
from crnerf_tpu_torch.render.inference import Renderer
from crnerf_tpu_torch.render.system import CrNerfSystem
from crnerf_tpu_torch.train.metrics import psnr as psnr_fn, ssim as ssim_fn
from crnerf_tpu_torch.train.optim import make_optimizer
from crnerf_tpu_torch.train.state import TrainState
from crnerf_tpu_torch.train.step import (
    make_train_step,
    reduce_metrics,
    select_random_embeddings,
)
from crnerf_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    restore_state,
    state_payload,
)
from crnerf_tpu_torch.utils import tracing
from crnerf_tpu_torch.utils.logging import MetricLogger
from crnerf_tpu_torch.utils.visualization import visualize_depth
from crnerf_tpu_torch.utils.weights import flax_from_state_dict, save_npz


class Trainer:
    def __init__(self, cfg: Config, scene: Scene,
                 logger: Optional[MetricLogger] = None,
                 device="cuda", group=None):
        """``group``: the process group of a data-parallel run, this
        process one of its ranks on ``device`` (``mesh.init_distributed``);
        ``logger`` is used on rank 0 only."""
        self.cfg = cfg
        self.scene = scene
        self.device = torch.device(device)
        self.group = group
        self.n_ranks, self.rank = mesh.world_size(group), mesh.rank(group)
        self.pipeline = TrainPipeline(scene, batch_size=cfg.batch_size,
                                      scale_anneal=cfg.scale_anneal,
                                      min_scale=cfg.min_scale)
        self.grids = max(1, cfg.grids_per_step)
        self.iters_per_epoch = max(
            1, self.pipeline.iterations // (self.n_ranks * self.grids))
        if cfg.testit:   # smoke mode: one step an epoch
            self.iters_per_epoch = 1

        # the weights from the seed, made on the CPU whatever the device
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            system = CrNerfSystem(cfg)
        system = system.to(self.device)
        optimizer, sched = make_optimizer(cfg, self.iters_per_epoch,
                                          system.parameters())
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        self.state = TrainState.create(system, optimizer, cfg.N_vocab, 32,
                                       cfg.nerf_out_dim, generator=gen)
        self.step_fn = make_train_step(
            system, optimizer, sched, grids_per_step=self.grids,
            grad_accum_chunks=cfg.resolved_chunks(), group=group)

        self.logger = logger if self.rank == 0 else None
        self.ckpt = CheckpointManager(
            os.path.join(cfg.save_dir, "ckpts", cfg.exp_name))
        self._stop_requested = False   # this process's flag
        self._stopping = False         # the flag the ranks agreed on
        self._flag = (mesh.AgreedFlag(group, self.device)
                      if group is not None else None)
        # the step of the checkpoint this process last wrote or restored:
        # a save at the same step is skipped (the state on disk is this
        # one)
        self._last_saved_step: Optional[int] = None
        # steps since the last save, a plain int a signal handler can read
        self._progress_steps = 0
        self._completed = False
        self._profiler = None   # the torch.profiler of Config.profile

        if cfg.ckpt_path:
            self.restore(cfg.ckpt_path)
        elif cfg.auto_resume and self.ckpt.latest_step() is not None:
            self.restore()

    @property
    def system(self) -> CrNerfSystem:
        return self.state.system

    @property
    def stopped(self) -> bool:
        """True once a stop was requested (sticky; see ``clear_stop``);
        with a group, once the ranks agreed on one, which every rank reads
        the same."""
        return self._stopping if self._flag is not None else (
            self._stop_requested)

    @property
    def completed(self) -> bool:
        """True once ``fit`` ran every epoch to the end."""
        return self._completed

    @property
    def has_unsaved_progress(self) -> bool:
        """Steps taken since the last checkpoint write."""
        return self._progress_steps > 0

    # ------------------------------------------------------------- resume
    def restore(self, directory: Optional[str] = None):
        """Load the latest checkpoint of ``directory`` (default: this
        experiment's) into the state."""
        if directory is not None and directory.endswith(".npz"):
            raise ValueError(
                "resume needs a checkpoint directory; a weights.npz bundle "
                "holds inference weights only (use the eval app for that)")
        same = directory is None or (
            os.path.abspath(directory) == self.ckpt.directory)
        mgr = self.ckpt if same else CheckpointManager(directory)
        restore_state(self.state, mgr.load(map_location=self.device))
        if same:   # the newest checkpoint on disk is this state
            self._last_saved_step = self.ckpt.latest_step()

    # ----------------------------------------------------- graceful stop
    def request_stop(self):
        """Ask ``fit`` to checkpoint after the step in flight and return
        (``apps/train`` wires SIGTERM and SIGINT here). With a group, every
        rank stops after the step at which the ranks agree on it."""
        self._stop_requested = True

    def clear_stop(self):
        """Re-arm a Trainer whose ``fit`` was stopped."""
        self._stop_requested = self._stopping = False

    def _agree_stop(self) -> bool:
        """Whether any rank asked to stop, waiting for the answer (between
        epochs)."""
        if self._flag is not None:
            self._stopping |= self._flag.agree(self._stop_requested)
        else:
            self._stopping |= self._stop_requested
        return self._stopping

    def _step_stop(self) -> bool:
        """After a step's dispatch: whether the ranks agreed to stop by the
        step before (the reduce launched then), then this step's reduce
        launched; on one process the local flag."""
        if self._flag is None:
            self._stopping |= self._stop_requested
            return self._stopping
        self._stopping |= self._flag.read()
        self._flag.launch(self._stop_requested)
        return self._stopping

    def _save_checkpoint(self, global_step: int):
        if self._last_saved_step == global_step:
            return
        mesh.barrier(self.group)
        if self.rank == 0:
            self.ckpt.save(global_step, state_payload(self.state))
            # the inference bundle: parameters and BatchNorm statistics
            save_npz(flax_from_state_dict(self.system),
                     os.path.join(self.ckpt.directory, "weights.npz"))
        mesh.barrier(self.group)
        self._last_saved_step = global_step
        # only once every file is on disk: the signal handler exits at
        # once while nothing is unsaved
        self._progress_steps = 0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -------------------------------------------------------------- train
    def fit(self, num_epochs: Optional[int] = None) -> TrainState:
        try:
            return self._fit(num_epochs)
        finally:   # a profiler window the run did not reach the end of
            self._stop_profile()

    def _fit(self, num_epochs: Optional[int]) -> TrainState:
        cfg = self.cfg
        epochs = num_epochs if num_epochs is not None else cfg.num_epochs
        global_step = self.state.step
        for epoch in range(global_step // self.iters_per_epoch, epochs):
            if self._agree_stop():
                self._save_checkpoint(global_step)
                return self.state
            t_ep = time.time()
            global_step, n_rays = self._epoch_per_step(epoch, global_step)
            if self._stopping:
                self._save_checkpoint(global_step)
                return self.state
            self._sync()
            dt = time.time() - t_ep
            if self.logger:
                self.logger.log({"train/epoch": epoch,
                                 "train/rays_per_sec": n_rays / max(dt, 1e-9)},
                                global_step)
            is_last = epoch == epochs - 1
            if cfg.val_every_epochs > 0 and (
                    (epoch + 1) % cfg.val_every_epochs == 0 or is_last):
                val = self.validate(log_images=is_last)
                if self.logger:
                    self.logger.log({"val/psnr": val["psnr"],
                                     "val/ssim": val["ssim"]}, global_step)
            if (epoch + 1) % cfg.ckpt_every_epochs == 0 or is_last:
                self._save_checkpoint(global_step)
        self._completed = True
        return self.state

    def _epoch_per_step(self, epoch: int, global_step: int):
        """The epoch's steps from ``global_step`` on -> (global_step,
        rays trained)."""
        cfg = self.cfg
        n_rays = 0
        # closed on the way out, so that the prefetch thread stops
        with contextlib.closing(self.pipeline.epoch_batches(
                epoch, self.grids, n_steps=self.iters_per_epoch,
                start_step=global_step - epoch * self.iters_per_epoch,
                rank=self.rank, world=self.n_ranks)) as batches:
            while True:
                # the spans of a batch carry the global step it feeds
                with tracing.span("train.batch_wait", rid=global_step):
                    batch = next(batches, None)
                if batch is None:
                    break
                with tracing.span("train.batch_copy", rid=global_step):
                    batch = {k: torch.from_numpy(v).to(self.device)
                             for k, v in batch.items() if k != "image_idx"}
                if (cfg.profile and self.rank == 0
                        and global_step == cfg.profile_steps[0]):
                    self._start_profile()
                self.state, metrics = self.step_fn(self.state, batch)
                global_step += 1
                self._progress_steps += 1
                n_rays += cfg.batch_size * self.n_ranks * self.grids
                if (self.logger and cfg.img_panel_every > 0
                        and global_step % cfg.img_panel_every == 0):
                    self._log_train_panels(batch, global_step)
                if global_step == cfg.profile_steps[1]:
                    self._stop_profile()
                if global_step % cfg.log_every == 0 and (
                        self.logger or self.group is not None):
                    vals = reduce_metrics(metrics, self.group)
                    if self.logger:
                        self.logger.log(
                            {k if "/" in k else f"train/{k}": v
                             for k, v in vals.items()}, global_step)
                if self._step_stop():
                    break
        if self._flag is not None and self._flag.pending:
            self._stopping |= self._flag.read()   # the epoch's last reduce
        return global_step, n_rays

    # ------------------------------------------------- panels, profiler
    @torch.no_grad()
    def _log_train_panels(self, batch: Dict[str, torch.Tensor],
                          global_step: int):
        """gt / pred / pred_random / mask panels of the batch's first grid:
        a no-grad forward of the system in training mode, as the step runs
        it, with a random embedding drawn from the state's generator. The
        forward's draws and CGNet's batch statistics are not the step's:
        the generator's state and the pending statistics are restored, so
        the run goes on with the bits it would have had without panels."""
        cfg, system, state = self.cfg, self.system, self.state
        one = batch["rays"].dim() == 2     # a single grid, no G axis
        b = {k: v[None] if one else v[:1] for k, v in batch.items()}
        gen = state.generator
        gen_state = gen.get_state() if gen is not None else None
        norms = (system.implicit_mask.norms()
                 if system.implicit_mask is not None else [])
        pending = [m.pending for m in norms]
        try:
            use_rand = cfg.encode_random and cfg.encode_a
            system.train()
            res = system.forward_train(
                b,
                a_embedded_random=(select_random_embeddings(state, 1)
                                   if use_rand else None),
                random_has_any=state.has_any, generator=gen)
        finally:
            if gen is not None:
                gen.set_state(gen_state)
            for m, p in zip(norms, pending):
                m.pending = p
        hw = cfg.grid_hw

        def img(x):
            return x[0].float().reshape(hw, hw, -1).cpu().numpy()

        typ = "rgb_fine" if "rgb_fine" in res else "rgb_coarse"
        self.logger.log_image("train/gt", img(b["rgbs"]), global_step)
        self.logger.log_image("train/pred", img(res[typ]), global_step)
        if "rgb_fine_random" in res:
            self.logger.log_image("train/pred_random",
                                  img(res["rgb_fine_random"]), global_step)
        if "out_mask" in res:
            self.logger.log_image("train/mask",
                                  np.repeat(img(res["out_mask"]), 3, -1),
                                  global_step)

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=acts)
        self._profiler.start()

    def _stop_profile(self):
        """End the profiler window (if one is open) and write its Chrome
        trace."""
        if self._profiler is None:
            return
        self._sync()
        self._profiler.stop()
        d = os.path.join(self.cfg.save_dir, "traces", self.cfg.exp_name)
        os.makedirs(d, exist_ok=True)
        a, b = self.cfg.profile_steps
        self._profiler.export_chrome_trace(
            os.path.join(d, f"steps_{a}_{b}.trace.json"))
        self._profiler = None

    # ---------------------------------------------------------- rendering
    @torch.no_grad()
    def render_image(self, image,
                     appearance_img=None) -> Dict[str, np.ndarray]:
        """Full render of one SceneImage -> rgb (h, w, 3), depth (h, w)
        and mask (h, w) when the system has one, float, on the host. Uses
        the image's own appearance unless one is given."""
        b = full_image_batch(self.scene, image, appearance_img)
        w, h = image.wh
        renderer = Renderer(self.cfg.replace(chunk=self.cfg.val_chunk),
                            self.system, self.device, group=self.group)
        try:
            return renderer.fetch(renderer.render_frame_async(
                b["rays"], b["whole_img"], (h, w), outputs="full"))
        finally:
            self.system.train()

    @torch.no_grad()
    def validate(self, max_images: int = 1,
                 log_images: bool = False) -> Dict[str, float]:
        """Render the first train image(s) at full size and score PSNR and
        SSIM; with ``log_images`` the gt / pred / depth / mask panels go to
        the logger."""
        psnrs, ssims = [], []
        for im in self.scene.train_images[:max_images]:
            out = self.render_image(im)
            w, h = im.wh
            gt = torch.from_numpy(im.rgbs.reshape(h, w, 3).astype(np.float32))
            pred = torch.from_numpy(out["rgb"].astype(np.float32))
            psnrs.append(float(psnr_fn(pred, gt)))
            ssims.append(float(ssim_fn(pred, gt)))
            if log_images and self.logger:
                step = self.state.step
                self.logger.log_image("val/gt", gt.numpy(), step)
                self.logger.log_image("val/pred", out["rgb"], step)
                self.logger.log_image("val/depth",
                                      visualize_depth(out["depth"]), step)
                if "mask" in out:
                    self.logger.log_image(
                        "val/mask", np.repeat(out["mask"][..., None], 3, -1),
                        step)
        return {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims))}
