"""Training entry point (``crnerf_tpu/apps/train.py``): config -> scene ->
``Trainer.fit`` with metric logging, checkpoints and a code snapshot.

SIGTERM or SIGINT: with nothing unsaved (still building, or the last
checkpoint is the present state) the process exits at once with code 0;
otherwise the Trainer checkpoints after the step in flight, prints
``preempted: checkpointed at step N`` and exits 0, and a relaunch with
``--auto_resume`` continues from that step exactly. A second signal during
that stop exits at once.

On several GPUs (``--num_devices N``, 0 = every visible GPU) the app
spawns N ranks, one GPU each, over NCCL; under ``torchrun
--nproc_per_node N`` each process joins the launcher's group instead. Rank
0 alone writes the code snapshot, the metrics and the checkpoints and
prints the final line. Every rank's SIGTERM / SIGINT handler only sets that
rank's flag; the ranks agree on the step to stop after (``Trainer``), so a
signal to any one rank stops the run with one checkpoint.

Run:  python -m crnerf_tpu_torch train --dataset_name phototourism \\
          --root_dir SCENE --exp_name EXP [--num_devices N] [--device cpu]
      torchrun --nproc_per_node N -m crnerf_tpu_torch train ...
"""

from __future__ import annotations

import os
import signal
from typing import Optional, Sequence

from crnerf_tpu_torch.apps import (
    add_device_arg,
    load_scene_from_config,
    resolve_device,
    run_ranks,
)
from crnerf_tpu_torch.config import Config, build_parser, config_from_args
from crnerf_tpu_torch.parallel import mesh
from crnerf_tpu_torch.train.loop import Trainer
from crnerf_tpu_torch.utils.logging import MetricLogger, save_code


def main(argv: Optional[Sequence[str]] = None):
    p = build_parser()
    add_device_arg(p)
    args = p.parse_args(argv)
    device = resolve_device(p, args.device)
    cfg = config_from_args(args)
    return run_ranks(run, cfg.num_devices, device, cfg)


def run(cfg: Config, device, group=None):
    """Train on ``device``, as one rank of ``group`` when there is one."""
    lead, several = mesh.rank(group) == 0, mesh.world_size(group) > 1
    # installed before the scene and the Trainer are built, so that a
    # signal meanwhile still ends the process at once (one process) or is
    # kept for the ranks to agree on (several)
    prev, holder = {}, {}

    def _graceful(signum, frame):
        t = holder.get("trainer")
        if several:
            holder["stop"] = True
            if t is not None:
                t.request_stop()
            return
        if t is not None and t.stopped:
            os._exit(128 + signum)   # the second signal
        if t is None or not t.has_unsaved_progress:
            os._exit(0)
        t.request_stop()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev[sig] = signal.signal(sig, _graceful)
        except ValueError:   # not the main thread (embedded use)
            pass

    try:
        scene = load_scene_from_config(cfg, "train")
        logger = None
        if lead:
            save_code(cfg.save_dir, cfg.exp_name, cfg.to_json())
            logger = MetricLogger(os.path.join(cfg.save_dir, "logs"),
                                  cfg.exp_name, use_wandb=cfg.use_wandb,
                                  project=cfg.proj_name)
        trainer = Trainer(cfg, scene, logger=logger, device=device,
                          group=group)
        holder["trainer"] = trainer
        if holder.get("stop"):
            trainer.request_stop()
        state = trainer.fit()
    finally:
        for sig, h in prev.items():
            if h is not None:
                signal.signal(sig, h)
    if trainer.stopped:
        # the checkpoint is saved; skip the extra validation render
        what = ("training complete; stop signal honored"
                if trainer.completed else "preempted")
        if lead:
            print(f"{what}: checkpointed at step {state.step}", flush=True)
    else:
        val = trainer.validate()
        if lead:
            print(f"final val: psnr={val['psnr']:.3f} "
                  f"ssim={val['ssim']:.4f}", flush=True)
    if logger:
        logger.close()
    return state


if __name__ == "__main__":
    main()
