"""Training entry point (``crnerf_tpu/apps/train.py``): config -> scene ->
``Trainer.fit`` with metric logging, checkpoints and a code snapshot.

SIGTERM or SIGINT: with nothing unsaved (still building, or the last
checkpoint is the present state) the process exits at once with code 0;
otherwise the Trainer checkpoints after the step in flight, prints
``preempted: checkpointed at step N`` and exits 0, and a relaunch with
``--auto_resume`` continues from that step exactly. A second signal during
that stop exits at once.

Run:  python -m crnerf_tpu_torch train --dataset_name phototourism \\
          --root_dir SCENE --exp_name EXP [--device cpu]
"""

from __future__ import annotations

import os
import signal
from typing import Optional, Sequence

from crnerf_tpu_torch.apps import (
    add_device_arg,
    load_scene_from_config,
    resolve_device,
)
from crnerf_tpu_torch.config import build_parser, config_from_args
from crnerf_tpu_torch.train.loop import Trainer
from crnerf_tpu_torch.utils.logging import MetricLogger, save_code


def main(argv: Optional[Sequence[str]] = None):
    p = build_parser()
    add_device_arg(p)
    args = p.parse_args(argv)
    device = resolve_device(p, args.device)
    cfg = config_from_args(args)
    scene = load_scene_from_config(cfg, "train")
    save_code(cfg.save_dir, cfg.exp_name, cfg.to_json())
    logger = MetricLogger(os.path.join(cfg.save_dir, "logs"), cfg.exp_name,
                          use_wandb=cfg.use_wandb, project=cfg.proj_name)

    # installed before the Trainer is built, so that a signal while it
    # builds still ends the process at once
    prev, holder = {}, {}

    def _graceful(signum, frame):
        t = holder.get("trainer")
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

    trainer = Trainer(cfg, scene, logger=logger, device=device)
    holder["trainer"] = trainer
    try:
        state = trainer.fit()
    finally:
        for sig, h in prev.items():
            if h is not None:
                signal.signal(sig, h)
    if trainer.stopped:
        # the checkpoint is saved; skip the extra validation render
        what = ("training complete; stop signal honored"
                if trainer.completed else "preempted")
        print(f"{what}: checkpointed at step {state.step}", flush=True)
    else:
        val = trainer.validate()
        print(f"final val: psnr={val['psnr']:.3f} ssim={val['ssim']:.4f}",
              flush=True)
    logger.close()
    return state


if __name__ == "__main__":
    main()
