"""Metric and experiment logging (``crnerf_tpu/utils/logging.py``).

``MetricLogger`` appends one JSON row per ``log`` call to
``<log_dir>/<exp_name>/metrics.jsonl`` (line-buffered, so a stopped run
keeps what it logged) and mirrors it to wandb when ``use_wandb`` is set and
wandb imports. Metric names are the JAX package's ('train/loss', 'lr',
'val/psnr', 'val/ssim', ...). ``log_image`` writes PNGs through
``utils/png.py``. ``save_code`` snapshots the port's sources and the full
config into the experiment's log directory.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, Optional

import numpy as np

from crnerf_tpu_torch.utils.png import write_png


class MetricLogger:
    def __init__(self, log_dir: str, exp_name: str = "exp",
                 use_wandb: bool = False, project: str = "crnerf_tpu"):
        self.log_dir = os.path.join(log_dir, exp_name)
        os.makedirs(self.log_dir, exist_ok=True)
        self.path = os.path.join(self.log_dir, "metrics.jsonl")
        self._fh = open(self.path, "a", buffering=1)
        self.wandb = None
        if use_wandb:
            try:
                import wandb  # type: ignore

                wandb.init(project=project, name=exp_name, dir=self.log_dir)
                self.wandb = wandb
            except Exception:   # offline or absent: metrics.jsonl only
                self.wandb = None

    def log(self, metrics: Dict[str, Any], step: int):
        row = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                row[k] = str(v)
        self._fh.write(json.dumps(row) + "\n")
        if self.wandb is not None:
            self.wandb.log({k: v for k, v in row.items()
                            if k not in ("step", "time")}, step=step)

    def log_image(self, name: str, img, step: int):
        """img: (H, W, 3) float [0, 1] -> PNG under images/."""
        d = os.path.join(self.log_dir, "images")
        os.makedirs(d, exist_ok=True)
        write_png(os.path.join(d, f"{name.replace('/', '_')}_{step:08d}.png"),
                  np.asarray(img, np.float32))

    def close(self):
        self._fh.close()
        if self.wandb is not None:
            self.wandb.finish()


def save_code(save_dir: str, exp_name: str, config_json: str,
              package_dir: Optional[str] = None):
    """Copy the port's package (``package_dir``, default this package) and
    the full config into ``{save_dir}/logs/{exp_name}/codes``."""
    package_dir = package_dir or os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))
    dst = os.path.join(save_dir, "logs", exp_name, "codes")
    os.makedirs(dst, exist_ok=True)
    shutil.copytree(package_dir,
                    os.path.join(dst, os.path.basename(package_dir)),
                    dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    with open(os.path.join(dst, "config.json"), "w") as f:
        f.write(config_json)
