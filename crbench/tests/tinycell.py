"""Tiny cells for the CPU tests: the cells' own files with their sizes cut
to what a test run holds (few rays, few samples, a small style image, a
small scene and frame), computed in float32 unless a test asks."""

import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TINY_TRAIN = dict(batch_size=64, N_samples=8,
                  N_importance=8, appearance_wh=[64, 48], N_vocab=24,
                  compute_dtype="float32")
TINY_RENDER = dict(N_samples=8, N_importance=8, appearance_wh=[64, 48],
                   chunk=256, compute_dtype="float32")


def tiny_cell(cell: str, **fields):
    """-> (workload, config) of ``cell`` at the tiny size."""
    from crbench.harness import load_json

    wl = load_json("workloads", cell + ".json")
    cfg = load_json("configs", wl["config"] + ".json")
    if wl["kind"] == "trainer":
        cfg["fields"].update(TINY_TRAIN)
        wl["scene"] = {"n_images": 4, "img_wh": [48, 36]}
    else:
        cfg["fields"].update(TINY_RENDER)
        wl.update(wh=[32, 24], trace_seconds=0.5)
    cfg["fields"].update(fields)
    return wl, cfg


def run_tiny(cell: str, seed: int = 1234567890123, seconds: float = 1.5,
             trace: bool = False, **fields):
    """One run of a tiny cell on the CPU, past the harness's look for a
    card -> {"result", "checks"}."""
    import torch

    from crbench.run import benchmark, metrics_for, run_cell

    wl, cfg = tiny_cell(cell, **fields)
    with tempfile.TemporaryDirectory() as tmp:
        return run_cell(cell, wl, cfg, seed, seconds, trace,
                        torch.device("cpu"),
                        metrics_for(benchmark(), cell, trace), tmp,
                        time.perf_counter())

