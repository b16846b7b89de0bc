"""The readings that the limits of ``correct`` are set from, at a cell's
own size: the plain reference computed in fp8 (e4m3, the precision below
the configuration's bfloat16) put in the program's place, and faults
planted in the reference, each compared with the float32 reference as a
run compares the program.

    python -m crbench.control --workload <cell> --seeds 1,2,3

Training cells: the control, and half of each grid's rays left out (the
mean taken over the rest); a step that returns its state unchanged reads
1 by the change's measure and needs no run. Serving cells: the control,
the frame's colour channels reversed (an answer altered where it is
produced, as ``tests/test_crbench_faults.py`` plants it in the program),
and a reply built from another request, served for the one asked: the
frame of the next style, or of the pose half the path away. (Request i
asks for pose i and style i mod ``styles``, so requests in flight at once
differ in style.) The benchmark's runs never run this; it prints one JSON
line a seed.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import numpy as np

from crbench import camera
from crbench import scene as bench_scene
from crbench.harness import load_json


def train_inputs(fields: Dict, workload: Dict, seed: int, device,
                 n_steps: int = 3):
    """Seeded weights, batches of the cell's size drawn from the seeded
    scene (a random image and a strided grid of pixels at a random zoom
    each, as the grid sampler draws them), and the steps' random draws."""
    import torch

    from crbench.traffic.trainer import reference_batches, step_draws
    from crbench.weights import seeded_entries

    s = workload["scene"]
    images = bench_scene.make_images(s["n_images"], tuple(s["img_wh"]),
                                     tuple(fields["appearance_wh"]), seed)
    rng = np.random.default_rng(seed + 3)
    side = int(round(fields["batch_size"] ** 0.5))
    g_n = fields["grids_per_step"]
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    steps, draws = [], []
    for _ in range(n_steps):
        ts, uv = [], []
        for _ in range(g_n):
            k = int(rng.integers(len(images)))
            w, h = images[k].wh
            scale = rng.uniform(0.5, 1.0)
            hs = np.linspace(0, 1 - 1 / h, side) * scale + rng.uniform(
                0, (1 - scale) * (1 - 1 / h))
            ws = np.linspace(0, 1 - 1 / w, side) * scale + rng.uniform(
                0, (1 - scale) * (1 - 1 / w))
            hi = np.clip(np.floor(hs * h), 0, h - 1)
            wi = np.clip(np.floor(ws * w), 0, w - 1)
            vv, uu = np.meshgrid((hi + 0.5) / h, (wi + 0.5) / w,
                                 indexing="ij")
            uv.append(np.stack([vv.reshape(-1), uu.reshape(-1)], -1))
            ts.append(images[k].id)
        valid = sorted({int(t) for c in steps for t in c["ts"]})
        draws.append(step_draws(fields, g_n, fields["batch_size"], valid,
                                gen, device))
        steps.append(dict(ts=np.asarray(ts),
                          uv=np.stack(uv).astype(np.float32)))
    batches = reference_batches(images, steps, device)
    w0 = seeded_entries(system_shapes(fields), seed, device)
    return w0, batches, draws


def system_shapes(fields: Dict) -> Dict[str, tuple]:
    """The floating entries of the system's state_dict, read from the
    program's module built on the meta device (no numbers made)."""
    import torch

    from crbench.weights import floating_shapes
    from crnerf_tpu_torch import Config
    from crnerf_tpu_torch.render.system import CrNerfSystem

    cfg = Config(**{k: tuple(v) if isinstance(v, list) else v
                    for k, v in fields.items()})
    with torch.device("meta"):
        return floating_shapes(CrNerfSystem(cfg))


def half_batch(d: Dict) -> Dict:
    """Half of every grid's rays left out and the mean taken over the
    rest: the first half of each tensor's ray axis (axis 1, the grid's
    rows 0 to side / 2 - 1) in both halves' places."""
    import torch

    b = d["rays"].shape[1] if "rays" in d else d["z_u"].shape[1]
    return {k: torch.cat([v[:, :b // 2]] * 2, 1)
            if v.dim() >= 2 and v.shape[1] == b else v
            for k, v in d.items()}


def train_readings(fields: Dict, workload: Dict, seed: int, device
                   ) -> Dict[str, Dict[str, float]]:
    from crbench.reference.model import Quant
    from crbench.reference.train import train_steps
    from crbench.traffic.trainer import readings

    w0, batches, draws = train_inputs(fields, workload, seed, device)
    s = workload["scene"]
    iters = (s["n_images"] * s["img_wh"][0] * s["img_wh"][1]
             // fields["batch_size"] // fields["grids_per_step"])
    n_vocab = fields["N_vocab"]
    ref = train_steps(w0, fields, batches, draws, iters, n_vocab)

    def read(got) -> Dict[str, float]:
        return {k: v[0] for k, v in readings(
            got["losses"], got["grad1"], got["params"], ref, w0).items()}

    out = {"control_fp8": read(train_steps(w0, fields, batches, draws,
                                           iters, n_vocab, Quant("fp8")))}
    out["half_batch"] = read(train_steps(
        w0, fields, [half_batch(b) for b in batches],
        [half_batch(d) for d in draws], iters, n_vocab))
    return out


def serve_readings(fields: Dict, workload: Dict, seed: int, device,
                   n_frames: int = 3) -> Dict[str, Dict[str, float]]:
    from crbench.reference.frame import frame_u8
    from crbench.reference.model import Quant
    from crbench.traffic.serve_closed import frame_readings, serve_inputs

    w0, styles = serve_inputs(fields, workload, seed, system_shapes(fields),
                              device)
    styles = [s.astype(np.float32) / 255.0 * 2.0 - 1.0 for s in styles]
    poses = camera.path_poses(workload["path_frames"])
    wh = tuple(workload["wh"])
    hw = (wh[1], wh[0])
    K = camera.fov_k(wh, workload["fov"])
    rng = np.random.default_rng(seed + 4)
    out: Dict[str, Dict[str, float]] = {
        "control_fp8": {}, "channels_reversed": {}, "other_pose": {},
        "other_style": {}}

    def keep(case, got, want):
        for k, v in frame_readings(got, want).items():
            out[case][k] = max(v, out[case].get(k, 0.0))

    for _ in range(n_frames):
        i = int(rng.integers(len(poses)))
        j = int(rng.integers(len(styles)))

        def frame(pose, style=j, q=None):
            return frame_u8(w0, fields, pose, K, workload["near"],
                            workload["far"], hw, styles[style], device,
                            *(() if q is None else (Quant(q),)))

        want = frame(poses[i])
        keep("control_fp8", frame(poses[i], q="fp8"), want)
        keep("channels_reversed", want[..., ::-1], want)
        keep("other_pose", frame(poses[(i + len(poses) // 2) % len(poses)]),
             want)
        keep("other_style", frame(poses[i], (j + 1) % len(styles)), want)
    return out


def main(argv=None):
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    workload = load_json("workloads", args.workload + ".json")
    fields = {**load_json("configs", workload["config"] + ".json")["fields"],
              **workload.get("runtime", {})}
    device = torch.device(args.device)
    for seed in (int(s) for s in args.seeds.split(",")):
        fn = (train_readings if workload["kind"] == "trainer"
              else serve_readings)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "readings": fn(fields, workload, seed, device)}),
              flush=True)


if __name__ == "__main__":
    main()
