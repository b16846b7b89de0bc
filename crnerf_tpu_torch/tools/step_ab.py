"""The flagship training step's time in two checkouts, in turns, on one
card.

    python3 -m crnerf_tpu_torch.tools.step_ab OTHER [--rounds 2] [--steps 10]
        [--route pallas_stash=False]

Each reading is a process of its own, run from one checkout's root: the
step of ``--route`` (a key of that checkout's ``chip_smoke.ROUTES``: the
stash route by default, ``pallas_stash=False``, ``pertube_cord=True``,
``pallas_render=False``) as its ``chip_smoke.py`` phases 6 and 7 drive it
(``train_config`` and ``make_trainer``: the train leg of bench.py at the
Config defaults with the route's fields, seeded weights, the synthetic
scene), two warm-up steps,
then ``--steps`` steps, each timed on the host clock with the card
synchronised before and after. The readings go OTHER, this checkout,
this checkout, OTHER in every round, so that a drift of the card or the
host falls on both sides alike. Prints each reading's median and range,
then per checkout the median over all its steps, with the card's name and
power limit. OTHER is a checkout of this repository (the parent commit,
say) whose ``chip_smoke.py`` has those two functions and the route.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

from crnerf_tpu_torch.tools._common import device_line

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_CHILD = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
cfg = cs.train_config(**cs.ROUTES[sys.argv[3]][0])
state, step, staged = cs.make_trainer(cfg, torch.device("cuda", 0), cs.SEED,
                                      (112, 84), cfg.resolved_chunks())
cs.timed_steps(state, step, staged, 2)
times, _, _ = cs.timed_steps(state, step, staged, int(sys.argv[2]), first=2)
print(json.dumps(times))
"""


def reading(root: str, steps: int, route: str):
    """One process's timed steps (ms) of the checkout at ``root``."""
    out = subprocess.run([sys.executable, "-c", _CHILD, root, str(steps),
                          route],
                         cwd=root, capture_output=True, text=True,
                         timeout=1200)
    if out.returncode != 0:
        raise RuntimeError(f"step in {root} failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("other", help="root of the other checkout")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--route", default="stash",
                   help="the training route, a key of chip_smoke.ROUTES")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("step_ab: needs a CUDA device", file=sys.stderr)
        return 1
    print(device_line(torch.device("cuda", 0)), f"route {args.route}")
    roots = {"other": os.path.abspath(args.other), "this": HERE}
    steps = {"other": [], "this": []}
    for r in range(args.rounds):
        for side in ("other", "this", "this", "other"):
            t = reading(roots[side], args.steps, args.route)
            steps[side] += t
            print(f"round {r} {side} ({roots[side]}): median "
                  f"{statistics.median(t):.2f} ms per step (range "
                  f"{min(t):.2f}-{max(t):.2f}) over {len(t)} steps",
                  flush=True)
    for side, t in steps.items():
        print(f"{side}: median {statistics.median(t):.2f} ms per step over "
              f"{len(t)} steps, quartiles "
              f"{statistics.quantiles(t, n=4)[0]:.2f}-"
              f"{statistics.quantiles(t, n=4)[2]:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
