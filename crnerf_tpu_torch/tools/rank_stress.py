"""Stress the port's two-rank launch and its exact resume on the CPU.

    python -m crnerf_tpu_torch.tools.rank_stress cli [--batches 5]
        [--copies 6] [--out DIR]
    python -m crnerf_tpu_torch.tools.rank_stress resume [--first 1]
        [--last 39] [--out DIR]

``cli``: batches of ``copies`` concurrent runs of the three tests of
``tests/test_torch_parallel.py`` that share its two-rank CLI runs (the
SIGTERM stop, the resume against the unstopped run, the one-process
resume), each with its own ``--basetemp``, beside one run of
``tests/test_torch_tp.py``, whose four gloo ranks add the socket load that
the whole suite's workers make. Prints the count of failed runs and, for
each, its failing tests' messages (the run at fault, its ranks' exit codes,
the stop step, the first tensor that differs) and the last lines of its
ranks' logs.

``resume``: two gloo ranks (``mesh.spawn``) train the tests' CLI config
for one epoch unstopped; then for every k from ``first`` to ``last``, a
run whose rank 1 alone asks to stop after step k, and its
``--auto_resume``, each held to the unstopped run's final state
(``torch.equal`` on every tensor) and final validation. Prints a line a k
and how many matched.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CLI_TESTS = "sigterm or resumed or one_process_resumes"
# tests/test_torch_parallel.py's CLI, one epoch of 40 steps on two ranks
CLI = ["--dataset_name", "synthetic", "--batch_size", "64",
       "--grids_per_step", "2", "--N_samples", "4", "--N_importance", "4",
       "--netdepth", "2", "--netwidth", "16", "--nerf_out_dim", "8",
       "--N_vocab", "10", "--appearance_wh", "32", "24", "--chunk", "256",
       "--val_chunk", "256", "--num_epochs", "1", "--log_every", "1"]


def _pytest(path: str, basetemp: str, out, *extra):
    return subprocess.Popen(
        [sys.executable, "-m", "pytest", path, "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", f"--basetemp={basetemp}", *extra], cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"), stdout=out,
        stderr=subprocess.STDOUT)


def _report(d: str):
    with open(os.path.join(d, "out.txt")) as f:
        text = f.read().splitlines()
    print(f"--- {d}")
    print("\n".join([ln for ln in text if ln.startswith("E ")][:40]
                    + [ln for ln in text if ln.startswith("FAILED")
                       or ln.startswith("ERROR")]))
    for log in sorted(glob.glob(os.path.join(d, "tmp", "cli*", "*",
                                             "rank*.log"))):
        with open(log) as f:
            tail = f.read().splitlines()[-3:]
        print(f"  {os.path.relpath(log, d)}: " + " | ".join(tail))


def stress_cli(batches: int, copies: int, out: str) -> int:
    failed, runs = [], 0
    for b in range(batches):
        jobs = []
        for c in range(copies):
            d = os.path.join(out, f"b{b}c{c}")
            shutil.rmtree(d, ignore_errors=True)
            os.makedirs(d)
            f = open(os.path.join(d, "out.txt"), "w")
            jobs.append((d, f, _pytest("tests/test_torch_parallel.py",
                                       os.path.join(d, "tmp"), f, "-k",
                                       CLI_TESTS)))
        with open(os.path.join(out, f"b{b}tp.txt"), "w") as f:
            tp = _pytest("tests/test_torch_tp.py",
                         os.path.join(out, f"b{b}tp"), f)
            rcs = []
            for d, g, p in jobs:
                rcs.append(p.wait(timeout=1800))
                g.close()
                if rcs[-1]:
                    failed.append(d)
            tp.wait(timeout=1800)
        runs += len(jobs)
        print(f"batch {b}: exit codes {rcs}; test_torch_tp.py beside it "
              f"exit {tp.returncode}", flush=True)
    for d in failed:
        _report(d)
    print(f"{len(failed)} of {runs} runs of the three CLI tests failed")
    return 1 if failed else 0


def _flat(payload):
    import torch

    out = {"step": torch.tensor(payload["step"])}
    out.update({f"system.{k}": v for k, v in payload["system"].items()})
    for i, st in payload["optimizer"]["state"].items():
        for k, v in st.items():
            out[f"optimizer.{i}.{k}"] = torch.as_tensor(v).clone()
    for k in ("embedding_cache", "embedding_valid", "generator"):
        out[k] = payload[k].clone()
    return out


def resume_job(save: str, ks, result: str):
    """One rank of ``resume`` (run by mesh.spawn)."""
    import torch

    from crnerf_tpu_torch.config import get_config
    from crnerf_tpu_torch.data.synthetic import make_synthetic_scene
    from crnerf_tpu_torch.parallel import mesh
    from crnerf_tpu_torch.train.loop import Trainer
    from crnerf_tpu_torch.utils.checkpoint import state_payload

    device, group = mesh.init_distributed("cpu")
    r = mesh.rank(group)
    scene = make_synthetic_scene(appearance_wh=(32, 24))

    def trainer(exp, *extra):
        cfg = get_config([*CLI, "--save_dir", save, "--exp_name", exp,
                          *extra])
        return Trainer(cfg, scene, device=device, group=group)

    t = trainer("whole")
    t.fit()
    want, want_val = _flat(state_payload(t.state)), t.validate()
    res = {}
    for k in ks:
        t = trainer(f"stop{k}")
        step_fn = t.step_fn

        def step(state, batch, t=t, k=k, step_fn=step_fn):
            state, m = step_fn(state, batch)
            if r == 1 and state.step == k:
                t.request_stop()
            return state, m

        t.step_fn = step
        t.fit()
        at = t.state.step
        t = trainer(f"stop{k}", "--auto_resume")
        t.fit()
        got = _flat(state_payload(t.state))
        differ = [n for n in want if not torch.equal(want[n], got[n])]
        res[k] = dict(at=at, end=t.state.step, differ=differ[:3],
                      n_differ=len(differ), same_val=t.validate() == want_val)
        if r == 0:
            print(f"stop asked after step {k}: {res[k]}", flush=True)
    if r == 0:
        with open(result, "w") as f:
            json.dump(res, f)
    torch.distributed.destroy_process_group()


def sweep_resume(first: int, last: int, out: str) -> int:
    from crnerf_tpu_torch.parallel import mesh

    os.environ.setdefault("OMP_NUM_THREADS", "2")
    save = tempfile.mkdtemp(dir=out)
    result = os.path.join(out, "resume.json")
    mesh.spawn(resume_job, 2, (save, list(range(first, last + 1)), result),
               timeout=7200)
    with open(result) as f:
        res = json.load(f)
    same = [k for k, v in res.items()
            if not v["n_differ"] and v["same_val"]]
    ats = sorted(v["at"] for v in res.values())
    print(f"{len(same)} of {len(res)} resumes (stopped at steps "
          f"{ats[0]}-{ats[-1]}) end on the unstopped run's bits and final "
          f"validation")
    return 0 if len(same) == len(res) else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("cli")
    c.add_argument("--batches", type=int, default=5)
    c.add_argument("--copies", type=int, default=6)
    r = sub.add_parser("resume")
    r.add_argument("--first", type=int, default=1)
    r.add_argument("--last", type=int, default=39)
    for q in (c, r):
        q.add_argument("--out", default=os.path.join(REPO, "build",
                                                      "rank_stress"))
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.cmd == "cli":
        return stress_cli(args.batches, args.copies, args.out)
    return sweep_resume(args.first, args.last, args.out)


if __name__ == "__main__":
    sys.exit(main())
