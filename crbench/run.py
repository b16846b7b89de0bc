"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python -m crbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's workload file names its configuration and its traffic kind;
the kind's driver (``traffic/<kind>.py``) builds the program from the
seed, warms it up, measures ``seconds`` of traffic, and compares what the
window produced with the plain reference. With ``--trace 0`` the result
holds the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics, each read by ``metrics/<name>.py`` from the run's spans and the
profiler's stretch. Without a CUDA device, or with fewer than the cell
asks for, it exits non-zero and prints no result; likewise if jax, jaxlib,
flax or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

from crbench.harness import (  # noqa: E402
    ROOT,
    BenchError,
    Run,
    card_line,
    emit,
    forbidden_loaded,
    load_json,
    require_cards,
)

REPO = os.path.dirname(ROOT)


def benchmark() -> Dict:
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_of(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise BenchError(f"no workload {name!r} in BENCHMARK.json")


def metrics_for(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The cell's end-to-end metrics (``trace`` False) or per-layer
    metrics (True), as ``BENCHMARK.json`` lists them."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names
                             else [])]


def reader(name: str):
    """The per-layer metric's reader, ``metrics/<name>.py``."""
    path = os.path.join(ROOT, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "crbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(name: str, workload: Dict, config: Dict, seed: int,
             seconds: float, trace: bool, device, metrics: List[Dict],
             tmp: str, t_process: float) -> Dict:
    """Run one cell on ``device`` -> (result, checks). ``metrics``: the
    metrics to report, as ``BENCHMARK.json`` lists them."""
    drive = importlib.import_module(f"crbench.traffic.{workload['kind']}")
    r = Run(name=name, workload=workload, config=config, seed=seed,
            seconds=seconds, trace=trace, device=device,
            t_process=t_process, tmp=tmp)
    out = drive.run(r)
    values: Dict[str, Dict] = {}
    for m in metrics:
        if trace:
            v: Optional[float] = reader(m["name"])(out["data"])
            if v is None:
                continue
        else:
            v = out["e2e"][m["name"]]
        values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    if device.type == "cuda":
        import torch

        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": workload.get("chips", 1)}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1}
    dev["memory_peak_bytes"] = int(out["memory_peak_bytes"])
    result = {"correct": all(c.ok for c in out["checks"]),
              "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": values,
              "device": dev}
    summary = out["data"].get("trace")
    if trace and summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = summary.breakdown()
    return {"result": result, "checks": out["checks"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    tmp = None
    try:
        bench = benchmark()
        cell = cell_of(bench, args.workload)
        workload = load_json("workloads", args.workload + ".json")
        config = load_json("configs", workload["config"] + ".json")
        require_cards(cell["chips"])
        import torch

        print(f"card: {card_line()}; peaks: bf16 989 TFLOP/s, fp32 67 "
              "TFLOP/s, 3.35 TB/s (H100 SXM data sheet)", file=sys.stderr,
              flush=True)
        tmp = tempfile.mkdtemp(prefix="crbench-")
        out = run_cell(args.workload, {**workload, "chips": cell["chips"]},
                       config, args.seed, args.seconds, bool(args.trace),
                       torch.device("cuda", 0),
                       metrics_for(bench, args.workload, bool(args.trace)),
                       tmp, T_PROCESS)
        found = forbidden_loaded()
        if found:
            raise BenchError(f"forbidden modules loaded: {found}")
    except BenchError as e:
        print(f"crbench: {e}", file=sys.stderr, flush=True)
        return 2
    except Exception:   # the run gives no result; the traceback says why
        traceback.print_exc()
        return 1
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    emit(out["result"], out["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
