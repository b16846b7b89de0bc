"""What the spike tools share: the device a tool runs on, its timers, the
card's name and power limit, and the error measure they print."""

from __future__ import annotations

import statistics
import subprocess
import sys
import time
from typing import Optional

import torch


def add_device_flag(parser) -> None:
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda (the default) runs the kernels and "
                             "stops at start without a card; cpu runs the "
                             "plain versions")


def pick_device(name: str, tool: str) -> Optional[torch.device]:
    """The device of ``--device``; None, with a message, when it is cuda
    and there is no card."""
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        print(f"{tool}: no CUDA device; pass --device cpu to run the plain "
              "versions on the CPU", file=sys.stderr)
        return None
    return torch.device("cuda", 0)


def device_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them, or the
    CPU, for the first line a tool prints."""
    if device.type != "cuda":
        return "device: CPU (plain versions; times on the host clock)"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        card = out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        card = f"{torch.cuda.get_device_name(device)} (nvidia-smi: {e})"
    return f"device: {card}"


def time_ms(fn, device: torch.device, reps: int) -> float:
    """ms per call of ``fn`` over ``reps`` calls after one warm-up: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def turns_ms(kernel, library, device: torch.device, reps: int = 20,
             readings: int = 3):
    """-> (kernel ms, library ms) per call: the medians of 2 * ``readings``
    readings of ``reps`` calls each, taken in turns library, kernel,
    kernel, library, so that a drift of the card or the host between calls
    falls on both sides alike."""
    ks, ls = [], []
    for _ in range(readings):
        ls.append(time_ms(library, device, reps))
        ks.append(time_ms(kernel, device, reps))
        ks.append(time_ms(kernel, device, reps))
        ls.append(time_ms(library, device, reps))
    return statistics.median(ks), statistics.median(ls)


def graph_ms(fn, device: torch.device, reps: int = 20,
             replays: int = 10) -> float:
    """Device ms per call of ``fn``: ``reps`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so that the
    host's path to each launch is not in the reading. Card only."""
    fn()
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / (reps * replays)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|, in float32."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / (float(want.abs().max())
                                              + 1e-30)
