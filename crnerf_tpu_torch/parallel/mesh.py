"""Data parallelism over ``torch.distributed`` (``crnerf_tpu/parallel/
mesh.py``).

The JAX package runs one SPMD program over a ``Mesh``: replicated state,
batches sharded on a leading 'data' axis, ``pmean`` / ``all_gather`` inside
``shard_map``. Here D processes each drive one device and a process group
takes the place of the mesh: every rank holds the whole state, steps on its
own grids, and the collectives below keep the replicas equal. This is the
reference's D-rank DDP over NCCL (``--num_gpus``).

- ``init_distributed`` joins the group that ``torchrun`` describes in the
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``), or that ``spawn`` sets up for the app's own launch. A
  CUDA process binds to ``cuda:LOCAL_RANK``; the backend is NCCL on CUDA
  and gloo on the CPU unless the caller names one. A failed rendezvous is
  an error.
- ``rank``, ``world_size``, ``barrier``: 0, 1 and a no-op without a group.
- ``all_reduce_mean_`` (``jax.lax.pmean``): one all-reduce of a flat buffer
  per dtype, then a divide by D.
- ``all_gather_rows`` (``all_gather(..., tiled=True)``): rows in rank order.
- ``shard_rows`` / ``local_rows`` (``shard_render``'s pad to a multiple of
  D): rank r's slice of n rows padded to D slices of equal size.
- ``AgreedFlag``: a flag that every rank reads the same (a MAX all-reduce),
  launched after one step and read after the next, so that agreeing adds
  no wait on the device.
- ``spawn``: D local processes with a rendezvous on localhost; when one
  fails the others are killed and the launcher exits non-zero.

On gloo a CUDA tensor goes through the host: gloo is a host transport, and
this is the case of two ranks on one card, where NCCL refuses.
"""

from __future__ import annotations

import datetime
import multiprocessing.connection
import os
import signal
import socket
import time
import traceback
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def launched() -> bool:
    """True in a process that a launcher (``torchrun`` or ``spawn``) gave a
    rank."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def resolve_world(num_devices: int, device) -> int:
    """The number of ranks of a run: ``Config.num_devices``, 0 meaning
    every visible GPU on CUDA and 1 on the CPU; under a launcher 0 or its
    ``WORLD_SIZE``, anything else a ``ValueError``."""
    if num_devices < 0:
        raise ValueError(f"num_devices={num_devices} must be >= 0")
    if launched():
        world = int(os.environ["WORLD_SIZE"])
        if num_devices not in (0, world):
            raise ValueError(f"num_devices={num_devices}, but the launcher "
                             f"started WORLD_SIZE={world} processes")
        return world
    if num_devices:
        return num_devices
    if torch.device(device).type == "cuda":
        return max(1, torch.cuda.device_count())
    return 1


def init_distributed(device, backend: Optional[str] = None
                     ) -> Tuple[torch.device, dist.ProcessGroup]:
    """Join the launcher's process group -> (this rank's device, the
    group). On CUDA the process binds to ``cuda:LOCAL_RANK``."""
    missing = [k for k in _ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"init_distributed: {missing} not set (launch "
                           "with torchrun or the app's --num_devices)")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device")
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK={local}, but "
                               f"{torch.cuda.device_count()} GPUs are "
                               "visible")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    elif "OMP_NUM_THREADS" not in os.environ:
        # ranks on one host's CPU share its cores (torchrun sets 1)
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // per_host))
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kw = {}
    if backend == "nccl":
        kw["device_id"] = device   # connect now, not at the first collective
    dist.init_process_group(
        backend=backend, rank=rank, world_size=world,
        init_method=(f"tcp://{os.environ['MASTER_ADDR']}:"
                     f"{os.environ['MASTER_PORT']}"),
        timeout=datetime.timedelta(minutes=10), **kw)
    return device, dist.group.WORLD


def world_size(group: Optional[dist.ProcessGroup] = None) -> int:
    return dist.get_world_size(group) if group is not None else 1


def rank(group: Optional[dist.ProcessGroup] = None) -> int:
    return dist.get_rank(group) if group is not None else 0


def barrier(group: Optional[dist.ProcessGroup] = None) -> None:
    if group is None:
        return
    if dist.get_backend(group) == "nccl":
        dist.barrier(group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group)


def _via_host(group, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_mean_(tensors: Sequence[torch.Tensor],
                     group: Optional[dist.ProcessGroup]) -> None:
    """``pmean`` in place: the tensors of each dtype packed into one flat
    buffer, summed over the ranks in one all-reduce, divided by D and
    copied back. Every rank gets the same bits."""
    if group is None or not tensors:
        return
    d = world_size(group)
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        if _via_host(group, flat):
            host = flat.cpu()
            dist.all_reduce(host, group=group)
            flat = host.to(flat.device)
        else:
            dist.all_reduce(flat, group=group)
        flat.div_(d)
        off = 0
        for t in ts:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n


def all_gather_rows(x: torch.Tensor,
                    group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each) stacked along dim 0 in
    rank order."""
    if group is None:
        return x
    d = world_size(group)
    src = x.contiguous()
    if _via_host(group, src):
        host = src.cpu()
        parts = [torch.empty_like(host) for _ in range(d)]
        dist.all_gather(parts, host, group=group)
        return torch.cat(parts, 0).to(x.device)
    if dist.get_backend(group) == "nccl":
        out = src.new_empty((d * src.shape[0], *src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=group)
        return out
    parts = [torch.empty_like(src) for _ in range(d)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, 0)


def shard_rows(n: int, d: int, r: int) -> Tuple[int, int]:
    """Rank r's slice [start, stop) of n rows padded to a multiple of d
    (``ceil(n / d)`` rows a rank; the padded rows lie past n)."""
    m = -(-n // d)
    return r * m, (r + 1) * m


def local_rows(x: torch.Tensor, d: int, r: int) -> torch.Tensor:
    """Rank r's rows of ``x`` (``shard_rows``), the padding a copy of the
    last row (a real ray, so no rank renders a degenerate one)."""
    n = x.shape[0]
    start, stop = shard_rows(n, d, r)
    if stop > n:
        x = torch.cat([x, x[-1:].expand(stop - n, *x.shape[1:])], 0)
    return x[start:stop]


class AgreedFlag:
    """A boolean every rank reads the same: the MAX over the ranks of
    their local flags. ``launch`` starts the all-reduce without waiting;
    ``read`` returns the last launch's result. On NCCL the result is
    copied to pinned host memory behind an event, so a read after the next
    step's dispatch waits for the reduce only, not for that step."""

    def __init__(self, group: dist.ProcessGroup, device: torch.device):
        self.group = group
        self.cuda = dist.get_backend(group) == "nccl"
        self.device = device if self.cuda else torch.device("cpu")
        self._pending = None

    def launch(self, local: bool) -> None:
        if self._pending is not None:
            raise RuntimeError("AgreedFlag: the last launch was not read")
        t = torch.full((1,), int(local), dtype=torch.int32,
                       device=self.device)
        work = dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group,
                               async_op=True)
        if not self.cuda:
            self._pending = (work, t, None)
            return
        work.wait()          # the current stream waits for the reduce
        host = torch.empty((1,), dtype=torch.int32, pin_memory=True)
        host.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self._pending = (None, host, ev)

    @property
    def pending(self) -> bool:
        return self._pending is not None

    def read(self) -> bool:
        """The last launch's result (False when none is pending)."""
        if self._pending is None:
            return False
        work, t, ev = self._pending
        self._pending = None
        if ev is not None:
            ev.synchronize()
        else:
            work.wait()
        return bool(t.item())

    def agree(self, local: bool) -> bool:
        """Launch and read at once (a point where waiting costs nothing)."""
        self.launch(local)
        return self.read()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(r: int, fn: Callable, n: int, port: int, args: tuple):
    os.environ.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(n),
                      LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    try:
        fn(*args)
    except BaseException:
        # the launcher keeps only the exit code; the traceback is the rank's
        traceback.print_exc()
        raise


def spawn(fn: Callable, n: int, args: tuple = (),
          timeout: Optional[float] = None) -> None:
    """Run ``fn(*args)`` in n new processes, ranks 0..n-1 of a group whose
    rendezvous is on localhost (``init_distributed`` joins it). SIGTERM
    and SIGINT to this process are passed on to every rank. Returns when
    every rank has exited 0; when one exits otherwise, the others are
    killed and ``SystemExit`` carries its code; past ``timeout`` seconds
    every rank is killed and ``TimeoutError`` raised."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_rank_entry, args=(fn, n, _free_port(), args),
                             nprocs=n, join=False, start_method="spawn")
    procs: List = ctx.processes

    def forward(signum, frame):
        for p in procs:
            if p.is_alive():
                os.kill(p.pid, signum)

    prev = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev[sig] = signal.signal(sig, forward)
        except ValueError:   # not the main thread
            pass
    deadline = None if timeout is None else time.monotonic() + timeout
    alive = {p.sentinel: p for p in procs}
    try:
        while alive:
            left = (None if deadline is None
                    else max(0.0, deadline - time.monotonic()))
            ready = multiprocessing.connection.wait(list(alive), left)
            if not ready:
                raise TimeoutError(f"spawn: ranks still running after "
                                   f"{timeout} s")
            for sentinel in ready:
                p = alive.pop(sentinel)
                p.join()
                if p.exitcode != 0:
                    code = p.exitcode if p.exitcode > 0 else 128 - p.exitcode
                    raise SystemExit(code)
    finally:
        for q in alive.values():   # a rank failed or the time ran out
            q.kill()
            q.join()
        for sig, h in prev.items():
            signal.signal(sig, h)
