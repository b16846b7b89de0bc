"""The rendezvous of the port's own launches (``parallel/mesh.py``
``host_store``, ``rank_env``, ``spawn``), on the CPU over gloo.

A launcher that picks a free port, frees it and hands it to rank 0 to bind
leaves a window in which another process can take the port: rank 0's store
then cannot listen and the run exits non-zero. The port's launchers host
the store themselves, as torchrun's agent does, on a port that the OS
assigns while the store listens on it; the ranks join it as clients.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading

import pytest
import torch
import torch.distributed as dist

from crnerf_tpu_torch.parallel import mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_ENV = {"OMP_NUM_THREADS": "1"}
CONCURRENT_ROUNDS = 10


def sum_job(path: str):
    """A rank of a group (run by mesh.spawn): one all-reduce of rank + 1,
    the sum and the group's size written to ``path``.<rank>."""
    _, group = mesh.init_distributed("cpu")
    t = torch.tensor([float(mesh.rank(group) + 1)])
    dist.all_reduce(t, group=group)
    with open(f"{path}.{mesh.rank(group)}", "w") as f:
        f.write(f"{t.item()} {mesh.world_size(group)}")
    dist.destroy_process_group()


def _sums(path: str, n: int):
    out = []
    for r in range(n):
        with open(f"{path}.{r}") as f:
            out.append(f.read())
    return out


@pytest.fixture
def held_port():
    """A port that another socket of this process listens on."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        s.listen()
        yield s.getsockname()[1]


@pytest.fixture
def rank_threads(monkeypatch):
    for k, v in RANK_ENV.items():
        monkeypatch.setenv(k, v)


def test_rank_zero_cannot_bind_a_port_another_process_holds(held_port):
    """What a launch that hands rank 0 a port to bind meets once another
    process has taken it: the store cannot listen, the rank exits
    non-zero."""
    env = dict(os.environ, PYTHONPATH=REPO, RANK="0", WORLD_SIZE="1",
               MASTER_ADDR="localhost", MASTER_PORT=str(held_port),
               **RANK_ENV)
    env.pop("TORCHELASTIC_USE_AGENT_STORE", None)
    out = subprocess.run(
        [sys.executable, "-c", "from crnerf_tpu_torch.parallel import mesh; "
         "mesh.init_distributed('cpu')"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "address already in use" in out.stderr.lower(), out.stderr


def test_spawn_forms_its_group_where_the_old_port_is_held(
        held_port, monkeypatch, rank_threads, tmp_path):
    """The free-port choice that the launcher made before forced onto a
    taken port (a launch that binds it fails, as above): ``spawn``'s ranks
    join the store that it hosts and sum over both ranks."""
    monkeypatch.setattr(mesh, "_free_port", lambda: held_port,
                        raising=False)
    path = str(tmp_path / "sum")
    mesh.spawn(sum_job, 2, (path,), timeout=120)
    assert _sums(path, 2) == ["3.0 2"] * 2


@pytest.mark.parametrize("round_", range(CONCURRENT_ROUNDS))
def test_two_concurrent_spawns_form_their_own_groups(round_, rank_threads,
                                                     tmp_path):
    """Two launches at once, one of two ranks and one of three: each group
    forms on its own store, and each rank sums its own group's ranks."""
    errors = []

    def launch(n):
        try:
            mesh.spawn(sum_job, n, (str(tmp_path / f"g{n}"),), timeout=120)
        except BaseException as e:   # SystemExit carries a rank's code
            errors.append((n, e))

    other = threading.Thread(target=launch, args=(3,))
    other.start()
    launch(2)
    other.join()
    assert not errors
    assert _sums(str(tmp_path / "g2"), 2) == ["3.0 2"] * 2
    assert _sums(str(tmp_path / "g3"), 3) == ["6.0 3"] * 3


def test_host_store_listens_on_the_port_it_names():
    store = mesh.host_store()
    assert store.port > 0
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        with pytest.raises(OSError):
            s.bind(("localhost", store.port))
    store.set("k", "v")
    client = dist.TCPStore("localhost", store.port, is_master=False,
                           timeout=mesh.TIMEOUT)
    assert client.get("k") == b"v"


def test_rank_env_is_torchruns_contract_on_the_launchers_store():
    store = mesh.host_store()
    env = mesh.rank_env(store, 1, 2, local_rank=0)
    assert env == dict(RANK="1", WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
                       LOCAL_RANK="0", MASTER_ADDR="localhost",
                       MASTER_PORT=str(store.port),
                       TORCHELASTIC_USE_AGENT_STORE="True")
    assert mesh.rank_env(store, 1, 2)["LOCAL_RANK"] == "1"


def test_a_process_joins_the_store_it_hosts(monkeypatch, rank_threads):
    """One rank in the launching process itself (the smoke run's one-rank
    group): the store and its client in one process."""
    store = mesh.host_store()
    for k, v in mesh.rank_env(store, 0, 1).items():
        monkeypatch.setenv(k, v)
    _, group = mesh.init_distributed("cpu")
    try:
        t = torch.ones(3)
        mesh.all_reduce_mean_([t], group)
        assert mesh.world_size(group) == 1 and t.tolist() == [1.0] * 3
    finally:
        dist.destroy_process_group()
