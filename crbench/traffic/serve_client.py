"""The clients of the serving cells: a standard-library process (no torch)
holding ``clients`` connections to the render server, each a closed loop
of render requests, so that their JSON and base64 work does not share the
server's interpreter lock.

Reads its plan as one JSON line on standard input, sends each client's
warm-up requests, prints ``ready``, waits for a ``go`` line, then runs
the window: request i (numbered across clients in sending order) asks
for pose ``(offset + i) mod len(poses)`` of the path in style
``styles[i mod len(styles)]``. A client sends while the window is open and
reads each reply to its end. Then a sample of the finished requests,
drawn from the plan's seed, keeps its PNGs, and the records go to the
plan's ``out`` file as JSON; times are seconds from ``go``.
"""

from __future__ import annotations

import json
import random
import socket
import sys
import threading
import time


def _request(plan, i: int) -> dict:
    poses = plan["poses"]
    return {"op": "render", "inline": True, "wh": plan["wh"],
            "fov": plan["fov"], "near": plan["near"], "far": plan["far"],
            "c2w": poses[(plan["offset"] + i) % len(poses)],
            "style_id": plan["styles"][i % len(plan["styles"])]}


class Client:
    def __init__(self, plan):
        self.sock = socket.create_connection((plan["host"], plan["port"]),
                                             timeout=plan["timeout"])
        self.rfile = self.sock.makefile("rb")

    def call(self, req: dict) -> dict:
        self.sock.sendall((json.dumps(req) + "\n").encode())
        line = self.rfile.readline()
        if not line.endswith(b"\n"):
            raise ConnectionError("the server closed the connection")
        return json.loads(line)

    def close(self):
        self.rfile.close()
        self.sock.close()


def main():
    plan = json.loads(sys.stdin.readline())
    clients = [Client(plan) for _ in range(plan["clients"])]
    for c in clients:
        for k in range(plan["warm_requests"]):
            c.call(_request(plan, -1 - k))
    print("ready", flush=True)
    if sys.stdin.readline().strip() != "go":
        raise SystemExit("no go")
    t_go = time.perf_counter()
    deadline = t_go + plan["seconds"]
    lock = threading.Lock()
    counter = [0]
    records, pngs = [], {}

    def loop(c: Client):
        while True:
            with lock:
                if time.perf_counter() >= deadline:
                    return
                i = counter[0]
                counter[0] += 1
            req = _request(plan, i)
            t_send = time.perf_counter()
            broken = False
            try:
                resp = c.call(req)
                ok = bool(resp.get("ok"))
            except (OSError, ValueError) as e:   # the connection is gone
                resp, ok, broken = {"error": repr(e)}, False, True
            t_recv = time.perf_counter()
            with lock:
                records.append(dict(i=i, send=t_send - t_go,
                                    recv=t_recv - t_go, ok=ok,
                                    ms=resp.get("ms"),
                                    error=resp.get("error")))
                if ok:
                    pngs[i] = resp.get("png_b64")
            if broken:
                return

    threads = [threading.Thread(target=loop, args=(c,)) for c in clients]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for c in clients:
        c.close()
    done = sorted(r["i"] for r in records if r["ok"])
    keep = random.Random(plan["sample_seed"]).sample(
        done, min(plan["checked_frames"], len(done)))
    with open(plan["out"], "w") as f:
        json.dump({"records": sorted(records, key=lambda r: r["i"]),
                   "kept": {str(i): pngs[i] for i in keep}}, f)


if __name__ == "__main__":
    main()
