"""The serving driver's funnel, which moves a traced run's renders onto
the main thread for the profiled stretch: under many threads and a short
switch interval every call returns its own result, none is left waiting,
and the stretch starts only once no render runs on a caller's thread."""

import sys
import threading
import time

from crbench.traffic.serve_closed import Funnel


class FakeService:
    def __init__(self):
        self.threads = set()

    def _render(self, x):
        self.threads.add(threading.get_ident())
        time.sleep(0.0005)
        return x * 2


def test_every_call_gets_its_own_result_across_the_stretch():
    svc = FakeService()
    funnel = Funnel(svc)
    wrong, done, started = [], [], []
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def caller(k):
            for i in range(60):
                if svc._render(k * 1000 + i) != 2 * (k * 1000 + i):
                    wrong.append((k, i))
            done.append(k)

        threads = [threading.Thread(target=caller, args=(k,))
                   for k in range(32)]
        for t in threads:
            t.start()
        for _ in range(3):     # stretches while the callers run
            funnel.serve(0.05, lambda: started.append(funnel.direct))
            time.sleep(0.01)
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(saved)
    assert not wrong and len(done) == 32
    assert funnel.waiting == 0 and funnel.tasks.empty()
    assert started == [0, 0, 0]   # no render on a caller's thread then
    assert threading.get_ident() in svc.threads   # the stretch's renders
    assert len(svc.threads) > 1                   # and the callers' own
