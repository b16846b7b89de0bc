"""The benchmark of ``crnerf_tpu_torch`` on NVIDIA GPUs.

``python -m crbench.run --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON line.
Everything a cell needs is found by name: its traffic in
``workloads/<cell>.json``, its model in ``configs/<config>.json``, its
driver in ``traffic/<kind>.py`` and each per-layer metric's reader in
``metrics/<metric>.py``. ``yardstick.py`` (peaks, operations and bytes),
``scene.py``, ``camera.py``, ``pngcodec.py`` and ``reference/`` are frozen
copies that the program cannot change. This package imports neither jax
nor the JAX package; importing it imports no torch.
"""
