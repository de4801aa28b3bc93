"""The benchmark of jpeg_tpu_torch on the card.

``python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints its result
line.  Everything that belongs to one configuration, traffic mix or
per-layer metric is a file of its own under ``configs/``, ``traffic/``
and ``metrics/``; ``drivers/`` holds one driver per kind of entry point,
``reference/`` the plain NumPy reference that decides ``correct``.
Nothing here imports ``jax`` or ``jpeg_tpu``.
"""
