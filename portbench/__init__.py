"""The benchmark of the PyTorch and CUDA port (``psana_ray_tpu_torch``).

``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on one card and
prints one JSON result line. Cells, traffic mixes, configurations and
metrics are found by the names ``BENCHMARK.json`` gives them:
``configs/<config>.json`` and ``.py``, ``traffic/<traffic>.json``,
``end_to_end/<metric>.py`` and ``metrics/<metric>.py``. The plain f32
reference that decides ``correct`` is ``reference/``; it imports nothing
of the port.
"""
