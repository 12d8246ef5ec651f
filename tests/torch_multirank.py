"""Run a function on gloo ranks on the CPU: the spawn helper of the port's
multi-device tests.

``run_ranks(n, "module:function", *args)`` calls ``function(rank,
*args)`` on ``n`` gloo ranks, one ``spawn`` process and one torch thread
each (``parallel.mesh.run_ranks``), and returns the results in rank
order; every join has a timeout and every child is reaped. The children
import torch and the port, never JAX (the rank functions live in
``tests/torch_rank_cases.py``, which imports no JAX): the JAX side of a
test runs in the test's own process, on the virtual CPU mesh of
``tests/conftest.py``.
"""

from __future__ import annotations

from psana_ray_tpu_torch.parallel.mesh import run_ranks as _run_ranks


def run_ranks(n: int, target: str, *args, timeout: float = 300.0):
    return _run_ranks(n, target, *args, device_type="cpu", threads=1, timeout=timeout)
