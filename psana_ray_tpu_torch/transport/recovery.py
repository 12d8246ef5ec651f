"""The one put-back path for items a process already popped.

The port's copy of ``psana_ray_tpu/transport/recovery.py``. A TCP
connection that dies with deliveries in flight hands them back here
(:meth:`TcpQueueServer._requeue`): at the queue's head where the queue has
``put_front``, so they stay ahead of EOS markers already queued, else with
timed tail retries and a logged, never silent, drop.
"""

from __future__ import annotations

import logging
import time
from typing import Any, List, Sequence

from psana_ray_tpu_torch.transport.registry import TransportClosed

logger = logging.getLogger(__name__)


def return_to_queue(queue, items: Sequence[Any], *, timeout_s: float = 30.0,
                    what: str = "in-flight item") -> List[Any]:
    """Return ``items`` to ``queue`` in FIFO order.

    ``put_front`` (head placement, allowed past maxsize, so it cannot fail)
    where the queue has it; else tail appends with ``put_wait`` retries up
    to ``timeout_s`` in all. Returns the items that could not be returned
    (logged); empty on success or when the queue is closed (a dead
    transport has no sibling left to starve)."""
    items = list(items)
    if not items:
        return []
    put_front = getattr(queue, "put_front", None)
    if put_front is not None:
        for item in reversed(items):  # so that items[0] ends at the head
            try:
                put_front(item)
            except TransportClosed:
                return []
        return []
    deadline = time.monotonic() + timeout_s
    for i, item in enumerate(items):
        returned = False
        while time.monotonic() < deadline:
            wait = min(5.0, max(0.1, deadline - time.monotonic()))
            try:
                if queue.put_wait(item, timeout=wait):
                    returned = True
                    break
            except TransportClosed:
                return []
        if not returned:
            rest = items[i:]
            logger.warning("dropping %d %s(s): queue stayed full for %.0f s",
                           len(rest), what, timeout_s)
            return rest
    return []
