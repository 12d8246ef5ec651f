"""Queue placement: the rendezvous ranking the queue server's worker
fleet pins queues by (:mod:`~psana_ray_tpu_torch.cluster.hashring`).

The port's copy of the part of ``psana_ray_tpu/cluster/`` that the worker
fleet needs. ``cluster://`` addressing, consumer groups and replication
are ROADMAP.md Queue 1 Item 8. Imports no torch.
"""
