"""Observability: the pipeline's stage vocabulary (:mod:`.stages`). The
JAX package's metrics server, tracer, flight recorder, history and
continuous profiler are not ported (ROADMAP.md Queue 1 Item 8)."""
