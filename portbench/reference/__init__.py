"""Plain f32 PyTorch references of what the benchmark's cells serve:
calibration, PeakNet-TPU, ResNet-50 and ``find_peaks``, written from
frozen copies of the math. They import nothing of the port or of JAX and
take only the seeded inputs and weight trees the benchmark makes.

Every function takes ``rnd``, the rounding applied where the served
program stores a value (weights, the calibrated frames, each layer's
output): the identity for the reference itself, a lower precision for
the control (:mod:`portbench.reference.precision`).
"""
