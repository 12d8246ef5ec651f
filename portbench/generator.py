"""The traffic generator: seeded detector frames and the source that feeds
them to the program.

:func:`make_data` draws, on the device and in bulk, a pool of raw frames
and the calibration constants with the arithmetic of the port's
``SyntheticSource`` (``sources/synthetic.py``): a pedestal of
``adu_offset + 3 N`` ADUs, a relative gain ``1 + 0.02 N``, a bad-pixel
mask, Poisson(0.08) photons with Bragg-like Gaussian peaks planted (a
panel, a centre, 50-800 photons, a width of 0.8-2.2 pixels),
``adu_gain`` ADUs a photon, a common-mode offset a panel of U(-8, 8) and
2.5 ADU of read noise, clipped and rounded to the raw type. The frames
are copied to the host once; the constants stay on the device.

:class:`Source` is one thread that puts the pool's frames, cycled, into
the program's in-process ``RingBuffer`` through the program's
``produce``: as fast as the ring takes them (``"arrival": "backlog"``)
or one every ``1 / rate_hz`` seconds on a fixed clock (``"periodic"``,
as a detector fires). A traffic file (``traffic/<name>.json``) gives the batch, the
raw type, the pool's size, the arrivals, the ring's slots, the warm-up
batches and the batches sampled for the comparison.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from portbench.weights import generator

PEAK_RADIUS = 10  # pixels around a peak's centre that its Gaussian is drawn over


def make_data(detector: Dict, traffic: Dict, seed: int, device) -> Dict:
    """``{"pool": [N, P, H, W] numpy raw frames, "energy": [N] keV,
    "pedestal", "gain", "mask": [P, H, W] on the device}``."""
    if traffic["raw_dtype"] != "uint16":
        raise ValueError(f"raw_dtype {traffic['raw_dtype']!r}: uint16, as epix10k2M's raw")
    p, h, w = detector["panels"], detector["height"], detector["width"]
    n = int(traffic["pool_frames"])
    g = generator(seed, device)
    ped = detector["adu_offset"] + 3.0 * torch.randn((p, h, w), generator=g, device=device)
    gain = 1.0 + 0.02 * torch.randn((p, h, w), generator=g, device=device)
    mask = (torch.rand((p, h, w), generator=g, device=device)
            >= detector["bad_pixel_fraction"]).to(torch.uint8)
    photons = torch.poisson(torch.full((n, p, h, w), 0.08, device=device), generator=g)
    _plant_peaks(photons, int(traffic["peak_count"]), g)
    raw = photons.mul_(gain).mul_(detector["adu_gain"]).add_(ped)
    raw += 16.0 * torch.rand((n, p, 1, 1), generator=g, device=device) - 8.0
    raw += 2.5 * torch.randn((n, p, h, w), generator=g, device=device)
    # through int16 with the same bits: every torch build copies int16
    adu = raw.clamp_(0.0, 65535.0).round_().to(torch.int32)
    pool = torch.where(adu > 32767, adu - 65536, adu).to(torch.int16).cpu().numpy().view(np.uint16)
    del raw, photons, adu
    energy = (8.0 + 4.0 * torch.rand(n, generator=g, device=device, dtype=torch.float64)).cpu()
    return {"pool": np.ascontiguousarray(pool), "energy": energy.numpy(),
            "pedestal": ped, "gain": gain, "mask": mask}


def _plant_peaks(photons: torch.Tensor, peak_count: int, g: torch.Generator) -> None:
    """Add ``peak_count // 2 .. peak_count`` Gaussian peaks to each frame of
    ``photons [N, P, H, W]``, in place."""
    n, p, h, w = photons.shape
    dev = photons.device
    k = peak_count
    keep = (torch.arange(k, device=dev)[None, :]
            < torch.randint(k // 2, k + 1, (n, 1), generator=g, device=dev))
    panel = torch.randint(0, p, (n, k), generator=g, device=dev)
    cy = 4.0 + (h - 8) * torch.rand((n, k), generator=g, device=dev)
    cx = 4.0 + (w - 8) * torch.rand((n, k), generator=g, device=dev)
    amp = (50.0 + 750.0 * torch.rand((n, k), generator=g, device=dev)) * keep
    sig = 0.8 + 1.4 * torch.rand((n, k), generator=g, device=dev)
    r = torch.arange(-PEAK_RADIUS, PEAK_RADIUS + 1, device=dev)
    ys = (cy.floor().long()[..., None] + r).clamp(0, h - 1)  # [n, k, R]
    xs = (cx.floor().long()[..., None] + r).clamp(0, w - 1)
    dy2 = (ys.float() - cy[..., None]) ** 2
    dx2 = (xs.float() - cx[..., None]) ** 2
    val = amp[..., None, None] * torch.exp(
        -(dy2[..., :, None] + dx2[..., None, :]) / (2.0 * sig[..., None, None] ** 2))
    frame = torch.arange(n, device=dev)[:, None, None, None]
    flat = ((frame * p + panel[..., None, None]) * h + ys[..., :, None]) * w + xs[..., None, :]
    # clamped duplicates at the edges add the same pixel twice: the window
    # stays 4 px off the edge and the Gaussian is negligible there
    photons.view(-1).index_add_(0, flat.reshape(-1), val.reshape(-1))


class Source:
    """One thread feeding ``ring`` with the pool's frames, cycled, through
    the program's ``produce``; :meth:`stop` ends the stream (the program
    then reads the end-of-stream marker after the last frame put)."""

    def __init__(self, ring, pool: np.ndarray, energy: np.ndarray, traffic: Dict):
        from psana_ray_tpu_torch.producer import produce

        self._produce = produce
        self.ring = ring
        self.pool = pool
        self.energy = energy
        self.period = 0.0
        if traffic["arrival"] == "periodic":
            self.period = 1.0 / float(traffic["rate_hz"])
        elif traffic["arrival"] != "backlog":
            raise ValueError(f"unknown arrival {traffic['arrival']!r}")
        self.n_put: Optional[int] = None
        self.error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="portbench-source", daemon=True)

    def start(self) -> "Source":
        self._thread.start()
        return self

    def _events(self):
        n = len(self.pool)
        t0 = time.monotonic()
        i = 0
        while not self._stop.is_set():
            if self.period:
                wait = t0 + i * self.period - time.monotonic()
                if wait > 0 and self._stop.wait(wait):
                    return
            yield i, self.pool[i % n], float(self.energy[i % n])
            i += 1

    def _run(self):
        try:
            self.n_put = self._produce(self._events(), self.ring)
        except BaseException as e:  # surfaced by join()
            self.error = e

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout: float = 120.0) -> int:
        """Wait for the thread; returns the events put. Raises its error,
        or ``TimeoutError`` if it is still putting."""
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError(f"the source thread is still putting after {timeout} s")
        if self.error is not None:
            raise self.error
        return int(self.n_put)
