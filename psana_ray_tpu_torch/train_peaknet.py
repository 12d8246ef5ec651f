"""Streaming PeakNet-TPU training on one card: source -> ring -> infeed ->
train step -> (optionally) the folded serving tree.

The port's counterpart of the JAX package's ``examples/train_peaknet.py``,
with its flags: a producer thread streams RAW events of a seeded
``SyntheticSource`` into a ``RingBuffer``; ``InfeedPipeline`` batches and
stages them on the device; each batch is calibrated, labelled (calibrated
photons above 50) and trained on with the focal loss
(:func:`psana_ray_tpu_torch.train.make_peaknet_step`), until ``--steps``
steps end the stream (``StopStream``). ``--export-serving PATH`` folds the
BatchNorm statistics (:func:`fold_batchnorm`) and saves the serving tree
that :class:`~psana_ray_tpu_torch.sfx.SfxPipeline` serves (implies
``--norm batch``).

Run (small, on the CPU):

    python -m psana_ray_tpu_torch.train_peaknet --steps 4 --device cpu

Without ``--device`` it runs on the card. ``--checkpoint_dir DIR`` saves
the final train state, as the JAX package's example does at the end of
training, into ``DIR/train_state.npz``: the port's own file
(:func:`~psana_ray_tpu_torch.checkpoint.save_train_state`: params,
``batch_stats``, the AdamW moments and the step), not an orbax
directory. The module imports nothing but ``argparse`` until :func:`main`
runs, so importing the package does not load torch through it. The
package's ``train_peaknet`` is the training function of
:mod:`psana_ray_tpu_torch.train`; take this module's names with
``from psana_ray_tpu_torch.train_peaknet import main``.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

TRAIN_STATE_FILE = "train_state.npz"  # the file --checkpoint_dir holds


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=8, help="train steps to run")
    ap.add_argument("--batch", type=int, default=2, help="frames per batch")
    ap.add_argument("--detector", default="epix100")
    ap.add_argument("--num_events", type=int, default=32)
    ap.add_argument("--checkpoint_dir", default=None,
                    help="save the final train state (params, batch_stats, AdamW moments, "
                         "step) into this directory as train_state.npz")
    ap.add_argument("--norm", default="group", choices=["group", "batch"],
                    help="'group' (row-independent) or 'batch' (running statistics, which "
                         "--export-serving folds)")
    ap.add_argument("--export-serving", default=None, metavar="PATH", dest="export_serving",
                    help="after training, fold the BatchNorm statistics into frozen affines "
                         "and save the serving tree to this .npz file (implies --norm batch)")
    ap.add_argument("--features", default="16,32",
                    help="comma-separated encoder widths (64,128,256,512 is PeakNet-TPU's)")
    ap.add_argument("--s2d", type=int, default=2, choices=[2, 4], help="space-to-depth factor")
    ap.add_argument("--focal_alpha", type=float, default=0.95,
                    help="focal-loss weight of the peak class")
    ap.add_argument("--lr", type=float, default=3e-3, help="AdamW learning rate")
    ap.add_argument("--device", default=None, help="'cpu' for the plain versions; the card "
                    "by default")
    args = ap.parse_args(argv)
    try:
        args.features = tuple(int(f) for f in args.features.split(","))
    except ValueError:
        ap.error(f"--features {args.features!r} is not a comma-separated integer list")
    if args.export_serving:
        args.norm = "batch"
    return args


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    import threading
    import time

    import psana_ray_tpu_torch as pt
    from psana_ray_tpu_torch.transport import TransportClosed

    device = pt.resolve_device(args.device)
    src = pt.SyntheticSource(num_events=1, detector_name=args.detector, seed=0)
    # absolute gain (ADUs a photon): the net trains on photon-scale inputs,
    # the scale SfxPipeline serves
    calib = (src.pedestal(), src.spec.adu_gain * src.gain_map(), src.create_bad_pixel_mask())
    tree = pt.init_peaknet_tpu_params(args.features, s2d=args.s2d, seed=0, norm=args.norm)
    model = pt.unet_from_flax(tree, norm=args.norm, device=device)
    step = pt.make_peaknet_step(model, *calib, lr=args.lr, focal_alpha=args.focal_alpha,
                                device=device)

    stream = pt.SyntheticSource(num_events=args.num_events, detector_name=args.detector, seed=0)
    ring = pt.RingBuffer(maxsize=4 * args.batch)

    def produce():
        try:
            pt.produce(stream.iter_indexed_events("raw"), ring)
        except TransportClosed:
            pass  # the trainer stopped the stream before its end

    producer = threading.Thread(target=produce, daemon=True)
    producer.start()
    pipe = pt.InfeedPipeline(ring, batch_size=args.batch, device=device, poll_interval_s=0.001)
    losses, frames = [], [0]
    t0 = time.perf_counter()

    def train_on(batch):
        loss = step(batch.frames, batch.valid)
        if loss is None:
            return  # a partial batch: its padding would enter the batch statistics
        losses.append(float(loss))
        frames[0] += batch.num_valid
        print(f"step {len(losses)}: loss {losses[-1]:.5f}", flush=True)
        if len(losses) >= args.steps:
            raise pt.StopStream

    try:
        pipe.run(train_on)
    finally:
        ring.close()
        producer.join(timeout=60)
    dt = time.perf_counter() - t0
    trend = f"; loss {losses[0]:.5f} -> {losses[-1]:.5f}" if losses else ""
    print(f"trained {len(losses)} steps on {frames[0]} frames in {dt:.1f}s (device={device})"
          f"{trend}")
    if args.checkpoint_dir:
        from psana_ray_tpu_torch.optim import adam_moments

        path = os.path.join(args.checkpoint_dir, TRAIN_STATE_FILE)
        pt.save_train_state(path, pt.unet_to_flax(model), adam_moments(model, step.optimizer),
                            step.optimizer.updates)
        print(f"train state (step {step.optimizer.updates}) saved to {path}")
    if args.export_serving:
        pt.export_serving_params(pt.unet_to_flax(model), args.export_serving)
        print(f"serving params (norm='frozen' form) exported to {args.export_serving}: "
              f"load_params -> SfxPipeline or unet_from_flax")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
