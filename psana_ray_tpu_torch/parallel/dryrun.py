"""The five legs of the multi-device dry run, each on the initialised
default group: counterpart of ``__graft_entry__.dryrun_multichip`` and
its ``_dryrun_*`` legs (``__graft_entry__.py:63-366``).

1. :func:`leg_resnet_train`: one sharded training step of ResNet-18
   (width 32, GroupNorm, bf16) on a ``("data", "model")`` mesh, the
   ``model`` axis 2 wide where the world size is even: DP x TP, each
   ``channels_out`` axis sharded at rest.
2. :func:`leg_flagship_serving`: config 4's serving step (K1 to bf16,
   then the fused ResNet-50 of K2 and K3 at the real stage sizes) over a
   ``("data",)`` mesh through :func:`make_infer_step`, one 4 x 32 x 32
   frame a rank, against the same step on the whole batch (a bf16 path:
   ``rel_err < 0.05``, the port's tolerance for every bf16 path).
3. :func:`leg_sequence_parallel`: the ViT with Ulysses-flash attention
   over a ``("data", "seq")`` mesh, served (against the single-device
   flash path on the same weights) and trained one step.
4. :func:`leg_pipeline_parallel`: the scanned-trunk ViT with its trunk
   as GPipe stages over a ``("data", "pipe")`` mesh, served (against the
   plain forward) and differentiated.
5. :func:`leg_expert_parallel`: the MoE ViT (1,056 tokens: grouped
   dispatch active) over a ``("data", "expert")`` mesh, its expert
   weights sharded on ``expert``, served (against the single-device
   forward) and trained one step with ``aux_loss_weight=0.01``.

On the CPU the ViT legs run at the reference's shapes (patch 8, embed
64, 4 heads, f32; 16 and 1,056 tokens) and its tolerances. ``flash_kernel``
takes bf16 with head dim 128 and sequences of multiples of 128, and the
card runs no plain version in its place, so there they run at embed 512
(4 heads of 128) in bf16 on 256 and 1,152 tokens, checked at the port's
bf16 tolerance (``rel_err < 0.05``). Each leg returns its numbers (and,
with ``keep``, its parameters, outputs and gradients as numpy) for the
caller to hold against the JAX package.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from psana_ray_tpu_torch.parallel.compat import DTensor, all_gather, collective_counts
from psana_ray_tpu_torch.parallel.mesh import axis_size, create_mesh, local_rows

REL_TOL = 0.05  # the port's bf16 tolerance on the card
LEGS = ("resnet_train", "flagship_serving", "sequence_parallel", "pipeline_parallel",
        "expert_parallel")


def _on_card(device: torch.device) -> bool:
    return device.type == "cuda"


def _vit_kwargs(device: torch.device) -> Dict[str, Any]:
    if _on_card(device):
        return dict(num_heads=4, dtype=torch.bfloat16)
    return dict(num_heads=4, dtype=torch.float32)


def _vit_shapes(device: torch.device):
    """(embed, SP/PP frame, MoE frame): the reference's on the CPU, the
    flash kernel's smallest on the card."""
    if _on_card(device):
        return 512, (2, 64, 128), (4, 96, 192)
    return 64, (2, 16, 32), (4, 96, 176)


def _rel_err(ref: torch.Tensor, got: torch.Tensor) -> float:
    ref, got = ref.float(), got.float()
    return float((ref - got).abs().max() / ref.abs().max().clamp_min(1e-3))


def _check_close(got: torch.Tensor, want: torch.Tensor, bf16: bool, rtol=1e-4,
                 atol=1e-3) -> float:
    """The reference's ``assert_allclose`` in f32; ``rel_err < 0.05`` in
    bf16, where the rows' grouping into batches changes the order of the
    f32 sums that each layer rounds to bf16."""
    err = _rel_err(want, got)
    if bf16:
        if not err < REL_TOL:
            raise AssertionError(f"rel_err {err} >= {REL_TOL}")
    else:
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                                   rtol=rtol, atol=atol)
    return err


def numpy_state(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """Every parameter and buffer whole, as f32 numpy, by state_dict key."""
    out = {}
    for k, t in model.state_dict().items():
        t = t.full_tensor() if isinstance(t, DTensor) else t
        out[k] = t.detach().float().cpu().numpy()
    return out


def placements(model: torch.nn.Module) -> Dict[str, list]:
    """Each parameter's DTensor placements, as strings."""
    return {k: [str(p) for p in v.placements] for k, v in model.named_parameters()
            if isinstance(v, DTensor)}


def _frames(seed: int, shape, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device)


def _xent(logits, aux):
    from psana_ray_tpu_torch.models.losses import masked_softmax_xent

    return masked_softmax_xent(logits, aux[0], aux[1])


def _labels(batch: int, device):
    return (torch.arange(batch, device=device) % 2,
            torch.ones(batch, dtype=torch.uint8, device=device))


def _adamw(lr: float = 1e-3):
    from psana_ray_tpu_torch.optim import adamw

    return lambda ps: adamw(ps, lambda n: lr)  # optax.adamw(lr): weight decay 1e-4


def leg_resnet_train(device: torch.device, tree: Optional[Mapping] = None,
                     dtype: torch.dtype = torch.bfloat16, keep: bool = False) -> Dict[str, Any]:
    """DP x TP: ResNet-18 (width 32, GroupNorm) one training step
    (``__graft_entry__.py:106-134``)."""
    from psana_ray_tpu_torch.convert import resnet18_from_flax
    from psana_ray_tpu_torch.models.heads import panels_to_nhwc
    from psana_ray_tpu_torch.models.init import init_resnet_params
    from psana_ray_tpu_torch.parallel.steps import create_train_state, make_train_step

    n = dist.get_world_size()
    tp = 2 if n % 2 == 0 else 1
    mesh = create_mesh(("data", "model"), (n // tp, tp), device_type=device.type)
    if tree is None:
        tree = init_resnet_params(in_channels=4, stage_sizes=(2, 2, 2, 2), width=32,
                                  block="basic", norm="group", seed=0)
    model = resnet18_from_flax(tree, norm="group", dtype=dtype).to(device)
    batch = 2 * axis_size(mesh, "data")
    x = panels_to_nhwc(_frames(0, (batch, 4, 32, 32), device))
    state = create_train_state(model, _adamw(), mesh)
    step = make_train_step(model, state.optimizer, _xent)
    state, loss = step(state, x, _labels(batch, device))
    loss = float(loss)
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    if int(state.step.full_tensor()) != 1:
        raise AssertionError(f"step count {state.step} after one step")
    out = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "batch": batch, "loss": loss,
           "placements": placements(model)}
    if keep:
        out["state"] = numpy_state(model)
    return out


def leg_flagship_serving(device: torch.device, tree: Optional[Mapping] = None,
                         keep: bool = False) -> Dict[str, Any]:
    """Config 4's serving step over ``data`` (``__graft_entry__.py:308-360``):
    K1 (bf16 out) then the fused ResNet-50 (K2, K3), a frame a rank."""
    from psana_ray_tpu_torch.convert import resnet_from_flax
    from psana_ray_tpu_torch.models import pack_fused, panels_to_nhwc, resnet_fused_infer
    from psana_ray_tpu_torch.models.init import init_resnet_params
    from psana_ray_tpu_torch.ops import fused_calibrate
    from psana_ray_tpu_torch.parallel.steps import make_infer_step

    n = dist.get_world_size()
    mesh = create_mesh(("data",), (n,), device_type=device.type)
    rng = np.random.default_rng(1)
    panels, h, w = 4, 32, 32
    t = functools.partial(torch.tensor, device=device)
    pedestal = t(rng.normal(90.0, 3.0, (panels, h, w)).astype(np.float32))
    gain = t((1 + 0.05 * rng.standard_normal((panels, h, w))).astype(np.float32))
    mask = t((rng.random((panels, h, w)) > 0.02).astype(np.float32))
    frames = t(rng.normal(100.0, 12.0, (n, panels, h, w)).astype(np.float32))
    if tree is None:
        tree = init_resnet_params(in_channels=panels, seed=0)
    params = pack_fused(resnet_from_flax(tree, device=device))

    def serve(frames):
        c = fused_calibrate(frames, pedestal, gain, mask, threshold=10.0,
                            out_dtype=torch.bfloat16)
        return resnet_fused_infer(params, panels_to_nhwc(c))

    logits = make_infer_step(serve, mesh)(frames)
    if tuple(logits.shape) != (n, 2) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"flagship logits {tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    with torch.no_grad():
        single = serve(frames)
    err = _check_close(logits, single, bf16=True)
    out = {"mesh": {"data": n}, "batch": n, "rel_err": err}
    if keep:
        out["logits"] = logits.float().cpu().numpy()
    return out


def _vit(tree, device, **kw):
    from psana_ray_tpu_torch.convert import vit_from_flax

    return vit_from_flax(tree, device=device, **_vit_kwargs(device), **kw)


def leg_sequence_parallel(device: torch.device, tree: Optional[Mapping] = None,
                          keep: bool = False) -> Dict[str, Any]:
    """Ulysses-flash ViT over ``("data", "seq")``: sharded serving against
    the single-device flash path, then one training step
    (``__graft_entry__.py:143-201``)."""
    from psana_ray_tpu_torch.models.init import init_vit_params
    from psana_ray_tpu_torch.parallel.ring_attention import ulysses_attention
    from psana_ray_tpu_torch.parallel.steps import (
        create_train_state,
        make_infer_step,
        make_train_step,
    )

    n = dist.get_world_size()
    sp = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    mesh = create_mesh(("data", "seq"), (n // sp, sp), device_type=device.type)
    embed, frame, _ = _vit_shapes(device)
    if tree is None:
        tree = init_vit_params(frame, patch=8, embed_dim=embed, depth=2, seed=3)
    attn = functools.partial(ulysses_attention, mesh=mesh, seq_axis="seq", data_axis="data",
                             impl="flash")
    model = _vit(tree, device, attn_fn=attn)
    single = _vit(tree, device)
    batch = 2 * axis_size(mesh, "data")
    frames = _frames(2, (batch, *frame), device)
    state = create_train_state(model, _adamw(), mesh)
    infer = make_infer_step(model, mesh)(frames)
    with torch.no_grad():
        want = single(frames)
    err = _check_close(infer, want, bf16=_on_card(device))
    step = make_train_step(model, state.optimizer, _xent)
    state, loss = step(state, frames, _labels(batch, device))
    if not np.isfinite(float(loss)):
        raise AssertionError(f"non-finite SP loss {float(loss)}")
    out = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "batch": batch,
           "loss": float(loss), "rel_err": err}
    if keep:
        out.update(logits=infer.float().cpu().numpy(), state=numpy_state(model))
    return out


def leg_pipeline_parallel(device: torch.device, tree: Optional[Mapping] = None,
                          keep: bool = False) -> Dict[str, Any]:
    """The scanned-trunk ViT as GPipe stages over ``("data", "pipe")``:
    pipelined serving against the plain forward, and the gradient of
    ``sum(logits**2)`` through the pipeline (``__graft_entry__.py:204-246``)."""
    from psana_ray_tpu_torch.models.init import init_vit_params
    from psana_ray_tpu_torch.models.vit import vit_pipelined_apply

    n = dist.get_world_size()
    pipe = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    mesh = create_mesh(("data", "pipe"), (n // pipe, pipe), device_type=device.type)
    embed, frame, _ = _vit_shapes(device)
    if tree is None:
        tree = init_vit_params(frame, patch=8, embed_dim=embed, depth=pipe, seed=5,
                               scan_trunk=True)
    model = _vit(tree, device)
    batch = 2 * axis_size(mesh, "data") * pipe  # pipe microbatches a data group
    frames = _frames(4, (batch, *frame), device)
    with torch.no_grad():
        want = model(frames)
        got = all_gather(vit_pipelined_apply(model, local_rows(frames, mesh), mesh,
                                             data_axis="data"), mesh.get_group("data"), 0)
    err = _check_close(got, want, bf16=_on_card(device), atol=1e-4)
    # every rank of a data group computes its rows' logits: the objective
    # is that group's sum over the pipe ranks' number of copies
    model.zero_grad(set_to_none=True)
    y = vit_pipelined_apply(model, local_rows(frames, mesh), mesh, data_axis="data")
    (y.float().pow(2).sum() / pipe).backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    flat = torch.cat([g.reshape(-1).float() for g in grads.values()])
    dist.all_reduce(flat)
    if not bool(torch.isfinite(flat).all()):
        raise AssertionError("non-finite PP grads")
    out = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "batch": batch, "rel_err": err}
    if keep:
        off, kept = 0, {}
        for k, g in grads.items():
            kept[k] = flat[off:off + g.numel()].view(g.shape).cpu().numpy()
            off += g.numel()
        out.update(logits=got.float().cpu().numpy(), grads=kept)
    return out


def leg_expert_parallel(device: torch.device, tree: Optional[Mapping] = None,
                        keep: bool = False) -> Dict[str, Any]:
    """The MoE ViT over ``("data", "expert")``, expert weights sharded on
    ``expert``: serving against the single-device forward, then one
    training step with the router loss at 0.01 (``__graft_entry__.py:249-305``)."""
    from psana_ray_tpu_torch.models.init import init_vit_params
    from psana_ray_tpu_torch.parallel.moe import pick_group_size
    from psana_ray_tpu_torch.parallel.steps import (
        create_train_state,
        make_infer_step,
        make_train_step,
    )

    n = dist.get_world_size()
    ep = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    mesh = create_mesh(("data", "expert"), (n // ep, ep), device_type=device.type)
    embed, _, frame = _vit_shapes(device)
    n_tokens = frame[0] * (frame[1] // 8) * (frame[2] // 8)
    if not pick_group_size(n_tokens, 512) < n_tokens:
        raise AssertionError("grouped dispatch is not active")
    if tree is None:
        tree = init_vit_params(frame, patch=8, embed_dim=embed, depth=2, seed=7,
                               moe_experts=ep, scan_trunk=True)
    model = _vit(tree, device)
    single = _vit(tree, device)
    batch = 2 * axis_size(mesh, "data")
    frames = _frames(6, (batch, *frame), device)
    state = create_train_state(model, _adamw(), mesh)
    w_up = model.trunk.blocks.block.moe.w_up
    if str(w_up.placements[list(mesh.mesh_dim_names).index("expert")]) != "S(1)":
        raise AssertionError(f"expert weights not sharded on the expert axis: {w_up.placements}")
    infer = make_infer_step(model, mesh)(frames)
    with torch.no_grad():
        want = single(frames)
    err = _check_close(infer, want, bf16=_on_card(device), atol=1e-4)
    step = make_train_step(model, state.optimizer, _xent, aux_loss_weight=0.01)
    state, loss = step(state, frames, _labels(batch, device))
    if not np.isfinite(float(loss)):
        raise AssertionError(f"non-finite EP loss {float(loss)}")
    out = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "batch": batch,
           "tokens": n_tokens, "loss": float(loss), "rel_err": err,
           "placements": placements(model)}
    if keep:
        out.update(logits=infer.float().cpu().numpy(), state=numpy_state(model))
    return out


def run_legs(device: torch.device) -> Dict[str, Any]:
    """The five legs in order on the initialised default group, each from
    its seeded init; every leg's result, and the collectives of the run
    under ``"collectives"``."""
    out = {name: globals()[f"leg_{name}"](device) for name in LEGS}
    out["collectives"] = collective_counts()
    return out


def rank_legs(rank: int, device_type: str) -> Dict[str, Any]:
    """:func:`run_legs` on a rank that ``parallel.mesh.run_ranks`` started."""
    return run_legs(torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu"))
