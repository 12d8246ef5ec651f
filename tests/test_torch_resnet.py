"""The port's fused ResNet path against the JAX package's.

The same numpy inputs and the same (converted, perturbed) flax weights go
through ``psana_ray_tpu.models.pallas_resnet`` (Pallas kernels in
interpret mode) and ``psana_ray_tpu_torch.models.fused_resnet`` (the
kernels' plain versions on CPU tensors). Tolerance: ``_rel_err < 0.05``,
the JAX package's own for bf16 activations with f32 accumulation
(``tests/test_pallas_resnet.py``). Affines are perturbed away from the
init constants, which would hide broadcast faults and leave logits too
small for the relative error to mean anything.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax.core import meta  # noqa: E402

import psana_ray_tpu.models.pallas_resnet as pr  # noqa: E402
from psana_ray_tpu.models.resnet import BottleneckBlock as JaxBlock  # noqa: E402
from psana_ray_tpu.models.resnet import ResNetClassifier as JaxResNet  # noqa: E402
from psana_ray_tpu_torch.convert import block_from_flax, resnet_from_flax  # noqa: E402
from psana_ray_tpu_torch.models import fused_resnet as fr  # noqa: E402
from psana_ray_tpu_torch.models.resnet import ResNetClassifier  # noqa: E402
from torch_parity import (  # noqa: E402
    check_norm_kind,
    norm_variables,
    one_torch_thread,
    perturbed,
    rel_err,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REL_TOL = 0.05
STAGES = (3, 4, 6, 3)


def flax_params(module, x, rng):
    variables = module.init(jax.random.key(0), jnp.asarray(x))
    return perturbed(jax.tree.map(np.asarray, meta.unbox(variables)["params"]), rng)


def jax_tree(params):
    return {"params": jax.tree.map(jnp.asarray, params)}


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def _jax_block(params, x, stride):
    w1, w2, w3, aff, wp = pr._block_params(params)
    return pr.fused_bottleneck(jnp.asarray(x).astype(jnp.bfloat16), w1, w2, w3, aff, wp=wp,
                               stride=stride, interpret=True)


def _check_block(rng, cin, f, stride, proj):
    x = rng.normal(size=(2, 16, 16, cin)).astype(np.float32)
    params = flax_params(JaxBlock(features=f, strides=(stride, stride), norm="frozen"), x, rng)
    assert ("proj" in params) == proj
    ref = _jax_block(jax.tree.map(jnp.asarray, params), x, stride)
    blk = fr.pack_block(block_from_flax(params, stride))
    got = fr.fused_bottleneck(_bf16(x), blk)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    err = rel_err(ref, got.float().numpy())
    print(f"rel_err {err}")  # observed values: pytest -rP
    assert err < REL_TOL, err


@pytest.mark.parametrize(
    "cin,f,stride,proj",
    [
        (64, 16, 1, False),  # identity block (cin == 4f)
        (32, 16, 1, True),  # projection, stride 1
        (64, 32, 2, True),  # projection + downsample
    ],
)
def test_fused_bottleneck_matches_jax(rng, cin, f, stride, proj):
    _check_block(rng, cin, f, stride, proj)


@pytest.mark.parametrize("cin,f,stride,proj", [(64, 16, 1, False), (64, 32, 2, True)])
def test_split_back_step_matches_jax(rng, monkeypatch, cin, f, stride, proj):
    """The JAX block split into its front half (K2, ``emit="y2"``) and its
    back kernel (K3) under a starved VMEM budget, as the stage-4
    projection block runs on the TPU; the port's back step is the same
    launch in every block."""
    monkeypatch.setattr(pr, "_VMEM_BUDGET", 1 << 20)
    _check_block(rng, cin, f, stride, proj)


def test_whole_network_matches_jax(rng):
    """Full ResNet-50 depth at width 16 on ``[2, 64, 64, 4]``: logits and
    pooled features. The JAX reference returns only logits, so its head
    is widened with an identity block that passes the features through."""
    x = rng.normal(size=(2, 64, 64, 4)).astype(np.float32)
    params = flax_params(JaxResNet(stage_sizes=STAGES, num_classes=2, width=16, norm="frozen"),
                         x, rng)
    head_k, head_b = params["head"]["kernel"], params["head"]["bias"]
    c = head_k.shape[0]
    wide = dict(params, head={"kernel": np.concatenate([np.eye(c, dtype=np.float32), head_k], 1),
                              "bias": np.concatenate([np.zeros(c, np.float32), head_b])})
    out = np.asarray(pr.resnet_fused_infer(jax_tree(wide), jnp.asarray(x), stage_sizes=STAGES,
                                           interpret=True))
    ref_feat, ref_logits = out[:, :c], out[:, c:]

    model = resnet_from_flax(params, STAGES)
    packed = fr.pack_fused(model)
    # width 16: F and the stem's channels padded to 64, as the card's kernels need
    assert packed.blocks[0].w1.shape == (64, 64) and packed.blocks[0].w2.shape == (64, 9 * 64)
    logits, feat = fr.resnet_fused_infer(packed, torch.from_numpy(x), STAGES,
                                         return_features=True)
    assert tuple(logits.shape) == (2, 2) and tuple(feat.shape) == (2, c)
    errs = {"logits": rel_err(ref_logits, logits.numpy()), "features": rel_err(ref_feat, feat.numpy())}
    # the port's plain oracle against the flax model
    flax_logits = JaxResNet(stage_sizes=STAGES, num_classes=2, width=16, norm="frozen").apply(
        jax_tree(params), jnp.asarray(x))
    errs["plain_vs_flax"] = rel_err(flax_logits, model(torch.from_numpy(x)).detach().numpy())
    print(f"rel_err {errs}")  # observed values: pytest -rP
    assert np.abs(ref_feat).max() >= 1e-2
    assert max(errs.values()) < REL_TOL, errs


def test_small_extent_falls_back_to_plain_model(rng):
    """Inputs too small for the strided stages take the plain forward
    (a shape rule of the reference, ``pallas_resnet.py:541-552``)."""
    x = rng.normal(size=(3, 16, 128, 2)).astype(np.float32)
    params = flax_params(JaxResNet(stage_sizes=STAGES, num_classes=2, width=16, norm="frozen"),
                         x, rng)
    ref = pr.resnet_fused_infer(jax_tree(params), jnp.asarray(x), stage_sizes=STAGES)
    model = resnet_from_flax(params, STAGES)
    got = fr.resnet_fused_infer(fr.pack_fused(model), torch.from_numpy(x), STAGES)
    torch.testing.assert_close(got, model(torch.from_numpy(x)), rtol=0, atol=0)
    assert rel_err(ref, got.numpy()) < REL_TOL


def test_stride2_needs_even_extent():
    """The reference's fused block takes ``h // s`` rows where flax SAME
    takes ``ceil(h / 2)``; they agree only on even extents, so the port
    refuses odd ones."""
    x = torch.zeros(1, 7, 8, 32, dtype=torch.bfloat16)
    w = torch.zeros(32, 9 * 32, dtype=torch.bfloat16)  # K-major
    s = torch.ones(32)
    with pytest.raises(ValueError, match="even"):
        fr.conv3x3(x, w, s, s, stride=2)


def test_stage_sizes_must_match_packed_blocks():
    params = fr.pack_fused(ResNetClassifier((1, 1), in_channels=2, width=8))
    with pytest.raises(ValueError, match="stage_sizes"):
        fr.resnet_fused_infer(params, torch.zeros(1, 32, 32, 2), stage_sizes=(1, 2))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["group", "batch", "batch_eval"])
def test_norm_kinds_match_flax(rng, kind, dtype):
    """Every trainable norm kind of a two-stage ResNet against flax's."""
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jmodel = JaxResNet(stage_sizes=(1, 1), num_classes=2, width=8, norm=kind, dtype=jdt)
    variables = norm_variables(jmodel, x, rng)
    check_norm_kind(jmodel, lambda v: resnet_from_flax(v, (1, 1), norm=kind, dtype=tdt), x,
                    variables, kind, dtype)


def test_unknown_norm_kind_raises():
    """The reference takes any unknown kind as "group"; the port refuses it."""
    with pytest.raises(ValueError, match="norm kind"):
        ResNetClassifier((1, 1), in_channels=2, width=8, norm="layer")


def test_plain_versions_use_xla_same_padding(rng):
    """The 3x3 plain version pads (1,1) at stride 1 and (0,1) at stride 2,
    against a direct loop over taps on the bf16-rounded operands."""
    x = _bf16(rng.normal(size=(1, 6, 8, 4)).astype(np.float32))
    w = _bf16(rng.normal(size=(9 * 4, 4)).astype(np.float32))
    s, b = torch.ones(4), torch.zeros(4)
    for stride, lo in ((1, 1), (2, 0)):
        got = fr.conv3x3_plain(x, w, s, b, stride).float()
        xf, wf = x.float(), w.float().reshape(3, 3, 4, 4)
        ho, wo = 6 // stride, 8 // stride
        acc = torch.zeros(1, ho, wo, 4)
        for dy in range(3):
            for dx in range(3):
                for oy in range(ho):
                    for ox in range(wo):
                        iy, ix = oy * stride + dy - lo, ox * stride + dx - lo
                        if 0 <= iy < 6 and 0 <= ix < 8:
                            acc[0, oy, ox] += xf[0, iy, ix] @ wf[dy, dx]
        want = torch.nn.functional.silu(acc).to(torch.bfloat16).float()
        torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)
