"""The yardstick: the card's peaks and the operations and bytes of each
kernel's work, computed from shapes.

The arithmetic is the one ``chip_smoke.py`` uses for its kernel table
(``_gemm_cost``, ``_conv3x3_cost`` and K1's byte count), copied here so
that a change to the program cannot change the yardstick. A bound counts
each input byte read once and each output byte written once; the least
time for a launch is the larger of its bytes over the memory rate and
its operations over the tensor cores' rate.

Peaks: one NVIDIA H100 SXM (data sheet, dense, at the 700 W limit).
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12  # CUDA cores, K1's arithmetic

Cost = Tuple[float, float]  # (bytes, operations) of one launch


def bound_s(nbytes: float, ops: float, ops_per_s: float = BF16_OPS_PER_S) -> float:
    """The least seconds a launch of ``nbytes`` and ``ops`` can take."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)


def bound_sum_s(costs: Iterable[Cost], ops_per_s: float = BF16_OPS_PER_S) -> float:
    return sum(bound_s(b, o, ops_per_s) for b, o in costs)


def gemm_cost(m: int, k: int, n: int, in_bytes_extra: int = 0) -> Cost:
    """A bf16 ``[m, k] @ [k, n]`` with f32 affines and a bf16 output."""
    return 2 * m * k + 2 * k * n + 8 * n + 2 * m * n + in_bytes_extra, 2.0 * m * n * k


def conv3x3_cost(m_out: int, cin: int, n: int, m_in: int, affine: bool = True) -> Cost:
    """One bf16 3x3 convolution: input, weight, affines, output, each once."""
    return (2 * m_in * cin + 2 * 9 * cin * n + (8 * n if affine else 0) + 2 * m_out * n,
            2.0 * m_out * 9 * cin * n)


def calib_cost(batch: int, frame: Sequence[int], raw_bytes: int, out_bytes: int) -> Cost:
    """One K1 launch over ``batch`` frames of ``frame = (P, H, W)``: the raw
    frames, f32 pedestal and gain and a byte of mask a pixel once, the
    output once; seven operations a pixel on the CUDA cores."""
    p, h, w = frame
    npix = batch * p * h * w
    return (npix * (raw_bytes + out_bytes) + p * h * w * (4 + 4 + 1), 7.0 * npix)


def conv_flops(m_out: int, k: int, cin: int, cout: int) -> float:
    """Multiply-adds of a ``k x k`` convolution, counted as two operations."""
    return 2.0 * m_out * k * k * cin * cout


def unet_level_costs(rows: int, h: int, w: int, features: Sequence[int]) -> List[Cost]:
    """The K4 launches of one PeakNet-TPU batch of ``rows`` images whose
    first level is ``h x w`` (after space-to-depth): levels 1..n-1 as conv,
    conv, down, the bottleneck as conv, conv."""
    costs: List[Cost] = []
    for i in range(1, len(features)):
        hi, wi = h >> i, w >> i
        m = rows * hi * wi
        cin, f = features[i - 1], features[i]
        costs.append(conv3x3_cost(m, cin, f, m))
        costs.append(conv3x3_cost(m, f, f, m))
        if i < len(features) - 1:
            m_down = rows * (hi // 2) * (wi // 2)
            costs.append(conv3x3_cost(m_down, f, f, m, affine=False))
    return costs


def bottleneck_costs(batch: int, h: int, w: int, stage_sizes: Sequence[int],
                     width: int) -> List[Cost]:
    """The K2 and K3 launches of one ResNet-50 batch whose first stage is
    ``h x w`` (after the stem and the pool): each block's 1x1 front, its
    3x3 middle (stride on it) and its back step with the identity or the
    strided projection."""
    costs: List[Cost] = []
    cin = width
    for i, n_blocks in enumerate(stage_sizes):
        f = width * 2 ** i
        cout = 4 * f
        for j in range(n_blocks):
            s = 2 if (i > 0 and j == 0) else 1
            m_in = batch * h * w
            h, w = h // s, w // s
            m_out = batch * h * w
            costs.append(gemm_cost(m_in, cin, f))
            costs.append((2 * m_in * f + 2 * 9 * f * f + 8 * f + 2 * m_out * f,
                          2.0 * m_out * f * 9 * f))
            if s == 1 and cin == cout:
                costs.append(gemm_cost(m_out, f, cout, in_bytes_extra=2 * m_out * cout))
            else:
                b_, o_ = gemm_cost(m_out, f, cout)
                costs.append((b_ + 2 * m_out * cin + 2 * cin * cout + 8 * cout,
                              o_ + 2.0 * m_out * cout * cin))
            cin = cout
    return costs
