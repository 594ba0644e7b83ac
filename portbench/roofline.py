"""The card's peaks and the least time a kernel's work could take.

Peaks: NVIDIA H100 SXM data sheet, at the 700 W power limit: 67 TFLOP/s
in float32 outside the tensor cores, 3.35 TB/s of HBM. The bound of a
piece of work is the larger of its operations over the first and its
bytes over the second, each input byte read once and each output byte
written once.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
F32_FLOPS_S = 67e12


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / F32_FLOPS_S, nbytes / HBM_BYTES_S)


def _span_sum(n: int, step: int, extent: int, rad: int) -> int:
    """Sum over the grid positions 0, step, ... (n of them) of the window
    of radius ``rad`` clipped to [0, extent)."""
    return sum(min(q, rad) + min(extent - 1 - q, rad) + 1 for q in range(0, n * step, step))


def k1_pass_work(h: int, w: int, c: int, psz: int, rad: int, has_prev: bool,
                 has_basic: bool) -> tuple[float, float]:
    """(FLOPs, bytes) of one NL-Kalman pass, counted from shapes and pass
    parameters alone: the separable psz x psz DCT of each band (4 psz^3 a
    patch), the distance of every candidate of every site (sites every
    psz/2, candidates within ``rad`` and inside the frame; 3 FLOPs a
    coefficient), the inverse DCT and the window fold. The group
    statistics are left out, so this is a lower bound. Bytes: the frames
    read once and the output written once."""
    step = psz // 2
    hh, ww, f = h - psz + 1, w - psz + 1, psz * psz * c
    ny, nx = (hh - 1) // step + 1, (ww - 1) // step + 1
    n_cand = _span_sum(ny, step, hh, rad) * _span_sum(nx, step, ww, rad)
    n_bands = 1 + int(has_basic) + int(has_prev)
    flops = (n_bands + 1) * hh * ww * c * 4 * psz ** 3 + n_cand * f * 3 \
        + h * w * c * psz * psz * 2
    nbytes = h * w * (4 * c * (2 + int(has_basic) + int(has_prev)) + int(has_prev))
    return float(flops), float(nbytes)
