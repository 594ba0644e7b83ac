"""Flow-accuracy measurement (the reference's unbuilt main_mesure.c,
lib/tvl1flow/main_mesure.c): end-point and angular error between a
computed flow and ground truth, per-frame and aggregated.

The port's copy of ``bwd_nlkalman_tpu.flow.measure``, in numpy: it takes
host arrays (a flow on the card comes over with ``.cpu().numpy()``)."""

from __future__ import annotations

import numpy as np


def endpoint_error(flow: np.ndarray, gt: np.ndarray) -> dict:
    """EPE statistics between (H, W, 2) flows (gt may contain the
    Middlebury 'unknown' sentinel > 1e9, which is masked out)."""
    flow = np.asarray(flow, np.float64)
    gt = np.asarray(gt, np.float64)
    valid = np.all(np.abs(gt) < 1e9, axis=-1)
    d = np.sqrt(np.sum((flow - gt) ** 2, axis=-1))[valid]
    return {
        "epe_mean": float(d.mean()),
        "epe_median": float(np.median(d)),
        "epe_p95": float(np.percentile(d, 95)),
        "frac_gt_1px": float((d > 1.0).mean()),
        "frac_gt_3px": float((d > 3.0).mean()),
    }


def angular_error(flow: np.ndarray, gt: np.ndarray) -> dict:
    """Mean angular error in degrees (Barron convention: 3-vectors
    (u, v, 1) normalized)."""
    flow = np.asarray(flow, np.float64)
    gt = np.asarray(gt, np.float64)
    valid = np.all(np.abs(gt) < 1e9, axis=-1)
    num = flow[..., 0] * gt[..., 0] + flow[..., 1] * gt[..., 1] + 1.0
    den = np.sqrt(
        (flow[..., 0] ** 2 + flow[..., 1] ** 2 + 1.0)
        * (gt[..., 0] ** 2 + gt[..., 1] ** 2 + 1.0)
    )
    ang = np.degrees(np.arccos(np.clip(num / den, -1.0, 1.0)))[valid]
    return {"ae_mean": float(ang.mean()), "ae_median": float(np.median(ang))}


def measure_sequence(flow_pattern, gt_pattern, first, last, step=1) -> dict:
    """Per-frame + aggregate EPE for .flo sequences (main_mesure.c role)."""
    from ..io import read_flo

    rows = []
    for i in range(first, last + 1, step):
        m = endpoint_error(read_flo(flow_pattern % i), read_flo(gt_pattern % i))
        rows.append({"frame": i, **m})
    agg = {
        k: float(np.mean([r[k] for r in rows]))
        for k in rows[0] if k != "frame"
    }
    return {"frames": rows, "mean": agg}
