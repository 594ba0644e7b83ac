"""Ground-truth evaluation harness (the *-gt.sh scripts); the port's copy
of ``bwd_nlkalman_tpu.pipeline.gt``, numpy in and out.

Reproduces nlkalman-seq-gt.sh: add reference-exact AWGN per frame
(:31-39), denoise, and compute per-frame and global RMSE/PSNR per stage
into a `measures`-style table (:47-120), with PSNR peak 255
(scripts/psnr.sh:9-11).
"""

from __future__ import annotations

import numpy as np

from ..ops.noise import awgn


def add_noise_sequence(clean: np.ndarray, sigma: float, seeds) -> np.ndarray:
    """Per-frame AWGN with explicit seeds (SRAND per frame,
    nlkalman-seq-gt.sh:36).  clean: (T, H, W, C)."""
    out = np.empty_like(clean, dtype=np.float32)
    for t in range(clean.shape[0]):
        out[t] = awgn(clean[t], sigma, seed=int(seeds[t]))
    return out


def sequence_psnr(
    ref: np.ndarray, test: np.ndarray, first_frame: int = 0, border: int = 0
) -> dict:
    """Per-frame + global RMSE/PSNR like the measures files.

    first_frame skips the recursive burn-in (PSNR from the 11th frame in
    the training protocol, scripts/dev-scripts/nlkalman-train.sh:43-50);
    border crops b pixels on each side (:35).
    """
    sl = np.s_[:, border:-border, border:-border] if border else np.s_[:]
    r = np.asarray(ref, np.float64)[sl]
    t = np.asarray(test, np.float64)[sl]
    mses = np.mean((r - t) ** 2, axis=(1, 2, 3))
    sel = mses[first_frame:]
    gmse = float(np.mean(sel))
    return {
        "frame_mse": mses.tolist(),
        "frame_psnr": (20 * np.log10(255.0 / np.sqrt(np.maximum(mses, 1e-12)))).tolist(),
        "mse": gmse,
        "rmse": float(np.sqrt(gmse)),
        "psnr": float(20 * np.log10(255.0 / np.sqrt(max(gmse, 1e-12)))),
    }


def gt_measures(clean, stacks: dict, first_frame: int = 0, border: int = 0) -> str:
    """Render a measures-style text block for {name: stack} outputs."""
    lines = []
    for name, stack in stacks.items():
        if stack is None:
            continue
        m = sequence_psnr(clean, stack, first_frame, border)
        for t, (fm, fp) in enumerate(zip(m["frame_mse"], m["frame_psnr"])):
            lines.append(f"{name}-frame {t:03d} RMSE {np.sqrt(fm):.6f} PSNR {fp:.6f}")
        lines.append(f"{name}-total RMSE {m['rmse']:.6f} PSNR {m['psnr']:.6f}")
    return "\n".join(lines) + "\n"
