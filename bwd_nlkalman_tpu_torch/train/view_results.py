"""Training-table analysis — the view_results.m equivalent; the port's own
copy of ``bwd_nlkalman_tpu.train.view_results`` (numpy only).

The reference inspects its accumulated 16-column results tables with an
Octave script that interpolates and plots the (np, beta) -> MSE landscape
and records historical bests (scripts/dev-scripts/view_results.m).  This
module gives the same insight headlessly: load a table, report the best
rows per sigma/stage, and render a coarse ASCII heat map of any two
parameter columns against an objective.

Columns (scripts/dev-scripts/run-nlk-set.sh:94-96):
sigma f1_nx f1_bx f1_nt f1_ntagg f1_bt f2_nx f2_bx f2_nt f2_ntagg f2_bt
s1_nt s1_bt f1_mse f2_mse s1_mse
"""

from __future__ import annotations

import sys

import numpy as np

COLUMNS = [
    "sigma", "f1_nx", "f1_bx", "f1_nt", "f1_ntagg", "f1_bt",
    "f2_nx", "f2_bx", "f2_nt", "f2_ntagg", "f2_bt",
    "s1_nt", "s1_bt", "f1_mse", "f2_mse", "s1_mse",
]


def load_table(path: str) -> np.ndarray:
    """(N, 16) float array from a results table file."""
    rows = []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) == 16:
                try:
                    rows.append([float(p) for p in parts])
                except ValueError:
                    continue
    return np.asarray(rows, np.float64).reshape(-1, 16)


def mse_to_psnr(mse: np.ndarray) -> np.ndarray:
    return 10.0 * np.log10(255.0 ** 2 / np.maximum(mse, 1e-12))


def best_rows(table: np.ndarray, objective: str = "s1_mse"):
    """Best row per sigma by the objective MSE column; returns
    [(sigma, row, psnr)] like view_results.m's historical-best record
    (view_results.m:63-67)."""
    obj = COLUMNS.index(objective)
    out = []
    for sig in np.unique(table[:, 0]):
        sub = table[table[:, 0] == sig]
        row = sub[np.argmin(sub[:, obj])]
        out.append((float(sig), row, float(mse_to_psnr(row[obj]))))
    return out


def ascii_landscape(
    table: np.ndarray,
    x: str,
    y: str,
    objective: str = "s1_mse",
    sigma: float | None = None,
    bins: int = 12,
) -> str:
    """Coarse ASCII heat map of min-MSE over an (x, y) parameter grid —
    the headless stand-in for view_results.m's interpolated surface."""
    xi, yi, oi = COLUMNS.index(x), COLUMNS.index(y), COLUMNS.index(objective)
    t = table if sigma is None else table[table[:, 0] == sigma]
    if t.shape[0] == 0:
        return "(no rows)"
    xv, yv, ov = t[:, xi], t[:, yi], t[:, oi]
    xe = np.linspace(xv.min(), xv.max() + 1e-9, bins + 1)
    ye = np.linspace(yv.min(), yv.max() + 1e-9, bins + 1)
    grid = np.full((bins, bins), np.inf)
    bx = np.clip(np.digitize(xv, xe) - 1, 0, bins - 1)
    by = np.clip(np.digitize(yv, ye) - 1, 0, bins - 1)
    for i in range(t.shape[0]):
        grid[by[i], bx[i]] = min(grid[by[i], bx[i]], ov[i])
    finite = grid[np.isfinite(grid)]
    if finite.size == 0:
        return "(no rows)"
    lo, hi = finite.min(), finite.max()
    shades = " .:-=+*#%@"
    lines = [f"{y} \\ {x}   min {objective}={lo:.3f} max={hi:.3f}"]
    for r in range(bins - 1, -1, -1):
        row = ""
        for c_ in range(bins):
            v = grid[r, c_]
            if not np.isfinite(v):
                row += " "
            else:
                k = int((v - lo) / max(hi - lo, 1e-12) * (len(shades) - 1))
                row += shades[len(shades) - 1 - k]
        lines.append(f"{ye[r]:8.2f} |{row}|")
    lines.append(" " * 10 + f"{xe[0]:<8.2f}{' ' * max(bins - 16, 0)}{xe[-1]:>8.2f}")
    return "\n".join(lines)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(prog="view-results", description=__doc__)
    ap.add_argument("table", help="results table path (16-column format)")
    ap.add_argument("--objective", default="s1_mse",
                    choices=["f1_mse", "f2_mse", "s1_mse"])
    ap.add_argument("--landscape", nargs=2, metavar=("X", "Y"),
                    help="two parameter columns for the ASCII heat map")
    ap.add_argument("--sigma", type=float, default=None)
    args = ap.parse_args(argv)

    t = load_table(args.table)
    print(f"{t.shape[0]} trials")
    for sig, row, psnr in best_rows(t, args.objective):
        vals = " ".join(f"{c}={v:g}" for c, v in zip(COLUMNS[1:13], row[1:13]))
        print(f"sigma {sig:g}: best {args.objective} "
              f"{row[COLUMNS.index(args.objective)]:.4f} "
              f"({psnr:.2f} dB)  {vals}")
    if args.landscape:
        print(ascii_landscape(t, args.landscape[0], args.landscape[1],
                              args.objective, args.sigma))
    return 0


if __name__ == "__main__":
    sys.exit(main())
