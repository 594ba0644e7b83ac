"""printf-style image statistics — the imprintf equivalent; the port's own
copy of ``bwd_nlkalman_tpu.utils.imprintf`` (numpy only).

Directive semantics match lib/imscript-lite/src/imprintf.c (the table at
imprintf.c:688-718 and the stat passes at :213-419):

%w width, %h height, %c pixel dimension, %d depth (always 1),
%n number of samples (w*h*c), %N number of pixels (w*h),
%i/%a min/max sample (NaN-skipped, imprintf.c:224-233),
%v average sample (NaN-skipped), %b average nonzero sample,
%m median sample = sorted_non-NaN[count/2] (imprintf.c:372 — NOT the
   midpoint-averaging median),
%q[n] nth sample percentile: index (count-1)*n/100 truncated into the
   sorted non-NaN samples (imprintf.c:496-507),
%e average pixel euclidean norm ("error", imprintf.c:256-270),
%r root mean square over non-NaN samples (imprintf.c:405-419),
%s sum of samples accumulated in f32 (imprintf.c:222,234 — float acc),
%k number of distinct non-NaN samples, %y #infinite, %Y #NaN,
%I/%A min/max-norm pixel values, %V average pixel, %S sum of pixels,
plus %% and \\n \\t escapes.

The JAX package's copy is cross-validated against the built C binary
(tests/test_utils.py::test_imprintf_vs_c); this one is held to it by
tests/test_torch_plambda.py.
"""

from __future__ import annotations

import re

import numpy as np

_DIRECTIVE = re.compile(r"%(q\[(\d+)\]|[vnNiabmderskyYwhcdIAVS])")


def _fmt(v) -> str:
    return f"{float(v):g}"


def _fmtvec(v) -> str:
    return ", ".join(f"{float(c):g}" for c in np.atleast_1d(v))


def imprintf(fmt: str, img) -> str:
    arr = np.asarray(img, np.float64)
    if arr.ndim == 1:
        arr = arr[:, None, None]
    elif arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, ch = arr.shape
    x = arr.ravel()
    finite_mask = ~np.isnan(x)
    vals = x[finite_mask]  # non-NaN (inf kept, like the C loops)

    # pixel norms (NaN pixels skipped, imprintf.c:261-268)
    norms = np.sqrt((arr.astype(np.float64) ** 2).sum(axis=2)).ravel()
    pvalid = ~np.isnan(norms)

    def sub(m):
        d = m.group(1)
        if d.startswith("q"):
            q = int(m.group(2)) % 101
            if vals.size == 0:
                return "nan"
            srt = np.sort(vals)
            # C arithmetic exactly (imprintf.c:505-506): float32 product,
            # float32 division by 100, THEN truncation — the order matters
            # for large sample counts where the product is inexact
            pq = int(np.float32(np.float32(vals.size - 1) * q)
                     / np.float32(100))
            return _fmt(srt[pq])
        if d == "v":
            return _fmt(vals.mean()) if vals.size else "nan"
        if d == "b":
            nz = vals[vals != 0]
            return _fmt(nz.mean()) if nz.size else "nan"
        if d == "n":
            return f"{x.size}"
        if d == "N":
            return f"{h * w}"
        if d == "i":
            return _fmt(vals.min()) if vals.size else "inf"
        if d == "a":
            return _fmt(vals.max()) if vals.size else "-inf"
        if d == "m":
            if not vals.size:
                return "nan"
            return _fmt(np.sort(vals)[vals.size // 2])
        if d == "e":
            return _fmt(norms[pvalid].mean()) if pvalid.any() else "nan"
        if d == "r":
            if not vals.size:
                return "nan"
            return _fmt(np.sqrt(np.mean(vals.astype(np.float64) ** 2)))
        if d == "s":
            # C accumulates the printed sum in a float (imprintf.c:222)
            return _fmt(np.float32(vals.astype(np.float32).sum(dtype=np.float32)))
        if d == "k":
            return f"{np.unique(vals).size}"
        if d == "y":
            return f"{int(np.isinf(x).sum())}"
        if d == "Y":
            return f"{int(np.isnan(x).sum())}"
        if d == "w":
            return f"{w}"
        if d == "h":
            return f"{h}"
        if d == "c":
            return f"{ch}"
        if d == "d":
            return "1"
        if d == "I":
            if not pvalid.any():
                return "nan"
            i = int(np.flatnonzero(pvalid)[np.argmin(norms[pvalid])])
            return _fmtvec(arr.reshape(-1, ch)[i])
        if d == "A":
            if not pvalid.any():
                return "nan"
            i = int(np.flatnonzero(pvalid)[np.argmax(norms[pvalid])])
            return _fmtvec(arr.reshape(-1, ch)[i])
        if d == "V":
            px = arr.reshape(-1, ch)[pvalid]
            return _fmtvec(px.mean(axis=0)) if px.size else "nan"
        if d == "S":
            px = arr.reshape(-1, ch)[pvalid]
            return _fmtvec(px.sum(axis=0)) if px.size else "nan"
        raise ValueError(d)

    out = _DIRECTIVE.sub(sub, fmt)
    return out.replace("\\n", "\n").replace("\\t", "\t").replace("%%", "%")
