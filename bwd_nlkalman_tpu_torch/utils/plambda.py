"""RPN per-pixel expression evaluator — the plambda workhorse; the port's
own copy of ``bwd_nlkalman_tpu.utils.plambda`` (numpy only, the same
results bit for bit).

A vectorized numpy re-design of the reference's plambda
(lib/imscript-lite/src/plambda.c), covering the pipeline-used subset plus
the language long tail:

- stack arithmetic: + - * / ^ , comparisons < > = >= <= !=, logic
  not/and/or/if, min max, constants (pi, e, nan, inf)
- libm function set (plambda.c:766-831): fabs sqrt exp log sin cos ...
  atan2 hypot fmod pow copysign fdim fmax fmin ldexp remainder, the
  quantization helpers q255/qe/iqe/range/affhalf/bound and the finiteness
  filters inftozero/nantozero/notfintozero/force_finite
- stack operators (plambda.c:105-112): del dup rot split join join3 njoin
- registers (plambda.c:1834): ``>n`` pops into register n, ``<n`` pushes it
- colon variables (eval_colonvar, plambda.c:947-974): :i :j :w :h :n
  :x :y :r :t :I :J :P :Q :L :R :W :H
- vector/matrix operators (plambda.c:852-894): topolar frompolar cprod
  vprod sprod mprod mdet mtrans minv mtrace vavg vsum vmin vmax vmul
  vnorm vdim
- image access: x, y, z ... (first, second, third input); x[c] component
  access; x(dx,dy) neighbor access with edge clamping; x(dx,dy)[c]
- image statistics suffixes (eval_magicvar, plambda.c:1276-1330):
  x%i min, x%a max, x%v avg, x%m median, x%s sum, x%r std, x%q<nn>
  percentile

Examples (from the pipeline):
    plambda("x(0,0)[0] x(-1,0)[0] - x(0,0)[1] x(0,-1)[1] - + fabs 0.75 > 255 *", flow)
    plambda("x y - 2 ^", a, b)   # squared error (scripts/psnr.sh:9)
"""

from __future__ import annotations

import math
import re

import numpy as np

_VAR_RE = re.compile(
    r"^([xyzuvwabc])"            # image name
    r"(?:\((-?\d+),(-?\d+)\))?"   # optional neighbor offset
    r"(?:\[(\d+)\])?"             # optional component
    r"(?:%([a-zA-Z])(\d+)?)?$"    # optional statistic (+percentile rank)
)

_REG_RE = re.compile(r"^([<>])([0-9])$")
_COLON_RE = re.compile(r"^:([ijwhnxyrtIJPQLRWH])$")

_BINOPS = {
    "+": np.add,
    "-": np.subtract,
    "*": np.multiply,
    "/": np.divide,
    "^": np.power,
    "pow": np.power,
    "<": lambda a, b: (a < b).astype(np.float32),
    ">": lambda a, b: (a > b).astype(np.float32),
    "=": lambda a, b: (a == b).astype(np.float32),
    ">=": lambda a, b: (a >= b).astype(np.float32),
    "<=": lambda a, b: (a <= b).astype(np.float32),
    "!=": lambda a, b: (a != b).astype(np.float32),
    "min": np.minimum,
    "max": np.maximum,
    "fmin": np.minimum,
    "fmax": np.maximum,
    "fmod": np.fmod,
    "hypot": np.hypot,
    "atan2": np.arctan2,
    "copysign": np.copysign,
    "fdim": lambda a, b: np.maximum(a - b, 0.0),
    "ldexp": lambda a, b: np.ldexp(a, b.astype(np.int32)),
    "remainder": lambda a, b: a - b * np.rint(a / b),
    "and": lambda a, b: ((a != 0) & (b != 0)).astype(np.float32),
    "or": lambda a, b: ((a != 0) | (b != 0)).astype(np.float32),
}

_UNOPS = {
    "fabs": np.abs,
    "abs": np.abs,
    "sqrt": np.sqrt,
    "cbrt": np.cbrt,
    "exp": np.exp,
    "exp2": np.exp2,
    "expm1": np.expm1,
    "log": np.log,
    "log1p": np.log1p,
    "logb": lambda a: np.floor(np.log2(np.abs(a))),
    "sin": np.sin,
    "cos": np.cos,
    "tan": np.tan,
    "sinh": np.sinh,
    "cosh": np.cosh,
    "tanh": np.tanh,
    "asinh": np.arcsinh,
    "acosh": np.arccosh,
    "atanh": np.arctanh,
    "round": np.rint,
    "rint": np.rint,
    "nearbyint": np.rint,
    "trunc": np.trunc,
    "floor": np.floor,
    "ceil": np.ceil,
    "not": lambda a: (a == 0).astype(np.float32),
    "neg": np.negative,
    "log10": np.log10,
    "log2": np.log2,
    "atan": np.arctan,
    "asin": np.arcsin,
    "acos": np.arccos,
    # finiteness filters (plambda.c:350-354)
    "inftozero": lambda a: np.where(np.isinf(a), 0.0, a),
    "nantozero": lambda a: np.where(np.isnan(a), 0.0, a),
    "notfintozero": lambda a: np.where(np.isfinite(a), a, 0.0),
    "force_finite": lambda a: np.where(np.isfinite(a), a, 0.0),
    # quantize_255 (plambda.c:356-362): int truncation then clamp
    "q255": lambda a: np.clip(np.trunc(a), 0, 255),
}

# ternary scalar functions, stack order [x, a, b] with b on top
_TERNOPS = {
    "if": lambda a, b, c: np.where(a != 0, b, c),   # logic_if(a,b,c)
    "range": lambda x, a, b: (x - a) / (b - a),      # plambda.c:374-377
    "affhalf": lambda x, a, b: a + (x / 255.0) * (b - a),
    "bound": lambda x, a, b: np.clip(x, a, b),       # plambda.c:391-396
    "qe": lambda x, a, b: np.clip(np.trunc(255.0 * (x - a) / (b - a)),
                                  0, 255),           # quantize_easy
    "iqe": lambda x, a, b: a + (x / 255.0) * (b - a),  # unquantize_easy
}

_CONSTS = {"pi": math.pi, "e": math.e, "nan": math.nan, "inf": math.inf}

_NAMES = "xyzuvwabc"


def _shift(img: np.ndarray, dx: int, dy: int) -> np.ndarray:
    """Neighbor access with edge clamping: value at (col+dx, row+dy)."""
    h, w = img.shape[:2]
    rows = np.clip(np.arange(h) + dy, 0, h - 1)
    cols = np.clip(np.arange(w) + dx, 0, w - 1)
    return img[rows][:, cols]


def _as3d(v, h, w):
    """Broadcast a stack item to (H, W, C) for channel-structured ops."""
    a = np.atleast_3d(np.asarray(v, np.float32))
    if a.shape[:2] != (h, w):
        a = np.broadcast_to(a, (h, w, a.shape[-1]))
    return a


def _colonvar(name: str, h: int, w: int) -> np.ndarray:
    """eval_colonvar (plambda.c:947-974), vectorized over the image."""
    i = np.broadcast_to(np.arange(w, dtype=np.float32)[None, :], (h, w))
    j = np.broadcast_to(np.arange(h, dtype=np.float32)[:, None], (h, w))
    relx = (2.0 / (w - 1)) * i - 1 if w > 1 else np.zeros_like(i)
    rely = (2.0 / (h - 1)) * j - 1 if h > 1 else np.zeros_like(j)

    def symm(idx, m):
        return np.where(idx >= m / 2, idx - m, idx)

    if name == "i":
        out = i
    elif name == "j":
        out = j
    elif name == "w":
        out = np.full((h, w), w, np.float32)
    elif name == "h":
        out = np.full((h, w), h, np.float32)
    elif name == "n":
        out = np.full((h, w), w * h, np.float32)
    elif name == "x":
        out = relx
    elif name == "y":
        out = rely
    elif name == "r":
        out = np.hypot(rely, relx)
    elif name == "t":
        out = np.arctan2(rely, relx)
    elif name == "I":
        out = symm(i, w)
    elif name == "J":
        out = symm(j, h)
    elif name == "P":
        out = symm(i, w) * 2 * math.pi / w
    elif name == "Q":
        out = symm(j, h) * 2 * math.pi / h
    elif name == "L":
        out = -(symm(i, w) ** 2 + symm(j, h) ** 2)
    elif name == "R":
        out = np.hypot(symm(i, w), symm(j, h))
    elif name == "W":
        out = np.full((h, w), w / (2 * math.pi), np.float32)
    else:  # "H"
        out = np.full((h, w), h / (2 * math.pi), np.float32)
    return out.astype(np.float32)[..., None]


def _sq(n: int) -> int:
    """Side of an n^2-vector seen as a square matrix (mdet/minv/...)."""
    s = int(round(math.sqrt(n)))
    if s * s != n:
        raise ValueError(f"plambda: {n}-vector is not a square matrix")
    return s


def _apply_vecop(tok: str, stack: list, h: int, w: int) -> None:
    """Vector/matrix operators (plambda.c:852-894) on the channel axis."""
    if tok in ("vavg", "vsum", "vmin", "vmax", "vmul", "vnorm", "vdim"):
        a = _as3d(stack.pop(), h, w)
        if tok == "vavg":
            r = a.mean(-1, keepdims=True)
        elif tok == "vsum":
            r = a.sum(-1, keepdims=True)
        elif tok == "vmin":
            r = a.min(-1, keepdims=True)
        elif tok == "vmax":
            r = a.max(-1, keepdims=True)
        elif tok == "vmul":
            r = a.prod(-1, keepdims=True)
        elif tok == "vnorm":
            r = np.sqrt((a * a).sum(-1, keepdims=True))
        else:  # vdim
            r = np.full((h, w, 1), a.shape[-1], np.float32)
        stack.append(r.astype(np.float32))
        return
    if tok in ("topolar", "frompolar"):
        a = _as3d(stack.pop(), h, w)
        if a.shape[-1] != 2:
            raise ValueError(f"plambda: {tok} needs a 2-vector")
        if tok == "topolar":   # plambda.c:398-402
            r = np.concatenate(
                [np.hypot(a[..., :1], a[..., 1:]),
                 np.arctan2(a[..., 1:], a[..., :1])], -1)
        else:                  # plambda.c:404-408
            r = np.concatenate(
                [a[..., :1] * np.cos(a[..., 1:]),
                 a[..., :1] * np.sin(a[..., 1:])], -1)
        stack.append(r.astype(np.float32))
        return
    if tok in ("cprod", "vprod", "sprod", "mprod"):
        b = _as3d(stack.pop(), h, w)
        a = _as3d(stack.pop(), h, w)
        if tok == "cprod":     # complex_product, plambda.c:410-414
            if a.shape[-1] != 2 or b.shape[-1] != 2:
                raise ValueError("plambda: cprod needs 2-vectors")
            r = np.concatenate(
                [a[..., :1] * b[..., :1] - a[..., 1:] * b[..., 1:],
                 a[..., :1] * b[..., 1:] + a[..., 1:] * b[..., :1]], -1)
        elif tok == "vprod":   # vector_product, plambda.c:520-529
            if a.shape[-1] != 3 or b.shape[-1] != 3:
                raise ValueError("plambda: vprod needs 3-vectors")
            r = np.cross(a, b)
        elif tok == "sprod":
            if a.shape[-1] != b.shape[-1]:
                raise ValueError("plambda: sprod dim mismatch")
            r = (a * b).sum(-1, keepdims=True)
        else:                  # matrix_product, plambda.c:488-518
            na, nb = a.shape[-1], b.shape[-1]
            if na == 6 and nb == 2:    # affine map applied to a 2-vector
                r = np.concatenate(
                    [a[..., 0:1] * b[..., 0:1] + a[..., 1:2] * b[..., 1:2]
                     + a[..., 2:3],
                     a[..., 3:4] * b[..., 0:1] + a[..., 4:5] * b[..., 1:2]
                     + a[..., 5:6]], -1)
            else:
                sa = _sq(na)
                am = a.reshape(h, w, sa, sa)
                if nb == na:
                    bm = b.reshape(h, w, sa, sa)
                elif nb == sa:
                    bm = b.reshape(h, w, sa, 1)
                else:
                    raise ValueError(
                        f"plambda: bad matrix product ({na} {nb})")
                r = np.einsum("hwik,hwkj->hwij", am, bm).reshape(h, w, -1)
        stack.append(r.astype(np.float32))
        return
    # square-matrix unary ops
    a = _as3d(stack.pop(), h, w)
    s = _sq(a.shape[-1])
    m = a.reshape(h, w, s, s)
    if tok == "mtrans":
        r = m.transpose(0, 1, 3, 2).reshape(h, w, -1)
    elif tok == "mtrace":
        r = np.trace(m, axis1=2, axis2=3)[..., None]
    elif tok == "mdet":
        r = np.linalg.det(m)[..., None]
    elif tok == "minv":
        r = np.linalg.inv(m).reshape(h, w, -1)
    else:  # pragma: no cover
        raise ValueError(f"plambda: unknown vector op {tok}")
    stack.append(r.astype(np.float32))


_VECOPS = {
    "vavg", "vsum", "vmin", "vmax", "vmul", "vnorm", "vdim",
    "topolar", "frompolar", "cprod", "vprod", "sprod", "mprod",
    "mtrans", "mtrace", "mdet", "minv",
}


def plambda_calc(expr: str) -> float:
    """The -c calculator mode (plambda.c main_calc): evaluate an RPN
    expression with NO images and return the scalar result — the form
    the eval scripts use for PSNR arithmetic, e.g.
    plambda -c "255 $RMSE / log10 20 *" (scripts/psnr.sh,
    nlkalman-train.sh:36-52)."""
    out = plambda(expr, np.zeros((1, 1, 1), np.float32))
    return float(np.asarray(out).ravel()[0])


def plambda(expr: str, *images) -> np.ndarray:
    """Evaluate an RPN expression over input images ((H, W, C) float)."""
    imgs = [np.atleast_3d(np.asarray(im, np.float32)) for im in images]
    h, w = imgs[0].shape[:2]
    stack: list = []
    regs: dict[int, object] = {}
    for tok in expr.split():
        if tok in _BINOPS:
            b = stack.pop()
            a = stack.pop()
            stack.append(_BINOPS[tok](a, b))
            continue
        if tok in _UNOPS:
            stack.append(_UNOPS[tok](stack.pop()))
            continue
        if tok in _TERNOPS:
            c = stack.pop()
            b = stack.pop()
            a = stack.pop()
            stack.append(np.asarray(_TERNOPS[tok](a, b, c), np.float32))
            continue
        if tok in _VECOPS:
            _apply_vecop(tok, stack, h, w)
            continue
        if tok in _CONSTS:
            stack.append(np.float32(_CONSTS[tok]))
            continue
        # ---- stack operators (plambda.c:105-112) ----
        if tok == "del":
            stack.pop()
            continue
        if tok == "dup":
            stack.append(stack[-1])
            continue
        if tok == "rot":
            a = stack.pop()
            b = stack.pop()
            stack += [a, b]
            continue
        if tok == "split":
            a = _as3d(stack.pop(), h, w)
            stack += [a[..., c : c + 1] for c in range(a.shape[-1])]
            continue
        if tok in ("join", "join3", "njoin"):
            if tok == "njoin":
                n = int(np.asarray(stack.pop()).ravel()[0])
            else:
                n = 2 if tok == "join" else 3
            parts = [_as3d(v, h, w) for v in stack[len(stack) - n :]]
            del stack[len(stack) - n :]
            stack.append(np.concatenate(parts, axis=-1))
            continue
        # ---- registers >n / <n (plambda.c:1834, Canny example) ----
        m = _REG_RE.match(tok)
        if m:
            n = int(m.group(2))
            if m.group(1) == ">":
                regs[n] = stack.pop()
            else:
                if n not in regs:
                    raise ValueError(f"plambda: register {n} empty")
                stack.append(regs[n])
            continue
        # ---- colon variables (plambda.c:947-974) ----
        m = _COLON_RE.match(tok)
        if m:
            stack.append(_colonvar(m.group(1), h, w))
            continue
        m = _VAR_RE.match(tok)
        if m and m.group(1) in _NAMES[: len(imgs)]:
            img = imgs[_NAMES.index(m.group(1))]
            if m.group(2) is not None:
                img = _shift(img, int(m.group(2)), int(m.group(3)))
            if m.group(4) is not None:
                img = img[..., int(m.group(4)) : int(m.group(4)) + 1]
            if m.group(5) is not None:
                # magic statistics (plambda.c eval_magicvar:1276-1330):
                # i min, a max, v avg, s sum, r std, m median,
                # q<nn> percentile (qpos = round(qq*N/100), clamped)
                st = m.group(5)
                if st == "v":
                    img = np.float32(img.mean())
                elif st == "i":
                    img = np.float32(img.min())
                elif st in ("a", "x"):   # 'x' kept as a max alias
                    img = np.float32(img.max())
                elif st == "s":
                    img = np.float32(img.sum())
                elif st == "r":
                    img = np.float32(img.std())
                elif st == "m":
                    img = np.float32(np.median(img))
                elif st == "q":
                    qq = int(m.group(6) or 50)
                    flat = np.sort(img.ravel())
                    qpos = int(np.clip(round(qq * flat.size / 100.0),
                                       0, flat.size - 1))
                    img = np.float32(flat[qpos])
                else:
                    raise ValueError(f"unsupported statistic %{st}")
            stack.append(img)
            continue
        try:
            stack.append(np.float32(float(tok)))
        except ValueError:
            raise ValueError(f"plambda: unknown token {tok!r}") from None
    if len(stack) != 1:
        raise ValueError(f"plambda: {len(stack)} values left on stack")
    out = stack[0]
    if np.isscalar(out) or out.ndim == 0:
        out = np.broadcast_to(out, imgs[0].shape).astype(np.float32)
    return np.asarray(out, np.float32)
