"""P, the streaming-rate probe: the card's own FMA rates.

Port of ``tools/vpu_probe.py`` (the Pallas kernel ``_probe_kernel``,
:39). Per element of an (H, W) plane: x from the input, y = x*0.5 + 0.25,
``nchains`` accumulators x + c run ``K`` FMA (or multiply) steps, they are
summed and written as float32; the whole plane is processed ``GRID``
times. On CUDA tensors the hand-written kernel ``csrc/probe.cu`` runs; on
CPU tensors :func:`probe_plain`, the same chain in torch ops.

Variants: fma8, fma4, fma1 and mul8 in float32, fmabf8 in bfloat16, each
at the three plane sizes of the TPU probe: 256x512, 8x512 (suffix s) and
64x512 (suffix m). For each the probe prints milliseconds, FLOP/s (2 per
FMA, 1 per multiply) and the share of the published H100 SXM peak
outside the tensor cores, with the card's name and power limit. Peaks:
67 TFLOP/s float32 (NVIDIA's H100 data sheet) and 133.8 TFLOP/s bfloat16
(the "BF16 (non-Tensor)" row, H100 SXM5, of NVIDIA's H100 Tensor Core GPU
Architecture white paper); both assume the 700 W power limit.

Run as ``python -m bwd_nlkalman_tpu_torch.tools.vpu_probe`` on a machine
with a CUDA card; without one it exits non-zero.
"""

from __future__ import annotations

import ctypes
import subprocess

import torch

from .._build import call, stream_ptr
from .._dispatch import LaunchCounter, check_tensor, use_kernel

K = 400     # chain steps per grid step (tools/vpu_probe.py:35)
GRID = 8    # times the plane is processed (tools/vpu_probe.py:36)
VARIANTS = {  # name -> (nchains, op, dtype)
    "fma8": (8, "fma", torch.float32),
    "fma4": (4, "fma", torch.float32),
    "fma1": (1, "fma", torch.float32),
    "mul8": (8, "mul", torch.float32),
    "fmabf8": (8, "fma", torch.bfloat16),
}
SIZES = {"": (256, 512), "s": (8, 512), "m": (64, 512)}
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 133.8e12}

LAUNCHES = LaunchCounter()


def flops(h: int, w: int, nchains: int, op: str, k: int = K, grid: int = GRID) -> int:
    """FLOPs of one call: 2 per FMA, 1 per multiply (the final sums not counted)."""
    return grid * k * nchains * h * w * (2 if op == "fma" else 1)


def probe_plain(a, nchains, op, dtype, k=K, grid=GRID):
    """Plain version of P: a (H, W) float32 -> (H, W) float32. An FMA rounds
    once, as the kernel's does: the step is taken in a wider type (exact
    for the product) and rounded back to ``dtype``."""
    wide = torch.float64 if dtype == torch.float32 else torch.float32
    for _ in range(grid):
        x = a.to(dtype)
        y = x * 0.5 + 0.25
        accs = [x + float(c) for c in range(nchains)]
        xw, yw = x.to(wide), y.to(wide)
        for _ in range(k):
            if op == "fma":
                accs = [(acc.to(wide) * xw + yw).to(dtype) for acc in accs]
            else:
                accs = [acc * x for acc in accs]
        s = accs[0]
        for acc in accs[1:]:
            s = s + acc
        out = s.to(torch.float32)
    return out


def probe_cuda(a, nchains, op, dtype, k=K, grid=GRID):
    """Kernel version of ``probe_plain`` (same arguments and result)."""
    h, w = a.shape
    dev = a.device
    if dev.type != "cuda":
        raise ValueError("probe_cuda takes CUDA tensors")
    check_tensor(a, "a", (h, w), torch.float32, dev)
    if dtype not in PEAK_FLOPS or op not in ("fma", "mul"):
        raise ValueError(f"P runs fma or mul in float32 or bfloat16, got {op} {dtype}")
    out = torch.empty_like(a)
    call("bnlk_probe", a.data_ptr(), out.data_ptr(), h * w, int(nchains), int(k),
         int(grid), 0 if op == "fma" else 1, int(dtype == torch.bfloat16),
         ctypes.c_void_p(stream_ptr(dev)))
    LAUNCHES.add()
    return out


def probe(a, nchains, op, dtype, k=K, grid=GRID, engine: str = "auto"):
    """P on CUDA tensors, its plain version on CPU tensors."""
    fn = probe_cuda if use_kernel(a, engine) else probe_plain
    return fn(a, nchains, op, dtype, k, grid)


def probe_input(h: int, w: int, device) -> torch.Tensor:
    """The TPU probe's input: uniform in [0.5, 1) from seed 0."""
    g = torch.Generator().manual_seed(0)
    return (0.5 + 0.5 * torch.rand((h, w), generator=g)).to(device)


def measure(variant: str, h: int, w: int, reps: int = 20) -> dict:
    """Time one variant on an (h, w) plane on the card with CUDA events,
    after one warm-up."""
    nchains, op, dtype = VARIANTS[variant]
    a = probe_input(h, w, "cuda")
    probe(a, nchains, op, dtype)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        probe(a, nchains, op, dtype)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    rate = flops(h, w, nchains, op) / (ms * 1e-3)
    return {"variant": variant, "h": h, "w": w, "ms": ms, "flops": rate,
            "share": rate / PEAK_FLOPS[dtype], "peak": PEAK_FLOPS[dtype]}


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main() -> list[dict]:
    if not torch.cuda.is_available():
        raise SystemExit("vpu_probe: needs a CUDA device")
    smi = card()
    results = []
    for suffix, (h, w) in SIZES.items():
        for variant in VARIANTS:
            r = dict(measure(variant, h, w), name=variant + suffix)
            results.append(r)
            print(f"{r['name']:>8} {h}x{w}: {r['ms']:8.4f} ms  "
                  f"{r['flops'] / 1e12:7.2f} TFLOP/s  {100 * r['share']:5.1f}% of "
                  f"{r['peak'] / 1e12:g} TFLOP/s  ({smi})", flush=True)
    return results


if __name__ == "__main__":
    main()
