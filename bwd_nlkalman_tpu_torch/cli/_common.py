"""Shared CLI helpers (the port's copy of ``bwd_nlkalman_tpu.cli._common``)."""

from __future__ import annotations

import argparse
import sys

import torch

from ..params import NLKParams


def device_arg(name: str):
    """The torch device a ``--device`` flag names. The CLIs run on the
    card unless asked for the CPU; a card that is not there exits 1."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device; pass --device cpu to run on the CPU",
              file=sys.stderr)
        raise SystemExit(1)
    return dev


def split_device(argv):
    """(positional args, device name) of a command with positional
    arguments: ``--device X`` or ``--device=X`` may stand anywhere among
    them (default ``cuda``)."""
    rest, device = [], "cuda"
    it = iter(argv)
    for a in it:
        if a == "--device":
            device = next(it, None)
            if device is None:
                raise ValueError("--device needs a value")
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    return rest, device


def add_prms_group(ap: argparse.ArgumentParser, prefix: str, title: str):
    """Parameter flags named like the reference (src/main-flt.c:83-113)."""
    g = ap.add_argument_group(title)
    g.add_argument(f"--{prefix}_p", type=int, default=-1, help="patch size")
    g.add_argument(f"--{prefix}_sx", type=int, default=-1, help="search radius (spatial)")
    g.add_argument(f"--{prefix}_st", type=int, default=-1, help="search radius (temporal)")
    g.add_argument(f"--{prefix}_nx", type=int, default=-1, help="number of similar patches spatial")
    g.add_argument(f"--{prefix}_nt", type=int, default=-1, help="number of similar patches kalman")
    g.add_argument(f"--{prefix}_nt_agg", type=int, default=-1, help="aggregated group size")
    g.add_argument(f"--{prefix}_bx", type=float, default=-1.0, help="noise multiplier spatial")
    g.add_argument(f"--{prefix}_bt", type=float, default=-1.0, help="noise multiplier kalman")
    g.add_argument(f"--{prefix}_l", type=float, default=-1.0, help="patch distance lambda")


def check_size(name: str, arr, ref, ref_name: str = "input",
               channels: int | str | None = None) -> None:
    """Hard-fail on frame size/channel mismatches like the reference
    binaries (src/main-flt.c:233-261, src/main-smo.c:120-165): print the
    offending geometry to stderr and exit(1) instead of letting a shape
    error (or silent broadcast) escape from the kernels.

    channels: None = must match ref's channel count, an int = must be
    exactly that, "any" = H/W check only (occlusion masks: any channel
    count is accepted, plane 0 is used, like iio-read masks)."""
    if arr.shape[0] != ref.shape[0] or arr.shape[1] != ref.shape[1]:
        print(
            f"error: {name} and {ref_name} size mismatch: "
            f"{arr.shape[1]}x{arr.shape[0]} vs {ref.shape[1]}x{ref.shape[0]}",
            file=sys.stderr,
        )
        raise SystemExit(1)
    if channels == "any":
        return
    want_ch = ref.shape[2] if channels is None else channels
    got_ch = arr.shape[2] if arr.ndim == 3 else 1
    if got_ch != want_ch:
        print(
            f"error: {name} has {got_ch} channels, expected {want_ch}",
            file=sys.stderr,
        )
        raise SystemExit(1)


def print_verbose_params(io_in: dict, io_out: dict, groups: dict) -> None:
    """The -v parameter dump of the reference binaries
    (src/main-flt.c:156-212, src/main-smo.c): input paths, output paths,
    then each pass's resolved parameters."""
    print("data input:")
    for k, v in io_in.items():
        print(f"\t{k:<13s} {v}")
    print()
    print("data output:")
    for k, v in io_out.items():
        print(f"\t{k:<13s} {v}")
    print()
    for title, p in groups.items():
        print(f"{title}:")
        print(f"\tpatch      {p.patch_sz}")
        print(f"\tsearch_x   {p.search_sz_x}")
        print(f"\tsearch_t   {p.search_sz_t}")
        if p.dista_th > 0:
            print(f"\tdth        {p.dista_th:g}")
        else:
            print(f"\tnp_x       {p.npatches_x}")
            print(f"\tnp_t       {p.npatches_t}")
            print(f"\tnp_tagg    {p.npatches_tagg}")
        print(f"\tlambda     {p.dista_lambda:g}")
        print(f"\tbeta_x     {p.beta_x:g}")
        print(f"\tbeta_t     {p.beta_t:g}")
        print()


def prms_from_args(args, prefix: str) -> NLKParams:
    a = vars(args)
    return NLKParams(
        patch_sz=a[f"{prefix}_p"],
        search_sz_x=a[f"{prefix}_sx"],
        search_sz_t=a[f"{prefix}_st"],
        npatches_x=a[f"{prefix}_nx"],
        npatches_t=a[f"{prefix}_nt"],
        npatches_tagg=a[f"{prefix}_nt_agg"],
        dista_lambda=a[f"{prefix}_l"],
        beta_x=a[f"{prefix}_bx"],
        beta_t=a[f"{prefix}_bt"],
    )
