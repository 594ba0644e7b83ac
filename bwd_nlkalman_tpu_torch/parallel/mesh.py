"""The device mesh of the sharded passes: a (dp, sp) grid of devices.

Port of ``bwd_nlkalman_tpu.parallel.mesh``. JAX's mesh is driven by one
controller; so is this one: one process holds the grid and moves the
shards' rows between its devices with ``Tensor.to``. A device may stand
in the grid more than once (``["cuda:0"] * 3`` on one card,
``["cpu"] * 4`` in the tests): the shards then run one after the other
on it, with the same halo exchange as across cards.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices[k][i]``: the device of shard i (rows, the 'sp' axis) of
    batch row k (the 'dp' axis)."""

    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict[str, int]:
        return {"dp": len(self.devices), "sp": len(self.devices[0])}

    @property
    def first(self) -> torch.device:
        """The device whole frames and results live on."""
        return self.devices[0][0]


def make_mesh(dp: int = 1, sp: int | None = None, devices=None) -> Mesh:
    """2-D ('dp', 'sp') mesh: batch data parallelism x spatial sharding.

    ``devices`` defaults to every visible CUDA device (none raises); a
    list given is taken as it is and may repeat a device. ``sp`` defaults
    to ``len(devices) // dp``; the grid is filled row by row, 'sp'
    innermost, as JAX's is.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices=['cpu'] * n "
                               "to shard on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if sp is None:
        sp = n // dp
    if dp * sp != n:
        raise ValueError(f"dp*sp = {dp}*{sp} != {n} devices")
    return Mesh(tuple(tuple(devices[k * sp:(k + 1) * sp]) for k in range(dp)))
