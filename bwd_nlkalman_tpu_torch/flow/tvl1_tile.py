"""Launch plan of the TV-L1 tile engine (``csrc/tvl1_tile.cuh``) that K2
and K3 share, and the stop-or-go of its shard form's rounds
(:class:`RoundCtl`).

A thread block holds a region of ``rows`` x ``COLS`` pixels of the six
state planes and the four constant planes in shared memory: an interior
of (rows - 2 kt) x (COLS - 2 kt) pixels and a halo of ``kt`` pixels on
each side, where ``kt`` (``KT`` = 4: with at most 44 rows in shared
memory, a halo of 8 would leave 28 of them to the interior) is the
number of iterations the block runs before it writes its interior back. A round of k iterations (K2's ``k_check``,
K3's ``K_ITERS``) runs as sub-rounds of at most ``kt``
(:func:`sub_rounds`). One block runs on each SM at a time (1024 threads
of 64 registers), so :func:`tile_plan` picks, per level, the region
height whose tiles fill the SMs in the fewest rows of work: the time of
a sub-round is about the number of waves of tiles times the region's
rows.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

COLS = 128                  # region columns, halo included (kTileCols)
MAX_ROWS = 44               # region rows at most (kTileMaxRows)
PLANES = 10                 # 6 state planes and 4 constant planes in shared memory
THREADS = 1024              # threads of a block (kTileThreads)
KT = 4                      # the tile depth the kernels are built for (kTileDepth)
SMS = 132                   # SMs of an H100 SXM, the default card
SMEM_LIMIT = 232_448        # shared memory a block may use on an H100 (227 KB)
STATIC_SMEM = 144          # the block sum's 32 warp sums and total, as ptxas reports them


@dataclass(frozen=True)
class TilePlan:
    kt: int
    rows: int                    # region rows, halo included
    interior: tuple[int, int]    # rows, columns a tile owns
    tiles: tuple[int, int]       # tile rows, tile columns over the level
    smem: int                    # bytes of shared memory a block uses

    @property
    def n_tiles(self) -> int:
        return self.tiles[0] * self.tiles[1]


@functools.lru_cache(maxsize=None)
def tile_plan(h: int, w: int, sms: int = SMS) -> TilePlan:
    """The tiles of an h x w level on a card of ``sms`` SMs; raises for a
    region that does not fit a block's shared memory or an empty level."""
    kt = KT
    if h < 1 or w < 1:
        raise ValueError(f"empty level {h}x{w}")
    if PLANES * MAX_ROWS * COLS * 4 + STATIC_SMEM > SMEM_LIMIT:
        raise ValueError(f"a {MAX_ROWS}x{COLS} region takes more shared memory "
                         f"than the {SMEM_LIMIT} bytes a block may use")
    tw = COLS - 2 * kt
    tiles_x = -(-w // tw)

    def cost(rows):         # (waves x rows, fewer tiles first on a tie)
        tiles = -(-h // (rows - 2 * kt)) * tiles_x
        return -(-tiles // sms) * rows, tiles

    rows = min(range(2 * kt + 1, MAX_ROWS + 1), key=cost)
    th = rows - 2 * kt
    return TilePlan(kt, rows, (th, tw), (-(-h // th), tiles_x),
                    PLANES * rows * COLS * 4 + STATIC_SMEM)


def sub_rounds(k: int) -> list[int]:
    """The sub-rounds of a round of k iterations, as the kernels run them:
    as many of ``KT`` as fit, then the rest."""
    if k < 1:
        raise ValueError(f"a round has at least one iteration, got {k}")
    return [KT] * (k // KT) + ([k % KT] if k % KT else [])


class RoundCtl:
    """The stop-or-go of a level's sharded rounds on one device, shared by
    the round entries (K2's and K3's) of the shards that run there: the
    int32 ``flag`` (1 = go), and ``sums`` (2, n), each of the n shards'
    owned sum of the squared update of a round, a row per round parity
    (``csrc/tvl1_tile.cuh``, ``round_go``). Round 0 of a warp stage runs
    and sets the flag; a later one runs where the flag is still set and
    the previous round's sums, added in shard order, over the level's size
    exceed epsilon squared, else clears it. ``buffers`` keeps each shard's
    scratch of the kernel's launches for the level."""

    def __init__(self, n: int, device, epsilon: float, h: int, w: int):
        self.flag = torch.ones(1, dtype=torch.int32, device=device)
        self.sums = torch.zeros((2, n), dtype=torch.float32, device=device)
        self.epsilon, self.h, self.w = float(epsilon), h, w
        self.buffers: dict = {}

    @property
    def n(self) -> int:
        return self.sums.shape[1]

    def go(self, r: int) -> bool:
        """Plain version of ``round_go``: whether round ``r`` runs, kept in
        the flag."""
        go = True
        if r > 0:
            s = np.float32(0.0)
            for v in self.sums[(r - 1) % 2].tolist():
                s = np.float32(s + np.float32(v))
            eps2 = np.float32(self.epsilon * self.epsilon)
            go = bool(self.flag[0]) and bool(s / np.float32(self.h * self.w) > eps2)
        self.flag.fill_(int(go))
        return go

    def run_plain(self, fn, state, consts, k, y0, h, halo, slot, r, **kw):
        """A round entry's plain version ``fn`` under the rule above:
        (state, consts, k, y0, h, halo) -> (new block, owned sum). Returns
        the block (as it was where the round does not run)."""
        if not self.go(r):
            return state
        out, s = fn(state, consts, k, y0, h, halo, **kw)
        self.sums[r % 2, slot] = s
        return out
