"""The (pairs, pixels) layout of ranks (port of
rs_sfm_tpu/parallel/mesh.py).

Rank r of a world of pairs x pixels ranks holds pair slot r // pixels and
scanline block r % pixels.  The `pixels` group of a rank joins the ranks
that share its pair (scanline-block sharding of one frame pair); its
`pairs` group joins the ranks that hold the same block of different pairs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    pairs: int          # size of the pairs axis
    pixels: int         # size of the pixels axis
    pair_index: int     # this rank's slot on the pairs axis
    pixel_index: int    # this rank's slot on the pixels axis
    pairs_group: Any    # process group along the pairs axis
    pixels_group: Any   # process group along the pixels axis

    @property
    def shape(self) -> dict:
        return {"pairs": self.pairs, "pixels": self.pixels}


def make_mesh(pairs: int = 1, pixels: Optional[int] = None) -> Mesh:
    """Build the (pairs, pixels) mesh over every rank of the default group.

    `pixels` defaults to world_size // pairs.  Raises ValueError when
    pairs x pixels is not the world size.  Every rank must call it (each
    `dist.new_group` is collective).
    """
    world = dist.get_world_size()
    rank = dist.get_rank()
    if pixels is None:
        if pairs <= 0 or world % pairs:
            raise ValueError(f"{world} ranks not divisible by pairs={pairs}")
        pixels = world // pairs
    if pairs <= 0 or pixels <= 0 or pairs * pixels != world:
        raise ValueError(f"mesh {pairs}x{pixels} needs {pairs * pixels} "
                         f"ranks, the world has {world}")
    pixels_group = pairs_group = None
    for p in range(pairs):
        ranks = [p * pixels + i for i in range(pixels)]
        group = dist.new_group(ranks)
        if rank in ranks:
            pixels_group = group
    for i in range(pixels):
        ranks = [p * pixels + i for p in range(pairs)]
        group = dist.new_group(ranks)
        if rank in ranks:
            pairs_group = group
    return Mesh(pairs=pairs, pixels=pixels, pair_index=rank // pixels,
                pixel_index=rank % pixels, pairs_group=pairs_group,
                pixels_group=pixels_group)
