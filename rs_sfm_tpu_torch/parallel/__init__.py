"""Sharded estimation over `torch.distributed` (port of
rs_sfm_tpu/parallel/).

  * pairs  -- independent frame pairs split over the `pairs` axis
              (`estimate_pairs_batched`);
  * pixels -- the scanline blocks of one pair split over the `pixels` axis
              (`estimate_sharded`): RANSAC draws from a pool shared by
              all-reduce and sums its votes in one all-reduce per stage,
              and the k-scan and each LM iteration all-reduce their sums.

Ranks are processes (`launch.spawn` on one host).  The entry points are
loaded on first use, because the solver imports `distributed` from here.
"""

_API = ("estimate_sharded", "estimate_pairs_batched")


def __getattr__(name):
    if name in _API:
        from rs_sfm_tpu_torch.parallel import api

        return getattr(api, name)
    if name in ("Mesh", "make_mesh"):
        from rs_sfm_tpu_torch.parallel import mesh

        return getattr(mesh, name)
    if name in ("initialize", "global_mesh"):
        from rs_sfm_tpu_torch.parallel import distributed

        return getattr(distributed, name)
    raise AttributeError(name)


__all__ = ["Mesh", "make_mesh", "initialize", "global_mesh", *_API]
