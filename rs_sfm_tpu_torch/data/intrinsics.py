"""Named device-intrinsics registry (port of rs_sfm_tpu/data/intrinsics.py;
reference Camera::setIntrinsics, src/camera.cc:179-206), kept as data and
extendable at run time."""

from __future__ import annotations

from rs_sfm_tpu_torch.geom.camera import Intrinsics

REGISTRY: dict[str, Intrinsics] = {
    # iPhone 4 (rolling-shutter dataset)
    "iphone": Intrinsics(fx=1505.1283359786307, fy=1513.7789208311444,
                         cx=657.81734686405991, cy=349.91807538147589),
    # Samsung Galaxy S8, full HD, no video stabilization
    "galaxy_stabil": Intrinsics(fx=1803.29785922382, fy=1799.35406531529,
                                cx=945.304708272490, cy=544.684292978344),
    # Samsung Galaxy S8, full HD, with video stabilization
    "galaxy": Intrinsics(fx=1492.41306997746, fy=1491.09286590722,
                         cx=949.571146410704, cy=554.675409391795),
    # first clips
    "galaxy_old": Intrinsics(fx=3154.53208221173, fy=3152.28696217577,
                             cx=1969.87107268891, cy=1521.27056048818),
    # Samsung Galaxy S8, VGA, no video stabilization
    "galaxy_vga": Intrinsics(fx=484.450845764569, fy=485.345469134313,
                             cx=313.442094604855, cy=241.383116350144),
}


def get(name: str) -> Intrinsics:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown camera {name!r}; known: {sorted(REGISTRY)}") from None
