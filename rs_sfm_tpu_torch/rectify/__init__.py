"""Rectification: RS -> global-shutter re-rendering (port of
rs_sfm_tpu/rectify/): the z-buffered back-projection with its five engines,
the small-motion warp and the crack fill."""
