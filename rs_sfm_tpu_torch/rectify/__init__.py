"""Z-buffered back-projection to a global-shutter image."""
