"""Camera model, so(3) helpers and the rolling-shutter scanline pose model."""
