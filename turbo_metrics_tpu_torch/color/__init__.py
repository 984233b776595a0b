"""Colour metadata (H.273 code points) and fallback rules."""
