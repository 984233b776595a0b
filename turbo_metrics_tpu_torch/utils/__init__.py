"""Utilities: score statistics."""
