"""Metric engines (the "model" layer): SSIMULACRA2 and its f64 scoring."""
