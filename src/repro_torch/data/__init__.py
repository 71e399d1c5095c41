"""Synthetic input data (numpy copies of ``repro.data``)."""
