"""Synthetic data for training (port of ``repro.data``)."""
