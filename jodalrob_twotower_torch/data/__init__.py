"""Batch types, the host feature store and the synthetic dataset."""
