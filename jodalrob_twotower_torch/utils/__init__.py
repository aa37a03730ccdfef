"""Model-FLOPs accounting."""
