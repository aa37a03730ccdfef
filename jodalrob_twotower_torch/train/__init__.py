"""Encoders for serving; the training step arrives with the training slice."""
