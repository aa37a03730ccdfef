"""The train step, its loss, optimizer and metrics, and the encoders."""
