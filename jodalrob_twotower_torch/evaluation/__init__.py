"""Corpus encoding; the metric surface arrives with the evaluation slice."""
