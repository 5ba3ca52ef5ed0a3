"""Utilities: analytic FLOP accounting."""
