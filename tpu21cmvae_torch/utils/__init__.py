"""Configuration, frequency axes, metrics and filesystem helpers."""
