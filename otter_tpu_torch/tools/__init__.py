"""Benchmarks and their helpers: entry points that build a model with
random weights and measure it."""
