"""Generators of the benchmark's inputs, each `make(dest, params, seed) -> {name: path}`."""
