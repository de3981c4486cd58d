"""Measurement scripts for the port's kernels, each run on one GPU."""
