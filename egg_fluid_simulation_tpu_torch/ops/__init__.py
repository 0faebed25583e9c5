"""Solver, binning and render operators, and the hand-written kernels."""
