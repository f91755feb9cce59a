"""Kernels and the array-level operations of the round body."""
