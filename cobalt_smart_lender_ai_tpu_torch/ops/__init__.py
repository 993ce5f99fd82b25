"""Kernels and their wrappers."""
