"""Sobol point generation: the ``sobol_points`` kernel."""
