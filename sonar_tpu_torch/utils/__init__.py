"""Analytic FLOP counts (``flops``) and profiling helpers (``profiling``)."""
