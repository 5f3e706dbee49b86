"""Parallelism descriptor threaded through the LM code."""
