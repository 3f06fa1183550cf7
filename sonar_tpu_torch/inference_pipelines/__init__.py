"""Inference pipelines of the port."""
