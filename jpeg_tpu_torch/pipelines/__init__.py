"""Encoder pipelines of the port."""
