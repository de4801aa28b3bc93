"""Constant tables and configuration types (numpy only)."""
