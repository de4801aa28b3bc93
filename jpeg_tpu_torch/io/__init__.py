"""Image file I/O and resize/pad tools (numpy only)."""
