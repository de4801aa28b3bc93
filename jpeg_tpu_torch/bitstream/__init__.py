"""JFIF container emission."""
