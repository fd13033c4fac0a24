"""Visualization and reporting: static plots (matplotlib) and the
interactive HTML dashboard."""
