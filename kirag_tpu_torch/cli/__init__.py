"""Command-line entry points of the port (the offline index build)."""
