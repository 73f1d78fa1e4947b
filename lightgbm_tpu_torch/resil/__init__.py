"""Crash-safe file publication (``atomic_write_text``)."""
