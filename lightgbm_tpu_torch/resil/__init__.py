"""Crash-safe file publication (``atomic_write_text``), the retry-delay
schedule (``backoff``) and named fault sites (``faults``)."""
