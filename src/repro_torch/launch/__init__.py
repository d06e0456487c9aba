"""Launcher of the port: the static-batching serving loop (``serve``)."""
