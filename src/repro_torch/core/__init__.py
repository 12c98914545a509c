"""Tally's core on PyTorch: descriptors, transforms, scheduler, profiler and
the real-mode server."""
