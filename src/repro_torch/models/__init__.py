"""Models on the port's kernels (ports of ``repro.models``)."""
