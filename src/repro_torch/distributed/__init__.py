"""Distributed control plane (the parts of ``repro.distributed`` that the
training driver uses)."""
