"""Distributed control plane (the port of ``repro.distributed``): the
heartbeat and straggler monitors, the logical-axis sharding rules and the
gradient compression."""
