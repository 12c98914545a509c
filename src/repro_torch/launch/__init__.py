"""Entry points (the port of ``repro.launch``): the serving driver."""
