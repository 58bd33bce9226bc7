"""End-to-end examples of the port, run with ``python -m``."""
