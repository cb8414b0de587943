"""Utilities of the host runtime: the leveled logger (``log``)."""
