"""Utilities of the host runtime: the leveled logger (``log``) and the
graph and priority-queue helpers (``graph``)."""
