"""Utilities: scalar event logs (``summary``) and step timing and traces
(``profiling``)."""
