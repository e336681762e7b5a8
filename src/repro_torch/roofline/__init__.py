"""Roofline analysis of traced steps (port of ``repro.roofline``)."""
