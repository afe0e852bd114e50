"""Crossbar physics: macro spec, nonideal effects, quantizers, mapping and
the single-chip structural simulation."""
