"""Incubating APIs of the port (the fused loss)."""
