"""Core runtime pieces of the port (flag registry)."""
