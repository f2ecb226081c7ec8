"""Incubating nn APIs of the port."""
