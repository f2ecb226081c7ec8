"""Incubating functional APIs of the port."""
from .fused_loss import fused_linear_cross_entropy  # noqa: F401
