"""Incubating functional APIs of the port."""
from ....nn.functional import fused_dropout_add  # noqa: F401
from .fused_loss import fused_linear_cross_entropy  # noqa: F401
