"""nn layers of the port."""
from .norm import Dropout, LayerNorm  # noqa: F401
