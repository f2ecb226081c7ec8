"""paddle.hapi — the high-level Model API (port of paddle_tpu/hapi)."""
from . import callbacks
from .callbacks import (Callback, EarlyStopping, LRScheduler,
                        ModelCheckpoint, ProgBarLogger, TelemetryCallback)
from .model import Model

__all__ = ["Model", "callbacks", "Callback", "ProgBarLogger",
           "ModelCheckpoint", "EarlyStopping", "LRScheduler",
           "TelemetryCallback"]
