"""paddle.callbacks: the hapi callback set Model.fit uses (port of
paddle_tpu/callbacks.py)."""
from .hapi.callbacks import (  # noqa: F401
    Callback, CallbackList, ProgBarLogger, ModelCheckpoint, EarlyStopping,
    LRScheduler,
)

__all__ = ['Callback', 'ProgBarLogger', 'ModelCheckpoint', 'EarlyStopping',
           'LRScheduler']
