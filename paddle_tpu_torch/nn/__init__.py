"""nn APIs of the port: the functional ops the model forwards route, and
gradient clipping (`ClipGradByValue`, `ClipGradByNorm`,
`ClipGradByGlobalNorm`, `clip_grad_norm_`, `clip_grad_value_`)."""
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue, clip_grad_norm_, clip_grad_value_)
