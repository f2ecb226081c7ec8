"""paddle.quantization: config-driven PTQ and QAT.

Port of paddle_tpu/quantization: `QuantConfig`, the calibration
observers, the fake-quant quanters (straight-through gradient as a
`torch.autograd.Function`), `PTQ` / `QAT` with `QuantizedLinear`
(weight-only, or full int8 whose int8 x int8 -> int32 product is
cuBLASLt's on a card), and the weight-only export `ptq_state_dict` /
`load_ptq_state_dict` in `weight_quantize`'s layout, which loads in
either package.
"""
from .config import QuantConfig
from .observers import AbsmaxObserver, BaseObserver, MinMaxObserver
from .ptq import PTQ, load_ptq_state_dict, ptq_state_dict
from .qat import QAT
from .quanters import BaseQuanter, FakeQuanterWithAbsMax, fake_quant, quanter

__all__ = ["QuantConfig", "PTQ", "QAT", "ptq_state_dict",
           "load_ptq_state_dict",
           "AbsmaxObserver", "MinMaxObserver",
           "BaseObserver", "BaseQuanter", "quanter",
           "FakeQuanterWithAbsMax", "fake_quant"]
