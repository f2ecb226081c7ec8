"""paddle_tpu_torch: the PyTorch + CUDA port of paddle_tpu for NVIDIA H100.

`import paddle_tpu_torch as paddle` gives the Paddle Tensor API: `Tensor`
(a wrapper over a torch tensor, its tape torch autograd), `to_tensor`,
`Parameter`, `create_parameter`, the dtypes, the places and
`set_device`, `no_grad` / `enable_grad` / `set_grad_enabled`, `seed`,
`grad`, `autograd` (`backward`, `PyLayer`, `jacobian`, `hessian`), the
tensor ops at top level (`add`, `reshape`, `matmul`, ...), as the
reference's `from .ops import *`, and `nn` (`Layer`, the layer zoo,
`functional`, `initializer`) with `save` / `load` and `ParamAttr`, and
the long tail: `fft`, `signal`, `geometric`, `incubate` (with
`incubate.autograd` and the fused-op `incubate.nn.functional`) and
`text.viterbi_decode`.

Below it the port serves LLaMA through the paged continuous-batching
`inference.ServingEngine` and trains LLaMA, GPT and BERT
(`text.models`, `optimizer`, `amp`, `jit.to_static`), with hand-written
CUDA kernels (`ops.flash_attention`, `ops.paged_decode`,
`ops.fused_norm`, ...). Importing this package pulls in neither jax nor
paddle_tpu. Entry points run on ``"cuda"`` unless the caller passes
``device="cpu"`` (or `set_device("cpu")` for the Tensor API), where the
kernels' plain PyTorch versions run.
"""
__version__ = "0.1.0"

import math as _math

# `ops` first: its import pulls in core, amp and jit in the one order
# without a cycle (core.dispatch -> amp -> jit.api -> ops._cuda_common)
from . import ops  # noqa: F401,I001
from .core.device import (  # noqa: F401
    CPUPlace, CUDAPinnedPlace, CUDAPlace, Place, device_count, get_device,
    is_compiled_with_cuda, set_device)
from .core.dispatch import (enable_grad, no_grad,  # noqa: F401
                            set_grad_enabled)
from .core.dtype import bool_ as bool  # noqa: A001,F401
from .core.dtype import (  # noqa: F401
    bfloat16, complex64, complex128, float8_e4m3fn, float8_e5m2, float16,
    float32, float64, get_default_dtype, int8, int16, int32, int64,
    promote_types, set_default_dtype, uint8)
from .core.engine import grad  # noqa: F401
from .core.flags import set_flags  # noqa: F401
from .core.rng import get_rng_state, seed, set_rng_state  # noqa: F401
from .core.tensor import Parameter, Tensor, to_tensor  # noqa: F401
from .ops import *  # noqa: F401,F403
from .ops import _tensor_to  # noqa: F401
from . import autograd  # noqa: F401,E402
from . import linalg  # noqa: F401,E402
from . import nn  # noqa: F401,E402
from . import amp, jit, optimizer  # noqa: F401,E402
from . import fft, geometric, incubate, signal, text  # noqa: F401,E402
from .framework_io import load, save  # noqa: F401,E402
from .nn import ParamAttr  # noqa: F401,E402


def is_grad_enabled():
    from .core.dispatch import grad_enabled

    return grad_enabled()


def in_dynamic_mode():
    return True


e = _math.e
pi = _math.pi
inf = float("inf")
nan = float("nan")
newaxis = None
