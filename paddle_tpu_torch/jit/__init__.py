"""`to_static` (one captured CUDA graph per specialization) and the
reference's jit surface: `enable_to_static`, `not_to_static`,
`ignore_module`, `set_code_level`, `set_verbosity`, `BucketAxis`,
`default_buckets`. `save` / `load` / `TranslatedLayer` and `dy2static`
are not ported and raise NotImplementedError naming their ROADMAP item."""
from ..core.flags import set_flags
from .api import (BucketAxis, CompiledFunction,  # noqa: F401
                  compiled_call_active, default_buckets, ignore_module,
                  not_to_static, to_static)

_SAVE_LOAD = ("jit.save / jit.load / TranslatedLayer are not ported (ROADMAP "
              "Queue 1, 'jit.save / jit.load', with ckpt/)")


def enable_to_static(enable=True):
    """Globally toggle to_static: off, decorated functions run eagerly."""
    set_flags({"FLAGS_enable_to_static": bool(enable)})


def set_code_level(level=100):
    """The reference's SOT code-dump shim: the level is recorded."""
    set_flags({"FLAGS_jit_code_level": int(level)})


def set_verbosity(level=0, also_to_stdout=False):
    set_flags({"FLAGS_jit_verbosity": int(level),
               "FLAGS_jit_log_to_stdout": bool(also_to_stdout)})


def save(layer, path, input_spec=None, **configs):
    raise NotImplementedError(_SAVE_LOAD)


def load(path, **configs):
    raise NotImplementedError(_SAVE_LOAD)


class TranslatedLayer:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_SAVE_LOAD)


class dy2static:
    """The reference's AST rewriting of tensor-valued control flow."""

    @staticmethod
    def convert_to_static(fn):
        raise NotImplementedError(
            "dy2static's control-flow rewriting is not ported (ROADMAP "
            "Queue 1, 'dy2static control flow'); a tensor-valued `if` is a "
            "graph break under the port's to_static")
