"""paddle.save / paddle.load.

Port of paddle_tpu/framework_io.py: nested containers pickled with each
Tensor turned into the reference's record, {"__paddle_tpu_tensor__":
True, "data": numpy array, "stop_gradient", "name"}, so a file that one
package writes loads in the other without importing it. The write goes
through the checkpoint core's crash-consistent write
(`ckpt.core.atomic_write_stream`), as the reference's does: the pickle
streams into a temp file in the same directory, which is fsynced and
atomically renamed over the target.

bfloat16 and float8: numpy has no such dtypes without ml_dtypes, which
the port does not use, so their "data" is float32 (every value exact)
and the record carries one more key, "dtype" (e.g. "bfloat16"); the
port's `load` casts such a record back, so its own round trip keeps the
dtype and the bits. The reference's `load` ignores the key and gives a
float32 Tensor. A record without the key (the reference's files) loads
in the array's dtype.
"""
from __future__ import annotations

import os
import pickle

from .ckpt.core import atomic_write_stream
from .core import dtype as dtypes
from .core.tensor import Tensor

_MARK = "__paddle_tpu_tensor__"


def _to_serializable(obj):
    if isinstance(obj, Tensor):
        rec = {_MARK: True, "data": obj.numpy(),
               "stop_gradient": obj.stop_gradient, "name": obj.name}
        if obj._data.dtype not in dtypes._TO_NUMPY:
            rec["dtype"] = dtypes.dtype_name(obj._data.dtype)
        return rec
    if isinstance(obj, dict):
        return {k: _to_serializable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_to_serializable(v) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def _from_serializable(obj, return_numpy=False):
    if isinstance(obj, dict):
        if obj.get(_MARK):
            if return_numpy:
                return obj["data"]
            t = Tensor(obj["data"], dtype=obj.get("dtype"),
                       stop_gradient=obj["stop_gradient"])
            t.name = obj["name"]
            return t
        return {k: _from_serializable(v, return_numpy)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_from_serializable(v, return_numpy) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def save(obj, path, protocol=4, **configs):
    """Pickle `obj` (Tensors as records, see the module note) to `path`,
    crash-consistently."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    payload = _to_serializable(obj)
    atomic_write_stream(path,
                        lambda f: pickle.dump(payload, f, protocol=protocol))


def load(path, **configs):
    """The object `save` wrote (or the reference's `paddle.save`), its
    Tensors on the current device; `return_numpy=True` gives their numpy
    arrays instead."""
    with open(path, "rb") as f:
        obj = pickle.load(f)
    return _from_serializable(obj, configs.get("return_numpy", False))

