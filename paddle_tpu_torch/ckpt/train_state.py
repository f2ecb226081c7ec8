"""Full resumable train state: ONE capture that makes resume bitwise.

Port of paddle_tpu/ckpt/train_state.py. ``capture_train_state`` packs
everything a training process needs to continue as if it never stopped
— params, optimizer slots (moments, master weights, the step count),
the global step, the RNG streams, the LR-schedule state (inside the
optimizer's state dict), and the data-iterator position — into one
checkpoint tree for ``ckpt.core``.

RNG streams. numpy's global state (which drives DataLoader shuffling)
is stored as the reference stores it, under ``rng/numpy``. The
framework stream differs by design: the reference keeps a jax key under
``rng/paddle``, the port the states of torch's generators under
``rng/torch`` (the default CPU and CUDA generators, which dropout draws
from, and the Tensor API's per-device generators, ``core.rng``). Each
package restores its own stream; restoring the other package's
checkpoint restores params, optimizer slots, step, LR state, numpy state
and data position, and logs that the framework stream was not restored
(ROADMAP Queue 3, the RNG-stream divergence). ``restore_train_state``
reports which streams it restored under ``"rng"``.
"""
from __future__ import annotations

import numpy as np
import torch


# ------------------------------------------------------- numpy RNG state
def pack_np_state(state=None) -> dict:
    """np.random.get_state() tuple -> checkpoint-tree-friendly dict
    (the MT19937 key vector stays an array shard)."""
    if state is None:
        state = np.random.get_state()
    algo, keys, pos, has_gauss, cached = state
    return {"algo": str(algo), "keys": np.asarray(keys, np.uint32),
            "pos": int(pos), "has_gauss": int(has_gauss),
            "cached_gaussian": float(cached)}


def unpack_np_state(packed) -> tuple:
    return (packed["algo"], np.asarray(packed["keys"], np.uint32),
            int(packed["pos"]), int(packed["has_gauss"]),
            float(packed["cached_gaussian"]))


def _network_of(model):
    """Accept a bare nn.Layer or a hapi Model."""
    return getattr(model, "network", model)


def _structured_names(model):
    """{id(param): model-state-dict key}: the optimizer's raw parameter
    names come from a process-global counter and do not reproduce after
    a restart, so its slots are keyed by the model's structured
    parameter paths to be restorable (``Optimizer.state_dict``'s
    ``structured_names``)."""
    if model is None:
        return None
    out = {}
    for k, p in _network_of(model).state_dict().items():
        # the optimizer holds a Parameter's torch leaf (`_data`)
        out[id(p)] = out[id(getattr(p, "_data", p))] = k
    return out


def _state_bytes(state) -> np.ndarray:
    return state.cpu().numpy().copy()


def _torch_rng_state() -> dict:
    from ..core import rng

    out = {"cpu": _state_bytes(torch.get_rng_state()),
           "paddle_seed": int(rng._seed),
           "paddle": {str(dev): _state_bytes(g.get_state())
                      for dev, g in rng._gens.items()}}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        out["cuda"] = [_state_bytes(s)
                       for s in torch.cuda.get_rng_state_all()]
    return out


def _set_torch_rng_state(st) -> None:
    from ..core import rng

    torch.set_rng_state(torch.as_tensor(np.asarray(st["cpu"], np.uint8)))
    if st.get("cuda") is not None and torch.cuda.is_available():
        torch.cuda.set_rng_state_all(
            [torch.as_tensor(np.asarray(s, np.uint8)) for s in st["cuda"]])
    rng._seed = int(st.get("paddle_seed", rng._seed))
    for dev, s in (st.get("paddle") or {}).items():
        rng.generator(torch.device(dev)).set_state(
            torch.as_tensor(np.asarray(s, np.uint8)))


def capture_train_state(model=None, optimizer=None, step=0,
                        data_state=None, extra=None) -> dict:
    """Snapshot the live training process as one checkpoint tree. Leaves
    stay references to the live tensors — the device→host copy happens
    inside the saver (``core.host_copy``), so capturing is cheap enough
    to do every save interval."""
    tree = {"step": int(step)}
    if model is not None:
        tree["model"] = dict(_network_of(model).state_dict())
    if optimizer is not None:
        try:
            tree["optimizer"] = dict(optimizer.state_dict(
                structured_names=_structured_names(model)))
        except TypeError:   # a custom optimizer without the keyword
            tree["optimizer"] = dict(optimizer.state_dict())
    tree["rng"] = {"torch": _torch_rng_state(), "numpy": pack_np_state()}
    tree["data"] = dict(data_state or {})
    if extra:
        tree["extra"] = dict(extra)
    return tree


def restore_train_state(tree, model=None, optimizer=None,
                        restore_rng=True) -> dict:
    """Apply a captured train state back onto live objects. Returns
    ``{"step": ..., "data": ..., "rng": [streams restored]}`` so the loop
    can fast-forward its data iterator to the captured position."""
    if model is not None and "model" in tree:
        _network_of(model).set_state_dict(tree["model"])
    if optimizer is not None and "optimizer" in tree:
        state = dict(tree["optimizer"])
        try:
            optimizer.set_state_dict(
                state, structured_names=_structured_names(model))
        except TypeError:
            optimizer.set_state_dict(state)
    restored = []
    if restore_rng and "rng" in tree:
        rng = tree["rng"]
        if rng.get("torch") is not None:
            _set_torch_rng_state(rng["torch"])
            restored.append("torch")
        elif rng.get("paddle") is not None:
            from .. import obs

            obs.get_logger(__name__).warning(
                "checkpoint carries paddle_tpu's framework RNG stream (a "
                "jax key), which the port cannot continue; params, "
                "optimizer, step, LR, numpy state and data position were "
                "restored, the torch generators were not (ROADMAP Queue "
                "3, RNG-stream divergence)", key="ckpt-rng-divergence")
        if rng.get("numpy") is not None:
            np.random.set_state(unpack_np_state(rng["numpy"]))
            restored.append("numpy")
    return {"step": int(tree.get("step", 0)),
            "data": dict(tree.get("data", {})), "rng": restored}
