"""QuantConfig: which layers get quantized, and by what (port of
paddle_tpu/quantization/config.py)."""
from __future__ import annotations


class _SingleConfig:
    def __init__(self, activation=None, weight=None):
        self.activation = activation
        self.weight = weight


class QuantConfig:
    """Declares which layers get quantized and by what quanter or observer
    factories (classes or zero-argument callables, or instances). A
    layer's config is looked up by the layer itself, then its name, then
    its type; the default covers `nn.Linear` only."""

    def __init__(self, activation=None, weight=None):
        self._default = _SingleConfig(activation, weight)
        self._by_type: dict = {}
        self._by_layer: dict = {}
        self._by_name: dict = {}

    def add_type_config(self, layer_type, activation=None, weight=None):
        for t in (layer_type if isinstance(layer_type, (list, tuple))
                  else [layer_type]):
            self._by_type[t] = _SingleConfig(activation, weight)

    def add_layer_config(self, layer, activation=None, weight=None):
        for lay in (layer if isinstance(layer, (list, tuple)) else [layer]):
            self._by_layer[id(lay)] = _SingleConfig(activation, weight)

    def add_name_config(self, layer_name, activation=None, weight=None):
        for n in (layer_name if isinstance(layer_name, (list, tuple))
                  else [layer_name]):
            self._by_name[n] = _SingleConfig(activation, weight)

    def config_for(self, name: str, layer) -> _SingleConfig | None:
        if id(layer) in self._by_layer:
            return self._by_layer[id(layer)]
        if name in self._by_name:
            return self._by_name[name]
        if type(layer) in self._by_type:
            return self._by_type[type(layer)]
        from ..nn import Linear

        # the default covers the quantizable set (Linear) only; explicit
        # configs on other types warn in quantize()
        if (self._default.activation or self._default.weight) and \
                isinstance(layer, Linear):
            return self._default
        return None
