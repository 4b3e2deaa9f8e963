"""Layer-construction DSL: the subset of ``paddle_tpu/config/dsl.py`` that
``lstm_text_classifier`` and a serve config need.

Each function appends a ``LayerDef`` to the active ``ModelDef`` and returns
a ``LayerOutput`` handle usable as ``input=`` of later calls. Names,
attributes and auto-generated names (``__fc_layer_0__``) match the JAX
DSL, so both build the same graph from the same calls.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional

from paddle_tpu_torch.config.model_config import (Input, LayerDef, ModelDef,
                                                  ParamAttr)

_GRAPH = ModelDef()
_COUNTERS: Dict[str, itertools.count] = {}
_SHAPES: Dict[str, Any] = {}


def reset():
    """Start a fresh graph."""
    global _GRAPH, _COUNTERS
    _GRAPH = ModelDef()
    _COUNTERS = {}
    _SHAPES.clear()


def current_graph() -> ModelDef:
    return _GRAPH


def _auto_name(type_name: str) -> str:
    c = _COUNTERS.setdefault(type_name, itertools.count())
    return f"__{type_name}_layer_{next(c)}__"


@dataclasses.dataclass(frozen=True)
class LayerOutput:
    name: str
    size: int
    graph: Any = dataclasses.field(default=None, repr=False, compare=False)

    def __repr__(self):
        return f"LayerOutput({self.name!r}, size={self.size})"


def _in(x) -> List[LayerOutput]:
    if isinstance(x, LayerOutput):
        return [x]
    return list(x)


def _add(ldef: LayerDef) -> LayerOutput:
    from paddle_tpu_torch.core.registry import get_layer_impl
    import paddle_tpu_torch.layers  # noqa: F401  (registers layer types)
    _GRAPH.add(ldef)
    infos = [_SHAPES[i.layer_name] for i in ldef.inputs]
    info = get_layer_impl(ldef.type).infer(ldef, infos)
    _SHAPES[ldef.name] = info
    return LayerOutput(ldef.name, info.size, graph=_GRAPH)


def _param(attr) -> Optional[ParamAttr]:
    if attr is None or isinstance(attr, ParamAttr):
        return attr
    if isinstance(attr, dict):
        return ParamAttr(**attr)
    raise TypeError(f"bad param attr {attr!r}")


def _bias(bias_attr):
    if bias_attr is True or bias_attr is None:
        return True
    if bias_attr is False:
        return False
    return _param(bias_attr) or True


# ----------------------------------------------------------------- layers
def data(name: str, size: int, *, height: int = None, width: int = None,
         channels: int = None, is_sequence: bool = False) -> LayerOutput:
    ldef = LayerDef(name=name, type="data", size=size, bias=False,
                    attrs={"height": height, "width": width,
                           "channels": channels, "is_sequence": is_sequence})
    return _add(ldef)


def fc(input, size: int, *, act: str = "tanh", name: str = None,
       bias_attr=True, param_attr=None) -> LayerOutput:
    ins = [Input(i.name, param_attr=_param(param_attr)) for i in _in(input)]
    ldef = LayerDef(name=name or _auto_name("fc"), type="fc", inputs=ins,
                    size=size, act=act, bias=_bias(bias_attr))
    return _add(ldef)


def embedding(input, size: int, *, vocab_size: int = None, name: str = None,
              param_attr=None) -> LayerOutput:
    src = _in(input)[0]
    vocab = vocab_size or _SHAPES[src.name].size
    ldef = LayerDef(name=name or _auto_name("embedding"), type="embedding",
                    inputs=[Input(src.name, param_attr=_param(param_attr))],
                    size=size, bias=False, attrs={"vocab_size": vocab})
    return _add(ldef)


def lstmemory(input, *, name: str = None, reverse: bool = False,
              act: str = "tanh", gate_act: str = "sigmoid",
              state_act: str = "tanh", bias_attr=True,
              param_attr=None) -> LayerOutput:
    src = _in(input)[0]
    ldef = LayerDef(name=name or _auto_name("lstmemory"), type="lstmemory",
                    inputs=[Input(src.name, param_attr=_param(param_attr))],
                    bias=_bias(bias_attr),
                    attrs={"reversed": reverse, "active_type": act,
                           "active_gate_type": gate_act,
                           "active_state_type": state_act})
    return _add(ldef)


def pooling(input, *, pooling_type: str = "max",
            name: str = None) -> LayerOutput:
    """Sequence pooling; only max over time is ported so far."""
    if pooling_type != "max":
        raise NotImplementedError(
            f"pooling_type={pooling_type!r} is not ported yet (max is)")
    src = _in(input)[0]
    ldef = LayerDef(name=name or _auto_name("seq_max"), type="max",
                    inputs=[Input(src.name)], bias=False, attrs={})
    return _add(ldef)


def classification_cost(input, label, *, name: str = None) -> LayerOutput:
    """Cross-entropy on post-softmax input. Graph only: the port serves
    outputs and does not evaluate costs yet."""
    ldef = LayerDef(name=name or _auto_name("cost"),
                    type="multi-class-cross-entropy",
                    inputs=[Input(_in(input)[0].name),
                            Input(_in(label)[0].name)], bias=False)
    return _add(ldef)
