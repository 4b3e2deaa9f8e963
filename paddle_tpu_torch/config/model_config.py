"""Model configuration graph — the contract between the DSL and the executor.

The port's own copy of ``paddle_tpu/config/model_config.py``: the same
dataclasses with the same field names, so a ``ModelDef`` pickled by the JAX
package (inside a PTM1 merged model) unpickles onto these classes field for
field (``trainer/merge_model.py`` maps the module path).

Parameter naming follows the reference convention: input weight i of layer
L is ``_L.w{i}``, the bias is ``_L.wbias``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union


@dataclasses.dataclass
class ParamAttr:
    """Per-parameter attributes (``proto/ParameterConfig.proto``)."""

    name: Optional[str] = None  # explicit name => parameter sharing
    init: str = "normal"
    initial_mean: float = 0.0
    initial_std: Optional[float] = None
    is_static: bool = False
    learning_rate: float = 1.0
    l1_rate: Optional[float] = None
    l2_rate: Optional[float] = None
    sparse_grad: bool = False
    sparsity_ratio: Optional[float] = None
    # True when this attr was synthesized from parse-wide defaults rather
    # than written at the layer: such attrs must not clobber
    # const-initialized specs
    from_defaults: bool = False


@dataclasses.dataclass
class Input:
    """One input connection of a layer (``LayerConfig.inputs``)."""

    layer_name: str
    param_attr: Optional[ParamAttr] = None
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class LayerDef:
    """One layer (``LayerConfig`` in ``proto/ModelConfig.proto``)."""

    name: str
    type: str
    inputs: List[Input] = dataclasses.field(default_factory=list)
    size: Optional[int] = None
    act: str = "linear"
    bias: Union[bool, ParamAttr] = True
    drop_rate: float = 0.0
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def input_names(self) -> List[str]:
        return [i.layer_name for i in self.inputs]


@dataclasses.dataclass
class ModelDef:
    """The full graph (``ModelConfig``)."""

    layers: Dict[str, LayerDef] = dataclasses.field(default_factory=dict)
    input_layer_names: List[str] = dataclasses.field(default_factory=list)
    output_layer_names: List[str] = dataclasses.field(default_factory=list)
    evaluators: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    def add(self, layer: LayerDef) -> LayerDef:
        if layer.name in self.layers:
            raise ValueError(f"duplicate layer name {layer.name!r}")
        self.layers[layer.name] = layer
        if layer.type == "data":
            self.input_layer_names.append(layer.name)
        return layer

    def topo_order(self, targets: Optional[List[str]] = None) -> List[str]:
        """Topological order of the sub-graph reaching ``targets``
        (defaults to output_layer_names, else all layers)."""
        if targets is None:
            targets = self.output_layer_names or list(self.layers)
        order: List[str] = []
        seen: Dict[str, int] = {}  # 0=visiting, 1=done

        def visit(name: str):
            st = seen.get(name)
            if st == 1:
                return
            if st == 0:
                raise ValueError(f"cycle through layer {name!r}")
            if name not in self.layers:
                raise KeyError(f"layer {name!r} referenced but not defined")
            seen[name] = 0
            for dep in self.layers[name].input_names():
                visit(dep)
            seen[name] = 1
            order.append(name)

        for t in targets:
            visit(t)
        return order
