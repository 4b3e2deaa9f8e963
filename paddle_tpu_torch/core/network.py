"""Network: the graph executor over a ``ModelDef``.

The port's counterpart of ``paddle_tpu/core/network.py``: the same
topological order, the same parameter table and the same
``_{layer}.{suffix}`` parameter names, so a JAX parameter dict drives this
executor unchanged. PyTorch runs eagerly: ``apply`` walks the layers and
calls each one's torch implementation.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from paddle_tpu_torch.config.model_config import LayerDef, ModelDef, ParamAttr
from paddle_tpu_torch.core.argument import Argument
from paddle_tpu_torch.core.initializers import init_param
from paddle_tpu_torch.core.registry import ParamSpec, ShapeInfo, get_layer_impl


@dataclasses.dataclass
class Context:
    """Per-apply execution context handed to layer impls."""

    train: bool = False
    out_info: Optional[ShapeInfo] = None
    outputs: Dict[str, Argument] = dataclasses.field(default_factory=dict)
    # cross-batch recurrent state: layer name -> initial state
    carried: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _resolve_param_name(layer: LayerDef, suffix: str, spec: ParamSpec,
                        attr: Optional[ParamAttr]) -> str:
    if spec.absolute_name:
        return spec.absolute_name
    if attr is not None and attr.name:
        return attr.name
    return f"_{layer.name}.{suffix}"


def _apply_attr(spec: ParamSpec, attr: Optional[ParamAttr]) -> ParamSpec:
    if attr is None:
        return spec
    if getattr(attr, "from_defaults", False) and spec.init in ("const",
                                                               "zeros"):
        return spec
    # an attr with no explicit init values keeps the layer's deliberate
    # constant init (batch-norm gamma's 1.0 survives ParamAttr(lr=...))
    init_explicit = getattr(attr, "init_explicit",
                            attr.initial_std is not None
                            or attr.init != "normal")
    keep_init = (not init_explicit) and spec.init in ("const", "zeros")
    return dataclasses.replace(
        spec,
        init=spec.init if keep_init else (
            attr.init if attr.init != "normal"
            or attr.initial_std is not None else spec.init),
        initial_mean=spec.initial_mean if keep_init else attr.initial_mean,
        initial_std=attr.initial_std if attr.initial_std is not None
        else spec.initial_std,
        is_static=attr.is_static or spec.is_static,
        learning_rate=attr.learning_rate,
        sparse_grad=attr.sparse_grad or spec.sparse_grad,
        user_sparse=attr.sparse_grad or spec.user_sparse,
        l1_rate=attr.l1_rate,
        l2_rate=attr.l2_rate,
        sparsity_ratio=(attr.sparsity_ratio
                        if attr.sparsity_ratio is not None
                        else spec.sparsity_ratio),
    )


def _weight_index(suffix: str) -> Optional[int]:
    if suffix.startswith("w") and suffix[1:].isdigit():
        return int(suffix[1:])
    return None


class Network:
    """Compiled view of a ModelDef: shape inference, parameter table, and
    an eager ``apply``."""

    def __init__(self, model: ModelDef,
                 outputs: Optional[List[str]] = None):
        self.model = model
        self.order = model.topo_order(outputs)
        self.shape_infos: Dict[str, ShapeInfo] = {}
        self.param_specs: Dict[str, ParamSpec] = {}
        self._layer_params: Dict[str, Dict[str, str]] = {}

        for name in self.order:
            layer = model.layers[name]
            impl = get_layer_impl(layer.type)
            in_infos = [self.shape_infos[i] for i in layer.input_names()]
            self.shape_infos[name] = impl.infer(layer, in_infos)
            self._layer_params[name] = {}
            for suffix, spec in impl.params(layer, in_infos).items():
                if spec.is_bias:
                    attr = (layer.bias if isinstance(layer.bias, ParamAttr)
                            else None)
                else:
                    # weight i takes input i's param_attr
                    idx = _weight_index(suffix)
                    attr = (layer.inputs[idx].param_attr
                            if idx is not None and idx < len(layer.inputs)
                            else None)
                pname = _resolve_param_name(layer, suffix, spec, attr)
                spec = _apply_attr(spec, attr)
                if pname in self.param_specs:
                    if self.param_specs[pname].shape != spec.shape:
                        raise ValueError(
                            f"shared parameter {pname!r} shape mismatch: "
                            f"{self.param_specs[pname].shape} vs "
                            f"{spec.shape}")
                else:
                    self.param_specs[pname] = spec
                self._layer_params[name][suffix] = pname

    def init_params(self, generator: torch.Generator, device="cuda",
                    dtype=torch.float32) -> Dict[str, torch.Tensor]:
        """Fresh parameters in sorted-name order from ``generator``."""
        return {
            pname: init_param(generator, spec.shape, init=spec.init,
                              initial_mean=spec.initial_mean,
                              initial_std=spec.initial_std, dtype=dtype,
                              device=device)
            for pname, spec in sorted(self.param_specs.items())}

    def apply(self, params: Dict[str, torch.Tensor],
              feed: Dict[str, Argument], *, train: bool = False,
              carried: Optional[Dict[str, Any]] = None,
              ) -> Dict[str, Argument]:
        """Forward over the whole graph. ``feed`` maps data-layer names to
        Arguments; returns every layer's output keyed by layer name."""
        from paddle_tpu_torch.layers.activations import apply_activation
        ctx = Context(train=train, carried=carried or {})
        for name in self.order:
            layer = self.model.layers[name]
            if layer.type == "data":
                if name not in feed:
                    raise KeyError(f"missing feed for data layer {name!r}")
                ctx.outputs[name] = feed[name]
                continue
            impl = get_layer_impl(layer.type)
            ins = [ctx.outputs[i] for i in layer.input_names()]
            lparams = {s: params[p]
                       for s, p in self._layer_params[name].items()}
            ctx.out_info = self.shape_infos[name]
            out = impl.apply(layer, lparams, ins, ctx)
            if layer.act and layer.act not in ("linear", ""):
                out = out.with_value(apply_activation(layer.act, out.value))
            if layer.drop_rate > 0.0:
                if train:
                    raise NotImplementedError(
                        "training-mode dropout is not ported yet")
                # reference (non-inverted) dropout scales at test time
                out = out.with_value(out.value * (1.0 - layer.drop_rate))
            ctx.outputs[name] = out
        return ctx.outputs
