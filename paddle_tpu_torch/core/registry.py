"""Layer registry keyed by the reference's ``LayerConfig.type`` strings.

The port's counterpart of ``paddle_tpu/core/registry.py``: an
implementation bundles shape inference, the parameter spec and an apply
function over torch tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class ShapeInfo:
    """Static shape metadata flowing through config-time shape inference.

    size: feature dimension (LayerConfig.size).
    channels/height/width: image geometry for conv/pool/norm layers.
    is_sequence: whether the layer emits per-timestep values.
    """

    size: int
    channels: Optional[int] = None
    height: Optional[int] = None
    width: Optional[int] = None
    is_sequence: bool = False


@dataclasses.dataclass
class ParamSpec:
    """What to allocate for one learnable parameter
    (``proto/ParameterConfig.proto``); the fields the port reads, named as
    in the JAX package's ``ParamSpec``."""

    shape: Tuple[int, ...]
    init: str = "normal"  # normal | uniform | zeros | const
    initial_mean: float = 0.0
    initial_std: Optional[float] = None
    is_static: bool = False
    learning_rate: float = 1.0
    is_bias: bool = False
    sparse_grad: bool = False
    l1_rate: Optional[float] = None
    l2_rate: Optional[float] = None
    sparsity_ratio: Optional[float] = None
    absolute_name: Optional[str] = None
    wire_dims: Optional[Tuple[int, ...]] = None
    user_sparse: bool = False


class LayerImpl:
    """Base for registered layer implementations. Subclasses override:

    - infer(cfg, in_infos)  -> ShapeInfo  (config-time shape inference)
    - params(cfg, in_infos) -> {suffix: ParamSpec}
    - apply(cfg, params, ins, ctx) -> Argument (pre-activation; the executor
      applies cfg.act afterwards, matching Layer::forwardActivation)
    """

    type_name: str = ""

    def infer(self, cfg, in_infos: List[ShapeInfo]) -> ShapeInfo:
        raise NotImplementedError

    def params(self, cfg, in_infos: List[ShapeInfo]) -> Dict[str, ParamSpec]:
        return {}

    def apply(self, cfg, params, ins, ctx):
        raise NotImplementedError


_LAYER_REGISTRY: Dict[str, LayerImpl] = {}


def register_layer(*type_names: str):
    """Class decorator: ``@register_layer("fc")``. Aliases allowed."""

    def deco(cls):
        impl = cls()
        impl.type_name = type_names[0]
        for t in type_names:
            if t in _LAYER_REGISTRY:
                raise ValueError(f"duplicate layer type {t!r}")
            _LAYER_REGISTRY[t] = impl
        return cls

    return deco


def get_layer_impl(type_name: str) -> LayerImpl:
    if type_name not in _LAYER_REGISTRY:
        raise KeyError(
            f"layer type {type_name!r} is not ported yet; ported: "
            f"{sorted(_LAYER_REGISTRY)}")
    return _LAYER_REGISTRY[type_name]
