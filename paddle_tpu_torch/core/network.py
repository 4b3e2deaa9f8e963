"""Network: the graph executor over a ``ModelDef``.

The port's counterpart of ``paddle_tpu/core/network.py``: the same
topological order, the same parameter table and the same
``_{layer}.{suffix}`` parameter names, so a JAX parameter dict drives this
executor unchanged. PyTorch runs eagerly: ``apply`` walks the layers and
calls each one's torch implementation; with ``train=True`` the autograd
graph it builds is what the trainer differentiates.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Dict, List, Optional, Tuple

import torch

from paddle_tpu_torch.config.model_config import LayerDef, ModelDef, ParamAttr
from paddle_tpu_torch.core.argument import Argument
from paddle_tpu_torch.core.initializers import init_param
from paddle_tpu_torch.core.registry import ParamSpec, ShapeInfo, get_layer_impl


@dataclasses.dataclass
class Context:
    """Per-apply execution context handed to layer impls."""

    train: bool = False
    in_infos: List[ShapeInfo] = dataclasses.field(default_factory=list)
    out_info: Optional[ShapeInfo] = None
    outputs: Dict[str, Argument] = dataclasses.field(default_factory=dict)
    # moving statistics (batch_norm): param name -> new value, folded into
    # the parameters by the train step after the optimizer's update
    state_updates: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)
    # cross-batch recurrent state: layer name -> initial state
    carried: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # the step's seed (training-mode dropout): each layer folds its name in
    seed: Optional[int] = None

    def layer_seed(self, name: str) -> int:
        """The seed of one layer's random stream: the step's seed with
        ``crc32(name)`` folded in (JAX ``Context.layer_rng``)."""
        if self.seed is None:
            raise ValueError("this apply needs a step seed (training-mode "
                             "dropout)")
        return fold_seed(self.seed, zlib.crc32(name.encode()))


_MASK63 = (1 << 63) - 1


def fold_seed(seed: int, data: int) -> int:
    """A 63-bit seed from ``seed`` and ``data`` (splitmix64's mixer): the
    counterpart of ``jax.random.fold_in`` for the port's seeds."""
    z = (seed * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) & (2**64 - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & (2**64 - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & (2**64 - 1)
    return (z ^ (z >> 31)) & _MASK63


def _dropout_mask(shape, rate: float, ctx: Context, name: str,
                  device) -> torch.Tensor:
    """The 0/1 keep mask (float32) of layer ``name``'s training-mode
    dropout: each entry kept with probability 1 - rate, drawn on
    ``device`` from a generator seeded by the step's seed and
    ``crc32(name + "/drop")``. The same seed gives the same mask."""
    gen = torch.Generator(device=device)
    gen.manual_seed(ctx.layer_seed(name + "/drop"))
    u = torch.rand(shape, generator=gen, device=device)
    return (u < 1.0 - rate).to(torch.float32)


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
              seed: Optional[int] = None) -> Dict[str, Argument]:
        """Forward over the whole graph. ``feed`` maps data-layer names to
        Arguments; returns every layer's output keyed by layer name.
        ``seed``: the step's seed, which training-mode dropout needs."""
        return self.apply_with_state(params, feed, train=train,
                                     carried=carried, seed=seed)[0]

    def apply_with_state(self, params: Dict[str, torch.Tensor],
                         feed: Dict[str, Argument], *, train: bool = False,
                         carried: Optional[Dict[str, Any]] = None,
                         seed: Optional[int] = None,
                         ) -> Tuple[Dict[str, Argument],
                                    Dict[str, torch.Tensor]]:
        """``apply`` that also returns the state updates (batch norm's
        moving statistics, by parameter name), detached: no gradient flows
        through them, as in JAX, where they are ``value_and_grad``'s aux."""
        ctx = Context(train=train, carried=carried or {}, seed=seed)
        for name in self.order:
            if self.model.layers[name].type == "data":
                if name not in feed:
                    raise KeyError(f"missing feed for data layer {name!r}")
                ctx.outputs[name] = feed[name]
            else:
                ctx.outputs[name] = self._run_layer(name, params, ctx)
        return ctx.outputs, {k: v.detach()
                             for k, v in ctx.state_updates.items()}

    def apply_layer(self, name: str, params: Dict[str, torch.Tensor],
                    outputs: Dict[str, Argument], *, train: bool = False,
                    ) -> Tuple[Argument, Dict[str, torch.Tensor]]:
        """One layer's output and state updates from the given outputs of
        the layers it reads: what ``apply_with_state`` computes for it."""
        ctx = Context(train=train, outputs=dict(outputs))
        out = self._run_layer(name, params, ctx)
        return out, {k: v.detach() for k, v in ctx.state_updates.items()}

    def _run_layer(self, name: str, params: Dict[str, torch.Tensor],
                   ctx: Context) -> Argument:
        from paddle_tpu_torch.layers.activations import apply_activation
        layer = self.model.layers[name]
        impl = get_layer_impl(layer.type)
        ins = [ctx.outputs[i] for i in layer.input_names()]
        lparams = {s: params[p] for s, p in self._layer_params[name].items()}
        ctx.in_infos = [self.shape_infos[i] for i in layer.input_names()]
        ctx.out_info = self.shape_infos[name]
        out = impl.apply(layer, lparams, ins, ctx)
        if layer.act and layer.act not in ("linear", ""):
            out = out.with_value(apply_activation(layer.act, out.value,
                                                  out.mask))
        if layer.drop_rate > 0.0:
            # reference (non-inverted) dropout (``Layer::forwardDropOut``):
            # training multiplies by a 0/1 keep mask, test scales by 1-rate
            if ctx.train:
                keep = _dropout_mask(out.value.shape, layer.drop_rate, ctx,
                                     name, out.value.device)
                out = out.with_value(out.value * keep.to(out.value.dtype))
            else:
                out = out.with_value(out.value * (1.0 - layer.drop_rate))
        return out

    def param_meta(self) -> Dict[str, ParamSpec]:
        """Per-parameter ``ParamSpec`` (learning_rate, l1/l2 rates,
        is_static, sparse_grad, sparsity_ratio) as the layer attrs resolved
        them: the optimizer's ``meta``."""
        return dict(self.param_specs)
