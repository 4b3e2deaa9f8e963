"""Recurrent layer group: a user-defined step network unrolled over time.

The port's counterpart of ``paddle_tpu/layers/group.py``
(``RecurrentGradientMachine`` in the reference). The step sub-network is
built once, as a ``Network`` over the group's sub-model, and driven by a
Python loop over the timesteps where JAX traces it once under
``lax.scan``: PyTorch runs eagerly, and autograd records every step.
Memories (``memory()`` in the DSL) are the loop's carries; padded steps
hold them (the mask guard) and the step outputs are zeroed there, so
ragged batches keep the reference semantics in the padded layout.

Sub-network parameters are hoisted into the global parameter table under
their sub-layer names (``ParamSpec.absolute_name``): one set of weights
shared by every timestep, named exactly as in the JAX package
(``_dec_in.w0``, ``_gru_decoder.w0``, ...).

In-link kinds: ``seq`` (one frame per step), ``static`` (the whole
Argument every step), ``boot`` (a memory's initial value) and ``auto``
(resolved to ``seq`` or ``static`` from the fed Argument). Nested
(``subseq``) in-links raise ``NotImplementedError``: two-level sequences
are a later slice of the port.

A memory may link to any layer of the step, a ``get_output`` layer
included (an ``lstm_step``'s cell state): the step network's outputs
cover every memory's link layer. The generating group
(``beam_search_group``) is a config-time node that hoists its step
network's parameters; ``core/generation.py:SequenceGenerator`` runs it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from paddle_tpu_torch.core.argument import Argument
from paddle_tpu_torch.core.network import Network
from paddle_tpu_torch.core.registry import LayerImpl, ShapeInfo, register_layer

# group LayerDef (held, so its id stays unique) -> its step Network
_SUBNETS: Dict[int, Tuple[Any, Network]] = {}

_NESTED = ("nested (SubsequenceInput) recurrent groups are not ported yet: "
           "two-level sequences come with a later slice of the port")


def _group_subnet(cfg) -> Network:
    """Build (once) the step sub-network covering the group outputs and
    every memory link layer."""
    entry = _SUBNETS.get(id(cfg))
    if entry is None or entry[0] is not cfg:
        targets = list(cfg.attrs["outputs"])
        for mem in cfg.attrs["memories"]:
            if mem["link"] not in targets:
                targets.append(mem["link"])
        entry = (cfg, Network(cfg.attrs["sub_model"], outputs=targets))
        _SUBNETS[id(cfg)] = entry
    return entry[1]


def _resolve_kind(cfg, a: Argument, kind: str) -> str:
    if kind == "auto":
        # wire-imported groups cannot recover the link kind: a maskless
        # [B, T, D] walks as a full-length sequence, other maskless values
        # broadcast, masked flat values are sequences
        if a.mask is not None and a.mask.dim() == 3:
            kind = "subseq"
        elif a.mask is None:
            kind = "seq" if a.value.dim() >= 3 else "static"
        else:
            kind = "seq"
    if kind == "subseq":
        raise NotImplementedError(f"recurrent group {cfg.name!r}: {_NESTED}")
    return kind


@register_layer("recurrent_layer_group")
class RecurrentLayerGroup(LayerImpl):
    """Training and evaluation path of the recurrent group."""

    def infer(self, cfg, in_infos):
        if any(m["kind"] == "subseq" for m in cfg.attrs["ins"]):
            raise NotImplementedError(f"recurrent group {cfg.name!r}: "
                                      f"{_NESTED}")
        net = _group_subnet(cfg)
        info = net.shape_infos[cfg.attrs["outputs"][0]]
        return dataclasses.replace(info, is_sequence=True)

    def params(self, cfg, in_infos):
        net = _group_subnet(cfg)
        return {f"sub:{p}": dataclasses.replace(spec, absolute_name=p)
                for p, spec in net.param_specs.items()}

    def apply(self, cfg, params, ins, ctx):
        net = _group_subnet(cfg)
        sub_params = {k[len("sub:"):]: v for k, v in params.items()}
        memories: List[Dict[str, Any]] = cfg.attrs["memories"]
        reverse = bool(cfg.attrs.get("reverse", False))

        xs: Dict[str, torch.Tensor] = {}     # per seq in-link: [T, B, ...]
        static_feed: Dict[str, Argument] = {}
        boot: Dict[str, torch.Tensor] = {}
        mask = None
        for a, m in zip(ins, cfg.attrs["ins"]):
            kind = _resolve_kind(cfg, a, m["kind"])
            if kind == "seq":
                xs[m["boundary"]] = a.value.transpose(0, 1)
                if mask is None and a.mask is not None:
                    mask = a.mask
            elif kind == "static":
                static_feed[m["boundary"]] = a
            elif kind == "boot":
                boot[m["boundary"]] = a.value
        if not xs:
            raise ValueError(
                f"recurrent group {cfg.name!r} has no sequence input; a "
                "generating group is a beam_search")
        lead = next(iter(xs.values()))
        T, B = lead.shape[0], lead.shape[1]
        if mask is None:
            mask = lead.new_ones((B, T), dtype=torch.float32)
        mask_tb = mask.transpose(0, 1)

        # cross-batch carry (prev_batch_state): resume every memory from
        # the previous batch's final carry instead of boot/zeros
        carried = None if reverse else ctx.carried.get(cfg.name)
        carry: Dict[str, torch.Tensor] = {}
        for mem in memories:
            bname = mem["boundary"]
            if carried is not None and bname in carried:
                carry[bname] = carried[bname]
            elif bname in boot:
                carry[bname] = boot[bname]
            else:
                size = net.shape_infos[bname].size
                carry[bname] = lead.new_full((B, size), mem.get("init", 0.0),
                                             dtype=torch.float32)

        out_names = cfg.attrs["outputs"]
        ys: Dict[str, List[torch.Tensor]] = {o: [None] * T for o in out_names}
        steps = range(T - 1, -1, -1) if reverse else range(T)
        for t in steps:
            feed = dict(static_feed)
            for k, v in xs.items():
                feed[k] = Argument(value=v[t])
            for mem in memories:
                feed[mem["boundary"]] = Argument(value=carry[mem["boundary"]])
            outs = net.apply(sub_params, feed, train=ctx.train)
            m_t = mask_tb[t]

            def _shaped(y, m_t=m_t):
                return m_t.reshape(m_t.shape + (1,) * (y.dim() - 1))

            carry = {
                mem["boundary"]: torch.where(
                    _shaped(outs[mem["link"]].value) > 0,
                    outs[mem["link"]].value, carry[mem["boundary"]])
                for mem in memories}
            for o in out_names:
                y = outs[o].value
                ys[o][t] = y * _shaped(y).to(y.dtype)

        stacked = {o: torch.stack(v, dim=1) for o, v in ys.items()}
        extras = {o: stacked[o] for o in out_names[1:]}
        return Argument(value=stacked[out_names[0]], mask=mask,
                        state={"group_outputs": extras, "final": carry})


@register_layer("group_output")
class GroupOutput(LayerImpl):
    """Exposes a non-main output of a recurrent group (the reference allows
    multiple out_links on a recurrent_group)."""

    def infer(self, cfg, in_infos):
        return ShapeInfo(size=cfg.size, is_sequence=True)

    def apply(self, cfg, params, ins, ctx):
        a = ins[0]
        return Argument(value=a.state["group_outputs"][cfg.attrs["sub_name"]],
                        mask=a.mask)


@register_layer("beam_search_group")
class BeamSearchGroup(LayerImpl):
    """Config-time node of a generating recurrent group (``beam_search``
    in the DSL). The forward pass cannot run it: drive it with
    ``paddle_tpu_torch.core.generation.SequenceGenerator``."""

    def infer(self, cfg, in_infos):
        _group_subnet(cfg)  # validate the step net early
        return ShapeInfo(size=1, is_sequence=True)

    def params(self, cfg, in_infos):
        net = _group_subnet(cfg)
        return {f"sub:{p}": dataclasses.replace(spec, absolute_name=p)
                for p, spec in net.param_specs.items()}

    def apply(self, cfg, params, ins, ctx):
        raise RuntimeError(
            f"beam_search group {cfg.name!r} cannot run in a training "
            "forward pass; use SequenceGenerator.generate")
