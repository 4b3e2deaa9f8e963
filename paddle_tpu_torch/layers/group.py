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

In-link kinds: ``seq`` (one frame per step), ``subseq`` (a nested
``[B, S, T_sub, D]`` input with a ``[B, S, T_sub]`` mask: the loop walks S
and each step feeds one whole sub-sequence as a sequence Argument, so the
step network may run an inner group over its words), ``static`` (the
whole Argument every step), ``boot`` (a memory's initial value) and
``auto`` (resolved from the fed Argument: a 3-D mask is ``subseq``). In a
nested group the target in-link's live sub-sequences are the outer mask;
flat sequence in-links are aligned to S where the extra or missing steps
are dead (a host check raises otherwise). A step output that is itself a
sequence (the reference's nested out-link) is flattened to
``[B, S * T_q, D]``, its two-level view kept in ``state["nested"]``.

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

import torch.nn.functional as F

from paddle_tpu_torch.core.argument import Argument, check_dead
from paddle_tpu_torch.core.network import Network, fold_seed
from paddle_tpu_torch.core.registry import LayerImpl, ShapeInfo, register_layer

# group LayerDef (held, so its id stays unique) -> its step Network
_SUBNETS: Dict[int, Tuple[Any, Network]] = {}

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


# the step layers whose second input is their recurrent state
_CELLS = ("gru_step", "lstm_step")


def _widened_cells(net: Network, params, carry):
    """``params`` with the bf16 weights of each cell whose state is an f32
    memory widened to f32, once a forward of the group (under
    ``--compute_dtype bfloat16``: JAX's promoted step is exactly the f32
    function of the widened weights, and the cells' card kernels take f32;
    the widened tensors carry the gradient back to the bf16 ones). A cell
    whose state is not a memory of this group is left to widen per call."""
    out = dict(params)
    for name in net.order:
        layer = net.model.layers[name]
        state = layer.input_names()[1] if layer.type in _CELLS else None
        if state not in carry or carry[state].dtype != torch.float32:
            continue
        for pname in net._layer_params[name].values():
            if out[pname].dtype == torch.bfloat16:
                out[pname] = out[pname].float()
    return out


def _resolve_kind(a: Argument, kind: str) -> str:
    if kind == "auto":
        # wire-imported groups cannot recover the link kind: a 3-D mask is
        # nested, a maskless [B, T, D] walks as a full-length sequence,
        # other maskless values broadcast, masked flat values are sequences
        if a.mask is not None and a.mask.dim() == 3:
            return "subseq"
        if a.mask is None:
            return "seq" if a.value.dim() >= 3 else "static"
        return "seq"
    return kind


def _fit(cfg, k, v, S, flat_mask, outer_live):
    """Flat in-link ``k`` ([T, B, ...]) aligned to S outer steps: a longer
    one trimmed where its tail is dead, a shorter one zero-padded where
    the outer steps past it are dead (JAX ``_fit``)."""
    if v.shape[0] > S:
        if flat_mask is None:
            raise ValueError(
                f"recurrent group {cfg.name!r}: maskless flat in-link "
                f"{k!r} (len {v.shape[0]}) cannot align to {S} "
                "sub-sequences")
        check_dead(flat_mask[:, S:].sum(),
                   f"recurrent group {cfg.name!r}: flat in-link {k!r} "
                   f"(len {v.shape[0]}) vs {S} sub-sequences")
        return v[:S]
    if v.shape[0] < S:
        if outer_live is None:
            raise ValueError(
                f"recurrent group {cfg.name!r}: flat in-link {k!r} (len "
                f"{v.shape[0]}) shorter than the {S} sub-sequences with "
                "no outer mask to prove the tail dead")
        check_dead(outer_live[:, v.shape[0]:].sum(),
                   f"recurrent group {cfg.name!r}: flat in-link {k!r} "
                   f"(len {v.shape[0]}) shorter than the {S} live "
                   "sub-sequences")
        pad = [0, 0] * (v.dim() - 1) + [0, S - v.shape[0]]
        return F.pad(v, pad)
    return v


@register_layer("recurrent_layer_group")
class RecurrentLayerGroup(LayerImpl):
    """Training and evaluation path of the recurrent group."""

    def infer(self, cfg, in_infos):
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
        ins_meta: List[Dict[str, Any]] = cfg.attrs["ins"]
        memories: List[Dict[str, Any]] = cfg.attrs["memories"]
        reverse = bool(cfg.attrs.get("reverse", False))
        target = cfg.attrs.get("target_boundary", ins_meta[0]["boundary"])

        xs: Dict[str, torch.Tensor] = {}     # per seq in-link: [T, B, ...]
        flat_masks: Dict[str, torch.Tensor] = {}
        sub_xs: Dict[str, torch.Tensor] = {}    # nested: [S, B, T_sub, ...]
        sub_masks: Dict[str, torch.Tensor] = {}  # [S, B, T_sub]
        static_feed: Dict[str, Argument] = {}
        boot: Dict[str, torch.Tensor] = {}
        mask = None
        for a, m in zip(ins, ins_meta):
            kind = _resolve_kind(a, m["kind"])
            bname = m["boundary"]
            if kind == "seq":
                xs[bname] = a.value.transpose(0, 1)
                if a.mask is not None:
                    flat_masks[bname] = a.mask
                    if mask is None:
                        mask = a.mask
            elif kind == "subseq":
                if a.value.dim() < 3 or a.mask is None or a.mask.dim() != 3:
                    raise ValueError(
                        f"nested group {cfg.name!r} needs a [B, S, T, D] "
                        "value with a [B, S, T] mask (2-level padded "
                        "layout)")
                sub_xs[bname] = a.value.transpose(0, 1)
                sub_masks[bname] = a.mask.transpose(0, 1)
                if mask is None or bname == target:
                    # an outer step is live if its sub-sequence has tokens;
                    # the target in-link's wins
                    mask = (a.mask.sum(dim=-1) > 0).to(torch.float32)
            elif kind == "static":
                static_feed[bname] = a
            elif kind == "boot":
                boot[bname] = a.value
        if not xs and not sub_xs:
            raise ValueError(
                f"recurrent group {cfg.name!r} has no sequence input; a "
                "generating group is a beam_search")
        if sub_xs and xs:
            # mixed levels: the loop walks sub-sequences, so every flat
            # in-link aligns to their count
            S = next(iter(sub_xs.values())).shape[0]
            outer_live = (mask if mask is not None and mask.shape[1] == S
                          else None)
            xs = {k: _fit(cfg, k, v, S, flat_masks.get(k), outer_live)
                  for k, v in xs.items()}
            if mask is not None and mask.shape[1] != S:
                mask = (mask[:, :S] if mask.shape[1] > S
                        else F.pad(mask, (0, S - mask.shape[1])))
        lead = next(iter(sub_xs.values())) if sub_xs \
            else next(iter(xs.values()))
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

        sub_params = _widened_cells(net, sub_params, carry)
        out_names = cfg.attrs["outputs"]
        # each step's seed (dropout inside the step net): the group's
        # stream with the step folded in (JAX splits it T ways)
        group_seed = (None if ctx.seed is None
                      else ctx.layer_seed(cfg.name + "/group"))
        ys: Dict[str, List[torch.Tensor]] = {o: [None] * T for o in out_names}
        steps = range(T - 1, -1, -1) if reverse else range(T)
        for t in steps:
            feed = dict(static_feed)
            for k, v in xs.items():
                feed[k] = Argument(value=v[t])
            for k, v in sub_xs.items():
                feed[k] = Argument(value=v[t], mask=sub_masks[k][t])
            for mem in memories:
                feed[mem["boundary"]] = Argument(value=carry[mem["boundary"]])
            outs = net.apply(sub_params, feed, train=ctx.train,
                             seed=None if group_seed is None
                             else fold_seed(group_seed, t))
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
        main = out_names[0]
        y_main = stacked[main]
        extras = {o: stacked[o] for o in out_names[1:]}
        # the output follows the target sub-link's sub-length
        sm_ref = (sub_masks.get(target, next(iter(sub_masks.values())))
                  if sub_masks else None)
        sub_t = sm_ref.shape[2] if sm_ref is not None else None
        if sub_xs and (net.shape_infos[main].is_sequence
                       or (y_main.dim() >= 4 and y_main.shape[2] == sub_t)):
            # the step returned a whole sequence per sub-sequence (the
            # reference's nested out-link): one flat sequence of the
            # sub-sequences, the two-level view kept for TO_SEQUENCE
            # layers and group_output
            Bq, Sq, Tq = y_main.shape[0], y_main.shape[1], y_main.shape[2]
            sm = sm_ref.transpose(0, 1)
            extras = {
                o: (v.reshape(Bq, Sq * Tq, *v.shape[3:])
                    if v.dim() >= 3 and v.shape[1] == Sq
                    and v.shape[2] == Tq else v)
                for o, v in extras.items()}
            return Argument(
                value=y_main.reshape(Bq, Sq * Tq, *y_main.shape[3:]),
                mask=sm.reshape(Bq, Sq * Tq),
                state={"group_outputs": extras, "final": carry,
                       "nested": Argument(value=y_main, mask=sm),
                       "nested_tq": Tq})
        return Argument(value=y_main, mask=mask,
                        state={"group_outputs": extras, "final": carry})


@register_layer("group_output")
class GroupOutput(LayerImpl):
    """Exposes a non-main output of a recurrent group (the reference allows
    multiple out_links on a recurrent_group)."""

    def infer(self, cfg, in_infos):
        return ShapeInfo(size=cfg.size, is_sequence=True)

    def apply(self, cfg, params, ins, ctx):
        a = ins[0]
        v = a.state["group_outputs"][cfg.attrs["sub_name"]]
        state = None
        mask = a.mask
        tq = a.state.get("nested_tq")
        if tq and mask is not None and v.dim() == 3 \
                and v.shape[1] == mask.shape[1] and v.shape[1] % tq == 0:
            # flattened like the main output: re-attach the 2-level view
            B, ST = v.shape[0], v.shape[1]
            state = {"nested": Argument(
                        value=v.reshape(B, ST // tq, tq, v.shape[-1]),
                        mask=mask.reshape(B, ST // tq, tq)),
                     "nested_tq": tq}
        elif tq and mask is not None and v.dim() >= 2 \
                and v.shape[1] * tq == mask.shape[1]:
            # a per-sub-sequence extra ([B, S, ...]): its mask marks the
            # sub-sequences that have tokens
            sm = (a.state["nested"].mask if "nested" in a.state
                  else mask.reshape(v.shape[0], v.shape[1], tq))
            mask = (sm.sum(dim=-1) > 0).to(torch.float32)
        return Argument(value=v, mask=mask, state=state)


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
