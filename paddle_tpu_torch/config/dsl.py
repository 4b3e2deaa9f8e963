"""Layer-construction DSL: the subset of ``paddle_tpu/config/dsl.py`` that
``lstm_text_classifier``, ``seq2seq_attention`` (its training graph, with
its encoder self-attention block, and its generating graph),
``bilstm_crf_tagger`` (the CRF layers and config-declared evaluators), an
``lstm_step`` decoder, a CTC acoustic model, ``resnet``, ``lenet_mnist``
(conv, image pool, batch norm, cross-map norm) and a serve config need.

Each function appends a ``LayerDef`` to the active ``ModelDef`` and returns
a ``LayerOutput`` handle usable as ``input=`` of later calls. Names,
attributes and auto-generated names (``__fc_layer_0__``,
``__recurrent_group_0__``, ``__beam_search_layer_0__``) match the JAX DSL,
so both build the same graph, with the same parameter names, from the same
calls. Nested groups (``SubsequenceInput``) raise ``NotImplementedError``:
they are a later slice.
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
    global _GRAPH, _COUNTERS, _GROUP_CTX
    _GRAPH = ModelDef()
    _COUNTERS = {}
    _SHAPES.clear()
    # a build that raised inside a recurrent_group step must not leave the
    # group context armed for the next build
    _GROUP_CTX = None


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


def _drop_rate(layer_attr: Optional[dict]) -> float:
    """A ``layer_attr``'s dropout rate (the reference's
    ``ExtraLayerAttribute(drop_rate=...)``); 0 without one."""
    return float((layer_attr or {}).get("drop_rate", 0.0))


def fc(input, size: int, *, act: str = "tanh", name: str = None,
       bias_attr=True, param_attr=None,
       layer_attr: Optional[dict] = None) -> LayerOutput:
    ins = [Input(i.name, param_attr=_param(param_attr)) for i in _in(input)]
    ldef = LayerDef(name=name or _auto_name("fc"), type="fc", inputs=ins,
                    size=size, act=act, bias=_bias(bias_attr),
                    drop_rate=_drop_rate(layer_attr))
    return _add(ldef)


def dropout(input, rate: float, *, name: str = None) -> LayerOutput:
    """The reference expresses dropout as a layer attribute; this helper
    adds an identity ``addto`` carrying ``drop_rate``."""
    src = _in(input)[0]
    ldef = LayerDef(name=name or _auto_name("dropout"), type="addto",
                    inputs=[Input(src.name)], bias=False, drop_rate=rate)
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


def grumemory(input, *, name: str = None, reverse: bool = False,
              act: str = "tanh", gate_act: str = "sigmoid",
              bias_attr=True, param_attr=None) -> LayerOutput:
    src = _in(input)[0]
    ldef = LayerDef(name=name or _auto_name("gru"), type="gated_recurrent",
                    inputs=[Input(src.name, param_attr=_param(param_attr))],
                    bias=_bias(bias_attr),
                    attrs={"reversed": reverse, "active_type": act,
                           "active_gate_type": gate_act})
    return _add(ldef)


def multi_head_attention(query, key_value=None, *, size: int = None,
                         num_heads: int = 1, causal: bool = False,
                         seq_parallel: str = None, seq_axis: str = "seq",
                         name: str = None, bias_attr=True,
                         param_attr=None) -> LayerOutput:
    """Fused multi-head attention (the flash kernels on the card);
    self-attention when key_value is omitted. ``seq_parallel`` and
    ``seq_axis`` are recorded as the JAX DSL records them; the port has no
    sequence mesh yet, so the layer runs dense (``layers/attention.py``)."""
    q = _in(query)[0]
    inputs = [Input(q.name, param_attr=_param(param_attr))]
    if key_value is not None:
        inputs.append(Input(_in(key_value)[0].name))
    if seq_parallel not in (None, "ring", "ulysses"):
        raise ValueError(f"seq_parallel must be ring/ulysses, "
                         f"got {seq_parallel!r}")
    ldef = LayerDef(name=name or _auto_name("mha"),
                    type="multi_head_attention", inputs=inputs,
                    size=size or q.size, act="linear",
                    bias=_bias(bias_attr),
                    attrs={"num_heads": num_heads, "causal": causal,
                           "seq_parallel": seq_parallel,
                           "seq_axis": seq_axis})
    return _add(ldef)


def conv(input, *, num_filters: int, filter_size: int, stride: int = 1,
         padding: int = 0, groups: int = 1, channels: int = None,
         act: str = "relu", name: str = None, bias_attr=True,
         param_attr=None, layer_type: str = "exconv") -> LayerOutput:
    """A convolution (``layer_type`` "exconvt" for the transposed one)."""
    src = _in(input)[0]
    extra = {"filter_size": filter_size, "stride": stride,
             "padding": padding, "groups": groups}
    if channels:
        extra["channels"] = channels
    ldef = LayerDef(name=name or _auto_name("conv"), type=layer_type,
                    inputs=[Input(src.name, param_attr=_param(param_attr),
                                  extra=extra)],
                    act=act, bias=_bias(bias_attr),
                    attrs={"num_filters": num_filters})
    return _add(ldef)


def img_pool(input, *, pool_size: Optional[int] = None, stride: int = 1,
             padding: int = 0, pool_type: str = "max-projection",
             name: str = None) -> LayerOutput:
    """pool_size=None pools over the full spatial extent (global pooling)."""
    src = _in(input)[0]
    if pool_size is None:
        info = _SHAPES[src.name]
        extra = {"filter_size": info.width, "size_y": info.height,
                 "stride": info.width, "stride_y": info.height,
                 "padding": 0, "pool_type": pool_type}
    else:
        extra = {"filter_size": pool_size, "stride": stride,
                 "padding": padding, "pool_type": pool_type}
    ldef = LayerDef(name=name or _auto_name("pool"), type="pool", bias=False,
                    inputs=[Input(src.name, extra=extra)])
    return _add(ldef)


def batch_norm(input, *, act: str = "linear", name: str = None,
               use_global_stats: bool = None,
               moving_average_fraction: float = 0.9,
               epsilon: float = 1e-5, bias_attr=True) -> LayerOutput:
    src = _in(input)[0]
    attrs = {"use_global_stats": use_global_stats,
             "moving_average_fraction": moving_average_fraction,
             "epsilon": epsilon}
    ldef = LayerDef(name=name or _auto_name("batch_norm"), type="batch_norm",
                    inputs=[Input(src.name)], act=act, bias=_bias(bias_attr),
                    attrs=attrs)
    return _add(ldef)


def img_cmrnorm(input, *, size: int = 5, scale: float = 1e-4,
                power: float = 0.75, name: str = None) -> LayerOutput:
    src = _in(input)[0]
    ldef = LayerDef(name=name or _auto_name("norm"), type="norm", bias=False,
                    inputs=[Input(src.name, extra={"size": size,
                                                   "scale": scale,
                                                   "pow": power})])
    return _add(ldef)


def addto(inputs, *, act: str = "linear", name: str = None,
          bias_attr=False) -> LayerOutput:
    ldef = LayerDef(name=name or _auto_name("addto"), type="addto",
                    inputs=[Input(i.name) for i in _in(inputs)], act=act,
                    bias=_bias(bias_attr))
    return _add(ldef)


def concat(inputs, *, name: str = None, act: str = "linear") -> LayerOutput:
    ldef = LayerDef(name=name or _auto_name("concat"), type="concat",
                    inputs=[Input(i.name) for i in _in(inputs)], act=act,
                    bias=False)
    return _add(ldef)


_POOL_TYPES = {"max": "max", "avg": "average", "average": "average",
               "sum": "average", "sqrt": "average", "last": "seqlastins",
               "first": "seqlastins"}


def pooling(input, *, pooling_type: str = "max",
            name: str = None) -> LayerOutput:
    """Sequence pooling (``pooling_layer`` in the reference DSL)."""
    src = _in(input)[0]
    attrs = {}
    if pooling_type == "sum":
        attrs["average_strategy"] = "sum"
    if pooling_type == "sqrt":
        attrs["average_strategy"] = "squarerootn"
    if pooling_type == "first":
        attrs["select_first"] = True
    ldef = LayerDef(name=name or _auto_name(f"seq_{pooling_type}"),
                    type=_POOL_TYPES[pooling_type], inputs=[Input(src.name)],
                    bias=False, attrs=attrs)
    return _add(ldef)


def last_seq(input, **kw):
    return pooling(input, pooling_type="last", **kw)


def first_seq(input, **kw):
    return pooling(input, pooling_type="first", **kw)


def expand(input, expand_as, *, name: str = None) -> LayerOutput:
    ldef = LayerDef(name=name or _auto_name("expand"), type="expand",
                    inputs=[Input(_in(input)[0].name),
                            Input(_in(expand_as)[0].name)], bias=False)
    return _add(ldef)


def scaling_layer(input, weight, *, name=None):
    """Row-wise scale: out[i] = weight[i] * input[i] (weight is [B, 1] or
    per-timestep [B, T, 1]); the attention-weighting primitive."""
    ldef = LayerDef(name=name or _auto_name("scaling"), type="scaling",
                    inputs=[Input(_in(weight)[0].name),
                            Input(_in(input)[0].name)], bias=False)
    return _add(ldef)


def gru_step_layer(input, output_mem, *, size: int = None, act: str = "tanh",
                   gate_act: str = "sigmoid", name=None, bias_attr=True,
                   param_attr=None):
    ldef = LayerDef(name=name or _auto_name("gru_step"), type="gru_step",
                    inputs=[Input(_in(input)[0].name,
                                  param_attr=_param(param_attr)),
                            Input(_in(output_mem)[0].name)],
                    bias=_bias(bias_attr),
                    attrs={"active_type": act,
                           "active_gate_type": gate_act})
    return _add(ldef)


def lstm_step_layer(input, state_mem, *, size: int = None, act: str = "tanh",
                    gate_act: str = "sigmoid", state_act: str = "tanh",
                    name=None, bias_attr=True):
    """One LSTM step inside a recurrent group: ``input`` the gate
    projection [4*size], ``state_mem`` the previous cell state; with a bias,
    the three peephole vectors. The new cell state is read with
    ``get_output_layer(..., arg_name="state")``."""
    ldef = LayerDef(name=name or _auto_name("lstm_step"), type="lstm_step",
                    inputs=[Input(_in(input)[0].name),
                            Input(_in(state_mem)[0].name)],
                    bias=_bias(bias_attr),
                    attrs={"active_type": act, "active_gate_type": gate_act,
                           "active_state_type": state_act})
    return _add(ldef)


def get_output_layer(input, *, arg_name: str = "state", size: int = None,
                     name=None):
    """A named auxiliary output of ``input`` (an lstm_step's ``state``)."""
    ldef = LayerDef(name=name or _auto_name("get_output"), type="get_output",
                    inputs=[Input(_in(input)[0].name)], size=size,
                    act="linear", bias=False, attrs={"arg_name": arg_name})
    return _add(ldef)


def classification_cost(input, label, *, name: str = None) -> LayerOutput:
    """Cross-entropy on post-softmax input (``layers/cost.py``)."""
    ldef = LayerDef(name=name or _auto_name("cost"),
                    type="multi-class-cross-entropy",
                    inputs=[Input(_in(input)[0].name),
                            Input(_in(label)[0].name)], bias=False)
    return _add(ldef)


def crf_layer(input, label, *, size: int = None, weight=None,
              param_attr=None, name: str = None) -> LayerOutput:
    """Linear-chain CRF cost (``layers/chain.py``); a ``param_attr`` name
    shares the (C+2, C) transition parameter with a ``crf_decoding_layer``."""
    ins = [Input(_in(input)[0].name, param_attr=_param(param_attr)),
           Input(_in(label)[0].name)]
    if weight is not None:
        ins.append(Input(_in(weight)[0].name))
    ldef = LayerDef(name=name or _auto_name("crf"), type="crf",
                    inputs=ins, bias=False)
    return _add(ldef)


def crf_decoding_layer(input, *, size: int = None, label=None,
                       param_attr=None, name: str = None) -> LayerOutput:
    """Viterbi decode; with ``label``, the per-sequence error indicator."""
    ins = [Input(_in(input)[0].name, param_attr=_param(param_attr))]
    if label is not None:
        ins.append(Input(_in(label)[0].name))
    ldef = LayerDef(name=name or _auto_name("crf_decoding"),
                    type="crf_decoding", inputs=ins, bias=False)
    return _add(ldef)


def ctc_layer(input, label, *, size: int = None, norm_by_times: bool = False,
              blank: int = None, name: str = None) -> LayerOutput:
    """CTC cost (``layers/chain.py``). No ``blank`` recorded means the
    layer takes the last class, C - 1. ``size`` is accepted and ignored,
    as in the JAX DSL."""
    attrs = {"norm_by_times": norm_by_times}
    if blank is not None:
        attrs["blank"] = blank
    ldef = LayerDef(name=name or _auto_name("ctc"), type="ctc",
                    inputs=[Input(_in(input)[0].name),
                            Input(_in(label)[0].name)],
                    bias=False, attrs=attrs)
    return _add(ldef)


def warp_ctc_layer(input, label, *, size: int = None,
                   norm_by_times: bool = False, blank: int = 0,
                   name: str = None) -> LayerOutput:
    """The same CTC cost under ``WarpCTCLayer``'s name and blank default,
    class 0."""
    ldef = LayerDef(name=name or _auto_name("warp_ctc"), type="warp_ctc",
                    inputs=[Input(_in(input)[0].name),
                            Input(_in(label)[0].name)],
                    bias=False,
                    attrs={"norm_by_times": norm_by_times, "blank": blank})
    return _add(ldef)


def evaluator(type: str, input, *, label=None, weight=None, name: str = None,
              **kwargs):
    """Attach a metric evaluator to the graph (the native spelling of the
    reference's evaluator config funcs, `trainer_config_helpers/
    evaluators.py`); the trainer wires it to the metric registry
    (``trainer/metrics.py``) each pass."""
    ins = [input] if isinstance(input, LayerOutput) else list(input)
    names = [i.name for i in ins]
    n_outputs = len(names)
    for extra in (label, weight):
        if extra is not None:
            names.append(extra.name)
    cfg = {"type": type,
           "name": name or _auto_name(f"{type}_evaluator").replace(
               "_layer_", "_"),
           "input_layers": names,
           "_roles": {"n_outputs": n_outputs,
                      "has_label": label is not None,
                      "has_weight": weight is not None}}
    cfg.update({k: v for k, v in kwargs.items() if v is not None})
    current_graph().evaluators.append(cfg)
    return cfg


# ------------------------------------------------------ recurrent groups
@dataclasses.dataclass
class StaticInput:
    """Non-time-varying input to a recurrent_group (read whole each
    timestep, not sliced)."""

    input: LayerOutput


class SubsequenceInput:
    """Two-level (nested) sequence input to a recurrent_group: not ported
    yet."""

    def __init__(self, input):
        raise NotImplementedError(
            "SubsequenceInput (nested recurrent groups) is not ported yet: "
            "two-level sequences come with a later slice of the port")


@dataclasses.dataclass
class GeneratedInput:
    """Generation-mode input of a beam search: at each step the previous
    step's generated word id is embedded (with the shared embedding
    parameter ``embedding_name``) and fed."""

    size: int                      # vocabulary size
    embedding_name: str            # shared embedding parameter name
    embedding_size: int
    bos_id: int = 0
    eos_id: int = 1


_GROUP_CTX: Optional[Dict[str, Any]] = None


def memory(*, name: str, size: int, boot_layer: Optional[LayerOutput] = None,
           boot_with_const_value: float = 0.0) -> LayerOutput:
    """Declare a recurrent memory inside a recurrent_group step function:
    the previous timestep's output of the layer called ``name`` (zero,
    constant or boot-layer initialised)."""
    if _GROUP_CTX is None:
        raise RuntimeError(
            "memory() must be called inside a recurrent_group step function")
    bname = f"{_GROUP_CTX['name']}@mem_{name}"
    out = _add(LayerDef(name=bname, type="data", size=size, bias=False))
    _GROUP_CTX["memories"].append(
        {"boundary": bname, "link": name, "boot_layer": boot_layer,
         "init": boot_with_const_value, "agent_name": None})
    return out


def recurrent_group(step, input, *, reverse: bool = False,
                    name: str = None, target_inlink=None):
    """Unroll a user step network over the timesteps of the sequence
    inputs (``layers/group.py``). ``input`` items: sequence LayerOutputs
    (one frame per step) and StaticInput (whole every step). The step
    function may call memory() and returns one LayerOutput or a tuple
    (first = main out_link)."""
    global _GRAPH, _GROUP_CTX
    inputs = [input] if isinstance(input, (LayerOutput, StaticInput)) \
        else list(input)
    # the reference's auto-name convention: __recurrent_group_0__
    c = _COUNTERS.setdefault("recurrent_group", itertools.count())
    gname = name or f"__recurrent_group_{next(c)}__"
    outer = _GRAPH
    sub = ModelDef()
    ins_meta: List[Dict[str, Any]] = []
    outer_in_names: List[str] = []
    proxies: List[LayerOutput] = []
    prev_ctx = _GROUP_CTX
    _GRAPH = sub
    _GROUP_CTX = {"name": gname, "memories": []}
    try:
        for i, x in enumerate(inputs):
            if isinstance(x, StaticInput):
                src, bname, kind = x.input, f"{gname}@static{i}", "static"
            else:
                src, bname = x, f"{gname}@seq{i}"
                # a source the graph knows is a sequence steps per
                # timestep; otherwise the fed data decides ("auto")
                info = _SHAPES.get(src.name)
                kind = "seq" if info is not None and info.is_sequence \
                    else "auto"
            # the boundary is a plain data layer: the step sees one frame
            proxies.append(_add(LayerDef(name=bname, type="data",
                                         size=src.size, bias=False)))
            ins_meta.append({"boundary": bname, "kind": kind})
            outer_in_names.append(src.name)
        traced = step(*proxies)
        memories = _GROUP_CTX["memories"]
    finally:
        _GRAPH = outer
        _GROUP_CTX = prev_ctx

    out_handles = list(traced) if isinstance(traced, (tuple, list)) \
        else [traced]
    for mem in memories:
        if mem["link"] not in sub.layers:
            raise ValueError(
                f"memory(name={mem['link']!r}) has no matching layer "
                f"inside recurrent_group {gname!r}")
        bl = mem.pop("boot_layer")
        if bl is not None:
            ins_meta.append({"boundary": mem["boundary"], "kind": "boot"})
            outer_in_names.append(bl.name)
    target_idx = 0
    if target_inlink is not None:
        for i, x in enumerate(inputs):
            src_in = getattr(x, "input", x)
            if getattr(src_in, "name", None) == target_inlink.name:
                target_idx = i
                break
    ldef = LayerDef(
        name=gname, type="recurrent_layer_group",
        inputs=[Input(n) for n in outer_in_names], bias=False,
        attrs={"sub_model": sub, "ins": ins_meta, "memories": memories,
               "outputs": [h.name for h in out_handles],
               "reverse": reverse,
               "target_boundary": ins_meta[target_idx]["boundary"]})
    main = _add(ldef)
    if len(out_handles) == 1:
        return main
    extras = []
    for h in out_handles[1:]:
        odef = LayerDef(name=f"{gname}@out_{h.name}", type="group_output",
                        inputs=[Input(main.name)], size=h.size, bias=False,
                        attrs={"sub_name": h.name})
        extras.append(_add(odef))
    return (main, *extras)


def beam_search(step, input, *, bos_id: int = None, eos_id: int = None,
                beam_size: int = 5, max_length: int = 100,
                candidate_adjust=None, drop_callback=None,
                norm_or_drop=None, stop_beam_search=None,
                decode_chunk: int = None, full_scan: bool = False,
                name: str = None) -> LayerOutput:
    """Generation-mode recurrent group (``beam_search`` in the reference
    DSL). The step function receives the embedding of the previously
    generated word for the GeneratedInput slot (and the StaticInputs) and
    returns post-softmax probabilities over the vocabulary. Run it with
    ``paddle_tpu_torch.core.generation.SequenceGenerator``.

    The four beam-control hooks (``candidate_adjust``, ``drop_callback``,
    ``norm_or_drop``, ``stop_beam_search``; signatures in
    ``SequenceGenerator.generate``) pinned here are the defaults of every
    ``generate`` call on this config, the serving endpoint's included; use
    module-level functions if the model will be merged (``--job merge``
    pickles the graph). ``decode_chunk`` / ``full_scan`` pin the decode
    policy: chunks of ``decode_chunk`` steps with an exit check between
    them, or one length-``max_length`` loop."""
    global _GRAPH, _GROUP_CTX
    inputs = list(input) if isinstance(input, (list, tuple)) else [input]
    gname = name or _auto_name("beam_search")
    outer = _GRAPH
    sub = ModelDef()
    ins_meta: List[Dict[str, Any]] = []
    outer_in_names: List[str] = []
    proxies: List[LayerOutput] = []
    gen_spec = None
    prev_ctx = _GROUP_CTX
    _GRAPH = sub
    _GROUP_CTX = {"name": gname, "memories": []}
    try:
        for i, x in enumerate(inputs):
            if isinstance(x, GeneratedInput):
                if gen_spec is not None:
                    raise ValueError("only one GeneratedInput allowed")
                bname = f"{gname}@gen{i}"
                proxies.append(_add(LayerDef(
                    name=bname, type="data", size=x.embedding_size,
                    bias=False)))
                gen_spec = {"boundary": bname, "size": x.size,
                            "embedding_name": x.embedding_name,
                            "embedding_size": x.embedding_size,
                            "bos_id": x.bos_id if bos_id is None else bos_id,
                            "eos_id": x.eos_id if eos_id is None else eos_id}
            elif isinstance(x, StaticInput):
                bname = f"{gname}@static{i}"
                proxies.append(_add(LayerDef(
                    name=bname, type="data", size=x.input.size, bias=False)))
                ins_meta.append({"boundary": bname, "kind": "static"})
                outer_in_names.append(x.input.name)
            else:
                raise TypeError(
                    "beam_search inputs must be GeneratedInput/StaticInput")
        traced = step(*proxies)
        memories = _GROUP_CTX["memories"]
    finally:
        _GRAPH = outer
        _GROUP_CTX = prev_ctx
    if gen_spec is None:
        raise ValueError("beam_search needs a GeneratedInput")
    out_handles = list(traced) if isinstance(traced, (tuple, list)) \
        else [traced]
    for mem in memories:
        if mem["link"] not in sub.layers:
            raise ValueError(
                f"memory(name={mem['link']!r}) has no matching layer "
                f"inside beam_search group {gname!r}")
        bl = mem.pop("boot_layer")
        if bl is not None:
            ins_meta.append({"boundary": mem["boundary"], "kind": "boot"})
            outer_in_names.append(bl.name)
    ldef = LayerDef(
        name=gname, type="beam_search_group",
        inputs=[Input(n) for n in outer_in_names], bias=False,
        attrs={"sub_model": sub, "ins": ins_meta, "memories": memories,
               "outputs": [h.name for h in out_handles], "gen": gen_spec,
               "beam_size": beam_size, "max_length": max_length,
               "candidate_adjust": candidate_adjust,
               "drop_callback": drop_callback,
               "norm_or_drop": norm_or_drop,
               "stop_beam_search": stop_beam_search,
               "decode_chunk": decode_chunk, "full_scan": full_scan})
    return _add(ldef)
