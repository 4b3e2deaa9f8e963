"""Parameters and optimizer state carried across from the JAX package.

The port keeps the JAX package's parameter names and layouts (``fc``
weights [in, out], ``lstmemory`` w0 [H, 4H] and wbias [7H],
``gated_recurrent`` / ``gru_step`` w0 [H, 3H] and wbias [3H], embedding
tables [vocab, dim], a recurrent group's sub-layer parameters under their
own names such as ``_dec_in.w1``, a CRF's packed (C+2, C) start / end /
transition matrix under its shared ``ParamAttr`` name such as
``crf_transitions``, a ``multi_head_attention`` layer's projections
``wq`` [q_in, S], ``wk`` and ``wv`` [kv_in, S], ``wo`` [S, S] and
``wbias`` [S], such as ``_enc_self_att.wq``; heads are column blocks of S;
an ``lstm_step``'s ``wbias`` [3H], its three peephole vectors; an
``nce`` layer's ``w0`` [C, D] and ``wbias`` [C], an ``hsigmoid``'s ``w0``
[C - 1, D] and ``wbias`` [C - 1]; a ``moe`` layer's ``wg`` [d, E], ``w1``
[E, d, h], ``b1`` [E, h], ``w2`` [E, h, d] and ``b2`` [E, d]; a nested
recurrent group's sub-layer parameters, the inner group's included, under
their absolute names such as ``_h.w0``) and its
optimizer-state tree, so a JAX parameter dict or optimizer state, as numpy,
maps onto the port's by name. A generating graph (a ``beam_search``
group) hoists its step network's parameters under the same absolute names
as the training graph's recurrent group (``_dec_in.w0``,
``_gru_decoder.w0``, ...) and reads its generated words' embedding under
the training graph's name (``_trg_emb.w0``), so a training checkpoint of
either package serves generation unchanged. PTM1 files and checkpoints
carry the same names.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def params_from_numpy(np_params: Dict[str, object], device="cuda",
                      network=None) -> Dict[str, torch.Tensor]:
    """{name: array} -> {name: f32 tensor on ``device``}. With a
    ``network`` (``core/network.py:Network``), every parameter it needs
    must be present with its spec's shape."""
    if network is not None:
        _check_params(np_params, network)
    return {name: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
            for name, v in np_params.items()}


def _check_params(np_params, network):
    """Every parameter ``network`` needs is present with its spec's
    shape."""
    missing = sorted(set(network.param_specs) - set(np_params))
    if missing:
        raise KeyError(f"parameters missing for this graph: {missing}")
    for name, spec in network.param_specs.items():
        shape = tuple(np.shape(np_params[name]))
        if shape != tuple(spec.shape):
            raise ValueError(f"parameter {name!r} has shape {shape}, "
                             f"the graph needs {tuple(spec.shape)}")


def quantized_params_from_numpy(np_params: Dict[str, object], quant: Dict,
                                device="cuda", network=None
                                ) -> Dict[str, torch.Tensor]:
    """The params of a quantized merged model in their storage dtype on
    ``device``: int8 leaves as ``torch.int8``, bf16 leaves (JAX's
    ``ml_dtypes.bfloat16`` arrays or the port's uint16 bits) as
    ``torch.bfloat16``, f32 stand-downs as f32, non-float leaves as they
    are, and each int8 scale as an f32 tensor under ``name +
    quant.SCALE_SUFFIX``. With a ``network``, the presence and shape
    checks of :func:`params_from_numpy`."""
    from paddle_tpu_torch import quant as quant_lib
    if network is not None:
        _check_params(np_params, network)
    out = {}
    for name, v in np_params.items():
        bits = quant_lib.bf16_bits(v, quant)
        if bits is not None:
            t = quant_lib.bf16_from_bits(bits)
        else:
            a = np.asarray(v)
            t = torch.from_numpy(np.array(a, dtype=np.float32)
                                 if a.dtype.kind == "f" else np.array(a))
        out[name] = t.to(device)
    for key, s in quant_lib.scale_leaves(quant).items():
        out[key] = torch.from_numpy(np.array(s, np.float32)).to(device)
    return out


def _tensor(v, device) -> torch.Tensor:
    a = np.array(v)
    return torch.from_numpy(a.astype(np.int32 if a.dtype.kind in "iu"
                                     else np.float32)).to(device)


def opt_state_from_numpy(np_state: Dict[str, object],
                         device="cuda") -> Dict[str, object]:
    """A JAX optimizer state as numpy (``{"slots": {name: {slot: array}},
    "t": array, "num_samples": array}``, plus ``"avg"``) -> the port's
    state: slot tensors on ``device`` (float32, the integer ``t_rows`` of
    lazy sparse rows as int32), ``t`` an int and ``num_samples`` a
    float."""
    state = {"slots": {name: {s: _tensor(v, device) for s, v in d.items()}
                       for name, d in np_state["slots"].items()},
             "t": int(np.asarray(np_state["t"])),
             "num_samples": float(np.asarray(np_state["num_samples"],
                                             dtype=np.float32))}
    if "avg" in np_state:
        state["avg"] = {n: _tensor(v, device)
                        for n, v in np_state["avg"].items()}
    return state
