"""Miscellaneous layers: the port's counterpart of
``paddle_tpu/layers/misc.py``. Only ``get_output`` is ported so far (the
cell state of an ``lstm_step`` in a recurrent or beam-search group); the
other types come with the layer plane's later slices."""

from __future__ import annotations

import dataclasses

from paddle_tpu_torch.core.argument import Argument
from paddle_tpu_torch.core.registry import LayerImpl, register_layer


@register_layer("get_output")
class GetOutputLayer(LayerImpl):
    """Reads a named auxiliary output of the previous layer (the
    reference's ``get_output_layer``, e.g. lstm_step's state)."""

    def infer(self, cfg, in_infos):
        return dataclasses.replace(in_infos[0], size=cfg.size
                                   or in_infos[0].size)

    def apply(self, cfg, params, ins, ctx):
        arg = cfg.attrs.get("arg_name", "state")
        return Argument(value=ins[0].state[arg], mask=ins[0].mask)
