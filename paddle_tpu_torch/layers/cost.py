"""Cost layers, graph only: a config names its cost, and shape inference
must accept it, but the serving path never evaluates it. The loss itself
arrives with training."""

from __future__ import annotations

from paddle_tpu_torch.core.registry import LayerImpl, ShapeInfo, register_layer


@register_layer("multi-class-cross-entropy")
class MultiClassCrossEntropy(LayerImpl):
    def infer(self, cfg, in_infos):
        return ShapeInfo(size=1)

    def apply(self, cfg, params, ins, ctx):
        raise NotImplementedError(
            "cost layers are not ported yet: serve the model's outputs, "
            "not its cost")
