"""ResNet for ImageNet-scale image classification: the port of
``paddle_tpu/models/resnet.py``, the graph ``__graft_entry__.py:entry()``
compiles.

The same topology, layer names and parameters as the reference: bottleneck
(50, 101, 152) or basic (18, 34) blocks, projection shortcuts where a stage
starts, batch norm after every conv, the reference's ceil-mode pools (the
stem pool gives 57 x 57 at 224, the last stage 8 x 8), a global average
pool and a softmax fc.
"""

from __future__ import annotations

from paddle_tpu_torch.config import dsl

_DEPTH_CFG = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}


def _conv_bn(name, x, nf, fs, stride, act, channels=None):
    c = dsl.conv(input=x, num_filters=nf, filter_size=fs, stride=stride,
                 padding=(fs - 1) // 2, act="linear", channels=channels,
                 bias_attr=False, name=f"{name}_conv")
    return dsl.batch_norm(input=c, act=act, name=f"{name}_bn")


def _bottleneck(name, x, nf, stride, project):
    r = _conv_bn(f"{name}_a", x, nf, 1, stride, "relu")
    r = _conv_bn(f"{name}_b", r, nf, 3, 1, "relu")
    r = _conv_bn(f"{name}_c", r, nf * 4, 1, 1, "linear")
    sc = (_conv_bn(f"{name}_sc", x, nf * 4, 1, stride, "linear")
          if project else x)
    return dsl.addto([r, sc], act="relu", name=f"{name}_add")


def _basic(name, x, nf, stride, project):
    r = _conv_bn(f"{name}_a", x, nf, 3, stride, "relu")
    r = _conv_bn(f"{name}_b", r, nf, 3, 1, "linear")
    sc = (_conv_bn(f"{name}_sc", x, nf, 1, stride, "linear")
          if project else x)
    return dsl.addto([r, sc], act="relu", name=f"{name}_add")


def resnet(depth: int = 50, *, classes: int = 1000, image_size: int = 224,
           channels: int = 3, width: int = 64):
    """Returns (cost, softmax_output, data_names)."""
    kind, blocks = _DEPTH_CFG[depth]
    img = dsl.data(name="image", size=channels * image_size * image_size,
                   channels=channels, height=image_size, width=image_size)
    label = dsl.data(name="label", size=classes)
    x = _conv_bn("stem", img, width, 7, 2, "relu", channels=channels)
    x = dsl.img_pool(input=x, pool_size=3, stride=2, padding=1,
                     name="stem_pool")
    block = _bottleneck if kind == "bottleneck" else _basic
    nf = width
    for stage, n in enumerate(blocks):
        for i in range(n):
            stride = 2 if (stage > 0 and i == 0) else 1
            x = block(f"res{stage + 2}{chr(ord('a') + i)}", x, nf, stride,
                      i == 0)
        nf *= 2
    # global average pool over the remaining spatial extent
    x = dsl.img_pool(input=x, pool_type="avg-projection", name="global_pool")
    out = dsl.fc(input=x, size=classes, act="softmax", name="output")
    cost = dsl.classification_cost(input=out, label=label, name="cost")
    return cost, out, ["image", "label"]
