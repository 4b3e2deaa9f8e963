"""LeNet-style MNIST conv net: the port of ``paddle_tpu/models/lenet.py``
(the reference's ``v1_api_demo/mnist`` topology: two conv + pool stages,
then fc + softmax)."""

from __future__ import annotations

from paddle_tpu_torch.config import dsl


def lenet_mnist(*, classes: int = 10):
    """Returns (cost, softmax_output, data_names). The graph is appended to
    the current DSL graph; call dsl.reset() first for a fresh model."""
    img = dsl.data(name="pixel", size=784, channels=1, height=28, width=28)
    label = dsl.data(name="label", size=classes)
    c1 = dsl.conv(input=img, num_filters=20, filter_size=5, act="relu",
                  channels=1, name="conv1")
    p1 = dsl.img_pool(input=c1, pool_size=2, stride=2, name="pool1")
    c2 = dsl.conv(input=p1, num_filters=50, filter_size=5, act="relu",
                  name="conv2")
    p2 = dsl.img_pool(input=c2, pool_size=2, stride=2, name="pool2")
    f1 = dsl.fc(input=p2, size=500, act="relu", name="fc1")
    out = dsl.fc(input=f1, size=classes, act="softmax", name="output")
    cost = dsl.classification_cost(input=out, label=label, name="cost")
    return cost, out, ["pixel", "label"]
