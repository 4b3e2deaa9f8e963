"""LSTM text classification — the reference's RNN benchmark model
(``benchmark/paddle/rnn/rnn.py``: embedding -> N x [fc(4h) + lstmemory] ->
max-pool over time -> fc softmax; IMDB, dict 30k). The same graph as
``paddle_tpu/models/lstm_text.py``, built with the port's DSL."""

from __future__ import annotations

from paddle_tpu_torch.config import dsl


def lstm_text_classifier(*, vocab_size: int = 30000, embed_dim: int = 128,
                         hidden: int = 256, num_layers: int = 2,
                         classes: int = 2):
    """Returns (cost, softmax_output, data_names)."""
    words = dsl.data(name="words", size=vocab_size, is_sequence=True)
    label = dsl.data(name="label", size=classes)
    x = dsl.embedding(input=words, size=embed_dim, vocab_size=vocab_size,
                      name="embed")
    for i in range(num_layers):
        proj = dsl.fc(input=x, size=hidden * 4, act="linear",
                      name=f"lstm{i}_proj")
        x = dsl.lstmemory(input=proj, name=f"lstm{i}")
    pooled = dsl.pooling(input=x, pooling_type="max", name="pool_time")
    out = dsl.fc(input=pooled, size=classes, act="softmax", name="output")
    cost = dsl.classification_cost(input=out, label=label, name="cost")
    return cost, out, ["words", "label"]
