"""BiLSTM-CRF sequence tagger — the reference's sequence-tagging demo
(``v1_api_demo/sequence_tagging/rnn_crf.py``): embeddings -> forward and
backward LSTM -> linear emission scores -> linear-chain CRF cost, with a
Viterbi decode branch sharing the transition matrix. The same graph, with
the same layer and parameter names, as ``paddle_tpu/models/tagging.py``,
built with the port's DSL.

CoNLL-2000 chunking, as ``rnn_crf.py`` hardcodes it: a word dictionary of
6778 and 23 chunk labels (IOB over 11 chunk types plus O).
"""

from __future__ import annotations

from paddle_tpu_torch.config import dsl
from paddle_tpu_torch.config.model_config import ParamAttr


def bilstm_crf_tagger(*, vocab_size: int = 5000, embed_dim: int = 64,
                      hidden: int = 64, num_labels: int = 9):
    """Returns (cost, decoded, data_names). ``decoded`` is the Viterbi
    path; the CRF transition matrix is shared between cost and decode by
    parameter name, as the reference shares it between ``crf_layer`` and
    ``crf_decoding_layer``."""
    word = dsl.data(name="word", size=vocab_size, is_sequence=True)
    label = dsl.data(name="label", size=num_labels, is_sequence=True)
    emb = dsl.embedding(input=word, size=embed_dim, name="word_emb")

    f_in = dsl.fc(input=emb, size=hidden * 4, act="linear", name="fwd_in")
    fwd = dsl.lstmemory(input=f_in, name="lstm_fwd")
    b_in = dsl.fc(input=emb, size=hidden * 4, act="linear", name="bwd_in")
    bwd = dsl.lstmemory(input=b_in, reverse=True, name="lstm_bwd")
    feat = dsl.concat([fwd, bwd], name="bilstm")

    emission = dsl.fc(input=feat, size=num_labels, act="linear",
                      name="emission", bias_attr=False)
    transitions = ParamAttr(name="crf_transitions")
    cost = dsl.crf_layer(input=emission, label=label, size=num_labels,
                         param_attr=transitions, name="crf_cost")
    decoded = dsl.crf_decoding_layer(input=emission, size=num_labels,
                                     param_attr=transitions,
                                     name="crf_decode")
    return cost, decoded, ["word", "label"]
