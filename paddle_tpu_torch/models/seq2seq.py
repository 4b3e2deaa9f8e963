"""Seq2seq NMT with Bahdanau attention: the reference's seqToseq demo
(``simple_attention`` in ``trainer_config_helpers/networks.py``): a
bidirectional GRU encoder and a GRU decoder, driven each step by an
additive-attention context, in a recurrent group (training) or a beam
search (generation, ``core/generation.py:SequenceGenerator``). The same
graphs, with the same layer and parameter names, as
``paddle_tpu/models/seq2seq.py``, built with the port's DSL; the
generating graph's step parameters are the training decoder's, and the
generated word's embedding is the training graph's ``_trg_emb.w0``.

``seq_parallel="ring"|"ulysses"`` adds the encoder self-attention block
``enc_self_att`` (``multi_head_attention``, ``num_heads`` heads over the
embedding) as the JAX model does; the port has no sequence mesh, so the
block runs dense through the flash-attention kernels.
"""

from __future__ import annotations

from paddle_tpu_torch.config import dsl


def _attention(name, enc_seq, enc_proj, state, hidden):
    """Additive attention: score = v.tanh(W_d s + W_e h_t); returns the
    attention-weighted context vector (``simple_attention``)."""
    dproj = dsl.fc(input=state, size=hidden, act="linear",
                   name=f"{name}_dproj", bias_attr=False)
    expanded = dsl.expand(dproj, enc_proj, name=f"{name}_expand")
    comb = dsl.addto([expanded, enc_proj], act="tanh", name=f"{name}_comb")
    weight = dsl.fc(input=comb, size=1, act="sequence_softmax",
                    name=f"{name}_weight", bias_attr=False)
    scaled = dsl.scaling_layer(enc_seq, weight, name=f"{name}_scaled")
    return dsl.pooling(input=scaled, pooling_type="sum",
                       name=f"{name}_context")


def seq2seq_attention(*, src_vocab: int = 5000, trg_vocab: int = 5000,
                      embed_dim: int = 64, hidden: int = 64,
                      beam_size: int = 4, max_length: int = 20,
                      generating: bool = False,
                      seq_parallel: str = None, num_heads: int = 4):
    """Build the training graph (``generating=False``: returns (cost,
    probs_seq, data_names)) or the generation graph (``generating=True``:
    returns (gen_layer, data_names); drive it with SequenceGenerator).
    The reference's published width is ``src_vocab = trg_vocab = 30000``,
    ``embed_dim = hidden = 512``; with ``seq_parallel`` and the default
    ``num_heads = 4`` the self-attention heads are 128 wide."""
    src = dsl.data(name="source_words", size=src_vocab, is_sequence=True)
    semb = dsl.embedding(input=src, size=embed_dim, name="src_emb")
    if seq_parallel:
        semb = dsl.multi_head_attention(
            semb, num_heads=num_heads, seq_parallel=seq_parallel,
            name="enc_self_att")
    f_in = dsl.fc(input=semb, size=hidden * 3, act="linear", name="enc_f_in")
    fwd = dsl.grumemory(input=f_in, name="enc_fwd")
    b_in = dsl.fc(input=semb, size=hidden * 3, act="linear", name="enc_b_in")
    bwd = dsl.grumemory(input=b_in, reverse=True, name="enc_bwd")
    enc = dsl.concat([fwd, bwd], name="encoded")
    enc_proj = dsl.fc(input=enc, size=hidden, act="linear",
                      name="encoded_proj", bias_attr=False)
    # backward GRU's first frame summarizes the sentence -> decoder boot
    boot = dsl.fc(input=dsl.first_seq(bwd, name="enc_bwd_first"),
                  size=hidden, act="tanh", name="decoder_boot")

    def step(trg_emb, enc_static, proj_static):
        state = dsl.memory(name="gru_decoder", size=hidden,
                           boot_layer=boot)
        context = _attention("att", enc_static, proj_static, state, hidden)
        dec_in = dsl.fc(input=[context, trg_emb], size=hidden * 3,
                        act="linear", name="dec_in")
        gru = dsl.gru_step_layer(dec_in, state, size=hidden,
                                 name="gru_decoder")
        return dsl.fc(input=gru, size=trg_vocab, act="softmax",
                      name="dec_out", bias_attr=False)

    if generating:
        gen = dsl.beam_search(
            step,
            [dsl.GeneratedInput(size=trg_vocab,
                                embedding_name="_trg_emb.w0",
                                embedding_size=embed_dim),
             dsl.StaticInput(enc), dsl.StaticInput(enc_proj)],
            bos_id=0, eos_id=1, beam_size=beam_size,
            max_length=max_length, name="gen")
        return gen, ["source_words"]

    trg = dsl.data(name="target_words", size=trg_vocab, is_sequence=True)
    trg_next = dsl.data(name="target_next", size=trg_vocab,
                        is_sequence=True)
    temb = dsl.embedding(input=trg, size=embed_dim, name="trg_emb")
    probs = dsl.recurrent_group(
        step, [temb, dsl.StaticInput(enc), dsl.StaticInput(enc_proj)],
        name="decoder_group")
    cost = dsl.classification_cost(input=probs, label=trg_next,
                                   name="nmt_cost")
    return cost, probs, ["source_words", "target_words", "target_next"]
