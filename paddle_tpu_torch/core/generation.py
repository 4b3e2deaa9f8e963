"""Sequence generation: beam search over a recurrent step network.

The port's counterpart of ``paddle_tpu/core/generation.py``
(``SequenceGenerator``; the reference's
``RecurrentGradientMachine::generateSequence``): beams live as a [B, K]
axis flattened to B*K rows of the step network, finished beams are frozen
by forcing a zero-cost EOS continuation, and the parent-beam reordering is
a gather. Greedy decoding is K = 1, which skips the gathers.

JAX jits the whole search; PyTorch runs eagerly, so the search is a Python
loop over the steps, each one ``Network.apply`` of the step network over
B*K rows (``train=False``: a ``gru_step`` runs ``gru_cell_infer``, an
``lstm_step`` ``lstm_cell_infer``, the CUDA kernels on the card). Nothing
is compiled, so JAX's jit cache and its bound have no counterpart.

**Decode cost follows the output length.** The default search runs
chunks of ``decode_chunk`` steps (``DEFAULT_DECODE_CHUNK``) and stops at
the first chunk boundary where every beam is finished: one host sync per
chunk. Its result equals the full length-``max_length`` loop
(``full_scan=True``), because a step in which every beam is finished only
appends the forced zero-cost EOS continuation: tokens stay EOS (the buffer
starts as EOS and the gathers are the identity), scores carry unchanged
through the selection (the hooks are exempt from the forced continuation)
and lengths read the first EOS.

The selection takes the K best of the B x (K*V) totals in the order of
``lax.top_k``: descending, and the lower index first among equal totals
(a stable sort). Ties do occur: the forced-EOS continuations of finished
beams, and the -1e9 fill when fewer than K finite candidates remain.

The user beam-control hooks (``RecurrentGradientMachine.h:92-145``) are
torch callables, called each step:

- ``candidate_adjust(logp [B*K, V], state) -> logp``;
- ``drop_callback(state, total [B, K, V]) -> bool [B, K, V]`` (True drops
  that (beam, token) node; the forced-EOS continuation of a finished beam
  is exempt);
- ``norm_or_drop(eos_scores [B, K], length) -> [B, K]``, applied to the
  candidates that end at this step (``length`` = t + 1 counts the EOS):
  a renormalised score, or -1e9 to drop the ending;
- ``stop_beam_search(state, t) -> bool`` (scalar or [B]): True freezes the
  search from this step on.

Hooks pinned by ``dsl.beam_search`` are the defaults of every call.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from paddle_tpu_torch.core.argument import Argument

#: decoder steps per chunk of the early-exit search; a request whose
#: beams all finish at step f pays ceil((f + 1) / chunk) * chunk steps
DEFAULT_DECODE_CHUNK = 8

NEG = -1e9  # JAX's NEG, in float32


def generation_params(graph) -> Dict[str, tuple]:
    """{name: shape} of the parameters a graph's beam searches read
    besides their hoisted step parameters: each GeneratedInput's
    embedding table [size, embedding_size], a parameter of the training
    graph that no layer of the generating graph owns."""
    out = {}
    for ldef in graph.layers.values():
        if ldef.type == "beam_search_group":
            g = ldef.attrs["gen"]
            out[g["embedding_name"]] = (g["size"], g["embedding_size"])
    return out


def _flatten_beams(x):
    return x.reshape((-1,) + tuple(x.shape[2:]))


def _unflatten_beams(x, B, K):
    return x.reshape((B, K) + tuple(x.shape[1:]))


def _select_top(flat, K):
    """The K largest entries of each row of ``flat`` and their indices,
    in ``lax.top_k``'s order (descending, lower index first on ties)."""
    scores, idx = torch.sort(flat, dim=1, descending=True, stable=True)
    return scores[:, :K], idx[:, :K]


class SequenceGenerator:
    """Drives a generating recurrent group (``beam_search`` in the DSL):
    construct from the graph and the group's name, call ``generate``."""

    def __init__(self, model, gen_layer: str):
        from paddle_tpu_torch.layers.group import _group_subnet

        self.cfg = model.layers[gen_layer]
        if self.cfg.type != "beam_search_group":
            raise ValueError(f"{gen_layer!r} is not a beam_search group")
        self.net = _group_subnet(self.cfg)
        self.gen = self.cfg.attrs["gen"]  # the GeneratedInput spec
        #: the last ``generate`` call's ``{decode_steps, steps_saved,
        #: max_length, decode_chunk, full_scan}``
        self.last_info: Dict[str, Any] = {}

    # ------------------------------------------------------------------
    def static_input_layers(self):
        """Outer layer names feeding the group's static and boot inputs:
        the encoder outputs ``generate`` needs in ``outer_outputs``."""
        return [inp.layer_name
                for inp, meta in zip(self.cfg.inputs, self.cfg.attrs["ins"])
                if meta["kind"] in ("static", "boot")]

    def static_feed_from_outer(self, outer_outputs, row=None):
        """Outer-layer-keyed encoder outputs -> the boundary-keyed static
        feed; ``row`` selects one lane as a batch of 1."""
        static_feed = {}
        for inp, meta in zip(self.cfg.inputs, self.cfg.attrs["ins"]):
            if meta["kind"] in ("static", "boot"):
                a = outer_outputs[inp.layer_name]
                if row is not None:
                    a = Argument(
                        value=a.value[row:row + 1],
                        mask=None if a.mask is None
                        else a.mask[row:row + 1])
                static_feed[meta["boundary"]] = a
        return static_feed

    def _resolve_hooks(self, candidate_adjust, drop_callback, norm_or_drop,
                       stop_beam_search):
        attrs = self.cfg.attrs
        if candidate_adjust is None:
            candidate_adjust = attrs.get("candidate_adjust")
        if drop_callback is None:
            drop_callback = attrs.get("drop_callback")
        if norm_or_drop is None:
            norm_or_drop = attrs.get("norm_or_drop")
        if stop_beam_search is None:
            stop_beam_search = attrs.get("stop_beam_search")
        return (candidate_adjust, drop_callback, norm_or_drop,
                stop_beam_search)

    def _resolve_chunk(self, L: int, decode_chunk, full_scan):
        """The chunk, or None for the full scan. ``decode_chunk`` is None
        (the config's pinned policy), ``> 0`` (chunked) or ``<= 0`` (the
        full scan); ``full_scan=True`` forces the full scan. Only when
        ``decode_chunk`` is unset do the config's attrs apply."""
        attrs = self.cfg.attrs
        if decode_chunk is None:
            decode_chunk = attrs.get("decode_chunk")
            if full_scan is None:
                full_scan = attrs.get("full_scan", False)
        if full_scan or (decode_chunk is not None and int(decode_chunk) <= 0):
            return None
        chunk = int(decode_chunk or DEFAULT_DECODE_CHUNK)
        return max(1, min(chunk, L))

    # ------------------------------------------------------------------
    def generate(self, params, outer_outputs: Dict[str, Argument], *,
                 beam_size: Optional[int] = None,
                 max_length: Optional[int] = None,
                 candidate_adjust: Optional[Callable] = None,
                 drop_callback: Optional[Callable] = None,
                 norm_or_drop: Optional[Callable] = None,
                 stop_beam_search: Optional[Callable] = None,
                 decode_chunk: Optional[int] = None,
                 full_scan: Optional[bool] = None):
        """Run the search.

        params: the parameter table (the step network's under their
            hoisted names, and the generated word's embedding).
        outer_outputs: the static and boot inputs' outer-layer Arguments,
            keyed by outer layer name (run the encoder network first).
        decode_chunk, full_scan: the decode policy (module docstring);
            each defaults to the config's attr.
        The hooks default to the config's attrs of the same names.

        Returns (tokens [B, K, L] int32, scores [B, K], lengths [B, K]):
        beams best first, the EOS counted in the length.
        """
        if beam_size is None:
            beam_size = self.cfg.attrs.get("beam_size", 1)
        if max_length is None:
            max_length = self.cfg.attrs.get("max_length", 100)
        hooks = self._resolve_hooks(candidate_adjust, drop_callback,
                                    norm_or_drop, stop_beam_search)
        chunk = self._resolve_chunk(max_length, decode_chunk, full_scan)
        static_feed = self.static_feed_from_outer(outer_outputs)
        with torch.no_grad():
            tokens, scores, lengths, steps = self._search(
                params, static_feed, int(beam_size), int(max_length), hooks,
                chunk)
        self.last_info = {
            "decode_steps": steps, "max_length": int(max_length),
            "steps_saved": int(max_length) - steps,
            "decode_chunk": chunk, "full_scan": chunk is None}
        return tokens, scores, lengths

    # ------------------------------------------------------------------
    def _make_step(self, B: int, K: int, L: int, hooks):
        """The one-decoder-step function ``step(params, flat_static,
        state, t) -> new_state``; ``state`` has keys {tokens, prev,
        scores, finished, mem} and ``flat_static`` maps a group boundary
        to an Argument of B*K rows."""
        adjust, drop_cb, norm_or_drop, stop_fn = hooks
        cfg, net, gen = self.cfg, self.net, self.gen
        memories = cfg.attrs["memories"]
        out_name = cfg.attrs["outputs"][0]
        eos = gen["eos_id"]
        gen_boundary = gen["boundary"]

        def step(params, flat_static, state, t):
            emb = params[gen["embedding_name"]]
            feed = dict(flat_static)
            feed[gen_boundary] = Argument(
                value=emb[state["prev"].reshape(-1)])  # [B*K, E]
            for m in memories:
                feed[m["boundary"]] = Argument(
                    value=state["mem"][m["boundary"]])
            outs = net.apply(params, feed, train=False)
            prob = outs[out_name].value  # [B*K, V] post-softmax
            logp = torch.log(torch.clamp_min(prob, 1e-20))
            if adjust is not None:
                logp = adjust(logp, state)
            V = logp.shape[-1]
            logp = _unflatten_beams(logp, B, K)  # [B, K, V]
            # finished beams may only "continue" with EOS at zero cost
            fin = state["finished"][:, :, None]
            is_eos = torch.arange(V, device=logp.device) == eos
            eos_only = torch.where(is_eos, 0.0, NEG).to(logp.dtype)
            logp = torch.where(fin, eos_only, logp)
            total = state["scores"][:, :, None] + logp  # [B, K, V]
            # the forced EOS continuation of a finished beam is
            # bookkeeping, not a candidate: no hook may touch it
            forced = fin & is_eos
            if norm_or_drop is not None:
                # NormOrDropNode: a candidate that ENDS here (picks EOS at
                # step t, path length t + 1 counting the EOS)
                ended = norm_or_drop(total[:, :, eos], t + 1)
                total[:, :, eos] = torch.where(state["finished"],
                                               total[:, :, eos], ended)
            if drop_cb is not None:
                drop = drop_cb(state, total)
                total = total.masked_fill(torch.logical_and(drop, ~forced),
                                          NEG)
            top_scores, top_idx = _select_top(total.reshape(B, K * V), K)
            parent = top_idx // V
            token = (top_idx % V).to(torch.int32)

            if K == 1:
                # greedy: the single beam is its own parent, every gather
                # below is the identity
                def gather_parents(x):
                    return x
                fin_parent = state["finished"]
                tokens = state["tokens"].clone()
            else:
                def gather_parents(x):
                    xb = _unflatten_beams(x, B, K)
                    idx = parent.reshape((B, K) + (1,) * (xb.dim() - 2))
                    return _flatten_beams(torch.gather(
                        xb, 1, idx.expand(xb.shape)))
                fin_parent = torch.gather(state["finished"], 1, parent)
                tokens = torch.gather(state["tokens"], 1,
                                      parent[:, :, None].expand(B, K, L))

            finf = _flatten_beams(fin_parent)  # [B*K]
            new_mem = {}
            for m in memories:
                b = m["boundary"]
                v = gather_parents(outs[m["link"]].value)
                # frozen memories for finished beams
                old = gather_parents(state["mem"][b])
                new_mem[b] = torch.where(
                    finf.reshape((-1,) + (1,) * (v.dim() - 1)), old, v)
            tokens[:, :, t] = token
            new_state = {"tokens": tokens, "prev": token,
                         "scores": top_scores,
                         "finished": fin_parent | (token == eos),
                         "mem": new_mem}
            if stop_fn is not None:
                # stopBeamSearch: from here on every beam behaves as
                # finished
                stop = torch.as_tensor(stop_fn(new_state, t),
                                       device=token.device).to(torch.bool)
                if stop.dim() <= 1:  # scalar or per-batch [B] -> [B, K]
                    stop = stop.reshape(-1, 1).expand(B, K)
                new_state["finished"] = new_state["finished"] | stop
            return new_state

        return step

    def _init_state(self, static_feed, K: int, L: int):
        """(B, flat_static, state0) of a search over the static and boot
        feed."""
        cfg, net, gen = self.cfg, self.net, self.gen
        memories = cfg.attrs["memories"]
        bos, eos = gen["bos_id"], gen["eos_id"]

        boots = {m["boundary"]: static_feed[m["boundary"]].value
                 for m in memories if m["boundary"] in static_feed}
        some_static = next(iter(static_feed.values()), None)
        if some_static is None:
            raise ValueError("generation needs at least one static/boot "
                             "input to define the batch size")
        B = some_static.value.shape[0]
        dev = some_static.value.device

        # beams: replicate the statics over K and flatten to B*K rows
        def rep(x):
            return _flatten_beams(
                x[:, None].expand((B, K) + tuple(x.shape[1:])))

        flat_static = {
            b: Argument(value=rep(a.value),
                        mask=None if a.mask is None else rep(a.mask))
            for b, a in static_feed.items() if b not in boots}

        carry0 = {}
        for m in memories:
            bname = m["boundary"]
            if bname in boots:
                v = boots[bname]
            else:
                v = torch.full((B, net.shape_infos[bname].size),
                               float(m.get("init", 0.0)),
                               dtype=torch.float32, device=dev)
            carry0[bname] = rep(v)

        if K > 1:
            # only beam 0 is live at t = 0, so duplicates don't fill the
            # beam
            scores = torch.cat(
                [torch.zeros((B, 1), device=dev),
                 torch.full((B, K - 1), NEG, device=dev)], dim=1)
        else:
            scores = torch.zeros((B, K), device=dev)
        state0 = {
            "tokens": torch.full((B, K, L), eos, dtype=torch.int32,
                                 device=dev),
            "prev": torch.full((B, K), bos, dtype=torch.int32, device=dev),
            "scores": scores,
            "finished": torch.zeros((B, K), dtype=torch.bool, device=dev),
            "mem": carry0,
        }
        return B, flat_static, state0

    def _search(self, params, static_feed, K: int, L: int, hooks,
                chunk: Optional[int] = None):
        """The search: ``chunk=None`` is the single length-L loop;
        otherwise chunks of ``chunk`` steps, stopping at the first chunk
        boundary where every beam is finished (or ``stop_beam_search``
        fired, which sets ``finished``). Returns (tokens, scores,
        lengths, steps), ``steps`` the decoder steps run."""
        B, flat_static, state = self._init_state(static_feed, K, L)
        step = self._make_step(B, K, L, hooks)
        if chunk is None:
            for t in range(L):
                state = step(params, flat_static, state, t)
            steps = L
        else:
            t0 = 0
            # one host sync per chunk; the last chunk stops at L, as the
            # overhanging steps of JAX's last chunk are no-ops
            while t0 < L and not bool(state["finished"].all()):
                for t in range(t0, min(t0 + chunk, L)):
                    state = step(params, flat_static, state, t)
                t0 += chunk
            steps = min(t0, L)

        tokens = state["tokens"]
        # length = index of the first EOS + 1 (EOS kept, as the
        # reference's results include the end mark), else L
        is_eos = tokens == self.gen["eos_id"]
        first = is_eos.to(torch.int32).argmax(dim=-1)
        lengths = torch.where(is_eos.any(dim=-1), first + 1,
                              torch.full_like(first, L))
        return tokens, state["scores"], lengths, steps
