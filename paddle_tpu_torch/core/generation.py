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

**Continuous batching** (:meth:`SequenceGenerator.session`,
:class:`DecodeSession`): a fixed number of lanes, each a request of K
beams with its own decode clock ``t``, share one step over all W*K rows;
requests are admitted into free lanes and retired at chunk boundaries.
JAX jits the session's admit, chunk and release once each and guards the
three programs against recompiles (``RecompileGuard``); the port runs
them eagerly, so that guard has no counterpart either.

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

Hooks pinned by ``dsl.beam_search`` are the defaults of every call. Their
time arguments are Python ints in the dedicated search and per-lane
tensors inside a :class:`DecodeSession` (``length`` [W, 1], ``t`` [W]):
write hooks with broadcasting ops, as the JAX package asks.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
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
        #: a params-view hook the step applies to its params (the one
        #: place the search reads them): the serving predictor installs
        #: ``quant.materialize`` for a quantized model, so the step reads
        #: its weights dequantized one layer at a time; None = identity
        self._param_view: Optional[Callable] = None
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
    def _make_step(self, B: int, K: int, L: int, hooks, *,
                   per_lane_t: bool = False):
        """The one-decoder-step function ``step(params, flat_static,
        state, t) -> new_state``, shared by the dedicated search (``t`` an
        int) and :class:`DecodeSession` (``t`` a [B] tensor,
        ``per_lane_t=True``: each lane writes its token at its own
        position); ``state`` has keys {tokens, prev, scores, finished,
        mem} and ``flat_static`` maps a group boundary to an Argument of
        B*K rows."""
        adjust, drop_cb, norm_or_drop, stop_fn = hooks
        cfg, net, gen = self.cfg, self.net, self.gen
        memories = cfg.attrs["memories"]
        out_name = cfg.attrs["outputs"][0]
        eos = gen["eos_id"]
        gen_boundary = gen["boundary"]

        def step(params, flat_static, state, t):
            if self._param_view is not None:
                params = self._param_view(params)
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
                length = (t + 1)[:, None] if per_lane_t else t + 1
                ended = norm_or_drop(total[:, :, eos], length)
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
            if per_lane_t:
                # each lane writes at its own position t[b]
                pos = (torch.arange(L, device=t.device)[None, None, :]
                       == t[:, None, None])  # [B, 1, L]
                tokens = torch.where(pos, token[:, :, None], tokens)
            else:
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
        step = self._make_step(B, K, L, hooks, per_lane_t=False)
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

    # ------------------------------------------------------------------
    def session(self, params, width: int, *,
                beam_size: Optional[int] = None,
                max_length: Optional[int] = None,
                decode_chunk: Optional[int] = None,
                candidate_adjust: Optional[Callable] = None,
                drop_callback: Optional[Callable] = None,
                norm_or_drop: Optional[Callable] = None,
                stop_beam_search: Optional[Callable] = None
                ) -> "DecodeSession":
        """A continuous-batching decode session: ``width`` lanes stepped
        ``decode_chunk`` steps per :meth:`DecodeSession.run_chunk`, with
        lanes admitted and retired between chunks."""
        if beam_size is None:
            beam_size = self.cfg.attrs.get("beam_size", 1)
        if max_length is None:
            max_length = self.cfg.attrs.get("max_length", 100)
        hooks = self._resolve_hooks(candidate_adjust, drop_callback,
                                    norm_or_drop, stop_beam_search)
        chunk = self._resolve_chunk(max_length, decode_chunk, False)
        if chunk is None:
            chunk = max(1, min(DEFAULT_DECODE_CHUNK, int(max_length)))
        return DecodeSession(self, params, int(width), int(beam_size),
                             int(max_length), int(chunk), hooks)


class DecodeSession:
    """Fixed-width continuous-batching decode state.

    ``width`` lanes share one step over all W*K rows; each lane carries
    its own decode clock ``t`` (a lane admitted mid-flight starts at 0
    while its neighbours are deep into their outputs). Between chunks the
    host drives each lane's life: :meth:`admit` splices a freshly encoded
    request into a free lane, :meth:`run_chunk` advances every live lane
    ``chunk`` steps, :meth:`poll` / :meth:`finished_lanes` /
    :meth:`peek` / :meth:`release` retire lanes whose beams all finished
    or that reached ``max_length``. Every per-step op is row-wise, so a
    lane's tokens and scores equal the dedicated search's on the same
    request whatever its neighbours decode.

    The chunk is a Python loop of ``chunk`` steps, each one step of the
    step network over all W*K rows, live or not, as the JAX package's
    compiled chunk; a lane that is not live keeps its state through
    ``torch.where`` on the step's advance mask. The state lives on the
    encoder outputs' device and is written under ``torch.inference_mode``
    only; the host reads it once a chunk boundary (:meth:`poll`).
    """

    _CORE = ("tokens", "prev", "scores", "finished", "mem")

    def __init__(self, gen: SequenceGenerator, params, width: int, K: int,
                 L: int, chunk: int, hooks):
        self.gen = gen
        self.params = params
        self.width, self.K, self.L, self.chunk = width, K, L, chunk
        self.hooks = hooks
        self._state = None  # built at the first admit
        self._step = None

    # ------------------------------------------------------------ state
    def _build(self, static_feed):
        """The empty W-lane state, shaped by the first admitted request's
        static feed."""
        W, K, L = self.width, self.K, self.L
        cfg, net, gen = self.gen.cfg, self.gen.net, self.gen.gen
        memories = cfg.attrs["memories"]
        bos, eos = gen["bos_id"], gen["eos_id"]
        boot_names = {m["boundary"] for m in memories}
        dev = next(iter(static_feed.values())).value.device

        def z(x):
            return torch.zeros((W * K,) + tuple(x.shape[1:]),
                               dtype=x.dtype, device=dev)

        statics = {b: Argument(value=z(a.value),
                               mask=None if a.mask is None else z(a.mask))
                   for b, a in static_feed.items() if b not in boot_names}
        mem = {}
        for m in memories:
            bname = m["boundary"]
            size = (static_feed[bname].value.shape[-1]
                    if bname in static_feed
                    else net.shape_infos[bname].size)
            mem[bname] = torch.zeros((W * K, size), dtype=torch.float32,
                                     device=dev)
        self._state = {
            "tokens": torch.full((W, K, L), eos, dtype=torch.int32,
                                 device=dev),
            "prev": torch.full((W, K), bos, dtype=torch.int32, device=dev),
            "scores": torch.zeros((W, K), device=dev),
            # lanes that are not live read as finished, so the step
            # gives them the forced-EOS continuation
            "finished": torch.ones((W, K), dtype=torch.bool, device=dev),
            "mem": mem,
            "static": statics,
            "t": torch.zeros(W, dtype=torch.int32, device=dev),
            "active": torch.zeros(W, dtype=torch.bool, device=dev),
        }
        self._step = self.gen._make_step(W, K, L, self.hooks,
                                         per_lane_t=True)

    def _lane_sel(self, adv, new, old):
        """The step's new state on the lanes in ``adv`` [W], the old one
        elsewhere."""
        K = self.K
        sel = {"tokens": torch.where(adv[:, None, None], new["tokens"],
                                     old["tokens"])}
        for k in ("prev", "scores", "finished"):
            sel[k] = torch.where(adv[:, None], new[k], old[k])
        advf = adv.repeat_interleave(K)
        sel["mem"] = {
            b: torch.where(advf.reshape((-1,) + (1,) * (v.dim() - 1)),
                           new["mem"][b], v)
            for b, v in old["mem"].items()}
        return sel

    # ------------------------------------------------------------ lanes
    def poll(self):
        """The lane flags in one device-to-host copy: ``(active [W] bool,
        all_finished [W] bool, t [W] int)`` as numpy. The continuous
        batcher calls it once a chunk boundary."""
        s = self._state
        if s is None:
            return (np.zeros(self.width, bool), np.zeros(self.width, bool),
                    np.zeros(self.width, np.int32))
        flags = torch.stack([s["active"].to(torch.int32),
                             s["finished"].all(dim=1).to(torch.int32),
                             s["t"]]).cpu().numpy()
        return flags[0].astype(bool), flags[1].astype(bool), flags[2]

    def free_lanes(self) -> List[int]:
        active, _, _ = self.poll()
        return [i for i in range(self.width) if not active[i]]

    def active_lanes(self) -> List[int]:
        active, _, _ = self.poll()
        return [i for i in range(self.width) if active[i]]

    def finished_lanes(self) -> List[int]:
        """Live lanes whose search is over (all beams finished, or the
        lane reached max_length)."""
        active, fin, t = self.poll()
        return [i for i in range(self.width)
                if active[i] and (fin[i] or t[i] >= self.L)]

    def admit(self, lane: int, outer_outputs, row: int = 0):
        """Splice request ``row`` of the encoded ``outer_outputs`` (outer
        layer name -> Argument) into ``lane``, its clock at 0."""
        static_feed = self.gen.static_feed_from_outer(outer_outputs,
                                                      row=row)
        if self._state is None:
            self._build(static_feed)
        s, K, L = self._state, self.K, self.L
        gen = self.gen.gen
        rows = slice(lane * K, (lane + 1) * K)
        with torch.inference_mode():
            for b, a in s["static"].items():
                src = static_feed[b]
                a.value[rows] = src.value.to(a.value.dtype)
                if a.mask is not None:
                    a.mask[rows] = src.mask.to(a.mask.dtype)
            for m in self.gen.cfg.attrs["memories"]:
                bname = m["boundary"]
                dst = s["mem"][bname]
                if bname in static_feed:
                    dst[rows] = static_feed[bname].value.to(dst.dtype)
                else:
                    dst[rows] = float(m.get("init", 0.0))
            s["tokens"][lane] = gen["eos_id"]
            s["prev"][lane] = gen["bos_id"]
            # only beam 0 is live at t = 0
            s["scores"][lane] = NEG
            s["scores"][lane, 0] = 0.0
            s["finished"][lane] = False
            s["t"][lane] = 0
            s["active"][lane] = True

    def run_chunk(self) -> int:
        """Advance every live lane ``chunk`` steps; returns the chunk
        size (0 when nothing was ever admitted)."""
        if self._state is None:
            return 0
        state, L = self._state, self.L
        with torch.inference_mode():
            for _ in range(self.chunk):
                # a lane runs while it is live, short of max_length and
                # not fully finished; every other lane keeps its state
                adv = (state["active"] & (state["t"] < L)
                       & ~state["finished"].all(dim=1))
                core = {k: state[k] for k in self._CORE}
                new_core = self._step(self.params, state["static"], core,
                                      state["t"])
                merged = dict(state)
                merged.update(self._lane_sel(adv, new_core, core))
                merged["t"] = torch.where(adv, state["t"] + 1, state["t"])
                state = merged
        self._state = state
        return self.chunk

    def lane_steps(self, lane: int) -> int:
        """Decode steps a lane has run (one scalar copy)."""
        if self._state is None:
            return 0
        return int(self._state["t"][lane])

    def peek(self, lane: int):
        """(tokens [K, L], scores [K], lengths [K], steps) of a lane as
        numpy; lengths by ``generate``'s first-EOS + 1 rule."""
        s = self._state
        tokens = s["tokens"][lane].cpu().numpy()
        scores = s["scores"][lane].cpu().numpy()
        steps = int(s["t"][lane])
        is_eos = tokens == self.gen.gen["eos_id"]
        first = np.argmax(is_eos, axis=-1)
        lengths = np.where(is_eos.any(axis=-1), first + 1,
                           self.L).astype(np.int64)
        return tokens, scores, lengths, steps

    def release(self, lane: int):
        """Free a lane (after :meth:`peek`); it reads finished and
        inactive until the next :meth:`admit`."""
        with torch.inference_mode():
            self._state["active"][lane] = False
            self._state["finished"][lane] = True
