"""The top-1 mixture-of-experts FFN on one device: the port's copy of
``paddle_tpu/parallel/moe.py``'s ``_route``, ``_dispatch_plan`` and
``moe_ffn`` (the Switch / GShard recipe with capacity clipping).

Each token goes to its argmax expert (softmax gate); each expert holds
``capacity`` token slots, filled in token order, and a token past its
expert's capacity is dropped (a zero output). The buffers are
``[E, capacity, d]``, so the expert products are batched matmuls.
"""

from __future__ import annotations

import torch


def _route(x, wg, n_experts):
    """Top-1 routing: (expert id [B], gate [B]) with softmax gates; the
    first maximum wins a tie, as ``jnp.argmax``."""
    probs = torch.softmax(torch.matmul(x, wg), dim=-1)       # [B, E]
    eid = torch.argmax(probs, dim=-1)
    gate = torch.gather(probs, 1, eid.unsqueeze(1))[:, 0]
    return eid, gate


def _dispatch_plan(eid, n_experts, capacity, live=None):
    """Each token's slot in its expert's buffer and whether it is kept
    (under capacity). ``live`` ([B], 0/1) marks real tokens: a dead
    (padded) one claims no slot and is not kept."""
    onehot = torch.nn.functional.one_hot(eid, n_experts).to(torch.int32)
    if live is not None:
        onehot = onehot * live.to(torch.int32).unsqueeze(1)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) * onehot  # 1-based
    slot = pos.sum(dim=-1, dtype=torch.int32) - 1
    keep = (slot < capacity) & (slot >= 0)
    return slot, keep


def moe_ffn(params, x, capacity: int, live=None):
    """The MoE FFN of tokens ``x`` [B, d] with ``params`` (``wg`` [d, E],
    ``w1`` [E, d, h], ``b1`` [E, h], ``w2`` [E, h, d], ``b2`` [E, d]):
    relu(x W1 + b1) W2 + b2 of each token's expert, times its gate; zero
    for a dropped or dead token."""
    n_experts = params["wg"].shape[-1]
    eid, gate = _route(x, params["wg"], n_experts)
    slot, keep = _dispatch_plan(eid, n_experts, capacity, live)
    d = x.shape[-1]
    cslot = torch.clamp(slot, 0, capacity - 1).long()
    buf = x.new_zeros((n_experts, capacity, d))
    # kept tokens own distinct (expert, slot) pairs; dropped ones add 0
    buf = buf.index_put((eid, cslot), x * keep.unsqueeze(1).to(x.dtype),
                        accumulate=True)
    h = torch.relu(torch.matmul(buf, params["w1"]) + params["b1"][:, None])
    out_buf = torch.matmul(h, params["w2"]) + params["b2"][:, None]
    y = out_buf[eid, cslot]
    return y * (gate * keep.to(x.dtype)).unsqueeze(1)
