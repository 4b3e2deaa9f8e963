"""Fused optimizer-update kernels: the dense Momentum and Adam chains.

The port's counterpart of ``paddle_tpu/kernels/opt_update.py``. On the
TPU each chain is one Pallas kernel over the parameter padded to
``[rows x 128]`` tiles, and XLA compiles a step's updates into one
program. Here a step's whole list of eligible parameters is one launch of
a hand-written CUDA kernel (``csrc/opt_update.cu``: ``adam_multi_kernel``,
``momentum_multi_kernel``, no padding), whose source note gives its design
and its bound on the H100; the C entry packs the list into the kernel's
table and splits a list longer than ``table_capacity()`` into one launch
a table.

``apply_group`` is the routing point, called once a step from
``Optimizer.update`` with the step's dense updates, and routes each as the
JAX ``apply_one`` does, with one change: on the card every float32 slot
set of the parameter's shape is eligible (the port has no VMEM budget).
Non-Nesterov Momentum with slots ``{"mom"}`` and Adam with ``{"mom",
"v"}`` on CUDA tensors go to the kernel; everything else, and every CPU
tensor, takes ``opt._apply_one``, the plain version. There is no switch
and no fallback: an eligible CUDA list launches the kernel, or raises.
Every number is bit-equal, per tensor, to ``opt._apply_one``: the kernels
take its roundings in its order.

``momentum`` and ``adam`` are groups of one with the kernel's checks; they
carry the launch counts (one per grouped launch). Outputs are fresh
tensors; the inputs are untouched.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from paddle_tpu_torch.ops import build


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("opt_update")
    f, p, i = ctypes.c_float, ctypes.c_void_p, ctypes.c_int
    lib.adam_multi_update.argtypes = [p] * 5 + [i] + [f] * 5 + [i, p]
    lib.adam_multi_update.restype = i
    lib.momentum_multi_update.argtypes = [p] * 5 + [i, f, i, p]
    lib.momentum_multi_update.restype = i
    lib.opt_table_capacity.argtypes = []
    lib.opt_table_capacity.restype = i
    return lib


def table_capacity() -> int:
    """The most tensors one launch takes (``csrc/opt_update.cu``: the
    table's records that fit in the kernel parameter space); the C entry
    splits a longer list into one launch a table."""
    return _lib().opt_table_capacity()


def _check(kernel, tensors):
    like = tensors[0]
    for name, t in zip(("p", "g", "mom", "v"), tensors):
        if t.dtype != torch.float32 or not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be a contiguous float32 "
                             f"CUDA tensor, got {t.dtype} on {t.device}")
        if t.shape != like.shape or t.device != like.device:
            raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)} "
                             f"on {t.device}, p has {tuple(like.shape)} on "
                             f"{like.device}")


_SLOTS = {"adam": ("mom", "v"), "momentum": ("mom",)}


def _kind(opt):
    """"adam", "momentum" or None: the kernel that takes ``opt``'s dense
    updates."""
    name = type(opt).__name__
    if name == "Adam":
        return "adam"
    if name == "Momentum" and not opt.nesterov:
        return "momentum"
    return None


def groupable(opt, p, g, slots):
    """Whether the kernel takes this dense update on the card: ``opt``'s
    kind, its exact slot set (``prune_mask`` aside) and float32 tensors of
    ``p``'s shape (the JAX ``apply_one``'s test, with no VMEM budget)."""
    names = _SLOTS.get(_kind(opt))
    if names is None or len(slots) - ("prune_mask" in slots) != len(names) \
            or any(s not in slots for s in names):
        return False
    shape, f32 = p.shape, torch.float32
    return all(t.dtype is f32 and t.shape == shape
               for t in (p, g, *(slots[s] for s in names)))


def group_outputs(ins):
    """The outputs of a grouped launch: per tensor of ``ins`` (p, g and
    the slots) its new p and slots, fresh tensors of its p's shape (one
    ``empty_like`` each: on the host a view of a shared block costs more
    than an allocation from the caching allocator)."""
    return [[torch.empty_like(row[0]) for _ in row[1:]] for row in ins]


def launch(opt, kind, ins, outs, rates, decays):
    """The kernel over ``ins`` (per tensor p, g and the slots: contiguous
    float32 CUDA tensors of one card) into ``outs`` (per tensor p' and the
    slots'), each tensor with its own rate (Adam: the bias-corrected
    alpha) and decay: one C call on the current stream, which packs the
    list into tables and launches one grid a table. Counts the launches on
    the wrapper; raises on a launch error."""
    like = ins[0][0]
    arrays = (np.array([[x.data_ptr() for x in row] for row in ins],
                       dtype=np.int64),
              np.array([[x.data_ptr() for x in row] for row in outs],
                       dtype=np.int64),
              np.array([row[0].numel() for row in ins], dtype=np.int64),
              np.array(rates, dtype=np.float32),
              np.array(decays, dtype=np.float32))
    args = [a.ctypes.data for a in arrays] + [len(ins)]
    lib, idx, sms = _lib(), like.get_device(), build.device_sms(like)
    if kind == "adam":
        got = build.call(lib.adam_multi_update, idx, *args, opt.beta1,
                         1 - opt.beta1, opt.beta2, 1 - opt.beta2,
                         opt.epsilon, sms)
    else:
        got = build.call(lib.momentum_multi_update, idx, *args, opt.momentum,
                         sms)
    if got < 0:
        build.raise_on(-got, kind)
    (adam if kind == "adam" else momentum).launches += got


def _launch_group(opt, kind, ins, lrs, decays, t):
    """``ins`` per tensor (p, g, slots...), contiguous float32 of one
    shape: the kernel's launches; returns [(p_new, slots_new)]."""
    idx = ins[0][0].get_device()
    if any(x.get_device() != idx for row in ins for x in row):
        raise ValueError(f"{kind}: the tensors of one group lie on "
                         "different cards")
    if kind == "adam":
        alpha = {}
        rates = [alpha[lr] if lr in alpha else
                 alpha.setdefault(lr, opt.alpha(lr, t)) for lr in lrs]
    else:
        rates = lrs
    outs = group_outputs(ins)
    launch(opt, kind, ins, outs, rates, decays)
    names = _SLOTS[kind]
    return [(o[0], dict(zip(names, o[1:]))) for o in outs]


def route(opt, entries):
    """The entries (p, g, slots, lr, decay) the kernel takes: (kind, their
    indices, their tensors (p, g and the slots, contiguous))."""
    kind = _kind(opt)
    names = _SLOTS.get(kind, ())
    group, ins = [], []
    for i, (p, g, slots, _, _) in enumerate(entries):
        if p.is_cuda and groupable(opt, p, g, slots):
            group.append(i)
            ins.append([x if x.is_contiguous() else x.contiguous()
                        for x in (p, g, *(slots[s] for s in names))])
    return kind, group, ins


def apply_group(opt, entries, t):
    """A step's dense updates, ``entries`` a list of (p, g, slots, lr,
    decay), as ``[opt._apply_one(p, g, slots, lr, decay, t) for ...]``:
    every update ``groupable`` on CUDA tensors in one launch of the kernel
    per table, the rest (and every CPU tensor) by ``opt._apply_one``. The
    slot dicts may carry ``prune_mask`` (ignored here, re-attached by the
    caller)."""
    kind, group, ins = route(opt, entries)
    out = [None] * len(entries)
    if group:
        got = _launch_group(opt, kind, ins, [entries[i][3] for i in group],
                            [entries[i][4] for i in group], t)
        for i, r in zip(group, got):
            out[i] = r
    for i, (p, g, slots, lr, decay) in enumerate(entries):
        if out[i] is None:
            out[i] = opt._apply_one(p, g, slots, lr, decay, t)
    return out


def momentum(opt, p, g, slots, lr, decay):
    """``opt._apply_one`` of a non-Nesterov ``Momentum`` as a group of one:
    (p_new, {"mom": mom_new}). ``momentum.launches`` counts the kernel's
    launches (one per grouped launch)."""
    if p.device.type == "cpu":
        return opt._apply_one(p, g, slots, lr, decay, 0)
    ins = [p, g, slots["mom"]]
    _check("momentum", ins)
    return _launch_group(opt, "momentum", [ins], [lr], [decay], 0)[0]


momentum.launches = 0


def adam(opt, p, g, slots, lr, decay, t):
    """``opt._apply_one`` of ``Adam`` as a group of one: (p_new, {"mom":
    ..., "v": ...}). The bias-corrected rate is ``opt.alpha(lr, t)``,
    float32 on the host. ``adam.launches`` counts the kernel's launches
    (one per grouped launch)."""
    if p.device.type == "cpu":
        return opt._apply_one(p, g, slots, lr, decay, t)
    ins = [p, g, slots["mom"], slots["v"]]
    _check("adam", ins)
    return _launch_group(opt, "adam", [ins], [lr], [decay], t)[0]


adam.launches = 0


def apply_one(opt, p, g, slots, lr, decay, t):
    """One dense update, routed as ``paddle_tpu/kernels/opt_update.py:
    apply_one``: ``apply_group`` of one entry."""
    return apply_group(opt, [(p, g, slots, lr, decay)], t)[0]
