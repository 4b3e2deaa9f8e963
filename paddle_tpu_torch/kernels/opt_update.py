"""Fused optimizer-update kernels: the dense Momentum and Adam chains.

The port's counterpart of ``paddle_tpu/kernels/opt_update.py``. On the
TPU each chain is one Pallas kernel over the parameter padded to
``[rows x 128]`` tiles; here it is a hand-written CUDA kernel over the
flat tensor (``csrc/opt_update.cu``, no padding), whose source note gives
its design and its bound on the H100.

``apply_one`` is the single routing point, called from
``Optimizer._update_param``'s dense branch, and routes as the JAX
``apply_one`` does, with one change: on the card every float32 slot set of
the parameter's shape is eligible (the port has no VMEM budget). Non-
Nesterov Momentum with slots ``{"mom"}`` takes ``momentum``, Adam with
``{"mom", "v"}`` takes ``adam``; everything else, and every CPU tensor,
takes ``opt._apply_one``. There is no switch and no fallback: an
eligible CUDA slot set launches the kernel, or raises.

The two wrappers take the optimizer itself: on a CPU tensor their plain
version IS ``opt._apply_one``, so the card checks hold the kernel against
exactly the chain the CPU tests hold against JAX. Outputs are fresh
tensors (the kernel could also update in place; the trainer drops the old
ones, and no autograd graph holds them by then).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from paddle_tpu_torch.ops import build


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("opt_update")
    f, p = ctypes.c_float, ctypes.c_void_p
    lib.momentum_update.argtypes = [p] * 5 + [f] * 3 + [ctypes.c_longlong, p]
    lib.momentum_update.restype = ctypes.c_int
    lib.adam_update.argtypes = [p] * 7 + [f] * 7 + [ctypes.c_longlong, p]
    lib.adam_update.restype = ctypes.c_int
    return lib


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


def _launch(kernel, entry, ins, n_out, scalars):
    _check(kernel, ins)
    outs = [torch.empty_like(ins[0]) for _ in range(n_out)]
    with torch.cuda.device(ins[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_lib(), entry)(
            *(t.data_ptr() for t in ins + outs), *scalars, ins[0].numel(),
            stream)
    if err != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with CUDA error "
                           f"{err}")
    return outs


def momentum(opt, p, g, slots, lr, decay):
    """``opt._apply_one`` of a non-Nesterov ``Momentum`` as one kernel:
    (p_new, {"mom": mom_new}). ``momentum.launches`` counts launches."""
    if p.device.type == "cpu":
        return opt._apply_one(p, g, slots, lr, decay, 0)
    p_new, m_new = _launch("momentum", "momentum_update",
                           [p, g, slots["mom"]], 2,
                           (lr, decay, opt.momentum))
    momentum.launches += 1
    return p_new, {"mom": m_new}


momentum.launches = 0


def adam(opt, p, g, slots, lr, decay, t):
    """``opt._apply_one`` of ``Adam`` as one kernel: (p_new, {"mom": ...,
    "v": ...}). The bias-corrected rate is ``opt.alpha(lr, t)``, float32
    on the host. ``adam.launches`` counts launches."""
    if p.device.type == "cpu":
        return opt._apply_one(p, g, slots, lr, decay, t)
    p_new, m_new, v_new = _launch(
        "adam", "adam_update", [p, g, slots["mom"], slots["v"]], 3,
        (opt.alpha(lr, t), decay, opt.beta1, 1 - opt.beta1, opt.beta2,
         1 - opt.beta2, opt.epsilon))
    adam.launches += 1
    return p_new, {"mom": m_new, "v": v_new}


adam.launches = 0


def _eligible(p, *slots):
    return all(t.dtype == torch.float32 and t.shape == p.shape
               for t in (p, *slots))


def apply_one(opt, p, g, slots, lr, decay, t):
    """Fused stand-in for ``opt._apply_one`` on the dense path, routed as
    ``paddle_tpu/kernels/opt_update.py:apply_one``. The slot dict may carry
    ``prune_mask`` (ignored here, re-attached by ``_update_param``)."""
    if p.device.type == "cpu":
        return opt._apply_one(p, g, slots, lr, decay, t)
    kind = type(opt).__name__
    keys = set(slots) - {"prune_mask"}
    if (kind == "Momentum" and not opt.nesterov and keys == {"mom"}
            and _eligible(p, g, slots["mom"])):
        return momentum(opt, p.contiguous(), g.contiguous(),
                        {"mom": slots["mom"].contiguous()}, lr, decay)
    if kind == "Adam" and keys == {"mom", "v"} and _eligible(
            p, g, slots["mom"], slots["v"]):
        return adam(opt, p.contiguous(), g.contiguous(),
                    {"mom": slots["mom"].contiguous(),
                     "v": slots["v"].contiguous()}, lr, decay, t)
    return opt._apply_one(p, g, slots, lr, decay, t)
