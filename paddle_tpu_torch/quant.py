"""Deploy-time weight quantization (the serving precision tier): the
port's copy of ``paddle_tpu/quant.py``.

``--job merge --quantize bf16|int8`` calls :func:`quantize_params` and
writes the result into the PTM1 file as the optional ``quant`` section,
with a ``golden`` section (:func:`golden_section`) beside it. The
serving predictor keeps the quantized leaves in their storage dtype on
the device (int8 weights are ``torch.int8`` tensors, bf16 weights
``torch.bfloat16``, each int8 scale an f32 tensor under ``name +
SCALE_SUFFIX``) and reads them through :func:`materialize`, a lazy
read-only mapping that dequantizes one leaf when it is read.
``Network._run_layer`` reads a layer's parameters when it runs the
layer, so only that layer's leaves exist in f32 at any moment: the
port's counterpart of XLA fusing the convert into its consumer.

Scheme (as the JAX package's):

- **bf16**: every floating leaf is cast to bfloat16 (round to nearest
  even, as ``jnp.astype``), no scales.
- **int8**: per-tensor symmetric, ``scale = max|w| / 127`` (a zero range
  pins ``scale = 1``), ``q = clip(rint(w / scale), -127, 127)``. Tables
  with sparse gradients quantize row-wise (one scale per leading row);
  1-D leaves, a sparse table of ndim < 2 and non-float leaves stay as
  they are, each named in ``meta["skipped"]`` with the JAX package's
  reason.

**Storage of bf16 leaves.** numpy has no bfloat16 of its own; the JAX
package's files hold ``ml_dtypes.bfloat16`` arrays, a package that comes
with JAX. The port writes each bf16 leaf as its 16 bits in a ``uint16``
array and marks the ``quant`` section with ``"bf16_storage":
"uint16"`` (:data:`BF16_STORAGE_KEY`), so its files load where
``ml_dtypes`` is not installed. :func:`bf16_bits` reads either form.

Host work stays in numpy, as the JAX package's does; the bf16 cast goes
through ``torch.float32 -> torch.bfloat16``.
"""

from __future__ import annotations

import logging
from collections.abc import Mapping
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger("paddle_tpu_torch.quant")

QUANT_DTYPES = ("bf16", "int8")

#: warmup-gate tolerance on the normalized max-abs output delta
#: (|quant - fp32|_max / max(1, |fp32|_max)), per storage dtype
GATE_TOLERANCES = {"bf16": 2e-2, "int8": 1e-1}

#: params-dict key suffix of an int8 leaf's scale
SCALE_SUFFIX = "::scale"

#: the ``quant`` section's marker of a port-written bf16 file: each bf16
#: leaf is a uint16 array of its bits
BF16_STORAGE_KEY = "bf16_storage"


def _is_float(arr) -> bool:
    return np.issubdtype(np.asarray(arr).dtype, np.floating)


def _is_bf16(arr) -> bool:
    """An ``ml_dtypes.bfloat16`` array (the JAX package's bf16 leaf),
    recognised without importing ``ml_dtypes``."""
    return getattr(getattr(arr, "dtype", None), "name", "") == "bfloat16"


def bf16_bits(leaf, meta: Dict) -> Optional[np.ndarray]:
    """The uint16 bits of a bf16 leaf of a quantized file: a port-written
    uint16 leaf (``meta`` marked with :data:`BF16_STORAGE_KEY`) or a
    JAX-written ``ml_dtypes.bfloat16`` array. None for any other leaf."""
    if meta.get("dtype") != "bf16":
        return None
    a = np.asarray(leaf)
    if _is_bf16(a):
        return a.view(np.uint16)
    if meta.get(BF16_STORAGE_KEY) == "uint16" and a.dtype == np.uint16:
        return a
    return None


def bf16_from_bits(bits: np.ndarray) -> torch.Tensor:
    """uint16 bits -> a ``torch.bfloat16`` tensor on the CPU."""
    return torch.from_numpy(np.array(bits, np.uint16).view(np.int16)).view(
        torch.bfloat16)


def int8_scale(w: np.ndarray, axis=None) -> np.ndarray:
    """Symmetric per-tensor (``axis=None``) or per-row scale with the
    zero-range guard: a constant or empty range pins scale = 1."""
    amax = np.max(np.abs(w), axis=axis, keepdims=axis is not None)
    amax = np.asarray(amax, np.float32)
    return np.where(amax > 0, amax / 127.0, np.float32(1.0))


def quantize_params(params: Dict[str, np.ndarray], dtype: str,
                    sparse_names: Iterable[str] = ()
                    ) -> Tuple[Dict[str, np.ndarray], Dict]:
    """-> ``(qparams, meta)``. ``meta`` is the PTM1 ``quant`` section:
    ``{"dtype", "scales": {name: np f32}, "skipped": {name: reason},
    "tol"}``, and for bf16 the :data:`BF16_STORAGE_KEY` marker.
    ``sparse_names`` (``ParamSpec.sparse_grad``) selects row-wise int8
    scales."""
    if dtype not in QUANT_DTYPES:
        raise ValueError(f"--quantize must be one of {QUANT_DTYPES}, "
                         f"got {dtype!r}")
    sparse = set(sparse_names)
    qparams: Dict[str, np.ndarray] = {}
    scales: Dict[str, np.ndarray] = {}
    skipped: Dict[str, str] = {}
    for name, v in params.items():
        w = np.asarray(v)
        if not _is_float(w):
            qparams[name] = w
            skipped[name] = f"non-float dtype {w.dtype}"
            continue
        if dtype == "bf16":
            b = torch.from_numpy(np.ascontiguousarray(w, np.float32)).to(
                torch.bfloat16)
            qparams[name] = b.view(torch.int16).numpy().view(np.uint16)
            continue
        if w.ndim < 2:
            qparams[name] = np.asarray(w, np.float32)
            skipped[name] = (
                "sparse table with ndim < 2: row-wise int8 scales are "
                "not expressible, kept f32" if name in sparse else
                "1-D leaf (bias/norm) kept f32: per-element rounding "
                "would shift every logit")
            if name in sparse:
                logger.warning("quantize: %s STOOD DOWN to f32 (%s)",
                               name, skipped[name])
            continue
        axis = tuple(range(1, w.ndim)) if name in sparse else None
        s = int8_scale(w.astype(np.float32), axis=axis)
        q = np.clip(np.rint(w.astype(np.float32) / s), -127, 127)
        qparams[name] = q.astype(np.int8)
        scales[name] = np.asarray(s, np.float32)
    meta = {"dtype": dtype, "scales": scales, "skipped": skipped,
            "tol": GATE_TOLERANCES[dtype]}
    if dtype == "bf16":
        meta[BF16_STORAGE_KEY] = "uint16"
    return qparams, meta


def scale_leaves(meta: Dict) -> Dict[str, np.ndarray]:
    """The scales keyed for the predictor's params dict (``name +
    SCALE_SUFFIX``). Empty for bf16."""
    return {name + SCALE_SUFFIX: s
            for name, s in meta.get("scales", {}).items()}


class DequantView(Mapping):
    """The f32 view of a storage-dtype parameter table, read-only and
    lazy: ``view[name]`` dequantizes that one leaf when it is read (an
    int8 leaf against its ``name::scale`` sibling, a bf16 leaf upcast, an
    f32 leaf passed through) and keeps nothing. The scale keys are not
    part of the view."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        self._params = params

    def __getitem__(self, name: str) -> torch.Tensor:
        if name.endswith(SCALE_SUFFIX):
            raise KeyError(name)
        leaf = self._params[name]
        scale = self._params.get(name + SCALE_SUFFIX)
        if scale is not None:
            return leaf.to(torch.float32) * scale
        if leaf.is_floating_point() and leaf.dtype != torch.float32:
            return leaf.to(torch.float32)
        return leaf

    def __iter__(self) -> Iterator[str]:
        return (k for k in self._params if not k.endswith(SCALE_SUFFIX))

    def __len__(self) -> int:
        return sum(1 for _ in self)


def materialize(params: Dict[str, torch.Tensor]) -> DequantView:
    """The lazy f32 view of a quantized params dict (storage-dtype
    tensors and their ``name::scale`` f32 scales): :class:`DequantView`.
    JAX's ``materialize(params, meta)`` also takes the quant section;
    the storage dtypes and scale keys carry all the view needs."""
    return DequantView(params)


def dequantize_params(qparams: Dict[str, np.ndarray],
                      meta: Dict) -> Dict[str, np.ndarray]:
    """Host-side eager dequant (tests, offline tooling): the arithmetic
    of :func:`materialize`, on numpy."""
    out = {}
    scales = meta.get("scales", {})
    for name, v in qparams.items():
        bits = bf16_bits(v, meta)
        if bits is not None:
            out[name] = bf16_from_bits(bits).to(torch.float32).numpy()
            continue
        w = np.asarray(v)
        if name in scales:
            out[name] = w.astype(np.float32) * np.asarray(scales[name],
                                                          np.float32)
        elif _is_float(w):
            out[name] = w.astype(np.float32)
        else:
            out[name] = w
    return out


# ------------------------------------------------------------- golden set
def make_golden_rows(feeding: Dict, n: int = 4, length: int = 4,
                     seed: int = 7) -> List[tuple]:
    """A deterministic pseudo-random golden-request set shaped like real
    traffic for every input slot, in the JAX package's draw order (so its
    rows equal JAX's for the same feeding)."""
    from paddle_tpu_torch.data import types as T
    rng = np.random.RandomState(seed)
    rows: List[tuple] = []
    for _ in range(n):
        row = []
        for name in feeding:
            itype = feeding[name]
            if itype.seq_type == T.SUB_SEQUENCE:
                raise ValueError(
                    f"golden set: input {name!r} is a nested sequence; "
                    "serving refuses SUB_SEQUENCE inputs, so a "
                    "quantized artifact cannot gate on one")
            steps = length if itype.seq_type == T.SEQUENCE else None

            def one():
                if itype.type == T.INDEX:
                    return int(rng.randint(itype.dim))
                if itype.type in (T.SPARSE_BINARY, T.SPARSE_FLOAT):
                    k = min(2, itype.dim)
                    ids = sorted(rng.choice(itype.dim, size=k,
                                            replace=False).tolist())
                    if itype.type == T.SPARSE_FLOAT:
                        return list(zip(
                            ids, rng.rand(k).astype(float).tolist()))
                    return ids
                return rng.randn(itype.dim).astype(np.float32)

            row.append([one() for _ in range(steps)]
                       if steps is not None else one())
        rows.append(tuple(row))
    return rows


def golden_section(graph, params: Dict, output_names: List[str],
                   feeding: Dict, n: int = 4) -> Optional[Dict]:
    """The PTM1 ``golden`` section: rows and their fp32 reference
    outputs, computed on the unquantized ``params`` (arrays or tensors)
    through the plain feed path on the CPU. None, with a named warning,
    for a generation-only config: the gate covers score outputs."""
    from paddle_tpu_torch.core.network import Network
    from paddle_tpu_torch.data.feeder import DataFeeder
    score = [name for name in output_names
             if graph.layers[name].type != "beam_search_group"]
    if not score:
        logger.warning(
            "quantize: config has no scoring outputs (generation-only)"
            " — no golden gate set recorded; the warmup gate will "
            "stand down with a named warning")
        return None
    rows = make_golden_rows(feeding, n=n)
    feed = DataFeeder(feeding, device="cpu")(list(rows))
    net = Network(graph, outputs=score)
    cpu = {k: (v.detach().cpu() if isinstance(v, torch.Tensor)
              else torch.from_numpy(np.array(v)))
           for k, v in params.items() if k in net.param_specs}
    with torch.no_grad():
        outs = net.apply(cpu, feed, train=False)
    refs = {name: outs[name].value.numpy() for name in score}
    return {"rows": rows, "outputs": refs, "n": n}


def gate_delta(got: np.ndarray, ref: np.ndarray) -> float:
    """Normalized max-abs output delta the warmup gate compares against
    the per-dtype tolerance."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref))
                 / max(1.0, float(np.max(np.abs(ref)))))
