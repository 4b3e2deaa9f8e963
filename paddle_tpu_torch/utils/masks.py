"""Mask dtype invariant: the port of ``paddle_tpu/utils/masks.py``.

Masks are f32 count data: they are summed for token counts, per-row
lengths and batch denominators, where bfloat16's 8-bit mantissa saturates
at 256 (a silently wrong denominator, not an error). ``assert_mask_f32``
is called where masks enter compute (``trainer/trainer.py:_cast_compute``)
and raises before a step runs with a saturating mask.
"""

from __future__ import annotations

from typing import Any


class MaskDtypeError(RuntimeError):
    """A mask tensor is not float32 (the count-data invariant).

    Not a TypeError or ValueError: the serving batcher answers those as
    a bad request, and a sub-f32 mask is a server fault (the feeder built
    it)."""


# "never below f32": float64, int and bool masks carry full count
# precision and pass; only the mantissa-losing float dtypes fail
_SUB_F32 = {"bfloat16", "float16", "half"}


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def assert_mask_f32(mask: Any, where: str = "mask") -> Any:
    """Validate (and return) a mask leaf (a tensor or an array): reject
    the sub-f32 float dtypes. ``None`` passes (dense inputs have no
    mask)."""
    if mask is None:
        return None
    dtype = getattr(mask, "dtype", None)
    if dtype is None:
        return mask  # python scalars and lists: the feeder normalizes
    if _dtype_name(dtype) in _SUB_F32:
        raise MaskDtypeError(
            f"{where}: mask dtype {_dtype_name(dtype)}: masks are f32 "
            "count data (summed for lengths and denominators; bf16 "
            "saturates at 256) and must never be cast below float32")
    return mask


def assert_feed_masks_f32(feed: Any, where: str = "feed") -> Any:
    """Validate every ``Argument.mask`` of a feed dict, recursing into
    Argument state as ``_cast_compute`` does; returns the feed."""
    from paddle_tpu_torch.core.argument import Argument

    def go(name: str, x):
        if isinstance(x, Argument):
            assert_mask_f32(x.mask, f"{where}[{name}].mask")
            if isinstance(x.state, dict):
                for k, v in x.state.items():
                    go(f"{name}.state[{k}]", v)
    if isinstance(feed, dict):
        for name, x in feed.items():
            go(str(name), x)
    return feed
