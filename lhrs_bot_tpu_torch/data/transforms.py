"""Host-side image preprocessing to uint8, in numpy (no PIL).

Counterpart of `lhrs_bot_tpu/data/transforms.py`: the CLIP geometry
(shortest edge resized bicubically to `size`, then the center crop) and the
non-ViT eval geometry (a square resize, then the center crop). The
normalization runs on the card, in the patch embedding.

The resize is Pillow's `ImagingResample` for 8-bit images, step for step,
so the result equals the JAX package's PIL output byte for byte: two
passes, horizontal first, each row or column a weighted sum of the source
pixels with coefficients in 22-bit fixed point, rounded to uint8 between
the passes. Per output pixel i of a pass, with scale = in / out and
filterscale = max(scale, 1): center = (i + 0.5) * scale; the taps run from
xmin = int(center - support + 0.5) (support = 2 * filterscale, clamped to
the image) to int(center + support + 0.5); tap x weighs
bicubic((x + xmin - center + 0.5) / filterscale), the weights are
normalized to sum to one, then scaled by 2^22 and rounded half away from
zero; a pixel is (2^21 + sum of value x weight) >> 22, clipped to [0, 255].
`native/lhrs_host.cc` documents the same scheme.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_PRECISION_BITS = 22  # Pillow's 32 - 8 - 2
_BICUBIC_A = -0.5
_BICUBIC_SUPPORT = 2.0


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic_filter (a = -0.5), in its order of operations."""
    a = _BICUBIC_A
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(xmin (out,), int32 weights (out, ksize)) of Pillow's
    precompute_coeffs + normalize_coeffs_8bpc; taps past a row's xmax
    weigh 0."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = _BICUBIC_SUPPORT * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    taps = np.arange(ksize)
    w = _bicubic(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5)
                 * (1.0 / filterscale))
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for x in range(ksize):  # summed in the C loop's order
        ww = ww + w[:, x]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None],
                 w)
    fixed = w * (1 << _PRECISION_BITS)
    fixed = np.where(w < 0, np.trunc(-0.5 + fixed), np.trunc(0.5 + fixed))
    return xmin, fixed.astype(np.int32)


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's 8-bpc resample along `axis` (1 horizontal,
    0 vertical) of an (H, W, C) uint8 array."""
    in_size = img.shape[axis]
    xmin, k = _coeffs(in_size, out_size)
    src = img.astype(np.int32)  # Pillow sums in INT32 too
    shape = [1, 1, 1]
    shape[axis] = out_size
    acc = np.zeros(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                   np.int32)
    for x in range(k.shape[1]):  # one tap at a time: integer sums
        idx = np.minimum(xmin + x, in_size - 1)  # taps past xmax weigh 0
        acc += np.take(src, idx, axis=axis) * k[:, x].reshape(shape)
    acc = (acc + (1 << (_PRECISION_BITS - 1))) >> _PRECISION_BITS
    return np.clip(acc, 0, 255).astype(np.uint8)


def resize_bicubic(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """(H, W, C) uint8 -> (new_h, new_w, C) uint8 as Pillow's
    `Image.resize((new_w, new_h), Image.BICUBIC)`; `size` is (w, h) as
    PIL takes it. A pass whose size does not change is skipped, as
    Pillow skips it."""
    new_w, new_h = size
    if new_w < 1 or new_h < 1:
        raise ValueError(f"resize to {size}: sizes must be positive")
    out = img
    if new_w != img.shape[1]:
        out = _resample_axis(out, new_w, axis=1)
    if new_h != img.shape[0]:
        out = _resample_axis(out, new_h, axis=0)
    return out


def _as_rgb(image) -> np.ndarray:
    """An (H, W) gray or (H, W, 3 | 4) uint8 array as (H, W, 3), as
    PIL's `Image.fromarray(a).convert("RGB")` gives it (alpha dropped)."""
    a = np.asarray(image)
    if a.dtype != np.uint8:
        raise ValueError(f"images must be uint8, got {a.dtype}")
    if a.ndim == 2:
        return np.repeat(a[:, :, None], 3, axis=2)
    if a.ndim == 3 and a.shape[2] in (3, 4):
        return np.ascontiguousarray(a[:, :, :3])
    raise ValueError(f"image of shape {a.shape}: expected (H, W) or "
                     "(H, W, 3 | 4)")


def _crop(img: np.ndarray, left: int, top: int, w: int, h: int
          ) -> np.ndarray:
    """PIL's crop((left, top, left + w, top + h)): zeros outside."""
    out = np.zeros((h, w, img.shape[2]), np.uint8)
    y0, x0 = max(top, 0), max(left, 0)
    y1, x1 = min(top + h, img.shape[0]), min(left + w, img.shape[1])
    if y1 > y0 and x1 > x0:
        out[y0 - top:y1 - top, x0 - left:x1 - left] = img[y0:y1, x0:x1]
    return out


def clip_preprocess_uint8(image, size: int = 224) -> np.ndarray:
    """An image array -> (size, size, 3) uint8: shortest edge resized
    bicubically to `size` (each side `round(side * size / short)`, half to
    even as Python rounds), then the center crop."""
    img = _as_rgb(image)
    h, w = img.shape[:2]
    scale = size / min(w, h)
    new_w, new_h = round(w * scale), round(h * scale)
    img = resize_bicubic(img, (new_w, new_h))
    return _crop(img, (new_w - size) // 2, (new_h - size) // 2, size, size)


def eval_resize_crop_uint8(image, resize: int = 256,
                           crop: int = 224) -> np.ndarray:
    """Non-ViT eval geometry: Resize((resize, resize)) -> CenterCrop(crop)."""
    img = resize_bicubic(_as_rgb(image), (resize, resize))
    left = (resize - crop) // 2
    return _crop(img, left, left, crop, crop)
