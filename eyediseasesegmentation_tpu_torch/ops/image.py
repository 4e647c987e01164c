"""Image primitives on torch tensors, in the JAX package's channel-last layout.

Counterpart of ``eyediseasesegmentation_tpu/ops/image.py``: resize / pad /
crop, normalization, the D4 view family, and the augmentation ops of the
policies (the distortions and CLAHE of ``easy``, ``easy_v2`` and
``medium`` too) and Ben Graham's colour stage. Images are
(..., H, W, C), so a batch (N, H, W, C) goes through in one call where the
JAX package vmaps; a map without channels gets a trailing axis of 1.

Each augmentation op is split in two: a ``draw_*`` that draws its scalars
(Python floats, from a CPU ``torch.Generator``, so drawing never waits for
the device) or its noise field (on the image's device, from a generator
there), and an ``apply_*`` that takes the drawn values. JAX's PRNG streams
cannot be reproduced in torch, so the parity tests feed the values a JAX
key draws to the ``apply_*`` functions.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


_H, _W = -3, -2


def longest_max_size_shape(h: int, w: int, max_size: int) -> Tuple[int, int]:
    """Static output shape of albumentations.LongestMaxSize (Python ``round``:
    halves go to the even neighbour, as in the JAX package)."""
    scale = max_size / max(h, w)
    return max(1, round(h * scale)), max(1, round(w * scale))


def _nearest_index(n_out: int, n_in: int, device) -> torch.Tensor:
    """``jax.image.resize``'s nearest source index: floor((i + 0.5)·in/out)
    in fp32."""
    i = torch.arange(n_out, dtype=torch.float32, device=device)
    return torch.floor((i + 0.5) * n_in / n_out).long()


def resize(img: torch.Tensor, out_hw: Tuple[int, int],
           method: str = "linear") -> torch.Tensor:
    """Bilinear resize at half-pixel centres with no antialias prefilter
    (cv2.INTER_LINEAR, ``jax.image.resize(..., antialias=False)``), or
    ``method="nearest"`` with ``jax.image.resize``'s nearest indices."""
    if tuple(img.shape[-3:-1]) == tuple(out_hw):
        return img
    if method == "nearest":
        h, w = img.shape[_H], img.shape[_W]
        iy = _nearest_index(out_hw[0], h, img.device)
        ix = _nearest_index(out_hw[1], w, img.device)
        return img.index_select(img.ndim + _H, iy).index_select(
            img.ndim + _W, ix)
    x = img.reshape((-1,) + tuple(img.shape[-3:])).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1).reshape(
        img.shape[:-3] + tuple(out_hw) + img.shape[-1:])


def pad_to(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Centre-pad with zeros to ``out_hw`` (PadIfNeeded, constant border);
    the top pad is ``ph // 2``."""
    h, w = img.shape[_H], img.shape[_W]
    ph, pw = out_hw[0] - h, out_hw[1] - w
    if ph == 0 and pw == 0:
        return img
    top, left = ph // 2, pw // 2
    out = img.new_zeros(img.shape[:-3] + tuple(out_hw) + img.shape[-1:])
    out[..., top:top + h, left:left + w, :] = img
    return out


def longest_max_size_pad(img: torch.Tensor, size: int,
                         method: str = "linear") -> torch.Tensor:
    """LongestMaxSize(size) then centre PadIfNeeded(size, size)."""
    nh, nw = longest_max_size_shape(img.shape[_H], img.shape[_W], size)
    return pad_to(resize(img, (nh, nw), method), (size, size))


def center_crop(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Centre crop (the inverse of the eval-time pad)."""
    top = (img.shape[_H] - out_hw[0]) // 2
    left = (img.shape[_W] - out_hw[1]) // 2
    return img[..., top:top + out_hw[0], left:left + out_hw[1], :]


LUMA = (0.2989, 0.5870, 0.1140)


def rgb_to_gray(img: torch.Tensor, keep_channels: bool = True) -> torch.Tensor:
    """Luma grayscale of the first three channels."""
    luma = torch.tensor(LUMA, dtype=img.dtype, device=img.device)
    g = (img[..., :3] * luma).sum(-1)
    return g[..., None] if keep_channels else g


def normalize(img: torch.Tensor, mean, std) -> torch.Tensor:
    """x/255 - mean, then /std, over the channel axis."""
    mean = torch.as_tensor(mean, dtype=torch.float32, device=img.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=img.device)
    return (img / 255.0 - mean) / std


def gaussian_kernel_1d(sigma: float, radius: int, device=None) -> torch.Tensor:
    """The normalised fp32 Gaussian taps at -radius..radius."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def gaussian_blur(img: torch.Tensor, sigma: float,
                  radius: Optional[int] = None) -> torch.Tensor:
    """Separable Gaussian blur of an (..., H, W, C) image: radius
    ``round(4σ)`` (at least 1) cut to ``min(·, H − 1, W − 1)``, a reflect-101
    border (cv2's default), then the depthwise taps along H, then along W."""
    if radius is None:
        radius = max(1, int(round(4.0 * sigma)))
    h, w, c = img.shape[_H], img.shape[_W], img.shape[-1]
    radius = min(radius, h - 1, w - 1)      # a reflect pad must be < size
    k = gaussian_kernel_1d(sigma, radius, img.device).to(img.dtype)
    x = img.reshape((-1, h, w, c)).permute(0, 3, 1, 2)
    x = F.pad(x, (radius, radius, radius, radius), mode="reflect")
    x = F.conv2d(x, k.view(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
    x = F.conv2d(x, k.view(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)
    return x.permute(0, 2, 3, 1).reshape(img.shape)


def ben_color_device(img: torch.Tensor, sigma: float = 10.0) -> torch.Tensor:
    """Ben Graham's colour enhancement, the addWeighted stage only
    (data_transform.py:199-203): 4·img − 4·blur(img) + 128, clipped to
    [0, 255]. The gray crop before it is host work (a shape that depends
    on the data)."""
    out = 4.0 * img - 4.0 * gaussian_blur(img, sigma) + 128.0
    return torch.clamp(out, 0.0, 255.0)


def binarize_mask(mask: torch.Tensor, thresh: float = 50.0) -> torch.Tensor:
    """Mask binarisation ``point(x > 50 → 255)`` as {0, 1} fp32
    (lesion_dataset.py:54-58)."""
    return (mask > thresh).to(torch.float32)


# ---------------------------------------------------------------------------
# D4 views (TTA geometry)
# ---------------------------------------------------------------------------

def hflip(img: torch.Tensor) -> torch.Tensor:
    return img.flip(_W)


def vflip(img: torch.Tensor) -> torch.Tensor:
    return img.flip(_H)


def rot90(img: torch.Tensor, k: int) -> torch.Tensor:
    """Rotate by k·90° in the HW plane, the same way as ``jnp.rot90``."""
    return torch.rot90(img, k, dims=(_H, _W))


def d4_views(img: torch.Tensor) -> torch.Tensor:
    """The 8 dihedral views stacked on a new leading axis, flip-major then k.
    Input (..., H, W, C) with H == W; output (8, ..., H, W, C)."""
    views = []
    for flip in (False, True):
        base = hflip(img) if flip else img
        for k in range(4):
            views.append(rot90(base, k))
    return torch.stack(views, 0)


def d4_inverse(views: torch.Tensor) -> torch.Tensor:
    """Invert :func:`d4_views` on predictions: (8, ..., H, W, C) → aligned."""
    out = []
    i = 0
    for flip in (False, True):
        for k in range(4):
            v = rot90(views[i], -k)
            if flip:
                v = hflip(v)
            out.append(v)
            i += 1
    return torch.stack(out, 0)


# ---------------------------------------------------------------------------
# Train-time augmentation: draws and applies
# ---------------------------------------------------------------------------

def uniform(gen: torch.Generator, lo: float, hi: float) -> float:
    """U(lo, hi) as a Python float (an fp32 value) from a CPU
    generator."""
    u = torch.rand((), generator=gen).item()
    return float(np.float32(u) * np.float32(hi - lo) + np.float32(lo))


def randint(gen: torch.Generator, lo: int, hi: int) -> int:
    """A uniform integer in [lo, hi) from a CPU generator."""
    return int(torch.randint(lo, hi, (), generator=gen).item())


def _clip(img: torch.Tensor) -> torch.Tensor:
    return torch.clamp(img, 0.0, 255.0)


def draw_brightness(gen, limit: float = 0.2) -> float:
    return uniform(gen, -limit, limit)


def apply_brightness(img, alpha: float):
    """albumentations RandomBrightness: img · (1 + alpha)."""
    return _clip(img * (1.0 + alpha))


def draw_contrast(gen, limit: float = 0.2) -> float:
    return float(np.float32(1.0) + np.float32(uniform(gen, -limit, limit)))


def apply_contrast(img, alpha: float):
    """albumentations RandomContrast: mean-preserving scale by ``alpha``
    about the mean luma (the mean value for other channel counts)."""
    mean = (rgb_to_gray(img, keep_channels=False).mean()
            if img.shape[-1] == 3 else img.mean())
    return _clip(img * alpha + mean * (1.0 - alpha))


def draw_gamma(gen, gamma_limit=(0.8, 1.2)) -> float:
    return uniform(gen, gamma_limit[0], gamma_limit[1])


def apply_gamma(img, gamma: float):
    """albumentations RandomGamma."""
    return _clip(((img / 255.0) ** gamma) * 255.0)


def draw_gauss_noise(gen, shape, noise_gen: Optional[torch.Generator] = None,
                     device=None, var_limit=(10.0, 50.0)):
    """(variance, unit normal field of ``shape`` on ``device`` drawn from
    ``noise_gen``)."""
    var = uniform(gen, var_limit[0], var_limit[1])
    return var, torch.randn(shape, generator=noise_gen, device=device)


def apply_gauss_noise(img, var: float, z: torch.Tensor):
    """albumentations GaussNoise: img + N(0, var)."""
    return _clip(img + z * math.sqrt(var))


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def warp_bilinear(img: torch.Tensor, coords_y: torch.Tensor,
                  coords_x: torch.Tensor, order: int = 1) -> torch.Tensor:
    """Sample an HW(C) image at float coordinates (H', W') with edge clamp:
    bilinear (``order=1``) or nearest, halves rounded away from zero
    (``order=0``), term for term as ``jax.scipy.ndimage.map_coordinates``
    with ``mode="nearest"``."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w = img.shape[0], img.shape[1]

    def nodes(c):
        if order == 0:
            return [(_round_half_away(c).long(), None)]
        lower = torch.floor(c)
        up = c - lower
        return [(lower.long(), 1.0 - up), (lower.long() + 1, up)]

    out = None
    for iy, wy in nodes(coords_y):
        for ix, wx in nodes(coords_x):
            v = img[iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
            if wy is not None:
                v = (wy * wx)[..., None] * v
            out = v if out is None else out + v
    return out[..., 0] if squeeze else out


def draw_shift_scale_rotate(gen, h: int, w: int, shift_limit=0.0625,
                            scale_limit=0.1, rotate_limit=45.0):
    """(angle in radians, scale, dy, dx in pixels): albumentations
    ShiftScaleRotate defaults (±45°, ±10 %, ±6.25 %), each computed in fp32
    from its uniform draw, as the JAX op computes it."""
    f32 = np.float32
    angle = f32(uniform(gen, -rotate_limit, rotate_limit)) * f32(
        math.pi) / f32(180.0)
    scale = f32(1.0) + f32(uniform(gen, -scale_limit, scale_limit))
    dy = f32(uniform(gen, -shift_limit, shift_limit)) * f32(h)
    dx = f32(uniform(gen, -shift_limit, shift_limit)) * f32(w)
    return float(angle), float(scale), float(dy), float(dx)


def apply_shift_scale_rotate(img, mask, angle: float, scale: float,
                             dy: float, dx: float):
    """Rotate by ``angle`` and scale about the centre, then shift, by the
    inverse map output → input; the image bilinear, the mask (if any)
    nearest."""
    h, w = img.shape[0], img.shape[1]
    f32 = dict(dtype=torch.float32, device=img.device)
    gy = torch.arange(h, **f32)[:, None].expand(h, w)
    gx = torch.arange(w, **f32)[None, :].expand(h, w)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    a = torch.tensor(angle, **f32)
    cos, sin = torch.cos(a), torch.sin(a)
    oy = gy - cy - torch.tensor(dy, **f32)
    ox = gx - cx - torch.tensor(dx, **f32)
    s = torch.tensor(scale, **f32)
    sy = (cos * oy - sin * ox) / s + cy
    sx = (sin * oy + cos * ox) / s + cx
    out = warp_bilinear(img, sy, sx)
    if mask is None:
        return out
    return out, warp_bilinear(mask, sy, sx, order=0)


def draw_random_scale(gen, scale_limit=(0.5, 2.0)) -> float:
    """The zoom factor of RandomScale, U(scale_limit)."""
    return uniform(gen, scale_limit[0], scale_limit[1])


def apply_random_scale(img, mask, scale: float):
    """RandomScale (the vessel policy, data_transform.py:141) as a
    scale-about-centre warp at the input's shape, by the inverse map
    output → input; the image bilinear, the mask (if any) nearest."""
    h, w = img.shape[0], img.shape[1]
    f32 = dict(dtype=torch.float32, device=img.device)
    gy = torch.arange(h, **f32)[:, None].expand(h, w)
    gx = torch.arange(w, **f32)[None, :].expand(h, w)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    s = torch.tensor(scale, **f32)
    sy = (gy - cy) / s + cy
    sx = (gx - cx) / s + cx
    out = warp_bilinear(img, sy, sx)
    if mask is None:
        return out
    return out, warp_bilinear(mask, sy, sx, order=0)


def _grid(h: int, w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.arange(h, **f32)[:, None].expand(h, w),
            torch.arange(w, **f32)[None, :].expand(h, w))


def _warp_pair(img, mask, sy, sx):
    out = warp_bilinear(img, sy, sx)
    if mask is None:
        return out
    return out, warp_bilinear(mask, sy, sx, order=0)


def draw_elastic(noise_gen: Optional[torch.Generator], h: int, w: int,
                 device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two U(−1, 1) displacement fields (H, W, 1) of the elastic
    transform, drawn on ``device`` from ``noise_gen``."""
    def field():
        u = torch.rand((h, w, 1), generator=noise_gen, device=device)
        return u * 2.0 - 1.0
    return field(), field()


def apply_elastic(img, mask, field_y: torch.Tensor, field_x: torch.Tensor,
                  alpha: float = 120.0, sigma: float = 6.0):
    """Elastic deformation (Simard et al.): each field blurred by σ and
    scaled by α/σ is the displacement of the sampling grid; the image
    bilinear, the mask (if any) nearest."""
    h, w = img.shape[0], img.shape[1]
    dy = gaussian_blur(field_y, sigma)[..., 0] * alpha / sigma
    dx = gaussian_blur(field_x, sigma)[..., 0] * alpha / sigma
    gy, gx = _grid(h, w, img.device)
    return _warp_pair(img, mask, gy + dy, gx + dx)


def draw_grid_distortion(gen, num_steps: int = 5, distort_limit: float = 0.3
                         ) -> Tuple[List[float], List[float]]:
    """The per-cell step scales 1 + U(±limit) of GridDistortion: first the
    ``num_steps + 1`` along H, then along W, each in fp32."""
    def axis():
        return [float(np.float32(1.0) + np.float32(
            uniform(gen, -distort_limit, distort_limit)))
            for _ in range(num_steps + 1)]
    return axis(), axis()


def _linspace(stop: float, n: int, device) -> torch.Tensor:
    """``jnp.linspace(0, stop, n)`` in fp32: node i is stop·(i / (n − 1)),
    the last node ``stop`` itself (XLA rounds some nodes up to two ulps
    apart)."""
    t = torch.arange(n - 1, dtype=torch.float32, device=device) / (n - 1)
    return torch.cat([stop * t, torch.full((1,), stop, dtype=torch.float32,
                                           device=device)])


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor
           ) -> torch.Tensor:
    """``jnp.interp``: piecewise-linear through (xp, fp), xp increasing,
    the end values outside."""
    i = torch.searchsorted(xp, x, right=True).clamp(1, xp.numel() - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    tiny = float(np.spacing(np.finfo(np.float32).eps))
    flat = dx.abs() <= tiny
    f = torch.where(flat, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(flat, torch.ones_like(dx),
                                                     dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _grid_axis_map(steps: Sequence[float], size: int, device) -> torch.Tensor:
    """One axis of GridDistortion: the nodes moved by the scaled cells and
    renormalised to the full extent, inverted by ``interp``."""
    n = len(steps) - 1
    scaled = torch.tensor(steps, dtype=torch.float32, device=device) * (size // n)
    pos = torch.cat([torch.zeros(1, device=device), torch.cumsum(scaled, 0)])
    pos = pos / pos[-1] * (size - 1)
    src = _linspace(float(size - 1), n + 2, device)
    return interp(torch.arange(size, dtype=torch.float32, device=device),
                  pos, src)


def apply_grid_distortion(img, mask, steps_y: Sequence[float],
                          steps_x: Sequence[float]):
    """albumentations GridDistortion with the drawn step scales, by the
    inverse map per axis; the image bilinear, the mask (if any) nearest.
    The two axis maps (H + W values) are computed on the CPU, so every
    device samples at the same coordinates (a device's cumsum over the
    nodes may round them apart)."""
    h, w = img.shape[0], img.shape[1]
    my = _grid_axis_map(steps_y, h, "cpu").to(img.device)
    mx = _grid_axis_map(steps_x, w, "cpu").to(img.device)
    return _warp_pair(img, mask, my[:, None].expand(h, w),
                      mx[None, :].expand(h, w))


def draw_optical_distortion(gen, h: int, w: int, distort_limit: float = 2.0,
                            shift_limit: float = 0.5
                            ) -> Tuple[float, float, float]:
    """(k, dy, dx) of OpticalDistortion: the barrel / pincushion strength
    U(±distort_limit) and the centre's shift U(±shift_limit)·size·0.1 in
    pixels, each in fp32 in the JAX op's order of operations."""
    f32 = np.float32
    k = f32(uniform(gen, -distort_limit, distort_limit))
    dy = f32(f32(uniform(gen, -shift_limit, shift_limit)) * f32(h)) * f32(0.1)
    dx = f32(f32(uniform(gen, -shift_limit, shift_limit)) * f32(w)) * f32(0.1)
    return float(k), float(dy), float(dx)


def apply_optical_distortion(img, mask, k: float, dy: float, dx: float):
    """albumentations OpticalDistortion as the JAX op approximates it:
    radius² r² of the centred, unit-normalised grid, the scale
    1 / (1 + k·r²·0.25), then the shift; the image bilinear, the mask (if
    any) nearest."""
    h, w = img.shape[0], img.shape[1]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    gy, gx = _grid(h, w, img.device)
    # divisors as device tensors: a CPU scalar divisor becomes a multiply
    # by its reciprocal on a GPU, an ulp away from the CPU's division
    f32 = dict(dtype=torch.float32, device=img.device)
    ny = (gy - cy) / torch.tensor(cy, **f32)
    nx = (gx - cx) / torch.tensor(cx, **f32)
    r2 = ny * ny + nx * nx
    kt = torch.tensor(k, **f32)
    factor = 1.0 / (1.0 + kt * r2 * 0.25)
    sy = ny * factor * cy + cy + torch.tensor(dy, **f32)
    sx = nx * factor * cx + cx + torch.tensor(dx, **f32)
    return _warp_pair(img, mask, sy, sx)


# ---------------------------------------------------------------------------
# CLAHE (EasyTransform / MediumTransform): tile histograms, the clipped CDF,
# each pixel's value through the four nearest tiles' maps, blended bilinearly
# ---------------------------------------------------------------------------

def clahe(img: torch.Tensor, clip_limit: float = 4.0,
          grid: Tuple[int, int] = (8, 8), nbins: int = 256) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalisation of an (H, W) image
    in [0, 255]. Each tile's histogram counts its truncated values with one
    ``bincount`` over (tile, bin), O(H·W) (the JAX op sums a one-hot of
    (tiles, pixels, bins), the same fp32 counts); bins over
    ``clip_limit``·pixels/bins are clipped and the excess spread evenly."""
    h, w = img.shape
    gh, gw = grid
    th, tw = h // gh, w // gw
    dev = img.device
    vals = torch.clamp(img[:gh * th, :gw * tw], 0, 255).to(torch.int64)
    tile = ((torch.arange(gh * th, device=dev) // th)[:, None] * gw
            + (torch.arange(gw * tw, device=dev) // tw)[None, :])
    hist = torch.bincount((tile * nbins + vals).reshape(-1),
                          minlength=gh * gw * nbins)
    hist = hist.to(torch.float32).view(gh * gw, nbins)
    limit = max(clip_limit * th * tw / nbins, 1.0)
    excess = torch.clamp(hist - limit, min=0.0).sum(1, keepdim=True)
    hist = torch.clamp(hist, max=limit) + excess / nbins
    cdf = torch.cumsum(hist, 1)
    cdf = ((cdf - cdf[:, :1]) / torch.clamp(cdf[:, -1:] - cdf[:, :1],
                                            min=1e-6) * (nbins - 1))
    cdf = cdf.reshape(-1)

    gy, gx = _grid(h, w, dev)
    ty = torch.clamp((gy + 0.5) / th - 0.5, 0.0, gh - 1.0)
    tx = torch.clamp((gx + 0.5) / tw - 0.5, 0.0, gw - 1.0)
    y0, x0 = torch.floor(ty), torch.floor(tx)
    fy, fx = ty - y0, tx - x0
    y0, x0 = y0.to(torch.int64), x0.to(torch.int64)
    y1, x1 = torch.clamp(y0 + 1, max=gh - 1), torch.clamp(x0 + 1, max=gw - 1)
    v = torch.clamp(img, 0, 255).to(torch.int64)

    def lookup(iy, ix):
        return cdf[(iy * gw + ix) * nbins + v]

    return (lookup(y0, x0) * (1 - fy) * (1 - fx)
            + lookup(y0, x1) * (1 - fy) * fx
            + lookup(y1, x0) * fy * (1 - fx) + lookup(y1, x1) * fy * fx)


def clahe_rgb(img: torch.Tensor, clip_limit: float = 4.0,
              grid: Tuple[int, int] = (8, 8)) -> torch.Tensor:
    """CLAHE of the luma, the colour kept by each pixel's ratio
    equalised / luma (the JAX package's stand-in for preprocess_gan.py's LAB
    round trip)."""
    lum = rgb_to_gray(img, keep_channels=False)
    eq = clahe(lum, clip_limit, grid)
    ratio = eq / torch.clamp(lum, min=1.0)
    return _clip(img * ratio[..., None])
