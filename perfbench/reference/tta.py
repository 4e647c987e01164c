"""Plain reference of the whole-image x8 (D4) test-time augmentation.

Raw uint8 images (B, H0, W0, 3) → probabilities (B, H0, W0): with
``resize``, LongestMaxSize to the scale (bilinear, half-pixel centres, no
antialias), zero centre pad to a square, then normalisation; without it
(the vessel path) normalisation only. The 8 dihedral views (flip-major,
then k·90°) go through the model, each logit map is turned back, the 8 are
averaged and one sigmoid is applied; with ``resize`` the pad is cropped and
the map resized back to the original size. Views run in blocks, so that a
float32 forward of a full-width model fits beside nothing else.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

# per-dataset channel statistics of the reference's normalisation
DATASET_STATS = {
    "IDRiD": ([0.44976714, 0.2186806, 0.06459363],
              [0.33224553, 0.17116262, 0.086509705]),
    "DRIVE": ([0.49742976, 0.27066445, 0.16217253],
              [0.34794736, 0.18998094, 0.1084089]),
}


def longest_side_shape(h: int, w: int, size: int) -> Tuple[int, int]:
    scale = size / max(h, w)
    return max(1, round(h * scale)), max(1, round(w * scale))


def resize_nhwc(x: torch.Tensor, hw: Sequence[int]) -> torch.Tensor:
    if tuple(x.shape[1:3]) == tuple(hw):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)


def normalise(x: torch.Tensor, dataset: str) -> torch.Tensor:
    mean, std = DATASET_STATS[dataset]
    mean = torch.tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.tensor(std, dtype=x.dtype, device=x.device)
    return (x / 255.0 - mean) / std


def d4(x: torch.Tensor, i: int) -> torch.Tensor:
    """View ``i`` of (B, H, W, C): hflip for i ≥ 4, then rot90 by i % 4."""
    if i >= 4:
        x = x.flip(2)
    return torch.rot90(x, i % 4, dims=(1, 2))


def d4_back(y: torch.Tensor, i: int) -> torch.Tensor:
    """The inverse of :func:`d4` on a (B, H, W) map."""
    y = torch.rot90(y, -(i % 4), dims=(1, 2))
    return y.flip(2) if i >= 4 else y


@torch.no_grad()
def predict(model, raw: torch.Tensor, scale: int, dataset: str,
            resize: bool = True, views_per_block: int = 8) -> torch.Tensor:
    """(B, H0, W0, 3) uint8 on the model's device → float32 probabilities
    (B, H0, W0). The views enter the model in its parameters' dtype."""
    x = raw.float()
    dtype = next(model.parameters()).dtype
    h0, w0 = x.shape[1], x.shape[2]
    if resize:
        nh, nw = longest_side_shape(h0, w0, scale)
        small = resize_nhwc(x, (nh, nw))
        x = x.new_zeros((x.shape[0], scale, scale, 3))
        top, left = (scale - nh) // 2, (scale - nw) // 2
        x[:, top:top + nh, left:left + nw] = small
    x = normalise(x, dataset)
    out = []
    for b in range(x.shape[0]):
        acc = None
        for start in range(0, 8, views_per_block):
            idx = range(start, min(8, start + views_per_block))
            views = torch.cat([d4(x[b:b + 1], i) for i in idx])
            logits = model(views.permute(0, 3, 1, 2).contiguous()
                           .to(dtype))[:, 0]
            for j, i in enumerate(idx):
                back = d4_back(logits[j:j + 1].float(), i)
                acc = back if acc is None else acc + back
        p = torch.sigmoid(acc / 8.0)
        if resize:
            p = p[:, top:top + nh, left:left + nw]
            p = resize_nhwc(p[..., None], (h0, w0))[..., 0]
        out.append(p)
    return torch.cat(out)
