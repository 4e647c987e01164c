"""Context-parallel (H-sharded) inference of the flagship UnetPlusPlusStar
(torch port, NCHW).

Counterpart of ``eyediseasesegmentation_tpu/parallel/spatial_model.py``.
The model's high-resolution stages run with activations split along H over
the ranks, conv borders exchanged as halos (``parallel.spatial``), so no
full-resolution activation is ever held whole by one rank:

* sharded FRONT: the stem's 7×7/2 conv + BN + ReLU (c0 at /2) and the
  3×3/2 max-pool (to /4), whose padding is −inf at the global edges;
* replicated MIDDLE: everything at /4 and below, on the gathered /4 map,
  through the model's own modules: the encoder's SE bottlenecks of layers
  1-3, the axial layer4 and the decoder nodes x_0_0 … x_0_2 with their
  cross-axial gates (on a card, in eval under ``torch.inference_mode``,
  these launch K1; the scSE nodes here take the plain route);
* sharded TAIL: x_3_3 → x_2_3 → x_1_3 → x_0_3 → x_0_4 and the head
  (conv, folded BN, scSE, bilinear ×2 only, plain PyTorch as JAX's tail is
  plain ``lax.conv``), the scSE channel gates from ``psum``'d means.

The axial attention never attends across a rank's border: it runs in the
middle, at 1/16 of the pixels, where gathering the map is cheap. What stays
sharded is the memory-dominant /2 and full-resolution maps. The computation
equals the model's eval forward; the gradient through it equals the
unsharded gradient on the plain path (the kernels have no backward).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.modules.layers import upsample2x, wide
from .mesh import DATA_AXIS, Mesh, all_gather, batch_rows, neighbour_rows, psum
from .spatial import conv3x3_spatial, halo_exchange, upsample2x_spatial


def _conv_spatial(x, weight, stride: int, pad: int, mesh: Mesh, axis: str,
                  dtype):
    """k×k conv with ``pad`` of an H-sharded block: a ``pad``-row halo, VALID
    over rows, zero-padded over columns (stride 2 needs even local rows)."""
    xh = halo_exchange(x, pad, mesh, axis)
    return F.conv2d(xh.to(dtype), weight.to(dtype), None, stride, (0, pad))


def _maxpool3x3s2_spatial(x, mesh: Mesh, axis: str):
    """The stem's 3×3 stride-2 max-pool with pad 1: a 1-row halo whose zero
    rows at the global edges become −inf, the pool's padding."""
    top, bottom = neighbour_rows(x, 1, mesh, 2, axis)
    if mesh.axis_index(axis) == 0:
        top = torch.full_like(top, float("-inf"))
    if mesh.axis_index(axis) == mesh.axis_size(axis) - 1:
        bottom = torch.full_like(bottom, float("-inf"))
    return F.max_pool2d(torch.cat([top, x, bottom], 2), 3, stride=2,
                        padding=(0, 1))


def _global_means(parts: List[torch.Tensor], mesh: Mesh, axis: str,
                  h_global: int) -> torch.Tensor:
    """(B, ΣC) means of H-sharded parts over the global spatial extent: the
    ranks' sums, ``psum``'d, over the global pixel count."""
    sums = torch.cat([p.to(wide(p.dtype)).sum((2, 3)) for p in parts], 1)
    return psum(sums, mesh, axis) / (h_global * parts[0].shape[3])


def _conv_bn_relu(block, parts: List[torch.Tensor], mesh: Mesh, axis: str):
    """An eval ``ConvBNReLU`` on H-sharded parts (their channel concat)."""
    x = torch.cat([p.to(block.dtype) for p in parts], 1)
    y = conv3x3_spatial(x, block.conv.weight, mesh, axis=axis,
                        dtype=block.dtype)
    return torch.relu(block.bn(y))


def _tail_node(block, up, skips: List[torch.Tensor], mesh: Mesh, axis: str,
               h_global: int):
    """A scSE ``DecoderBlock``'s logical path on H-sharded data: [up] +
    skips gated by attention1, conv1, conv2, attention2, each channel gate
    from global means, each spatial gate local (1×1)."""
    parts = [up] + skips
    att1 = getattr(block, "attention1", None)
    if att1 is not None and not isinstance(att1, nn.Identity):
        parts = att1(parts, mean_override=_global_means(parts, mesh, axis,
                                                        h_global))
    y = _conv_bn_relu(block.conv1, parts, mesh, axis)
    y = _conv_bn_relu(block.conv2, [y], mesh, axis)
    if not isinstance(block.attention2, nn.Identity):
        y = block.attention2(y, mean_override=_global_means([y], mesh, axis,
                                                            h_global))
    return y


def _up2_from_replicated(x_full, mesh: Mesh, axis: str):
    """This rank's rows of the bilinear ×2 of a replicated map: its input
    rows and one more each way from the replicated copy (the edge row
    repeated at the global edges: the clamp), the ×2, the rows the extra
    ones give dropped."""
    n, r = mesh.axis_size(axis), mesh.axis_index(axis)
    hin = x_full.shape[2] // n
    xe = torch.cat([x_full[:, :, :1], x_full, x_full[:, :, -1:]], 2)
    return upsample2x(xe[:, :, r * hin:r * hin + hin + 2])[:, :, 2:-2]


def spatial_flagship_predict(model, x: torch.Tensor, mesh: Mesh, *,
                             axis: str = DATA_AXIS,
                             gather: bool = False) -> torch.Tensor:
    """Eval forward of the port's UnetPlusPlusStar (BoTSER50 axial encoder,
    no deep supervision or classification head) with H-sharded front and
    tail.

    ``model`` in eval mode, the same weights on every rank. ``x``: (B, 3,
    H, W), already normalised, the whole input on every rank; H divisible
    by 4 × the ranks (stride alignment, as in JAX). Returns this rank's
    rows of the (B, classes, H, W) logits in fp32 (or wider), or with
    ``gather`` all of them on every rank: the model's forward."""
    enc, dec = model.encoder, model.decoder
    if model.training:
        raise ValueError("spatial_flagship_predict: the model is in train "
                         "mode; it runs the eval forward")
    if (model.deep_supervision or model.clf_head
            or not getattr(enc, "use_axial", False)):
        raise ValueError("spatial_flagship_predict: the flagship on a "
                         "BoTSER50 axial encoder without deep supervision "
                         "or a classification head")
    n, h = mesh.axis_size(axis), x.shape[2]
    if h % (4 * n):
        raise ValueError(f"spatial_flagship_predict: H {h} is not divisible "
                         f"by 4 × {n} ranks")
    sn, dt = enc.seresnet, model.dtype

    # ---- sharded front: stem + max-pool ----
    xl = x[:, :, batch_rows(mesh, h, axis)]
    c0 = torch.relu(sn.stem_bn(_conv_spatial(xl, sn.stem_conv.weight, 2, 3,
                                             mesh, axis, dt)))
    p0 = _maxpool3x3s2_spatial(c0, mesh, axis)

    # ---- replicated middle (/4 and below) ----
    y = all_gather(p0, mesh, dim=2, axis=axis)
    feats = []
    for names in sn.block_names:
        for name in names:
            y = getattr(sn, name)(y)
        feats.append(y)
    y = enc.layer4_shared(enc.layer4_shared(enc.layer4_first(y)))
    c1, c2, c3, c4 = feats + [y]

    def node(name, xin, skip):
        return getattr(dec, name)(xin, skip, kernel_route=False)

    x00 = node("x_0_0", c4, c3)
    x11 = node("x_1_1", c3, c2)
    x22 = node("x_2_2", c2, c1)
    x01 = node("x_0_1", x00, [x11, c2])
    x12 = node("x_1_2", x11, [x22, c1])
    x02 = node("x_0_2", x01, [x12, x22, c1])

    # ---- sharded tail: x_3_3 .. x_0_4 + head ----
    h2 = h // 2

    def tail(name, up, skips, h_out):
        return _tail_node(getattr(dec, name), up, skips, mesh, axis, h_out)

    x33 = tail("x_3_3", _up2_from_replicated(c1, mesh, axis), [c0], h2)
    x23 = tail("x_2_3", _up2_from_replicated(x22, mesh, axis), [x33, c0], h2)
    x13 = tail("x_1_3", _up2_from_replicated(x12, mesh, axis),
               [x23, x33, c0], h2)
    x03 = tail("x_0_3", _up2_from_replicated(x02, mesh, axis),
               [x13, x23, x33, c0], h2)
    x04 = tail("x_0_4", upsample2x_spatial(x03, mesh, axis), [], h)
    head = model.segmentation_head
    logits = conv3x3_spatial(x04, head.conv.weight, mesh,
                             bias=head.conv.bias, axis=axis,
                             dtype=head.dtype).to(wide(head.dtype))
    return all_gather(logits, mesh, dim=2, axis=axis) if gather else logits
