"""U-Net family decoders (torch, NCHW).

Counterpart of ``eyediseasesegmentation_tpu/models/decoders.py``, logical
path: ``DecoderBlock`` upsamples ×2 and either gates the skip with scSE over
the concat or, on ``use_catt`` nodes, with height+width cross-axial attention
at C/16 width; ``UnetPlusPlusDecoder`` is the nested dense grid (``star``:
cross-axial gates on x_0_0, x_1_1 and x_0_1, the flagship's variant);
``UnetDecoder`` is the plain smp.Unet decoder.

``pallas_tail`` (the JAX package's name, kept so that a config carries over)
routes the scSE skip nodes of the high-resolution tail through the fused
decode-node kernels of ``ops/scse_conv.py`` (``True``/``"v1"``: attention1 +
conv1 in one kernel) or ``ops/decode_pair.py`` (``"pair"``: both convs and
attention2's pooled sums in one kernel; ``"pair_up"``: also the H direction
of part 0's upsample). The nodes are the JAX decoder's, exactly. In the JAX
package the routes also need ``fast_inference`` (the TPU default); here
``pallas_tail`` alone switches them on, because the packed layouts
(``fast_inference``, ``keep_packed``) are exact rewrites of the logical path
with no counterpart in the port: they only decide which nodes qualify. The
kernels have no backward: in training every node takes the plain path, as
the JAX decoder does (``pallas_tail and not train``), and the cross-axial
gates run their attention's train path.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .modules.axial import (CrossAxialAttention, columns, columns_to_rows,
                            rows_to_nchw)
from ..ops.decode_pair import scse_conv3x3_pair
from ..ops.scse_conv import scse_conv3x3_bn_relu
from .modules.layers import (Attention, BatchNorm, ConvBNReLU, PortModule,
                             Parts, conv2d, output_parts, remat, upsample2x,
                             upsample2x_w)

PALLAS_TAIL_MODES = (None, False, True, "v1", "pair", "pair_up")


def check_pallas_tail(mode: Any) -> Any:
    if mode not in PALLAS_TAIL_MODES:
        raise ValueError(f"Unknown pallas_tail {mode!r} (one of "
                         f"{PALLAS_TAIL_MODES})")
    return mode


class DecoderBlock(PortModule):

    def __init__(self, in_channels: int, skip_channels: int,
                 out_channels: int, base_dim: int = 32, level: int = 0,
                 use_catt: bool = False,
                 attention_type: Optional[str] = None,
                 pallas_tail: Any = False, drop_block_prob: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.use_catt, self.dtype = use_catt, dtype
        self.pallas_tail = check_pallas_tail(pallas_tail)
        self.out_channels = out_channels
        dim = base_dim * (2 ** level)
        if use_catt:
            c16 = skip_channels // 16
            self.down_sample = nn.Conv2d(skip_channels, c16, 1, bias=False)
            self.init_conv = nn.Conv2d(skip_channels, c16, 1)
            self.init_bn = BatchNorm(c16, dtype)
            self.h_catt = CrossAxialAttention(
                dim, in_channels=in_channels, in_skip_channels=c16, heads=4,
                dim_head_kq=8, dtype=dtype)
            self.w_catt = CrossAxialAttention(
                dim, in_channels=in_channels, in_skip_channels=c16, heads=4,
                dim_head_kq=8, dtype=dtype)
            self.up_sample = nn.Conv2d(c16, skip_channels, 1, bias=False)
        elif skip_channels > 0:
            self.attention1 = Attention(attention_type,
                                        in_channels + skip_channels, dtype)
        self.conv1 = ConvBNReLU(in_channels + skip_channels, out_channels,
                                dtype=dtype, drop_block_prob=drop_block_prob)
        self.conv2 = ConvBNReLU(out_channels, out_channels, dtype=dtype,
                                drop_block_prob=drop_block_prob)
        if not use_catt:
            self.attention2 = Attention(attention_type, out_channels, dtype)

    def _cross_gate(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        """The skip gated by height then width cross-axial attention."""
        dt = self.dtype
        b, _, h, w = x.shape
        ori_skip = conv2d(skip, self.down_sample, dt)
        s = conv2d(F.max_pool2d(skip, 2), self.init_conv, dt)
        s = torch.relu(self.init_bn(s))
        s_cols = self.h_catt(columns(x), columns(s))
        x_rows = x.permute(0, 2, 3, 1).reshape(b * h, w, x.shape[1])
        s_rows = self.w_catt(x_rows, columns_to_rows(s_cols, b, h, w))
        s = rows_to_nchw(s_rows, b, h, w)
        gate = upsample2x(torch.sigmoid(s).to(dt))
        return conv2d(ori_skip * gate, self.up_sample, dt)

    def _raw_gates(self, x: torch.Tensor, skips: List[torch.Tensor]):
        """(gated, gate_c, sse_kernel, sse_bias) of attention1 for the
        kernels; zeros when the block has no attention."""
        if isinstance(self.attention1, nn.Identity):
            c = x.shape[1] + sum(p.shape[1] for p in skips)
            zeros = torch.zeros((x.shape[0], c), dtype=torch.float32,
                                device=x.device)
            return False, zeros, zeros[0], zeros[0, 0]
        return (True, *self.attention1.raw_gates([x] + skips, up_part0=True))

    def _pallas_call(self, x: torch.Tensor, skips: List[torch.Tensor]):
        """attention1 + conv1 + BN + ReLU as one kernel; conv2 and attention2
        as on the logical path. Same parameters as the logical path."""
        gated, gate_c, sse_k, sse_b = self._raw_gates(x, skips)
        parts = [p.to(self.dtype) for p in [upsample2x(x)] + skips]
        y = scse_conv3x3_bn_relu(parts, gate_c, sse_k, sse_b,
                                 *self.conv1.folded_params(), relu=True,
                                 gated=gated)
        return self.attention2(self.conv2(y))

    def _pallas_pair_call(self, x: torch.Tensor, skips: List[torch.Tensor],
                          up_in_kernel: bool = False):
        """attention1 + conv1 + BN + ReLU + conv2 + BN + ReLU as one kernel
        that also returns attention2's pooled channel sums; attention2's
        gating multiply stays a plain op. With ``up_in_kernel`` part 0 goes
        to the kernel upsampled along W only, at half height."""
        gated, gate_c, sse_k, sse_b = self._raw_gates(x, skips)
        up = upsample2x_w if up_in_kernel else upsample2x
        # one dtype for all parts: the previous pair node's output and the
        # encoder's skips may differ, and the convs would cast here anyway
        parts = [p.to(self.dtype) for p in [up(x)] + skips]
        y2, csum = scse_conv3x3_pair(
            parts, gate_c, sse_k, sse_b, *self.conv1.folded_params(),
            *self.conv2.folded_params(), gated=gated, up_part0=up_in_kernel)
        if not isinstance(self.attention2, nn.Identity):
            hw = y2.shape[2] * y2.shape[3]
            y2 = self.attention2(y2, mean_override=csum / hw)
        # the fp32 sSE gate promotes the gating multiply; the node's output
        # stays in the compute dtype
        return y2.to(self.dtype)

    def forward(self, x: torch.Tensor, skip: Optional[Parts] = None,
                kernel_route: Optional[bool] = None):
        """``kernel_route``: take the ``pallas_tail`` route for this call
        (None: whenever the block has one and a skip that scSE gates). In
        training the route is never taken."""
        if kernel_route is None:
            kernel_route = bool(self.pallas_tail)
        if (kernel_route and self.pallas_tail and skip is not None
                and not self.use_catt and not self.training):
            skips = output_parts(skip)
            if self.pallas_tail in ("pair", "pair_up"):
                return self._pallas_pair_call(
                    x, skips, up_in_kernel=self.pallas_tail == "pair_up")
            return self._pallas_call(x, skips)
        x_up: Parts = upsample2x(x)
        if skip is not None:
            if self.use_catt:
                skip = torch.cat(output_parts(skip), 1)
                x_up = [x_up, self._cross_gate(x, skip)]
            else:
                x_up = self.attention1([x_up] + output_parts(skip))
        y = self.conv2(self.conv1(x_up))
        if not self.use_catt:
            y = self.attention2(y)
        return y


class UnetDecoder(PortModule):
    """Plain smp.Unet decoder: one ``DecoderBlock`` per decoder channel over
    the reversed feature pyramid, the last without a skip."""

    def __init__(self, encoder_channels: Sequence[int],
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 attention_type: Optional[str] = None,
                 drop_block_prob: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        enc = list(encoder_channels[1:])[::-1]  # head first
        in_ch = [enc[0]] + list(decoder_channels[:-1])
        skip_ch = enc[1:] + [0] * len(decoder_channels)
        self.n_blocks = len(decoder_channels)
        for i, out in enumerate(decoder_channels):
            self.add_module(f"block{i}", DecoderBlock(
                in_ch[i], skip_ch[i], out, attention_type=attention_type,
                drop_block_prob=drop_block_prob, dtype=dtype))

    def forward(self, features: List[torch.Tensor]) -> torch.Tensor:
        feats = features[1:][::-1]
        x, skips = feats[0], feats[1:]
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(
                x, skips[i] if i < len(skips) else None)
        return x


class UnetPlusPlusDecoder(PortModule):
    """Nested UNet++ dense-grid decoder. ``star``: the skips of the nodes
    with layer index 0 or 1 (x_0_0, x_1_1, x_0_1) are gated by cross-axial
    attention (the flagship's variant). Returns the final map, or
    (final, [x_3_3, x_2_3, x_1_3]) with ``deep_supervision``. ``remat``:
    in training each node, the final block included, is recomputed in the
    backward (``layers.remat``); a training node never takes a kernel
    route, recomputed or not."""

    def __init__(self, encoder_channels: Sequence[int],
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 base_dim: int = 32, attention_type: Optional[str] = None,
                 deep_supervision: bool = False, star: bool = False,
                 pallas_tail: Any = False, fast_min_res: int = 512,
                 drop_block_prob: float = 0.1, remat: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.deep_supervision, self.remat = deep_supervision, remat
        self.pallas_tail = check_pallas_tail(pallas_tail)
        self.fast_min_res = fast_min_res
        enc = list(encoder_channels[1:])[::-1]  # head first
        in_channels = [enc[0]] + list(decoder_channels[:-1])
        skip_channels = enc[1:] + [0]
        out_channels = list(decoder_channels)
        self.depth = depth = len(in_channels) - 1

        def add(depth_idx, layer_idx):
            if depth_idx == 0:
                in_ch = in_channels[layer_idx]
                skip_ch = skip_channels[layer_idx] * (layer_idx + 1)
                out_ch = out_channels[layer_idx]
            else:
                out_ch = skip_channels[layer_idx]
                skip_ch = skip_channels[layer_idx] * (layer_idx + 1 - depth_idx)
                in_ch = skip_channels[layer_idx - 1]
            self.add_module(f"x_{depth_idx}_{layer_idx}", DecoderBlock(
                in_ch, skip_ch, out_ch, base_dim=base_dim, level=layer_idx,
                use_catt=star and layer_idx in (0, 1),
                attention_type=attention_type, pallas_tail=pallas_tail,
                drop_block_prob=drop_block_prob, dtype=dtype))

        for d in range(depth):
            add(d, d)
        for layer_idx in range(1, depth):
            for depth_idx in range(depth - layer_idx):
                add(depth_idx, depth_idx + layer_idx)
        self.add_module(f"x_0_{depth}", DecoderBlock(
            in_channels[-1], 0, out_channels[-1], base_dim=base_dim,
            attention_type=attention_type, drop_block_prob=drop_block_prob,
            dtype=dtype))

    def kernel_nodes(self, feat_hw: Sequence[Tuple[int, int]]) -> List[str]:
        """The nodes that take the ``pallas_tail`` route, from shapes alone.

        ``feat_hw``: (H, W) of the encoder features, head (deepest) first, as
        ``forward`` orders them. The rule is the JAX decoder's: a node
        qualifies for the fast tail when its output has fewer than 128
        channels, it is not a cross-axial node, its output height is at
        least ``fast_min_res``, its input is at least 3×3 and every skip has
        the output's size; it takes the kernel route when it also has a skip
        and is not the producer the JAX decoder hands on in packed layout
        (x_0_{depth-1}, when the final block qualifies too)."""
        if not self.pallas_tail:
            return []
        depth = self.depth
        hw = {f"x_{d}_{d}": (2 * feat_hw[d][0], 2 * feat_hw[d][1])
              for d in range(depth)}

        def fast(name, xin_hw, skip_hws):
            block = getattr(self, name)
            h, w = xin_hw
            return (not block.use_catt and block.out_channels < 128
                    and 2 * h >= self.fast_min_res and h >= 3 and w >= 3
                    and all(s == (2 * h, 2 * w) for s in skip_hws))

        nodes = [f"x_{d}_{d}" for d in range(depth)
                 if fast(f"x_{d}_{d}", tuple(feat_hw[d]),
                         [tuple(feat_hw[d + 1])])]
        for layer_idx in range(1, depth):
            for depth_idx in range(depth - layer_idx):
                li = depth_idx + layer_idx
                name = f"x_{depth_idx}_{li}"
                xin = hw[f"x_{depth_idx}_{li - 1}"]
                skips = ([hw[f"x_{i}_{li}"]
                          for i in range(depth_idx + 1, li + 1)]
                         + [tuple(feat_hw[li + 1])])
                hw[name] = (2 * xin[0], 2 * xin[1])
                if not fast(name, xin, skips):
                    continue
                h2, w2 = hw[name]
                keep_packed = (depth_idx == 0 and li == depth - 1
                               and getattr(self, f"x_0_{depth}").out_channels
                               < 128 and 2 * h2 >= self.fast_min_res
                               and h2 >= 4 and w2 >= 4)
                if not keep_packed:
                    nodes.append(name)
        return nodes

    def forward(self, features: List[torch.Tensor]):
        depth = self.depth
        feats = features[1:][::-1]
        routed = (set() if self.training else
                  set(self.kernel_nodes([tuple(f.shape[2:]) for f in feats])))
        dense: Dict[str, torch.Tensor] = {}

        def node(name, x, skip):
            return remat(getattr(self, name), x, skip, name in routed,
                         enabled=self.remat)

        for d in range(depth):
            name = f"x_{d}_{d}"
            dense[name] = node(name, feats[d], feats[d + 1])
        for layer_idx in range(1, depth):
            for depth_idx in range(depth - layer_idx):
                li = depth_idx + layer_idx
                name = f"x_{depth_idx}_{li}"
                cat = ([dense[f"x_{i}_{li}"] for i in range(depth_idx + 1, li + 1)]
                       + [feats[li + 1]])
                dense[name] = node(name, dense[f"x_{depth_idx}_{li - 1}"], cat)
        final = node(f"x_0_{depth}", dense[f"x_0_{depth - 1}"], None)
        if self.deep_supervision:
            return final, [dense["x_3_3"], dense["x_2_3"], dense["x_1_3"]]
        return final
