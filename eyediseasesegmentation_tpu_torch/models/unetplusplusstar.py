"""UnetPlusPlusStar, the flagship (torch, NCHW).

Counterpart of ``eyediseasesegmentation_tpu/models/unetplusplusstar.py``:
BoTSER50 axial encoder, the star UNet++ decoder and the segmentation,
deep-supervision and classification heads.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from .decoders import UnetPlusPlusDecoder
from .encoders import get_encoder
from .modules.layers import ClassificationHead, PortModule, SegmentationHead


class UnetPlusPlusStar(PortModule):
    """NCHW input → fp32 logits (N, classes, H, W); with deep supervision
    (mask, [ds3, ds2, ds1]); with ``clf_head`` the classification logits are
    appended to the output. ``pallas_tail`` (``True``/``"v1"``, ``"pair"``,
    ``"pair_up"``) routes the decoder's scSE tail nodes at output height
    ≥ ``fast_min_res`` through the fused decode-node kernels
    (``models/decoders.py``) in eval. In training (``.train()``) the
    decoder's ConvBNReLUs apply DropBlock at ``drop_block_prob`` and the
    classification head dropout 0.1; with ``remat`` each encoder block
    (SE bottleneck, axial block call) and each decoder node is recomputed
    in the backward instead of kept (``layers.remat``)."""

    def __init__(self, encoder_name: str = "BoTSER50_Axial_Imagenet_3",
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 decoder_attention_type: Optional[str] = None,
                 base_dim: int = 32, classes: int = 1,
                 deep_supervision: bool = False, clf_head: bool = False,
                 pallas_tail: Any = None, fast_min_res: int = 512,
                 drop_block_prob: float = 0.1, remat: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.deep_supervision, self.clf_head = deep_supervision, clf_head
        self.encoder, enc_channels = get_encoder(
            encoder_name, base_dim=base_dim, dtype=dtype, remat=remat)
        if clf_head:
            self.classification_head = ClassificationHead(
                enc_channels[-1], classes, dropout=0.1, dtype=dtype)
        self.decoder = UnetPlusPlusDecoder(
            enc_channels, decoder_channels, base_dim=base_dim,
            attention_type=decoder_attention_type,
            deep_supervision=deep_supervision, star=True,
            pallas_tail=pallas_tail,
            fast_min_res=fast_min_res, drop_block_prob=drop_block_prob,
            remat=remat, dtype=dtype)
        self.segmentation_head = SegmentationHead(
            decoder_channels[-1], classes, dtype=dtype)
        if deep_supervision:
            # x_3_3, x_2_3 and x_1_3 all have the width of the /2 skip
            for i in range(3):
                self.add_module(f"deep_head{i}", SegmentationHead(
                    enc_channels[1], classes, dtype=dtype))

    def forward(self, x: torch.Tensor):
        features = self.encoder(x)
        clf = (self.classification_head(features[-1]) if self.clf_head
               else None)
        decoder_out = self.decoder(features)
        if self.deep_supervision:
            final, deeps = decoder_out
            mask = self.segmentation_head(final)
            ds_masks = [getattr(self, f"deep_head{i}")(f)
                        for i, f in enumerate(deeps)]
            return (mask, ds_masks, clf) if self.clf_head else (mask, ds_masks)
        mask = self.segmentation_head(decoder_out)
        return (mask, clf) if self.clf_head else mask
