"""Model registry (torch port).

Counterpart of ``eyediseasesegmentation_tpu/models/__init__.py``, with the
same names in the same order: the flagship ``unetplusplusstar``, the
families on the ResNet, EfficientNet, MobileNetV3, DenseNet and Swin
encoders or on no encoder (Unet, UNet++, Attention U-Net, FPN, DeepLabV3+,
the classic U-Nets, UNet 3+, smp's Linknet, PSPNet, DeepLabV3, PAN and
MAnet), the transformer families (SegFormerStar, SwinformerStar, TransUNet
R50 / B16, TransUnet_V2) and ``misc.py``'s (the MedT axial U-Nets,
DoubleU-Nets, HED-UNets, DC-UNet, ResUNet++, HuBMAP, HRNet, UneXt50).
``get_model`` applies the same inference-time demotions as the JAX
package.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .attentionunet import AttentionUnet
from .classic import AttUNet, ClassicUNet, R2AttUNet, R2UNet, SAUnet
from .deeplabv3plus import DeepLabV3Plus
from .fpn import FPN
from .misc import (DcUnet, DoubleUnet, HEDUNet, HRNet, MedT,
                   ResAxialAttentionUNet, ResUnetPlusPlus, UneXt50,
                   UnetSEResNext101)
from .smp_extra import PAN, DeepLabV3, Linknet, MAnet, PSPNet
from .transformers import (SegformerStar, SwinformerStar, TransUnet,
                           TransUnetV2)
from .unet import Unet
from .unet3plus import UNet3Plus
from .unetplusplus import UnetPlusPlus
from .unetplusplusstar import UnetPlusPlusStar

__all__ = ["MODEL_REGISTRY", "list_models", "get_model", "get_preprocessing_fn",
           "DATASET_STATS", "init_random", "init_flax"]

# the reference spelling the JAX registry translates
_ALIASES = {"clfhead": "clf_head"}


def _factory(cls, **fixed) -> Callable[..., Any]:
    """A registry entry: ``cls`` built from ``fixed`` updated by the
    caller's params."""
    fields = set(inspect.signature(cls).parameters)

    def make(**params):
        params = {**fixed, **params}
        # keys that are not constructor fields are dropped, as in the JAX
        # registry: the reference's torch-only keys (encoder_weights,
        # pretrained, encoder_depth, ...) and the JAX layout knobs
        # (fast_inference, fast_train, keep_packed, ...), exact rewrites of
        # the logical path (tests/test_packed_tail.py; pallas_tail and
        # fast_min_res ARE fields: they select the fused decode-node
        # kernels; drop_block_prob and remat are fields too), so a
        # config.json round-trips; a true remat on a model without the
        # field raises TypeError
        kwargs = {}
        for k, v in params.items():
            k2 = _ALIASES.get(k, k)
            if k2 in fields:
                kwargs[k2] = v
        if params.get("remat") and "remat" not in fields:
            # a model without its own per-block remat refuses it, as a flax
            # constructor refuses an unknown field (the trainer then
            # checkpoints the whole model)
            raise TypeError(f"{cls.__name__} has no field 'remat'")
        return cls(**kwargs)

    return make


MODEL_REGISTRY: Dict[str, Callable[..., Any]] = {
    "unetplusplusstar": _factory(UnetPlusPlusStar),
    "unetplusplus_deepsup": _factory(UnetPlusPlus),
    "Unet": _factory(Unet),
    "resnet18_unet32": _factory(Unet, encoder_name="resnet18"),
    "resnet34_unet32": _factory(Unet, encoder_name="resnet34"),
    "resnet50_unet32": _factory(Unet, encoder_name="resnet50"),
    "seresnet50_unet32": _factory(Unet, encoder_name="seresnet50"),
    "b4_unet32": _factory(Unet, encoder_name="efficientnet-b4"),
    "b2_effunet32": _factory(Unet, encoder_name="efficientnet-b2"),
    "b4_effunet32": _factory(Unet, encoder_name="efficientnet-b4"),
    "resnet50_attunet": _factory(AttentionUnet, encoder_name="resnet50"),
    "seresnet50_attunet": _factory(AttentionUnet, encoder_name="seresnet50"),
    "efficientnetb2_attunet": _factory(AttentionUnet,
                                       encoder_name="efficientnet-b2"),
    "mobilenetv3_attunet": _factory(AttentionUnet,
                                    encoder_name="mobilenetv3"),
    "swin_tiny_attunet": _factory(AttentionUnet, encoder_name="swin_tiny"),
    "swin_small_attunet": _factory(AttentionUnet, encoder_name="swin_small"),
    "hrnet18": _factory(HRNet, width=18),
    "hrnet34": _factory(HRNet, width=34),
    "hrnet48": _factory(HRNet, width=48),
    "resnet50_doubleunet": _factory(DoubleUnet, encoder_name="resnet50"),
    "efficientnetb2_doubleunet": _factory(DoubleUnet,
                                          encoder_name="efficientnet-b2"),
    "mobilenetv3_doubleunet": _factory(DoubleUnet,
                                       encoder_name="mobilenetv3"),
    "vgg_doubleunet": _factory(DoubleUnet, encoder_name="vgg"),
    "unet_resnext50_ssl": _factory(UneXt50),
    "rrcnn_unet": _factory(R2UNet),
    "sa_unet": _factory(SAUnet),
    "classic_unet": _factory(ClassicUNet),
    "hed_unet": _factory(HEDUNet, block="double"),
    "hed_resunet": _factory(HEDUNet, block="res"),
    "hed_denseunet": _factory(HEDUNet, block="dense"),
    "b2_fpn_cat": _factory(FPN, encoder_name="efficientnet-b2",
                           fpn_channels=128),
    "resnet34_fpncat128": _factory(FPN, encoder_name="resnet34",
                                   fpn_channels=128),
    "seresnext50_fpncat128": _factory(FPN, encoder_name="seresnext50",
                                      fpn_channels=128),
    "resnet152_fpncat256": _factory(FPN, encoder_name="resnet152",
                                    fpn_channels=256),
    "resnet34_deeplab128": _factory(DeepLabV3Plus, encoder_name="resnet34"),
    "deeplabv3plus_deepsup": _factory(DeepLabV3Plus),
    "seresnext101_deeplab256": _factory(DeepLabV3Plus,
                                        encoder_name="seresnext101"),
    "transunet_r50": _factory(TransUnet, hybrid=True),
    "transunet_b16": _factory(TransUnet, hybrid=False),
    "TransUnet_V2": _factory(TransUnetV2),
    "Unet3Plus_Base": _factory(UNet3Plus),
    "Unet3Plus_DS": _factory(UNet3Plus, deep_supervision=True),
    "LeeJunHyun_impl_att": _factory(AttUNet),
    "LeeJunHyun_impl_R2U_Net": _factory(R2UNet),
    "LeeJunHyun_impl_R2AttU_Net": _factory(R2AttUNet),
    "axialatt_unet": _factory(ResAxialAttentionUNet, gated=False),
    "gated": _factory(ResAxialAttentionUNet, gated=True),
    "medt": _factory(MedT),
    "logo": _factory(MedT, patch_grid=2),
    "axialattwopo_unet": _factory(ResAxialAttentionUNet, gated=False,
                                  use_pos=False),
    "dcunet": _factory(DcUnet),
    "resunetplusplus": _factory(ResUnetPlusPlus),
    "hubmap_kaggle": _factory(UnetSEResNext101),
    "SegFormerStar": _factory(SegformerStar),
    "SwinformerStar": _factory(SwinformerStar),
    # the smp class names the reference resolves by reflection
    "UnetPlusPlus": _factory(UnetPlusPlus),
    "FPN": _factory(FPN),
    "DeepLabV3Plus": _factory(DeepLabV3Plus),
    "Linknet": _factory(Linknet),
    "PSPNet": _factory(PSPNet),
    "DeepLabV3": _factory(DeepLabV3),
    "PAN": _factory(PAN),
    "MAnet": _factory(MAnet),
}


def list_models():
    return list(MODEL_REGISTRY.keys())


def _fill(model: torch.nn.Module, who: str, bn, kernel, bias, relative,
          table) -> torch.nn.Module:
    """Draw every parameter and buffer of ``model`` on the CPU by kind:
    ``bn`` (BatchNorm leaf → draw; its ``weight`` and ``bias`` draws fill
    the LayerNorm and GroupNorm affines too, its ``weight`` draw the gated
    axial attention's scalar gates), ``kernel(fan_in)`` for conv,
    dense and projection weights, ``bias``, ``relative`` (the axial position
    tables) and ``table`` (the Swin ``rel_bias`` and ViT ``pos_embed``).
    Raises on a leaf no kind covers."""
    from .misc import GATES
    from .modules.layers import BatchNorm

    done = set()
    with torch.no_grad():
        for name, mod in model.named_modules():
            leaves = {}
            if isinstance(mod, BatchNorm):
                leaves = dict(bn)
            elif isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)):
                leaves = {"weight": kernel(mod.weight[0].numel()),
                          "bias": bias}
            elif isinstance(mod, torch.nn.ConvTranspose2d):   # (I, O, kh, kw)
                leaves = {"weight": kernel(mod.weight[:, 0].numel())}
            elif isinstance(mod, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
                leaves = {"weight": bn["weight"], "bias": bn["bias"]}
            if isinstance(getattr(mod, "relative", None), torch.nn.Parameter):
                leaves["relative"] = relative
            for leaf in GATES:
                if isinstance(getattr(mod, leaf, None), torch.nn.Parameter):
                    leaves[leaf] = bn["weight"]
            for leaf in ("rel_bias", "pos_embed"):
                if isinstance(getattr(mod, leaf, None), torch.nn.Parameter):
                    leaves[leaf] = table
            for leaf in ("to_qkv", "to_kq", "to_v"):
                if isinstance(getattr(mod, leaf, None), torch.nn.Parameter):
                    leaves[leaf] = kernel(getattr(mod, leaf).shape[0])
            for leaf, fn in leaves.items():
                t = getattr(mod, leaf, None)
                if t is not None:
                    t.copy_(fn(torch.empty(t.shape, dtype=torch.float32)))
                    done.add(f"{name}.{leaf}" if name else leaf)
    unset = sorted(set(model.state_dict()) - done)
    if unset:
        raise ValueError(f"{who}: no rule for {unset[:10]}")
    return model


def init_random(model: torch.nn.Module,
                generator: torch.Generator) -> torch.nn.Module:
    """Fill every parameter and buffer of ``model`` from ``generator``, at
    the scales of the flax initializers (lecun-normal weights, unit-normal
    axial position tables, N(0, 0.02) Swin and ViT tables) with BatchNorm
    statistics, the LayerNorm / GroupNorm affines and the MedT gates drawn
    away from the identity.
    Draws on the CPU, so a seed gives the same weights on every device."""
    def normal(std, mean=0.0):
        return lambda x: x.normal_(mean, std, generator=generator)

    def uniform(lo, hi):
        return lambda x: x.uniform_(lo, hi, generator=generator)

    return _fill(model, "init_random",
                 bn={"weight": uniform(0.8, 1.2), "bias": normal(0.1),
                     "running_mean": normal(0.1),
                     "running_var": uniform(0.5, 1.5)},
                 kernel=lambda fan_in: normal(fan_in ** -0.5),
                 bias=normal(0.01), relative=normal(1.0), table=normal(0.02))


def init_flax(model: torch.nn.Module,
              generator: torch.Generator) -> torch.nn.Module:
    """Initialise ``model`` as the JAX package's ``model.init`` does, by the
    flax initializers: lecun-normal (fan-in variance scaling, normal
    truncated at two standard deviations) for conv, dense and projection
    kernels, zeros for biases, unit-normal axial position tables, N(0,
    0.02) Swin ``rel_bias`` and ViT ``pos_embed``, BatchNorms, LayerNorms
    and GroupNorms at the identity (scale 1, bias 0, running mean 0,
    variance 1) and the MedT gates at 1. Draws on
    the CPU from ``generator``, so a seed gives the same weights on every
    device (the streams are torch's, not JAX's)."""
    def kernel(fan_in):
        std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
        return lambda x: torch.nn.init.trunc_normal_(
            x, 0.0, std, -2 * std, 2 * std, generator=generator)

    ones, zeros = torch.nn.init.ones_, torch.nn.init.zeros_
    return _fill(model, "init_flax",
                 bn={"weight": ones, "bias": zeros, "running_mean": zeros,
                     "running_var": ones},
                 kernel=kernel, bias=zeros,
                 relative=lambda x: x.normal_(0.0, 1.0, generator=generator),
                 table=lambda x: x.normal_(0.0, 0.02, generator=generator))


def get_model(model_name: str, params: Optional[Dict[str, Any]] = None,
              training: bool = True, dtype: torch.dtype = torch.float32,
              device=None):
    """Registry factory with the reference's inference-time demotions
    (``training=False`` drops the deep-supervision and classification
    heads; ``training=True`` keeps them). The model comes back in eval
    mode: a trainer calls ``.train()``.

    The model is built on ``device``. ``None`` means the GPU (``"cuda"``)
    and raises when there is none: the port runs on the CPU only for a
    caller that asks for it with ``device="cpu"``."""
    try:
        model_fn = MODEL_REGISTRY[model_name]
    except KeyError:
        raise KeyError(f"Cannot find {model_name}, available options are "
                       f"{list_models()}") from None
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "get_model: no CUDA device is present; pass device='cpu' to "
                "build the model on the CPU")
        device = "cuda"
    params = dict(params or {})
    if not training:
        params.pop("clfhead", None)
        params["clf_head"] = False
        params["pretrained"] = False
        params["encoder_weights"] = None
        params["deep_supervision"] = False
        params.pop("remat", None)    # a training-only knob
    params["dtype"] = dtype
    return model_fn(**params).to(device)


# per-dataset channel statistics (reference archs/__init__.py:61-89)
DATASET_STATS = {
    "IDRiD": ([0.44976714, 0.2186806, 0.06459363],
              [0.33224553, 0.17116262, 0.086509705]),
    "FGADR": ([0.4554011, 0.2591345, 0.13285689],
              [0.28593522, 0.185085, 0.13528904]),
    "DDR": ([0.31897065, 0.19916488, 0.08322998],
            [0.32040685, 0.20822203, 0.114768185]),
    "DRIVE": ([0.49742976, 0.27066445, 0.16217253],
              [0.34794736, 0.18998094, 0.1084089]),
    "HRF": ([0.6273858, 0.20169912, 0.10424815],
            [0.2866019, 0.11408445, 0.060513902]),
    "CHASEDB1": ([0.4527923, 0.16221291, 0.028265305],
                 [0.36041078, 0.14167951, 0.036878455]),
}


def get_preprocessing_fn(dataset_name: str, grayscale: bool = False):
    """Return (fn, mean, std); fn maps [0, 255] images (torch tensors or numpy
    arrays, channel last) to normalized floats."""
    mean, std = DATASET_STATS.get(dataset_name, DATASET_STATS["IDRiD"])
    if grayscale:
        luma = (0.2989, 0.5870, 0.1140)
        mean = sum(m * w for m, w in zip(mean, luma))
        std = sum(s * w for s, w in zip(std, luma))

    def preprocessing(x, mean=mean, std=std):
        x = x / 255.0
        if isinstance(x, torch.Tensor):
            return ((x - torch.as_tensor(mean, dtype=x.dtype, device=x.device))
                    / torch.as_tensor(std, dtype=x.dtype, device=x.device))
        return (x - np.asarray(mean)) / np.asarray(std)

    return preprocessing, mean, std
