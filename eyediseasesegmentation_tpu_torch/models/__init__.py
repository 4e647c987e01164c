"""Model registry (torch port).

Counterpart of ``eyediseasesegmentation_tpu/models/__init__.py``. Only the
flagship ``unetplusplusstar`` is ported; other registry names raise KeyError
(ROADMAP.md lists the rest of the zoo). ``get_model`` applies the same
inference-time demotions as the JAX package.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .unetplusplusstar import UnetPlusPlusStar

__all__ = ["MODEL_REGISTRY", "list_models", "get_model", "get_preprocessing_fn",
           "DATASET_STATS", "init_random"]

# the reference spelling the JAX registry translates
_ALIASES = {"clfhead": "clf_head"}


def _factory(cls) -> Callable[..., Any]:
    fields = set(inspect.signature(cls).parameters)

    def make(**params):
        # keys that are not constructor fields are dropped, as in the JAX
        # registry: the reference's torch-only keys (encoder_weights,
        # pretrained, encoder_depth, ...), the JAX layout knobs (fast_inference,
        # keep_packed, remat, ...), exact rewrites of the logical path
        # (tests/test_packed_tail.py; pallas_tail and fast_min_res ARE
        # fields: they select the fused decode-node kernels), and
        # drop_block_prob (DropBlock is the
        # identity at eval), so a config.json round-trips
        kwargs = {}
        for k, v in params.items():
            k2 = _ALIASES.get(k, k)
            if k2 in fields:
                kwargs[k2] = v
        return cls(**kwargs)

    return make


MODEL_REGISTRY: Dict[str, Callable[..., Any]] = {
    "unetplusplusstar": _factory(UnetPlusPlusStar),
}


def list_models():
    return list(MODEL_REGISTRY.keys())


def init_random(model: torch.nn.Module,
                generator: torch.Generator) -> torch.nn.Module:
    """Fill every parameter and buffer of ``model`` from ``generator``, at
    the scales of the flax initializers (lecun-normal weights, unit-normal
    position tables) with BatchNorm statistics drawn away from the identity.
    Draws on the CPU, so a seed gives the same weights on every device."""
    from .modules.axial import RelativePosEnc2D
    from .modules.layers import BatchNorm

    def draw(t, fn):
        t.copy_(fn(torch.empty(t.shape, dtype=torch.float32)))

    def normal(std, mean=0.0):
        return lambda x: x.normal_(mean, std, generator=generator)

    def uniform(lo, hi):
        return lambda x: x.uniform_(lo, hi, generator=generator)

    done = set()
    with torch.no_grad():
        for name, mod in model.named_modules():
            leaves = {}
            if isinstance(mod, BatchNorm):
                leaves = {"weight": uniform(0.8, 1.2), "bias": normal(0.1),
                          "running_mean": normal(0.1),
                          "running_var": uniform(0.5, 1.5)}
            elif isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)):
                fan_in = mod.weight[0].numel()
                leaves = {"weight": normal(fan_in ** -0.5),
                          "bias": normal(0.01)}
            elif isinstance(mod, RelativePosEnc2D):
                leaves = {"relative": normal(1.0)}
            for leaf in ("to_qkv", "to_kq", "to_v"):
                if isinstance(getattr(mod, leaf, None), torch.nn.Parameter):
                    leaves[leaf] = normal(getattr(mod, leaf).shape[0] ** -0.5)
            for leaf, fn in leaves.items():
                t = getattr(mod, leaf, None)
                if t is not None:
                    draw(t, fn)
                    done.add(f"{name}.{leaf}" if name else leaf)
    unset = sorted(set(model.state_dict()) - done)
    if unset:
        raise ValueError(f"init_random: no rule for {unset[:10]}")
    return model


def get_model(model_name: str, params: Optional[Dict[str, Any]] = None,
              training: bool = True, dtype: torch.dtype = torch.float32,
              device=None):
    """Registry factory with the reference's inference-time demotions.

    The model is built on ``device``. ``None`` means the GPU (``"cuda"``)
    and raises when there is none: the port runs on the CPU only for a
    caller that asks for it with ``device="cpu"``."""
    try:
        model_fn = MODEL_REGISTRY[model_name]
    except KeyError:
        raise KeyError(
            f"Model '{model_name}' is not ported yet (ported: {list_models()});"
            " see ROADMAP.md for the rest of the zoo") from None
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
