"""Weights of the JAX package ↔ the port's ``state_dict``.

The port's submodules carry the flax scope names, so a leaf's torch key is its
flax path with the module names kept, a short table for the auto-names of a
few module kinds, and one layout rule per leaf kind:

* conv ``kernel`` HWIO → ``weight`` OIHW (a depthwise kernel (kh, kw, 1,
  C) → (C, 1, kh, kw)); a ``ConvTranspose_*`` kernel HWIO → IOHW flipped in
  H and W (flax's transposed conv does not flip its kernel, torch's does);
  Dense ``kernel`` (in, out) → ``weight`` (out, in); ``bias`` as is;
* BatchNorm ``scale`` / ``bias`` and batch_stats ``mean`` / ``var`` →
  ``weight`` / ``bias`` / ``running_mean`` / ``running_var``; the axial
  norms' ``<name>_scale`` (…) go to the same four under ``<name>``;
* the axial projections ``to_qkv`` / ``to_kq`` / ``to_v`` and
  ``pos_enc/relative`` keep the layout the attention op takes, and so do
  the Swin ``rel_bias`` tables, the ViT ``pos_embed``, the gated axial
  attention's ``relative`` table and its four 0-d gates ``gate_qr`` /
  ``gate_kr`` / ``gate_v`` / ``gate_rv`` (MedT; there ``to_qkv`` and
  ``to_out`` are Dense scopes, and ``qkv_bn`` a plain BatchNorm);
* scSE's ``sse_kernel`` / ``sse_bias`` → its ``sse`` 1×1 conv.

``flax_to_torch`` takes the variables as nested dicts of arrays, as the
port's ``train.checkpoint.load_checkpoint`` reads them from a JAX
checkpoint; ``torch_to_flax`` is its inverse, so a checkpoint the port
writes with ``save_checkpoint`` loads in the JAX package. The GAN's
``best_gan.ckpt`` tree (``gan_to_flax`` / ``load_gan``) holds the
generator's variables and the discriminator's parameters, whose modules
keep the flax names (``conv0``-``conv3``, ``Dense_0``), so the same rules
cover them.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import (Any, Dict, Iterator, List, Mapping, Sequence,
                    Tuple, Union)

import numpy as np
import torch

# The module kinds whose children the port names apart from flax, each by
# the names of ALL its children, scopes and leaves (flax name → port name):
# a name is changed only inside a module of its kind, because other modules
# reuse the same auto-names for other things (AttentionGate's and ASPP's
# ``Conv_0`` and ``BatchNorm_0``, which the port keeps as they are). A
# module is recognised by its children's flax names in ``flax_to_torch`` and
# by their port names in ``torch_to_flax``, so the two sets must tell the
# kinds apart on both sides: RecurrentConv's flax ``bn`` is the port's
# ``norm``.
RENAMED = (
    {"conv": "conv", "BatchNorm_0": "bn"},        # ConvBNReLU
    {"conv": "conv", "bn": "norm"},               # RecurrentConv
    {"Dense_0": "fc1", "Dense_1": "fc2"},         # SEBlock, CBAMChannel
    {"Dense_0": "fc1"},                           # ClassificationHead
)
# SCSEAttention: the two 1×1 convs of the channel gate, beside the leaves
# ``sse_kernel`` / ``sse_bias`` (the port's ``sse`` conv). Attention('scse')
# holds it as the auto-named scope ``SCSEAttention_0``, whose parameters the
# port holds directly.
_SCSE = "SCSEAttention_0"
_SCSE_NAMES = {"Conv_0": "cse_reduce", "Conv_1": "cse_expand"}
# leaves kept as they are (before the suffix rules: ``rel_bias`` is no
# ``<name>_bias``): the axial projections and position tables, the Swin
# relative-bias tables, the ViT position embeddings and the gated axial
# attention's scalar gates
_KEPT = ("to_qkv", "to_kq", "to_v", "relative", "rel_bias", "pos_embed",
         "gate_qr", "gate_kr", "gate_v", "gate_rv")


def _children(paths) -> Dict[Tuple[str, ...], set]:
    """Each module path → the names of its children, scopes and leaves, from
    the paths of the leaves."""
    kids: Dict[Tuple[str, ...], set] = {}
    for path in paths:
        for i in range(len(path)):
            kids.setdefault(tuple(path[:i]), set()).add(path[i])
    return kids


def _renamed(scopes: Sequence[str], kids, to_torch: bool) -> List[str]:
    """``scopes`` with each name renamed by the kind of its parent module
    (``RENAMED``), flax → port or port → flax."""
    out = []
    for i, name in enumerate(scopes):
        siblings = kids.get(tuple(scopes[:i]), set())
        for table in RENAMED:
            names = table if to_torch else {v: k for k, v in table.items()}
            if siblings == set(names):
                name = names[name]
                break
        out.append(name)
    return out


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _contiguous(a: np.ndarray) -> np.ndarray:
    """A C-contiguous copy of ``a`` at its own shape, 0-d included: the
    converted weights never share memory with the model or the tree they
    came from (a train forward moves BatchNorm statistics in place)."""
    return np.array(a, order="C")


def _oihw(a: np.ndarray) -> np.ndarray:
    return a.transpose(3, 2, 0, 1)


def _transposed(scopes: Sequence[str]) -> bool:
    """Whether the kernel under ``scopes`` is a flax ``ConvTranspose``'s."""
    return bool(scopes) and scopes[-1].startswith("ConvTranspose")


def _flip_iohw(a: np.ndarray, to_torch: bool) -> np.ndarray:
    """HWIO → IOHW, or IOHW → HWIO, with H and W reversed."""
    a = a[::-1, ::-1] if to_torch else a[..., ::-1, ::-1]
    return a.transpose(2, 3, 0, 1)


def _torch_key(collection: str, path: Tuple[str, ...], a: np.ndarray,
               kids) -> Tuple[List[str], np.ndarray]:
    *scopes, leaf = path
    mod = _renamed(scopes, kids, to_torch=True)
    mod = [_SCSE_NAMES[s] if s in _SCSE_NAMES
           and "sse_kernel" in kids[tuple(scopes[:i])] else s
           for i, s in enumerate(mod)]
    mod = [s for s in mod if s != _SCSE]
    if collection == "params":
        if leaf == "kernel" and a.ndim == 4 and _transposed(scopes):
            return mod + ["weight"], _flip_iohw(a, to_torch=True)
        if leaf == "kernel" and a.ndim in (2, 4):
            return mod + ["weight"], (_oihw(a) if a.ndim == 4 else a.T)
        if leaf == "bias":
            return mod + ["bias"], a
        if leaf == "scale":
            return mod + ["weight"], a
        if leaf == "sse_kernel":
            return mod + ["sse", "weight"], _oihw(a)
        if leaf == "sse_bias":
            return mod + ["sse", "bias"], a
        if leaf in _KEPT:
            return mod + [leaf], a
        if leaf.endswith("_scale"):
            return mod + [leaf[:-len("_scale")], "weight"], a
        if leaf.endswith("_bias"):
            return mod + [leaf[:-len("_bias")], "bias"], a
    elif collection == "batch_stats":
        if leaf == "mean":
            return mod + ["running_mean"], a
        if leaf == "var":
            return mod + ["running_var"], a
        if leaf.endswith("_mean"):
            return mod + [leaf[:-len("_mean")], "running_mean"], a
        if leaf.endswith("_var"):
            return mod + [leaf[:-len("_var")], "running_var"], a
    raise KeyError(f"no conversion rule for flax leaf "
                   f"{collection}/{'/'.join(path)} of shape {a.shape}")


def flax_to_torch(variables: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """``{"params", "batch_stats"}`` (nested dicts of arrays) → state_dict.
    Raises on a leaf no rule covers, or on two leaves with one torch key."""
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for collection in variables:
        if collection not in ("params", "batch_stats"):
            raise KeyError(f"unexpected flax collection '{collection}'")
    kids = _children(path for tree in variables.values()
                     for path, _ in _leaves(tree))
    for collection, tree in variables.items():
        for path, value in _leaves(tree):
            if isinstance(value, torch.Tensor):   # a bfloat16 leaf
                value = value.float().numpy()
            parts, a = _torch_key(collection, path,
                                  np.asarray(value, dtype=np.float32), kids)
            key = ".".join(parts)
            if key in out:
                raise KeyError(f"two flax leaves map to '{key}'")
            out[key] = torch.from_numpy(_contiguous(a))
    return out


def load_flax(model: torch.nn.Module, variables: Mapping) -> torch.nn.Module:
    """Convert ``variables`` and load them into ``model``. Raises unless every
    flax leaf lands on a parameter or buffer of the same shape and every
    parameter and buffer is set."""
    state = flax_to_torch(variables)
    want = model.state_dict()
    missing = sorted(set(want) - set(state))
    extra = sorted(set(state) - set(want))
    shapes = sorted(k for k in set(want) & set(state)
                    if tuple(want[k].shape) != tuple(state[k].shape))
    if missing or extra or shapes:
        raise ValueError(
            f"flax variables do not fit {type(model).__name__}: "
            f"not set {missing[:10]} ({len(missing)}), left over "
            f"{extra[:10]} ({len(extra)}), shape mismatch "
            f"{[(k, tuple(want[k].shape), tuple(state[k].shape)) for k in shapes[:10]]}")
    model.load_state_dict(state)
    return model


def _flax_scopes(mod: List[str], kids) -> List[str]:
    out = []
    cse = {v: k for k, v in _SCSE_NAMES.items()}
    for name in _renamed(mod, kids, to_torch=False):
        if name in cse:
            out += [_SCSE, cse[name]]
        else:
            out.append(name)
    return out


def torch_to_flax(model_or_state_dict: Union[torch.nn.Module, Mapping]
                  ) -> Dict[str, Dict[str, Any]]:
    """The inverse of :func:`flax_to_torch`: ``{"params", "batch_stats"}``
    as nested dicts of fp32 numpy arrays in the JAX layout (HWIO conv and
    (in, out) Dense kernels, flax's auto-names, the kept leaves as they
    are, scSE's ``sse`` as ``sse_kernel`` / ``sse_bias``, the axial norms
    as ``<name>_scale`` ... leaves of their attention module). An axial
    norm is told apart from a BatchNorm module by its parent: the module
    that holds ``to_qkv`` or ``to_kq``. Raises on a key no rule covers."""
    state = (model_or_state_dict.state_dict()
             if isinstance(model_or_state_dict, torch.nn.Module)
             else model_or_state_dict)
    keys = [k.split(".") for k in state]
    kids = _children(keys)
    attention = {tuple(k[:-1]) for k in keys if k[-1] in ("to_qkv", "to_kq")}
    out: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for parts, value in zip(keys, state.values()):
        *mod, leaf = parts
        a = value.detach().to("cpu", torch.float32).numpy()
        norm = len(mod) > 0 and tuple(mod[:-1]) in attention
        if leaf in _KEPT:
            collection, path = "params", mod + [leaf]
        elif mod and mod[-1] == "sse" and leaf in ("weight", "bias"):
            collection = "params"
            path = mod[:-1] + [_SCSE, "sse_kernel" if leaf == "weight"
                               else "sse_bias"]
        elif norm and leaf in ("weight", "bias", "running_mean",
                               "running_var"):
            collection = "batch_stats" if leaf.startswith("running") else \
                "params"
            suffix = {"weight": "scale", "bias": "bias",
                      "running_mean": "mean", "running_var": "var"}[leaf]
            path = mod[:-1] + [f"{mod[-1]}_{suffix}"]
        elif leaf == "weight" and a.ndim in (1, 2, 4):
            collection = "params"
            path = mod + ["scale" if a.ndim == 1 else "kernel"]
        elif leaf == "bias":
            collection, path = "params", mod + ["bias"]
        elif leaf in ("running_mean", "running_var"):
            collection, path = "batch_stats", mod + [leaf[len("running_"):]]
        else:
            raise KeyError(f"no conversion rule for torch key "
                           f"'{'.'.join(parts)}' of shape {a.shape}")
        if path[-1] == "kernel" and a.ndim == 4 and _transposed(mod):
            a = _flip_iohw(a, to_torch=False)
        elif path[-1] in ("kernel", "sse_kernel"):
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        *scopes, name = path
        node = out[collection]
        for s in _flax_scopes(scopes, kids):
            node = node.setdefault(s, {})
        if name in node:
            raise KeyError(f"two torch keys map to flax leaf "
                           f"{collection}/{'/'.join(path)}")
        node[name] = _contiguous(a)
    return out


def gan_to_flax(generator: torch.nn.Module, discriminator: torch.nn.Module,
                epoch: int, step: int) -> Dict[str, Any]:
    """The JAX GAN trainer's checkpoint tree: ``{epoch, step,
    g_state_dict, g_batch_stats, d_state_dict}`` in flax naming."""
    g = torch_to_flax(generator)
    return {"epoch": int(epoch), "step": int(step),
            "g_state_dict": g["params"], "g_batch_stats": g["batch_stats"],
            "d_state_dict": torch_to_flax(discriminator)["params"]}


def load_gan(generator: torch.nn.Module, discriminator: torch.nn.Module,
             tree: Mapping) -> None:
    """Load a :func:`gan_to_flax` tree (from either package's
    ``best_gan.ckpt``) into the generator and the discriminator."""
    load_flax(generator, {"params": tree["g_state_dict"],
                          "batch_stats": tree.get("g_batch_stats") or {}})
    load_flax(discriminator, {"params": tree["d_state_dict"]})
