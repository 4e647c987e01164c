"""PyTorch checkpoint → pretrained encoder weights (torch port).

Counterpart of ``eyediseasesegmentation_tpu/utils/torch_import.py``, key for
key: the functions act on the JAX layout, nested dicts of numpy arrays in
flax naming, so a port model takes an import as
``convert.torch_to_flax(model)`` → :func:`import_torch_checkpoint` →
``convert.load_flax(model, ...)``, and loads the same leaves as the JAX
package with the same report. It covers the reference's pretrained
bootstrap (``se_resnet50-ce0d4300.pth`` into BoTSER50's layers 0-3,
unetplusplusstar.py:282-284) and the mmcv-style checkpoint reader
(util/checkpoint.py: the ``module.`` prefix strip, the ``state_dict`` /
``model_state_dict`` containers, a non-strict load with a key-diff report,
l.18-78, 213-214).

Layout rules:
* conv weights OIHW → HWIO
* linear weights (out, in) → (in, out)
* SENet's 1×1-conv SE gates → Dense kernels (squeeze + transpose)
* BN: weight/bias → params scale/bias; running_mean/var → batch_stats

The two resizes the JAX module does with ``jax.image.resize`` (a Swin
relative-position table, bicubic; a ViT position grid, bilinear) are
:func:`resize`, the same separable weights (antialiased when they shrink)
in fp32 numpy.

Scope: local files only; remote checkpoint URIs are not resolved
(download the ``.pth`` out of band and pass its path).
"""

from __future__ import annotations

import logging
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np

logger = logging.getLogger("eyediseasesegmentation_tpu_torch")


def to_numpy(t) -> np.ndarray:
    """torch tensor (or array) → numpy."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def conv_kernel(t) -> np.ndarray:
    """OIHW → HWIO."""
    return to_numpy(t).transpose(2, 3, 1, 0)


def dense_kernel(t) -> np.ndarray:
    """(out, in) → (in, out); also squeezes 1×1-conv SE gates (out,in,1,1)."""
    a = to_numpy(t)
    if a.ndim == 4:
        a = a[:, :, 0, 0]
    return a.transpose(1, 0)


def load_torch_checkpoint(path) -> Dict[str, Any]:
    """torch.load a checkpoint, unwrap state-dict containers, strip 'module.'
    (reference checkpoint.py:107-137, 213-214)."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("model_state_dict", "state_dict", "model"):
        if isinstance(ckpt, dict) and key in ckpt:
            ckpt = ckpt[key]
            break
    return {re.sub(r"^module\.", "", k): v for k, v in ckpt.items()}


def _set(tree: Dict, path: Tuple[str, ...], value: np.ndarray, report: Dict):
    node = tree
    for p in path[:-1]:
        if p not in node:
            report["missing_in_jax"].append("/".join(path))
            return
        node = node[p]
    leaf = path[-1]
    if leaf not in node:
        report["missing_in_jax"].append("/".join(path))
        return
    if tuple(node[leaf].shape) != tuple(value.shape):
        report["shape_mismatch"].append(
            ("/".join(path), tuple(node[leaf].shape), tuple(value.shape)))
        return
    node[leaf] = value.astype(np.asarray(node[leaf]).dtype)
    report["loaded"].append("/".join(path))


def import_senet(state_dict: Dict[str, Any], params: Dict, batch_stats: Dict,
                 prefix: Tuple[str, ...] = ("seresnet",),
                 num_stages: int = 3,
                 stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)) -> Dict[str, Any]:
    """Map a pytorch_toolbelt/senet-family state_dict (se_resnet50,
    se_resnext50/101_32x4d) onto a ResNetEncoder tree in flax naming (in
    place on mutable dict copies).

    senet names: layer0.conv1/bn1; layerN.M.{conv1..3,bn1..3},
    se_module.fc1/fc2, downsample.{0,1}. Grouped 3×3 convs (ResNeXt) need no
    special-casing: torch (O, I/g, 3, 3) → flax HWIO (3, 3, I/g, O).
    Returns a key-diff report (the reference's non-strict load,
    checkpoint.py:18-78).
    """
    report = {"loaded": [], "missing_in_jax": [], "shape_mismatch": [],
              "unused_torch": []}
    used = set()

    def take(name):
        used.add(name)
        return state_dict[name]

    def bn(torch_prefix, jax_prefix):
        _set(params, jax_prefix + ("scale",), to_numpy(take(f"{torch_prefix}.weight")), report)
        _set(params, jax_prefix + ("bias",), to_numpy(take(f"{torch_prefix}.bias")), report)
        _set(batch_stats, jax_prefix + ("mean",), to_numpy(take(f"{torch_prefix}.running_mean")), report)
        _set(batch_stats, jax_prefix + ("var",), to_numpy(take(f"{torch_prefix}.running_var")), report)

    # stem
    _set(params, prefix + ("stem_conv", "kernel"),
         conv_kernel(take("layer0.conv1.weight")), report)
    bn("layer0.bn1", prefix + ("stem_bn",))

    # residual stages
    for stage in range(1, num_stages + 1):
        for blk in range(stage_sizes[stage - 1]):
            tp = f"layer{stage}.{blk}"
            jp = prefix + (f"layer{stage}_block{blk}",)
            for ci in (1, 2, 3):
                if f"{tp}.conv{ci}.weight" not in state_dict:
                    continue
                _set(params, jp + (f"conv{ci}", "kernel"),
                     conv_kernel(take(f"{tp}.conv{ci}.weight")), report)
                bn(f"{tp}.bn{ci}", jp + (f"bn{ci}",))
            # SE gates: fc1/fc2 1x1 convs (or linears) → Dense_0 / Dense_1
            for fc, dense in (("fc1", "Dense_0"), ("fc2", "Dense_1")):
                wname = f"{tp}.se_module.{fc}.weight"
                if wname in state_dict:
                    _set(params, jp + ("se", dense, "kernel"),
                         dense_kernel(take(wname)), report)
                    bname = f"{tp}.se_module.{fc}.bias"
                    if bname in state_dict:
                        _set(params, jp + ("se", dense, "bias"),
                             to_numpy(take(bname)), report)
            if f"{tp}.downsample.0.weight" in state_dict:
                _set(params, jp + ("down_conv", "kernel"),
                     conv_kernel(take(f"{tp}.downsample.0.weight")), report)
                bn(f"{tp}.downsample.1", jp + ("down_bn",))

    report["unused_torch"] = [k for k in state_dict if k not in used
                              and not k.endswith("num_batches_tracked")]
    logger.info("torch import: %d loaded, %d missing, %d mismatched, %d unused",
                len(report["loaded"]), len(report["missing_in_jax"]),
                len(report["shape_mismatch"]), len(report["unused_torch"]))
    return report


# back-compat alias (round-1 API)
def import_se_resnet50(state_dict, params, batch_stats,
                       prefix: Tuple[str, ...] = ("seresnet",),
                       num_stages: int = 3) -> Dict[str, Any]:
    return import_senet(state_dict, params, batch_stats, prefix=prefix,
                        num_stages=num_stages, stage_sizes=(3, 4, 6, 3))


# ---------------------------------------------------------------------------
# Swin (reference util/checkpoint.py:213-246: 'module.' strip + absolute
# pos-embed reshape + relative-position-bias-table bicubic interpolation)
# ---------------------------------------------------------------------------

def _keys_cubic(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    out = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x
                              - np.float32(4.0)) * x + np.float32(2.0), out)
    return np.where(x >= 2.0, np.float32(0.0), out)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))


KERNELS = {"cubic": _keys_cubic, "linear": _triangle}


def _weights(n_in: int, n_out: int, kernel) -> np.ndarray:
    """(n_in, n_out) fp32 weights of ``jax.image.resize`` along one axis:
    half-pixel centres, the kernel widened by n_in / n_out when it shrinks
    (antialias), each column normalised, none outside the input."""
    f32 = np.float32
    inv_scale = f32(1.0) / (f32(n_out) / f32(n_in))
    kscale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kscale
    w = kernel(x.astype(f32)).astype(f32)
    total = w.sum(0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize(a: np.ndarray, shape: Tuple[int, ...],
           method: str = "linear") -> np.ndarray:
    """``jax.image.resize(a, shape, method)`` for ``method`` "linear" or
    "cubic" in fp32 numpy: each axis whose size changes, in order, is
    contracted with its :func:`_weights`."""
    out = np.asarray(a, np.float32)
    for axis, n_out in enumerate(shape):
        n_in = out.shape[axis]
        if n_in == n_out:
            continue
        w = _weights(n_in, n_out, KERNELS[method])
        out = np.moveaxis(np.tensordot(out, w, axes=([axis], [0])), -1, axis)
    return out.astype(np.float32)


def resize_rel_bias_table(table: np.ndarray, dst_rows: int) -> np.ndarray:
    """Bicubicly resize a ((2w1-1)², H) relative-position-bias table to
    ((2w2-1)², H) — the reference's window-size adaptation
    (checkpoint.py:229-243)."""
    L1, H = table.shape
    S1 = int(round(np.sqrt(L1)))
    S2 = int(round(np.sqrt(dst_rows)))
    if S1 * S1 != L1 or S2 * S2 != dst_rows:
        raise ValueError(f"non-square bias tables: {L1} -> {dst_rows}")
    if S1 == S2:
        return table
    grid = table.reshape(S1, S1, H)
    return resize(grid, (S2, S2, H), "cubic").reshape(S2 * S2, H)


def import_swin(state_dict: Dict[str, Any], params: Dict,
                prefix: Tuple[str, ...] = (),
                depths: Tuple[int, ...] = (2, 2, 6, 2)) -> Dict[str, Any]:
    """Map an official Swin state_dict (layers.{i}.blocks.{j}.attn...) onto
    the flax ``SwinTransformer`` tree.

    Layout notes:
    * qkv/proj/mlp Dense: (out,in) → (in,out); biases copied.
    * patch_embed.proj 4×4 conv: OIHW → HWIO.
    * patch-merging: torch concatenates (0,0),(1,0),(0,1),(1,1) 2×2 sub-pixels;
      the flax reshape produces (0,0),(0,1),(1,0),(1,1) — the reduction weight
      and merge norm are permuted accordingly.
    * relative_position_bias_table rows are bicubicly resized when the flax
      window (snapped to the feature size) differs from torch's 7
      (reference checkpoint.py:229-243). Swin-T/S have no absolute pos embed.
    Swin blocks are flat in the flax tree as stage{s}_block{i}.
    """
    report = {"loaded": [], "missing_in_jax": [], "shape_mismatch": [],
              "unused_torch": []}
    used = set()

    def take(name):
        used.add(name)
        return state_dict[name]

    def dense(tname, jpath, transform=dense_kernel):
        _set(params, jpath + ("kernel",), transform(take(f"{tname}.weight")), report)
        if f"{tname}.bias" in state_dict:
            _set(params, jpath + ("bias",), to_numpy(take(f"{tname}.bias")), report)

    def ln(tname, jpath):
        _set(params, jpath + ("scale",), to_numpy(take(f"{tname}.weight")), report)
        _set(params, jpath + ("bias",), to_numpy(take(f"{tname}.bias")), report)

    # patch embed conv + following LayerNorm (flax auto-name LayerNorm_0)
    _set(params, prefix + ("patch_embed", "kernel"),
         conv_kernel(take("patch_embed.proj.weight")), report)
    _set(params, prefix + ("patch_embed", "bias"),
         to_numpy(take("patch_embed.proj.bias")), report)
    ln("patch_embed.norm", prefix + ("LayerNorm_0",))

    # torch merge order (0,0),(1,0),(0,1),(1,1) -> flax (0,0),(0,1),(1,0),(1,1)
    def merge_perm(c):
        order = np.array([0, 2, 1, 3])
        return np.concatenate([np.arange(c) + o * c for o in order])

    for stage, depth in enumerate(depths):
        if stage > 0:
            # patch merging: flax auto-names LayerNorm_{stage}, Dense_{stage-1}
            cc = to_numpy(state_dict[f"layers.{stage - 1}.downsample.norm.weight"]).shape[0] // 4
            perm = merge_perm(cc)
            w = to_numpy(take(f"layers.{stage - 1}.downsample.reduction.weight"))
            _set(params, prefix + (f"Dense_{stage - 1}", "kernel"),
                 w.transpose(1, 0)[perm], report)
            nw = to_numpy(take(f"layers.{stage - 1}.downsample.norm.weight"))[perm]
            nb = to_numpy(take(f"layers.{stage - 1}.downsample.norm.bias"))[perm]
            _set(params, prefix + (f"LayerNorm_{stage}", "scale"), nw, report)
            _set(params, prefix + (f"LayerNorm_{stage}", "bias"), nb, report)
        for blk in range(depth):
            tp = f"layers.{stage}.blocks.{blk}"
            jp = prefix + (f"stage{stage}_block{blk}",)
            ln(f"{tp}.norm1", jp + ("LayerNorm_0",))
            ln(f"{tp}.norm2", jp + ("LayerNorm_1",))
            att = jp + ("WindowAttention_0",)
            dense(f"{tp}.attn.qkv", att + ("Dense_0",))
            dense(f"{tp}.attn.proj", att + ("Dense_1",))
            dense(f"{tp}.mlp.fc1", jp + ("Dense_0",))
            dense(f"{tp}.mlp.fc2", jp + ("Dense_1",))
            # relative position bias table, window-resized on mismatch
            tbl = to_numpy(take(f"{tp}.attn.relative_position_bias_table"))
            used.add(f"{tp}.attn.relative_position_index")
            node = params
            ok = True
            for p in att:
                if p not in node:
                    ok = False
                    break
                node = node[p]
            if ok and "rel_bias" in node:
                dst = node["rel_bias"].shape[0]
                _set(params, att + ("rel_bias",),
                     resize_rel_bias_table(tbl, dst), report)
            else:
                report["missing_in_jax"].append("/".join(att) + "/rel_bias")

    report["unused_torch"] = [k for k in state_dict if k not in used]
    logger.info("swin import: %d loaded, %d missing, %d mismatched, %d unused",
                len(report["loaded"]), len(report["missing_in_jax"]),
                len(report["shape_mismatch"]), len(report["unused_torch"]))
    return report


# ---------------------------------------------------------------------------
# Top-level entry: checkpoint (path or state_dict) -> model variables
# ---------------------------------------------------------------------------

ARCH_STAGE_SIZES = {
    "se_resnet50": (3, 4, 6, 3),
    "seresnet50": (3, 4, 6, 3),
    "se_resnext50": (3, 4, 6, 3),
    "seresnext50": (3, 4, 6, 3),
    "se_resnext101": (3, 4, 23, 3),
    "seresnext101": (3, 4, 23, 3),
}


def import_mit(state_dict: Dict[str, Any], params: Dict,
               prefix: Tuple[str, ...] = (),
               depths: Tuple[int, ...] = (2, 2, 2, 2)) -> Dict[str, Any]:
    """Map an official Segformer/MixViT state_dict (patch_embed{s}.*,
    block{s}.{i}.*, norm{s}.* — reference segformerstar.py:139-347, loaded at
    l.401-414) onto the flax ``MixVisionTransformer`` tree.

    Layout notes:
    * the torch ``attn.kv`` Linear (dim → 2·dim) splits into the flax k/v
      Dense pair (rows [:dim] / [dim:]);
    * ``mlp.dwconv.dwconv`` is a depthwise 3×3: (C,1,3,3) OIHW → (3,3,1,C);
    * SRAttention submodule order: Dense_0=q, [Conv_0=sr, LayerNorm_0=sr-norm
      when sr_ratio>1], Dense_1=k, Dense_2=v, Dense_3=proj.
    """
    report = {"loaded": [], "missing_in_jax": [], "shape_mismatch": [],
              "unused_torch": []}
    used = set()

    def take(name):
        used.add(name)
        return state_dict[name]

    def dense(tname, jpath):
        _set(params, jpath + ("kernel",), dense_kernel(take(f"{tname}.weight")),
             report)
        if f"{tname}.bias" in state_dict:
            _set(params, jpath + ("bias",), to_numpy(take(f"{tname}.bias")),
                 report)

    def ln(tname, jpath):
        _set(params, jpath + ("scale",), to_numpy(take(f"{tname}.weight")), report)
        _set(params, jpath + ("bias",), to_numpy(take(f"{tname}.bias")), report)

    for s, depth in enumerate(depths):
        t_embed = f"patch_embed{s + 1}"
        j_embed = prefix + (f"embed{s}",)
        _set(params, j_embed + ("Conv_0", "kernel"),
             conv_kernel(take(f"{t_embed}.proj.weight")), report)
        _set(params, j_embed + ("Conv_0", "bias"),
             to_numpy(take(f"{t_embed}.proj.bias")), report)
        ln(f"{t_embed}.norm", j_embed + ("LayerNorm_0",))
        for i in range(depth):
            tb = f"block{s + 1}.{i}"
            jb = prefix + (f"stage{s}_block{i}",)
            ln(f"{tb}.norm1", jb + ("LayerNorm_0",))
            ln(f"{tb}.norm2", jb + ("LayerNorm_1",))
            att = jb + ("SRAttention_0",)
            dense(f"{tb}.attn.q", att + ("Dense_0",))
            kv_w = to_numpy(take(f"{tb}.attn.kv.weight"))  # (2C, C)
            c = kv_w.shape[0] // 2
            _set(params, att + ("Dense_1", "kernel"),
                 kv_w[:c].transpose(1, 0), report)
            _set(params, att + ("Dense_2", "kernel"),
                 kv_w[c:].transpose(1, 0), report)
            if f"{tb}.attn.kv.bias" in state_dict:
                kv_b = to_numpy(take(f"{tb}.attn.kv.bias"))
                _set(params, att + ("Dense_1", "bias"), kv_b[:c], report)
                _set(params, att + ("Dense_2", "bias"), kv_b[c:], report)
            if f"{tb}.attn.sr.weight" in state_dict:
                _set(params, att + ("Conv_0", "kernel"),
                     conv_kernel(take(f"{tb}.attn.sr.weight")), report)
                _set(params, att + ("Conv_0", "bias"),
                     to_numpy(take(f"{tb}.attn.sr.bias")), report)
                ln(f"{tb}.attn.norm", att + ("LayerNorm_0",))
            dense(f"{tb}.attn.proj", att + ("Dense_3",))
            ffn = jb + ("MixFFN_0",)
            dense(f"{tb}.mlp.fc1", ffn + ("Dense_0",))
            _set(params, ffn + ("Conv_0", "kernel"),
                 conv_kernel(take(f"{tb}.mlp.dwconv.dwconv.weight")), report)
            _set(params, ffn + ("Conv_0", "bias"),
                 to_numpy(take(f"{tb}.mlp.dwconv.dwconv.bias")), report)
            dense(f"{tb}.mlp.fc2", ffn + ("Dense_1",))
        ln(f"norm{s + 1}", prefix + (f"norm{s}",))

    report["unused_torch"] = sorted(set(state_dict) - used)
    return report


def import_vit_npz(npz, variables: Dict[str, Any],
                   hybrid: bool = True) -> Tuple[Dict, Dict]:
    """Load an official ViT ``.npz`` checkpoint (ViT-B_16 / R50+ViT-B_16)
    into a flax ``TransUnet`` (reference transunet.py:528-546 +
    load_from l.404-455).

    Mappings:
    * ``embedding/kernel`` (HWIO already) → patch_proj (hybrid) or
      patch_embed; ``Transformer/encoder_norm`` → the post-block LayerNorm.
    * ``Transformer/posembed_input/pos_embedding``: the class token is
      dropped and the grid bilinearly resized on size mismatch (the
      reference uses scipy zoom order=1; here :func:`resize` "linear", as
      the JAX package's ``jax.image.resize``).
    * encoderblock_N: separate query/key/value kernels (hidden, heads, hd)
      reshape to (hidden, hidden) and concatenate into the fused qkv Dense;
      ``out`` reshapes (heads, hd, hidden). NOTE the reference deliberately
      (or not — the lines are commented out, transunet.py:210-218) skips the
      MLP weights; MlpBlock_3/Dense_0/1 are loaded here, as in JAX.
    * hybrid ResNetV2 trunk: conv_root/gn_root + block{b}/unit{u}
      conv1-3/gn1-3/conv_proj/gn_proj, all HWIO natively.

    ``npz``: a path or a dict-like of numpy arrays. Returns
    (new_variables, report).
    """
    if not hasattr(npz, "keys"):
        npz = np.load(npz)
    report = {"loaded": [], "missing_in_jax": [], "shape_mismatch": [],
              "unused_torch": []}
    used = set()

    def take(name):
        used.add(name)
        return np.asarray(npz[name])

    params = _to_mutable(variables["params"])

    # patch embedding + final encoder norm
    embed_key = "patch_proj" if hybrid else "patch_embed"
    if embed_key in params:
        _set(params, (embed_key, "kernel"), take("embedding/kernel"), report)
        _set(params, (embed_key, "bias"), take("embedding/bias"), report)
    _set(params, ("LayerNorm_0", "scale"),
         take("Transformer/encoder_norm/scale"), report)
    _set(params, ("LayerNorm_0", "bias"),
         take("Transformer/encoder_norm/bias"), report)

    # position embeddings: drop cls, resize grid on mismatch
    pos = take("Transformer/posembed_input/pos_embedding")
    if "pos_embed" in params:
        dst = params["pos_embed"].shape  # (1, L, C)
        grid = pos
        if int(np.sqrt(pos.shape[1])) ** 2 != pos.shape[1]:
            grid = pos[:, 1:]  # drop the class token (transunet.py:419-421)
        if grid.shape != tuple(dst):
            gs_old = int(np.sqrt(grid.shape[1]))
            gs_new = int(np.sqrt(dst[1]))
            g = grid.reshape(gs_old, gs_old, -1)
            g = resize(g, (gs_new, gs_new, g.shape[-1]), "linear")
            grid = g.reshape(1, gs_new * gs_new, -1)
        _set(params, ("pos_embed",), grid.astype(np.float32), report)

    # encoder blocks
    att = "MultiHeadDotProductAttention_1"
    n_blocks = sum(1 for k in params if re.match(r"vit\d+$", k))
    for i in range(n_blocks):
        root = f"Transformer/encoderblock_{i}"
        jb = (f"vit{i}",)
        hidden = take(f"{root}/{att}/query/kernel").shape[0]
        q = take(f"{root}/{att}/query/kernel").reshape(hidden, hidden)
        k = take(f"{root}/{att}/key/kernel").reshape(hidden, hidden)
        v = take(f"{root}/{att}/value/kernel").reshape(hidden, hidden)
        _set(params, jb + ("Dense_0", "kernel"),
             np.concatenate([q, k, v], axis=1), report)
        qb = take(f"{root}/{att}/query/bias").reshape(-1)
        kb = take(f"{root}/{att}/key/bias").reshape(-1)
        vb = take(f"{root}/{att}/value/bias").reshape(-1)
        _set(params, jb + ("Dense_0", "bias"),
             np.concatenate([qb, kb, vb]), report)
        _set(params, jb + ("Dense_1", "kernel"),
             take(f"{root}/{att}/out/kernel").reshape(hidden, hidden), report)
        _set(params, jb + ("Dense_1", "bias"),
             take(f"{root}/{att}/out/bias").reshape(-1), report)
        _set(params, jb + ("LayerNorm_0", "scale"),
             take(f"{root}/LayerNorm_0/scale"), report)
        _set(params, jb + ("LayerNorm_0", "bias"),
             take(f"{root}/LayerNorm_0/bias"), report)
        _set(params, jb + ("LayerNorm_1", "scale"),
             take(f"{root}/LayerNorm_2/scale"), report)
        _set(params, jb + ("LayerNorm_1", "bias"),
             take(f"{root}/LayerNorm_2/bias"), report)
        _set(params, jb + ("Dense_2", "kernel"),
             take(f"{root}/MlpBlock_3/Dense_0/kernel"), report)
        _set(params, jb + ("Dense_2", "bias"),
             take(f"{root}/MlpBlock_3/Dense_0/bias"), report)
        _set(params, jb + ("Dense_3", "kernel"),
             take(f"{root}/MlpBlock_3/Dense_1/kernel"), report)
        _set(params, jb + ("Dense_3", "bias"),
             take(f"{root}/MlpBlock_3/Dense_1/bias"), report)

    # hybrid ResNetV2 trunk
    if hybrid and "trunk" in params and "conv_root/kernel" in npz:
        trunk = params["trunk"]
        _set(trunk, ("root_conv", "kernel"), take("conv_root/kernel"), report)
        _set(trunk, ("root_gn", "scale"), take("gn_root/scale").reshape(-1),
             report)
        _set(trunk, ("root_gn", "bias"), take("gn_root/bias").reshape(-1),
             report)
        for name in list(trunk):
            m = re.match(r"block(\d+)_unit(\d+)$", name)
            if not m:
                continue
            broot = f"block{m.group(1)}/unit{m.group(2)}"
            for conv in ("conv1", "conv2", "conv3"):
                _set(trunk, (name, conv, "kernel"),
                     take(f"{broot}/{conv}/kernel"), report)
            for gn in ("gn1", "gn2", "gn3"):
                _set(trunk, (name, gn, "scale"),
                     take(f"{broot}/{gn}/scale").reshape(-1), report)
                _set(trunk, (name, gn, "bias"),
                     take(f"{broot}/{gn}/bias").reshape(-1), report)
            if "downsample" in trunk[name]:
                _set(trunk, (name, "downsample", "kernel"),
                     take(f"{broot}/conv_proj/kernel"), report)
                _set(trunk, (name, "gn_proj", "scale"),
                     take(f"{broot}/gn_proj/scale").reshape(-1), report)
                _set(trunk, (name, "gn_proj", "bias"),
                     take(f"{broot}/gn_proj/bias").reshape(-1), report)

    report["unused_torch"] = sorted(set(npz.keys()) - used)
    new_vars = {**variables, "params": params}
    return new_vars, report


def _to_mutable(d):
    if isinstance(d, dict) or hasattr(d, "items"):
        return {k: _to_mutable(v) for k, v in d.items()}
    return d


def import_torch_checkpoint(path_or_state_dict, variables: Dict[str, Any],
                            arch: str = "se_resnet50",
                            encoder_key: str = "encoder",
                            backbone_key: Optional[str] = None) -> Tuple[Dict, Dict]:
    """Load torch pretrained encoder weights into a model's variables (the
    flax-layout ``{"params", "batch_stats"}`` of ``convert.torch_to_flax``).

    ``arch``: se_resnet50 / se_resnext50 / se_resnext101 (senet family) or
    swin_tiny / swin_small. ``encoder_key`` names the encoder subtree in
    ``variables['params']``; ``backbone_key`` an optional nested subtree
    ('seresnet' inside BoTSER50Encoder, 'swin' inside SwinPyramidEncoder;
    auto-detected when present). Returns (new_variables, report) — the
    non-strict load with key-diff report of reference checkpoint.py:18-78.

    Reference parity: unetplusplusstar.py:282-284 (se_resnet50 → BoTSER50),
    hubmap_kaggle.py:124 (se_resnext101), checkpoint.py:213-246 (Swin).
    """
    if isinstance(path_or_state_dict, dict):
        state_dict = {re.sub(r"^module\.", "", k): v
                      for k, v in path_or_state_dict.items()}
    else:
        state_dict = load_torch_checkpoint(path_or_state_dict)

    params = _to_mutable(variables["params"])
    batch_stats = _to_mutable(variables.get("batch_stats", {}))

    enc_params = params.get(encoder_key, params)
    enc_stats = batch_stats.get(encoder_key, batch_stats)

    if backbone_key is None:  # auto-detect known nested backbones
        for cand in ("seresnet", "swin", "mit"):
            if cand in enc_params:
                backbone_key = cand
                break
    if backbone_key:
        enc_params = enc_params[backbone_key]
        enc_stats = enc_stats.get(backbone_key, {}) if hasattr(enc_stats, "get") else {}

    if arch in ARCH_STAGE_SIZES:
        num_stages = sum(1 for k in enc_params if re.match(r"layer\d+_block0$", k))
        report = import_senet(state_dict, enc_params, enc_stats,
                              prefix=(), num_stages=num_stages,
                              stage_sizes=ARCH_STAGE_SIZES[arch])
    elif arch.startswith("swin"):
        from ..models.transformers import SWIN_CONFIGS
        depths = SWIN_CONFIGS.get(arch, SWIN_CONFIGS["swin_tiny"])["depths"]
        report = import_swin(state_dict, enc_params, prefix=(), depths=depths)
    elif arch.startswith("mit"):
        from ..models.transformers import MIT_CONFIGS
        depths = MIT_CONFIGS.get(arch, MIT_CONFIGS["mit_b0"])["depths"]
        report = import_mit(state_dict, enc_params, prefix=(), depths=depths)
    else:
        raise KeyError(f"no importer for arch '{arch}'")

    new_vars = {**variables, "params": params, "batch_stats": batch_stats}
    return new_vars, report


def load_pretrained_encoder(variables: Dict[str, Any], checkpoint_path,
                            arch: str = "se_resnet50",
                            encoder_key: str = "encoder") -> Tuple[Dict, Dict]:
    """Load torch pretrained weights into a model's encoder subtree.

    Returns (new_variables, report). Unknown architectures raise.
    """
    return import_torch_checkpoint(checkpoint_path, variables, arch=arch,
                                   encoder_key=encoder_key)
