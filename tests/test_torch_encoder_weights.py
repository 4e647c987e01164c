"""Port parity: ``encoder_weights``, the torch ``.pth`` import.

One ``.pth`` (se_resnet50's names and shapes, layers 0-4 and
``last_linear``, with random values: ``chip_smoke.senet_state_dict``,
written with ``torch.save``) goes through the JAX package's
``import_torch_checkpoint`` and through the port's
``Trainer(encoder_weights=...)``: the flagship's leaves after ``convert``
are the JAX result bit for bit, from the same initial tree, and the
key-diff reports are equal. An official-layout Swin-T and MiT-b0 state
dict and a hybrid ViT ``.npz`` go through both packages' importers on the
port's trees at 64²; their resized tables (bicubic Swin bias tables, the
bilinear ViT position grid, both antialiased as they shrink) agree within
``RESIZE_TOL`` of the leaf's largest (the two einsum orders round apart),
every other leaf bit for bit.
"""

import re

import numpy as np
import pytest
import torch

from eyediseasesegmentation_tpu.utils import torch_import as JTI
from eyediseasesegmentation_tpu_torch import models
from eyediseasesegmentation_tpu_torch.convert import torch_to_flax
from eyediseasesegmentation_tpu_torch.train import trainer as trainer_module
from eyediseasesegmentation_tpu_torch.train.trainer import Trainer
from eyediseasesegmentation_tpu_torch.utils import torch_import as TTI
from chip_smoke import senet_state_dict

RESIZE_TOL = 1e-6


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _same(got, want, loose=()):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for k, w in want.items():
        if any(s in k for s in loose):
            top = max(float(np.abs(w).max()), 1e-30)
            assert np.abs(got[k] - w).max() <= RESIZE_TOL * top, k
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=str(k))


def test_flagship_encoder_weights_match_jax(tmp_path, monkeypatch):
    ckpt = tmp_path / "se_resnet50.pth"
    torch.save(senet_state_dict(torch.Generator().manual_seed(3)), ckpt)
    params = {"encoder_name": "BoTSER50_Axial_Imagenet_3", "base_dim": 2,
              "decoder_attention_type": "scse", "classes": 1}
    cfg = {"model_name": "unetplusplusstar", "model_params": params,
           "is_fp16": False, "encoder_weights": str(ckpt)}
    starts = []

    def keep_start(path, variables, **kw):
        # the tree before the import (the importer copies what it changes)
        starts.append(variables)
        return TTI.import_torch_checkpoint(path, variables, **kw)

    monkeypatch.setattr(trainer_module, "import_torch_checkpoint",
                        keep_start)
    trainer = Trainer(cfg, seed=11, device="cpu")
    before = starts[0]["params"]["decoder"]["x_0_0"]["conv1"]["conv"]
    np.testing.assert_array_equal(     # the rest kept from init_flax
        torch_to_flax(trainer.model.decoder.x_0_0.conv1.conv)["params"][
            "kernel"], before["kernel"])
    want, jreport = JTI.import_torch_checkpoint(str(ckpt), starts[0],
                                                arch="se_resnet50")
    got = torch_to_flax(trainer.model)
    _same(got, want)
    assert trainer.encoder_report == jreport
    assert len(jreport["loaded"]) > 250 and not jreport["missing_in_jax"]
    assert not jreport["shape_mismatch"]
    assert {k.split(".")[0] for k in jreport["unused_torch"]} == {
        "layer4", "last_linear"}           # BoTSER50's layer4 is axial
    stem = got["params"]["encoder"]["seresnet"]["stem_conv"]["kernel"]
    sd = torch.load(ckpt)
    np.testing.assert_array_equal(stem, JTI.conv_kernel(
        sd["layer0.conv1.weight"]))
    assert trainer.freeze_bn_scopes == ("encoder",)


def _swin_state_dict(rng):
    dims, depths, heads = (96, 192, 384, 768), (2, 2, 6, 2), (3, 6, 12, 24)
    r = lambda *s: rng.randn(*s).astype(np.float32)
    sd = {"patch_embed.proj.weight": r(96, 3, 4, 4),
          "patch_embed.proj.bias": r(96), "patch_embed.norm.weight": r(96),
          "patch_embed.norm.bias": r(96)}
    for s, (dim, depth, h) in enumerate(zip(dims, depths, heads)):
        if s > 0:
            sd[f"layers.{s - 1}.downsample.reduction.weight"] = r(
                dim, 4 * dims[s - 1])
            sd[f"layers.{s - 1}.downsample.norm.weight"] = r(4 * dims[s - 1])
            sd[f"layers.{s - 1}.downsample.norm.bias"] = r(4 * dims[s - 1])
        for b in range(depth):
            p = f"layers.{s}.blocks.{b}"
            for nm, shape in (("norm1", (dim,)), ("norm2", (dim,)),
                              ("attn.qkv", (3 * dim, dim)),
                              ("attn.proj", (dim, dim)),
                              ("mlp.fc1", (4 * dim, dim)),
                              ("mlp.fc2", (dim, 4 * dim))):
                sd[f"{p}.{nm}.weight"] = r(*shape)
                sd[f"{p}.{nm}.bias"] = r(shape[0])
            sd[f"{p}.attn.relative_position_bias_table"] = r(169, h)
            sd[f"{p}.attn.relative_position_index"] = np.zeros((49, 49),
                                                               np.int64)
    return sd


def _mit_state_dict(rng):
    dims, depths, srs = (32, 64, 160, 256), (2, 2, 2, 2), (8, 4, 2, 1)
    r = lambda *s: (rng.randn(*s) * 0.05).astype(np.float32)
    sd = {}
    for s, (dim, depth) in enumerate(zip(dims, depths)):
        cin, patch = (3, 7) if s == 0 else (dims[s - 1], 3)
        sd[f"patch_embed{s + 1}.proj.weight"] = r(dim, cin, patch, patch)
        for nm, n in (("proj.bias", dim), ("norm.weight", dim),
                      ("norm.bias", dim)):
            sd[f"patch_embed{s + 1}.{nm}"] = r(n)
        for i in range(depth):
            p = f"block{s + 1}.{i}"
            for nm, shape in (("norm1", (dim,)), ("norm2", (dim,)),
                              ("attn.q", (dim, dim)),
                              ("attn.kv", (2 * dim, dim)),
                              ("attn.proj", (dim, dim)),
                              ("mlp.fc1", (4 * dim, dim)),
                              ("mlp.fc2", (dim, 4 * dim))):
                sd[f"{p}.{nm}.weight"] = r(*shape)
                sd[f"{p}.{nm}.bias"] = r(shape[0])
            if srs[s] > 1:
                sd[f"{p}.attn.sr.weight"] = r(dim, dim, srs[s], srs[s])
                for nm in ("attn.sr.bias", "attn.norm.weight",
                           "attn.norm.bias"):
                    sd[f"{p}.{nm}"] = r(dim)
            sd[f"{p}.mlp.dwconv.dwconv.weight"] = r(4 * dim, 1, 3, 3)
            sd[f"{p}.mlp.dwconv.dwconv.bias"] = r(4 * dim)
        sd[f"norm{s + 1}.weight"] = r(dim)
        sd[f"norm{s + 1}.bias"] = r(dim)
    return sd


@pytest.mark.parametrize("name,params,arch,make", [
    ("swin_tiny_attunet", {"input_size": 64}, "swin_tiny", _swin_state_dict),
    ("SegFormerStar", {"encoder_name": "mit_b0"}, "mit_b0", _mit_state_dict),
])
def test_transformer_imports_match_jax(name, params, arch, make):
    tree = torch_to_flax(models.get_model(name, params, device="cpu"))
    sd = make(np.random.RandomState(0))
    want, jreport = JTI.import_torch_checkpoint(dict(sd), tree, arch=arch)
    got, report = TTI.import_torch_checkpoint(dict(sd), tree, arch=arch)
    assert report == jreport
    assert not report["missing_in_jax"] and not report["shape_mismatch"]
    assert not report["unused_torch"]
    _same(got, want, loose=("rel_bias",))


def _vit_npz(params, rng):
    r = lambda *s: (rng.randn(*s) * 0.05).astype(np.float32)
    trunk = params["trunk"]
    npz = {"conv_root/kernel": r(*trunk["root_conv"]["kernel"].shape)}
    c = trunk["root_gn"]["scale"].shape[0]
    npz["gn_root/scale"], npz["gn_root/bias"] = r(1, 1, 1, c), r(1, 1, 1, c)
    for name, sub in trunk.items():
        m = re.match(r"block(\d+)_unit(\d+)$", name)
        if not m:
            continue
        root = f"block{m.group(1)}/unit{m.group(2)}"
        for conv in ("conv1", "conv2", "conv3"):
            npz[f"{root}/{conv}/kernel"] = r(*sub[conv]["kernel"].shape)
        gns = ["gn1", "gn2", "gn3"]
        if "downsample" in sub:
            npz[f"{root}/conv_proj/kernel"] = r(
                *sub["downsample"]["kernel"].shape)
            gns.append("gn_proj")
        for gn in gns:
            c = sub[gn]["scale"].shape[0]
            npz[f"{root}/{gn}/scale"] = r(1, 1, 1, c)
            npz[f"{root}/{gn}/bias"] = r(1, 1, 1, c)
    npz["embedding/kernel"] = r(*params["patch_proj"]["kernel"].shape)
    for k in ("embedding/bias", "Transformer/encoder_norm/scale",
              "Transformer/encoder_norm/bias"):
        npz[k] = r(64)
    npz["Transformer/posembed_input/pos_embedding"] = r(1, 197, 64)
    att = "MultiHeadDotProductAttention_1"
    for i in range(2):
        root = f"Transformer/encoderblock_{i}"
        for nm in ("query", "key", "value"):
            npz[f"{root}/{att}/{nm}/kernel"] = r(64, 4, 16)
            npz[f"{root}/{att}/{nm}/bias"] = r(4, 16)
        npz[f"{root}/{att}/out/kernel"] = r(4, 16, 64)
        npz[f"{root}/{att}/out/bias"] = r(64)
        for ln in ("LayerNorm_0", "LayerNorm_2"):
            npz[f"{root}/{ln}/scale"] = r(64)
            npz[f"{root}/{ln}/bias"] = r(64)
        npz[f"{root}/MlpBlock_3/Dense_0/kernel"] = r(64, 256)
        npz[f"{root}/MlpBlock_3/Dense_0/bias"] = r(256)
        npz[f"{root}/MlpBlock_3/Dense_1/kernel"] = r(256, 64)
        npz[f"{root}/MlpBlock_3/Dense_1/bias"] = r(64)
    return npz


def test_vit_npz_import_matches_jax():
    model = models.get_model("transunet_r50", {
        "input_size": 64, "hidden": 64, "depth": 2, "heads": 4,
        "decoder_channels": (32, 16, 8, 8)}, device="cpu")
    tree = torch_to_flax(model)
    npz = _vit_npz(tree["params"], np.random.RandomState(1))
    want, jreport = JTI.import_vit_npz(dict(npz), tree, hybrid=True)
    got, report = TTI.import_vit_npz(dict(npz), tree, hybrid=True)
    assert report == jreport and not report["unused_torch"]
    assert not report["missing_in_jax"] and not report["shape_mismatch"]
    _same(got, want, loose=("pos_embed",))


def test_resize_matches_jax_image_resize():
    import jax

    a = np.random.RandomState(2).randn(13, 13, 5).astype(np.float32)
    for shape, method in (((3, 3, 5), "cubic"), ((7, 7, 5), "cubic"),
                          ((4, 4, 5), "linear"), ((20, 20, 5), "linear")):
        want = np.asarray(jax.image.resize(a, shape, method))
        np.testing.assert_allclose(TTI.resize(a, shape, method), want,
                                   rtol=0, atol=1e-6 * np.abs(want).max())
