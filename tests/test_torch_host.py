"""Port parity: the host code (synthetic data, dataset builders, offline
augmentation, summaries, profiling hooks, visualisation).

``data.synthetic``'s arrays and trees equal the JAX package's for a seed;
each builder and ``augment_offline`` function writes the same files (byte
for byte) and returns the same values as the JAX package's on one tiny
tree; ``get_num_parameters`` counts what JAX counts for ``classic_unet``
and the base_dim-2 flagship, and ``summarize``'s total row says so;
``cost_estimate`` counts a matmul as JAX's test asks and a 3×3 conv at
exactly 2 FLOPs a multiply-add; ``debug_nans``, ``StepTimer`` and ``trace``
behave as the JAX tests ask of theirs; the visualisations write their
files.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eyediseasesegmentation_tpu import models as jzoo
from eyediseasesegmentation_tpu.analysis import visualize as JV
from eyediseasesegmentation_tpu.data import augment_offline as JA
from eyediseasesegmentation_tpu.data import builders as JB
from eyediseasesegmentation_tpu.data import synthetic as JS
from eyediseasesegmentation_tpu.utils import summary as JU
from eyediseasesegmentation_tpu_torch import models as tzoo
from eyediseasesegmentation_tpu_torch.analysis import visualize as TV
from eyediseasesegmentation_tpu_torch.data import augment_offline as TA
from eyediseasesegmentation_tpu_torch.data import builders as TB
from eyediseasesegmentation_tpu_torch.data import synthetic as TS
from eyediseasesegmentation_tpu_torch.data.transforms import get_transform
from eyediseasesegmentation_tpu_torch.utils import profiling as TP
from eyediseasesegmentation_tpu_torch.utils import summary as TU


def _files(root):
    """{relative path: bytes} of every file under ``root``."""
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_synthetic_matches_jax(tmp_path):
    for seed in (0, 1999):
        for ours, theirs, size in ((TS.synthetic_fundus, JS.synthetic_fundus,
                                    (40, 56)),
                                   (TS.synthetic_vessels,
                                    JS.synthetic_vessels, (48, 48))):
            got = ours(np.random.RandomState(seed), size)
            want = theirs(np.random.RandomState(seed), size)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
    for make_t, make_j in ((TS.make_idrid_tree, JS.make_idrid_tree),
                           (TS.make_vessel_tree, JS.make_vessel_tree)):
        kw = dict(n_train=2, n_test=1, size=(24, 32))
        t = make_t(tmp_path / "port" / make_t.__name__, **kw)
        j = make_j(tmp_path / "jax" / make_t.__name__, **kw)
        assert t.keys() == j.keys()
        assert _files(tmp_path / "port" / make_t.__name__) == \
            _files(tmp_path / "jax" / make_t.__name__)


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """A tiny raw dataset: 4 fundus-like RGB images (jpg and png), their
    lesion masks under the IDRiD names, and an FGADR Seg-set."""
    from PIL import Image
    root = tmp_path_factory.mktemp("raw")
    rng = np.random.RandomState(3)
    names = [f"IDRiD_{i:02d}" for i in range(4)]
    (root / "img").mkdir()
    (root / "mask").mkdir()
    seg = root / "Seg-set"
    (seg / "Original_Images").mkdir(parents=True)
    for i, name in enumerate(names):
        img, mask = TS.synthetic_fundus(rng, (40, 48))
        Image.fromarray(img).save(root / "img" / f"{name}.jpg", quality=95)
        Image.fromarray(mask).save(root / "mask" / f"{name}.png")
        Image.fromarray(img).save(seg / "Original_Images" / f"{i:04d}_1.png")
        for j, (sub, lesion) in enumerate(TB.FGADR_MASK_DIRS.items()):
            (seg / sub).mkdir(exist_ok=True)
            if (i + j) % 3:         # some grades without a mask file
                Image.fromarray(np.roll(mask, 3 * j, axis=1)).save(
                    seg / sub / f"{i:04d}_1.png")
            lesion_dir = root / "lesions" / lesion
            lesion_dir.mkdir(parents=True, exist_ok=True)
            Image.fromarray(np.roll(mask, 5 * j, axis=0)).save(
                lesion_dir / f"{name}_{lesion}.tif")
    return root, names


CASES = ["build_vessel_dataset", "compute_mean_std", "build_black_masks",
         "make_multilesion", "prepare_clahe_images", "build_fgadr_dataset",
         "augment_dataset", "pad_dataset"]


def _run(case, mod, aug, root, names, out):
    imgs = sorted((root / "img").glob("*.jpg"))
    masks = sorted((root / "mask").glob("*.png"))
    if case == "build_vessel_dataset":
        return mod.build_vessel_dataset(imgs, masks, out)
    if case == "compute_mean_std":
        return mod.compute_mean_std(imgs, out / "mean_std.txt")
    if case == "build_black_masks":
        return [p.name for p in mod.build_black_masks(imgs, out)]
    if case == "make_multilesion":
        dirs = {k: root / "lesions" / k for k in mod.MULTILESION_COLORS}
        return [p.name for p in mod.make_multilesion(dirs, names, out)]
    if case == "prepare_clahe_images":
        fov = mod.build_black_masks(imgs, out / "fov")
        return [p.name for p in mod.prepare_clahe_images(imgs, out / "clahe",
                                                         fov_masks=fov)]
    if case == "build_fgadr_dataset":
        return mod.build_fgadr_dataset(root / "Seg-set", out)
    if case == "augment_dataset":
        return aug.augment_dataset(root / "img", root / "mask", out / "img",
                                   out / "mask", ops=tuple(aug.AUGMENT_OPS),
                                   copies_per_op=1, max_workers=2)
    return (aug.pad_dataset(root / "img", out / "img", 56),
            aug.pad_dataset(root / "mask", out / "mask", 56, is_mask=True))


@pytest.mark.parametrize("case", CASES)
def test_builders_and_augment_match_jax(case, raw, tmp_path):
    root, names = raw
    got = _run(case, TB, TA, root, names, tmp_path / "port")
    want = _run(case, JB, JA, root, names, tmp_path / "jax")
    if case == "compute_mean_std":
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    else:
        assert got == want
    files = _files(tmp_path / "port")
    assert files and files == _files(tmp_path / "jax")


def test_pad_to_square_and_overlays_match_jax(tmp_path):
    rng = np.random.RandomState(4)
    img = rng.randint(0, 256, (30, 44, 3)).astype(np.uint8)
    mask = rng.randint(0, 256, (30, 44)).astype(np.uint8)
    for a, is_mask in ((img, False), (mask, True)):
        np.testing.assert_array_equal(TA.pad_to_square(a, 48, is_mask),
                                      JA.pad_to_square(a, 48, is_mask))
    np.testing.assert_array_equal(TV.overlay_image_mask(img, mask > 128),
                                  JV.overlay_image_mask(img, mask > 128))
    mask01 = (mask > 128).astype(np.float32)
    t = TV.show_examples("ex", img, mask01, tmp_path / "port")
    j = JV.show_examples("ex", img, mask01, tmp_path / "jax")
    assert t.read_bytes() == j.read_bytes()


def test_visualize_augmentations_writes_the_grid(tmp_path):
    from PIL import Image
    img, mask = TS.synthetic_fundus(np.random.RandomState(2), (40, 40))
    transform = get_transform("advanced")(image_size=32)
    out = TV.visualize_augmentations(img, mask / 255.0, transform,
                                     tmp_path / "grid.jpg", n=5, seed=1)
    grid = np.asarray(Image.open(out))
    assert grid.shape == (3 * 32, 3 * 32, 3)     # ⌈√5⌉ = 3 columns and rows
    # five panels drawn; the empty ones black but for the jpeg's ringing
    assert grid[:64].std() > 0 and grid[64:, 64:].mean() < 1.0


@pytest.mark.parametrize("name,params,size", [
    ("classic_unet", {"filters": (8, 16)}, 32),
    ("unetplusplusstar", {"base_dim": 2, "decoder_attention_type": "scse",
                          "classes": 1}, 64)])
def test_num_parameters_match_jax(name, params, size):
    jmodel = jzoo.get_model(name, params)
    shapes = jax.eval_shape(
        lambda x: jmodel.init({"params": jax.random.PRNGKey(0),
                               "dropout": jax.random.PRNGKey(1)}, x,
                              train=False),
        jnp.zeros((1, size, size, 3)))
    want = JU.get_num_parameters(shapes["params"])
    model = tzoo.get_model(name, params, training=True, device="cpu")
    assert TU.get_num_parameters(model) == want
    model.train()
    table = TU.summarize(model, (1, 3, size, size))
    total = [ln for ln in table.splitlines() if ln.startswith("Total")]
    assert total and f"{want[1]:,}" in total[0]
    assert model.training        # summarize puts the mode back


def test_cost_estimate():
    a = torch.zeros(128, 128)
    c = TU.cost_estimate(lambda x, y: x @ y, a, a)
    assert c["flops"] >= 2 * 128 ** 3 * 0.9
    assert c["bytes_accessed"] >= 3 * 128 * 128 * 4
    conv = torch.nn.Conv2d(5, 7, 3, padding=1)
    x = torch.zeros(2, 5, 9, 11)
    with torch.no_grad():
        c = TU.cost_estimate(conv, x)
    assert c["flops"] == 2 * (2 * 9 * 11) * 7 * 5 * 9
    if torch.cuda.is_available():       # the card's kernels hide from it
        with pytest.raises(ValueError, match="plain path"):
            TU.cost_estimate(lambda v: v + 1, torch.zeros(2, device="cuda"))


def test_step_timer():
    t = TP.StepTimer()
    t.tick(); t.tick(); t.tick()
    assert t.mean > 0
    assert t.rate(4) > 0


def test_debug_nans_context():
    with TP.debug_nans(False):
        assert torch.isnan(torch.log(torch.tensor(-1.0)))   # silently NaN
    with pytest.raises(FloatingPointError, match="log"):
        with TP.debug_nans():
            torch.log(torch.tensor([1.0, -1.0]))
    assert torch.isnan(torch.log(torch.tensor(-1.0)))       # off again


def test_trace_writes_a_chrome_trace(tmp_path):
    with TP.trace(tmp_path / "tr") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any("mm" in e.key for e in prof.key_averages())
    traces = list((tmp_path / "tr").glob("trace_*.json"))
    assert len(traces) == 1 and "traceEvents" in json.loads(
        traces[0].read_text())
