"""H-sharded (context-parallel) primitives and the H-sharded flagship on
two gloo ranks, against the JAX package's ``parallel/spatial.py`` and
``parallel/spatial_model.py`` at ``{"data": 2}``.

One 2-rank group (``parallel.mesh.spawn``, CPU) runs every case; the parent
computes the JAX references and the port's unsharded gradients. The ranks
import this file but not JAX.

* ``halo_exchange``, ``conv3x3_spatial``, ``pool2x_spatial``,
  ``upsample2x_spatial`` and ``spatial_predict`` on a conv stack, to 1e-5
  (the stack 1e-4, as JAX's own test);
* ``spatial_flagship_predict`` at 64², base_dim 2, fp32, to 1e-4 ×
  max|logit| (ROADMAP's whole-flagship rule) of JAX's, and of the port's
  unsharded eval forward;
* its gradients against the port's unsharded ones at JAX's
  ``test_spatial_flagship_grads_match_unsharded`` tolerances (loss 1e-5
  relative, each leaf rtol 5e-3 and atol 5e-4 × its max), on the plain
  path: the axial kernel's wrapper refuses autograd, so both sides call
  its plain version.
"""

import numpy as np
import pytest
import torch

from eyediseasesegmentation_tpu_torch import models as zoo
from eyediseasesegmentation_tpu_torch.ops import axial_attention as AK
from eyediseasesegmentation_tpu_torch.parallel import mesh as P
from eyediseasesegmentation_tpu_torch.parallel import spatial as SP
from eyediseasesegmentation_tpu_torch.parallel.spatial_model import (
    spatial_flagship_predict)

WORLD, S = 2, 64
FLAGSHIP = {"encoder_name": "BoTSER50_Axial_Imagenet_3",
            "decoder_attention_type": "scse", "base_dim": S // 32,
            "classes": 1}
_rng = np.random.RandomState(0)
X_CONV = _rng.randn(2, 64, 16, 5).astype(np.float32)         # NHWC
K_CONV = _rng.randn(3, 3, 5, 7).astype(np.float32)           # HWIO
X_UP = np.random.RandomState(1).randn(1, 32, 8, 3).astype(np.float32)
_rng = np.random.RandomState(2)
X_STACK = _rng.randn(1, 64, 16, 4).astype(np.float32)
K_STACK = [_rng.randn(3, 3, a, b).astype(np.float32)
           for a, b in ((4, 8), (8, 8), (8, 2))]
X_FLAG = np.random.RandomState(1).randn(1, S, S, 3).astype(np.float32)
TARGET = (np.random.RandomState(2).rand(1, 1, S, S) < 0.2).astype(np.float32)


def nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def oihw(k):
    return torch.from_numpy(k).permute(3, 2, 0, 1)


def flagship():
    model = zoo.get_model("unetplusplusstar", FLAGSHIP, training=False,
                          device="cpu")
    return zoo.init_random(model, torch.Generator().manual_seed(3))


def grad_loss(logits):
    return ((torch.sigmoid(logits) - torch.from_numpy(TARGET)) ** 2).mean()


def _ranks(mesh, out):
    torch.set_num_threads(2)
    res = {"halo": SP.halo_exchange(nchw(X_CONV)[:, :, P.batch_rows(
        mesh, 64)], 2, mesh)}
    with torch.no_grad():
        res["conv"] = SP.spatial_predict(
            lambda xl: SP.conv3x3_spatial(xl, oihw(K_CONV), mesh),
            nchw(X_CONV), mesh, gather=True)
        res["up"] = SP.spatial_predict(
            lambda xl: SP.upsample2x_spatial(xl, mesh), nchw(X_UP), mesh,
            gather=True)
        for kind in ("max", "avg"):
            res[f"pool_{kind}"] = SP.spatial_predict(
                lambda xl: SP.pool2x_spatial(xl, kind), nchw(X_CONV), mesh,
                gather=True)
        k1, k2, k3 = (oihw(k) for k in K_STACK)

        def stack(xl):
            y = SP.conv3x3_spatial(xl, k1, mesh)
            y = SP.pool2x_spatial(y, "max")
            y = SP.conv3x3_spatial(y, k2, mesh)
            y = SP.upsample2x_spatial(y, mesh)
            return SP.conv3x3_spatial(y, k3, mesh)

        res["stack"] = SP.spatial_predict(stack, nchw(X_STACK), mesh)
    model = flagship()
    with torch.inference_mode():
        res["flagship_block"] = spatial_flagship_predict(model, nchw(X_FLAG),
                                                         mesh)
        res["flagship"] = P.all_gather(res["flagship_block"], mesh, dim=2)
    try:
        spatial_flagship_predict(model, nchw(X_FLAG)[:, :, :S - 4], mesh)
    except ValueError as e:
        res["error"] = str(e)
    # the gradient, on the plain path
    AK.axial_attention = AK.axial_attention_reference
    loss = grad_loss(spatial_flagship_predict(model, nchw(X_FLAG), mesh,
                                              gather=True))
    loss.backward()
    P.mean_grads(model.parameters(), mesh)
    res["loss"] = loss.item()
    res["grads"] = {n: p.grad for n, p in model.named_parameters()
                    if p.grad is not None}
    torch.save(res, f"{out}/rank{mesh.rank}.pt")


def _unsharded_grads(monkeypatch):
    monkeypatch.setattr(AK, "axial_attention", AK.axial_attention_reference)
    model = flagship()
    logits = model(nchw(X_FLAG))
    loss = grad_loss(logits)
    loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters()
                         if p.grad is not None}, logits.detach()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from concurrent.futures import ThreadPoolExecutor
    out = tmp_path_factory.mktemp("spatial")
    with ThreadPoolExecutor(1) as pool, pytest.MonkeyPatch.context() as mp:
        ranks = pool.submit(P.spawn, _ranks, WORLD, "cpu", str(out))
        unsharded = _unsharded_grads(mp)
        ranks.result()
    return {"unsharded": unsharded[:2], "logits": unsharded[2],
            "ranks": [torch.load(out / f"rank{r}.pt", weights_only=False)
                      for r in range(WORLD)]}


@pytest.fixture(scope="module")
def jax_sp():
    import jax.numpy as jnp
    from eyediseasesegmentation_tpu.parallel import make_mesh
    from eyediseasesegmentation_tpu.parallel import spatial as JSP
    return JSP, make_mesh({"data": WORLD}), jnp


def _hold(got, want, tol):
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=tol, atol=tol)


def test_halo_exchange_matches_jax(runs, jax_sp):
    """Rank r's block with its halos is JAX's shard r of the same call."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as JP
    JSP, mesh, jnp = jax_sp
    spec = JP(None, "data", None, None)
    halo = np.asarray(shard_map(lambda xl: JSP.halo_exchange(xl, 2),
                                mesh=mesh, in_specs=(spec,), out_specs=spec)(
        jnp.asarray(X_CONV)))
    h = halo.shape[1] // WORLD
    for r, res in enumerate(runs["ranks"]):
        _hold(res["halo"], halo[:, r * h:(r + 1) * h], 0.0)


def test_conv3x3_spatial_matches_jax(runs, jax_sp):
    JSP, mesh, jnp = jax_sp
    want = JSP.spatial_predict(
        lambda xl: JSP.conv3x3_spatial(xl, jnp.asarray(K_CONV)),
        jnp.asarray(X_CONV), mesh)
    for res in runs["ranks"]:
        _hold(res["conv"], want, 1e-5)


def test_upsample2x_spatial_matches_jax(runs, jax_sp):
    JSP, mesh, jnp = jax_sp
    want = JSP.spatial_predict(JSP.upsample2x_spatial, jnp.asarray(X_UP),
                               mesh)
    for res in runs["ranks"]:
        _hold(res["up"], want, 1e-5)


@pytest.mark.parametrize("kind", ["max", "avg"])
def test_pool2x_spatial_matches_jax(runs, jax_sp, kind):
    JSP, mesh, jnp = jax_sp
    want = JSP.spatial_predict(lambda xl: JSP.pool2x_spatial(xl, kind),
                               jnp.asarray(X_CONV), mesh)
    for res in runs["ranks"]:
        _hold(res[f"pool_{kind}"], want, 1e-5)


def test_spatial_predict_conv_stack_matches_jax(runs, jax_sp):
    """conv → pool → conv → upsample → conv, sharded along H the whole way;
    without ``gather`` each rank holds its own rows."""
    JSP, mesh, jnp = jax_sp
    k1, k2, k3 = (jnp.asarray(k) for k in K_STACK)

    def stack(xl):
        y = JSP.conv3x3_spatial(xl, k1)
        y = JSP.pool2x_spatial(y, "max")
        y = JSP.conv3x3_spatial(y, k2)
        y = JSP.upsample2x_spatial(y)
        return JSP.conv3x3_spatial(y, k3)

    want = np.asarray(JSP.spatial_predict(stack, jnp.asarray(X_STACK), mesh))
    h = want.shape[1] // WORLD
    for r, res in enumerate(runs["ranks"]):
        _hold(res["stack"], want[:, r * h:(r + 1) * h], 1e-4)


def test_spatial_flagship_matches_jax_and_unsharded(runs, jax_sp):
    import jax
    from eyediseasesegmentation_tpu.parallel.spatial_model import (
        spatial_flagship_predict as jspatial)
    from eyediseasesegmentation_tpu_torch.convert import torch_to_flax
    JSP, mesh, jnp = jax_sp
    want = np.asarray(jax.jit(lambda v, x: jspatial(v, x, mesh, base_dim=2))(
        torch_to_flax(flagship()), jnp.asarray(X_FLAG)))
    bound = 1e-4 * np.abs(want).max()
    for r, res in enumerate(runs["ranks"]):
        got = res["flagship"].permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape == (1, S, S, 1)
        assert np.abs(got - want).max() <= bound
        assert torch.equal(res["flagship_block"],
                           res["flagship"][:, :, r * S // 2:(r + 1) * S // 2])
        ref = runs["logits"]
        assert (res["flagship"] - ref).abs().max() <= 1e-4 * ref.abs().max()
        assert "H 60 is not divisible by 4 × 2 ranks" in res["error"]


# a leaf whose exact gradient vanishes by an invariance (an attention
# norm's bias: the softmax ignores a shift) is rounding noise, so its scale
# is floored at this fraction of the largest gradient
GRAD_FLOOR = 1e-6


def test_spatial_flagship_grads_match_unsharded(runs):
    want_loss, want = runs["unsharded"]
    floor = GRAD_FLOOR * max(a.abs().max().item() for a in want.values())
    for res in runs["ranks"]:
        assert abs(res["loss"] - want_loss) <= 1e-5 * abs(want_loss)
        got = res["grads"]
        assert got.keys() == want.keys() and len(want) > 400
        for k, a in want.items():
            scale = max(a.abs().max().item(), floor)
            np.testing.assert_allclose(got[k].numpy(), a.numpy(), rtol=5e-3,
                                       atol=5e-4 * scale, err_msg=k)
