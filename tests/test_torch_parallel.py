"""The port's mesh helpers and collectives on two gloo ranks.

Every case runs in one 2-rank group (``parallel.mesh.spawn``, CPU, gloo)
started once by the module fixture; the ranks write what they saw and the
tests hold it against the JAX package's ``parallel/mesh.py`` behaviour
(``tests/test_parallel.py``: default mesh, wildcard, ``P("data")`` rows,
replication, padding) and against world size 1. The ranks import this file
but not JAX: the JAX side runs in the parent only.
"""

import numpy as np
import pytest
import torch

from eyediseasesegmentation_tpu_torch.parallel import mesh as P
from eyediseasesegmentation_tpu_torch.models.modules.layers import (
    batch_moments)

WORLD = 2
BATCH = np.random.RandomState(0).rand(8, 4, 4, 3).astype(np.float32)
MASK = np.random.RandomState(1).rand(8, 4, 4).astype(np.float32)


def _ranks(mesh, out):
    torch.set_num_threads(1)
    r = mesh.rank
    res = {"shape": mesh.shape, "devices": mesh.devices.tolist(),
           "index": mesh.axis_index(), "backend": mesh.backend}
    res["wild"] = P.make_mesh({"data": -1, "model": 1}, "cpu").shape
    res["model_axis"] = P.make_mesh({"data": 1, "model": -1}, "cpu").shape
    try:
        P.make_mesh({"data": 4}, "cpu")
    except ValueError as e:
        res["too_big"] = str(e)
    res["rows"] = P.shard_batch({"image": BATCH, "mask": MASK}, mesh)
    res["sharding"] = P.batch_sharding(mesh, 8)
    # replicate: rank 1 starts from other values
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.fill_(float(r + 1))
        lin.bias.fill_(float(-r))
    P.replicate(lin, mesh)
    res["replicated"] = [lin.weight.clone(), lin.bias.clone()]
    x = torch.arange(6.0, dtype=torch.float64).reshape(2, 3) + 10 * r
    res["psum"] = P.psum(x, mesh)
    res["pmax"] = P.pmax(x, mesh)
    res["gather"] = P.all_gather(x, mesh)
    res["gather_dim1"] = P.all_gather(x, mesh, dim=1)
    top, bottom = P.neighbour_rows(x[None, None], 1, mesh, dim=2)
    res["halo"] = (top, bottom)
    # the differentiable SUM all_reduce: backward = SUM all_reduce of the
    # gradient; a replicated loss gives n × this rank's share, the mean
    # over ranks the whole batch's gradient
    xr = x.clone().requires_grad_(True)
    (P.psum(xr, mesh) * torch.arange(6.0, dtype=torch.float64)
     .reshape(2, 3)).sum().backward()
    res["psum_grad"] = xr.grad
    xg = x.clone().requires_grad_(True)
    (P.all_gather(xg, mesh) ** 2).sum().backward()
    res["gather_grad"] = xg.grad
    gen = torch.Generator().manual_seed(3)
    xb = torch.randn(8, 5, generator=gen, dtype=torch.float64)
    w = torch.randn(5, 2, generator=gen, dtype=torch.float64)
    w.requires_grad_(True)
    # each rank's rows through w, gathered, the loss of the whole batch
    y = P.all_gather(xb[P.batch_rows(mesh, 8)] @ w, mesh)
    loss = torch.tanh(y).pow(2).mean()
    loss.backward()
    res["local_grad"] = w.grad.clone()
    P.mean_grads([w], mesh)
    res["loss"], res["mean_grad"] = loss.detach(), w.grad
    # the global mean of a sharded batch (JAX's test_global_mean_matches_local)
    xs = torch.from_numpy(BATCH.reshape(8, -1))[P.batch_rows(mesh, 8)]
    res["global_mean"] = P.psum(xs.sum(), mesh) / BATCH.size
    # batch statistics under data_parallel are the whole batch's
    xm = torch.from_numpy(BATCH).permute(0, 3, 1, 2)[P.batch_rows(mesh, 8)]
    with P.data_parallel(mesh):
        _, mean, var = batch_moments(xm, (0, 2, 3))
    res["moments"] = (mean, var)
    torch.save(res, f"{out}/rank{r}.pt")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel")
    P.spawn(_ranks, WORLD, "cpu", str(out))
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def test_make_mesh_default_all_ranks(ranks):
    import jax
    from eyediseasesegmentation_tpu.parallel import make_mesh
    jmesh = make_mesh()
    for r, res in enumerate(ranks):
        assert res["shape"] == {"data": WORLD}
        assert np.asarray(res["devices"]).size == WORLD
        assert res["index"] == r and res["backend"] == "gloo"
    assert jmesh.axis_names == ("data",) and jmesh.devices.size == \
        jax.device_count()


def test_make_mesh_wildcard_and_model_axis(ranks):
    from eyediseasesegmentation_tpu.parallel import make_mesh
    assert make_mesh({"data": 4, "model": -1}).devices.shape == (4, 2)
    for res in ranks:
        assert res["wild"] == {"data": WORLD, "model": 1}
        assert res["model_axis"] == {"data": 1, "model": WORLD}
        assert "covers 4 ranks, but the job has 2" in res["too_big"]


def test_shard_batch_rows_are_jax_data_layout(ranks):
    """Rank r holds the rows JAX's ``P("data")`` puts on data index r."""
    from eyediseasesegmentation_tpu.parallel import make_mesh, shard_batch
    jmesh = make_mesh({"data": WORLD})
    sharded = shard_batch({"image": BATCH, "mask": MASK}, jmesh)
    for key in ("image", "mask"):
        shards = sorted(sharded[key].addressable_shards,
                        key=lambda s: s.index[0].start)
        for r, res in enumerate(ranks):
            np.testing.assert_array_equal(res["rows"][key],
                                          np.asarray(shards[r].data))
    assert [res["sharding"] for res in ranks] == [slice(0, 4), slice(4, 8)]


def test_replicate_broadcasts_rank0(ranks):
    for res in ranks:
        w, b = res["replicated"]
        assert torch.equal(w, torch.ones(2, 3)) and torch.equal(
            b, torch.zeros(2))


def test_pad_to_batch_multiple_matches_jax():
    from eyediseasesegmentation_tpu.parallel.mesh import (
        pad_to_batch_multiple as jpad)
    batch = {"x": np.ones((5, 2), np.float32)}
    want, n = jpad(batch, 4)
    got, m = P.pad_to_batch_multiple(batch, 4)
    assert n == m == 5
    np.testing.assert_array_equal(got["x"], want["x"])
    got_t, _ = P.pad_to_batch_multiple({"x": torch.ones(5, 2)}, 4)
    np.testing.assert_array_equal(got_t["x"].numpy(), want["x"])


def test_collectives(ranks):
    x = [torch.arange(6.0, dtype=torch.float64).reshape(2, 3) + 10 * r
         for r in range(WORLD)]
    for res in ranks:
        assert torch.equal(res["psum"], x[0] + x[1])
        assert torch.equal(res["pmax"], torch.maximum(x[0], x[1]))
        assert torch.equal(res["gather"], torch.cat(x, 0))
        assert torch.equal(res["gather_dim1"], torch.cat(x, 1))
    # neighbour rows along dim 2 of (1, 1, 2, 3): zeros at the global edges
    (t0, b0), (t1, b1) = ranks[0]["halo"], ranks[1]["halo"]
    assert not t0.any() and not b1.any()
    assert torch.equal(b0[0, 0], x[1][:1]) and torch.equal(t1[0, 0], x[0][1:])


def test_differentiable_all_reduce_gradient(ranks):
    """The backward of the SUM all_reduce is a SUM all_reduce: d/dx of
    Σ c·psum(x) is n·c on every rank; of Σ all_gather(x)² it is n·2x."""
    c = torch.arange(6.0, dtype=torch.float64).reshape(2, 3)
    for r, res in enumerate(ranks):
        x = torch.arange(6.0, dtype=torch.float64).reshape(2, 3) + 10 * r
        assert torch.equal(res["psum_grad"], WORLD * c)
        assert torch.equal(res["gather_grad"], WORLD * 2 * x)


def test_mean_grads_is_the_whole_batch_gradient(ranks):
    """A replicated loss over the gathered batch: each rank's gradient is n
    × its share, their mean the world-size-1 gradient (1e-12 of its max,
    fp64)."""
    gen = torch.Generator().manual_seed(3)
    xb = torch.randn(8, 5, generator=gen, dtype=torch.float64)
    w = torch.randn(5, 2, generator=gen, dtype=torch.float64)
    w.requires_grad_(True)
    loss = torch.tanh(xb @ w).pow(2).mean()
    loss.backward()
    scale = w.grad.abs().max()
    for res in ranks:
        assert abs(res["loss"].item() - loss.item()) <= 1e-12 * loss.item()
        assert (res["mean_grad"] - w.grad).abs().max() <= 1e-12 * scale
    total = ranks[0]["local_grad"] + ranks[1]["local_grad"]
    assert (total / WORLD - w.grad).abs().max() <= 1e-12 * scale
    # n × the share: no rank alone holds the whole gradient
    assert (ranks[0]["local_grad"] - w.grad).abs().max() > 1e-3 * scale


def test_global_mean_matches_local(ranks):
    for res in ranks:
        assert abs(float(res["global_mean"]) - float(BATCH.mean())) < 1e-6


def test_batch_moments_under_data_parallel(ranks):
    """BatchNorm's train statistics of a split batch are the whole
    batch's."""
    x = torch.from_numpy(BATCH).permute(0, 3, 1, 2)
    _, mean, var = batch_moments(x, (0, 2, 3))
    for res in ranks:
        got_mean, got_var = res["moments"]
        torch.testing.assert_close(got_mean, mean, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(got_var, var, rtol=1e-5, atol=1e-7)
