"""Port parity: checkpoints cross between the JAX package and the torch port.

The flagship's variables (``base_dim=2``, shared with test_torch_flagship.py)
plus ``metric`` and ``epoch`` are written by one package and read by the
other with bit-equal arrays. The port's pure-Python msgpack codec writes the
same bytes as ``flax.serialization.msgpack_serialize`` (which sorts dict
keys, as ``jax.tree_util`` does; the port does too), also for the chunked
form of large arrays (the chunk size lowered through the modules'
``MAX_CHUNK_SIZE``) and for bfloat16 leaves, which the port reads without
``ml_dtypes`` as ``torch.bfloat16`` tensors. The two flagship files (about
230 MB each) are written once, by a module fixture, and deleted after the
module's last test.
"""

import shutil

import ml_dtypes
import numpy as np
import pytest
import torch

from flax import serialization

from eyediseasesegmentation_tpu.train import checkpoint as JC
from eyediseasesegmentation_tpu_torch.convert import (_leaves, flax_to_torch,
                                                      torch_to_flax)
from eyediseasesegmentation_tpu_torch.train import checkpoint as TC

from test_torch_flagship import jax_flagship, torch_flagship


def _flat(tree):
    return {p: v for p, v in _leaves(tree)}


def _assert_bit_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = got[k], np.asarray(w)
        assert isinstance(g, np.ndarray), k
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


def _checkpoint_tree(variables):
    return {"model_state_dict": variables, "metric": 0.8125, "epoch": 7}


@pytest.fixture(scope="module")
def flagship_files(tmp_path_factory):
    """The flagship's variables written once by each package: by the JAX
    package as ``jax/best.ckpt``, and by the port (from the port's model
    through ``torch_to_flax``) as ``port/checkpoints/last.ckpt``."""
    root = tmp_path_factory.mktemp("flagship_ckpt")
    _, variables, _ = jax_flagship()
    files = {"jax": root / "jax" / "best.ckpt",
             "port": root / "port" / "checkpoints" / "last.ckpt",
             "port_variables": torch_to_flax(torch_flagship())}
    JC.save_checkpoint(files["jax"], _checkpoint_tree(variables))
    TC.save_checkpoint(files["port"],
                       _checkpoint_tree(files["port_variables"]))
    yield files
    shutil.rmtree(root)


def test_jax_checkpoint_loads_in_port(flagship_files):
    _, variables, _ = jax_flagship()
    path = flagship_files["jax"]
    got = TC.load_checkpoint(path)
    _assert_bit_equal(got, JC.load_checkpoint(path))
    _assert_bit_equal(got["model_state_dict"], variables)
    assert float(got["metric"]) == 0.8125 and int(got["epoch"]) == 7


def test_port_checkpoint_loads_in_jax(flagship_files):
    variables = flagship_files["port_variables"]
    path = flagship_files["port"]
    assert sorted(p.name for p in path.parent.iterdir()) == ["last.ckpt"]
    got = JC.load_checkpoint(path)
    _assert_bit_equal(got["model_state_dict"], variables)
    assert float(got["metric"]) == 0.8125 and int(got["epoch"]) == 7


def test_payload_matches_flax_bytes(flagship_files):
    """The port's file of the port's model holds the same bytes as the JAX
    package's file of the same weights (``torch_to_flax`` gives the JAX
    variables back bit for bit: test_flax_to_torch_inverts_torch_to_flax)."""
    _, variables, _ = jax_flagship()
    _assert_bit_equal(flagship_files["port_variables"], variables)
    assert (flagship_files["port"].read_bytes()
            == flagship_files["jax"].read_bytes())
    # every kind of leaf the codec covers, every length class of the headers
    rng = np.random.RandomState(0)
    mixed = {"z": None, "b": [True, False], "ints": [0, 127, 128, 255, 256,
                                                    65535, 65536, 2 ** 32,
                                                    -1, -32, -33, -128, -129,
                                                    -2 ** 15 - 1, -2 ** 40],
             "f": 0.1, "s": ["", "x" * 31, "y" * 32, "é" * 200, "w" * 70000],
             "bin": [b"", b"\x00" * 300, b"\x01" * 70000],
             "map16": {str(i): i for i in range(20)},
             "arr": rng.randn(3, 5).astype(np.float32),
             "i64": np.arange(7), "u8": np.zeros((2, 0), np.uint8),
             "np_scalar": np.float32(2.5), "np_bool": np.bool_(True),
             "c": complex(1.0, -2.0), "list16": list(range(17))}
    payload = TC.msgpack_serialize(mixed)
    assert payload == serialization.msgpack_serialize(mixed)
    back = TC.msgpack_restore(payload)
    flax_back = serialization.msgpack_restore(payload)
    assert back.keys() == flax_back.keys()
    for k in mixed:
        if isinstance(mixed[k], np.ndarray):
            assert back[k].dtype == flax_back[k].dtype
            np.testing.assert_array_equal(back[k], flax_back[k])
        else:
            assert back[k] == flax_back[k], k


def test_chunked_array_round_trips(tmp_path, monkeypatch):
    """Arrays over MAX_CHUNK_SIZE bytes go in flax's chunked form (here 256
    bytes instead of 2^30: 64 fp32 values a chunk, 11 chunks)."""
    monkeypatch.setattr(TC, "MAX_CHUNK_SIZE", 256)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    rng = np.random.RandomState(1)
    tree = {"params": {"big": rng.randn(20, 33).astype(np.float32),
                       "small": rng.randn(8).astype(np.float32)}}
    payload = TC.msgpack_serialize(tree)
    assert payload == serialization.msgpack_serialize(tree)
    raw = serialization.msgpack.unpackb(payload, raw=False,
                                        ext_hook=lambda c, d: None)
    assert len(raw["params"]["big"]["chunks"]) == 11
    for back in (TC.msgpack_restore(payload),
                 serialization.msgpack_restore(payload)):
        _assert_bit_equal(back, tree)
    TC.save_checkpoint(tmp_path / "c.ckpt", tree)
    _assert_bit_equal(JC.load_checkpoint(tmp_path / "c.ckpt"), tree)


def test_bfloat16_leaf_round_trips(tmp_path):
    rng = np.random.RandomState(2)
    w = rng.randn(4, 6).astype(ml_dtypes.bfloat16)
    JC.save_checkpoint(tmp_path / "jax.ckpt", {"w": w, "s": w[0, 0]})
    got = TC.load_checkpoint(tmp_path / "jax.ckpt")
    assert got["w"].dtype == torch.bfloat16 and got["w"].shape == (4, 6)
    assert got["w"].view(torch.int16).numpy().tobytes() == w.tobytes()
    assert got["s"].dtype == torch.bfloat16 and got["s"].shape == ()
    assert float(got["s"]) == float(w[0, 0])
    t = torch.from_numpy(rng.randn(3, 5).astype(np.float32)).bfloat16()
    TC.save_checkpoint(tmp_path / "port.ckpt", {"w": t})
    back = JC.load_checkpoint(tmp_path / "port.ckpt")["w"]
    assert back.dtype == ml_dtypes.bfloat16
    assert back.tobytes() == t.view(torch.int16).numpy().tobytes()
    again = TC.load_checkpoint(tmp_path / "port.ckpt")["w"]
    assert torch.equal(again, t)
    assert (TC.msgpack_serialize({"w": t})
            == serialization.msgpack_serialize({"w": np.asarray(back)}))


def test_flax_to_torch_inverts_torch_to_flax():
    state = torch_flagship().state_dict()
    back = flax_to_torch(torch_to_flax(state))
    assert set(back) == set(state)
    for k, v in state.items():
        assert torch.equal(back[k], v), k
    _, variables, _ = jax_flagship()
    _assert_bit_equal(torch_to_flax(flax_to_torch(variables)), variables)
    with pytest.raises(KeyError, match="no conversion rule"):
        torch_to_flax({"head.odd": torch.zeros(3)})
