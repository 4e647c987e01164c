"""Checkpoint I/O (torch port), in the JAX package's format.

Counterpart of ``load_checkpoint`` / ``save_checkpoint`` in
``eyediseasesegmentation_tpu/train/checkpoint.py``: a checkpoint is a pytree
of nested dicts serialized as msgpack the way ``flax.serialization`` writes
it. The codec here is pure Python, so the port needs neither ``flax`` nor
``msgpack``, and a file written by either package is read by the other.

What the codec covers: nil, bool, int, float, str, bin, array and map, and
flax's three ext types. Ext 1 is an ndarray, whose payload is itself msgpack
``(shape, dtype name, C-order bytes)``; ext 2 a Python complex as
``(real, imag)``; ext 3 a numpy scalar, packed as a 0-d ndarray. Arrays over
``MAX_CHUNK_SIZE`` bytes are written in flax's chunked form,
``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``, and
joined again on load.

Leaves load as numpy arrays, except those whose dtype name is ``bfloat16``:
numpy has no such type without ``ml_dtypes``, so their bytes are read as
``uint16`` and viewed as a ``torch.bfloat16`` tensor of the same shape (a
0-d tensor for an ext 3 scalar).

``best.ckpt`` / ``last.ckpt`` hold ``{"model_state_dict": {"params",
"batch_stats"}, "metric", "epoch"}`` in the JAX layout
(``convert.torch_to_flax``), so the JAX package reads a run the port
trained. ``best_full.ckpt`` holds the port's own resume state
(:func:`resume_state`): the model's ``state_dict``, the optimizer state by
parameter name, the step and the epoch. :func:`restore_into` reads it
back, and reads the JAX package's ``best_full.ckpt`` too, ``{"state":
TrainState(params, batch_stats, opt_state, step), "epoch"}``: the weights
through ``convert``, and each optax state tree shaped like the parameters
(found by its field name, ``mu``, ``nu``, ``trace``, ``slow``, ...) onto the
port's per-parameter state (``optim.optimizers.state_fields``), with
``inject_hyperparams``' count as every 0-d ``step`` counter and its
learning rate as the base rate.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch

from ..convert import _leaves

# flax.serialization.MAX_CHUNK_SIZE: an array leaf of more bytes is chunked
MAX_CHUNK_SIZE = 2 ** 30

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


# ---------------------------------------------------------------------------
# msgpack encoder (the choices of msgpack.packb with use_bin_type=True)
# ---------------------------------------------------------------------------

def _pack_int(n: int, out: List[bytes]) -> None:
    if 0 <= n < 0x80:
        out.append(struct.pack("B", n))
    elif -0x20 <= n < 0:
        out.append(struct.pack("b", n))
    elif 0 <= n <= 0xFF:
        out.append(struct.pack(">BB", 0xCC, n))
    elif -0x80 <= n < 0:
        out.append(struct.pack(">Bb", 0xD0, n))
    elif 0 <= n <= 0xFFFF:
        out.append(struct.pack(">BH", 0xCD, n))
    elif -0x8000 <= n < 0:
        out.append(struct.pack(">Bh", 0xD1, n))
    elif 0 <= n <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", 0xCE, n))
    elif -0x80000000 <= n < 0:
        out.append(struct.pack(">Bi", 0xD2, n))
    elif 0 <= n <= 0xFFFFFFFFFFFFFFFF:
        out.append(struct.pack(">BQ", 0xCF, n))
    elif -0x8000000000000000 <= n < 0:
        out.append(struct.pack(">Bq", 0xD3, n))
    else:
        raise OverflowError(f"msgpack: integer {n} does not fit 64 bits")


def _pack_header(n: int, fix: Optional[Tuple[int, int]], codes: Tuple[int, ...],
                 out: List[bytes]) -> None:
    """A length header: the fix form ``base | n`` while ``n <= limit``
    (``fix`` None: no fix form), else the first of ``codes`` (8-, 16-,
    32-bit lengths; the 8-bit form only where ``codes`` has three) that
    fits."""
    if fix is not None and n <= fix[1]:
        out.append(struct.pack("B", fix[0] | n))
        return
    forms = list(zip((">BB", ">BH", ">BI"), (0xFF, 0xFFFF, 0xFFFFFFFF)))
    for code, (fmt, top) in zip(codes, forms[3 - len(codes):]):
        if n <= top:
            out.append(struct.pack(fmt, code, n))
            return
    raise ValueError(f"msgpack: length {n} does not fit 32 bits")


def _pack_ext(code: int, data: bytes, out: List[bytes]) -> None:
    n = len(data)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(struct.pack(">Bb", fixext[n], code))
    elif n <= 0xFF:
        out.append(struct.pack(">BBb", 0xC7, n, code))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BHb", 0xC8, n, code))
    elif n <= 0xFFFFFFFF:
        out.append(struct.pack(">BIb", 0xC9, n, code))
    else:
        raise ValueError(f"msgpack: ext payload of {n} bytes")
    out.append(data)


def _array_payload(arr) -> bytes:
    """flax's ``_ndarray_to_bytes``: msgpack ``(shape, dtype name, bytes)``.
    A ``torch.bfloat16`` tensor is written under the name ``bfloat16``."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu()
        if arr.dtype == torch.bfloat16:
            return _packb((tuple(arr.shape), "bfloat16",
                           arr.contiguous().view(torch.int16).numpy()
                           .tobytes("C")))
        arr = arr.numpy()
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported for "
                         "serialization of ndarrays.")
    return _packb((arr.shape, arr.dtype.name, arr.tobytes("C")))


def _pack(obj: Any, out: List[bytes], strict: bool) -> None:
    """``strict``: flax's ``strict_types=True`` (exact types only; a tuple,
    like any type not listed, goes to the ext hook and is refused)."""
    t = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif t is int:
        _pack_int(obj, out)
    elif t is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif t is str:
        data = obj.encode("utf-8")
        _pack_header(len(data), (0xA0, 31), (0xD9, 0xDA, 0xDB), out)
        out.append(data)
    elif t in (bytes, bytearray, memoryview):
        data = bytes(obj)
        _pack_header(len(data), None, (0xC4, 0xC5, 0xC6), out)
        out.append(data)
    elif t is list or (t is tuple and not strict):
        _pack_header(len(obj), (0x90, 15), (0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out, strict)
    elif t is dict:
        _pack_header(len(obj), (0x80, 15), (0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out, strict)
            _pack(v, out, strict)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack_ext(_EXT_NDARRAY, _array_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(_EXT_NPSCALAR, _array_payload(np.asarray(obj)), out)
    elif t is complex:
        _pack_ext(_EXT_COMPLEX, _packb((obj.real, obj.imag)), out)
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def _packb(obj: Any, strict: bool = False) -> bytes:
    out: List[bytes] = []
    _pack(obj, out, strict)
    return b"".join(out)


def _chunk(arr) -> dict:
    """flax's ``_chunk``: the flattened array in pieces of at most
    ``MAX_CHUNK_SIZE`` bytes, keyed "0", "1", ..."""
    itemsize = arr.element_size() if isinstance(arr, torch.Tensor) \
        else arr.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = arr.reshape(-1)
    n = flat.numel() if isinstance(flat, torch.Tensor) else flat.size
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(j): flat[i:i + size]
                       for j, i in enumerate(range(0, n, size))}}


def _nbytes(arr) -> int:
    if isinstance(arr, torch.Tensor):
        return arr.numel() * arr.element_size()
    return arr.size * arr.dtype.itemsize


def _chunk_leaves(tree: Any) -> Any:
    """The tree as flax hands it to msgpack: every dict rebuilt with its keys
    sorted (flax copies the tree with ``jax.tree_util.tree_map``, which
    sorts them), then ``_chunk_array_leaves_in_place``: arrays over
    ``MAX_CHUNK_SIZE`` bytes, at the top level and in dict values only,
    become chunk dicts, whose keys keep their insertion order."""
    big = lambda v: (isinstance(v, (np.ndarray, torch.Tensor))
                     and _nbytes(v) > MAX_CHUNK_SIZE)
    if isinstance(tree, dict):
        return {k: _chunk(v) if big(v) else _chunk_leaves(v)
                for k, v in sorted(tree.items())}
    if isinstance(tree, list):
        return [_sorted(v) for v in tree]
    return _chunk(tree) if big(tree) else tree


def _sorted(tree: Any) -> Any:
    """Dicts inside lists: keys sorted, no chunking (flax chunks only dict
    values)."""
    if isinstance(tree, dict):
        return {k: _sorted(v) for k, v in sorted(tree.items())}
    if isinstance(tree, list):
        return [_sorted(v) for v in tree]
    return tree


def msgpack_serialize(tree: Any) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize`` writes for a tree of
    dicts, lists and leaves (arrays, numpy scalars, Python scalars, str,
    bytes, complex)."""
    return _packb(_chunk_leaves(tree), strict=True)


# ---------------------------------------------------------------------------
# msgpack decoder
# ---------------------------------------------------------------------------

def _array_from_payload(data: memoryview):
    shape, name, buf = _Reader(data, raw=True).read()
    name = bytes(name).decode()
    shape = tuple(shape)
    if name == "bfloat16":
        a = np.frombuffer(buf, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(a).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


class _Reader:
    """One pass over a msgpack buffer. ``raw`` (an ndarray's own payload):
    str stays bytes, as flax reads it, and bin is a view of the buffer."""

    def __init__(self, data, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        view = self.data[self.pos:self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ("B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
                 0xD9: ("B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
                 0xDC: (">H", "array"), 0xDD: (">I", "array"),
                 0xDE: (">H", "map"), 0xDF: (">I", "map")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":   # raw: a view, so arrays share the buffer
                return self.take(n) if self.raw else bytes(self.take(n))
            if kind == "str":
                return self._str(n)
            if kind == "array":
                return [self.read() for _ in range(n)]
            return self._map(n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: "B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: "b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(self.unpack("b"), fixext[b])
        ext = {0xC7: "B", 0xC8: ">H", 0xC9: ">I"}
        if b in ext:
            n = self.unpack(ext[b])
            return self._ext(self.unpack("b"), n)
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def _str(self, n: int):
        data = self.take(n)
        return bytes(data) if self.raw else str(data, "utf-8")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, code: int, n: int) -> Any:
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _array_from_payload(data)
        if code == _EXT_NPSCALAR:
            a = _array_from_payload(data)
            return a if isinstance(a, torch.Tensor) else a[()]
        if code == _EXT_COMPLEX:
            real, imag = _Reader(data).read()
            return complex(real, imag)
        raise ValueError(f"msgpack: unknown ext type {code}")


def _unchunk(tree: Any) -> Any:
    """flax's ``_unchunk_array_leaves_in_place``: join chunked leaves."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data) -> Any:
    """``flax.serialization.msgpack_restore``: bytes → nested dicts and
    leaves."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(f"msgpack: {len(reader.data) - reader.pos} bytes "
                         "after the end of the tree")
    return _unchunk(tree)


# ---------------------------------------------------------------------------
# Checkpoint files
# ---------------------------------------------------------------------------

def _state_dict(tree: Any) -> Any:
    """flax's ``to_state_dict`` of dicts, lists and tuples (lists and tuples
    become {"0": ..., "1": ...}), with every leaf on the host as an array,
    as the JAX package's ``_to_host`` leaves it (a Python scalar becomes a
    0-d array; a tensor a numpy array, or stays a CPU tensor in bfloat16)."""
    if isinstance(tree, dict):
        return {str(k): _state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return t if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(tree)


def save_checkpoint(path: Union[str, Path], tree: Any) -> None:
    """Serialize a tree (dict of params / batch_stats / metric / epoch ...)
    to ``path`` through ``path.tmp`` and a rename, as the JAX package
    does."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = msgpack_serialize(_state_dict(tree))
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_bytes(payload)
    tmp.replace(path)


def load_checkpoint(path: Union[str, Path]) -> dict:
    """The raw tree: nested dicts of numpy arrays (``torch.bfloat16``
    tensors for bfloat16 leaves)."""
    return msgpack_restore(bytearray(Path(path).read_bytes()))


# ---------------------------------------------------------------------------
# Resume state
# ---------------------------------------------------------------------------

def resume_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 step: int, epoch: int) -> dict:
    """The tree ``best_full.ckpt`` holds: ``model_state_dict`` (the
    model's ``state_dict``), ``optimizer`` (each parameter's state by its
    name), ``step`` and ``epoch``."""
    names = {id(p): n for n, p in model.named_parameters()}
    opt = {names[id(p)]: dict(s) for p, s in optimizer.state.items()}
    return {"model_state_dict": dict(model.state_dict()),
            "optimizer": opt, "step": int(step), "epoch": int(epoch)}


def _param_shaped(opt_state: Any, leaves: set) -> dict:
    """Every subtree of an optax state whose leaf paths are the parameters'
    (the per-parameter trees: moments, traces, slow weights; a 0-d leaf per
    parameter for novograd's second moment), by its field name; raises
    when a field name is found twice."""
    found: dict = {}

    def walk(node, name):
        if not isinstance(node, dict) or not node:
            return
        if {p for p, _ in _leaves(node)} == leaves:
            if name in found:
                raise ValueError(f"optax state: two '{name}' trees")
            found[name] = node
            return
        for k, v in node.items():
            walk(v, k)

    walk(opt_state, None)
    return found


def _restore_jax(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 tree: dict) -> dict:
    from ..convert import flax_to_torch, load_flax
    from ..optim.optimizers import set_learning_rate, state_fields

    state = tree["state"]
    params = state["params"]
    load_flax(model, {"params": params,
                      "batch_stats": state.get("batch_stats") or {}})
    shapes = {k: np.shape(v) for k, v in _leaves(params)}
    trees = _param_shaped(state["opt_state"], set(shapes))
    fields, has_step = state_fields(optimizer)
    named = {}
    for field, key in fields.items():
        if field not in trees:
            raise KeyError(f"JAX optimizer state has no '{field}' tree for "
                           f"the port's '{key}'")
        sub = {p: np.asarray(v) for p, v in _leaves(trees[field])}
        scalar = all(v.ndim == 0 for v in sub.values())
        full = {p: np.full(shapes[p], v) if scalar else v
                for p, v in sub.items()}
        nested: dict = {}
        for p, v in full.items():
            node = nested
            for part in p[:-1]:
                node = node.setdefault(part, {})
            node[p[-1]] = v
        conv = flax_to_torch({"params": nested})
        named[key] = {n: t.reshape(-1)[0] if scalar else t
                      for n, t in conv.items()}
    opt = state["opt_state"]
    count = float(np.asarray(opt["count"]))
    mine = {id(p) for g in optimizer.param_groups for p in g["params"]}
    for name, p in model.named_parameters():
        if id(p) not in mine:
            continue
        entry = {}
        for key, by_name in named.items():
            if name not in by_name:
                raise KeyError(f"JAX optimizer state '{key}' has no entry "
                               f"for parameter '{name}'")
            t = by_name[name]
            entry[key] = (t.clone() if t.ndim == 0
                          else t.to(p.device, p.dtype))
        if has_step:
            entry["step"] = torch.tensor(count)
        optimizer.state[p] = entry
    if "learning_rate" in (opt.get("hyperparams") or {}):
        set_learning_rate(optimizer,
                          float(np.asarray(opt["hyperparams"]
                                           ["learning_rate"])))
    return {"step": int(np.asarray(state["step"])),
            "epoch": int(np.asarray(tree["epoch"]))}


def restore_into(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 path: Union[str, Path]) -> dict:
    """Load a :func:`resume_state` checkpoint, or a JAX ``best_full.ckpt``
    (told apart by its top-level ``state`` key), into ``model`` and
    ``optimizer`` (on their devices); returns ``{"step", "epoch"}``.
    Raises when a model key or an optimizer entry has no counterpart,
    naming the first one missing."""
    tree = load_checkpoint(path)
    if "state" in tree and "model_state_dict" not in tree:
        return _restore_jax(model, optimizer, tree)
    state = {k: torch.as_tensor(np.asarray(v))
             for k, v in tree["model_state_dict"].items()}
    model.load_state_dict(state)
    params = dict(model.named_parameters())
    for name, entries in (tree.get("optimizer") or {}).items():
        p = params[name]
        optimizer.state[p] = {
            k: (None if v is None else
                torch.as_tensor(np.asarray(v)).to(
                    p.device if np.asarray(v).ndim else "cpu"))
            for k, v in entries.items()}
    return {"step": int(tree["step"]), "epoch": int(tree["epoch"])}
