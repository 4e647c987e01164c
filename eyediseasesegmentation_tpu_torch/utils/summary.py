"""Model introspection: parameter counts, layer tables, FLOP estimates
(torch port).

Counterpart of ``eyediseasesegmentation_tpu/utils/summary.py`` (reference
``archs/model_util.py``): ``get_num_parameters`` (train.py:243,262-265), the
Keras-style per-layer ``summarize`` (model_util.py:102-214; here from
forward hooks) and ``cost_estimate``, the FLOPs and bytes of one call.

The port's CUDA kernels are called through ctypes, below the aten
dispatcher, so no counter sees them: count a model on its plain path, on
the ``meta`` device where its forward runs there and on the CPU otherwise.
``cost_estimate`` refuses a call that puts a tensor on a CUDA device.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


def get_num_parameters(model: torch.nn.Module) -> Tuple[int, int]:
    """(trainable, total) parameter counts; BatchNorm statistics are
    buffers and not counted, as flax keeps them out of ``params``."""
    params = list(model.parameters())
    return (sum(p.numel() for p in params if p.requires_grad),
            sum(p.numel() for p in params))


def _shapes(out) -> str:
    leaves, _ = tree_flatten(out)
    shapes = [tuple(t.shape) for t in leaves if isinstance(t, torch.Tensor)]
    return ", ".join(str(s) for s in shapes)


def summarize(model: torch.nn.Module,
              input_shape: Sequence[int] = (1, 3, 64, 64),
              train: bool = False) -> str:
    """Per-layer table: each module's path, class, output shape(s) and
    parameter count (its own and its children's), in call order, and a
    total row of :func:`get_num_parameters`. ``input_shape`` is NCHW; the
    forward runs on the model's device, in train mode if ``train``."""
    rows: List[Tuple[str, str, str, int]] = []
    hooks = []
    for name, mod in model.named_modules():
        def hook(m, args, out, name=name):
            rows.append((name or "(model)", type(m).__name__, _shapes(out),
                         sum(p.numel() for p in m.parameters())))
        hooks.append(mod.register_forward_hook(hook))
    was_training = model.training
    param = next(model.parameters(), None)
    device = param.device if param is not None else "cpu"
    try:
        model.train(train)
        with torch.no_grad():
            model(torch.zeros(tuple(input_shape), device=device))
    finally:
        for h in hooks:
            h.remove()
        model.train(was_training)
    trainable, total = get_num_parameters(model)
    rows.append(("Total", "", "", total))
    width = max(len(r[0]) for r in rows)
    kind = max(len(r[1]) for r in rows)
    lines = [f"{'path':<{width}}  {'class':<{kind}}  {'params':>13}  output",
             *(f"{p:<{width}}  {c:<{kind}}  {n:>13,}  {s}"
               for p, c, s, n in rows),
             f"trainable params: {trainable:,}"]
    return "\n".join(lines)


class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of every aten op's tensor inputs and outputs, and
    refuses tensors on a CUDA device."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        for t in tree_flatten((args, kwargs, out))[0]:
            if isinstance(t, torch.Tensor):
                if t.device.type == "cuda":
                    raise ValueError(
                        "cost_estimate: a tensor on a CUDA device; count on "
                        "the plain path (the meta device or the CPU), where "
                        "no ctypes kernel hides from the counter")
                self.bytes += t.numel() * t.element_size()
        return out


def cost_estimate(fn, *args) -> Dict[str, float]:
    """``{"flops", "bytes_accessed"}`` of one call ``fn(*args)``. FLOPs from
    ``torch.utils.flop_counter.FlopCounterMode`` (2 per multiply-add of the
    matmuls and convolutions, as XLA counts them); bytes are the sum over
    every aten op of its inputs' and outputs' sizes: an eager, unfused count,
    larger than XLA's ``bytes accessed`` of a fused program."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = _ByteCounter()
    flops = FlopCounterMode(display=False)
    with flops, counter:
        fn(*args)
    return {"flops": float(flops.get_total_flops()),
            "bytes_accessed": float(counter.bytes)}
