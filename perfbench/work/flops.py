"""Model FLOPs of one forward, counted over the plain reference.

``torch.utils.flop_counter.FlopCounterMode`` over the reference model on
the ``meta`` device: 2 per multiply-add of the convolutions, matmuls and
einsums, nothing for elementwise work. The count is of the architecture at
the cell's shape, whatever implements it.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.common import reference_module


def forward_flops(config: dict, size: int) -> float:
    """FLOPs of one eval forward of one ``size``² view."""
    model = reference_module(config).build(config, device="meta")
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(torch.empty((1, 3, size, size), device="meta"))
    return float(counter.get_total_flops())
