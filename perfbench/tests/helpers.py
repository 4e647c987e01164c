"""Tiny cells for the CPU tests: the flagship at 64² and base_dim 2
(full widths otherwise), a few small images."""

import json
import time

import torch

from perfbench import run
from perfbench.common import Context


def tiny_context(cell: str, seed: int = 2147483711, dtype="float32",
                 trace=False, seconds=0.5) -> Context:
    files = run.cell_files(cell)
    cfg = json.loads(json.dumps(files["config"]))
    cfg["model_params"]["base_dim"] = 2
    cfg["scale_size"] = 64
    cfg["inference_dtype"] = dtype
    tr = dict(files["traffic"])
    if tr["loop"] == "tta":
        tr.update(images=4, batch=2, warm_batches=1,
                  image_hw=[96, 144] if tr["resize"] else [60, 58],
                  pad_to=None if tr["resize"] else [64, 64])
    else:
        cfg["train"] = dict(cfg["train"], is_fp16=dtype == "bfloat16")
        tr.update(pool=6, trace_steps=2, warm_steps=0, compared_steps=1)
    return Context(config=cfg, traffic=tr, limits=files["limits"],
                   seed=seed, seconds=seconds, trace=trace,
                   device=torch.device("cpu"), t_start=time.perf_counter())
