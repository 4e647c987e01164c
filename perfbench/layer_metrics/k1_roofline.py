"""K1 (``ops.axial_attention.axial_attention``): the summed per-call bound
(``perfbench.work.kernels.k1_work`` against the H100's peaks) over the
device time of every kernel launched inside its calls."""

import torch

from perfbench.work import kernels


def work(xq, xv, wkq, wv, *args, heads, dkq, dv, dtype=torch.bfloat16,
         **kwargs):
    """(FLOPs, bytes) of one call, from its arguments."""
    return kernels.k1_work(xq, xv, wv, heads, dkq, dv, dtype)


RANGES = [{"name": "pb.k1",
           "call": "eyediseasesegmentation_tpu_torch.ops.axial_attention:"
                   "axial_attention",
           "work": work}]


def read(trace):
    fam = trace.get("families", {}).get("pb.k1")
    work = trace.get("work", {}).get("pb.k1")
    if not fam or not work or fam["kernel_s"] <= 0:
        return None
    return 100.0 * work[3] / fam["kernel_s"]
