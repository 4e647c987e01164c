"""K2 (``models.decoders.scse_conv3x3_pair``): the summed per-call bound
(``perfbench.work.kernels.k2_work`` against the H100's peaks) over the
device time of every kernel launched inside its calls."""

from perfbench.work import kernels


def work(parts, gate_c, sse_kernel, sse_bias, k1, *args, up_part0=False,
         **kwargs):
    """(FLOPs, bytes) of one call, from its arguments (``k1``'s first axis
    is the output channels)."""
    return kernels.k2_work(parts, k1.shape[0], up_part0, parts[0].dtype)


RANGES = [{"name": "pb.k2",
           "call": "eyediseasesegmentation_tpu_torch.models.decoders:"
                   "scse_conv3x3_pair",
           "work": work}]


def read(trace):
    fam = trace.get("families", {}).get("pb.k2")
    work = trace.get("work", {}).get("pb.k2")
    if not fam or not work or fam["kernel_s"] <= 0:
        return None
    return 100.0 * work[3] / fam["kernel_s"]
