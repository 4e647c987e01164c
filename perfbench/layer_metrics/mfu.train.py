"""Model FLOPs of the traced train steps, 3 × the forward per sample
(forward, and the backward at twice the forward), over the steps'
seconds in the untraced stretch (host clock), as a share of the H100's
bf16 dense peak."""

from perfbench.work import peaks


def read(trace):
    if trace.get("kind") != "train" or not trace.get("steps"):
        return None
    flops = 3.0 * trace["view_flops"] * trace["samples"]
    return 100.0 * flops / trace["plain_window_s"] / peaks.BF16_FLOPS
