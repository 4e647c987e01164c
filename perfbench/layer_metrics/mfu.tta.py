"""Model FLOPs of the views the traced pass completed (the reference's
forward count per view, ``perfbench.work.flops``) over the pass's seconds
in the untraced stretch (host clock), as a share of the H100's bf16 dense
peak."""

from perfbench.work import peaks


def read(trace):
    if trace.get("kind") != "tta" or not trace.get("images"):
        return None
    flops = trace["views"] * trace["view_flops"]
    return 100.0 * flops / trace["plain_window_s"] / peaks.BF16_FLOPS
