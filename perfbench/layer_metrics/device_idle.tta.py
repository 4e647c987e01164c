"""Share of the traced test pass in which no operation ran on the device:
one minus the union of kernel, copy and set intervals over the pass's
host-clock length, in the stretch profiled with device activity alone (the
host at its untraced pace)."""


def read(trace):
    if trace.get("kind") != "tta" or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
