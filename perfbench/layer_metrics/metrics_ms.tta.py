"""Device milliseconds of ``ops.metrics.batch_image_metrics`` (per-image
AP or ROC-AUC and the threshold sweep) per image of the traced pass."""

RANGES = [{"name": "pb.metrics",
           "call": "eyediseasesegmentation_tpu_torch.ops.metrics:"
                   "batch_image_metrics"}]


def read(trace):
    fam = trace.get("families", {}).get("pb.metrics")
    if trace.get("kind") != "tta" or not fam or fam["kernel_s"] <= 0:
        return None
    return 1e3 * fam["kernel_s"] / trace["images"]
