"""Outermost aten calls the host makes per train step (the profiler's CPU
ops inside the range around ``Trainer.train_step``, those not nested in
another aten call): the host's launch work, a count that moves little
between runs (the augmentation's random draws change it by about 1 %)."""

RANGES = [{"name": "pb.step",
           "call": "eyediseasesegmentation_tpu_torch.train.trainer:"
                   "Trainer.train_step"}]


def read(trace):
    fam = trace.get("families", {}).get("pb.step")
    if trace.get("kind") != "train" or not fam or not trace.get("steps"):
        return None
    return fam["aten_calls"] / trace["steps"]
