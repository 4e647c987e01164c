"""Nothing the benchmark imports loads JAX or the JAX package, and the
reference loads nothing of the port. Checked in a fresh interpreter, as the
difference of ``sys.modules`` by whole top-level names."""

import json
import subprocess
import sys

from perfbench import run

PROBE = r"""
import importlib, json, sys
sys.path.insert(0, {root!r})
before = set(m.split(".")[0] for m in list(sys.modules))
{body}
after = set(m.split(".")[0] for m in list(sys.modules))
print(json.dumps(sorted(after - before)))
"""


def added(body: str):
    code = PROBE.format(root=str(run.ROOT), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=str(run.ROOT))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_imports_no_jax():
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    readers = "\n".join(
        f"run.load_reader({m['name']!r})" for m in bench["per_layer"])
    body = ("from perfbench import run, calibrate, devtrace, weights\n"
            "import perfbench.reference.model, perfbench.reference.tta\n"
            "import perfbench.reference.metrics, perfbench.reference.train\n"
            "import perfbench.loops.tta, perfbench.loops.train\n"
            "import perfbench.work.flops, perfbench.work.kernels\n"
            "import eyediseasesegmentation_tpu_torch.infer.tta\n"
            "import eyediseasesegmentation_tpu_torch.train.trainer\n"
            + readers)
    new = added(body)
    assert not new & set(run.FORBIDDEN), new & set(run.FORBIDDEN)


def test_reference_imports_nothing_of_the_port():
    new = added("import perfbench.reference.model, perfbench.reference.tta\n"
                "import perfbench.reference.metrics\n"
                "import perfbench.reference.train\n"
                "import perfbench.weights, perfbench.work.flops")
    assert "eyediseasesegmentation_tpu_torch" not in new
    assert not new & set(run.FORBIDDEN)
