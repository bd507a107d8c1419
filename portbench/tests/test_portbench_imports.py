"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port either. Each look runs in a fresh
interpreter, since the test process itself may hold other imports; top-level
module names are compared whole (`flowerdiff_torch` is not `flowerdiff`)."""
import json
import subprocess
import sys

from conftest import DATA, ROOT

PRELUDE = f"""
import json, sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
def tops():
    return sorted({{m.split('.')[0] for m in sys.modules}})
"""


def _tops(body: str):
    out = subprocess.run([sys.executable, "-c", PRELUDE + body + "\nprint(json.dumps(tops()))"],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_a_cells_set_up_load_no_jax():
    body = f"""
import torch
from pathlib import Path
from portbench.harness import cell, env, spec
from portbench.harness.cell import Prepared
s = spec.Spec(Path({str(DATA / 'BENCHMARK.json')!r}), first=[Path({str(DATA)!r})])
Prepared(s, "tiny_v2.online", 3, torch.device("cpu"))
import flowerdiff_torch.serving_http
assert env.forbidden_modules() == [], env.forbidden_modules()
"""
    tops = _tops(body)
    assert "flowerdiff_torch" in tops  # the program was loaded
    assert not tops & {"jax", "jaxlib", "flax", "flowerdiff"}


def test_the_reference_alone_loads_nothing_of_either_package():
    body = """
import portbench.reference.sampler, portbench.reference.decoder, portbench.reference.denoiser
import portbench.reference.philox, portbench.reference.seeds
"""
    tops = _tops(body)
    assert "portbench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "flowerdiff", "flowerdiff_torch"}
