"""What the benchmark reads does not move with its model families: the
latent family, reached through `Spec.family`, makes the same weight bytes
from the same seed, draws the same open-loop schedule and computes the same
reference bytes for fixed picks as the harness did before families
(`data/digests.json`, taken from that harness on the CPU)."""
import hashlib
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench.harness import traffic as tr
from portbench.harness.spec import Spec

from conftest import DATA

PINNED = json.loads((DATA / "digests.json").read_text())
SEED = PINNED["seed"]
# (dispatch seed, dispatch classes, first row, images): a grid's rows inside
# one chunk, and six rows across the 64-row chunk of a 70-image dispatch
PICKS = [(SEED + 1, list(range(10)) * 5, 3, 4),
         (SEED + 2, [(7 * i) % 102 for i in range(70)], 60, 6)]


def _spec_and_config(name):
    spec = Spec(DATA / "BENCHMARK.json", first=[DATA]) if name.startswith("tiny") else Spec()
    return spec, spec.config(name)


def _weights_digest(params, stats) -> str:
    h = hashlib.sha256()
    for part in sorted(params):
        for name in sorted(params[part]):
            t = params[part][name].detach().cpu().contiguous()
            h.update(f"{part}.{name}:{tuple(t.shape)}:{t.dtype}".encode())
            h.update(t.numpy().tobytes())
    for t in stats:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(PINNED["weights"]))
def test_weights_are_the_pinned_bytes(name):
    spec, cfg = _spec_and_config(name)
    params, stats = spec.family(cfg).make(cfg, SEED, torch.device("cpu"))
    assert _weights_digest(params, stats) == PINNED["weights"][name]


@pytest.mark.parametrize("key", sorted(PINNED["reference"]))
def test_reference_images_are_the_pinned_bytes(key):
    name, precision = key.split(".")
    spec, cfg = _spec_and_config(name)
    family = spec.family(cfg)
    params, stats = family.make(cfg, SEED, torch.device("cpu"))
    picks = [(SimpleNamespace(seed=seed, classes=np.asarray(classes, np.int64), colors=None),
              first, n) for seed, classes, first, n in PICKS]
    images = family.reference(params, stats, cfg, picks, precision)
    assert images.shape == (sum(p[2] for p in picks), 64, 64, 3) and images.dtype == np.uint8
    assert hashlib.sha256(images.tobytes()).hexdigest() == PINNED["reference"][key]


@pytest.mark.parametrize("cell", sorted(PINNED["schedule"]))
def test_open_schedule_is_the_pinned_draw(cell):
    name, mix_name = cell.split(".")
    spec, cfg = _spec_and_config(name)
    plan = tr.open_schedule(spec.traffic(mix_name), spec.family(cfg).conditions(cfg), 56.0, SEED)
    h = hashlib.sha256()
    for p in plan:
        assert p.colors is None
        h.update(np.float64(p.due).tobytes())
        h.update(np.asarray(p.classes, np.int64).tobytes())
    assert {"n": len(plan), "sha256": h.hexdigest()} == PINNED["schedule"][cell]
