"""A model family of another kind comes in from new files alone: a folder
outside `portbench/` holds a configuration, `families/toy.py` and two
mixes, and `cell.run` drives it on the CPU in a closed and in an open loop
through the port's `CoalescingBatcher`. The toy declares classes and colours
(and, as `toy_plain`, no condition at all), serves uint8 images from a
seeded table in bucket-sized chunks with noise drawn per (seed, chunk), and
recomputes them in its own reference. The sound toy is correct; an answer
with altered pixels and one rendered with swapped colours are not; and no
file under `portbench/` changes."""
import json
import time

import numpy as np
import pytest
import torch

from portbench.harness import cell
from portbench.harness.spec import Spec

from conftest import ROOT

TOY = '''
import numpy as np
import torch


def conditions(cfg):
    return {"classes": cfg["classes"], "colors": cfg["colors"]} if cfg["colors"] \\
        else {"classes": cfg["classes"]}


def make(cfg, seed, device):
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**62)
    side = cfg["side"]
    shape = (cfg["classes"] or 1, cfg["colors"] or 1, side, side, 3)
    return torch.randint(0, 200, shape, generator=gen, device=device), None


def _plan(n, buckets):
    top = buckets[-1]
    plan = [top] * (n // top)
    if n % top:
        plan.append(next(b for b in buckets if n % top <= b))
    return plan or [buckets[0]]


def _noise(seed, chunk, bucket, side):
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), chunk]))
    return rng.integers(0, 50, (bucket, side, side, 3))


def _render(table, classes, colors):
    cls = classes if table.shape[0] > 1 else np.zeros_like(classes)
    col = colors if colors is not None else np.zeros_like(classes)
    return table[cls, col]


class ToyService:
    def __init__(self, cfg, table):
        self.table = table.cpu().numpy()
        self.buckets = tuple(cfg["buckets"])
        self.side = cfg["side"]

    def request_plan(self, n):
        return _plan(n, self.buckets)

    def warmup(self, seed, buckets=None):
        for b in buckets or self.buckets:
            self.sample_async(np.zeros((b,), np.int64), seed)()

    def colors_used(self, colors):
        return colors

    def sample_async(self, classes, seed=0, colors=None, decode=True):
        classes = np.asarray(classes, np.int64)
        colors = None if colors is None else self.colors_used(np.asarray(colors, np.int64))
        out, start = [], 0
        for i, b in enumerate(self.request_plan(len(classes))):
            take = min(b, len(classes) - start)
            part = slice(start, start + take)
            img = _render(self.table, classes[part], None if colors is None else colors[part])
            out.append((img + _noise(seed, i, b, self.side)[:take]).astype(np.uint8))
            start += take
        images = np.concatenate(out)
        return lambda: images


def build_service(cfg, params, stats, device):
    return ToyService(cfg, params)


def reference(params, stats, cfg, picks, precision):
    table = params.cpu().numpy()
    if precision == "control":
        table = table // 8 * 8
    out = []
    for d, first, n in picks:
        plan = _plan(len(d.classes), cfg["buckets"])
        starts = np.cumsum([0] + plan[:-1])
        for j in range(first, first + n):
            c = int(np.searchsorted(starts, j, side="right") - 1)
            colors = None if d.colors is None else d.colors[j:j + 1]
            img = _render(table, d.classes[j:j + 1], colors)[0]
            out.append((img + _noise(d.seed, c, plan[c], cfg["side"])[j - starts[c]])
                       .astype(np.uint8))
    return np.stack(out)


def image_flops(cfg):
    return 3 * cfg["side"] ** 2
'''

LIMITS = {"image_gap": 0.5, "unplaced": 0, "missing": 0}
MIXES = {
    "grid": {"loop": "closed", "in_flight": 2, "classes": "grid", "class_ids": [0, 1, 2, 3, 4],
             "per_class": 2, "lead_s": 0.0, "check_requests": 4},
    "online": {"loop": "open", "classes": "uniform", "sizes": [1, 2, 3, 5], "rate_per_s": 60,
               "client_threads": 16, "lead_s": 0.2, "check_requests": 8,
               "batcher": {"max_wait_ms": 5.0, "max_batch": 16, "pipeline_depth": 2}},
}
CONFIGS = {"toy": {"classes": 5, "colors": 3}, "toy_plain": {"classes": None, "colors": None}}


@pytest.fixture
def toy_spec(tmp_path):
    """A Spec over a folder that holds the toy family alone; checks on the
    way out that nothing under portbench/ changed."""
    def files():
        return {p: p.read_bytes() for p in (ROOT / "portbench").rglob("*")
                if p.is_file() and "__pycache__" not in str(p)}

    before = files()
    for d in ("configs", "families", "traffic"):
        (tmp_path / d).mkdir()
    (tmp_path / "families/toy.py").write_text(TOY)
    for name, mix in MIXES.items():
        (tmp_path / f"traffic/{name}.json").write_text(json.dumps(mix))
    for name, conds in CONFIGS.items():
        (tmp_path / f"configs/{name}.json").write_text(json.dumps(
            {"name": name, "family": "toy", **conds, "side": 4, "buckets": [4, 8],
             "check": {"limits": LIMITS}}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": n, "source": "https://example.org/toy", "reduced": [],
                         "file": f"configs/{n}.json", "why": "a test"} for n in CONFIGS]
    bench["workloads"] = [{"name": f"{c}.{m}", "config": c, "traffic": m, "chips": 1,
                           "why": "a test"} for c in CONFIGS for m in MIXES]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    yield Spec(tmp_path / "BENCHMARK.json", first=[tmp_path])
    assert files() == before


def _run(spec, name):
    res = cell.run(spec, name, 2**31 + 17, 0.6, False, torch.device("cpu"), time.perf_counter(),
                   metric_names=["images_per_s", "mfu.toy"])
    return res, res["verdict"]


@pytest.mark.parametrize("name", [f"{c}.{m}" for c in CONFIGS for m in MIXES])
def test_sound_toy_is_correct(toy_spec, name):
    res, v = _run(toy_spec, name)
    assert v["correct"], v["numbers"]
    assert v["images"] > 0 and v["numbers"]["image_gap"] == 0.0
    assert res["metrics"]["images_per_s"]["value"] > 0
    assert res["metrics"]["mfu.toy"]["value"] > 0  # the family's image_flops


def test_toy_control_is_not_correct(toy_spec):
    res = cell.run(toy_spec, "toy.online", 2**31 + 18, 0.6, False, torch.device("cpu"),
                   time.perf_counter(), metric_names=[], control=True)
    assert res["verdict"]["correct"]
    assert not res["verdict"]["control"]["correct"], res["verdict"]["control"]["numbers"]


def _pixels_altered(toy):
    orig = toy.ToyService.sample_async

    def altered(self, *args, **kw):
        out = orig(self, *args, **kw)().copy()
        out[:, :2] = 255 - out[:, :2]
        return lambda: out

    return altered


def _colors_swapped(toy):
    return lambda self, colors: (colors + 1) % 3


FAULTS = {"pixels_altered": ("sample_async", _pixels_altered),
          "colors_swapped": ("colors_used", _colors_swapped)}


@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_toy_is_not_correct(toy_spec, monkeypatch, fault, mix):
    cfg = toy_spec.config("toy")
    toy = toy_spec.family(cfg)
    attr, make = FAULTS[fault]
    monkeypatch.setattr(toy.ToyService, attr, make(toy))
    res, v = _run(toy_spec, f"toy.{mix}")
    assert not v["correct"], v["numbers"]
    assert v["numbers"]["unplaced"] == 0  # placed by classes and colours, wrong in its pixels


def test_colours_reach_the_service_and_the_placement(toy_spec):
    from portbench.harness import check

    prep = cell.Prepared(toy_spec, "toy.online", 2**31 + 19, torch.device("cpu"))
    run, rec = prep.drive(0.6, False)
    assert all(d.colors is not None and len(d.colors) == len(d.classes) for d in rec.dispatches)
    r = next(r for r in run.in_window() if r.result is not None and len(r.classes) >= 2)
    assert r.colors is not None and check.place(r, rec.dispatches) is not None
    r.colors = (r.colors + 1) % 3  # a request whose colours no dispatch row has
    assert check.place(r, rec.dispatches) is None


def test_a_config_without_a_family_raises(toy_spec):
    cfg = toy_spec.config("toy")
    del cfg["family"]
    with pytest.raises(KeyError):
        toy_spec.family(cfg)
    with pytest.raises(FileNotFoundError):
        toy_spec.family({**cfg, "family": "nope"})
