"""The port's coalescing HTTP front end (flowerdiff_torch/serving_http.py)
against the JAX package's (flowerdiff/serving_http.py).

  - the batcher's semantics, as tests/test_serving_http.py holds the JAX
    one's: one dispatch a window, each caller's rows equal to the unbatched
    call at `derived_seed(seed, k)` for dispatch k, kinds grouped, errors per
    caller, window i + 1 dispatched while window i's fetch waits;
  - the protocol: the JAX server and the port's, each over the same
    deterministic stub service (images computed from the class and color
    ids, the key or seed ignored, so no JAX program compiles), answer the
    same list of requests, valid and invalid, for both families and a
    color model, with equal status codes, content types and bodies (JSON,
    PNG and npy bytes, GIF bytes from the stub). /healthz's "backend" is
    the service's device type in the port and `jax.default_backend()` in
    JAX: "cpu" for both here;
  - live round trips over the port's tiny services on the CPU (the latent
    one with `use_fused=True`, so the kernels' plain twins run): the npy
    rows equal a direct call at the dispatch's seed, the animation equals
    `animate` called directly.
"""
import http.client
import io
import json
import threading
import types

import jax
import numpy as np
import pytest
import torch

from flowerdiff import serving_http as jax_http
from flowerdiff_torch import serving_http as port_http
from flowerdiff_torch.diffusion import linear_schedule
from flowerdiff_torch.serving import PixelSamplingService, SamplingService
from flowerdiff_torch.serving_http import CoalescingBatcher, serve
from flowerdiff_torch.utils.device import derived_seed
from flowerdiff_torch.utils.weights import (
    denoiser_from_params,
    init_numpy_params,
    pixel_unet_from_params,
    vae_from_params,
)
from torch_port_threads import one_thread_per_process  # noqa: F401 (autouse)

DEN = dict(latent_dim=16, hidden_dims=(16, 32, 16), time_emb_dim=16, num_classes=6)
VAE = dict(latent_dim=16, channels=(8, 16, 24, 32), head_width=32)


def _tiny_service(num_colors=None, buckets=(4, 8), use_fused=False, quantize=False):
    den = dict(DEN, num_colors=num_colors, shared_cond_proj=num_colors is None)
    return SamplingService(
        denoiser_from_params(init_numpy_params("denoiser", seed=0, **den), device="cpu", **den),
        vae_from_params(init_numpy_params("vae", seed=1, **VAE), device="cpu", **VAE),
        sched=linear_schedule(8), buckets=buckets, use_fused=use_fused,
        quantize_uint8=quantize, device="cpu")


def _wait_for(batcher, n):
    for _ in range(500):
        if batcher.stats["requests"] == n:
            return
        threading.Event().wait(0.01)
    raise AssertionError(f"{n} requests never queued")


def _submit_all(batcher, requests):
    """Submit each (name, args, kwargs) from its own thread, drain once,
    return {name: result or exception}."""
    out = {}

    def client(name, args, kw):
        try:
            out[name] = batcher.submit(*args, **kw)
        except Exception as exc:  # the per-caller error is the result
            out[name] = exc

    threads = [threading.Thread(target=client, args=r) for r in requests]
    before = batcher.stats["requests"]
    for i, t in enumerate(threads):
        t.start()
        _wait_for(batcher, before + i + 1)  # queue in a known order
    batcher.drain_once()
    for t in threads:
        t.join(timeout=60)
    return out


# ---------------------------------------------------------------------------
# batcher semantics (no worker thread: deterministic coalescing)
# ---------------------------------------------------------------------------
def test_batcher_coalesces_requests_into_one_dispatch():
    service = _tiny_service()
    batcher = CoalescingBatcher(service, 1, autostart=False)
    seen = []
    orig = service.sample_async

    def spy(classes, seed, colors=None, decode=True):
        seen.append((int(np.asarray(classes).shape[0]), seed))
        return orig(classes, seed, colors, decode=decode)

    service.sample_async = spy
    out = _submit_all(batcher, [(i, ([i % 6, (i + 1) % 6],), {}) for i in range(3)])
    assert seen == [(6, derived_seed(1, 0))]  # 3 x 2 rows merged into one call
    assert batcher.stats == {"requests": 3, "images": 6, "dispatches": 1, "max_coalesced": 3,
                             "errors": 0}
    for i in range(3):
        assert out[i].shape == (2, 64, 64, 3)


def test_batcher_rows_match_the_unbatched_request():
    """Coalescing is invisible: each caller's rows equal a direct service call
    at the dispatch's seed, sliced at its position, bit for bit."""
    service = _tiny_service(use_fused=True)
    batcher = CoalescingBatcher(service, 2, autostart=False)
    first = _submit_all(batcher, [("a", ([1, 2],), {}), ("b", ([3],), {})])
    second = _submit_all(batcher, [("c", ([5, 0, 4],), {})])
    direct = service.sample(np.array([1, 2, 3]), derived_seed(2, 0))
    np.testing.assert_array_equal(first["a"], direct[:2])
    np.testing.assert_array_equal(first["b"], direct[2:3])
    np.testing.assert_array_equal(second["c"], service.sample(np.array([5, 0, 4]),
                                                              derived_seed(2, 1)))
    assert batcher.next_seed() == derived_seed(2, 3)  # the counter moves on


def test_batcher_groups_incompatible_kinds_separately():
    """A latents request and a decoded request, with and without colors,
    cannot share a call: one dispatch a kind, all complete."""
    service = _tiny_service(num_colors=4)
    batcher = CoalescingBatcher(service, 3, autostart=False)
    out = _submit_all(batcher, [("img", ([0],), dict(colors=[1])),
                                ("lat", ([1],), dict(colors=[2], decode=False)),
                                ("img2", ([2, 3],), dict(colors=[0, 3]))])
    assert batcher.stats["dispatches"] == 2 and batcher.stats["max_coalesced"] == 2
    assert out["img"].shape == (1, 64, 64, 3) and out["img2"].shape == (2, 64, 64, 3)
    assert out["lat"].shape == (1, 16)
    with pytest.raises(ValueError, match="colors must match"):
        batcher.submit([0, 1], colors=[2])


def test_batcher_propagates_errors_per_caller():
    service = _tiny_service()
    batcher = CoalescingBatcher(service, 4, autostart=False)

    def boom(*a, **k):
        raise RuntimeError("device exploded")

    service.sample_async = boom
    out = _submit_all(batcher, [("x", ([0],), {}), ("y", ([1, 2],), {})])
    assert all("device exploded" in str(out[k]) for k in "xy")
    assert batcher.stats["errors"] == 1

    def fetch_fails(*a, **k):
        def fetch():
            raise ValueError("copy failed")
        return fetch

    service.sample_async = fetch_fails
    out = _submit_all(batcher, [("z", ([0],), {})])
    assert isinstance(out["z"], ValueError) and batcher.stats["errors"] == 2
    batcher.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        batcher.submit([0])


def test_batcher_dispatches_ahead_of_the_fetch():
    """Window i + 1 is dispatched while window i's fetch is still blocked."""
    class _AsyncStub:
        def __init__(self):
            self.dispatched = []
            self.release = threading.Event()

        def sample_async(self, classes, seed, colors=None, decode=True):
            n = int(np.asarray(classes).shape[0])
            self.dispatched.append((n, seed))

            def fetch():
                assert self.release.wait(20), "fetch never released"
                return np.zeros((n, 4, 4, 3), np.float32)

            return fetch

    stub = _AsyncStub()
    batcher = CoalescingBatcher(stub, 7, max_wait_ms=1.0, autostart=True)
    try:
        results = {}

        def client(i):
            results[i] = batcher.submit([i, i + 1])

        threads = [threading.Thread(target=client, args=(0,))]
        threads[0].start()
        for want in (1, 2):
            for _ in range(500):
                if len(stub.dispatched) == want:
                    break
                threading.Event().wait(0.01)
            assert len(stub.dispatched) == want, "the batcher waited for a fetch"
            if want == 1:
                threads.append(threading.Thread(target=client, args=(2,)))
                threads[1].start()
        stub.release.set()
        for t in threads:
            t.join(timeout=20)
        assert results[0].shape == results[2].shape == (2, 4, 4, 3)
        assert stub.dispatched == [(2, derived_seed(7, 0)), (2, derived_seed(7, 1))]
    finally:
        stub.release.set()
        batcher.stop()


# ---------------------------------------------------------------------------
# protocol parity: the JAX server and the port's over one stub service
# ---------------------------------------------------------------------------
class _StubService:
    """Images from the class (and color) ids alone; the key or seed is
    ignored. Class 5 fails on the device side (a 500)."""

    def __init__(self, family="latent", num_colors=None, quantize=False):
        self.buckets = (4, 8)
        self.device = torch.device("cpu")
        self.quantize = quantize
        self.model = (types.SimpleNamespace(num_classes=6, num_colors=num_colors)
                      if family == "latent" else types.SimpleNamespace())

    def sample_async(self, classes, key_or_seed, colors=None, decode=True):
        classes = np.asarray(classes).astype(np.int64)
        if (classes == 5).any() and hasattr(self.model, "num_classes"):
            raise ValueError("class 5 failed on the device")
        base = classes * 37 + (0 if colors is None else np.asarray(colors) * 11)
        if not decode:
            out = (base[:, None] + np.arange(16)).astype(np.float32) / 7.0
        else:
            pix = (base[:, None, None, None] + np.arange(8)[:, None, None]
                   + 3 * np.arange(8)[None, :, None] + 5 * np.arange(3)) % 256
            out = pix.astype(np.uint8) if self.quantize else (pix / 255.0).astype(np.float32)
        return lambda: out

    def unwarmed(self):
        return []

    def animate(self, *args, **kw):
        pixel = not hasattr(self.model, "num_classes")
        what = {"class": None if pixel else args[0], **kw}
        return b"GIF89a" + json.dumps(what, sort_keys=True).encode()


def _request(port, method, path, body=None, raw=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    payload = raw if raw is not None else (json.dumps(body) if body is not None else None)
    conn.request(method, path, body=payload, headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, resp.getheader("Content-Type"), data


LATENT_REQUESTS = [
    ("GET", "/healthz", None), ("GET", "/v1/classes", None), ("GET", "/v1/colors", None),
    ("GET", "/nope", None), ("POST", "/nope", {}),
    ("POST", "/v1/sample", {"classes": [0, 3], "n_per_class": 2, "format": "npy"}),
    ("POST", "/v1/sample", {"classes": [1, 2, 4]}),
    ("POST", "/v1/sample", {"classes": ["2", 4, "0"], "format": "json"}),
    ("POST", "/v1/sample", {"classes": [4], "latents": True, "format": "json"}),
    ("POST", "/v1/sample", {"classes": [3, 1], "latents": True, "format": "npy"}),
    ("POST", "/v1/sample", {"classes": [5]}),                     # device-side error
    ("POST", "/v1/sample", {}), ("POST", "/v1/sample", {"classes": []}),
    ("POST", "/v1/sample", {"classes": [99]}), ("POST", "/v1/sample", {"classes": ["nope"]}),
    ("POST", "/v1/sample", {"classes": [True]}),
    ("POST", "/v1/sample", {"classes": [0], "n_per_class": 0}),
    ("POST", "/v1/sample", {"classes": [0], "format": "bmp"}),
    ("POST", "/v1/sample", {"classes": [0], "latents": True}),
    ("POST", "/v1/sample", {"classes": [0], "colors": [1]}),
    ("POST", "/v1/sample", {"classes": list(range(5)) * 4, "n_per_class": 2}),  # 413
    ("POST", "/v1/sample", b"{nope"),
    ("POST", "/v1/animate", {"class": "3", "num_frames": 6, "fps": 5, "seed": 7}),
    ("POST", "/v1/animate", {"class": 2}),
    ("POST", "/v1/animate", {}), ("POST", "/v1/animate", {"class": 99}),
    ("POST", "/v1/animate", {"class": 0, "num_frames": 1}),
    ("POST", "/v1/animate", {"class": 0, "fps": 0}),
    ("POST", "/v1/animate", {"class": 0, "seed": "x"}),
    ("POST", "/v1/animate", {"class": 0, "color": 1}),
    ("POST", "/v1/animate", b"[1,"),
    ("GET", "/stats", None),
]
COLOR_REQUESTS = [
    ("GET", "/healthz", None), ("GET", "/v1/colors", None),
    ("POST", "/v1/sample", {"classes": [0, 1], "colors": ["red", 3], "format": "npy"}),
    ("POST", "/v1/sample", {"classes": [2], "colors": [1], "n_per_class": 3}),
    ("POST", "/v1/sample", {"classes": [0], "colors": ["chartreuse"]}),
    ("POST", "/v1/sample", {"classes": [0], "colors": [9]}),
    ("POST", "/v1/sample", {"classes": [0, 1], "colors": [1]}),
    ("POST", "/v1/animate", {"class": 1, "color": "blue", "seed": 2, "num_frames": 4}),
    ("GET", "/stats", None),
]
PIXEL_REQUESTS = [
    ("GET", "/healthz", None), ("GET", "/v1/classes", None), ("GET", "/v1/colors", None),
    ("POST", "/v1/sample", {"n": 3, "format": "npy"}), ("POST", "/v1/sample", {"n": 2}),
    ("POST", "/v1/sample", {"n": 1, "format": "json"}),
    ("POST", "/v1/sample", {"classes": [0]}), ("POST", "/v1/sample", {"n": 1, "colors": [0]}),
    ("POST", "/v1/sample", {"n": 0}), ("POST", "/v1/sample", {"n": 1, "latents": True}),
    ("POST", "/v1/sample", {"n": 20}), ("POST", "/v1/sample", {"n": 1, "format": "gif"}),
    ("POST", "/v1/animate", {"num_frames": 4, "fps": 5, "seed": 3}),
    ("POST", "/v1/animate", {"class": 0}),
    ("GET", "/stats", None),
]


def _replies(module, seed, service, requests, stopped_body):
    server = module.serve(service, seed, host="127.0.0.1", port=0, max_wait_ms=1.0,
                          max_batch=16)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        port = server.server_address[1]
        out = []
        for method, path, body in requests:
            raw = body if isinstance(body, bytes) else None
            out.append(_request(port, method, path, None if raw else body, raw))
        server.batcher.stop()  # a stopped batcher answers 503
        out.append(_request(port, "POST", "/v1/sample", stopped_body))
        return out
    finally:
        server.shutdown()
        server.server_close()


@pytest.mark.parametrize("case", ["latent", "latent_uint8", "colors", "pixel"])
def test_protocol_matches_the_jax_server(case):
    family = "pixel" if case == "pixel" else "latent"
    requests = {"colors": COLOR_REQUESTS, "pixel": PIXEL_REQUESTS}.get(case, LATENT_REQUESTS)

    def stub():
        return _StubService(family, num_colors=4 if case == "colors" else None,
                            quantize=case == "latent_uint8")

    stopped = {"n": 1} if case == "pixel" else {"classes": [0]}
    got = _replies(port_http, 9, stub(), requests, stopped)
    want = _replies(jax_http, jax.random.key(9), stub(), requests, stopped)
    assert len(got) == len(want) == len(requests) + 1
    codes = []
    for req, (g, w) in zip(requests + [("POST", "stopped", None)], zip(got, want)):
        assert g == w, (req, g[:2], w[:2], g[2][:200], w[2][:200])
        codes.append(g[0])
    assert {200, 400, 503} <= set(codes)
    if case in ("latent", "pixel"):
        assert {404, 413} <= set(codes)
    if case == "latent":
        assert 500 in codes
        health = json.loads(got[0][2])
        assert health["backend"] == jax.default_backend() == "cpu"


# ---------------------------------------------------------------------------
# live round trips over the port's tiny services
# ---------------------------------------------------------------------------
def test_live_round_trip_over_the_tiny_service():
    service = _tiny_service(use_fused=True, quantize=True)
    service.warmup()
    server = serve(service, 21, host="127.0.0.1", port=0, max_wait_ms=1.0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    try:
        status, _, data = _request(port, "GET", "/healthz")
        assert status == 200 and json.loads(data)["buckets"] == [4, 8]
        status, ctype, data = _request(port, "POST", "/v1/sample",
                                       {"classes": [0, 3], "n_per_class": 2, "format": "npy"})
        assert status == 200 and ctype == "application/octet-stream"
        want = service.sample(np.array([0, 0, 3, 3]), derived_seed(21, 0))
        np.testing.assert_array_equal(np.load(io.BytesIO(data)),
                                      want.astype(np.float32) / 255.0)
        status, ctype, data = _request(port, "POST", "/v1/sample", {"classes": [1, 2, 4]})
        assert status == 200 and ctype == "image/png"
        assert data == port_http._png_grid(service.sample(np.array([1, 2, 4]),
                                                          derived_seed(21, 1)))
        status, _, data = _request(port, "POST", "/v1/sample",
                                   {"classes": [5], "latents": True, "format": "json"})
        np.testing.assert_array_equal(np.asarray(json.loads(data)["data"], np.float32),
                                      service.sample(np.array([5]), derived_seed(21, 2),
                                                     decode=False))
        status, ctype, data = _request(port, "POST", "/v1/animate",
                                       {"class": "3", "num_frames": 6, "fps": 5, "seed": 7})
        assert status == 200 and ctype == "image/gif"
        assert data == service.animate(3, 7, num_frames=6, fps=5, label="3")
        status, _, data = _request(port, "POST", "/v1/animate", {"class": 1, "num_frames": 4})
        assert data == service.animate(1, derived_seed(21, 4), num_frames=4, label="1")
        stats = json.loads(_request(port, "GET", "/stats")[2])
        assert stats == {"requests": 3, "images": 8, "dispatches": 3, "max_coalesced": 1,
                         "errors": 0, "animations": 2}
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.stop()


def test_live_round_trip_over_the_tiny_pixel_service():
    model = pixel_unet_from_params(init_numpy_params("pixel", seed=3, base_channels=8,
                                                     time_emb_dim=16),
                                   device="cpu", base_channels=8, time_emb_dim=16)
    service = PixelSamplingService(model, sched=linear_schedule(8), buckets=(2, 4), img_size=16,
                                   device="cpu")
    server = serve(service, 5, host="127.0.0.1", port=0, max_wait_ms=1.0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    try:
        health = json.loads(_request(port, "GET", "/healthz")[2])
        assert health["family"] == "pixel" and health["num_classes"] is None
        status, _, data = _request(port, "POST", "/v1/sample", {"n": 3, "format": "npy"})
        assert status == 200
        np.testing.assert_array_equal(np.load(io.BytesIO(data)),
                                      service.sample_images(3, derived_seed(5, 0)))
        status, ctype, data = _request(port, "POST", "/v1/animate",
                                       {"num_frames": 4, "fps": 5, "seed": 3})
        assert status == 200 and ctype == "image/gif"
        assert data == service.animate(3, num_frames=4, fps=5)
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.stop()


def test_serve_refuses_a_service_with_unwarmed_buckets():
    """A bucket whose first call would bind a kernel plan under traffic
    keeps the server from being built; the CPU services bind none."""
    stub = _StubService()
    stub.unwarmed = lambda: [8]
    with pytest.raises(RuntimeError, match=r"buckets \[8\] have no kernel plan"):
        serve(stub, 0, host="127.0.0.1", port=0)
    assert _tiny_service(use_fused=True).unwarmed() == []
