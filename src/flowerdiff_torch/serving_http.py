"""HTTP serving front end with request coalescing over the port's services
(port of flowerdiff/serving_http.py), on the standard library alone.

- :class:`CoalescingBatcher`: concurrent requests queue up and are merged
  into ONE service call per dispatch window, so a burst of small requests
  rides one bucket of the service's ladder (one CUDA-graph replay a chunk
  on the card) instead of many. The merged batch still flows through the
  service's `request_plan`, so no request mix captures a new graph once
  `warmup` has run.
- :func:`serve` / :class:`FlowerHTTPServer`: a ThreadingHTTPServer:

    GET  /healthz     -> {"ok": true, "backend": ..., "buckets": [...], ...}
    GET  /stats       -> request/dispatch/coalescing counters
    GET  /v1/classes  -> class-name list (the original repository's
                         stringified indices, v1:1302)
    GET  /v1/colors   -> color-name list (v3 taxonomy), 404 if uncolored
    POST /v1/sample   -> JSON body:
        {"classes": [ids or names...],  # required, one per sample (before
                                        #  n_per_class expansion)
         "n_per_class": 1,              # optional repeat factor
         "colors": [ids or names...],   # optional (v3 dual conditioning)
         "format": "png"|"npy"|"json",  # default png (grid image)
         "latents": false}              # true -> raw latents (npy/json only)
    POST /v1/animate  -> image/gif, the diffusion animation (v1:884-960);
        body {"class": id|name, "color": id|name?, "num_frames": 50,
              "fps": 10, "seed": int?}

The same server fronts the unconditional pixel family (v4/v5,
PixelSamplingService; /healthz reports "family": "pixel"): /v1/sample takes
{"n": count} instead of classes, /v1/animate takes no class, and
/v1/classes and /v1/colors answer 404.

Responses: image/png (a sample grid), application/octet-stream (a .npy
payload, np.load-able) or application/json (nested lists); npy and json
carry float images in [0, 1] also when the service quantises to uint8.
Errors are JSON with HTTP 400/404/413/500/503.

Where the JAX module differs, by force:
  - the batcher hands the service an integer seed,
    `utils.device.derived_seed(seed, dispatch_counter)`, where the JAX one
    folds the counter into a key; `serve` takes an int seed;
  - /healthz's "backend" is the service's device type ("cuda" / "cpu");
  - /v1/animate's "seed" goes to the service as the int it is (without
    one, the server's next derived seed).

Determinism: a dispatch's seed comes from a server-lifetime counter, so
results depend on request arrival order; for reproducible output call the
service with a seed. The services enqueue under their own lock
(serving.py), so the batcher's two threads and the handlers' animations
interleave safely on the card, provided no graph is captured under traffic:
`serve` refuses a card service with a bucket not yet warmed
(`service.unwarmed()`).
"""
from __future__ import annotations

import io
import json
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from flowerdiff_torch.data.color_labels import COLOR_NAMES
from flowerdiff_torch.utils.device import derived_seed

__all__ = ["CoalescingBatcher", "FlowerHTTPServer", "serve"]


@dataclass
class _Pending:
    """One enqueued request: per-row classes/colors plus a completion event."""

    classes: np.ndarray
    colors: Optional[np.ndarray]
    decode: bool
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    error: Optional[BaseException] = None

    @property
    def kind(self):
        """Requests merge only when they run the same program family."""
        return (self.colors is not None, self.decode)


class CoalescingBatcher:
    """Merges concurrent sampling requests into shared service calls.

    Requests submitted within one dispatch window (`max_wait_ms`, counted
    from the first queued request) are concatenated per `kind` (with or
    without colors x decoded or latents) and run as ONE service call with
    the seed `derived_seed(seed, k)` for dispatch k. Each caller gets back
    exactly its rows.

    Double-buffered: dispatching a window (`service.sample_async`, which
    enqueues the device work) and fetching its results run on two threads
    joined by a queue of depth `pipeline_depth`, so window i + 1 is
    enqueued while window i's copy to the host and its fan-out are still in
    flight.

    `autostart=False` runs no threads; call `drain_once()` by hand (tests
    use it to make coalescing deterministic).
    """

    def __init__(self, service, seed: int, max_wait_ms: float = 5.0,
                 max_batch: int = 512, autostart: bool = True, pipeline_depth: int = 2):
        self.service = service
        self._seed = int(seed)
        self.max_wait_ms = max_wait_ms
        self.max_batch = max_batch
        self._lock = threading.Condition()
        self._queue: list[_Pending] = []
        self._dispatch_counter = 0
        self._inflight = 0  # dispatched windows not yet distributed
        self.pipeline_depth = max(1, pipeline_depth)
        self._stopped = False
        self.stats = {"requests": 0, "images": 0, "dispatches": 0, "max_coalesced": 0,
                      "errors": 0}
        self._worker = None
        self._completer = None
        if autostart:
            # bounded: at most `pipeline_depth` windows in flight (backpressure)
            self._completions = queue.Queue(maxsize=self.pipeline_depth)
            self._worker = threading.Thread(target=self._run, daemon=True,
                                            name="flowerdiff-batcher")
            self._worker.start()
            self._completer = threading.Thread(target=self._complete_loop, daemon=True,
                                               name="flowerdiff-batcher-fetch")
            self._completer.start()

    # -- client side ------------------------------------------------------
    def submit(self, classes, colors=None, decode=True, timeout: float = 600.0) -> np.ndarray:
        """Block until the request's rows are sampled; returns (N, ...)."""
        item = _Pending(
            classes=np.asarray(classes, np.int32).reshape(-1),
            colors=(np.asarray(colors, np.int32).reshape(-1) if colors is not None else None),
            decode=decode,
        )
        if item.colors is not None and item.colors.shape != item.classes.shape:
            raise ValueError("colors must match classes length")
        with self._lock:
            if self._stopped:
                raise RuntimeError("batcher is stopped")
            self._queue.append(item)
            self.stats["requests"] += 1
            self.stats["images"] += int(item.classes.shape[0])
            self._lock.notify_all()
        if not item.done.wait(timeout):
            raise TimeoutError("sampling request timed out")
        if item.error is not None:
            raise item.error
        return item.result

    def next_seed(self) -> int:
        """A fresh seed off the server-lifetime counter (for work outside
        the coalescer, such as /v1/animate without a seed)."""
        with self._lock:
            self._dispatch_counter += 1
            return derived_seed(self._seed, self._dispatch_counter)

    def stop(self):
        with self._lock:
            self._stopped = True
            self._lock.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=5.0)
        if self._completer is not None:
            self._completions.put(None)  # sentinel after the worker drained
            self._completer.join(timeout=5.0)

    # -- worker side ------------------------------------------------------
    def _take_window(self) -> list[_Pending]:
        """Wait for at least one request, then hold the window open for
        max_wait_ms (or until max_batch rows queue up).

        While every pipeline slot holds a dispatched window, the service
        cannot take this one anyway, so the window stays open past
        max_wait_ms (at most 2 s): late arrivals merge instead of
        fragmenting into small trailing dispatches. Once a slot frees (the
        completer notifies), the max_wait_ms clock applies."""
        with self._lock:
            while not self._queue and not self._stopped:
                self._lock.wait(timeout=0.1)
            if not self._queue:
                return []
            deadline = time.monotonic() + self.max_wait_ms / 1e3
            hard_deadline = time.monotonic() + 2.0  # safety cap
            while (sum(p.classes.shape[0] for p in self._queue) < self.max_batch
                   and not self._stopped):
                now = time.monotonic()
                if self._completer is not None and self._inflight >= self.pipeline_depth:
                    if now >= hard_deadline:
                        break
                    self._lock.wait(timeout=0.05)
                    continue
                remaining = deadline - now
                if remaining <= 0:
                    break
                self._lock.wait(timeout=remaining)
            batch, self._queue = self._queue, []
            return batch

    def drain_once(self):
        """Process everything currently queued (test / manual mode)."""
        with self._lock:
            batch, self._queue = self._queue, []
        self._process(batch)

    def _run(self):
        while True:
            batch = self._take_window()
            if not batch:
                with self._lock:
                    if self._stopped and not self._queue:
                        return
                continue
            self._process(batch, pipelined=self._completer is not None)

    def _dispatch_group(self, kind, items: list[_Pending]):
        """Dispatch one merged group; returns a zero-argument fetch() or None
        on a dispatch error (already surfaced to the callers)."""
        has_colors, decode = kind
        classes = np.concatenate([p.classes for p in items])
        colors = np.concatenate([p.colors for p in items]) if has_colors else None
        with self._lock:
            seed = derived_seed(self._seed, self._dispatch_counter)
            self._dispatch_counter += 1
            self.stats["dispatches"] += 1
            self.stats["max_coalesced"] = max(self.stats["max_coalesced"], len(items))
            self._inflight += 1
        try:
            return self.service.sample_async(classes, seed, colors, decode=decode)
        except BaseException as exc:  # surface device errors per caller
            self._window_done()
            self._fail_group(items, exc)
            return None

    def _window_done(self):
        with self._lock:
            self._inflight -= 1
            self._lock.notify_all()  # wake a busy-pipeline window hold

    def _fail_group(self, items: list[_Pending], exc: BaseException):
        with self._lock:
            self.stats["errors"] += 1
        for p in items:
            p.error = exc
            p.done.set()

    @staticmethod
    def _distribute(items: list[_Pending], out: np.ndarray):
        start = 0
        for p in items:
            n = p.classes.shape[0]
            p.result = out[start:start + n]
            start += n
            p.done.set()

    def _finish(self, fetch, items: list[_Pending]):
        try:
            out = np.asarray(fetch())
        except BaseException as exc:
            self._window_done()
            self._fail_group(items, exc)
            return
        self._distribute(items, out)
        self._window_done()

    def _complete_loop(self):
        """Fetch side of the double buffer: waits for a window's results and
        fans them out while the worker thread dispatches the next window."""
        while True:
            entry = self._completions.get()
            if entry is None:
                return
            self._finish(*entry)

    def _process(self, batch: list[_Pending], pipelined: bool = False):
        groups: dict[tuple, list[_Pending]] = {}
        for item in batch:
            groups.setdefault(item.kind, []).append(item)
        for kind, items in groups.items():
            fetch = self._dispatch_group(kind, items)
            if fetch is None:
                continue
            if pipelined:
                self._completions.put((fetch, items))  # bounded: backpressure
            else:
                self._finish(fetch, items)


# ---------------------------------------------------------------------------
# HTTP layer
# ---------------------------------------------------------------------------
def _png_grid(images: np.ndarray) -> bytes:
    """(N, H, W, 3) floats in [0, 1] (or quantised uint8) -> one grid PNG
    (row-major, about square)."""
    from PIL import Image

    n, h, w, c = images.shape
    cols = int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    grid = np.zeros((rows * h, cols * w, c), np.uint8)
    if images.dtype == np.uint8:  # quantize_uint8 service: ready as is
        arr = images
    else:
        arr = (np.clip(images, 0.0, 1.0) * 255).astype(np.uint8)
    for i in range(n):
        r, cc = divmod(i, cols)
        grid[r * h:(r + 1) * h, cc * w:(cc + 1) * w] = arr[i]
    buf = io.BytesIO()
    Image.fromarray(grid).save(buf, format="PNG")
    return buf.getvalue()


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


class _Handler(BaseHTTPRequestHandler):
    # HTTP/1.1 keep-alive (every reply carries Content-Length) and
    # TCP_NODELAY: the header flush and the body are separate writes, which
    # Nagle's algorithm and delayed ACKs would hold back
    protocol_version = "HTTP/1.1"
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    def _reply(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code: int, obj):
        self._reply(code, json.dumps(obj).encode(), "application/json")

    def _body(self):
        length = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(length) or b"{}")

    def do_GET(self):
        svc = self.server.batcher.service
        if self.path == "/healthz":
            self._json(200, {
                "ok": True,
                "backend": self.server.backend,
                "buckets": list(svc.buckets),
                "family": self.server.family,
                "num_classes": getattr(svc.model, "num_classes", None),
                "num_colors": getattr(svc.model, "num_colors", None),
            })
        elif self.path == "/stats":
            self._json(200, {**self.server.batcher.stats, "animations": self.server.animations})
        elif self.path == "/v1/classes":
            if self.server.family == "pixel":
                return self._json(404, {"error": "the pixel family is unconditional"})
            self._json(200, {"classes": self.server.class_names})
        elif self.path == "/v1/colors":
            if getattr(svc.model, "num_colors", None) is None:
                return self._json(404, {"error": "this model has no color conditioning"})
            self._json(200, {"colors": COLOR_NAMES[:svc.model.num_colors]})
        else:
            self._json(404, {"error": "not found"})

    def do_POST(self):
        if self.path == "/v1/animate":
            return self._animate()
        if self.path != "/v1/sample":
            return self._json(404, {"error": "not found"})
        try:
            req = self._body()
        except ValueError:  # json.JSONDecodeError included
            return self._json(400, {"error": "invalid JSON body"})
        try:
            classes, colors, decode, fmt = self._validate(req)
        except ValueError as exc:
            code = 413 if "exceeds" in str(exc) else 400
            return self._json(code, {"error": str(exc)})
        try:
            out = self.server.batcher.submit(classes, colors, decode=decode)
        except RuntimeError as exc:
            return self._json(503, {"error": str(exc)})
        except BaseException as exc:  # device-side failure
            return self._json(500, {"error": f"{type(exc).__name__}: {exc}"})
        if fmt == "png":
            return self._reply(200, _png_grid(out), "image/png")
        if out.dtype == np.uint8:
            # quantize_uint8 service: keep the float [0, 1] contract of npy/json
            out = out.astype(np.float32) / 255.0
        if fmt == "npy":
            self._reply(200, _npy_bytes(out), "application/octet-stream")
        else:
            self._json(200, {"shape": list(out.shape), "data": out.tolist()})

    def _animate(self):
        """POST /v1/animate: the diffusion animation (v1:884-960) as GIF
        bytes. Runs outside the coalescer, on the handler's thread; the
        service's lock orders its device work with the batcher's."""
        try:
            req = self._body()
        except ValueError:
            return self._json(400, {"error": "invalid JSON body"})
        svc = self.server.batcher.service
        pixel = self.server.family == "pixel"
        try:
            class_idx = color = None
            if pixel:
                if "class" in req or "color" in req:
                    raise ValueError("the pixel family is unconditional")
            else:
                if "class" not in req:
                    raise ValueError("'class' (id or name) is required")
                (class_idx,) = self._resolve([req["class"]], self.server.class_names,
                                             "classes", svc.model.num_classes)
                if req.get("color") is not None:
                    if svc.model.num_colors is None:
                        raise ValueError("this model has no color conditioning")
                    (color,) = self._resolve([req["color"]], COLOR_NAMES, "colors",
                                             svc.model.num_colors)
            num_frames = req.get("num_frames", 50)
            if not isinstance(num_frames, int) or not 2 <= num_frames <= 200:
                raise ValueError("'num_frames' must be an int in [2, 200]")
            fps = req.get("fps", 10)
            if not isinstance(fps, int) or not 1 <= fps <= 60:
                raise ValueError("'fps' must be an int in [1, 60]")
            seed = req.get("seed")
            if seed is not None and not isinstance(seed, int):
                raise ValueError("'seed' must be an int")
        except ValueError as exc:
            return self._json(400, {"error": str(exc)})
        seed = seed if seed is not None else self.server.batcher.next_seed()
        try:
            if pixel:
                gif = svc.animate(seed, num_frames=num_frames, fps=fps)
            else:
                gif = svc.animate(class_idx, seed, color=color, num_frames=num_frames,
                                  fps=fps, label=self.server.class_names[class_idx])
        except BaseException as exc:
            return self._json(500, {"error": f"{type(exc).__name__}: {exc}"})
        with self.server.anim_lock:
            self.server.animations += 1
        self._reply(200, gif, "image/gif")

    def _resolve(self, entries, names, what: str, limit: int):
        """A list of ids or names -> int indices (the original repository's
        name-or-index arguments, v1:856-882 and v3:1175-1234)."""
        out = []
        lookup = {n: i for i, n in enumerate(names)} if names else {}
        for c in entries:
            if isinstance(c, bool) or not isinstance(c, (int, str)):
                raise ValueError(f"'{what}' entries must be ints or names")
            if isinstance(c, str):
                if c not in lookup:
                    raise ValueError(f"unknown {what} name {c!r} (see GET /v1/{what})")
                c = lookup[c]
            if not 0 <= c < limit:
                raise ValueError(f"{what} ids must be in [0, {limit})")
            out.append(c)
        return out

    def _validate(self, req):
        svc = self.server.batcher.service
        limit = self.server.batcher.max_batch
        if self.server.family == "pixel":
            # unconditional family: the request names a count, not classes
            if "classes" in req or "colors" in req:
                raise ValueError("the pixel family is unconditional; "
                                 "request {'n': count} instead of classes")
            n = req.get("n", 1)
            if not isinstance(n, int) or n < 1:
                raise ValueError("'n' must be a positive int")
            if n > limit:
                raise ValueError(f"request of {n} images exceeds the "
                                 f"{limit}-image limit; split the request")
            if req.get("latents"):
                raise ValueError("the pixel family has no latent space")
            fmt = req.get("format", "png")
            if fmt not in ("png", "npy", "json"):
                raise ValueError("'format' must be png, npy, or json")
            return np.zeros((n,), np.int32), None, True, fmt
        classes = req.get("classes")
        if not isinstance(classes, list) or not classes:
            raise ValueError("'classes' must be a non-empty list of ids or names")
        n_per = req.get("n_per_class", 1)
        if not isinstance(n_per, int) or n_per < 1:
            raise ValueError("'n_per_class' must be a positive int")
        classes = self._resolve(classes, self.server.class_names, "classes",
                                svc.model.num_classes)
        total = len(classes) * n_per
        if total > limit:
            raise ValueError(f"request of {total} images exceeds the "
                             f"{limit}-image limit; split the request")
        colors = req.get("colors")
        if colors is not None:
            if svc.model.num_colors is None:
                raise ValueError("this model has no color conditioning")
            if not isinstance(colors, list) or len(colors) != len(classes):
                raise ValueError("'colors' must be a list matching 'classes' length")
            colors = self._resolve(colors, COLOR_NAMES, "colors", svc.model.num_colors)
            colors = np.repeat(np.asarray(colors, np.int32), n_per)
        decode = not bool(req.get("latents", False))
        fmt = req.get("format", "png")
        if fmt not in ("png", "npy", "json"):
            raise ValueError("'format' must be png, npy, or json")
        if not decode and fmt == "png":
            raise ValueError("latents=true requires format npy or json")
        return np.repeat(np.asarray(classes, np.int32), n_per), colors, decode, fmt


class FlowerHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # listen(5) drops SYNs under a burst of concurrent clients, and each
    # dropped SYN costs the client a retransmit about a second later
    request_queue_size = 128

    def __init__(self, addr, batcher: CoalescingBatcher, verbose=False, class_names=None):
        super().__init__(addr, _Handler)
        self.batcher = batcher
        self.verbose = verbose
        self.animations = 0
        self.anim_lock = threading.Lock()
        svc = batcher.service
        self.backend = torch.device(svc.device).type
        num_classes = getattr(svc.model, "num_classes", None)
        # "pixel" = the unconditional v4/v5 family (PixelSamplingService):
        # requests carry a count, not classes
        self.family = "latent" if num_classes is not None else "pixel"
        # torchvision's Flowers102 has no names: the original repository
        # uses stringified indices (v1:1302)
        self.class_names = (list(class_names) if class_names is not None
                            else [str(i) for i in range(num_classes or 0)])


def serve(service, seed: int, host: str = "0.0.0.0", port: int = 8000,
          max_wait_ms: float = 5.0, max_batch: int = 512, verbose: bool = False,
          class_names=None) -> FlowerHTTPServer:
    """Build the batcher and the server (does NOT block; call
    serve_forever()). The service must be warmed first (`warmup`): on the
    card a bucket's first call captures its CUDA graph, which another
    thread's device call during the capture would break, so a service
    with `unwarmed()` buckets raises RuntimeError here."""
    missing = service.unwarmed()
    if missing:
        raise RuntimeError(f"buckets {missing} have no CUDA graph captured yet: call "
                           f"service.warmup() before serving")
    batcher = CoalescingBatcher(service, seed, max_wait_ms=max_wait_ms, max_batch=max_batch)
    return FlowerHTTPServer((host, port), batcher, verbose=verbose, class_names=class_names)
