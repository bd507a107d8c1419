"""Device time of a CUDA call, with the host's launch overhead left out."""
from __future__ import annotations

import torch


def cuda_ms(fn, iters: int = 50) -> float:
    """Device time of one call: `iters` calls captured in a CUDA graph and
    replayed between CUDA events, so host launch overhead is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
