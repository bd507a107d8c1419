"""What a metric's reader is given: the run's records, the configuration and
its family's module, the traffic mix, the profiled stretch; and the helpers
they share."""
from __future__ import annotations

from typing import List, Optional

import numpy as np


def percentile(values: List[float], q: float) -> Optional[float]:
    return float(np.percentile(np.asarray(values, np.float64), q)) if values else None


class Context:
    def __init__(self, cfg: dict, traffic: dict, run, dispatches, seconds: float,
                 setup_s: float, family=None):
        self.cfg, self.traffic, self.run, self.family = cfg, traffic, run, family
        self.dispatches, self.seconds, self.setup_s = dispatches, seconds, setup_s

    @property
    def trace(self):
        return self.run.trace

    def window_requests(self):
        """Requests sent (closed loop) or due (open loop) in the window."""
        return self.run.in_window()

    def latencies_ms(self) -> List[float]:
        return [(r.t_done - r.start) * 1e3 for r in self.window_requests() if r.result is not None]

    def delivered_images(self) -> int:
        """Images whose request returned inside the window."""
        run = self.run
        return sum(len(r.classes) for r in run.requests
                   if r.result is not None and run.w0 <= r.t_done <= run.w1)

    def window_dispatches(self):
        return [d for d in self.dispatches if self.run.w0 <= d.t_call < self.run.w1]

    def dispatch_at(self, t: float):
        """The dispatch whose `sample_async` call was running at host time t."""
        for d in self.dispatches:
            if d.t_call <= t <= (d.t_issued if d.t_issued is not None else d.t_call):
                return d
        return None
