"""Closed loop: one client calls ``Predictor`` back to back, each call
``call_records`` rows of a host pool of ``pool_records``, until ``--seconds``
have passed.  Every call's probabilities are kept and compared with the
reference's."""

from __future__ import annotations

from typing import Callable

import numpy as np

from benchmark import roofline
from benchmark.drive import Serve, Window, chunk_rows, now


class Load(Serve):
    def warm(self) -> None:
        for _ in range(2):
            self.call(self.predictor, 0, self.traffic["call_records"])

    def window(self, seconds: float, w: Window, on_start: Callable[[], None]) -> None:
        k, cs = self.traffic["call_records"], self.traffic["predictor"]["chunk_size"]
        self.outputs = []
        on_start()
        w.t0 = now()
        end = w.t0 + int(seconds * 1e9)
        while now() < end:
            s = now()
            self.outputs.append(self.call(self.predictor, 0, k))
            w.spans.add("call", s, now())
            w.attempted += 1
            w.records += k
            w.launched += chunk_rows(k, cs)
        w.t1 = now()
        w.flops = roofline.forward_flops(self.cfg, w.records)

    def checked(self):
        rows = np.arange(self.traffic["call_records"])
        return [(rows, o) for o in self.outputs]
