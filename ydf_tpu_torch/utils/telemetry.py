"""The two pieces of the JAX package's telemetry that `model.benchmark`
reads (counterpart of ydf_tpu/utils/telemetry.py: LatencyHistogram,
peak_rss_bytes). Spans, counters, the metrics registry and the memory
ledger are not ported (ROADMAP Queue 1 item 17).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

#: Linear sub-buckets per power-of-two octave: worst-case relative
#: bucket width (and so percentile error) is 1/_SUB = 12.5 %.
_SUB = 8
_NUM_BUCKETS = 64 * _SUB


class LatencyHistogram:
    """Log2-bucketed histogram over non-negative integer nanoseconds.

    Bucket index for v ≥ 1: octave e = v.bit_length() − 1, sub-bucket
    s = ⌊(v − 2^e) · 8 / 2^e⌋, index = 8·e + s; v < 1 → bucket 0.
    Percentiles walk the 512 slots and interpolate linearly inside the
    covering sub-bucket, clamped to the exact observed [min, max]."""

    __slots__ = ("buckets", "count", "total", "min", "max")

    def __init__(self) -> None:
        self.buckets = [0] * _NUM_BUCKETS
        self.count = 0
        self.total = 0
        self.min = None  # exact extrema: clamp + zero-count answers
        self.max = None

    @staticmethod
    def bucket_index(v: int) -> int:
        if v < 1:
            return 0
        e = v.bit_length() - 1
        if e > 62:
            return _NUM_BUCKETS - 1
        return (e << 3) + (((v - (1 << e)) << 3) >> e)

    @staticmethod
    def bucket_bounds(i: int) -> Tuple[float, float]:
        e, s = i >> 3, i & 7
        base = float(1 << e)
        return base + s * base / _SUB, base + (s + 1) * base / _SUB

    def observe_ns(self, v) -> None:
        v = int(v)
        self.buckets[self.bucket_index(v)] += 1
        self.count += 1
        self.total += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v

    def observe_s(self, seconds: float) -> None:
        self.observe_ns(int(seconds * 1e9))

    def percentile_ns(self, p: float) -> Optional[float]:
        """Nearest-rank percentile with in-bucket linear interpolation;
        None while empty."""
        if self.count == 0:
            return None
        rank = min(max(int(math.ceil(p / 100.0 * self.count)), 1),
                   self.count)
        cum = 0
        for i, c in enumerate(self.buckets):
            if c == 0:
                continue
            if cum + c >= rank:
                lo, hi = self.bucket_bounds(i)
                frac = (rank - cum) / c
                est = lo + frac * (hi - lo)
                return float(min(max(est, self.min), self.max))
            cum += c
        return float(self.max)


def peak_rss_bytes() -> int:
    """Process-lifetime peak RSS in bytes (getrusage ru_maxrss, kB on
    Linux); 0 where unavailable."""
    try:
        import resource

        return int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024
    except (ImportError, OSError):
        return 0
