"""The whole step's share of the card's peak, in %: the least time the
counted work (``counts/``) of the traced run's untraced window needs at
the published float32 and HBM peaks, over that window's wall time, so the
profiler's own cost does not lower it. The power limit is reported beside
it in ``PERF.md``."""

from portbench.counts import least_seconds


def read(rec):
    work = rec.work
    if not work or not rec.rate_window_s or rec.rate_window_s <= 0:
        return None
    return 100.0 * least_seconds(work["flops"], work["bytes"],
                                 rec.peaks) / rec.rate_window_s
