"""Kernel launches the host issued per training step in the traced
window, from the trace's runtime launch calls (a graph replay is one)."""


def read(rec):
    if rec.trace is None or not rec.steps or not rec.trace.launches:
        return None
    return rec.trace.launches / rec.steps
