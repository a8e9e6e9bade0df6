"""Device busy time per training step in the traced window, in ms."""


def read(rec):
    if rec.trace is None or not rec.steps:
        return None
    return 1e3 * rec.trace.busy_s / rec.steps
