"""Share of the traced window in which no kernel, copy or set ran on the
card, %: from the ``torch.profiler`` trace of the window."""


def read(w):
    if w.trace is None or w.trace_window_s <= 0:
        return None
    return 100.0 * (1.0 - w.trace["busy_s"] / w.trace_window_s)
