"""Seconds of one compaction: ``kb.compact.seconds`` summed over its
phases, over the compactions that began in the window (each is waited for,
also where it ends after the window)."""


def read(w):
    n = w.compactions
    if not n:
        return None
    return sum(w.samples_after_start("kb.compact.seconds")) / n
