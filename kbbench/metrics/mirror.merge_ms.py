"""Delta merges into the device mirror, ms of merge per second of window:
each ``kb.mirror.merge.seconds`` sample is one merge, emitted as it ends,
so it ran over [emitted - seconds, emitted]; only the part of it inside
the window counts. One merge runs at a time (``_merge_delta`` holds
``_merge_lock`` throughout), so it stays at or under 1,000. Nothing where
no merge ran in the window."""


def read(w):
    ms = 0.0
    for t, s in w.timed("kb.mirror.merge.seconds"):
        ms += max(0.0, min(t, w.t1) - max(t - s, w.t0)) * 1e3
    return ms / w.seconds if ms else None
