"""Mean lag from a write's commit to its events on the subscriber queues:
``kb.watch.lag.seconds{point=queue}``, ms."""


def read(w):
    s = w.samples("kb.watch.lag.seconds", point="queue")
    return sum(s) / len(s) * 1e3 if s else None
