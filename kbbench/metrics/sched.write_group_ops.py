"""Mean write operations per commit group the scheduler formed:
``kb.sched.write.batch.size``."""


def read(w):
    s = w.samples("kb.sched.write.batch.size")
    return sum(s) / len(s) if s else None
