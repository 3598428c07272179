"""Mean wait of a request in the request scheduler's lanes, enqueue to a
worker's pickup: ``kb.rpc.stage.seconds{stage=queue_wait}``, ms."""


def read(w):
    s = w.samples("kb.rpc.stage.seconds", stage="queue_wait")
    return sum(s) / len(s) * 1e3 if s else None
