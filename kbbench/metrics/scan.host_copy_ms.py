"""The scanner's host materialization (``host_copy`` stage seconds) per
Range or Count request completed in the window, ms."""


def read(w):
    if not w.reads:
        return None
    return sum(w.samples("kb.rpc.stage.seconds", stage="host_copy")) \
        * 1e3 / w.reads
