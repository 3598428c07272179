"""The scanner's engine stages (``device_dispatch`` + ``device_compute``
stage seconds) per Range or Count request completed in the window, ms.
Mostly host time: the port labels the host engine's scan of a page of at
most 1,024 rows with these stages, as it labels a kernel launch and its
pull for a query on the mirror."""


def read(w):
    if not w.reads:
        return None
    return (sum(w.samples("kb.rpc.stage.seconds", stage="device_dispatch"))
            + sum(w.samples("kb.rpc.stage.seconds", stage="device_compute"))
            ) * 1e3 / w.reads
