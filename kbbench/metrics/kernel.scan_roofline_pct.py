"""K1/K2's share of their roofline over the window, %: the least time the
window's scan launches need, over the device time the profiler gave them.

The launches' work is counted from the queries, not from the kernel: each
launch is one execution of the window's Counts (the only reads of these
cells that the scanner sends to the kernels; a page of at most 1,024 rows
takes the host engine's scan), over the version rows the reference's model
holds in the Count's range at the window's end (the mirror holds these,
less any delta not yet merged), each row's key (at the width the
published mirror stores it, ``encoding_stats()["key_bytes_per_row"]``),
revision and tombstone read once and the count written. Bytes bound it."""

from kbbench import roofline


def start(w):
    w.scratch["key_bytes"] = w.backend.scanner.encoding_stats()[
        "key_bytes_per_row"]


def read(w):
    if w.trace is None:
        return None
    n, dev_s = 0, 0.0
    for name, (launches, seconds) in w.trace["ops"].items():
        if roofline.SCAN_KERNEL in name:
            n += launches
            dev_s += seconds
    counts = [op for op in w.traffic["ops"] if op["op"] == "count"]
    if not n or not dev_s or not counts:
        return None
    need = []
    for op in counts:
        res = w.dataset.resources[op["resource"]]
        rows = w.model().version_rows(res.prefix, res.end, w.head)
        need.append(roofline.scan_need(rows, w.scratch["key_bytes"]))
    nbytes = n * sum(b for b, _o in need) / len(need)
    ops = n * sum(o for _b, o in need) / len(need)
    least, _bound = roofline.least_seconds(nbytes, ops)
    return least / dev_s * 100.0
