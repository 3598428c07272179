"""Debug env switches (reference pkg/util/env.go: KUBE_DEBUG modes).

``KB_DEBUG`` is a comma-separated flag list:

- ``txn``      — log every failed/errored transaction (reference txnLog,
                 pkg/backend/util.go:90-110 logs failures always, everything
                 at -v>=10);
- ``verbose``  — log every transaction.

``KB_HOST`` overrides node-identity autodetection (util/net.py).
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger("kubebrain")


def debug_flags() -> set[str]:
    return {f.strip() for f in os.environ.get("KB_DEBUG", "").split(",") if f.strip()}


def txn_log_enabled() -> bool:
    return "txn" in debug_flags() or "verbose" in debug_flags()


def verbose() -> bool:
    return "verbose" in debug_flags()


def txn_log(verb: str, key: bytes, revision: int, err: BaseException | None) -> None:
    """Transaction outcome logging: failures when ``txn`` is set, everything
    when ``verbose`` is set."""
    if err is not None:
        if txn_log_enabled():
            logger.warning("txn %s key=%r rev=%d failed: %s", verb, key, revision, err)
    elif verbose():
        logger.info("txn %s key=%r rev=%d ok", verb, key, revision)


def crash_guard(fn):
    """Daemon-loop wrapper: an unhandled exception in a critical loop (the
    sequencer, a campaign) must crash the process loudly rather than leave a
    silently-stalled pipeline — the reference's util.Recover prints the stack
    and os.Exit(2)s on goroutine panic (pkg/util/util.go:24-31)."""
    import functools
    import traceback

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception:
            traceback.print_exc()
            logger.critical("critical loop %s crashed; exiting", fn.__name__)
            os._exit(2)

    return wrapped
