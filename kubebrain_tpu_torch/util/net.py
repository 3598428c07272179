"""Node identity helpers.

Reference: pkg/util/net.go:86-138 (GetHost — pick the node identity IP,
preferring private IPv4) and env.go (KUBE_DEBUG switches). The identity
string "host:peerPort" names this replica in the election record and the
revision-sync URL.
"""

from __future__ import annotations

import os
import socket


def get_host() -> str:
    if os.environ.get("KB_HOST"):
        return os.environ["KB_HOST"]
    try:
        # route probe: no packets sent, just picks the egress interface
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect(("10.254.254.254", 1))
            return s.getsockname()[0]
        finally:
            s.close()
    except OSError:
        return "127.0.0.1"
