"""Native "brain" protocol server (reference pkg/server/brain)."""

from .server import BrainServer, make_brain_handlers

__all__ = ["BrainServer", "make_brain_handlers"]
