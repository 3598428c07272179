"""Endpoint layer (reference pkg/endpoint)."""

from .endpoint import Endpoint, EndpointConfig

__all__ = ["Endpoint", "EndpointConfig"]
