"""Host-native (C++) crypto engine bindings. See engine.py."""

from .engine import available, build  # noqa: F401
