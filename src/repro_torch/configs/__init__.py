"""Model configurations of the port, by arch name (``registry.get_arch``)."""
from .registry import ARCHS, get_arch  # noqa: F401
