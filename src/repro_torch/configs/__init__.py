"""Architecture configs and input shapes (port of `repro.configs`).

Each ``<arch>.py`` exposes ``CONFIG`` (the assigned hyper-parameters, with
source citation) and ``SMOKE`` (a reduced same-family variant for CPU
tests). ``ARCHS`` holds every arch of the reference, ``PORT_ARCHS`` the
port's own (granite-4.0-h-micro); an unknown arch raises ``KeyError``.
"""

from .registry import ARCHS, PORT_ARCHS, SHAPES, get_config, get_smoke_config

__all__ = ["ARCHS", "PORT_ARCHS", "SHAPES", "get_config", "get_smoke_config"]
