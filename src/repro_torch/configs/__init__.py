"""Architecture configs and input shapes (port of `repro.configs`).

Each ``<arch>.py`` exposes ``CONFIG`` (the assigned hyper-parameters, with
source citation) and ``SMOKE`` (a reduced same-family variant for CPU
tests). Only the archs whose families are ported are registered; the
rest raise ``KeyError`` naming the ROADMAP queue that holds them.
"""

from .registry import ARCHS, SHAPES, get_config, get_smoke_config

__all__ = ["ARCHS", "SHAPES", "get_config", "get_smoke_config"]
