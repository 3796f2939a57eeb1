"""Training/serving runtimes of the port. Only the plain (non-consensus)
runtime is ported; ``ConsensusRuntime`` is ROADMAP Queue 1, item 15."""

from .plain import PlainRuntime

__all__ = ["PlainRuntime"]
