"""Training/serving runtimes of the port: ``PlainRuntime`` (Adam on one
device) and ``ConsensusRuntime`` (the paper's csI-ADMM over A agents, in
one process; the agent axis across devices is ROADMAP Queue 1, item 15)."""

from .consensus import ConsensusConfig, ConsensusRuntime
from .plain import PlainRuntime

__all__ = ["ConsensusConfig", "ConsensusRuntime", "PlainRuntime"]
