"""Training/serving runtimes of the port: ``PlainRuntime`` (Adam on one
device) and ``ConsensusRuntime`` (the paper's csI-ADMM over A agents, in
one process, on one device or with the agent axis across ``devices``)."""

from .consensus import ConsensusConfig, ConsensusRuntime
from .plain import PlainRuntime

__all__ = ["ConsensusConfig", "ConsensusRuntime", "PlainRuntime"]
