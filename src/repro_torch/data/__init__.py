"""Data pipelines of the port (numpy, as the reference's): least-squares
data layout (paper §V) and LM token streams."""

from .lm import TokenStream, agent_token_streams, make_lm_batch
from .lsq import ecn_batch_indices, partition_for_code

__all__ = [
    "TokenStream",
    "agent_token_streams",
    "make_lm_batch",
    "ecn_batch_indices",
    "partition_for_code",
]
