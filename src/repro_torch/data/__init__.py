"""Data pipelines of the port (numpy, as the reference's)."""

from .lm import TokenStream, agent_token_streams, make_lm_batch

__all__ = ["TokenStream", "agent_token_streams", "make_lm_batch"]
