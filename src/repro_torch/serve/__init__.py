"""The serving front end: `MatchServer` answers many queries over one
shared sample stream (port of `repro.serve`; the supervisor and the
LM-style `ServeEngine` are not ported)."""

from repro_torch.serve.fastmatch_server import MatchQuery, MatchServer

__all__ = ["MatchQuery", "MatchServer"]
