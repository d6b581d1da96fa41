"""The serving front ends: `MatchServer` answers many queries over one
shared sample stream, `ServeSupervisor` keeps it serving through
deadlines, overload and crashes, and `ServeEngine` serves an LM's
requests in batches of prefill and greedy decode (port of
`repro.serve`)."""

from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.fastmatch_server import MatchQuery, MatchServer
from repro_torch.serve.supervisor import ServeSupervisor, SupervisorPolicy

__all__ = [
    "MatchQuery", "MatchServer", "Request", "ServeEngine", "ServeSupervisor", "SupervisorPolicy",
]
