"""The serving front end: `MatchServer` answers many queries over one
shared sample stream, and `ServeSupervisor` keeps it serving through
deadlines, overload and crashes (port of `repro.serve`; the LM-style
`ServeEngine` is not ported, ROADMAP A12)."""

from repro_torch.serve.fastmatch_server import MatchQuery, MatchServer
from repro_torch.serve.supervisor import ServeSupervisor, SupervisorPolicy

__all__ = ["MatchQuery", "MatchServer", "ServeSupervisor", "SupervisorPolicy"]
