"""Block I/O for the sampling engine (paper Fig. 5 "I/O manager").

Port of `repro.io`: where window data comes from, behind the
`BlockSource` protocol, so the scheduler does not depend on it.

  InMemorySource  — the whole blocked dataset, resident on the device (a
                    fetch is a device gather) or in host memory
  PrefetchSource  — a worker thread fetches the next window while the
                    current round runs
  ResilientSource — retry and backoff, integrity validation and block
                    quarantine at the source boundary (`io.faults`;
                    `FaultySource` is the seeded chaos wrapper)

The data-parallel `ShardedSource` waits for ROADMAP A9.
"""

from repro_torch.io.block_source import BlockSource, InMemorySource, WindowData, as_block_source
from repro_torch.io.faults import (
    FaultInjector,
    FaultPlan,
    FaultySource,
    ResilientSource,
    RetryPolicy,
    WindowQuarantined,
    maybe_chaos,
    validate_window,
)
from repro_torch.io.prefetch import PrefetchSource

__all__ = [
    "BlockSource",
    "FaultInjector",
    "FaultPlan",
    "FaultySource",
    "InMemorySource",
    "PrefetchSource",
    "ResilientSource",
    "RetryPolicy",
    "WindowData",
    "WindowQuarantined",
    "as_block_source",
    "maybe_chaos",
    "validate_window",
]
