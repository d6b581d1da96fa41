"""Block I/O for the sampling engine (paper Fig. 5 "I/O manager")."""

from repro_torch.io.block_source import InMemorySource, WindowData, as_block_source

__all__ = ["InMemorySource", "WindowData", "as_block_source"]
