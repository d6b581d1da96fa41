"""HistSim statistics and the FastMatch scheduling loop, in PyTorch."""
