"""Training-side tools of the port. Only the drift monitor is ported so
far; the train step, its state and the optimizers are ROADMAP A12b."""

from repro_torch.train.monitor import ActivationMonitor

__all__ = ["ActivationMonitor"]
