"""Training side of the port (`repro.train`): the train state, the train
and eval steps, and the activation drift monitor."""

from repro_torch.train.monitor import ActivationMonitor
from repro_torch.train.step import cross_entropy_loss, make_eval_step, make_train_step
from repro_torch.train.train_state import TrainState

__all__ = [
    "ActivationMonitor", "TrainState", "cross_entropy_loss", "make_eval_step", "make_train_step",
]
