"""Training substrate: the step factory + the fault-tolerant trainer loop
(port of ``repro.train``)."""
from repro_torch.train.step import TrainState, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["TrainState", "make_train_step", "Trainer", "TrainerConfig"]
