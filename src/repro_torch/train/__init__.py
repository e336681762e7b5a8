from repro_torch.train.optimizer import AdamWState, adamw_init, adamw_update
from repro_torch.train.data import SyntheticLM
from repro_torch.train.trainer import Trainer, TrainState

__all__ = ["AdamWState", "adamw_init", "adamw_update", "SyntheticLM",
           "Trainer", "TrainState"]
