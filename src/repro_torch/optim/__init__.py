from repro_torch.optim.lr import constant, cosine, smith_lr_range_test, warmup_cosine
from repro_torch.optim.optimizers import (
    Optimizer,
    adafactor_like,
    adam,
    momentum_sgd,
    sgd,
)

__all__ = ["Optimizer", "sgd", "momentum_sgd", "adam", "adafactor_like",
           "constant", "cosine", "warmup_cosine", "smith_lr_range_test"]
