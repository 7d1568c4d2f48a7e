from repro_torch.optim.lr import constant
from repro_torch.optim.optimizers import Optimizer, momentum_sgd, sgd

__all__ = ["Optimizer", "sgd", "momentum_sgd", "constant"]
