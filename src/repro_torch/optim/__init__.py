"""The port's optimiser library: the paper's Table-I optimisers and the
learning-rate schedules, with the reference's arithmetic and defaults."""
from repro_torch.optim.optimizers import (SGD, Adagrad, Adam, AdamW,
                                          Optimizer, RMSprop, adagrad, adam,
                                          adamw, get_optimizer, rmsprop, sgd)
from repro_torch.optim.schedules import constant, cosine_decay, warmup_cosine

__all__ = [
    "Adagrad",
    "Adam",
    "AdamW",
    "Optimizer",
    "RMSprop",
    "SGD",
    "adagrad",
    "adam",
    "adamw",
    "get_optimizer",
    "rmsprop",
    "sgd",
    "constant",
    "cosine_decay",
    "warmup_cosine",
]
