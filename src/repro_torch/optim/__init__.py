from repro_torch.optim.optimizers import sgd, adamw, Optimizer
from repro_torch.optim.schedules import constant, round_decay, cosine_warmup
