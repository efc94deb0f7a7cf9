"""Training -- counterpart of `repro.train`: the losses (with the
condensation-core logdet aux) and the train step."""
from repro_torch.train.loss import (chunked_cross_entropy, cross_entropy,
                                    logdet_decorrelation)
from repro_torch.train.step import (TrainConfig, init_train_state,
                                    make_grad_fn, make_loss_fn,
                                    make_train_step)

__all__ = ["TrainConfig", "make_train_step", "make_grad_fn",
           "init_train_state", "make_loss_fn", "cross_entropy",
           "chunked_cross_entropy", "logdet_decorrelation"]
