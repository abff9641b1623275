"""repro_torch.train — the LM's training step (the port of ``repro.train``):
``optimizer`` (AdamW with global-norm clipping, applied in place) and
``train_step`` (loss → gradients → update on the one-device host mesh).
The reference's int8 error-feedback gradient reduction
(``grad_compression``) runs over a data axis of several devices and
comes with the multi-card layouts (ROADMAP A12d).
"""
from .optimizer import (  # noqa: F401
    AdamWConfig,
    abstract_opt_state,
    adamw_update,
    global_norm,
    init_opt_state,
    lr_schedule,
)
from .train_step import loss_and_grads, make_loss_fn, make_train_step, train_step  # noqa: F401
