"""repro_torch.train — the LM's training step (the port of ``repro.train``):
``optimizer`` (AdamW with global-norm clipping, applied in place) and
``train_step`` (loss → gradients → update, data-parallel over the host
mesh's data axis when it has several shards) and ``grad_compression``
(the reference's int8 error-feedback gradient reduction over that axis
and its data-parallel step).
"""
from .optimizer import (  # noqa: F401
    AdamWConfig,
    abstract_opt_state,
    adamw_update,
    global_norm,
    init_opt_state,
    lr_schedule,
)
from .grad_compression import (  # noqa: F401
    init_residuals,
    make_compressed_train_step,
    tree_compress_psum,
)
from .train_step import (  # noqa: F401
    loss_and_grads,
    make_loss_fn,
    make_train_step,
    opt_state_shardings,
    shard_params,
    train_step,
    unshard_params,
)
