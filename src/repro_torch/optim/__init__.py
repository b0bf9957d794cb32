"""The optimizer of the port: the reference's ``optim/`` (AdamW, the
cosine schedule, int8 error-feedback compression) over a mapping of
name to tensor (``optim.params``)."""
from .adamw import adamw_init, adamw_update, clip_by_global_norm  # noqa: F401
from .schedule import cosine_with_warmup  # noqa: F401
from .compression import (  # noqa: F401
    compress_int8,
    decompress_int8,
    error_feedback_allreduce,
)
