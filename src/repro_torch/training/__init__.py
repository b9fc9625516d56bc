"""Training for the port, counterpart of ``repro.training``: AdamW, train
steps, SHRINK gradient compression, checkpoints, fault tolerance and the
compressed metrics logger."""
from .optimizer import AdamWConfig, adamw_init, adamw_update  # noqa: F401
from .train_step import (  # noqa: F401
    make_compressed_train_step,
    make_decode_step,
    make_ef_state,
    make_prefill_step,
    make_train_step,
)
from .grad_compress import GradCompressConfig, compression_wire_bytes  # noqa: F401
from .checkpoint import CheckpointManager, load_checkpoint, save_checkpoint  # noqa: F401
from .fault_tolerance import ShardScheduler, TrainingRunner  # noqa: F401
from .metrics import MetricsLogger  # noqa: F401
