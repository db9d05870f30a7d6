"""Parallelism over ``torch.distributed``: the mesh and batch sharding,
the sequence- and channel-sharded scans and the GPipe pipeline of the
Mamba LM's block stack (port of ``mamba_unet_tpu/parallel``), on the
differentiable collectives of ``parallel/comm.py``."""

from mamba_unet_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    make_mesh,
    replicated,
    shard_batch,
)
from mamba_unet_torch.parallel.pipeline import (
    pipeline_blocks,
    pipeline_lm_apply,
    pipeline_lm_loss,
    prestack_lm_params,
    stack_layer_params,
)
from mamba_unet_torch.parallel.seq_scan import (
    current_sequence_sharding,
    selective_scan_seq_sharded,
    sequence_sharding,
)
from mamba_unet_torch.parallel.tp_scan import (
    channel_sharding,
    current_channel_sharding,
    selective_scan_tp_sharded,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "batch_sharding",
    "replicated",
    "shard_batch",
    "selective_scan_seq_sharded",
    "sequence_sharding",
    "current_sequence_sharding",
    "selective_scan_tp_sharded",
    "channel_sharding",
    "current_channel_sharding",
    "pipeline_blocks",
    "pipeline_lm_apply",
    "pipeline_lm_loss",
    "prestack_lm_params",
    "stack_layer_params",
]
