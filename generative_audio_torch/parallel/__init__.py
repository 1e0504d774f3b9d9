"""The multi-GPU runtime: the device mesh, the batch's placement over the
ranks and the multi-process job (generative_audio_tpu/parallel/__init__.py
exports the same names)."""
from generative_audio_torch.parallel.mesh import (  # noqa: F401
    make_mesh, data_sharding, replicated, shard_batch, subband_sharding,
    place_batch, replicate_state,
)
from generative_audio_torch.parallel import distributed  # noqa: F401
