"""Sparse mixture-of-experts (Mixtral-style) model family.

Counterpart of `cake_tpu/models/moe/`: the family reuses the whole Llama
stack (attention, KV cache, RoPE, generator, every engine flavor),
because a block is a dict of leaves: MoE blocks carry `router` / `we_*`
leaves and `block_skeleton` dispatches on their presence
(models/llama/model.py). The expert math lives in ops/moe.py. Expert
parallelism is ported too: `params.param_specs` shards the experts over
an "ep" mesh axis and `params.load_params_sharded` streams each shard's
slice from the checkpoint.
"""

from cake_tpu_torch.models.moe.config import MoEConfig
from cake_tpu_torch.models.moe.params import init_params

__all__ = ["MoEConfig", "init_params"]
