"""Paged speculative decoding: spec rows behind the one front door.

Counterpart of `cake_tpu/spec/`: speculative decoding as a row kind of
the paged serving engine. Draft and target KV both live in paged pools
addressed by the engine's one page allocator; a stream's gamma-token
speculative suffix occupies pages that acceptance truncates back to the
allocator after every round; the acceptance EMA closes the loop through
the gamma tuner (autotune/spec.py), degrading a collapsing stream to
plain decode with typed spec_round/spec_degraded events and cake_spec_*
metrics.

Layout:
  accept.py: the accept/resample arithmetic and the rows' draws from
             the engine's counter-based streams;
  round.py:  spec_round_paged, the batched draft+verify round over
             paged KV (eager; serve/graphs.SpecRunner captures it);
  state.py:  SpecState, SpecPlane and the cake_spec_* families.
"""

from cake_tpu_torch.spec.accept import (
    assemble_sampled, greedy_accept, rejection_accept, round_draws,
)
from cake_tpu_torch.spec.round import spec_round_paged
from cake_tpu_torch.spec.state import (
    SPEC_DEGRADED, SPEC_ROUNDS, SpecPlane, SpecState,
)

__all__ = [
    "assemble_sampled", "greedy_accept", "rejection_accept", "round_draws",
    "spec_round_paged", "SpecPlane", "SpecState", "SPEC_DEGRADED",
    "SPEC_ROUNDS",
]
