"""Online autotuner: joint config search and live hot-switching.

Counterpart of `cake_tpu/autotune/`, exporting what it exports:

  * ``space``      — the declarative ``EngineConfig`` point, its
                     validity rules (reusing args.py validation) and the
                     switch-legality guard;
  * ``search``     — the offline fitter: step-log or JSON measurements
                     -> a piecewise ``PolicyTable`` (offered-load regime
                     -> best config), written to the ``--autotune-policy``
                     file by ``python -m cake_tpu_torch.tools.autotune_fit``;
  * ``controller`` — the online loop: sliding-window signals with
                     hysteresis, cooldown and a one-shot rollback guard,
                     driving ``engine.reconfigure()`` between iterations;
  * ``spec``       — the speculative gamma tuner.

The hot-switch seam itself lives in serve/engine.py
(``InferenceEngine.reconfigure``): in-flight requests fold their
generated tokens into their prompts (the recovery resubmit minus backoff
and crash implication), the pool and its captured CUDA graphs are
dropped and rebuilt under the new config, and everything requeues with
seniority, class and preempt budget preserved — greedy streams complete
token-identical at f32 KV across a switch.
"""

from cake_tpu_torch.autotune.controller import (  # noqa: F401
    CONFIG_INFO, ROLLBACKS, SWITCH_SECONDS, SWITCHES, AutotuneController,
    AutotuneSignals, ControllerConfig, set_config_info,
)
from cake_tpu_torch.autotune.search import (  # noqa: F401
    Observation, PolicyTable, extract_observations, fit,
    observations_from_step_log,
)
from cake_tpu_torch.autotune.space import (  # noqa: F401
    EngineConfig, config_key, switch_guard, validate_config,
)
from cake_tpu_torch.autotune.spec import (  # noqa: F401
    SpecGammaTuner, SpecTunerConfig,
)
