"""Diffusion noise schedulers: DDIM and Euler-discrete.

Counterpart of `cake_tpu/models/sd/scheduler.py` (`SchedulerConfig`,
`Schedule.create`, `scale_model_input`, `step`, `add_noise`): the
schedule is host-side numpy (f64 alphas, descending timesteps), and each
update is a few torch ops on the latents' device with host floats as
coefficients, as JAX runs them on its arrays. Beta schedule:
scaled-linear (sqrt-space linear), the SD default; epsilon and
v-prediction parameterisations (v2.1-768 uses v).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    prediction_type: str = "epsilon"   # or "v_prediction"
    kind: str = "ddim"                 # or "euler"


def _alphas_cumprod(cfg: SchedulerConfig) -> np.ndarray:
    betas = np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5,
                        cfg.num_train_timesteps, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


@dataclass(frozen=True)
class Schedule:
    """Precomputed per-inference-step state (host-side, static)."""

    config: SchedulerConfig
    timesteps: np.ndarray        # [steps] int32, descending
    alphas_cumprod: np.ndarray   # [train_timesteps] f64
    sigmas: np.ndarray           # [steps+1] (euler only; zeros for ddim)
    init_noise_sigma: float

    @classmethod
    def create(cls, cfg: SchedulerConfig, num_steps: int) -> "Schedule":
        ac = _alphas_cumprod(cfg)
        step = cfg.num_train_timesteps // num_steps
        ts = (np.arange(num_steps) * step).round()[::-1].astype(np.int32)
        if cfg.kind == "euler":
            sig = np.sqrt((1 - ac[ts]) / ac[ts])
            sigmas = np.concatenate([sig, [0.0]])
            init_sigma = float(sig.max())
        else:
            sigmas = np.zeros(num_steps + 1)
            init_sigma = 1.0
        return cls(cfg, ts, ac, sigmas, init_sigma)

    # -- the scheduler's API ------------------------------------------------

    def scale_model_input(self, latents, step_idx: int):
        """Euler scales by 1/sqrt(sigma^2+1); DDIM is identity."""
        if self.config.kind == "euler":
            sigma = self.sigmas[step_idx]
            return latents / float(np.sqrt(sigma ** 2 + 1.0))
        return latents

    def step(self, model_out, step_idx: int, latents):
        """One denoise update over tensors; returns the new latents."""
        t = int(self.timesteps[step_idx])
        if self.config.kind == "euler":
            return self._euler_step(model_out, step_idx, latents)
        return self._ddim_step(model_out, t, step_idx, latents)

    def _pred_x0_eps(self, model_out, latents, a_t):
        """(x0, eps) from the model output under the parameterisation."""
        sqrt_a = float(np.sqrt(a_t))
        sqrt_1ma = float(np.sqrt(1.0 - a_t))
        if self.config.prediction_type == "v_prediction":
            x0 = sqrt_a * latents - sqrt_1ma * model_out
            eps = sqrt_a * model_out + sqrt_1ma * latents
        else:
            x0 = (latents - sqrt_1ma * model_out) / sqrt_a
            eps = model_out
        return x0, eps

    def _ddim_step(self, model_out, t, step_idx, latents):
        a_t = self.alphas_cumprod[t]
        prev_i = step_idx + 1
        if prev_i < len(self.timesteps):
            a_prev = self.alphas_cumprod[int(self.timesteps[prev_i])]
        else:
            a_prev = 1.0
        x0, eps = self._pred_x0_eps(model_out, latents, a_t)
        dir_xt = float(np.sqrt(1.0 - a_prev)) * eps
        return float(np.sqrt(a_prev)) * x0 + dir_xt

    def _euler_step(self, model_out, step_idx, latents):
        sigma = float(self.sigmas[step_idx])
        sigma_next = float(self.sigmas[step_idx + 1])
        # latents here live in sigma-space (x = x0 + sigma*eps)
        if self.config.prediction_type == "v_prediction":
            denom = sigma ** 2 + 1.0
            x0 = latents / denom - model_out * sigma / float(np.sqrt(denom))
        else:
            x0 = latents - sigma * model_out
        d = (latents - x0) / sigma
        return latents + d * (sigma_next - sigma)

    def add_noise(self, x0, noise, step_idx: int):
        """Noise clean latents to the given step (img2img's entry).
        step_idx == num_steps means strength ~ 0:
        no denoising steps remain, so the latents stay clean."""
        if step_idx >= len(self.timesteps):
            return x0
        if self.config.kind == "euler":
            sigma = float(self.sigmas[step_idx])
            return x0 + noise * sigma
        t = int(self.timesteps[step_idx])
        a = self.alphas_cumprod[t]
        return float(np.sqrt(a)) * x0 + float(np.sqrt(1 - a)) * noise
