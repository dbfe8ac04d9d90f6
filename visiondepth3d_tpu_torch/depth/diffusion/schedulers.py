"""Diffusion schedulers: DDIM (Marigold) and Euler-discrete with the EDM
preconditioning (DepthCrafter / SVD).

Counterpart of ``visiondepth3d_tpu/depth/diffusion/schedulers.py``: the
timesteps and sigmas are numpy, computed once per schedule; ``step`` takes
and returns tensors (any device, any float type: the coefficients are
Python floats).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def betas_scaled_linear(n: int = 1000, beta_start: float = 0.00085,
                        beta_end: float = 0.012) -> np.ndarray:
    """The SD family's 'scaled_linear' beta schedule."""
    return np.linspace(beta_start ** 0.5, beta_end ** 0.5, n, dtype=np.float64) ** 2


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    """Deterministic DDIM (eta 0) over trailing-spaced steps."""

    num_train_timesteps: int = 1000
    num_inference_steps: int = 4
    prediction_type: str = "v_prediction"  # Marigold v1-0

    def __post_init__(self):
        alphas_cumprod = np.cumprod(1.0 - betas_scaled_linear(self.num_train_timesteps))
        object.__setattr__(self, "alphas_cumprod", alphas_cumprod)
        # diffusers' timestep_spacing='trailing'
        step = self.num_train_timesteps / self.num_inference_steps
        ts = np.round(np.arange(self.num_train_timesteps, 0, -step)).astype(int) - 1
        object.__setattr__(self, "timesteps", ts)

    def alpha_bar(self, t: int) -> float:
        return float(self.alphas_cumprod[t]) if t >= 0 else 1.0

    def step(self, model_out, t_index: int, sample):
        """One DDIM update; ``t_index`` indexes ``timesteps``."""
        t = int(self.timesteps[t_index])
        prev_t = (int(self.timesteps[t_index + 1]) if t_index + 1 < len(self.timesteps)
                  else -1)
        a_t, a_prev = self.alpha_bar(t), self.alpha_bar(prev_t)
        sqrt_at, sqrt_1mat = a_t ** 0.5, (1 - a_t) ** 0.5
        if self.prediction_type == "epsilon":
            x0 = (sample - sqrt_1mat * model_out) / sqrt_at
            eps = model_out
        else:  # v_prediction
            x0 = sqrt_at * sample - sqrt_1mat * model_out
            eps = sqrt_at * model_out + sqrt_1mat * sample
        return (a_prev ** 0.5) * x0 + ((1 - a_prev) ** 0.5) * eps

    def add_noise(self, x0, noise, t: int):
        a = self.alpha_bar(int(t))
        return (a ** 0.5) * x0 + ((1 - a) ** 0.5) * noise


@dataclasses.dataclass(frozen=True)
class EulerSchedule:
    """Euler-discrete with Karras sigmas (the SVD family)."""

    num_train_timesteps: int = 1000
    num_inference_steps: int = 2
    sigma_min_max: tuple = (0.002, 700.0)
    rho: float = 7.0

    def __post_init__(self):
        smin, smax = self.sigma_min_max
        ramp = np.linspace(0, 1, self.num_inference_steps, dtype=np.float64)
        inv_rho = 1.0 / self.rho
        sigmas = (smax ** inv_rho + ramp * (smin ** inv_rho - smax ** inv_rho)) ** self.rho
        object.__setattr__(self, "sigmas", np.append(sigmas, 0.0))

    def scale_input(self, sample, i: int):
        return sample / ((float(self.sigmas[i]) ** 2 + 1) ** 0.5)

    def init_noise_sigma(self) -> float:
        return float((self.sigmas[0] ** 2 + 1) ** 0.5)

    def step(self, model_out, i: int, sample):
        """An Euler step; ``model_out`` is the denoised x0 estimate (the UNet
        wrapper applies the preconditioning)."""
        s, s_next = float(self.sigmas[i]), float(self.sigmas[i + 1])
        return sample + (sample - model_out) / s * (s_next - s)


def svd_precondition(sigma: float) -> tuple[float, float, float]:
    """EDM preconditioning (c_skip, c_out, c_in): x0 = c_skip x + c_out F(c_in x)."""
    c_skip = 1.0 / (sigma ** 2 + 1.0)
    c_out = -sigma / (sigma ** 2 + 1.0) ** 0.5
    c_in = 1.0 / (sigma ** 2 + 1.0) ** 0.5
    return c_skip, c_out, c_in
