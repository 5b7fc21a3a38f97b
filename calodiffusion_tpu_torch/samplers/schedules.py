"""Noise-schedule tables.

All tables are tiny (O(num_steps)) and static per configuration, so they are
computed host-side in numpy once and handed to the sampler/loss as
constants.  A copy of ``calodiffusion_tpu/samplers/schedules.py``.

Reference math: calodiffusion/utils/sampling.py:16-24 (cosine beta schedule),
:31-41 (ancestral step), :44-71 (Karras/Lu/VP grids), :77-89 (LMS
coefficients via quadrature).
"""

from __future__ import annotations

import numpy as np
from scipy import integrate


def cosine_beta_schedule(nsteps: int, s: float = 0.008) -> np.ndarray:
    x = np.linspace(0, nsteps, nsteps + 1, dtype=np.float64)
    alphas_cumprod = np.cos(((x / nsteps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0.0001, 0.9999).astype(np.float32)


def ddpm_tables(nsteps: int) -> dict[str, np.ndarray]:
    """alpha-bar tables for the discrete cosine schedule."""
    betas = cosine_beta_schedule(nsteps).astype(np.float64)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.concatenate([[1.0], alphas_cumprod[:-1]])
    return {
        "betas": betas.astype(np.float32),
        "alphas_cumprod": alphas_cumprod.astype(np.float32),
        "alphas_cumprod_prev": alphas_cumprod_prev.astype(np.float32),
        "sqrt_alphas_cumprod": np.sqrt(alphas_cumprod).astype(np.float32),
        "sqrt_one_minus_alphas_cumprod": np.sqrt(1.0 - alphas_cumprod).astype(
            np.float32
        ),
        "posterior_variance": (
            betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
        ).astype(np.float32),
    }


def discrete_sigmas(nsteps: int) -> np.ndarray:
    """sigma(t) = sqrt(1-abar)/sqrt(abar) for the cosine schedule, decreasing
    in sampling order (reference sample.py:146-153 create_sigmas)."""
    t = ddpm_tables(nsteps)
    idx = nsteps - 1 - np.arange(nsteps)
    return (
        t["sqrt_one_minus_alphas_cumprod"][idx] / t["sqrt_alphas_cumprod"][idx]
    ).astype(np.float32)


def get_ancestral_step(sigma_from, sigma_to, eta=1.0):
    """sigma_down / sigma_up for an ancestral step (scalar, host-side)."""
    if not eta:
        return sigma_to, 0.0
    sigma_up = min(
        sigma_to,
        eta * (sigma_to**2 * (sigma_from**2 - sigma_to**2) / sigma_from**2) ** 0.5,
    )
    sigma_down = (sigma_to**2 - sigma_up**2) ** 0.5
    return sigma_down, sigma_up


def karras_steps(num_step: int, min_t: float, max_t: float, rho: float = 7) -> np.ndarray:
    idx = np.arange(num_step, dtype=np.float64)
    t = (
        max_t ** (1 / rho)
        + idx / (num_step - 1) * (min_t ** (1 / rho) - max_t ** (1 / rho))
    ) ** rho
    return t.astype(np.float32)


def lu_steps(num_step: int, min_t: float, max_t: float, rho: float = 1) -> np.ndarray:
    idx = np.arange(num_step, dtype=np.float64)
    lmin, lmax = np.log(min_t), np.log(max_t)
    t = (lmax ** (1 / rho) + idx / (num_step - 1) * (lmin ** (1 / rho) - lmax ** (1 / rho))) ** rho
    return t.astype(np.float32)


def vp_steps(num_step: int, eps_s=1e-3, beta_d=19.9, beta_min=0.1) -> np.ndarray:
    t1 = np.linspace(1, eps_s, num_step, dtype=np.float64)
    return np.sqrt(np.exp(beta_d * t1**2 / 2 + beta_min * t1) - 1).astype(np.float32)


def iddpm_orig_steps(
    num_steps: int, sigma_min: float, sigma_max: float,
    C_1: float = 0.001, C_2: float = 0.0008,
) -> np.ndarray:
    """Original iDDPM sigma grid (reference sample.py:687-701)."""
    M = num_steps
    u = np.zeros(M + 1, dtype=np.float64)

    def alpha_bar(j):
        return np.sin(0.5 * np.pi * j / M / (C_2 + 1)) ** 2

    for j in range(M, 0, -1):
        u[j - 1] = np.sqrt(
            (u[j] ** 2 + 1) / max(alpha_bar(j - 1) / alpha_bar(j), C_1) - 1
        )
    u_filtered = u[(u >= sigma_min) & (u <= sigma_max)]
    step_indices = np.arange(num_steps, dtype=np.float64)
    sel = np.round((len(u_filtered) - 1) / (num_steps - 1) * step_indices).astype(int)
    return u_filtered[sel].astype(np.float32)


def linear_multistep_coeff(order: int, t: np.ndarray, i: int, j: int) -> float:
    if order - 1 > i:
        raise ValueError(f"Order {order} too high for step {i}")

    def fn(tau):
        prod = 1.0
        for k in range(order):
            if j == k:
                continue
            prod *= (tau - t[i - k]) / (t[i - j] - t[i - k])
        return prod

    return integrate.quad(fn, t[i], t[i + 1], epsrel=1e-4)[0]
