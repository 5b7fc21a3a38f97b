"""EDM-family samplers: Karras sigma ladder + churn (arXiv:2206.00364),
plus LMS and Restart (arXiv:2306.14878).

Port of ``calodiffusion_tpu/samplers/edm.py`` (reference semantics:
calodiffusion/models/sample.py:577-954).  Per-step scalars (t_hat, churn
scale, LMS quadrature weights) are host-side tables; where the JAX sampler
holds a table as f32 rows, so does this one.  The last step of Heun and
DPM2 is a plain Euler step (the reference's corrector divides by
t_next = 0 there), Heun takes its slope at the Euler-stepped point, and
Restart follows the reference's working legacy form with tied restart
indices all applied in order (PARITY.md deviations 1, 2, 2b, 2c).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from calodiffusion_tpu_torch.samplers import schedules
from calodiffusion_tpu_torch.samplers.base import Sample, sigma_like


class EDMBase(Sample):
    def __init__(self, config):
        super().__init__(config)
        noisy = self.config.get("NOISY_SAMPLE", False)
        self.S_churn = 40 if noisy else 0
        self.S_min = self.sample_config.get("S_MIN", 0.01)
        self.S_max = 50 if noisy else 1
        self.S_noise = self.sample_config.get("S_NOISE", 1.003)
        self.sigma_min = self.sample_config.get("SIGMA_MIN", 0.002)
        self.sigma_max = self.sample_config.get("SIGMA_MAX", 80.0)
        self.orig_schedule = self.sample_config.get("ORG_SCHEDULE", False)
        self.rho = self.sample_config.get("RHO", 7)
        self.order = self.sample_config.get("ORDER", 4)
        self.restart_gamma = self.sample_config.get("RESTART_GAMMA", 0.05)
        self.C_2 = self.sample_config.get("C2", 0.0008)
        self.C_1 = self.sample_config.get("C1", 0.001)

    def t_steps(self, num_steps: int, sample_offset: int) -> np.ndarray:
        t = schedules.karras_steps(
            num_steps, self.sigma_min, self.sigma_max, self.rho
        ).astype(np.float64)
        t = np.concatenate([t, [0.0]])
        t = t[sample_offset:]
        if self.orig_schedule:
            t = schedules.iddpm_orig_steps(
                num_steps, self.sigma_min, self.sigma_max, self.C_1, self.C_2
            ).astype(np.float64)
        return t

    def churn_rows(self, t_steps: np.ndarray, num_steps: int):
        """Per-step (t_cur, t_hat, t_next, churn_scale) host-side table."""
        rows = []
        for t_cur, t_next in zip(t_steps[:-1], t_steps[1:]):
            gamma = (
                min(self.S_churn / num_steps, math.sqrt(2) - 1)
                if self.S_min <= t_cur <= self.S_max
                else 0.0
            )
            t_hat = t_cur + gamma * t_cur
            churn = math.sqrt(max(t_hat**2 - t_cur**2, 0.0)) * self.S_noise
            rows.append((t_cur, t_hat, t_next, churn))
        return rows

    @staticmethod
    def f32_rows(rows):
        """The (t_hat, t_next, churn) columns of ``rows`` as f32 scalars."""
        return [(np.float32(r[1]), np.float32(r[2]), np.float32(r[3])) for r in rows]

    def churned(self, x, churn, inj, i, generator):
        """x + churn * noise (row ``i`` of ``inj``, else a fresh normal).
        A zero churn leaves x as it is and draws nothing; an injected row
        was consumed all the same by ``take_noise``."""
        if not churn:
            return x
        return x + float(churn) * self.noise(inj, i, x.shape, generator, x.device)

    def euler_steps(self, denoise, x, rows, generator, trajectory=None):
        """Churned Euler steps over f32 ``rows``, one network call each;
        appends (x, x0) per step to ``trajectory`` when given."""
        inj = self.take_noise(len(rows), x.shape, x.device)
        for i, (t_hat, t_next, churn) in enumerate(self.f32_rows(rows)):
            x_hat = self.churned(x, churn, inj, i, generator)
            den = denoise(x_hat, sigma_like(x, t_hat))
            x = x_hat + float(t_next - t_hat) * ((x_hat - den) / float(t_hat))
            if trajectory is not None:
                trajectory.append((x, den))
        return x


def _debug_out(x, trajectory):
    xs, x0s = zip(*trajectory)
    return x, torch.stack(xs), torch.stack(x0s)


class Euler(EDMBase):
    """EDM 1st-order (reference sample.py:771-789)."""

    def __call__(
        self, model, start, energy, layers, num_steps, sample_offset,
        generator, debug=False,
    ):
        denoise = self.make_denoise_fn(model, energy, layers)
        ts = self.t_steps(num_steps, sample_offset)
        rows = self.churn_rows(ts, num_steps)
        trajectory = [] if debug else None
        x = self.euler_steps(denoise, start.float() * float(ts[0]), rows, generator,
                             trajectory)
        return _debug_out(x, trajectory) if debug else x


class _SecondOrderEDM(EDMBase):
    """Churn + first eval + subclass 2nd-order update on every step but the
    last (t_next == 0), which is a plain Euler step."""

    def second_order_update(self, denoise, x_hat, den, t_hat, t_next):
        raise NotImplementedError

    def __call__(
        self, model, start, energy, layers, num_steps, sample_offset,
        generator, debug=False,
    ):
        denoise = self.make_denoise_fn(model, energy, layers)
        ts = self.t_steps(num_steps, sample_offset)
        rows = self.churn_rows(ts, num_steps)
        dev = start.device
        x = start.float() * float(ts[0])

        main, last = rows[:-1], rows[-1]
        inj = self.take_noise(len(main), start.shape, dev)
        trajectory = []
        for i, (t_hat, t_next, churn) in enumerate(self.f32_rows(main)):
            x_hat = self.churned(x, churn, inj, i, generator)
            den = denoise(x_hat, sigma_like(x, t_hat))
            x = self.second_order_update(denoise, x_hat, den, t_hat, t_next)
            if debug:
                trajectory.append((x, den))

        # final step: Euler to t=0 (2nd-order corrector undefined there)
        _, t_hat, t_next, churn = last
        x_hat = self.churned(x, churn, self.take_noise(1, start.shape, dev), 0, generator)
        den = denoise(x_hat, sigma_like(x, t_hat))
        x = x_hat + (t_next - t_hat) * (x_hat - den) / t_hat
        if debug:
            # the trajectory's last frame IS the returned sample (the debug
            # plot keys on xs[-1])
            trajectory.append((x, den))
            return _debug_out(x, trajectory)
        return x


class Heun(_SecondOrderEDM):
    """EDM 2nd-order Heun (reference sample.py:792-821, corrected)."""

    def second_order_update(self, denoise, x_hat, den, t_hat, t_next):
        d_cur = (x_hat - den) / float(t_hat)
        h = float(t_next - t_hat)
        x_prime = x_hat + h * d_cur
        den2 = denoise(x_prime, sigma_like(x_prime, t_next))
        d_prime = (x_prime - den2) / float(t_next)
        return x_hat + h * (0.5 * d_cur + 0.5 * d_prime)


class DPM2(_SecondOrderEDM):
    """EDM 2nd-order midpoint (reference sample.py:824-850)."""

    def second_order_update(self, denoise, x_hat, den, t_hat, t_next):
        d_cur = (x_hat - den) / float(t_hat)
        h = float(t_next - t_hat)
        t_mid = np.exp(np.float32(0.5) * (np.log(t_hat) + np.log(t_next)))
        x_2 = x_hat + d_cur * float(t_mid - t_hat)
        den2 = denoise(x_2, sigma_like(x_2, t_mid))
        d_2 = (x_2 - den2) / float(t_mid)
        return x_hat + h * d_2


class LMS(EDMBase):
    """Linear multistep over the Karras grid (reference sample.py:729-768);
    quadrature coefficients from scipy, host-side, held in f32."""

    def __call__(
        self, model, start, energy, layers, num_steps, sample_offset,
        generator, debug=False,
    ):
        denoise = self.make_denoise_fn(model, energy, layers)
        ts = self.t_steps(num_steps, sample_offset)
        x = start.float() * float(ts[0])

        T = len(ts) - 1
        order = self.order
        coeffs = np.zeros((T, order), dtype=np.float64)
        for i in range(T):
            cur_order = min(i + 1, order)
            for j in range(cur_order):
                coeffs[i, j] = schedules.linear_multistep_coeff(cur_order, ts, i, j)
        coeffs = coeffs.astype(np.float32)
        t_rows = ts[:-1].astype(np.float32)

        slopes = []  # the last ``order`` slopes, newest first
        trajectory = []
        for i in range(T):
            den = denoise(x, sigma_like(x, t_rows[i]))
            slopes = [(x - den) / float(t_rows[i])] + slopes[:order - 1]
            upd = float(coeffs[i, 0]) * slopes[0]
            for j in range(1, len(slopes)):
                upd = upd + float(coeffs[i, j]) * slopes[j]
            x = x + upd
            if debug:
                trajectory.append((x, den))
        return _debug_out(x, trajectory) if debug else x


class Restart(EDMBase):
    """Restart sampling (reference sample.py:853-954, intended semantics)."""

    def __init__(self, config):
        super().__init__(config)
        default_restart = {
            "0": [4, 1, 19.35, 40.79],
            "1": [4, 1, 1.09, 1.92],
            "2": [4, 4, 0.59, 1.09],
            "3": [4, 1, 0.30, 0.59],
            "4": [4, 4, 0.06, 0.30],
        }
        self.restart_list = self.sample_config.get("RESTART_LIST", default_restart)

    def __call__(
        self, model, start, energy, layers, num_steps, sample_offset,
        generator, debug=False,
    ):
        denoise = self.make_denoise_fn(model, energy, layers)
        ts = self.t_steps(num_steps, sample_offset)
        rows = self.churn_rows(ts, num_steps)
        x = start.float() * float(ts[0])

        # each config's t_min cast to the nearest main-step index (the
        # legacy sampler, sampling.py:198-203); configs that map to the
        # same index are all kept and applied in order
        restart_at: dict[int, list] = {}
        for v in self.restart_list.values():
            idx = int(np.argmin(np.abs(ts - v[2])))
            restart_at.setdefault(idx, []).append(v)

        # the main Euler walk, split at the restart points
        seg_start = 0
        for i in range(len(rows)):
            if i + 1 in restart_at:
                x = self.euler_steps(denoise, x, rows[seg_start: i + 1], generator)
                for cfg in restart_at[i + 1]:
                    x = self._restart_block(denoise, ts, x, generator, i + 1, cfg)
                seg_start = i + 1
        x = self.euler_steps(denoise, x, rows[seg_start:], generator)
        if debug:
            return x, None, None
        return x

    def _restart_block(self, denoise, ts, x, generator, restart_idx, cfg):
        """One restart config: re-noise up to t_max, Heun back down to
        t_steps[restart_idx], K times (reference sample.py:871-932)."""
        n_restart, K, _t_min, t_max = cfg
        new_ts = schedules.karras_steps(
            n_restart, float(ts[restart_idx]), t_max, self.rho
        ).astype(np.float64)
        reup = math.sqrt(max(new_ts[0] ** 2 - new_ts[-1] ** 2, 0.0)) * self.S_noise

        def noised(x, scale):  # one draw (an injected row) per call
            return self.churned(x, scale, self.take_noise(1, x.shape, x.device), 0,
                                generator)

        for _ in range(int(K)):
            x = noised(x, reup)
            for j, (t_cur, t_next) in enumerate(zip(new_ts[:-1], new_ts[1:])):
                gamma = (
                    self.restart_gamma
                    if self.S_min <= t_cur <= self.S_max
                    else 0.0
                )
                t_hat = t_cur + gamma * t_cur
                churn = math.sqrt(max(t_hat**2 - t_cur**2, 0.0)) * self.S_noise
                x_hat = noised(x, churn)
                den = denoise(x_hat, sigma_like(x, t_hat))
                d_cur = (x_hat - den) / float(t_hat)
                x = x_hat + float(t_next - t_hat) * d_cur
                if (j < len(new_ts) - 2 or new_ts[-1] != 0) and t_next > 0:
                    den2 = denoise(x, sigma_like(x, t_next))
                    d_prime = (x - den2) / float(t_next)
                    x = x_hat + float(t_next - t_hat) * (0.5 * d_cur + 0.5 * d_prime)
        return x
