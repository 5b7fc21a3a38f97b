"""DPM-Solver family (fast / adaptive) and DPM-Solver++ variants.

Port of ``calodiffusion_tpu/samplers/dpm.py`` (reference semantics:
calodiffusion/models/sample.py:124-574 and
calodiffusion/utils/sampling.py:385-600, arXiv:2206.00927 / 2211.01095).

- ``DPM`` (solver-fast): its uniform order-3 prefix computes its step
  scalars in f32, as the JAX sampler's scan over f32 rows does; its 1-2
  tail segments in Python floats, as the JAX sampler's inline tail does.
- ``DPMAdaptive``: the step state (s, h, the error history) stays on the
  device as f32 0-dim tensors and steps are accepted with ``torch.where``;
  one scalar is read back a step for the loop condition, the counterpart
  of the JAX sampler's ``lax.while_loop``.  Its PID controller is the
  working k-diffusion one (PARITY.md deviation 3).
- DPM++ fixed-step samplers: per-step coefficients are f64 host math held
  as f32 rows.
- SDE variants draw per-interval standard normals in place of torchsde's
  Brownian tree (PARITY.md deviation 4).

Draws that the JAX sampler takes from its PRNG even with an injected noise
table (``DPM`` and ``DPMAdaptive`` with ``ETA`` set, ``DPMPP2S``'s final
noise) come from the generator here too.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from calodiffusion_tpu_torch.samplers import schedules
from calodiffusion_tpu_torch.samplers.base import Sample, bshape, randn, sigma_like


def _ancestral_np(sigma_from, sigma_to, eta):
    if not eta:
        return float(sigma_to), 0.0
    if sigma_from <= 0:
        return float(sigma_to), 0.0
    sigma_up = min(
        float(sigma_to),
        eta * (sigma_to**2 * (sigma_from**2 - sigma_to**2) / sigma_from**2) ** 0.5,
    )
    sigma_down = (sigma_to**2 - sigma_up**2) ** 0.5
    return float(sigma_down), float(sigma_up)


def _f32_table(rows):
    """A list of row dicts as a dict of f32 columns."""
    return {k: np.array([r[k] for r in rows], dtype=np.float32) for k in rows[0]}


class DPM(Sample):
    """DPM-Solver-Fast (fixed step size; reference sample.py:124-185)."""

    def __init__(self, config):
        super().__init__(config)
        self.eta = self.sample_config.get("ETA", 0)
        self.s_noise = self.sample_config.get("S_NOISE", 1.0)

    def create_sigmas(self, model, num_steps):
        # quirk preserved: selecting a different num_steps rebuilds the
        # model's loss tables (reference sample.py:155-162)
        if model.nsteps != num_steps:
            model.loss_function.update_step(num_steps)
        return schedules.discrete_sigmas(num_steps)

    def __call__(
        self, model, start, energy, layers, num_steps, sample_offset,
        generator, debug=False,
    ):
        denoise = self.make_denoise_fn(model, energy, layers)
        sigmas = self.create_sigmas(model, num_steps).astype(np.float64)
        sigma_min, sigma_max = sigmas[-1], sigmas[0]
        if sigma_min <= 0 or sigma_max <= 0:
            raise ValueError("sigma_min and sigma_max must not be 0")

        x = start * float(sigmas[0])

        t_start, t_end = -math.log(sigma_max), -math.log(sigma_min)
        nfe = num_steps
        m = math.floor(nfe / 3) + 1
        ts = np.linspace(t_start, t_end, m + 1)
        if nfe % 3 == 0:
            orders = [3] * (m - 2) + [2, 1]
        else:
            orders = [3] * (m - 1) + [nfe % 3]

        def sig(t):
            return math.exp(-t)

        def eval_d(x, t):
            return (x - denoise(x, sigma_like(x, sig(t)))) / sig(t)

        def solver_1(x, t, t_next, eps):
            return x - sig(t_next) * math.expm1(t_next - t) * eps

        def solver_2(x, t, t_next, eps, r1=0.5):
            h = t_next - t
            s1 = t + r1 * h
            u1 = x - sig(s1) * math.expm1(r1 * h) * eps
            eps_r1 = eval_d(u1, s1)
            return (
                x
                - sig(t_next) * math.expm1(h) * eps
                - sig(t_next) / (2 * r1) * math.expm1(h) * (eps_r1 - eps)
            )

        def solver_3(x, t, t_next, eps, r1=1 / 3, r2=2 / 3):
            h = t_next - t
            s1, s2 = t + r1 * h, t + r2 * h
            u1 = x - sig(s1) * math.expm1(r1 * h) * eps
            eps_r1 = eval_d(u1, s1)
            u2 = (
                x
                - sig(s2) * math.expm1(r2 * h) * eps
                - sig(s2) * (r2 / r1) * (math.expm1(r2 * h) / (r2 * h) - 1)
                * (eps_r1 - eps)
            )
            eps_r2 = eval_d(u2, s2)
            return (
                x
                - sig(t_next) * math.expm1(h) * eps
                - sig(t_next) / r2 * (math.expm1(h) / h - 1) * (eps_r2 - eps)
            )

        # ancestral adjustment per segment (host scalars)
        def seg_targets(t, t_next):
            if self.eta:
                sd, _ = _ancestral_np(sig(t), sig(t_next), self.eta)
                t_next_ = min(t_end, -math.log(sd))
                su = (sig(t_next) ** 2 - sig(t_next_) ** 2) ** 0.5
            else:
                t_next_, su = t_next, 0.0
            return t_next_, su

        def ancestral_noise(x, su):
            if not su:
                return x
            return x + su * self.s_noise * randn(x.shape, generator, x.device)

        seg_xs = []
        # the uniform order-3 prefix, its step scalars in f32
        n3 = sum(1 for o in orders if o == 3)
        start_idx = n3 if n3 > 1 else 0
        for i in range(start_idx):
            t_next_, su = seg_targets(ts[i], ts[i + 1])
            x = self._order3_f32(denoise, x, np.float32(ts[i]), np.float32(t_next_))
            x = ancestral_noise(x, float(np.float32(su)))
            if debug:
                seg_xs.append(x)

        # remaining segments, in Python floats
        for i in range(start_idx, len(orders)):
            t, t_next = ts[i], ts[i + 1]
            t_next_, su = seg_targets(t, t_next)
            eps = eval_d(x, t)
            if orders[i] == 1:
                x = solver_1(x, t, t_next_, eps)
            elif orders[i] == 2:
                x = solver_2(x, t, t_next_, eps)
            else:
                x = solver_3(x, t, t_next_, eps)
            x = ancestral_noise(x, su)
            if debug:
                seg_xs.append(x)

        if debug:
            # per-SEGMENT states (this solver steps in multi-eval segments,
            # not single sigma steps)
            return x, torch.stack(seg_xs) if seg_xs else None, None
        return x

    @staticmethod
    def _order3_f32(denoise, x, t, t_next):
        """One order-3 segment from f32 t to f32 t_next, its scalars in f32."""
        one, r1, r2 = np.float32(1), np.float32(1 / 3), np.float32(2 / 3)
        h = t_next - t

        def sigj(tt):
            return np.float32(math.exp(-tt))

        def expm1(v):
            return np.float32(math.expm1(v))

        d0 = denoise(x, sigma_like(x, sigj(t)))
        eps = (x - d0) / float(sigj(t))
        s1, s2 = t + r1 * h, t + r2 * h
        u1 = x - float(sigj(s1) * expm1(r1 * h)) * eps
        d1 = denoise(u1, sigma_like(x, sigj(s1)))
        eps_r1 = (u1 - d1) / float(sigj(s1))
        u2 = (
            x
            - float(sigj(s2) * expm1(r2 * h)) * eps
            - float(sigj(s2) * np.float32(2.0) * (expm1(r2 * h) / (r2 * h) - one))
            * (eps_r1 - eps)
        )
        d2 = denoise(u2, sigma_like(x, sigj(s2)))
        eps_r2 = (u2 - d2) / float(sigj(s2))
        return (
            x
            - float(sigj(t_next) * expm1(h)) * eps
            - float(sigj(t_next) / r2 * (expm1(h) / h - one)) * (eps_r2 - eps)
        )


class DPMAdaptive(DPM):
    """DPM-Solver-12/23 with PID step-size control (reference :188-308)."""

    def __init__(self, config):
        super().__init__(config)
        self.order = self.sample_config.get("ORDER", 3)
        self.r_tol = self.sample_config.get("R_TOL", 0.05)
        self.a_tol = self.sample_config.get("A_TOL", 0.0078)
        self.h_init = self.sample_config.get("H_INIT", 0.05)
        self.t_err = self.sample_config.get("T_ERROR", 1e-5)
        self.accept_safety = self.sample_config.get("ACCEPT_SAFETY", 0.81)
        self.pcoeff = self.sample_config.get("P_COEFF", 0.0)
        self.icoeff = self.sample_config.get("I_COEFF", 1.0)
        self.dcoeff = self.sample_config.get("D_COEFF", 0.0)
        # (accepted, rejected) steps of the last call
        self.last_steps = (0, 0)

    def __call__(
        self, model, start, energy, layers, num_steps, sample_offset,
        generator, debug=False,
    ):
        if self.order not in (2, 3):
            raise ValueError("order should be 2 or 3")
        denoise = self.make_denoise_fn(model, energy, layers)
        sigmas = self.create_sigmas(model, num_steps).astype(np.float64)
        sigma_min, sigma_max = float(sigmas[-1]), float(sigmas[0])
        if sigma_min <= 0 or sigma_max <= 0:
            raise ValueError("sigma_min and sigma_max must not be 0")

        t_start, t_end = -math.log(sigma_max), -math.log(sigma_min)
        bs = bshape(start)
        dev = start.device
        x = start * sigma_max

        pid_order = 1.5 if self.eta else self.order
        b1 = (self.pcoeff + self.icoeff + self.dcoeff) / pid_order
        b2 = -(self.pcoeff + 2 * self.dcoeff) / pid_order
        b3 = self.dcoeff / pid_order

        def scalar(v):
            return torch.tensor(v, dtype=torch.float32, device=dev)

        t_end_t = scalar(t_end)

        def sigj(t):
            return torch.exp(-t)

        def eval_eps(x, t):
            sigma_b = torch.ones(bs, dtype=torch.float32, device=dev) * sigj(t)
            return (x - denoise(x, sigma_b)) / sigj(t)

        def solver_1(x, t, t_next, eps):
            return x - sigj(t_next) * torch.expm1(t_next - t) * eps

        def solver_2(x, t, t_next, eps, r1):
            h = t_next - t
            s1 = t + r1 * h
            u1 = x - sigj(s1) * torch.expm1(r1 * h) * eps
            eps_r1 = eval_eps(u1, s1)
            x2 = (
                x
                - sigj(t_next) * torch.expm1(h) * eps
                - sigj(t_next) / (2 * r1) * torch.expm1(h) * (eps_r1 - eps)
            )
            return x2, eps_r1

        def solver_3(x, t, t_next, eps, eps_r1, r1, r2):
            h = t_next - t
            s2 = t + r2 * h
            u2 = (
                x
                - sigj(s2) * torch.expm1(r2 * h) * eps
                - sigj(s2) * (r2 / r1) * (torch.expm1(r2 * h) / (r2 * h) - 1)
                * (eps_r1 - eps)
            )
            eps_r2 = eval_eps(u2, s2)
            return (
                x
                - sigj(t_next) * torch.expm1(h) * eps
                - sigj(t_next) / r2 * (torch.expm1(h) / h - 1) * (eps_r2 - eps)
            )

        x_prev = x
        s, h = scalar(t_start), scalar(abs(self.h_init))
        errs = torch.ones(2, dtype=torch.float32, device=dev)
        accepted = torch.zeros((), dtype=torch.int64, device=dev)
        n_iter = 0
        # the loop condition in f32, as the JAX while_loop compares
        limit = float(np.float32(t_end - self.t_err))
        while s.item() < limit:
            n_iter += 1
            t = torch.minimum(t_end_t, s + h)

            if self.eta:
                sig_s, sig_t = sigj(s), sigj(t)
                su0 = torch.minimum(
                    sig_t,
                    self.eta * (sig_t**2 * (sig_s**2 - sig_t**2) / sig_s**2) ** 0.5,
                )
                sd = (sig_t**2 - su0**2) ** 0.5
                t_ = torch.minimum(t_end_t, -torch.log(sd))
                su = (sig_t**2 - sigj(t_) ** 2) ** 0.5
            else:
                t_, su = t, None

            eps = eval_eps(x, s)
            if self.order == 2:
                x_low = solver_1(x, s, t_, eps)
                x_high, _ = solver_2(x, s, t_, eps, r1=0.5)
            else:
                x_low, eps_r1 = solver_2(x, s, t_, eps, r1=1 / 3)
                x_high = solver_3(x, s, t_, eps, eps_r1, r1=1 / 3, r2=2 / 3)

            delta = torch.clamp_min(
                self.r_tol * torch.maximum(torch.abs(x_low), torch.abs(x_prev)), self.a_tol
            )
            error = torch.sqrt(torch.mean(((x_low - x_high) / delta) ** 2))

            # k-diffusion PID step controller
            inv_err = 1.0 / (error + 1e-8)
            factor_raw = inv_err**b1 * errs[0] ** b2 * errs[1] ** b3
            factor = 1 + torch.arctan(factor_raw - 1)
            accept = factor >= self.accept_safety
            errs = torch.where(accept, torch.stack([inv_err, errs[0]]), errs)
            h = h * factor

            x_acc = x_high
            if su is not None:
                x_acc = x_high + su * self.s_noise * randn(x.shape, generator, dev)
            x = torch.where(accept, x_acc, x)
            x_prev = torch.where(accept, x_low, x_prev)
            s = torch.where(accept, t, s)
            accepted = accepted + accept
        n_acc = int(accepted.item())
        self.last_steps = (n_acc, n_iter - n_acc)
        if debug:
            return x, None, None
        return x


class DPMPP2S(DPM):
    """DPM-Solver++(2S) ancestral (reference sample.py:311-344)."""

    def __call__(
        self, model, start, energy, layers, num_steps, sample_offset,
        generator, debug=False,
    ):
        denoise = self.make_denoise_fn(model, energy, layers)
        sigmas = self.create_sigmas(model, num_steps).astype(np.float64)
        x = start * float(sigmas[0])

        rows = []
        for i in range(len(sigmas) - 1):
            si = float(sigmas[i])
            sd, su = _ancestral_np(si, float(sigmas[i + 1]), self.eta)
            sig_mid = math.sqrt(si * sd)  # sigma(s) at the midpoint in lambda
            rows.append(
                dict(
                    sigma=si,
                    sig_mid=sig_mid,
                    c_x2_x=sig_mid / si,
                    c_x2_d=1.0 - math.sqrt(sd / si) if sd > 0 else 1.0,
                    c_x_x=sd / si,
                    c_x_d=1.0 - sd / si,
                )
            )
        tab = _f32_table(rows)

        xs, x0s = [], []
        for i in range(len(rows)):
            d0 = denoise(x, sigma_like(x, tab["sigma"][i]))
            x2 = float(tab["c_x2_x"][i]) * x + float(tab["c_x2_d"][i]) * d0
            d1 = denoise(x2, sigma_like(x, tab["sig_mid"][i]))
            x = float(tab["c_x_x"][i]) * x + float(tab["c_x_d"][i]) * d1
            if debug:
                xs.append(x)
                x0s.append(d0)

        # quirk preserved: the reference adds the ancestral noise once, after
        # the loop, using the last interval (reference :336-343)
        _, su_last = _ancestral_np(float(sigmas[-2]), float(sigmas[-1]), self.eta)
        if float(sigmas[-1]) > 0 and su_last > 0:
            x = x + randn(x.shape, generator, x.device) * self.s_noise * su_last
        if debug:
            # last frame = the returned sample, the post-loop noise included
            xs[-1] = x
            return x, torch.stack(xs), torch.stack(x0s)
        return x


class DPMPPSDE(DPM):
    """DPM-Solver++ (stochastic) (reference :347-412)."""

    def __init__(self, config):
        super().__init__(config)
        self.r = self.sample_config.get("R", 0.5)

    def __call__(
        self, model, start, energy, layers, num_steps, sample_offset,
        generator, debug=False,
    ):
        denoise = self.make_denoise_fn(model, energy, layers)
        sigmas = self.create_sigmas(model, num_steps).astype(np.float64)
        dev = start.device
        x = start * float(sigmas[0])
        r, fac = self.r, 1 / (2 * self.r)

        rows = []
        for i in range(len(sigmas) - 1):
            si, sn = float(sigmas[i]), float(sigmas[i + 1])
            t, t_next = -math.log(si), -math.log(sn)
            h = t_next - t
            s = t + h * r
            sig_s = math.exp(-s)
            sd1, su1 = _ancestral_np(si, sig_s, self.eta)
            sd2, su2 = _ancestral_np(si, sn, self.eta)
            rows.append(
                dict(
                    sigma=si,
                    sig_s=sig_s,
                    c1_x=sd1 / si,
                    c1_d=1.0 - sd1 / si,
                    su1=su1,
                    c2_x=sd2 / si,
                    c2_d=1.0 - sd2 / si,
                    su2=su2,
                )
            )
        tab = _f32_table(rows)
        # the reference draws from its Brownian sampler twice a step, after
        # each half-step (sample.py:369-412), whatever eta is
        inj = self.take_noise(2 * len(rows), start.shape, dev)

        def noised(x, su, i):
            if not su:
                return x
            return x + self.noise(inj, i, x.shape, generator, dev) * self.s_noise * float(su)

        for i in range(len(rows)):
            d0 = denoise(x, sigma_like(x, tab["sigma"][i]))
            x2 = float(tab["c1_x"][i]) * x + float(tab["c1_d"][i]) * d0
            x2 = noised(x2, tab["su1"][i], 2 * i)
            d1 = denoise(x2, sigma_like(x, tab["sig_s"][i]))
            dd = (1 - fac) * d0 + fac * d1
            x = float(tab["c2_x"][i]) * x + float(tab["c2_d"][i]) * dd
            x = noised(x, tab["su2"][i], 2 * i + 1)
        if debug:
            return x, None, None
        return x


class DPMPP2M(DPM):
    """DPM-Solver++(2M) multistep (reference :415-449)."""

    def __call__(
        self, model, start, energy, layers, num_steps, sample_offset,
        generator, debug=False,
    ):
        denoise = self.make_denoise_fn(model, energy, layers)
        sigmas = self.create_sigmas(model, num_steps).astype(np.float64)
        x = start * float(sigmas[0])

        rows = []
        for i in range(len(sigmas) - 1):
            si, sn = float(sigmas[i]), float(sigmas[i + 1])
            t, t_next = -math.log(si), -math.log(sn) if sn > 0 else float("inf")
            h = t_next - t
            use_ms = 1.0 if (i > 0 and sn != 0) else 0.0
            if i > 0:
                h_last = t - (-math.log(float(sigmas[i - 1])))
                rr = h_last / h if h not in (0.0, float("inf")) else 0.0
            else:
                rr = 0.0
            c_x = sn / si
            c_d = 1.0 - sn / si  # = -expm1(-h)
            w_new = (1 + 1 / (2 * rr)) if use_ms else 1.0
            w_old = (1 / (2 * rr)) if use_ms else 0.0
            rows.append(dict(sigma=si, c_x=c_x, c_d=c_d, w_new=w_new, w_old=w_old))
        tab = _f32_table(rows)

        old_d = torch.zeros_like(x)
        xs, x0s = [], []
        for i in range(len(rows)):
            d0 = denoise(x, sigma_like(x, tab["sigma"][i]))
            dd = float(tab["w_new"][i]) * d0 - float(tab["w_old"][i]) * old_d
            x = float(tab["c_x"][i]) * x + float(tab["c_d"][i]) * dd
            old_d = d0
            if debug:
                xs.append(x)
                x0s.append(d0)
        if debug:
            return x, torch.stack(xs), torch.stack(x0s)
        return x


class DPMPP2MSDE(DPM):
    """DPM-Solver++(2M) SDE (reference :452-516)."""

    def __init__(self, config):
        super().__init__(config)
        self.solver_type = self.sample_config.get("SOLVER", "heun")
        if self.solver_type not in {"heun", "midpoint"}:
            raise ValueError("'SOLVER' must be 'heun' or 'midpoint'")

    def __call__(
        self, model, start, energy, layers, num_steps, sample_offset,
        generator, debug=False,
    ):
        denoise = self.make_denoise_fn(model, energy, layers)
        sigmas = self.create_sigmas(model, num_steps).astype(np.float64)
        dev = start.device
        x = start * float(sigmas[0])

        rows = []
        h_prev = None
        for i in range(len(sigmas) - 1):
            si, sn = float(sigmas[i]), float(sigmas[i + 1])
            if sn == 0:
                rows.append(dict(sigma=si, c_x=0.0, c_d=1.0, w_corr=0.0,
                                 noise_c=0.0, denoise_only=1.0))
                continue
            t, s = -math.log(si), -math.log(sn)
            h = s - t
            eta_h = self.eta * h
            c_x = sn / si * math.exp(-eta_h)
            c_d = -math.expm1(-h - eta_h)
            if h_prev is not None:
                rr = h_prev / h
                if self.solver_type == "heun":
                    w_corr = (-math.expm1(-h - eta_h) / (-h - eta_h) + 1) * (1 / rr)
                else:
                    w_corr = 0.5 * (-math.expm1(-h - eta_h)) * (1 / rr)
            else:
                w_corr = 0.0
            noise_c = (
                sn * math.sqrt(-math.expm1(-2 * eta_h)) * self.s_noise
                if self.eta
                else 0.0
            )
            rows.append(dict(sigma=si, c_x=c_x, c_d=c_d, w_corr=w_corr,
                             noise_c=noise_c, denoise_only=0.0))
            h_prev = h
        tab = _f32_table(rows)
        # the reference draws only when eta is truthy and sigma_next != 0
        # (sample.py:505-512): one injected row per such step
        live = [i for i, rr in enumerate(rows) if not rr["denoise_only"]]
        inj = self.take_noise(len(live), start.shape, dev) if self.eta else None

        old_d = torch.zeros_like(x)
        for i in range(len(rows)):
            d0 = denoise(x, sigma_like(x, tab["sigma"][i]))
            if tab["denoise_only"][i]:
                x = d0
            else:
                x_new = float(tab["c_x"][i]) * x + float(tab["c_d"][i]) * d0
                x_new = x_new + float(tab["w_corr"][i]) * (d0 - old_d)
                if tab["noise_c"][i]:
                    noise = self.noise(inj, live.index(i), x.shape, generator, dev)
                    x_new = x_new + float(tab["noise_c"][i]) * noise
                x = x_new
            old_d = d0
        if debug:
            return x, None, None
        return x


class DPMPP3MSDE(DPM):
    """DPM-Solver++(3M) SDE (reference :519-574)."""

    def __call__(
        self, model, start, energy, layers, num_steps, sample_offset,
        generator, debug=False,
    ):
        denoise = self.make_denoise_fn(model, energy, layers)
        sigmas = self.create_sigmas(model, num_steps).astype(np.float64)
        dev = start.device
        x = start * float(sigmas[0])

        rows = []
        h1 = h2 = None
        for i in range(len(sigmas) - 1):
            si, sn = float(sigmas[i]), float(sigmas[i + 1])
            if sn == 0:
                rows.append(dict(sigma=si, c_x=0.0, c_d=1.0, w_d1=0.0, w_d2=0.0,
                                 r0=1.0, r1=1.0, noise_c=0.0, denoise_only=1.0,
                                 mode=0.0))
                continue
            t, s = -math.log(si), -math.log(sn)
            h = s - t
            h_eta = h * (self.eta + 1)
            c_x = math.exp(-h_eta)
            c_d = -math.expm1(-h_eta)
            phi_2 = math.expm1(-h_eta) / h_eta + 1
            phi_3 = phi_2 / h_eta - 0.5
            if h2 is not None:
                mode, r0, r1 = 2.0, h1 / h, h2 / h
                w_d1, w_d2 = phi_2, phi_3
            elif h1 is not None:
                mode, r0, r1 = 1.0, h1 / h, 1.0
                w_d1, w_d2 = phi_2, 0.0
            else:
                mode, r0, r1 = 0.0, 1.0, 1.0
                w_d1 = w_d2 = 0.0
            noise_c = (
                sn * math.sqrt(-math.expm1(-2 * h * self.eta)) * self.s_noise
                if self.eta
                else 0.0
            )
            rows.append(dict(sigma=si, c_x=c_x, c_d=c_d, w_d1=w_d1, w_d2=w_d2,
                             r0=r0, r1=r1, noise_c=noise_c, denoise_only=0.0,
                             mode=mode))
            h2, h1 = h1, h
        tab = _f32_table(rows)
        # the reference draws once a step with sigma_next != 0, whatever eta
        # is (sample.py:565-571): one injected row per such step
        live = [i for i, rr in enumerate(rows) if not rr["denoise_only"]]
        inj = self.take_noise(len(live), start.shape, dev)

        d_1 = d_2 = torch.zeros_like(x)
        for i in range(len(rows)):
            row = {k: v[i] for k, v in tab.items()}
            d0 = denoise(x, sigma_like(x, row["sigma"]))
            if row["denoise_only"]:
                x = d0
            else:
                x_new = float(row["c_x"]) * x + float(row["c_d"]) * d0
                r0, r1 = row["r0"], row["r1"]
                if row["mode"] >= 2.0:
                    d1_0 = (d0 - d_1) * float(np.float32(1.0) / r0)
                    d1_1 = (d_1 - d_2) * float(np.float32(1.0) / r1)
                    d1 = d1_0 + (d1_0 - d1_1) * float(r0) / float(r0 + r1)
                    d2 = (d1_0 - d1_1) / float(r0 + r1)
                    x_new = x_new + (float(row["w_d1"]) * d1 - float(row["w_d2"]) * d2)
                elif row["mode"] >= 1.0:
                    d1_0 = (d0 - d_1) * float(np.float32(1.0) / r0)
                    x_new = x_new + float(row["w_d1"]) * d1_0
                if row["noise_c"]:
                    noise = self.noise(inj, live.index(i), x.shape, generator, dev)
                    x_new = x_new + float(row["noise_c"]) * noise
                x = x_new
            d_1, d_2 = d0, d_1
        if debug:
            return x, None, None
        return x
