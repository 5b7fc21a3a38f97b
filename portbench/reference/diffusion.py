"""CaloDiffusion's diffusion plumbing in plain PyTorch and NumPy.

A frozen copy of the math around the U-Net (OzAmram/CaloDiffusion
``calodiffusion/models/calodiffusion.py``, ``loss.py``, ``sample.py`` and
``utils/utils.py``) for the configurations the benchmark runs:

- the denoiser of the "hybrid_weight" objective, with the EDM scalings and
  the "sigma" or "log" time feature;
- the DDIM sampler (eta 0) over the discrete cosine schedule;
- the "hybrid_weight" training loss with its l2 weighting, its sigmas drawn
  from the cosine table or the log-normal;
- the inverse preprocessing of CaloChallenge datasets 2 and 3
  ("logit-norm", "layer-logit-norm");
- Adam as ``torch.optim.Adam`` defines it.

It imports nothing of the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.unet import UNet, identity, rz_images

# normalisation constants of CaloChallenge datasets 2 and 3
# (CaloDiffusion utils/consts.py)
DATASET_CONSTS = {
    2: {"logit_mean": -12.8564, "logit_std": 1.9123, "totalE_mean": 0.3926,
        "totalE_std": 0.05546, "layers_mean": -6.35551, "layers_std": 3.90699},
    3: {"logit_mean": -13.4753, "logit_std": 1.1070, "totalE_mean": 0.0,
        "totalE_std": 1.0, "layers_mean": 0.0, "layers_std": 1.0},
}
LOGIT_ALPHA = 1e-6


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

def cosine_tables(nsteps: int) -> dict:
    """The discrete cosine schedule's alpha-bar tables, float32 as stored."""
    x = np.linspace(0, nsteps, nsteps + 1, dtype=np.float64)
    acp = np.cos(((x / nsteps) + 0.008) / 1.008 * np.pi * 0.5) ** 2
    acp = acp / acp[0]
    betas = np.clip(1 - acp[1:] / acp[:-1], 0.0001, 0.9999).astype(np.float32)
    alphas_cumprod = np.cumprod(1.0 - betas.astype(np.float64))
    prev = np.concatenate([[1.0], alphas_cumprod[:-1]])
    return {
        "alphas_cumprod": alphas_cumprod.astype(np.float32),
        "alphas_cumprod_prev": prev.astype(np.float32),
        "sqrt_alphas_cumprod": np.sqrt(alphas_cumprod).astype(np.float32),
        "sqrt_one_minus_alphas_cumprod": np.sqrt(1.0 - alphas_cumprod).astype(np.float32),
    }


def ddim_tables(num_steps: int) -> tuple[np.ndarray, np.ndarray]:
    """(sigma, step coefficient) of each DDIM step (eta 0), float32."""
    t = cosine_tables(num_steps)
    acp_prev = t["alphas_cumprod_prev"].astype(np.float64)
    sa = t["sqrt_alphas_cumprod"].astype(np.float64)
    s1m = t["sqrt_one_minus_alphas_cumprod"].astype(np.float64)
    steps = np.arange(num_steps)[::-1]
    sigma = (s1m[steps] / sa[steps]).astype(np.float32)
    sigma_prev = (np.sqrt(1.0 - acp_prev[steps]) / sa[np.maximum(steps - 1, 0)]).astype(
        np.float32)
    mask = (steps > 0).astype(np.float32)
    return sigma, mask * sigma_prev


# ---------------------------------------------------------------------------
# The denoiser
# ---------------------------------------------------------------------------

class Denoiser:
    """x0 estimate of the "hybrid_weight" objective: c_skip x + c_out
    F(c_in x, [E, layers], t(sigma)), with the R and Z images beside x."""

    def __init__(self, config, params: dict, fake_quant=identity):
        if config.get("TRAINING_OBJ") != "hybrid_weight":
            raise NotImplementedError(f"objective {config.get('TRAINING_OBJ')!r}")
        self.config = config
        self.unet = UNet(config, params, fake_quant)
        device = next(iter(params.values())).device
        images = rz_images(config)
        self.images = None if images is None else torch.as_tensor(images, device=device)[None]
        self.layer_cond = "layer" in config.get("SHOWERMAP", "")
        self.sigma_data = 1.0 if "log" in config.get("NOISE_SCHED", "linear") else 0.5

    def time_feature(self, sigma):
        if self.config.get("TIME_EMBED") == "sigma":
            return sigma / torch.sqrt(1 + sigma ** 2)
        return 0.5 * torch.log(sigma)

    def scalings(self, sigma):
        """(c_skip, c_out, c_in) of the EDM preconditioning at ``sigma``."""
        sd = self.sigma_data
        return (sd ** 2 / (sigma ** 2 + sd ** 2), sigma * sd / (sigma ** 2 + sd ** 2) ** 0.5,
                1 / (sigma ** 2 + sd ** 2) ** 0.5)

    def network(self, x_in, E, sigma, layers=None):
        """The network's prediction F(x_in, [E, layers], t(sigma)) for the
        scaled input x_in = c_in x."""
        cond = torch.cat([E, layers], dim=1) if self.layer_cond else E
        if self.images is not None:
            x_in = torch.cat([x_in, self.images.expand(x_in.shape[0], -1, -1, -1, -1)], dim=1)
        return self.unet(x_in, cond, self.time_feature(sigma.reshape(-1)))

    def __call__(self, x, E, sigma, layers=None):
        """x (B, 1, Z, A, R), E (B, 1), sigma (B, 1, 1, 1, 1)."""
        c_skip, c_out, c_in = self.scalings(sigma)
        return c_skip * x + c_out * self.network(x * c_in, E, sigma, layers)


def ddim_sample(denoiser: Denoiser, start, E, layers, num_steps: int):
    """DDIM with eta 0 from the unit normals ``start``: the sampler's output
    in the preprocessed space."""
    sigma, coeff = ddim_tables(num_steps)
    x = start * float(sigma[0])
    for i in range(num_steps):
        s = torch.full((x.shape[0],) + (1,) * (x.ndim - 1), float(sigma[i]),
                       dtype=x.dtype, device=x.device)
        x0 = denoiser(x, E, s, layers)
        x = x0 + float(coeff[i]) * ((x - x0) / s)
    return x


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def draw_sigma_noise(config, generator: torch.Generator, shape):
    """The sigmas (B, 1, 1, 1, 1) and unit noise of one training batch, drawn
    from ``generator`` in the order the objective draws them: the discrete
    time (cosine schedule) or the log-normal (P_mean -1.2, P_std 1.2), then
    the noise."""
    B, dev = shape[0], generator.device
    bshape = (B,) + (1,) * (len(shape) - 1)
    if "log" in config.get("NOISE_SCHED", "linear"):
        rnd = torch.randn((B,), generator=generator, device=dev)
        sigma = torch.exp(rnd * 1.2 - 1.2).reshape(bshape)
    else:
        t = cosine_tables(config["NSTEPS"])
        idx = torch.randint(0, config["NSTEPS"], (B,), generator=generator, device=dev).cpu()
        sigma = (torch.from_numpy(t["sqrt_one_minus_alphas_cumprod"])[idx]
                 / torch.from_numpy(t["sqrt_alphas_cumprod"])[idx]).reshape(bshape).to(dev)
    noise = torch.randn(shape, generator=generator, device=dev)
    return sigma, noise


def hybrid_loss(denoiser: Denoiser, data, E, layers, sigma, noise):
    """The "hybrid_weight" l2 loss: sum((1 + 1/sigma^2) (D(x + sigma n) -
    x)^2) over the mean weight times the element count."""
    x0 = denoiser(data + sigma * noise, E, sigma, layers)
    w = (1.0 + 1.0 / sigma ** 2) * torch.ones_like(x0)
    return (w * (x0 - data) ** 2).sum() / (w.mean() * float(np.prod(data.shape)))


class Adam:
    """torch.optim.Adam's update (no weight decay, no amsgrad) over a dict
    of tensors, in place."""

    def __init__(self, params: dict, lr: float, betas=(0.9, 0.999), eps=1e-8):
        self.params, self.lr, self.betas, self.eps = params, lr, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict):
        self.t += 1
        b1, b2 = self.betas
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / bc2 ** 0.5).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / bc1)


# ---------------------------------------------------------------------------
# The inverse preprocessing
# ---------------------------------------------------------------------------

def reverse_logit(x, alpha=LOGIT_ALPHA):
    with np.errstate(over="ignore", invalid="ignore"):
        exp = np.exp(x)
        o = np.where(np.isinf(exp), 1.0, exp / (1 + exp))
    return (o - alpha) / (1 - 2 * alpha)


def reverse_norm(voxels, E, config, layers=None):
    """Showers (B, Z*A*R) in the dataset's units from the sampler's output
    (B, 1, Z, A, R), the preprocessed energies E (B, 1) and, for a
    layer-conditioned map, the preprocessed layer energies (B, 1 + Z);
    float64 throughout."""
    c = DATASET_CONSTS[config["DATASET_NUM"]]
    smap = config["SHOWERMAP"]
    if smap not in ("logit-norm", "layer-logit-norm") or not config.get("logE", True):
        raise NotImplementedError(f"SHOWERMAP {smap!r}")
    emin, emax = float(config["EMIN"]), float(config["EMAX"])
    energy = emin * (emax / emin) ** np.asarray(E, np.float64)
    data = reverse_logit(np.asarray(voxels, np.float64) * c["logit_std"] + c["logit_mean"])
    B = data.shape[0]
    data = data.reshape(B, *config["SHAPE_FINAL"][2:])
    if smap == "layer-logit-norm":
        layers = np.asarray(layers, np.float64)
        total = layers[:, :1] * c["totalE_std"] + c["totalE_mean"]
        per = reverse_logit(layers[:, 1:] * c["layers_std"] + c["layers_mean"])
        per = per / per.sum(axis=1, keepdims=True) * total
        data[data < 0] = 0
        prev = data.sum(axis=(2, 3), keepdims=True)
        per = per.reshape(B, data.shape[1], 1, 1)
        fac = per / (prev + 1e-10)
        fac[per < 1e-6] = 1.0
        fac[prev < 1e-6] = 1.0
        data = data * fac
    data = data.reshape(B, -1) * float(config["MAXDEP"]) * energy.reshape(-1, 1)
    ecut = float(config.get("ECUT", 0))
    if ecut > 0:
        data[data < ecut] = 0
    return data
