"""What decides ``correct``: the program's outputs against the plain reference.

Both sides get the same weights and inputs, made by ``inputs`` from the
run's seed; the reference (``reference/``) runs in float32 with TF32 off,
after the window has closed and the program's state is freed.

Generation: hooks keep, for rows and steps drawn from the seed, the
network's input and output in every call of the window.  For each call
completed, the reference follows the program from its own state: its
network at the program's inputs against the program's output; each kept
sampler step (DDIM, eta 0) from the program's state and output against
the program's next state; the first state against the start noise; the
showers against the inverse preprocessing of the program's last step.
The network's gap is the RMS over the kept rows, steps and voxels of
F_program - F_reference, in the units of the network's output F (the
preconditioning gives its target unit variance): rounding's error is set
by the activations' scale, which the GroupNorms fix, while the output's
own norm moves threefold with the seed's weights.  The other stages' gap
is the widest row's relative L2 gap, ||program - reference|| /
||reference||.  The number compared, ``gap``, is the widest stage of the
widest call.  (A reference that samples on its own from the start noise
drifts from the program by as much in bfloat16 as in int8: PERF.md.)

Training: the set-up drives the training object through its first three
steps (same batches, same sigma and noise draws as the reference), and the
window then drives that same object.  Compared:

- ``grad3_diff``: the gradients of the three steps as the optimizer got
  them (the first worked out from its state: Adam's first moment after one
  step over 1 - beta1), each against the reference's gradient at the
  program's own parameters before that step, as the norm of the difference
  over the reference's norm, all leaves and steps together;
- ``update3_diff``: the parameters' change over the three steps against
  the reference's Adam run from the same weights over the program's own
  gradients, as the norm of the difference over the norm of that change,
  over the leaves whose reference gradient is at least a thousandth of the
  median leaf's (Adam moves the others by round-off).

The reference follows the program's state, as in generation: a reference
that trains on its own diverges from the program after the first step,
by as much as half a gradient at step 3 on seeds where the program's own
state agrees to a hundredth (``calibrate.py`` reads both; PERF.md gives
the readings).  Read too, and not compared: the first gradient alone
(``grad1_diff``) and the widest of steps 2 and 3 (``grad_state_diff``),
each of which reads up to six times its usual on a few seeds, where that
step's gradient alone is off while the three together are not; and the
first loss's gap (``loss1_rel``).  A cell compares what its ``limits/``
file lists; PERF.md gives the readings behind each limit.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from portbench import inputs
from portbench.reference import diffusion as ref
from portbench.reference.unet import identity

LEAF_FLOOR = 1e-3


def passes(numbers: dict, limits: dict) -> bool:
    """Whether every number that has a limit is finite and within it."""
    return all(math.isfinite(numbers[k]) and numbers[k] <= v for k, v in limits.items())


@contextlib.contextmanager
def float32_exact():
    """TF32 off for matrix products and convolutions, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _round(t, dtype, top):
    """``t`` rounded to the float8 ``dtype`` with a per-tensor scale that
    takes its largest magnitude to ``top``."""
    scale = top / t.detach().abs().amax().clamp(min=1e-30)
    return (t * scale).to(dtype).to(t.dtype) / scale


class _FP8(torch.autograd.Function):
    """Values in float8 e4m3, their gradients in float8 e5m2."""

    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def fp8(t):
    """The control's rounding of an operand or a stored activation."""
    return _FP8.apply(t)


# ---------------------------------------------------------------------------
# Generation
# ---------------------------------------------------------------------------

def capture_plan(seed: int, batch: int, traffic) -> tuple[list, list]:
    """(rows, steps) of each generation call that the check keeps, drawn
    from the seed: ``check_rows`` rows, the first and the last step, and
    ``check_pairs`` pairs of consecutive steps between them."""
    rng = np.random.default_rng(inputs.sub_seed(seed, inputs.SAMPLE))
    n = traffic["steps"]
    rows = sorted(int(r) for r in rng.choice(batch, min(batch, traffic["check_rows"]),
                                                replace=False))
    between = np.arange(1, max(n - 2, 1))
    firsts = rng.choice(between, min(len(between), traffic["check_pairs"]), replace=False)
    steps = sorted({0, n - 1} | {int(s) for s in firsts} | {int(s) + 1 for s in firsts})
    return rows, steps


class Capture:
    """Hooks on the program's network that keep, for the planned rows and
    steps of each generation call (``begin``), the network's input (c_in x,
    E, t, layers) and its output.  ``evals`` counts every evaluation
    completed while the hooks are on, inside a call or not: the run's
    window counts its work by it."""

    def __init__(self, net, rows, steps):
        self.rows, self.steps = rows, set(steps)
        self.call, self.step, self.store = None, 0, {}
        self.evals = 0
        self.handles = [net.register_forward_pre_hook(self._pre),
                        net.register_forward_hook(self._post)]

    def begin(self, call):
        self.call, self.step = call, 0
        self.store[call] = {}

    def end(self):
        self.call = None

    def _take(self, t):
        return None if t is None else t[self.rows].detach().float().clone()

    def _pre(self, mod, args):
        if self.call is not None and self.step in self.steps:
            x_in, E, _, layers = (list(args) + [None] * 4)[:4]
            self.store[self.call][self.step] = {"x_in": self._take(x_in)}

    def _post(self, mod, args, out):
        self.evals += 1
        if self.call is None:
            return
        if self.step in self.steps:
            self.store[self.call][self.step]["out"] = self._take(out)
        self.step += 1

    def close(self):
        for h in self.handles:
            h.remove()


def rel_rows(got, want):
    """Each row's ||got - want|| / ||want|| (torch, float64)."""
    g = got.double().reshape(got.shape[0], -1)
    w = want.double().reshape(want.shape[0], -1)
    den = w.norm(dim=1)
    num = (g - w).norm(dim=1)
    return torch.where(den > 0, num / den.clamp(min=1e-300),
                       torch.where(num > 0, torch.inf, 0.0)).cpu().numpy()


def rel_l2(prog_rows, ref_rows) -> np.ndarray:
    return rel_rows(torch.as_tensor(np.asarray(prog_rows)), torch.as_tensor(np.asarray(ref_rows)))


def generation_gaps(config, traffic, seed, outputs, capture: Capture, conds, device) -> dict:
    """{call: {stage: gap}} over the completed calls' ``outputs``
    [(call, showers)]: the network's output against the reference network
    at the program's own inputs, each kept step of the sampler from the
    program's own state, the start against the start noise, and the showers
    against the inverse preprocessing of the program's last step."""
    if traffic["sampler"] != "DDim":
        raise NotImplementedError(f"the reference samples with DDim, not {traffic['sampler']}")
    n = traffic["steps"]
    sigma_tab, coeff = ref.ddim_tables(n)
    rows = capture.rows
    B = len(conds[0][0])
    out = {}
    with float32_exact(), torch.no_grad():
        den = ref.Denoiser(config, inputs.make_weights(config, seed, device))

        def sig(i):
            return torch.full((len(rows), 1, 1, 1, 1), float(sigma_tab[i]), device=device)

        for call, showers in outputs:
            caps = capture.store[call]
            E, L = conds[call % len(conds)]
            E = E[rows]
            L = L[rows] if den.layer_cond else None
            gaps = {"network": 0.0, "step": 0.0, "start": 0.0, "showers": 0.0}
            sq, count = 0.0, 0
            for s in sorted(caps):
                c = caps[s]
                c_skip, c_out, c_in = den.scalings(sig(s))
                x = c["x_in"] / c_in
                pred = den.network(c["x_in"], E, sig(s), L)
                sq += float((c["out"].double() - pred.double()).pow(2).sum())
                count += pred.numel()
                if s == 0:
                    start = inputs.start_noise(config, B, seed, call, device)[rows]
                    gaps["start"] = rel_rows(x, start * float(sigma_tab[0])).max()
                x0 = c_skip * x + c_out * c["out"]
                x_next = x0 + float(coeff[s]) * ((x - x0) / sig(s))
                if s + 1 in caps:
                    want = caps[s + 1]["x_in"] / den.scalings(sig(s + 1))[2]
                    gaps["step"] = max(gaps["step"], rel_rows(x_next, want).max())
                if s == n - 1:
                    final = ref.reverse_norm(x_next.cpu().numpy(), E.cpu().numpy(), config,
                                             None if L is None else L.cpu().numpy())
                    gaps["showers"] = rel_l2(showers[rows], final).max()
            gaps["network"] = (sq / count) ** 0.5
            out[call] = {k: float(v) for k, v in gaps.items()}
    return out


def check_generation(config, traffic, seed, outputs, capture, conds, device, limits):
    """({"gap": the widest gap of any stage and call}, calls failed, the
    widest gap by stage)."""
    B = len(conds[0][0])
    voxels = int(np.prod(config["SHAPE_ORIG"][1:]))
    bad = {c for c, s in outputs
           if s.shape != (B, voxels) or not np.isfinite(s).all() or (s < 0).any()}
    if not outputs:
        return {"gap": math.inf}, 1, {}
    gaps = generation_gaps(config, traffic, seed, outputs, capture, conds, device)
    bad |= {c for c, g in gaps.items() if not call_gap(g) <= limits["gap"]}
    stages = {k: max(g[k] for g in gaps.values()) for k in next(iter(gaps.values()))}
    return {"gap": max(call_gap(g) for g in gaps.values())}, len(bad), stages


def call_gap(stages: dict) -> float:
    """A call's compared gap: the widest of its stages."""
    return max(stages.values())


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def reference_training(config, seed, data, conds, device, steps: int = 3,
                       fake_quant=identity, rows=None, states=None) -> dict:
    """The reference's first ``steps`` steps from the benchmark's weights,
    on the run's batches and sigma and noise draws: {"losses", "grads"
    (leaf -> gradient, a dict a step), "grad1" (the first), "states" (the
    parameters before each step), "after" (after the steps)}.  With
    ``states`` each step's gradient is taken at ``states[i]``, another
    side's parameters before its step i, and nothing is updated.  ``rows``:
    the loss over the first ``rows`` of each batch only (a fault the check
    must catch)."""
    n = len(conds)
    layer_cond = "layer" in config.get("SHOWERMAP", "")
    out = {"losses": [], "grads": [], "states": []}
    w0 = inputs.make_weights(config, seed, device)
    with float32_exact():
        params = {k: v.requires_grad_(True) for k, v in w0.items()}
        gen = inputs.generator(seed, inputs.TRAIN_DRAWS, device=device)
        adam = ref.Adam(params, float(config["LR"]))
        keys = list(params)
        for i in range(steps):
            if states is not None:
                params = {k: states[i][k].detach().float().clone().requires_grad_(True)
                          for k in keys}
            den = ref.Denoiser(config, params, fake_quant)
            E, L = conds[i % n]
            x = data[i % n]
            sigma, noise = ref.draw_sigma_noise(config, gen, x.shape)
            take = slice(None) if rows is None else slice(0, rows)
            loss = ref.hybrid_loss(den, x[take], E[take],
                                   L[take] if layer_cond else None, sigma[take], noise[take])
            grads = dict(zip(keys, torch.autograd.grad(loss, [params[k] for k in keys])))
            out["losses"].append(float(loss.detach()))
            out["grads"].append({k: g.detach() for k, g in grads.items()})
            out["states"].append({k: v.detach().clone() for k, v in params.items()})
            if states is None:
                adam.step(grads)
            del loss, grads, den
    out["grad1"] = out["grads"][0]
    out["after"] = {k: v.detach() for k, v in params.items()}
    return out


def adam_after(config, seed, grads: list, device) -> dict:
    """The parameters after the reference's Adam from the benchmark's
    weights over the gradients ``grads`` (a dict a step)."""
    params = inputs.make_weights(config, seed, device)
    adam = ref.Adam(params, float(config["LR"]))
    for g in grads:
        adam.step(g)
    return params


def _norm(t) -> float:
    return float(t.double().norm())


def rel_diff(got: dict, want: dict, keys=None) -> float:
    """||got - want|| / ||want|| over the leaves ``keys`` together."""
    keys = list(want) if keys is None else keys
    num = sum(_norm(got[k] - want[k]) ** 2 for k in keys)
    den = sum(_norm(want[k]) ** 2 for k in keys)
    return float((num / den) ** 0.5) if den > 0 else math.inf


def moved_leaves(grad1: dict) -> list:
    """The leaves whose reference gradient is at least ``LEAF_FLOOR`` of the
    median leaf's: Adam moves the others by round-off."""
    keys = list(grad1)
    norms = np.array([_norm(grad1[k]) for k in keys])
    return [k for k, g in zip(keys, norms) if g >= LEAF_FLOOR * np.median(norms)]


def compare_training(config, seed, program: dict, at_state: dict, device) -> dict:
    """The numbers of a training check (module docstring).  ``program``:
    its losses, "grad1" (from the optimizer's state), "grads" (each checked
    step's, as the optimizer got them) and "after"; ``at_state``: the
    reference at the program's parameters before each step."""
    w0 = inputs.make_weights(config, seed, device)
    keys = list(at_state["grad1"])
    steps = len(program["grads"])
    # the three steps' gradients together, the first from the optimizer's state
    got = [program["grad1"]] + program["grads"][1:]
    num = sum(_norm(got[i][k] - at_state["grads"][i][k]) ** 2
              for i in range(steps) for k in keys)
    den = sum(_norm(at_state["grads"][i][k]) ** 2 for i in range(steps) for k in keys)
    adam = adam_after(config, seed, program["grads"], device)
    moved = moved_leaves(at_state["grad1"])
    lp, lr = program["losses"][0], at_state["losses"][0]
    return {"grad3_diff": float((num / den) ** 0.5) if den > 0 else math.inf,
            "update3_diff": rel_diff({k: program["after"][k] - w0[k] for k in moved},
                                     {k: adam[k] - w0[k] for k in moved}),
            "grad1_diff": rel_diff(program["grad1"], at_state["grad1"]),
            "grad_state_diff": max((rel_diff(program["grads"][i], at_state["grads"][i])
                                    for i in range(1, steps)), default=0.0),
            "loss1_rel": abs(lp - lr) / abs(lr) if lr != 0 else math.inf}


def loss_gaps(program: dict, reference: dict) -> list:
    """Each checked step's relative loss gap."""
    return [abs(a - b) / abs(b) for a, b in zip(program["losses"], reference["losses"])]


def check_training(config, traffic, seed, program, data, conds, device) -> dict:
    at_state = reference_training(config, seed, data, conds, device, traffic["checked_steps"],
                                  states=program["states"])
    return compare_training(config, seed, program, at_state, device)
