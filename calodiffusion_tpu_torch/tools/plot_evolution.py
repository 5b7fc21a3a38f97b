"""Sampler-evolution debug plots: the distribution of normalized voxels along
the reverse trajectory (the working equivalent of the reference's legacy
calodiffusion/tests/plot_evolution.py, driven by the samplers' debug mode).

The port's counterpart of ``calodiffusion_tpu/tools/plot_evolution.py``: a
trained port checkpoint, the first eval batch, ``CaloDiffusion.sample(...,
debug=True)`` from a seeded ``torch.Generator``; ``matplotlib`` is imported
when it runs.  ``--device cpu`` runs it on the CPU (else the card).

Usage:
  python -m calodiffusion_tpu_torch.tools.plot_evolution -c config.json \
      --model-loc CKPT/..._Diffusion/final.ckpt -d DATA -o ./plots
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def checkpoint_steps(n_steps: int) -> list[int]:
    """The trajectory steps drawn: the first, the quarters and the last."""
    return sorted(set([0, n_steps // 4, n_steps // 2, 3 * n_steps // 4, n_steps - 1]))


def main(argv=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import torch

    from calodiffusion_tpu_torch.data.loader import load_data
    from calodiffusion_tpu_torch.train.trainer import TrainDiffusion
    from calodiffusion_tpu_torch.utils.config import LoadJson, default_flags

    ap = argparse.ArgumentParser()
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("--model-loc", required=True)
    ap.add_argument("-d", "--data-folder", default="./data")
    ap.add_argument("-o", "--plot-folder", default="./plots")
    ap.add_argument("--sample-steps", type=int, default=50)
    ap.add_argument("--nevts", type=int, default=64)
    ap.add_argument("--device", default=None, help="cpu, or the card where unset")
    args = ap.parse_args(argv)

    config = LoadJson(args.config)
    flags = default_flags(
        data_folder=args.data_folder, model_loc=args.model_loc,
        nevts=args.nevts,
    )
    trainer = TrainDiffusion(flags, config, load_data=False, save_model=False,
                             device=args.device)
    model = trainer.load_for_inference()

    loader, _ = load_data(flags, config, eval=True, device=model.device)
    E, layers, data = next(iter(loader))

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=model.device)

    gen = torch.Generator(device=model.device).manual_seed(0)
    _, xs, x0s = model.sample(put(E), layers=put(layers) if model.layer_cond else None,
                              num_steps=args.sample_steps, generator=gen, debug=True)
    xs, x0s = xs.float().cpu().numpy(), x0s.float().cpu().numpy()

    os.makedirs(args.plot_folder, exist_ok=True)
    for j in checkpoint_steps(xs.shape[0]):
        fig = plt.figure(figsize=(8, 6))
        plt.hist(xs[j].reshape(-1), bins=40, density=True, histtype="step",
                 label=f"x (step {j})")
        plt.hist(x0s[j].reshape(-1), bins=40, density=True, histtype="step",
                 label=f"x0 pred (step {j})")
        plt.hist(np.asarray(data).reshape(-1), bins=40, density=True,
                 histtype="stepfilled", alpha=0.3, label="Geant4 (normed)")
        plt.xlabel("Normalized voxel value")
        plt.legend()
        fout = os.path.join(args.plot_folder, f"evolution_step{j}.png")
        fig.savefig(fout)
        plt.close(fig)
        print(f"wrote {fout}")


if __name__ == "__main__":
    main()
