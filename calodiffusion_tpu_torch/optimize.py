"""Optimization CLI on PyTorch (port of ``calodiffusion_tpu/optimize.py``).

    python -m calodiffusion_tpu_torch.optimize -c config.json -o COUNT FPD \\
        --model diffusion --n-trials 20

The JAX CLI's flags and defaults, plus ``--device`` (default ``cuda``;
``--device cpu`` trains and scores on the CPU).  ``--model diffusion|layer``
trains with the port's ``TrainDiffusion`` or ``TrainLayerModel``; the
report lands in ``{results_folder}/{study_name}_report.json``.
"""

from __future__ import annotations

import argparse

from calodiffusion_tpu_torch.train.optimize import Optimize
from calodiffusion_tpu_torch.utils.config import LoadJson, dotdict


def optimize_parser():
    parser = argparse.ArgumentParser(prog="calodif-optimize", description=__doc__.split("\n")[0])
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("-d", "--data-folder", dest="data_folder",
                        default="./data/")
    parser.add_argument("-o", "--objectives", nargs="+", default=["COUNT"],
                        choices=["COUNT", "FPD", "CNN"])
    parser.add_argument("--model", default="diffusion",
                        choices=["diffusion", "layer"])
    parser.add_argument("--study-name", dest="study_name", default="optimize")
    parser.add_argument("--n-trials", dest="n_trials", type=int, default=10)
    parser.add_argument("--timeout", type=float, default=None,
                        help="Total study wall-clock budget in seconds "
                             "(default: unlimited)")
    parser.add_argument("--results-folder", dest="results_folder",
                        default="./optimization_results")
    parser.add_argument("-n", "--nevts", type=int, default=-1)
    parser.add_argument("--checkpoint", dest="checkpoint_folder",
                        default="./trained_models/")
    parser.add_argument("--device", default="cuda",
                        help="Torch device to train and score on (cpu for the CPU)")
    return parser


def optimize(args=None):
    """Run one command line; returns the study."""
    parsed = optimize_parser().parse_args(args)
    flags = dotdict(vars(parsed))
    flags.config = LoadJson(flags.config)
    flags.load = False
    flags.reclean = False
    flags.reset_training = False
    flags.seed = 1234

    from calodiffusion_tpu_torch.train.train_layer_model import TrainLayerModel
    from calodiffusion_tpu_torch.train.trainer import TrainDiffusion

    trainers = {"diffusion": TrainDiffusion, "layer": TrainLayerModel}
    return Optimize(flags, trainers[flags.model], flags.objectives)()


if __name__ == "__main__":
    optimize()
