"""``calodif-train`` CLI on PyTorch (port of ``calodiffusion_tpu/training.py``).

    python -m calodiffusion_tpu_torch.training -c config.json -d DATA/ \\
        --checkpoint CKPT diffusion

The JAX CLI's group flags, defaults and subcommands, in argparse, plus
``--device`` (default ``cuda``; ``--device cpu`` trains on the CPU).  The
checkpoints land in ``<checkpoint>/<CHECKPOINT_NAME>_<Diffusion|LayerModel|
Distillation>/`` as the JAX trainers name them (``checkpoint``,
``best_val`` and ``final`` ``.ckpt``, ``torch.save`` files).

    ... layer [--layer-model-loc CKPT]    the cascade's layer-energy model
    ... distill --teacher-loc CKPT        consistency distillation

Under ``torchrun`` (``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` set) the
command joins the process group (NCCL on the card, each rank on
``cuda:LOCAL_RANK``; gloo with ``--device cpu``) and trains data-parallel
over every rank, as the JAX CLI trains over every local device:

    torchrun --nproc-per-node N -m calodiffusion_tpu_torch.training ...

It leaves the group at the end; a group the caller initialised stays.
"""

from __future__ import annotations

import argparse
import contextlib
import os

from calodiffusion_tpu_torch.utils.config import LoadJson, dotdict


def train_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="calodif-train", description=__doc__.split("\n")[0])
    parser.add_argument("-d", "--data-folder", dest="data_folder", default="../data/",
                        help="Folder containing data and MC files")
    parser.add_argument("-c", "--config", default="configs/test.json",
                        help="Config file with training parameters")
    parser.add_argument("--checkpoint", dest="checkpoint_folder", default="../models",
                        help="Folder with checkpoints")
    parser.add_argument("-n", "--nevts", type=int, default=-1, help="Number of events to load")
    parser.add_argument("--frac", type=float, default=0.85,
                        help="Fraction of total events used for training")
    parser.add_argument("--load", action="store_true", default=False,
                        help="Load pretrained weights to continue the training")
    parser.add_argument("--seed", type=int, default=1234, help="PRNG seed")
    parser.add_argument("--reclean", action=argparse.BooleanOptionalAction, default=False,
                        help="Reclean data")
    parser.add_argument("--reset_training", action="store_true", default=False,
                        help="Retrain")
    parser.add_argument("--hgcal", action=argparse.BooleanOptionalAction, default=None,
                        help="Use HGCal settings (overwrites config)")
    parser.add_argument("--model-loc", dest="model_loc", default=None,
                        help="Specify existing model to load")
    parser.add_argument("--device", default="cuda",
                        help="Torch device to train on (cpu for the CPU)")
    commands = parser.add_subparsers(dest="command", required=True)
    commands.add_parser("diffusion")
    distill = commands.add_parser("distill")
    distill.add_argument("--teacher-loc", dest="teacher_loc", default=None,
                         help="Trained diffusion checkpoint to distill from")
    layer = commands.add_parser("layer")
    layer.add_argument("--layer-model-loc", dest="layer_model_loc", default=None,
                       help="Specify existing layer model to load")
    return parser


@contextlib.contextmanager
def process_group(device: str):
    """The device this rank trains on, inside the process group that
    ``torchrun``'s environment names (joined here and left at the end);
    ``device`` itself where there is none or one is initialised already."""
    import torch
    import torch.distributed as dist

    if "RANK" not in os.environ or dist.is_initialized():
        yield device
        return
    card = torch.device(device).type == "cuda"
    if card:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if card else "gloo")
    try:
        yield device
    finally:
        dist.destroy_process_group()


def main(argv=None):
    """Run one command line; returns the trainer."""
    flags = dotdict(vars(train_parser().parse_args(argv)))
    with process_group(flags.device) as flags.device:
        return _train(flags)


def _train(flags):
    flags.config = LoadJson(flags.config)
    if flags.hgcal is not None:
        flags.config["HGCAL"] = flags.hgcal
    else:
        flags.hgcal = flags.config.get("HGCAL", False)

    if flags.command == "distill":
        from calodiffusion_tpu_torch.train.train_distill import TrainDistillation

        if flags.teacher_loc is not None:
            flags.config["TEACHER_LOC"] = flags.teacher_loc
        trainer = TrainDistillation(flags, flags.config, device=flags.device)
    elif flags.command == "layer":
        from calodiffusion_tpu_torch.train.train_layer_model import TrainLayerModel

        if flags.layer_model_loc is not None and flags.load:
            flags.config["layer_model"] = flags.layer_model_loc
        trainer = TrainLayerModel(flags, flags.config, device=flags.device)
    else:
        from calodiffusion_tpu_torch.train.trainer import TrainDiffusion

        trainer = TrainDiffusion(flags, flags.config, device=flags.device)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
