"""``calodif-inference`` CLI on PyTorch (port of ``calodiffusion_tpu/inference.py``).

    python -m calodiffusion_tpu_torch.inference -c config.json -d DATA/ \\
        sample --model-loc CKPT/final.ckpt -g gen.h5 diffusion
    python -m calodiffusion_tpu_torch.inference -c config.json -d DATA/ plot -g gen.h5

``sample diffusion`` generates showers with any of the 16 registered
samplers (``--sample-algo``), ``sample layer --layer-model CKPT`` through
the two-stage cascade (the layer energies sampled first, then the showers
on them; ``--model-loc`` holds the base U-Net), and each writes
reference-compatible HDF5 (gzip ``showers`` + ``incident_energies``, or
HGCal's ``gen_info``); ``plot`` runs the histogram/separation-power
evaluation suite (HGCal's ring, R and phi profiles with ``--hgcal`` or the
config's ``HGCAL``).  HGCal's ``--sparse-decoding`` (``--sparse-per-batch``)
draws the decode's cells from a numpy Generator seeded from ``--seed``.  The flags,
subcommands and defaults are the JAX CLI's, in argparse; ``--device``
(default ``cuda``) is the port's own: ``--device cpu`` runs on the CPU.
Sampling draws from a ``torch.Generator`` on the model's device seeded from
``--seed``, so its showers differ from the JAX package's for one seed.

``h5py`` and ``matplotlib`` are imported only by the functions that read
or write h5 or draw (``--debug``'s trajectory plots among them), so
sampling from npz caches needs neither.

``--int8`` (config ``QUANT_INT8``) samples with the U-Net's convolutions
in W8A8 int8, ``sample … diffusion`` and ``sample … layer`` alike
(``ops/quant.py``; the calibration on the first batch's conditioning, the
convolutions on Q1 on the card and on its plain version with ``--device
cpu``); ``QUANT_INT8_EXCLUDE`` keeps the convs it names in float.
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime

import numpy as np

from calodiffusion_tpu_torch.utils.config import LoadJson, dotdict


class _Multiple(argparse.Action):
    """click's ``multiple=True``: each use appends, and the first replaces
    the default."""

    def __call__(self, parser, namespace, values, option_string=None):
        current = getattr(namespace, self.dest)
        current = [] if current is self.default else current
        setattr(namespace, self.dest, current + [values])


def _flag_pair(parser, on: str, off: str, dest: str, default, help: str = ""):
    """click's ``--on/--off`` boolean pair."""
    parser.add_argument(on, dest=dest, action="store_true", default=default, help=help)
    parser.add_argument(off, dest=dest, action="store_false", default=default)


def inference_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="calodif-inference", description=__doc__.split("\n")[0])
    parser.add_argument("-c", "--config", default=None)
    parser.add_argument("-d", "--data-folder", dest="data_folder", default="./data/",
                        help="Folder containing data and MC files")
    parser.add_argument("--checkpoint-folder", dest="checkpoint_folder",
                        default="./trained_models/", help="Folder to save checkpoints")
    parser.add_argument("-n", "--n-events", dest="nevts", type=int, default=-1,
                        help="Number of events to load")
    parser.add_argument("--job-idx", dest="job_idx", type=int, default=-1,
                        help="Split generation among different jobs")
    _flag_pair(parser, "--layer-only", "--no-layer", "layer_only", False,
               "Only sample layer energies")
    parser.add_argument("--reclean", action=argparse.BooleanOptionalAction, default=False,
                        help="Redo preprocessing on loaded sample")
    parser.add_argument("--debug", action=argparse.BooleanOptionalAction, default=False,
                        help="Debugging options")
    parser.add_argument("--hgcal", action=argparse.BooleanOptionalAction, default=None,
                        help="Use HGCal settings (overwrites config)")
    parser.add_argument("--seed", type=int, default=None,
                        help="Set a manual seed (saved in config)")
    parser.add_argument("--device", default="cuda",
                        help="Torch device to run on (cpu for the CPU)")
    commands = parser.add_subparsers(dest="command", required=True)

    sample = commands.add_parser("sample")
    sample.add_argument("-g", "--generated", default="",
                        help="Path for generated shower results")
    sample.add_argument("--sample-file", dest="sample_file", default="",
                        help="File of showers to generate (override config)")
    sample.add_argument("--sample-steps", dest="sample_steps", type=int, default=200,
                        help="How many steps for sampling (override config)")
    sample.add_argument("--sample-offset", dest="sample_offset", type=int, default=0,
                        help="Skip some iterations in the sampling")
    sample.add_argument("--sample-algo", dest="sample_algo", default="DDim",
                        help="Algorithm for sampling the model output")
    sample.add_argument("--sparse-decoding", dest="sparse_decoding", action="store_true",
                        default=False, help="Sampling during HGCal decoding step")
    sample.add_argument("--sparse-per-batch", dest="sparse_per_batch", action="store_true",
                        default=False, help="Sparsity sampling once per batch")
    sample.add_argument("--batch-size", dest="batch_size", type=int, default=-1,
                        help="Set sampling batch size")
    sample.add_argument("--train-sampler", dest="train_sampler",
                        action=argparse.BooleanOptionalAction, default=None,
                        help="For samplers requiring pre-training, train them")
    sample.add_argument("--model-loc", dest="model_loc", default=None,
                        help="Specific folder for loading existing model")
    sample.add_argument("--int8", action=argparse.BooleanOptionalAction, default=None,
                        help="W8A8 int8 sampling (config QUANT_INT8)")
    models = sample.add_subparsers(dest="model", required=True)
    models.add_parser("diffusion")
    layer = models.add_parser("layer")
    layer.add_argument("--layer-model", dest="layer_model", required=True)

    plot = commands.add_parser("plot")
    plot.add_argument("-g", "--generated", default="",
                      help="Path to existing generated results")
    plot.add_argument("--plot-label", dest="plot_label", default="", help="Labels for the plot")
    plot.add_argument("--plot-folder", dest="plot_folder", default="./plots",
                      help="Folder to save results")
    plot.add_argument("--plot-reshape", dest="plot_reshape",
                      action=argparse.BooleanOptionalAction, default=False,
                      help="Plot the embedded space")
    plot.add_argument("-e", "--extension", action=_Multiple, default=["png"],
                      help="Types of files to save under.")
    plot.add_argument("--cms", action=argparse.BooleanOptionalAction, default=False,
                      help="Use the CMS plotting style")
    plot.add_argument("--energy-min", dest="EMin", type=float, default=-1.0,
                      help="Min cell energy threshold")
    plot.add_argument("--geant-only", dest="geant_only", action="store_true", default=False,
                      help="Plots only of geant distribution")
    return parser


def parse_flags(argv=None) -> dotdict:
    """The flags of one command line, as the JAX CLI's context object holds
    them, with the config loaded into ``flags.config`` (and the sample
    options written into it as the JAX CLI writes them)."""
    args = inference_parser().parse_args(argv)
    flags = dotdict(vars(args))
    flags.config = LoadJson(args.config) if args.config is not None else {}
    config = flags.config

    # quirk preserved: the seed defaults to a random draw stored into the
    # config (reference inference.py:48-52)
    if flags.seed is None:
        flags.seed = int(np.random.default_rng().integers(low=100, high=10**5))
    config["SEED"] = int(flags.seed)
    if flags.hgcal is not None:
        config["HGCAL"] = flags.hgcal
    else:
        flags.hgcal = config.get("HGCAL", False)

    if args.command == "sample":
        config["SAMPLER"] = flags.sample_algo
        if flags.int8 is not None:
            config["QUANT_INT8"] = flags.int8
        config.setdefault("SAMPLER_OPTIONS", {})
        if flags.train_sampler is not None:
            config["SAMPLER_OPTIONS"]["TRAIN_SAMPLER"] = flags.train_sampler
        if len(flags.sample_file) > 0:
            config["EVAL"] = flags.sample_file
        if flags.model_loc is None:
            raise ValueError("model-loc is required")
        config["flags"] = dotdict({k: v for k, v in flags.items() if k != "config"})
    else:
        flags.plot_extensions = flags.pop("extension")
    return flags


def main(argv=None):
    """Run one command line; returns the generated file (``sample``) or the
    plots' separation powers (``plot``)."""
    flags = parse_flags(argv)
    if flags.command == "sample":
        return run_inference(flags, flags.config)
    data_dict, energies = process_data_dict(flags, config=flags.config)
    return plot_results(flags, flags.config, data_dict, energies)


def name_translate(generated_file_path: str) -> str:
    try:
        return generated_file_path.split("/")[-2].split("_")[-1]
    except IndexError:
        return "generated"


def process_data_dict(flags, config):
    """Load generated + Geant4 reference samples (reference :137-203)."""
    from calodiffusion_tpu_torch.data.loader import get_files
    from calodiffusion_tpu_torch.utils.geom import GeomConverter
    from calodiffusion_tpu_torch.utils.xml_handler import XMLHandler

    dataset_num = config.get("DATASET_NUM", 2)

    NN_embed = None
    if flags.hgcal:
        if flags.plot_reshape:  # the geometric GLaM (the JAX CLI's init())
            from calodiffusion_tpu_torch.utils import hgcal_utils

            NN_embed = hgcal_utils.cached_converter(config, norm=False, device=flags.device)
    elif dataset_num <= 1:
        bins = XMLHandler(config["PART_TYPE"], config["BIN_FILE"])
        NN_embed = GeomConverter(bins)

    generated = energy = None
    if not flags.geant_only:
        for f_sample in get_files(flags.generated):
            gen, en = LoadSamples(f_sample, flags, config, NN_embed=NN_embed)
            if generated is None:
                generated, energy = gen, en
            else:
                generated = np.concatenate((generated, gen), axis=0)
                energy = np.concatenate((energy, en), axis=0)
            if flags.nevts > 0 and generated.shape[0] >= flags.nevts:
                break

    # --job-idx: Geant4 eval files are read at the matching event offset so
    # job i compares its generated slice against the same Geant events
    job_idx = getattr(flags, "job_idx", -1)
    evt_start = 0
    if job_idx is not None and job_idx >= 0:
        if flags.nevts <= 0:
            raise ValueError("--job-idx requires a positive --n-events")
        evt_start = job_idx * flags.nevts

    data, energies = [], []
    eval_files = get_files(config["EVAL"], folder=flags.data_folder)
    for dataset in eval_files:
        if evt_start > 0:
            import h5py

            with h5py.File(dataset, "r") as h5f:
                raw_nevts = h5f["showers"].shape[0]
            if evt_start >= raw_nevts:
                evt_start -= raw_nevts
                continue
        showers, en = LoadSamples(
            dataset, flags, config, NN_embed=NN_embed, evt_start=evt_start
        )
        evt_start = 0
        data.append(showers)
        energies.append(en)
        if sum(d.shape[0] for d in data) >= flags.nevts > 0:
            break
    if not data:
        raise ValueError(
            "No Evaluation Data passed, please change the `EVAL` field of the config"
        )
    energies = np.concatenate(energies)
    data = np.concatenate(data)
    if flags.nevts > 0:
        energies = energies[: flags.nevts]
        data = data[: flags.nevts]
        if generated is not None:
            generated = generated[: flags.nevts]

    data_dict = {"Geant4": data}
    if not flags.geant_only:
        data_dict[name_translate(flags.generated)] = generated
    return data_dict, energies


def LoadSamples(fp, flags, config, NN_embed=None, evt_start=0):
    """Load one generated/reference h5 (reference :257-297).

    ``evt_start`` slices Geant4 eval files for job-array sharding.  NOTE
    the 0.001 default here intentionally differs from the loader's 200.0:
    it matches the reference site-for-site (inference.py:260 vs
    utils.py:871); both generated and Geant files get the same factor so
    histogram comparisons are unaffected (see PARITY.md).
    """
    import h5py

    end = None if flags.nevts < 0 else evt_start + flags.nevts
    shower_scale = config.get("SHOWERSCALE", 0.001)

    if config.get("DATASET_NUM", 2) <= 1:
        flags.plot_reshape = True

    if (not flags.hgcal) or flags.plot_reshape:
        shape_plot = config["SHAPE_FINAL"]
    else:
        shape_plot = config["SHAPE_PAD"]

    with h5py.File(fp, "r") as h5f:
        if flags.hgcal:
            generated = (
                h5f["showers"][evt_start:end, :, : config["MAX_CELLS"]]
                * shower_scale
            )
            energies = h5f["gen_info"][evt_start:end, 0]
        else:
            generated = h5f["showers"][evt_start:end] * shower_scale
            energies = h5f["incident_energies"][evt_start:end] * shower_scale

    energies = np.reshape(energies, (-1, 1))
    if flags.plot_reshape:
        if config.get("DATASET_NUM", 2) <= 1:
            generated = NN_embed.convert(NN_embed.reshape(generated))
        elif flags.hgcal:  # the GLaM grid, encoded on --device
            generated = np.asarray(generated, np.float32).reshape(config["SHAPE_PAD"])
            generated = NN_embed.enc_numpy(generated, device=flags.device)

    if flags.plot_reshape or not flags.hgcal:
        generated = np.reshape(generated, shape_plot)

    if flags.EMin > 0.0:
        from calodiffusion_tpu_torch.evaluation.metrics_utils import apply_mask_conserveE

        mask = generated < flags.EMin
        generated = apply_mask_conserveE(generated, mask)
    return generated, energies


def write_out(fout, flags, config, generated, energies, first_write=True,
              do_mask=False):
    """Write generated showers as reference-compatible HDF5 (reference :206-254)."""
    import h5py

    shower_embed = config.get("SHOWER_EMBED", "")
    orig_shape = "orig" in shower_embed
    dataset_num = config.get("DATASET_NUM", 2)

    if not orig_shape:
        generated = generated.reshape(config["SHAPE_ORIG"])
    energies = np.reshape(energies, (energies.shape[0], -1))

    hgcal = config.get("HGCAL", False)
    shower_scale = config.get("SHOWERSCALE", 200.0)

    if do_mask and dataset_num > 1:
        mask_file = os.path.join(
            flags.data_folder, config["EVAL"][0].replace(".hdf5", "_mask.hdf5")
        )
        if not os.path.exists(mask_file):
            mask = np.sum(generated, 0) == 0
        else:
            with h5py.File(mask_file, "r") as h5f:
                mask = h5f["mask"][:]
        generated = generated * (np.reshape(mask, (1, -1)) == 0)

    generated = np.reshape(generated, config["SHAPE_ORIG"])
    shape = list(config["SHAPE_ORIG"])
    shape[0] = None
    energy_key = "gen_info" if hgcal else "incident_energies"
    energy_data = energies if hgcal else (1.0 / shower_scale) * energies
    if first_write:
        print(f"Creating {fout}")
        with h5py.File(fout, "w") as h5f:
            h5f.create_dataset(
                "showers", data=(1.0 / shower_scale) * generated,
                compression="gzip", maxshape=shape, chunks=True,
            )
            h5f.create_dataset(
                energy_key, data=energy_data, compression="gzip",
                maxshape=(None, energies.shape[1]), chunks=True,
            )
    else:
        print(f"Appending to {fout}")
        with h5py.File(fout, "a") as h5f:
            _append_h5(h5f, "showers", (1.0 / shower_scale) * generated)
            _append_h5(h5f, energy_key, energy_data)


def _append_h5(f, name, data):
    prev = f[name].shape[0]
    f[name].resize(prev + data.shape[0], axis=0)
    f[name][prev:] = data


def plot_results(flags, config, data_dict, energies) -> dict:
    """Draw the CaloChallenge plot suite (reference :300-339); returns each
    plot's separation powers (``Plot.last_separations``) by plot name."""
    from calodiffusion_tpu_torch.evaluation import plots

    plot_routines = {
        "Energy per layer": plots.ELayer(flags, config),
        "Energy": plots.HistEtot(flags, config),
        "2D Energy scatter split": plots.ScatterESplit(flags, config),
        "Energy Ratio split": plots.HistERatio(flags, config),
        "Layer Sparsity": plots.SparsityLayer(flags, config),
    }
    if flags.hgcal and not flags.plot_reshape:
        plot_routines.update({
            "Energy R": plots.RadialEnergyHGCal(flags, config),
            "Energy R Center": plots.RCenterHGCal(flags, config),
            "Energy Phi Center": plots.PhiCenterHGCal(flags, config),
            "Nhits": plots.HistNhits(flags, config),
            "Max voxel": plots.HistMaxELayer(flags, config),
            "VoxelE": plots.HistVoxelE(flags, config),
        })
    elif not flags.layer_only:
        plot_routines.update({
            "Nhits": plots.HistNhits(flags, config),
            "VoxelE": plots.HistVoxelE(flags, config),
            "Shower width": plots.AverageShowerWidth(flags, config),
            "Max voxel": plots.HistMaxELayer(flags, config),
            "Energy per radius": plots.AverageER(flags, config),
            "Energy per phi": plots.AverageEPhi(flags, config),
        })
    if (not config["CYLINDRICAL"]) and (
        config["SHAPE_PAD"][-1] == config["SHAPE_PAD"][-2]
    ):
        plot_routines["2D average shower"] = plots.Plot_Shower_2D(flags, config)

    for plotting_method in plot_routines.values():
        plotting_method(data_dict, energies)
    return {name: dict(p.last_separations) for name, p in plot_routines.items()}


def generate_showers(flags, config):
    """Sample the EVAL set with a trained model (reference :342-365, up to
    the write): loads the data and the weights, generates, and returns
    ``(generated, energies, fout)``, ``fout`` the file ``write_out`` is to
    write.  ``sample layer`` loads the cascade through
    ``TrainLayerModel(inference=True)`` (JAX inference.py:122-133)."""
    import torch

    from calodiffusion_tpu_torch.data.loader import load_data
    from calodiffusion_tpu_torch.samplers import get_sampler
    from calodiffusion_tpu_torch.train.train_layer_model import TrainLayerModel
    from calodiffusion_tpu_torch.train.trainer import TrainDiffusion

    get_sampler(flags.sample_algo)  # an unknown name raises before anything loads

    data_loader, _ = load_data(flags, config, eval=True)
    if flags.model == "layer":
        config["layer_model"] = flags.layer_model
        trainer = TrainLayerModel(flags, config, load_data=False, inference=True,
                                  device=flags.device)
    else:
        trainer = TrainDiffusion(flags, config, load_data=False, device=flags.device)
    trainer.init_model()
    model = trainer.load_for_inference()

    sample_steps = (
        flags.sample_steps
        if flags.sample_steps is not None
        else config.get("SAMPLE_STEPS", 400)
    )
    if flags.generated == "":
        fout = (
            f"{trainer.checkpoint_folder}/generated_{config['CHECKPOINT_NAME']}_"
            f"{flags.sample_algo}{sample_steps}_{datetime.now().timestamp()}.h5"
        )
    else:
        fout = flags.generated

    generator = torch.Generator(device=model.device).manual_seed(int(flags.seed))
    generated, energies = model.generate(
        data_loader, sample_steps, generator=generator,
        sample_offset=flags.sample_offset, debug=flags.debug,
        sparse_decoding=flags.sparse_decoding, sparse_per_batch=flags.sparse_per_batch,
        rng=np.random.default_rng(int(flags.seed)),
    )
    return generated, energies, fout


def run_inference(flags, config):
    """Generate the EVAL set's showers and write them to h5; returns the file."""
    generated, energies, fout = generate_showers(flags, config)
    write_out(fout, flags, config, generated, energies, first_write=True)
    return fout


if __name__ == "__main__":
    main()
