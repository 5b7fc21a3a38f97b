"""Physics-fidelity evaluation suite: histograms + ratio panels +
separation power.

Same plot classes / output-file naming / separation-power printing as the
reference suite (reference: calodiffusion/utils/plots.py) so evaluation
workflows port unchanged.  In addition to printing, every plot records its
separation powers in ``Plot.last_separations`` so the benchmark harness can
gate throughput numbers on fidelity programmatically.

All math is host-side numpy on final physical-unit showers.

A copy of ``calodiffusion_tpu/evaluation/plots.py`` (the port imports
nothing of the JAX package), the HGCal plots and the shower-drawing helpers
among it.  ``matplotlib`` is imported when a plot is drawn, not with the
module, so the port imports where it is not installed.
"""

from __future__ import annotations

import copy
import math
import os
from abc import ABC, abstractmethod

import numpy as np

from calodiffusion_tpu_torch.evaluation.metrics_utils import (
    ang_center_spread,
    get_width,
    separation_power,
    weighted_mean,
)


def _pyplot():
    """pyplot on the Agg backend, imported at the first plot."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def name_translate(generated_file_path: str) -> str:
    try:
        return generated_file_path.split("/")[-2].split("_")[-1]
    except (IndexError, AttributeError):
        return "generated"


def _scalar_formatter():
    """A ScalarFormatter printing two decimals (the reference's
    ScalarFormatterClass)."""
    import matplotlib.ticker as mtick

    class ScalarFormatterClass(mtick.ScalarFormatter):
        def _set_format(self):
            self.format = "%1.2f"

    return ScalarFormatterClass(useMathText=True)


def apply_cms_style() -> None:
    """CMS publication style for ``--cms`` (reference utils/plots.py:157-160
    uses ``mplhep.style.CMS``).  mplhep is used when installed; otherwise an
    equivalent rcParams set (the core of hep.style.CMS) is applied so the
    flag works without the optional dependency."""
    import matplotlib

    try:  # pragma: no cover - mplhep not installed in the test image
        import mplhep as hep

        matplotlib.style.use(hep.style.CMS)
        return
    except Exception:
        pass
    matplotlib.rcParams.update(
        {
            "font.family": "sans-serif",
            "font.sans-serif": ["TeX Gyre Heros", "Helvetica", "Arial",
                                "DejaVu Sans"],
            "mathtext.fontset": "custom",
            "mathtext.default": "regular",
            "font.size": 26.0,
            "axes.labelsize": "medium",
            "axes.linewidth": 2,
            "axes.unicode_minus": False,
            "xtick.direction": "in",
            "ytick.direction": "in",
            "xtick.major.size": 12,
            "xtick.minor.size": 6,
            "xtick.major.width": 1.2,
            "ytick.major.size": 12,
            "ytick.minor.size": 6,
            "ytick.major.width": 1.2,
            "xtick.top": True,
            "ytick.right": True,
            "xtick.minor.visible": True,
            "ytick.minor.visible": True,
            "legend.frameon": False,
            "legend.fontsize": "small",
            "lines.linewidth": 2,
            "grid.alpha": 0.8,
        }
    )


def cms_header(ax) -> None:
    """'CMS Simulation Preliminary' header (reference: hep.cms.text)."""
    try:  # pragma: no cover
        import mplhep as hep

        hep.cms.text(ax=ax, text="Simulation Preliminary")
        return
    except Exception:
        pass
    ax.text(
        0.0, 1.005, "CMS", transform=ax.transAxes, fontsize=28,
        fontweight="bold", va="bottom", ha="left",
    )
    ax.text(
        0.16, 1.005, "Simulation Preliminary", transform=ax.transAxes,
        fontsize=21, fontstyle="italic", va="bottom", ha="left",
    )


class Plot(ABC):
    def __init__(self, flags, config) -> None:
        self.flags = flags
        self.config = config
        self.plt_exts = list(getattr(flags, "plot_extensions", None) or ["png"])
        self.axis_scales = ["", "_logy"]
        self.line_style = {
            "Geant4": "dotted",
            "Geant4 (CMSSW)": "dotted",
            "CaloDiffusion": "-",
            "HGCaloDiffusion": "-",
            "Avg Shower": "-",
        }
        self.colors = {
            "Geant4": "black",
            "Geant4 (CMSSW)": "black",
            "Avg Shower": "blue",
            "CaloDiffusion": "blue",
            "HGCaloDiffusion": "blue",
        }
        self.geant_key = "Geant4"
        self.hgcal = config.get("HGCAL", False)
        if (not self.hgcal) or getattr(flags, "plot_reshape", False):
            self.shape_plot = config["SHAPE_FINAL"]
        else:
            self.shape_plot = config["SHAPE_PAD"]
        self.last_separations: dict[str, float] = {}
        self.cms = bool(getattr(flags, "cms", False))
        if self.cms:
            apply_cms_style()

    # -- figure plumbing ---------------------------------------------------
    def save_names(self, plot_name) -> list[str]:
        plot_dir = os.path.join(
            getattr(self.flags, "plot_folder", "./plots"),
            self.config["CHECKPOINT_NAME"],
        )
        os.makedirs(plot_dir, exist_ok=True)
        gen = getattr(self.flags, "generated", "")
        return [
            os.path.join(
                plot_dir,
                f"{plot_name}_{name_translate(gen)}{axis_scale}.{ext}",
            )
            for ext in self.plt_exts
            for axis_scale in self.axis_scales
        ]

    def save_fig(self, name, fig, ax0) -> None:
        ax0.set_yscale("log" if "logy" in name else "linear")
        fig.savefig(name)
        _pyplot().close(fig)

    def SetGrid(self, ratio=True):
        from matplotlib import gridspec

        fig = _pyplot().figure(figsize=(9, 9))
        if ratio:
            gs = gridspec.GridSpec(2, 1, height_ratios=[3, 1])
            gs.update(wspace=0.025, hspace=0.1)
        else:
            gs = gridspec.GridSpec(1, 1)
        return fig, gs

    @staticmethod
    def SetFig(xlabel, ylabel):
        from matplotlib import gridspec

        plt = _pyplot()
        fig = plt.figure(figsize=(9, 9))
        gs = gridspec.GridSpec(1, 1)
        ax0 = plt.subplot(gs[0])
        ax0.yaxis.set_ticks_position("both")
        ax0.xaxis.set_ticks_position("both")
        ax0.tick_params(direction="in", which="both")
        plt.xlabel(xlabel, fontsize=24)
        plt.ylabel(ylabel, fontsize=24)
        ax0.minorticks_on()
        return fig, ax0

    def FormatFig(self, xlabel, ylabel, ax0):
        ax0.set_xlabel(xlabel)
        ax0.set_ylabel(ylabel, labelpad=10)

    # -- core histogram with ratio panel + separation power -----------------
    def _hist(
        self, feed_dict, xlabel="", ylabel="Arbitrary units",
        reference_name="Geant4", binning=None, label_loc="best", ratio=True,
        normalize=True, leg_font=24,
    ):
        if reference_name not in feed_dict:
            reference_name = list(feed_dict.keys())[0]

        plt = _pyplot()
        fig, gs = self.SetGrid(ratio)
        ax0 = plt.subplot(gs[0])
        ax1 = plt.subplot(gs[1], sharex=ax0) if ratio else None
        if self.cms:
            cms_header(ax0)

        if binning is None:
            ref = feed_dict[reference_name]
            binning = np.linspace(np.quantile(ref, 0.0), np.quantile(ref, 1), 10)
        xaxis = (np.asarray(binning[:-1]) + np.asarray(binning[1:])) / 2.0
        reference_hist, _ = np.histogram(
            feed_dict[reference_name], bins=binning, density=True
        )

        for plot in reversed(list(feed_dict.keys())):
            color = self.colors.get(plot, "blue")
            linestyle = self.line_style.get(plot, "-")
            if "Geant" in plot:
                dist, _, _ = ax0.hist(
                    feed_dict[plot], bins=binning, label=plot, density=True,
                    histtype="stepfilled", facecolor="silver", lw=2, alpha=1.0,
                )
            else:
                dist, _, _ = ax0.hist(
                    feed_dict[plot], bins=binning, label=plot,
                    linestyle=linestyle, color=color, density=True,
                    histtype="step", lw=4,
                )
            if getattr(self.flags, "plot_label", ""):
                ax0.set_title(self.flags.plot_label, fontsize=20, loc="right",
                              style="italic")
            if reference_name != plot and ratio:
                h_ratio = np.divide(dist, reference_hist + 1e-8)
                if len(binning) > 20:
                    ax1.plot(xaxis, h_ratio, color=color, linestyle="-", lw=4)
                else:
                    ax1.plot(xaxis, h_ratio, color=color, marker="o", ms=10, lw=0)
                sep = separation_power(dist, reference_hist, np.asarray(binning))
                self.last_separations[f"{xlabel}|{plot}"] = float(sep)
                print("Separation power for hist '%s' is %.4f" % (xlabel, sep))

        if ratio:
            self.FormatFig(xlabel="", ylabel=ylabel, ax0=ax0)
            ax1.set_ylabel("Ratio")
            ax1.set_xlabel(xlabel)
            ax1.axhline(y=1.0, color="black", linestyle="--", linewidth=1)
            ax1.set_ylim([0.5, 1.5])
        else:
            self.FormatFig(xlabel=xlabel, ylabel=ylabel, ax0=ax0)
        ax0.legend(loc=label_loc, fontsize=leg_font, ncol=1, facecolor="white",
                   framealpha=0.5, frameon=True)
        return fig, ax0

    def _plot(self, feed_dict, xlabel="", ylabel="", reference_name="Geant4",
              no_mean=False):
        if reference_name not in feed_dict:
            raise ValueError(
                f"Reference distribution {reference_name} not in {list(feed_dict)}"
            )
        plt = _pyplot()
        fig, gs = self.SetGrid()
        ax0 = plt.subplot(gs[0])
        ax1 = plt.subplot(gs[1], sharex=ax0)

        for plot in feed_dict:
            color = self.colors.get(plot, "blue")
            linestyle = self.line_style.get(plot, "-")
            if no_mean:
                d = feed_dict[plot]
                ref = feed_dict[reference_name]
            else:
                d = np.mean(feed_dict[plot], 0)
                ref = np.mean(feed_dict[reference_name], 0)
            ax0.plot(d, label=plot, linestyle=linestyle, color=color)
            if reference_name != plot:
                ax0.get_xaxis().set_visible(False)
                ax0.set_ymargin(0)
                ratio = np.divide(d, ref + 1e-8)
                ax1.axhline(y=1.0, color="black", linestyle="--", linewidth=2)
                ax1.plot(ratio, color=color, linestyle=linestyle)

        self.FormatFig(xlabel="", ylabel=ylabel, ax0=ax0)
        ax0.legend(loc="best", fontsize=24, ncol=1, facecolor="white",
                   framealpha=0.5, frameon=True)
        ax1.set_ylabel("Ratio")
        ax1.set_xlabel(xlabel)
        ax1.set_ylim([0.5, 1.5])
        return fig, ax0

    @abstractmethod
    def __call__(self, data_dict: dict[str, np.ndarray],
                 energies: np.ndarray) -> None:
        raise NotImplementedError


class HistERatio(Plot):
    """Deposited / generated energy ratio (reference plots.py:402-430)."""

    def __call__(self, data_dict, energies):
        feed_dict = {}
        for key in data_dict:
            dep = np.sum(data_dict[key].reshape(data_dict[key].shape[0], -1), -1)
            feed_dict[key] = dep / energies.reshape(-1)
        norm = np.mean(feed_dict[self.geant_key])
        for key in data_dict:
            feed_dict[key] /= norm
        binning = np.linspace(0.7, 1.3, 30)
        fig, ax0 = self._hist(
            feed_dict, xlabel="Dep. energy / Gen. energy", binning=binning,
            ratio=True,
        )
        for name in self.save_names("ERatio"):
            self.save_fig(name, fig, ax0)


class ScatterESplit(Plot):
    def __call__(self, data_dict, true_energies):
        fig, ax = self.SetFig("Gen. energy [GeV]", "Dep. energy [GeV]")
        for key in data_dict:
            x = true_energies[0:500]
            y = np.sum(data_dict[key].reshape(data_dict[key].shape[0], -1), -1)[0:500]
            ax.scatter(x, y, label=key)
        ax.set_yscale("log")
        ax.set_xscale("log")
        ax.legend(loc="best", fontsize=16, ncol=1)
        for name in self.save_names("ScatterES"):
            fig.savefig(name)
        _pyplot().close(fig)


class AverageShowerWidth(Plot):
    """Per-layer energy centroids and widths in r / alpha
    (reference plots.py:457-560)."""

    def __call__(self, data_dict, energies):
        def get_matrix(sizex, minval, maxval):
            binning = np.linspace(minval, maxval, sizex + 1)
            return (binning[:-1] + binning[1:]) / 2.0

        phi_matrix = get_matrix(self.shape_plot[3], -math.pi, math.pi)
        phi_matrix = phi_matrix.reshape(1, 1, -1)
        r_matrix = get_matrix(self.shape_plot[4], 0, self.shape_plot[4])
        r_matrix = r_matrix.reshape(1, 1, -1)

        def get_center(matrix, energies_, power=1):
            ec = energies_ * np.power(matrix, power)
            layerE = np.sum(
                energies_.reshape(energies_.shape[0], energies_.shape[1], -1), -1
            )
            totalE = np.sum(layerE, axis=-1, keepdims=True)
            layer_zero = layerE < (1e-6 * totalE)
            ec = ec.reshape(ec.shape[0], ec.shape[1], -1)
            ec = np.ma.divide(np.sum(ec, -1), layerE).filled(0)
            ec[layer_zero] = 0.0
            return ec

        fd_phi, fd_phi2, fd_r, fd_r2 = {}, {}, {}, {}
        for key, data in data_dict.items():
            phi_proj = np.sum(
                data.reshape(data.shape[0], self.shape_plot[2],
                             self.shape_plot[3], -1), axis=-1
            )
            r_proj = np.sum(
                data.reshape(data.shape[0], self.shape_plot[2],
                             self.shape_plot[4], -1), axis=-1
            )
            fd_phi[key], fd_phi2[key] = ang_center_spread(phi_matrix, phi_proj)
            fd_r[key] = get_center(r_matrix, r_proj)
            fd_r2[key] = get_width(fd_r[key], get_center(r_matrix, r_proj, 2))

        for fd, fname, ylabel in [
            (fd_r, "FCCREC", "r-center of energy"),
            (fd_phi, "FCCAlphaEC", "alpha-center of energy"),
            (fd_r2, "RW", "r-width"),
            (fd_phi2, "AlphaW", "alpha-width (radians)"),
        ]:
            fig, ax0 = self._plot(fd, xlabel="Layer number", ylabel=ylabel)
            for name in self.save_names(fname):
                self.save_fig(name, fig, ax0)


class ELayer(Plot):
    """Mean/std/nonzero-fraction of per-layer energy (reference :563-610)."""

    def __call__(self, data_dict, energies):
        def _preprocess(data):
            p = data.reshape(data.shape[0], self.shape_plot[2], -1)
            layer_sum = np.sum(p, axis=-1)
            totalE = np.sum(p, axis=(1, 2)).reshape(-1, 1)
            layer_mean = np.mean(layer_sum, 0)
            layer_std = np.std(layer_sum, 0) / layer_mean
            layer_nonzero = layer_sum > (1e-6 * totalE)
            return layer_mean, layer_std, layer_nonzero

        fd_avg, fd_std, fd_nonzero = {}, {}, {}
        for key in data_dict:
            fd_avg[key], fd_std[key], fd_nonzero[key] = _preprocess(data_dict[key])

        for fd, fname, ylabel, no_mean in [
            (fd_avg, "EnergyZ", "Mean dep. energy [GeV]", True),
            (fd_std, "StdEnergyZ", "Std. Dev. / Mean of energy [GeV]", True),
            (fd_nonzero, "NonZeroEnergyZ", "Freq. > $10^{-6}$ Total Energy", False),
        ]:
            fig, ax0 = self._plot(fd, xlabel="Layer number", ylabel=ylabel,
                                  no_mean=no_mean)
            for name in self.save_names(fname):
                self.save_fig(name, fig, ax0)


class AverageER(Plot):
    def __call__(self, data_dict, energies):
        feed_dict = {}
        for key, data in data_dict.items():
            p = np.transpose(data, (0, 4, 1, 2, 3))
            p = p.reshape(data.shape[0], self.shape_plot[4], -1)
            feed_dict[key] = np.sum(p, -1)
        fig, ax0 = self._plot(feed_dict, xlabel="R-bin", ylabel="Mean Energy [GeV]")
        for name in self.save_names("Energy_R"):
            self.save_fig(name, fig, ax0)


class AverageEPhi(Plot):
    def __call__(self, data_dict, energies):
        feed_dict = {}
        for key, data in data_dict.items():
            p = np.transpose(data, (0, 3, 1, 2, 4))
            p = p.reshape(data.shape[0], self.shape_plot[3], -1)
            feed_dict[key] = np.sum(p, -1)
        fig, ax0 = self._plot(feed_dict, xlabel="alpha-bin",
                              ylabel="Mean Energy [GeV]")
        for name in self.save_names("EnergyAlpha"):
            self.save_fig(name, fig, ax0)


class SparsityLayer(Plot):
    def __call__(self, data_dict, energies):
        def _preprocess(data):
            eps = 1e-6
            p = data.reshape(data.shape[0], self.shape_plot[2], -1)
            layer_sparsity = np.sum(p > eps, axis=-1) / p.shape[2]
            return np.mean(layer_sparsity, axis=0), np.std(layer_sparsity, axis=0)

        fd_avg, fd_std = {}, {}
        for key in data_dict:
            fd_avg[key], fd_std[key] = _preprocess(data_dict[key])
        for fd, fname, ylabel in [
            (fd_avg, "SparsityZ", "Mean sparsity"),
            (fd_std, "StdSparsityZ", "Std. dev. sparsity"),
        ]:
            fig, ax0 = self._plot(fd, xlabel="Layer number", ylabel=ylabel,
                                  no_mean=True)
            for name in self.save_names(fname):
                self.save_fig(name, fig, ax0)


class HistEtot(Plot):
    def __call__(self, data_dict, energies):
        feed_dict = {
            key: np.sum(data.reshape(data.shape[0], -1), -1)
            for key, data in data_dict.items()
        }
        ref = feed_dict[self.geant_key]
        binning = np.geomspace(
            np.quantile(ref[ref > 0.0], 0.01), np.quantile(ref, 1.0), 20
        )
        fig, ax0 = self._hist(feed_dict, xlabel="Deposited energy [GeV]",
                              binning=binning)
        ax0.set_xscale("log")
        for name in self.save_names("TotalE"):
            self.save_fig(name, fig, ax0)


class HistNhits(Plot):
    def __call__(self, data_dict, energies):
        min_voxel = 1e-3  # 1 MeV
        feed_dict = {
            key: np.sum(data.reshape(data.shape[0], -1) > min_voxel, -1)
            for key, data in data_dict.items()
        }
        vmax = max(np.max(v) for v in feed_dict.values())
        binning = np.linspace(np.min(feed_dict[self.geant_key]), vmax, 20)
        fig, ax0 = self._hist(
            feed_dict, xlabel="Number of hits (> 1 MeV)",
            label_loc="upper right", binning=binning, ratio=True,
        )
        fmt = _scalar_formatter()
        fmt.set_powerlimits((0, 0))
        ax0.yaxis.set_major_formatter(fmt)
        for name in self.save_names("Nhits"):
            self.save_fig(name, fig, ax0)


class HistVoxelE(Plot):
    def __call__(self, data_dict, energies):
        nShowers = 1000
        feed_dict = {
            key: data[: min(nShowers, data.shape[0])].reshape(-1)
            for key, data in data_dict.items()
        }
        vmax = max(np.max(v) for v in feed_dict.values())
        ref = feed_dict[self.geant_key]
        vmin = np.amin(ref[ref > 0])
        binning = np.geomspace(vmin, vmax, 50)
        fig, ax0 = self._hist(
            feed_dict, xlabel="Voxel Energy [GeV]", binning=binning,
            ratio=True, normalize=False,
        )
        ax0.set_xscale("log")
        for name in self.save_names("VoxelE"):
            self.save_fig(name, fig, ax0)


class HistMaxELayer(Plot):
    def __call__(self, data_dict, energies):
        feed_dict = {}
        for key, data in data_dict.items():
            p = data.reshape(data.shape[0], self.shape_plot[2], -1)
            feed_dict[key] = np.ma.divide(
                np.max(p, -1), np.sum(p, -1)
            ).filled(0)
        fig, ax0 = self._plot(feed_dict, xlabel="Layer number",
                              ylabel="Max voxel/Dep. energy")
        for name in self.save_names("MaxEnergyZ"):
            self.save_fig(name, fig, ax0)


class HistMaxE(Plot):
    def __call__(self, data_dict, energies):
        feed_dict = {}
        for key, data in data_dict.items():
            p = data.reshape(data.shape[0], -1)
            feed_dict[key] = np.ma.divide(np.max(p, -1), np.sum(p, -1)).filled(0)
        binning = np.linspace(0, 1, 10)
        fig, ax0 = self._hist(feed_dict, xlabel="Max. voxel/Dep. energy",
                              binning=binning)
        for name in self.save_names("MaxEnergy"):
            self.save_fig(name, fig, ax0)


class Plot_Shower_2D(Plot):
    """2D average/example shower images for square cartesian grids
    (reference :1026-1090)."""

    layer_number = (10, 44)

    def plot_shower(self, shower, fout="", title="", vmax=0, vmin=0):
        plt = _pyplot()
        cmap = copy.copy(plt.get_cmap("viridis"))
        cmap.set_bad("white")
        shower = np.array(shower, dtype=np.float64)
        shower[shower == 0] = np.nan
        fig, ax = self.SetFig("x-bin", "y-bin")
        if vmax == 0:
            vmax = np.nanmax(shower)
            vmin = np.nanmin(shower)
        im = ax.pcolormesh(
            range(shower.shape[0]), range(shower.shape[1]),
            shower.reshape(shower.shape[0], shower.shape[1], -1)[:, :, 0],
            cmap=cmap, vmin=vmin, vmax=vmax,
        )
        fig.colorbar(im, ax=ax, label="Dep. energy [GeV]")
        ax.set_title(title, fontsize=15)
        if fout:
            fig.savefig(fout)
        plt.close(fig)
        return vmax, vmin

    def __call__(self, data_dict, energies):
        for layer in self.layer_number:
            vmin = vmax = 0
            for key in data_dict:
                data = data_dict[key].reshape(self.shape_plot)
                if layer >= data.shape[2]:
                    continue
                average = np.mean(data[:, 0, layer], 0)
                fout_avg = self.save_names(f"{key}2D_{layer}")[0]
                self.plot_shower(
                    average, fout=fout_avg,
                    title=f"{key}, layer number {layer}",
                )
                for i in range(min(5, data.shape[0])):
                    shower = data[i, 0, layer]
                    fout_ex = self.save_names(f"{key}2D_{layer}_shower{i}")[0]
                    vmax, vmin = self.plot_shower(
                        shower, fout=fout_ex,
                        title=f"{key} Shower {i}, layer number {layer}",
                        vmax=vmax, vmin=vmin,
                    )


class RadialEnergyHGCal(Plot):
    """HGCal ring-energy profile (reference :716-741)."""

    def __call__(self, data_dict, energies):
        from calodiffusion_tpu_torch.utils import hgcal_utils

        geom = hgcal_utils.load_geom(self.config.get("BIN_FILE", ""))
        r_vals = geom.ring_map[:, : geom.max_ncell]
        feed_dict = {}
        for key in data_dict:
            nrings = int(np.max(geom.nrings))
            r_bins = np.zeros((data_dict[key].shape[0], nrings))
            for i in range(nrings):
                mask = r_vals == i
                r_bins[:, i] = np.sum(data_dict[key] * mask, axis=(1, 2))
            feed_dict[key] = r_bins
        fig, ax0 = self._plot(feed_dict, xlabel="R-bin", ylabel="Avg. Energy")
        for name in self.save_names("EnergyR"):
            self.save_fig(name, fig, ax0)
        return feed_dict


class RCenterHGCal(Plot):
    """HGCal per-layer R centroid/width (reference :744-803)."""

    def __call__(self, data_dict, energies):
        from calodiffusion_tpu_torch.utils import hgcal_utils

        geom = hgcal_utils.load_geom(self.config.get("BIN_FILE", ""))
        r_vals = (
            geom.xmap[:, : geom.max_ncell] ** 2
            + geom.ymap[:, : geom.max_ncell] ** 2
        ) ** 0.5

        fd_C_hist, fd_C_avg, fd_W_hist, fd_W_avg = {}, {}, {}, {}
        for key, data in data_dict.items():
            p = data.reshape(data.shape[0], self.shape_plot[2], -1)
            layer_sum = np.sum(p, axis=-1)
            totalE = np.sum(p, axis=(1, 2)).reshape(-1, 1)
            layer_zero = layer_sum < (1e-6 * totalE)

            r_centers = weighted_mean(r_vals, np.squeeze(data))
            r2_centers = weighted_mean(r_vals, np.squeeze(data), power=2)
            r_centers[layer_zero] = 0.0
            r2_centers[layer_zero] = 0.0
            fd_C_hist[key] = r_centers.reshape(-1)
            fd_C_avg[key] = np.mean(r_centers, axis=0)
            r_widths = get_width(r_centers, r2_centers)
            fd_W_hist[key] = r_widths.reshape(-1)
            fd_W_avg[key] = np.mean(r_widths, axis=0)

        fig, ax0 = self._hist(fd_C_hist, xlabel="Shower R Center", normalize=True)
        for name in self.save_names("RCenter"):
            self.save_fig(name, fig, ax0)
        fig, ax0 = self._plot(fd_C_avg, ylabel="Avg. Shower R Center",
                              xlabel="Layer", no_mean=True)
        for name in self.save_names("RCenterLayer"):
            self.save_fig(name, fig, ax0)
        fig, ax0 = self._hist(fd_W_hist, xlabel="Shower R Width", normalize=True)
        for name in self.save_names("RWidth"):
            self.save_fig(name, fig, ax0)
        fig, ax0 = self._plot(fd_W_avg, ylabel="Avg. Shower R Width",
                              xlabel="Layer", no_mean=True)
        for name in self.save_names("RWidthLayer"):
            self.save_fig(name, fig, ax0)


class PhiCenterHGCal(Plot):
    """HGCal per-layer phi centroid/width (reference :806-877)."""

    def __call__(self, data_dict, energies):
        from calodiffusion_tpu_torch.utils import hgcal_utils

        geom = hgcal_utils.load_geom(self.config.get("BIN_FILE", ""))
        phi_vals = geom.theta_map[:, : geom.max_ncell]

        fd_C_hist, fd_C_avg, fd_W_hist, fd_W_avg = {}, {}, {}, {}
        for key, data in data_dict.items():
            p = data.reshape(data.shape[0], self.shape_plot[2], -1)
            layer_sum = np.sum(p, axis=-1)
            totalE = np.sum(p, axis=(1, 2)).reshape(-1, 1)
            layer_zero = layer_sum < (1e-6 * totalE)

            phi_centers, phi_widths = ang_center_spread(phi_vals, np.squeeze(data))
            phi_centers[layer_zero] = 0.0
            phi_widths[layer_zero] = 0.0
            fd_C_hist[key] = phi_centers.reshape(-1)
            fd_C_avg[key] = np.mean(phi_centers, axis=0)
            fd_W_hist[key] = phi_widths.reshape(-1)
            fd_W_avg[key] = np.mean(phi_widths, axis=0)

        fig, ax0 = self._hist(fd_C_hist, xlabel="Shower Phi Center",
                              normalize=True)
        for name in self.save_names("PhiCenter"):
            self.save_fig(name, fig, ax0)
        fig, ax0 = self._plot(fd_C_avg, ylabel="Avg. Shower Phi Center",
                              xlabel="Layer", no_mean=True)
        for name in self.save_names("PhiCenterLayer"):
            self.save_fig(name, fig, ax0)
        fig, ax0 = self._hist(fd_W_hist, xlabel="Shower Phi Width",
                              normalize=True)
        for name in self.save_names("PhiWidth"):
            self.save_fig(name, fig, ax0)
        fig, ax0 = self._plot(fd_W_avg, ylabel="Avg. Shower Phi Width",
                              xlabel="Layer", no_mean=True)
        for name in self.save_names("PhiWidthLayer"):
            self.save_fig(name, fig, ax0)


# ---------------------------------------------------------------------------
# standalone shower-drawing helpers (reference utils/plots.py:1094-1160
# plot_shower_layer; plot_shower_hex is called by the reference's legacy
# scripts but defined nowhere - implemented working here)
# ---------------------------------------------------------------------------

def plot_shower_layer(data, fname="", title=None, fig=None,
                      subplot=(1, 1, 1), vmin=None, vmax=None,
                      r_edges=None):
    """Polar (phi x R) heatmap of one regular-grid layer; ``data`` is
    (n_phi, n_rad)."""
    from matplotlib.colors import LogNorm

    plt = _pyplot()
    if fig is None:
        fig = plt.figure(figsize=(5, 5), dpi=200)
    n_phi, n_rad = data.shape
    pts = 50
    if r_edges is None:
        r_edges = np.arange(n_rad + 1)
    phi_bins = 2.0 * np.pi * np.arange(pts * n_phi + 1) / (pts * n_phi)
    theta, rad = np.meshgrid(phi_bins, np.asarray(r_edges, float))
    rep = np.repeat(data.reshape(n_phi, -1), pts, axis=0)
    ax = fig.add_subplot(*subplot, polar=True)
    ax.grid(False)
    if vmax is None:
        vmax = max(float(np.max(data)), 1e-12)
    if vmin is None:
        vmin = 1e-2 if vmax > 1e-3 else vmax / 100.0
    pcm = ax.pcolormesh(theta, rad, rep.T + 1e-16,
                        norm=LogNorm(vmin=vmin, vmax=vmax))
    ax.axes.get_xaxis().set_visible(False)
    ax.axes.get_yaxis().set_visible(False)
    ax.set_rmax(float(np.max(r_edges)))
    if title is not None:
        ax.set_title(title, fontsize=10)
    fig.colorbar(pcm, ax=ax, fraction=0.05, orientation="horizontal",
                 label="Energy (GeV)")
    if fname:
        fig.savefig(fname, facecolor="white")
        plt.close(fig)
    return fig


def plot_shower_hex(x, y, values, nrings=None, fout="", title=None,
                    vmin=None, vmax=None):
    """Hexagonal-cell heatmap of one HGCal layer: cell centers (x, y) with
    energies ``values`` drawn as hex markers (log color scale)."""
    from matplotlib.colors import LogNorm

    plt = _pyplot()
    x = np.asarray(x, float)
    y = np.asarray(y, float)
    values = np.asarray(values, float)
    fig, ax = plt.subplots(figsize=(5.5, 5), dpi=200)
    pos = values > 0
    vmax = vmax or max(float(values.max()), 1e-12)
    vmin = vmin or max(vmax * 1e-4, 1e-12)
    extent = float(max(np.abs(x).max(), np.abs(y).max())) * 1.1 + 1e-9
    # marker area scaled to the cell pitch so hexes tile without gaps
    # (geometry pickles may carry nrings as a per-layer array)
    if nrings is not None and np.size(nrings):
        nrings = int(np.max(nrings))
    if nrings:
        pitch_pts = (ax.get_window_extent().width / (2.2 * nrings))
    else:
        pitch_pts = 6.0
    sc = ax.scatter(
        x[pos], y[pos], c=values[pos], marker="h", s=pitch_pts**2,
        norm=LogNorm(vmin=vmin, vmax=vmax), cmap="viridis",
        edgecolors="none",
    )
    ax.scatter(x[~pos], y[~pos], color="0.92", marker="h", s=pitch_pts**2,
               edgecolors="none")
    ax.set_xlim(-extent, extent)
    ax.set_ylim(-extent, extent)
    ax.set_aspect("equal")
    if title:
        ax.set_title(title, fontsize=10)
    fig.colorbar(sc, ax=ax, label="Energy (GeV)")
    if fout:
        fig.savefig(fout, facecolor="white")
        plt.close(fig)
    return fig
