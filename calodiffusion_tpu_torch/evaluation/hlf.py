"""CaloChallenge high-level features.

Per-layer energies plus energy centroids/widths in eta and phi over the
binning-XML geometry (reference: calodiffusion/utils/HighLevelFeatures.py
:16-89).  Pure numpy on final physical showers; accessor names match the
reference so downstream metric code ports unchanged.

A copy of ``calodiffusion_tpu/evaluation/hlf.py``: the port imports nothing of
the JAX package.  matplotlib is imported inside ``DrawSingleShower`` only.
"""

from __future__ import annotations

import numpy as np

from calodiffusion_tpu_torch.utils.xml_handler import XMLHandler


class HighLevelFeatures:
    def __init__(self, particle: str, filename: str = "binning.xml"):
        xml = XMLHandler(particle, filename=filename)
        self.bin_edges = xml.GetBinEdges()
        self.eta_all_layers, self.phi_all_layers = xml.GetEtaPhiAllLayers()
        self.relevantLayers = xml.GetRelevantLayers()
        self.layersBinnedInAlpha = xml.GetLayersWithBinningInAlpha()
        self.r_edges = [r for r in xml.r_edges if len(r) > 1]
        self.num_alpha = [
            len(xml.alphaListPerLayer[idx][0])
            for idx, redge in enumerate(xml.r_edges)
            if len(redge) > 1
        ]
        self.num_voxel = [
            (len(r) - 1) * n for r, n in zip(self.r_edges, self.num_alpha)
        ]
        self.particle = particle

        self.E_tot = None
        self.E_layers: dict[int, np.ndarray] = {}
        self.EC_etas: dict[int, np.ndarray] = {}
        self.EC_phis: dict[int, np.ndarray] = {}
        self.width_etas: dict[int, np.ndarray] = {}
        self.width_phis: dict[int, np.ndarray] = {}

    @staticmethod
    def _center(coord, energy):
        return (coord * energy).sum(axis=-1) / (energy.sum(axis=-1) + 1e-16)

    def GetECandWidths(self, eta_layer, phi_layer, energy_layer):
        eta_EC = self._center(eta_layer, energy_layer)
        phi_EC = self._center(phi_layer, energy_layer)
        eta_w2 = self._center(eta_layer**2, energy_layer)
        phi_w2 = self._center(phi_layer**2, energy_layer)
        eta_width = np.sqrt((eta_w2 - eta_EC**2).clip(min=0.0))
        phi_width = np.sqrt((phi_w2 - phi_EC**2).clip(min=0.0))
        return eta_EC, phi_EC, eta_width, phi_width

    def CalculateFeatures(self, data: np.ndarray) -> None:
        """data: (N, total_bins) physical-unit showers."""
        self.E_tot = data.sum(axis=-1)
        for l in self.relevantLayers:
            seg = data[:, self.bin_edges[l]: self.bin_edges[l + 1]]
            self.E_layers[l] = seg.sum(axis=-1)
        for l in self.relevantLayers:
            if l in self.layersBinnedInAlpha:
                seg = data[:, self.bin_edges[l]: self.bin_edges[l + 1]]
                (
                    self.EC_etas[l], self.EC_phis[l],
                    self.width_etas[l], self.width_phis[l],
                ) = self.GetECandWidths(
                    self.eta_all_layers[l], self.phi_all_layers[l], seg
                )

    # -- reference-compatible accessors -------------------------------------
    def GetEtot(self):
        return self.E_tot

    def GetElayers(self):
        return self.E_layers

    def GetECEtas(self):
        return self.EC_etas

    def GetECPhis(self):
        return self.EC_phis

    def GetWidthEtas(self):
        return self.width_etas

    def GetWidthPhis(self):
        return self.width_phis

    # -- shower drawing (reference HighLevelFeatures.py:91-301) --------------
    def DrawSingleShower(self, data, filename=None, title=None,
                         vmax=5506, vmin=1e-3):
        """Polar per-layer heatmaps of one shower over the binning geometry."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib.colors import LogNorm

        data = np.asarray(data).reshape(-1)
        n_lay = len(self.relevantLayers)
        ncols = min(n_lay, 5)
        nrows = -(-n_lay // ncols)
        fig = plt.figure(figsize=(2 * ncols, 2 * nrows + 1), dpi=150)
        num_splits = 400
        layer_boundaries = np.unique(self.bin_edges)
        max_r = max(r[-1] for r in self.r_edges)

        pcm = None
        for idx, layer in enumerate(self.relevantLayers):
            radii = np.array(self.r_edges[idx], dtype=float)
            theta, rad = np.meshgrid(
                2.0 * np.pi * np.arange(num_splits + 1) / num_splits, radii
            )
            pts = int(num_splits / self.num_alpha[idx])
            seg = data[layer_boundaries[idx]: layer_boundaries[idx + 1]]
            seg = seg.reshape(int(self.num_alpha[idx]), -1)
            seg = np.repeat(seg, pts, axis=0)
            ax = plt.subplot(nrows, ncols, idx + 1, polar=True)
            ax.grid(False)
            pcm = ax.pcolormesh(
                theta, rad, seg.T + 1e-16, norm=LogNorm(vmin=vmin, vmax=vmax)
            )
            ax.axes.get_xaxis().set_visible(False)
            ax.axes.get_yaxis().set_visible(False)
            ax.set_rmax(max_r)
            ax.set_title(f"Layer {layer}", fontsize=8)
        if pcm is not None:
            fig.colorbar(pcm, ax=fig.get_axes(), orientation="horizontal",
                         fraction=0.05, label="Energy (GeV)")
        if title:
            fig.suptitle(title)
        if filename:
            fig.savefig(filename, facecolor="white")
        plt.close(fig)
        return fig

    def feature_matrix(self, energies: np.ndarray) -> np.ndarray:
        """Flat (N, F) feature array: [log10 E_inc, log10 E_layers,
        EC_eta/1e2, EC_phi/1e2, width_eta/1e2, width_phi/1e2]
        (the FPD input layout, reference train/evaluate.py:26-47)."""
        E_layer = np.concatenate(
            [self.E_layers[l].reshape(-1, 1) for l in self.E_layers], axis=1
        )
        blocks = [np.log10(energies.reshape(-1, 1)), np.log10(E_layer + 1e-8)]
        if self.EC_etas:
            for d in (self.EC_etas, self.EC_phis, self.width_etas,
                      self.width_phis):
                blocks.append(
                    np.concatenate(
                        [d[l].reshape(-1, 1) for l in d], axis=1
                    ) / 1e2
                )
        return np.concatenate(blocks, axis=1)
