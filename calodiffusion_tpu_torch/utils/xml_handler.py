"""CaloChallenge binning-XML parser.

A copy of ``calodiffusion_tpu/utils/xml_handler.py``: the port imports nothing of the
JAX package.

Produces, per calorimeter layer: radial bin edges, number of alpha bins,
flat-bin bookkeeping, and per-voxel eta/phi coordinates.  Behavior-compatible
with the reference parser (reference: calodiffusion/utils/XMLHandler.py) which
downstream geometry conversion and high-level features rely on.
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET

import numpy as np


class XMLHandler:
    def __init__(self, particle_name: str, filename: str = "binning.xml"):
        root = ET.parse(filename).getroot()

        self.r_bins: list[int] = []          # number of radial bins per layer
        self.a_bins: list[int] = []          # number of alpha bins per layer
        self.r_edges: list[list[float]] = []
        self.r_midvalue: list[list[float]] = []
        self.relevantlayers: list[int] = []
        self.layerWithBinningInAlpha: list[int] = []
        self.alphaListPerLayer: list[list] = []
        self.nBinAlphaPerlayer: list[list] = []
        self.eta_all_layers: list[np.ndarray] = []
        self.phi_all_layers: list[np.ndarray] = []
        self.etaRegion = 0
        self.minAlpha = -math.pi

        particles = [p for p in root if p.attrib.get("name") == particle_name]
        if not particles:
            raise ValueError(
                f"Particle {particle_name} not found in {filename}"
            )
        for layer in particles[0]:
            edges = [float(s) for s in layer.attrib["r_edges"].split(",")]
            n_alpha = int(layer.attrib["n_bin_alpha"])
            self.r_edges.append(edges)
            self.r_bins.append(len(edges) - 1)
            self.a_bins.append(n_alpha)
            self.r_midvalue.append(
                [(lo + hi) / 2.0 for lo, hi in zip(edges[:-1], edges[1:])]
            )
            if n_alpha > 1:
                self.layerWithBinningInAlpha.append(int(layer.attrib["id"]))

        self.totalBins = 0
        self.bin_number: list[int] = []
        self._set_number_of_bins()
        self._set_eta_phi()

        self.bin_edges = [0]
        for n in self.bin_number:
            self.bin_edges.append(n + self.bin_edges[-1])

    def _set_number_of_bins(self) -> None:
        for layer, (n_r, n_a) in enumerate(zip(self.r_bins, self.a_bins)):
            self.totalBins += n_r * n_a
            self.bin_number.append(n_r * n_a)
            if n_r > 0:
                self.relevantlayers.append(layer)
                alpha_edges = np.linspace(self.minAlpha, math.pi, n_a + 1)
                centres = ((alpha_edges[:-1] + alpha_edges[1:]) / 2.0).tolist()
                self.alphaListPerLayer.append([centres] * n_r)
                self.nBinAlphaPerlayer.append([n_a] * n_r)
            else:
                self.alphaListPerLayer.append([0])
                self.nBinAlphaPerlayer.append([0])

    def _set_eta_phi(self) -> None:
        # flat (alpha-major, r-minor) per-voxel eta/phi, matching the
        # reference fill order (alpha outer loop, r inner loop)
        for layer in range(len(self.r_bins)):
            if self.r_bins[layer] == 0:
                self.eta_all_layers.append(np.array([]))
                self.phi_all_layers.append(np.array([]))
                continue
            mids = np.asarray(self.r_midvalue[layer])
            alphas = np.asarray(self.alphaListPerLayer[layer][0])
            r_flat = np.tile(mids, len(alphas))
            a_flat = np.repeat(alphas, len(mids))
            self.eta_all_layers.append(r_flat * np.cos(a_flat))
            self.phi_all_layers.append(r_flat * np.sin(a_flat))

    # -- reference-compatible accessors ------------------------------------
    def GetTotalNumberOfBins(self) -> int:
        return self.totalBins

    def GetBinEdges(self) -> list[int]:
        return self.bin_edges

    def GetEtaPhiAllLayers(self):
        return self.eta_all_layers, self.phi_all_layers

    def GetRelevantLayers(self) -> list[int]:
        return self.relevantlayers

    def GetLayersWithBinningInAlpha(self) -> list[int]:
        return self.layerWithBinningInAlpha

    def GetEtaRegion(self) -> int:
        return self.etaRegion
