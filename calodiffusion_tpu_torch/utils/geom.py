"""Dataset-1 irregular-to-regular geometry conversion.

CaloChallenge dataset 1 layers have heterogeneous radial binnings and some
layers carry only one alpha bin.  ``GeomConverter`` re-bins every layer onto
the union radial grid (area-weighted splitting) so showers become a regular
(n_layers, alpha_out, dim_r_out) image; ``unconvert`` applies the pseudo-
inverse maps.  Behavior-compatible with the reference converter (reference:
calodiffusion/utils/utils.py:659-784), implemented in pure numpy so it runs
identically on host during preprocessing.  A copy of
``calodiffusion_tpu/utils/geom.py``: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import numpy as np

from calodiffusion_tpu_torch.utils.xml_handler import XMLHandler


class GeomConverter:
    def __init__(
        self,
        bins: XMLHandler | None = None,
        all_r_edges=None,
        lay_r_edges=None,
        alpha_out: int = 1,
        lay_alphas=None,
    ):
        self.layer_boundaries = []

        if bins is not None:
            self.layer_boundaries = np.unique(bins.GetBinEdges())
            rel_layers = bins.GetRelevantLayers()
            lay_alphas = [
                len(bins.alphaListPerLayer[idx][0])
                for idx, redge in enumerate(bins.r_edges)
                if len(redge) > 1
            ]
            alpha_out = int(np.amax(lay_alphas))
            lay_r_edges = [bins.r_edges[l] for l in rel_layers]
            all_r_edges = np.unique(
                np.concatenate([np.asarray(e, dtype=np.float32) for e in lay_r_edges])
            )

        self.all_r_edges = np.asarray(all_r_edges, dtype=np.float32)
        self.lay_r_edges = lay_r_edges
        self.alpha_out = alpha_out
        self.lay_alphas = lay_alphas
        self.num_layers = len(self.lay_r_edges)

        self.all_r_areas = self.all_r_edges[1:] ** 2 - self.all_r_edges[:-1] ** 2
        self.dim_r_out = len(self.all_r_edges) - 1

        # per-layer (dim_r_out, dim_in) area-weighted rebinning matrices
        self.weight_mats: list[np.ndarray] = []
        for ilay in range(self.num_layers):
            edges = np.asarray(self.lay_r_edges[ilay], dtype=np.float32)
            dim_in = len(edges) - 1
            mat = np.zeros((self.dim_r_out, dim_in), dtype=np.float32)
            for ir in range(dim_in):
                lo = int(np.nonzero(self.all_r_edges == edges[ir])[0][0])
                hi = int(np.nonzero(self.all_r_edges == edges[ir + 1])[0][0])
                orig_area = edges[ir + 1] ** 2 - edges[ir] ** 2
                mat[lo:hi, ir] = self.all_r_areas[lo:hi] / orig_area
            self.weight_mats.append(mat)

        self.weight_mats_inv = [
            np.linalg.pinv(m).astype(np.float32) for m in self.weight_mats
        ]

    # -- flat <-> jagged ----------------------------------------------------
    def reshape(self, raw_shower: np.ndarray) -> list[np.ndarray]:
        """Flat (N, total_bins) -> list of (N, n_alpha_l, n_r_l) per layer."""
        out = []
        for idx in range(len(self.layer_boundaries) - 1):
            seg = raw_shower[:, self.layer_boundaries[idx]: self.layer_boundaries[idx + 1]]
            out.append(seg.reshape(raw_shower.shape[0], int(self.lay_alphas[idx]), -1))
        return out

    def unreshape(self, jagged: list[np.ndarray]) -> np.ndarray:
        n = jagged[0].shape[0]
        out = np.zeros((n, self.layer_boundaries[-1]), dtype=np.float32)
        for idx in range(len(self.layer_boundaries) - 1):
            out[:, self.layer_boundaries[idx]: self.layer_boundaries[idx + 1]] = (
                np.asarray(jagged[idx]).reshape(n, -1)
            )
        return out

    # -- irregular <-> regular ---------------------------------------------
    def _spread_alpha(self, o: np.ndarray, lay: int) -> np.ndarray:
        if self.lay_alphas is not None:
            if self.lay_alphas[lay] == 1:
                # single alpha bin: distribute evenly over the output phi bins
                o = np.repeat(o, self.alpha_out, axis=-2) / self.alpha_out
            elif self.lay_alphas[lay] != self.alpha_out:
                raise ValueError(
                    f"Layer {lay} has {self.lay_alphas[lay]} alpha bins; "
                    f"cannot map onto {self.alpha_out}"
                )
        return o

    def convert(self, jagged: list[np.ndarray]) -> np.ndarray:
        n = len(jagged[0])
        out = np.zeros(
            (n, self.num_layers, self.alpha_out, self.dim_r_out), dtype=np.float32
        )
        for i in range(self.num_layers):
            o = np.einsum("ij,...j->...i", self.weight_mats[i],
                          np.asarray(jagged[i], dtype=np.float32))
            out[:, i] = self._spread_alpha(o, i)
        return out

    def unconvert(self, regular: np.ndarray) -> list[np.ndarray]:
        out = []
        for i in range(self.num_layers):
            o = np.einsum("ij,...j->...i", self.weight_mats_inv[i],
                          np.asarray(regular[:, i], dtype=np.float32))
            if self.lay_alphas is not None:
                if self.lay_alphas[i] == 1:
                    o = np.sum(o, axis=-2, keepdims=True)
                elif self.lay_alphas[i] != self.alpha_out:
                    raise ValueError(
                        f"Layer {i} has {self.lay_alphas[i]} alpha bins; "
                        f"cannot map back from {self.alpha_out}"
                    )
            out.append(o)
        return out
