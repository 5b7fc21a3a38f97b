"""CMS HGCal support: GLaM geometry-latent mapping + preprocessing.

The HGCal detector has irregular hexagonal sensor layers (<= ~3000 cells per
layer).  The GLaM embedding maps each layer's cells onto a regular
(alpha x R) grid via per-layer linear encode matrices (+pinv decode), built
from the detector geometry: cells are bucketed by ring -> R-bin (with the
production ring compression: rings >= 23 merged 3:1) and by angle ->
alpha-bin with boundary-cell splitting.  Behavior-compatible with the
reference converter (reference: calodiffusion/utils/HGCal_utils.py - enc/dec
:636-680, init_map :412-486, sparse decode :355-407, loaders :89-292).

A copy of ``calodiffusion_tpu/utils/hgcal_utils.py`` (the port imports
nothing of the JAX package).  The geometry, the maps, their pseudo-inverses
(numpy float32, one ``np.linalg.pinv`` a layer, where the CPU takes
them; on the card one batched product, ``init``), the sparse decode (numpy,
drawn from the caller's ``np.random.Generator``, so one ``rng`` selects the
same cells in both packages) and the preprocessing keep the JAX package's
arithmetic.  The dense encode and decode are one batched f32 product over
the (L, out, ncell) matrix stack in torch, TF32 off, on the ``device`` the
caller passes (the card unless it asks for the CPU): on the pion geometry
(47 layers x 576 bins x 22,268 cells) one batch of 128 showers is 154
GFLOP each way.  ``make_pre_embed_converter`` builds one converter per
(``BIN_FILE``, ``SHAPE_FINAL``, norm, ``DATASET_NUM``) and process, so the
loader, ``generate``, the cascade and the sample CLI share its
pseudo-inverses.  The in-model/trainable variant lives in
models/hgcal_converter.py as an ``nn.Module`` built from these matrices.

The geometry ships as a pickle of an ``HGCalGeo`` object from the (external)
HGCalShowers package; a rename-tolerant unpickler maps both historical
module paths onto the local :class:`HGCalGeo` so real geometry files load
without that package installed.
"""

from __future__ import annotations

import contextlib
import pickle

import numpy as np
import torch

from calodiffusion_tpu_torch.utils import consts
from calodiffusion_tpu_torch.utils.device import resolve_device

LOGIT_ALPHA_HGCAL = 1e-8


def logit(x, alpha: float = LOGIT_ALPHA_HGCAL):
    o = alpha + (1 - 2 * alpha) * x
    return np.ma.log(o / (1 - o)).filled(0)


def reverse_logit(x, alpha: float = LOGIT_ALPHA_HGCAL):
    exp = np.exp(x)
    o = exp / (1 + exp)
    return (o - alpha) / (1 - 2 * alpha)


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------

class HGCalGeo:
    """Geometry container matching the HGCalShowers.HGCalGeo pickle layout:
    xmap/ymap/ring_map (nlayers, max_cells), ncells (nlayers,), nlayers,
    nrings.  theta_map and max_ncell are derived on load."""

    pass


class _RenameUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if name == "HGCalGeo" and module in (
            "HGCalGeo", "HGCalShowers.HGCalGeo", "__main__",
            "calodiffusion_tpu.utils.hgcal_utils",
            "calodiffusion_tpu_torch.utils.hgcal_utils",
        ):
            return HGCalGeo
        return super().find_class(module, name)


_geom_cache: dict[str, HGCalGeo] = {}


def load_geom(geom_filename: str) -> HGCalGeo:
    if geom_filename in _geom_cache:
        return _geom_cache[geom_filename]
    with open(geom_filename, "rb") as f:
        geom = _RenameUnpickler(f).load()
    # angle in [0, 2pi); note the reference's (x, y) argument order
    geom.theta_map = np.arctan2(geom.xmap, geom.ymap) % (2.0 * np.pi)
    geom.max_ncell = int(round(np.amax(geom.ncells)))
    _geom_cache[geom_filename] = geom
    return geom


def make_synthetic_geom(
    nlayers: int = 28, cells_per_ring: int = 6, nrings: int = 8, seed: int = 0,
    max_cells: int | None = None,
) -> HGCalGeo:
    """Build a small fake hexagonal-ish geometry (for tests / CI, standing in
    for the real detector pickle like the reference's mocked HGCal fixture).
    ``max_cells`` (at most the full rings' 1 + cells_per_ring * n(n+1)/2)
    keeps that many cells a layer, the last ring filled in part, so that a
    geometry can hold exactly a config's ``MAX_CELLS``."""
    rng = np.random.default_rng(seed)
    geom = HGCalGeo()
    ncells_per_layer = 1 + cells_per_ring * ((nrings * (nrings + 1)) // 2)
    if max_cells is None:
        max_cells = ncells_per_layer
    if not 0 < max_cells <= ncells_per_layer:
        raise ValueError(f"max_cells {max_cells} not in (0, {ncells_per_layer}]")
    xmap = np.zeros((nlayers, max_cells))
    ymap = np.zeros((nlayers, max_cells))
    ring_map = np.full((nlayers, max_cells), -1.0)
    ncells = np.zeros(nlayers)
    for lay in range(nlayers):
        idx = 0
        xmap[lay, idx], ymap[lay, idx] = 0.0, 0.0
        ring_map[lay, idx] = 0
        idx += 1
        for ring in range(1, nrings + 1):
            n_in_ring = cells_per_ring * ring
            angles = (
                np.linspace(0, 2 * np.pi, n_in_ring, endpoint=False)
                + rng.uniform(0, 0.05)
            )
            n_keep = min(n_in_ring, max_cells - idx)
            xmap[lay, idx: idx + n_keep] = ring * np.cos(angles[:n_keep])
            ymap[lay, idx: idx + n_keep] = ring * np.sin(angles[:n_keep])
            ring_map[lay, idx: idx + n_keep] = ring
            idx += n_keep
        ncells[lay] = idx
    geom.xmap = xmap
    geom.ymap = ymap
    geom.ring_map = ring_map
    geom.ncells = ncells
    geom.nlayers = nlayers
    geom.nrings = np.full(nlayers, nrings + 1)
    geom.theta_map = np.arctan2(geom.xmap, geom.ymap) % (2.0 * np.pi)
    geom.max_ncell = max_cells
    return geom


def save_geom(geom: HGCalGeo, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(geom, f)


# ---------------------------------------------------------------------------
# GLaM map construction (reference init_map :412-486)
# ---------------------------------------------------------------------------

def init_map(num_alpha_bins: int, num_r_bins: int, geom: HGCalGeo, ilay: int):
    """Per-layer encode matrix + trainable-sparsity mask, vectorized.

    Returns (weight_mat, mask) of shape (num_alpha_bins*num_r_bins, max_ncell).
    """
    dim_in = geom.max_ncell
    ncells = int(round(geom.ncells[ilay]))

    weight = np.zeros((num_alpha_bins, num_r_bins, dim_in), dtype=np.float32)
    mask = np.zeros((num_alpha_bins, num_r_bins, dim_in), dtype=np.float32)

    # ring -> R-bin compression (production values: inner 23 rings 1:1, then
    # 3 rings per bin)
    inner, max_ring, outer_step = 23, 100, 3
    r_binning = np.arange(0, max_ring, 1)
    r_binning[inner:] = (r_binning[inner:] - inner) // outer_step + inner

    step_size = 2.0 * np.pi / num_alpha_bins
    ang_bins = np.arange(num_alpha_bins + 1) * step_size + np.pi / num_alpha_bins

    eps, eps2 = 1e-4, 1e-2
    cell_alphas = np.asarray(geom.theta_map[ilay][:dim_in])
    cell_ang_bins = np.searchsorted(ang_bins, cell_alphas + eps, side="left")
    cell_ang_bins[cell_ang_bins == num_alpha_bins] = 0
    diffs = np.abs(cell_alphas - ang_bins[cell_ang_bins - 1])
    close_boundaries = (diffs < eps2) | (np.abs(diffs - 2.0 * np.pi) < eps2)

    # central cell: split among all alpha bins of the innermost radial bin
    weight[:, 0, 0] = 1.0 / num_alpha_bins
    mask[:, 0, 0] = 1.0

    cells = np.arange(1, ncells)
    a_bins = cell_ang_bins[cells] % num_alpha_bins
    ring_idx = np.round(geom.ring_map[ilay, cells]).astype(int)
    r_bins = r_binning[ring_idx]
    cb = close_boundaries[cells]

    # regular cells: full weight in their (alpha, r) bin; neighborhood mask
    reg, a_r, r_r = cells[~cb], a_bins[~cb], r_bins[~cb]
    weight[a_r, r_r, reg] = 1.0
    mask[a_r, r_r, reg] = 1.0
    mask[(a_r - 1) % num_alpha_bins, r_r, reg] = 1.0
    mask[(a_r + 1) % num_alpha_bins, r_r, reg] = 1.0
    inner_ok = r_r > 0
    mask[a_r[inner_ok], r_r[inner_ok] - 1, reg[inner_ok]] = 1.0
    outer_ok = r_r < num_r_bins - 1
    mask[a_r[outer_ok], r_r[outer_ok] + 1, reg[outer_ok]] = 1.0

    # boundary cells: split 50/50 between adjacent alpha bins
    bnd, a_b, r_b = cells[cb], a_bins[cb], r_bins[cb]
    weight[a_b, r_b, bnd] = 0.5
    weight[a_b - 1, r_b, bnd] = 0.5
    mask[a_b, r_b, bnd] = 1.0
    mask[a_b - 1, r_b, bnd] = 1.0
    b_inner = r_b > 0
    mask[a_b[b_inner], r_b[b_inner] - 1, bnd[b_inner]] = 1.0
    mask[a_b[b_inner] - 1, r_b[b_inner] - 1, bnd[b_inner]] = 1.0
    b_outer = r_b < num_r_bins - 1
    mask[a_b[b_outer], r_b[b_outer] + 1, bnd[b_outer]] = 1.0

    out_dim = num_alpha_bins * num_r_bins
    return weight.reshape(out_dim, dim_in), mask.reshape(out_dim, dim_in)


def generate_sparse_mat(
    in_mat: np.ndarray, rng: np.random.Generator, batches: int = 1,
    per_batch: bool = False,
) -> np.ndarray:
    """Stochastic 'sparse' decode matrix: sample cells proportionally to the
    decode weights instead of spreading energy over all of them; energy
    conserving per column (reference :355-407)."""
    batch_size = 1 if per_batch else batches
    mats = np.broadcast_to(in_mat, (batch_size, *in_mat.shape)).copy()

    eps = 1e-6
    mask = mats > eps
    rand_mat = rng.random(mats.shape, dtype=np.float32) * mask + mats

    # always keep the (argmax) strongest cell per column
    maxs = np.argmax(rand_mat, axis=-2)
    np.put_along_axis(rand_mat, maxs[..., None, :], 1.0 + eps, axis=-2)

    sparse_mat = (rand_mat > 1.0).astype(np.float32)
    norm = np.sum(sparse_mat, axis=-2, keepdims=True)
    sparse_mat /= norm
    sparse_mat *= mask
    if per_batch:
        sparse_mat = np.broadcast_to(
            sparse_mat, (batches, *in_mat.shape)
        ).copy()
    return sparse_mat


# ---------------------------------------------------------------------------
# Converter
# ---------------------------------------------------------------------------

class HGCalConverter:
    """Host-side GLaM converter (frozen matrices).  The trainable in-model
    variant (models/hgcal_converter.py) shares these matrices as init."""

    def __init__(self, bins=None, geom_file=None, trainable=False, **_unused):
        self.geom = load_geom(geom_file)
        self.bins = bins
        self.num_r_bins = bins[-1]
        self.num_alpha_bins = bins[-2]
        self.num_layers = bins[-3]
        self.trainable = trainable

        self.norm = False
        self.embed_mean = 0.0
        self.embed_std = 1.0

        out_dim = self.num_alpha_bins * self.num_r_bins
        self.enc_mat = np.zeros(
            (self.num_layers, out_dim, self.geom.max_ncell), np.float32
        )
        self.dec_mat = np.zeros(
            (self.num_layers, self.geom.max_ncell, out_dim), np.float32
        )
        self.enc_mask = np.zeros_like(self.enc_mat, dtype=bool)
        self.dec_mask = np.zeros_like(self.dec_mat, dtype=bool)
        self._initialized = False
        self._torch_mats: dict = {}  # (name, device) -> the matrix stack there

    def init(self, noise_scale: float = 0.0, norm: bool = False,
             dataset_num: int = 101, device=None):
        """The maps, their masks and pseudo-inverses (JAX init).  On the CPU
        each layer's pseudo-inverse is ``np.linalg.pinv`` in float32, as in
        the JAX package, bit for bit; on a CUDA ``device`` the whole stack's
        are taken there (``_card_pinv``): numpy's take 136 s on the pion
        geometry on the card's host."""
        rng = np.random.default_rng(0)
        eps = 1e-6
        for i in range(self.geom.nlayers):
            conv_map, mask = init_map(
                self.num_alpha_bins, self.num_r_bins, self.geom, i
            )
            self.enc_mat[i] = conv_map
            self.enc_mask[i] = mask > eps
        dev = resolve_device(device)
        if dev.type == "cpu":
            for i in range(self.geom.nlayers):
                self.dec_mat[i] = np.linalg.pinv(self.enc_mat[i]).astype(np.float32)
        else:
            self.dec_mat[: self.geom.nlayers] = _card_pinv(
                self.enc_mat[: self.geom.nlayers], dev)
        for i in range(self.geom.nlayers):
            inv_init = self.dec_mat[i]
            self.dec_mask[i] = np.abs(inv_init) > eps
            if noise_scale > 0.0:
                self.enc_mat[i] += rng.standard_normal(
                    self.enc_mat[i].shape
                ).astype(np.float32) * noise_scale
                inv_init += eps * rng.standard_normal(
                    inv_init.shape
                ).astype(np.float32)

        if norm:
            self.norm = True
            c = consts.dataset_params[dataset_num]
            self.embed_mean = c["embed_mean"]
            self.embed_std = c["embed_std"]
        self._initialized = True
        self._torch_mats = {}
        return self

    # -- encode / decode ----------------------------------------------------
    def _product(self, name: str, x, device) -> np.ndarray:
        """``x`` (..., L, k) through the (L, m, k) stack ``self.<name>``, one
        batched f32 product on ``device`` (TF32 off): (..., L, m), numpy
        float32.  The stack's torch copy is kept per device."""
        dev = resolve_device(device)
        key = (name, str(dev))
        if key not in self._torch_mats:
            self._torch_mats[key] = torch.from_numpy(getattr(self, name)).to(dev)
        mat = self._torch_mats[key]
        L, m, k = mat.shape
        x = np.asarray(x, dtype=np.float32)
        lead = x.shape[:-2]
        xt = torch.from_numpy(np.ascontiguousarray(x.reshape(-1, L, k))).to(dev)
        with _full_f32_matmul():
            out = torch.bmm(xt.transpose(0, 1), mat.transpose(1, 2))  # (L, B, m)
        return out.transpose(0, 1).cpu().numpy().reshape(*lead, L, m)

    def enc(self, x: np.ndarray, device=None) -> np.ndarray:
        """(..., L, max_ncell) -> (..., L, alpha, r)."""
        out = self._product("enc_mat", x, device)
        out = out.reshape(
            *out.shape[:-1], self.num_alpha_bins, self.num_r_bins
        )
        if self.norm:
            out = (out - self.embed_mean) / self.embed_std
        return out

    # alias used by the plotting CLI
    enc_numpy = enc

    def dec(self, x: np.ndarray, sparse_decoding: bool = False,
            sparse_per_batch: bool = False, rng=None, device=None) -> np.ndarray:
        """(..., L, alpha, r) -> (..., L, max_ncell)."""
        if self.norm:
            x = x * self.embed_std + self.embed_mean
        flat = x.reshape(*x.shape[:-2], self.num_alpha_bins * self.num_r_bins)
        if sparse_decoding:
            rng = rng if rng is not None else np.random.default_rng()
            out = self._sparse_dec(flat, rng, per_batch=sparse_per_batch)
        else:
            out = self._product("dec_mat", flat, device)
        return out

    # -- sparse decoding ------------------------------------------------------
    # Same stochastic law as the reference's generate_sparse_mat
    # (HGCal_utils.py:355-407, kept above for parity inspection): per
    # (layer, embed-bin) column, cell n is selected iff u + w > 1 (i.e.
    # with probability w) where w = dec_mat[l, n, e], the column's highest
    # u + w cell is always kept, and the column's energy is split evenly
    # over the selected cells.  The dense form materializes
    # (B, L, max_ncell, embed) random matrices — ~7 GB per 128-event chunk
    # on real HGCal geometry, which made sparse decoding the single
    # slowest stage of HGCal inference.  This index form draws only on the
    # ~1-2 positive weights each cell actually has (the decode matrix is
    # ring-local), ~250x less work, identical distribution.

    def _sparse_nnz(self):
        if getattr(self, "_sparse_cache", None) is None:
            eps = 1e-6
            L, N, E = self.dec_mat.shape
            l_idx, n_idx, e_idx = np.nonzero(self.dec_mat > eps)
            col = l_idx * E + e_idx
            order = np.argsort(col, kind="stable")
            l_idx, n_idx, col = l_idx[order], n_idx[order], col[order]
            e_idx = e_idx[order]
            w = self.dec_mat[l_idx, n_idx, e_idx].astype(np.float32)
            _, seg_starts = np.unique(col, return_index=True)
            seg_lens = np.diff(np.append(seg_starts, col.size))
            self._sparse_cache = (l_idx, n_idx, e_idx, w, seg_starts,
                                  seg_lens)
        return self._sparse_cache

    def _sparse_dec(self, flat: np.ndarray, rng,
                    per_batch: bool = False) -> np.ndarray:
        l_idx, n_idx, e_idx, w, seg_starts, seg_lens = self._sparse_nnz()
        L, N, _E = self.dec_mat.shape
        B = flat.shape[0]
        mid = flat.shape[1:-2]
        M = int(np.prod(mid, dtype=np.int64)) if mid else 1
        flat2 = flat.reshape(B, M, flat.shape[-2], flat.shape[-1])

        nsel = 1 if per_batch else B
        score = rng.random((nsel, w.size), dtype=np.float32) + w[None, :]
        segmax = np.maximum.reduceat(score, seg_starts, axis=1)
        sel = (score > 1.0) | (score >= np.repeat(segmax, seg_lens, axis=1))
        counts = np.add.reduceat(sel.astype(np.float32), seg_starts, axis=1)
        val = sel / np.repeat(counts, seg_lens, axis=1)  # (nsel, nnz)

        gathered = flat2[:, :, l_idx, e_idx]              # (B, M, nnz)
        contrib = (gathered * val[:, None, :]).reshape(-1)
        cell = (l_idx * N + n_idx).astype(np.int64)       # (nnz,)
        idx = (
            np.arange(B * M, dtype=np.int64)[:, None] * (L * N) + cell[None, :]
        ).reshape(-1)
        out = np.bincount(idx, weights=contrib, minlength=B * M * L * N)
        return out.astype(np.float32).reshape(B, *mid, L, N)

    def enc_batches(self, x: np.ndarray, batch_size: int = 256,
                    device=None) -> np.ndarray:
        outs = [
            self.enc(x[i: i + batch_size], device=device)
            for i in range(0, x.shape[0], batch_size)
        ]
        return np.concatenate(outs)

    def dec_batches(self, x: np.ndarray, batch_size: int = 128,
                    sparse_decoding=False, sparse_per_batch=False,
                    device=None, rng=None) -> np.ndarray:
        """``dec`` batch by batch; the sparse draws of all batches come from
        ``rng`` in turn (where None, each batch draws from a fresh
        Generator, as in the JAX package)."""
        outs = [
            self.dec(x[i: i + batch_size], sparse_decoding=sparse_decoding,
                     sparse_per_batch=sparse_per_batch, rng=rng, device=device)
            for i in range(0, x.shape[0], batch_size)
        ]
        return np.concatenate(outs)


def _card_pinv(mats: np.ndarray, device) -> np.ndarray:
    """Pseudo-inverses of the (L, out, ncell) stack on ``device``, float32:
    pinv(A) = A^T pinv(A A^T) in float64, the (out, out) Gram matrices'
    by one batched hermitian ``torch.linalg.pinv``.  In float64 the null
    directions' eigenvalues fall ~1e-16 below the largest and the geometry's
    smallest real ones ~1e-3 (photons: smallest singular value 0.07 of the
    largest), so the cut at 1e-10 separates them; an f32 pinv of A itself
    cut real singular values at torch's default cut (0.15 off numpy's on the
    pion geometry) and kept null ones at 1e-6."""
    a = torch.from_numpy(np.ascontiguousarray(mats)).to(device, torch.float64)
    gram_inv = torch.linalg.pinv(a @ a.transpose(1, 2), hermitian=True, rtol=1e-10)
    return (a.transpose(1, 2) @ gram_inv).float().cpu().numpy()


@contextlib.contextmanager
def _full_f32_matmul():
    """CUDA float32 matrix products without TF32 inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


_converter_cache: dict[tuple, HGCalConverter] = {}


def cached_converter(config: dict, norm: bool, device=None) -> HGCalConverter:
    """The initialised converter of ``config``'s geometry and grid, built
    once per (``BIN_FILE``, ``SHAPE_FINAL``, ``norm``, ``DATASET_NUM``) and
    process (and per kind of device that takes its pseudo-inverses:
    ``init``).  The converter is not tied to that device: ``enc`` and
    ``dec`` take their own."""
    dataset_num = config.get("DATASET_NUM", 101)
    geom_file = config.get("BIN_FILE", "")
    dev = resolve_device(device)
    key = (geom_file, tuple(config["SHAPE_FINAL"]), norm, dataset_num, dev.type)
    if key not in _converter_cache:
        conv = HGCalConverter(
            bins=config["SHAPE_FINAL"],
            geom_file=geom_file,
            trainable=config.get("TRAINABLE_EMBED", False),
        )
        _converter_cache[key] = conv.init(norm=norm, dataset_num=dataset_num, device=dev)
    return _converter_cache[key]


def make_pre_embed_converter(config: dict, device=None) -> HGCalConverter:
    return cached_converter(config, norm=True, device=device)


# ---------------------------------------------------------------------------
# Preprocessing (reference :20-164)
# ---------------------------------------------------------------------------

def preprocess_hgcal_shower(
    shower, e, shape, showerMap="log-norm", dataset_num=101,
    orig_shape=False, ecut=0, max_deposit=2,
):
    c = consts.dataset_params[dataset_num]
    layerE = None
    prefix = ""
    if "layer" in showerMap:
        eshape = (-1, *(1,) * (len(shower.shape) - 1))
        shower = np.ma.divide(shower, max_deposit * e.reshape(eshape))
        axes = list(range(len(shower.shape)))
        layers = np.sum(shower, tuple(axes[2:]), keepdims=True)
        totalE = np.sum(shower, tuple(axes[1:]), keepdims=True)
        layers = np.ma.divide(layers, totalE)
        layers = logit(layers)
        layers = (layers - c["layers_mean"]) / c["layers_std"]
        totalE = (totalE - c["totalE_mean"]) / c["totalE_std"]
        totalE = np.reshape(totalE, (totalE.shape[0], 1))
        layers = np.squeeze(layers)
        layerE = np.concatenate((totalE, layers), axis=1)
    else:
        eshape = (-1, *(1,) * (len(shower.shape) - 1))
        shower = shower / (max_deposit * e.reshape(eshape))

    if "logit" in showerMap:
        shower = logit(shower)
        if "norm" in showerMap:
            shower = (shower - c[prefix + "logit_mean"]) / c[prefix + "logit_std"]
        elif "scaled" in showerMap:
            shower = (
                2.0 * (shower - c["logit_min"]) / (c["logit_max"] - c["logit_min"])
                - 1.0
            )
    elif "log" in showerMap:
        shower = np.ma.log(shower).filled(c["log_min"])
        if "norm" in showerMap:
            shower = (shower - c[prefix + "log_mean"]) / c[prefix + "log_std"]
        elif "scaled" in showerMap:
            shower = (
                2.0
                * (shower - c[prefix + "log_min"])
                / (c[prefix + "log_max"] - c[prefix + "log_min"])
                - 1.0
            )
    return shower, layerE


def load_hgcal_h5(
    file_name, shape=None, emax=9999.0, emin=0.0001, nevts=-1, max_deposit=2,
    ecut=0, logE=True, showerMap="log-norm", nholdout=0, from_end=False,
    dataset_num=101, orig_shape=False, evt_start=0, max_cells=None,
    embed=False, NN_embed=None, shower_scale=200.0, config=None,
    binning_file="", device=None, **_unused,
):
    """Read + preprocess one HGCal HDF5 (reference DataLoaderHGCal); the
    pre-embed encode runs on ``device``."""
    import h5py as h5

    with h5.File(file_name, "r") as h5f:
        if nevts == -1 and nholdout > 0:
            nevts = -nholdout
        end = evt_start + int(nevts)
        if from_end:
            evt_start = -int(nevts)
            end = None
        if end == -1:
            end = None
        gen_info = h5f["gen_info"][evt_start:end].astype(np.float32)
        shower = (
            h5f["showers"][evt_start:end][:, :, :max_cells].astype(np.float32)
            * shower_scale
        )

    e = gen_info[:, 0]
    gen_min, gen_max = np.array(emin), np.array(emax)

    if embed and NN_embed is None:
        NN_embed = make_pre_embed_converter(
            dict(config or {}, BIN_FILE=binning_file, SHAPE_FINAL=shape
                 if config is None else config["SHAPE_FINAL"]), device=device
        )
    if embed:
        shower = NN_embed.enc_batches(shower, device=device)

    shower_pre, layerE_pre = preprocess_hgcal_shower(
        shower, e, shape, showerMap, dataset_num=dataset_num,
        orig_shape=orig_shape, ecut=ecut, max_deposit=max_deposit,
    )
    gen_pre = (gen_info - gen_min) / (gen_max - gen_min)
    return (
        shower_pre.astype(np.float32),
        gen_pre.astype(np.float32),
        layerE_pre.astype(np.float32),
    )


def reverse_norm_hgcal(
    voxels, e, shape=None, emax=9999.0, emin=0.0001, max_deposit=2, logE=True,
    layerE=None, showerMap="log", dataset_num=101, orig_shape=False, ecut=0.0,
    embed=False, NN_embed=None, binning_file="", config=None,
    sparse_decoding=False, sparse_per_batch=False, rng=None, device=None,
    **_unused,
):
    """Invert HGCal preprocessing (reference ReverseNormHGCal).  The dense
    decode runs on ``device``; the sparse one draws from ``rng`` (a numpy
    Generator; a fresh one where None, as in the JAX package)."""
    c = consts.dataset_params[dataset_num]
    gen_min, gen_max = np.array(emin), np.array(emax)
    gen_out = gen_min + (gen_max - gen_min) * e
    energy = gen_out[:, 0]

    prefix = ""
    if "logit" in showerMap:
        if "norm" in showerMap:
            voxels = voxels * c[prefix + "logit_std"] + c[prefix + "logit_mean"]
        elif "scaled" in showerMap:
            voxels = (voxels + 1.0) * 0.5 * (
                c[prefix + "logit_max"] - c[prefix + "logit_min"]
            ) + c[prefix + "logit_min"]
        data = reverse_logit(voxels)
    elif "log" in showerMap:
        if "norm" in showerMap:
            voxels = voxels * c[prefix + "log_std"] + c[prefix + "log_mean"]
        elif "scaled" in showerMap:
            voxels = (voxels + 1.0) * 0.5 * (
                c[prefix + "log_max"] - c[prefix + "log_min"]
            ) + c[prefix + "log_min"]
        voxels = np.minimum(voxels, np.log(max_deposit))
        data = np.exp(voxels)
    else:
        data = voxels

    if embed and NN_embed is None:
        NN_embed = make_pre_embed_converter(
            dict(config or {}, BIN_FILE=binning_file), device=device
        )
    if embed:
        data = NN_embed.dec_batches(
            data, sparse_decoding=sparse_decoding,
            sparse_per_batch=sparse_per_batch, device=device, rng=rng,
        )

    if "layer" in showerMap:
        assert layerE is not None
        totalE, layers = layerE[:, :1], layerE[:, 1:]
        totalE = totalE * c["totalE_std"] + c["totalE_mean"]
        layers = layers * c["layers_std"] + c["layers_mean"]
        layers = reverse_logit(layers)
        layers /= np.sum(layers, axis=1, keepdims=True)
        layers *= totalE

        data = np.squeeze(data)
        eps = 1e-8
        data[data < 0] = 0
        prev_layers = np.sum(data, 2, keepdims=True)
        layers = layers.reshape((-1, data.shape[1], 1))
        rescale_facs = layers / (prev_layers + 1e-10)
        rescale_facs[layers < eps] = 1.0
        rescale_facs[prev_layers < eps] = 1.0
        data *= rescale_facs

    data = data * max_deposit * energy.reshape(-1, 1, 1)
    return data, gen_out
