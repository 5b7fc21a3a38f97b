"""calodiffusion_tpu_torch's data loader against the JAX package's on the
CPU: from the same tiny synthetic h5 files (dataset 2's 6480 voxels and
dataset 3's 40,500), both write npz caches under the same names with the
same arrays, bit for bit, and their batchers yield the same batches."""

import os
import shutil

import h5py
import numpy as np
import pytest
import torch

from calodiffusion_tpu.data import loader as jloader
from calodiffusion_tpu_torch.data import loader as tloader
from calodiffusion_tpu_torch.utils.config import default_flags
from tests.test_torch_port_ds3 import ds3_config
from tests.utils_test import tiny_ds2_config


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch and two BLAS threads: the Tier-1 run shares the cores
    between six workers."""
    from threadpoolctl import threadpool_limits

    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    with threadpool_limits(limits=2):
        yield
    torch.set_num_threads(prev)


def make_h5(path, n, voxels, seed):
    """Showers with exponential deposits, 80 % of the voxels zero, and
    incident energies in [1 GeV, 1 TeV] (MeV)."""
    rng = np.random.default_rng(seed)
    showers = rng.exponential(1.0, (n, voxels)).astype(np.float32)
    showers[rng.uniform(size=showers.shape) < 0.8] = 0
    with h5py.File(path, "w") as f:
        f.create_dataset("showers", data=showers)
        f.create_dataset("incident_energies",
                         data=rng.uniform(1e3, 1e6, (n, 1)).astype(np.float32))


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """ds2: two train files of 12 and 10 showers and a val file of 6; ds3:
    two files of 3 showers."""
    root = tmp_path_factory.mktemp("sources")
    for name, n, vox in (("dataset_2_1.hdf5", 12, 6480), ("dataset_2_2.hdf5", 10, 6480),
                         ("dataset_2_val.hdf5", 6, 6480), ("dataset_3_1.hdf5", 3, 40500),
                         ("dataset_3_2.hdf5", 3, 40500)):
        make_h5(root / name, n, vox, seed=n + vox)
    return root


def _two_dirs(sources, tmp_path):
    """The same sources in a directory for each package."""
    dirs = []
    for side in ("jax", "torch"):
        d = tmp_path / side
        shutil.copytree(sources, d)
        dirs.append(str(d) + "/")
    return dirs


def _caches(folder):
    return sorted(f for f in os.listdir(folder) if f.endswith(".npz"))


def _assert_same_caches(jdir, tdir):
    names = _caches(jdir)
    assert names and names == _caches(tdir)
    for name in names:
        with np.load(os.path.join(jdir, name)) as a, np.load(os.path.join(tdir, name)) as b:
            assert sorted(a.files) == sorted(b.files) == ["E", "layers", "showers"]
            for k in a.files:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (name, k)
                assert a[k].tobytes() == b[k].tobytes(), (name, k)
    return names


def _batches(loader):
    return [tuple(np.asarray(a) for a in b) for b in loader]


def _assert_same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            assert u.dtype == v.dtype and u.tobytes() == v.tobytes()


DS2 = ["dataset_2_1.hdf5", "dataset_2_2.hdf5"]

# (config overrides, flag overrides, cache names both must write)
CASES = {
    "ds2_all": (dict(FILES=DS2, VAL_FILES=["dataset_2_val.hdf5"]), {},
                ["dataset_2_1.hdf5.npz", "dataset_2_2.hdf5.npz", "dataset_2_val.hdf5.npz"]),
    "ds2_nevts": (dict(FILES=DS2), dict(nevts=8), ["dataset_2_1.hdf5.n8.npz"]),
    "ds2_nevts_two_files": (dict(FILES=DS2), dict(nevts=15),
                            ["dataset_2_1.hdf5.npz", "dataset_2_2.hdf5.n3.npz"]),
    # job 1 of -n 8 starts at event 8: 4 events of the first file, then
    # 4 of the second
    "ds2_job_spill": (dict(FILES=DS2), dict(nevts=8, job_idx=1),
                      ["dataset_2_1.hdf5.s8.n8.npz", "dataset_2_2.hdf5.n4.npz"]),
    # job 2 of -n 8 starts past the first file (12): event 4 of the second
    "ds2_job_next_file": (dict(FILES=DS2), dict(nevts=8, job_idx=2),
                          ["dataset_2_2.hdf5.s4.n8.npz"]),
    "ds2_holdout": (dict(FILES=DS2, HOLDOUT=4), {},
                    ["dataset_2_1.hdf5.npz", "dataset_2_2.hdf5.npz"]),
    "ds3_all": (None, {}, ["dataset_3_1.hdf5.npz", "dataset_3_2.hdf5.npz"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_load_data_writes_the_jax_caches_and_batches(sources, tmp_path, case):
    cfg_kw, flag_kw, names = CASES[case]
    cfg = (ds3_config(BATCH=2) if cfg_kw is None
           else tiny_ds2_config(BATCH=5, **cfg_kw))
    jdir, tdir = _two_dirs(sources, tmp_path)
    jtrain, jval = jloader.load_data(default_flags(data_folder=jdir, **flag_kw), dict(cfg))
    ttrain, tval = tloader.load_data(default_flags(data_folder=tdir, **flag_kw), dict(cfg))
    assert _assert_same_caches(jdir, tdir) == sorted(names)
    assert [os.path.basename(f) for f in ttrain.files] == \
        [os.path.basename(f) for f in jtrain.files]
    assert len(ttrain) == len(jtrain)
    _assert_same_batches(_batches(ttrain), _batches(jtrain))
    assert (tval is None) == (jval is None)
    if tval is not None:
        _assert_same_batches(_batches(tval), _batches(jval))
    if case == "ds2_holdout":  # the last train file keeps 10 - 4
        assert sum(b[0].shape[0] for b in _batches(ttrain)) == 12 + 6
    if case == "ds3_all":
        assert _batches(ttrain)[0][2].shape == (2, 1, 45, 50, 18)


def test_eval_loader_and_preprocess_one_match_jax(sources, tmp_path):
    """``eval=True`` reads EVAL; ``_preprocess_one`` returns the same
    (cache, count): the events it wrote, and on reusing the cache with
    ``nevts`` > 0 the source's count (a quirk of the JAX loader)."""
    cfg = tiny_ds2_config(BATCH=4, EVAL=["dataset_2_val.hdf5"])
    jdir, tdir = _two_dirs(sources, tmp_path)
    jl, _ = jloader.load_data(default_flags(data_folder=jdir), dict(cfg), eval=True)
    tl, _ = tloader.load_data(default_flags(data_folder=tdir), dict(cfg), eval=True)
    assert _assert_same_caches(jdir, tdir) == ["dataset_2_val.hdf5.npz"]
    _assert_same_batches(_batches(tl), _batches(jl))
    flags = default_flags()
    for side, mod, d in (("jax", jloader, jdir), ("torch", tloader, tdir)):
        for want in (6, 10):
            path, n = mod._preprocess_one(d + "dataset_2_2.hdf5", dict(cfg), flags, 6, 0)
            assert (os.path.basename(path), n) == ("dataset_2_2.hdf5.n6.npz", want), side
    _assert_same_caches(jdir, tdir)


def test_load_data_from_caches_alone_needs_no_h5(sources, tmp_path):
    """With every cache present and -n -1 the loader never opens an h5
    file: the sources may be gone."""
    cfg = tiny_ds2_config(BATCH=5, FILES=DS2)
    d = tmp_path / "d"
    shutil.copytree(sources, d)
    want = _batches(tloader.load_data(default_flags(data_folder=str(d) + "/"), dict(cfg))[0])
    for f in DS2:
        os.remove(d / f)
    got = _batches(tloader.load_data(default_flags(data_folder=str(d) + "/"), dict(cfg))[0])
    _assert_same_batches(got, want)


@pytest.mark.parametrize("mod", [jloader, tloader], ids=["jax", "torch"])
def test_job_idx_errors(sources, tmp_path, mod):
    """The loader's three refusals, as the JAX package words them."""
    d = str(tmp_path) + "/"
    for f in DS2 + ["dataset_2_val.hdf5"]:
        shutil.copy(sources / f, d)
    cfg = tiny_ds2_config(BATCH=4, FILES=DS2)
    with pytest.raises(ValueError, match="requires a positive --n-events"):
        mod.load_data(default_flags(data_folder=d, job_idx=1), dict(cfg))
    with pytest.raises(ValueError, match="past the end of the available events"):
        mod.load_data(default_flags(data_folder=d, nevts=8, job_idx=3), dict(cfg))
    val_cfg = tiny_ds2_config(BATCH=4, FILES=["dataset_2_1.hdf5"],
                              VAL_FILES=["dataset_2_val.hdf5"])
    with pytest.raises(ValueError, match="past the end of the training files"):
        mod.load_data(default_flags(data_folder=d, nevts=6, job_idx=2), dict(val_cfg))


def _npz_files(tmp_path, sizes):
    files = []
    rng = np.random.default_rng(len(sizes))
    for i, n in enumerate(sizes):
        path = str(tmp_path / f"f{i}.npz")
        np.savez(path, E=rng.uniform(size=(n, 1)).astype(np.float32),
                 layers=rng.standard_normal((n, 3)).astype(np.float32),
                 showers=rng.standard_normal((n, 1, 2, 2, 2)).astype(np.float32))
        files.append(path)
    return files


@pytest.mark.parametrize("shuffle", [False, True], ids=["ordered", "shuffled"])
@pytest.mark.parametrize("drop_remainder", [False, True], ids=["keep", "drop"])
@pytest.mark.parametrize("shard", [(0, 1), (1, 2)], ids=["one", "rank1of2"])
def test_npz_dataset_matches_jax(tmp_path, shuffle, drop_remainder, shard):
    """Batches of 4 over files of 5, 6 and 3 (leftovers carried across
    files), two epochs, each rank's share of the files."""
    files = _npz_files(tmp_path, (5, 6, 3))
    kw = dict(shuffle=shuffle, seed=7, drop_remainder=drop_remainder,
              process_index=shard[0], process_count=shard[1])
    jd, td = jloader.NpzDataset(files, 4, **kw), tloader.NpzDataset(files, 4, **kw)
    assert len(td) == len(jd)
    for _ in range(2):
        got, want = _batches(td), _batches(jd)
        assert len(got) == len(td)
        _assert_same_batches(got, want)


def test_load_data_shards_by_process_group_rank(sources, tmp_path, monkeypatch):
    """Rank 1 of 2 reads the second half of the files, as the JAX package's
    process 1 of 2 does."""
    cfg = tiny_ds2_config(BATCH=4, FILES=DS2)
    d = str(tmp_path) + "/"
    for f in DS2:
        shutil.copy(sources / f, d)
    monkeypatch.setattr(tloader, "_process_rank", lambda: (1, 2))
    train, _ = tloader.load_data(default_flags(data_folder=d), dict(cfg))
    assert [os.path.basename(f) for f in train.files] == ["dataset_2_2.hdf5.npz"]
    monkeypatch.undo()
    assert tloader._process_rank() == (0, 1)


def test_get_files_keeps_the_substring_quirk(tmp_path):
    """A file name that contains the folder name is not joined to it
    (reference parity; the reason to pass an absolute data folder)."""
    for folder in ("data", str(tmp_path) + "/"):
        for names in (["dataset_2_1.hdf5"], ["x.hdf5", "datafile.hdf5"]):
            assert tloader.get_files(names, folder) == jloader.get_files(names, folder)
    assert tloader.get_files(["dataset_2_1.hdf5"], "data") == ["dataset_2_1.hdf5"]
    lst = tmp_path / "files.txt"
    lst.write_text("a.hdf5\nb.hdf5\n")
    assert tloader.get_files(str(lst), "/d/") == jloader.get_files(str(lst), "/d/")
    assert tloader.get_files(str(tmp_path / "none.txt")) == []


def test_hgcal_and_pre_embed_raise(sources, tmp_path):
    """HGCal data is ported (tests/test_torch_port_hgcal.py): a CaloChallenge
    file read as HGCal has no gen_info, in both loaders; a pre-embed without
    HGCAL is refused, where the JAX loader fails reading BIN_FILE ("") as a
    geometry."""
    d = str(tmp_path) + "/"
    shutil.copy(sources / "dataset_2_1.hdf5", d)
    cfg = tiny_ds2_config(FILES=["dataset_2_1.hdf5"], HGCAL=True)
    for mod in (jloader, tloader):
        with pytest.raises(KeyError, match="gen_info"):
            mod.load_data(default_flags(data_folder=d, device="cpu"), dict(cfg))
    cfg = tiny_ds2_config(SHOWER_EMBED="pre-embed")
    with pytest.raises(ValueError, match="needs HGCAL"):
        tloader.load_data(default_flags(data_folder=d), dict(cfg))
    with pytest.raises(FileNotFoundError):
        jloader.load_data(default_flags(data_folder=d), dict(cfg))


@pytest.mark.parametrize("config", ["config_dataset2.json", "config_dataset3.json"])
def test_chip_smoke_caches_equal_the_loaders(tmp_path, config):
    """chip_smoke.py writes its npz caches without h5py (the card machine
    has none): from the same showers they equal the loader's, bit for bit."""
    import json

    import chip_smoke

    cfg = json.load(open(os.path.join(os.path.dirname(__file__), "..", "configs", config)))
    voxels = cfg["SHAPE_ORIG"][1]
    showers, energies = chip_smoke.raw_showers(np.random.default_rng(1), 3, voxels)
    with h5py.File(tmp_path / "src.hdf5", "w") as f:
        f.create_dataset("showers", data=showers)
        f.create_dataset("incident_energies", data=energies)
    path, n = tloader._preprocess_one(str(tmp_path / "src.hdf5"), dict(cfg), default_flags(),
                                      -1, 0)
    chip_smoke.write_cache(tmp_path / "smoke.npz", showers, energies, dict(cfg))
    assert n == 3 and (showers == 0).mean() > 0.7
    with np.load(path) as a, np.load(tmp_path / "smoke.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


def test_misc_matches_jax(tmp_path):
    """utils/misc: the mask file of always-empty voxels, the in-place
    shuffle and split, and batched application."""
    from calodiffusion_tpu.utils import misc as jmisc
    from calodiffusion_tpu_torch.utils import misc as tmisc

    showers = np.random.default_rng(3).exponential(1.0, (5, 40)).astype(np.float32)
    showers[:, :7] = 0
    masks = []
    for side, mod in (("jax", jmisc), ("torch", tmisc)):
        d = tmp_path / side
        d.mkdir()
        with h5py.File(d / "eval.hdf5", "w") as f:
            f.create_dataset("showers", data=showers)
        path = mod.conversion_preprocess(str(d / "eval.hdf5"))
        assert path == str(d / "eval_mask.hdf5")
        with h5py.File(path, "r") as f:
            masks.append(f["mask"][:])
    np.testing.assert_array_equal(masks[0], masks[1])
    assert masks[1][:7].all() and not masks[1][7:].any()
    splits = []
    for mod in (jmisc, tmisc):
        np.random.seed(11)
        splits.append(mod.split_data_np(np.arange(10), 0.7))
    for a, b in zip(*splits):
        np.testing.assert_array_equal(a, b)
    x = np.arange(23.0).reshape(23, 1)
    np.testing.assert_array_equal(tmisc.apply_in_batches(lambda a: 2 * a, x, 4),
                                  jmisc.apply_in_batches(lambda a: 2 * a, x, 4))
