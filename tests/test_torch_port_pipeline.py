"""moma_tpu_torch.data.pipeline against moma_tpu.data.pipeline.

The port keeps its own numpy copy of the host pipeline so that its training
path imports nothing of the JAX package; these tests hold the copy to the
original: the same synthetic images and labels for a seed, the same train
batch order per epoch (also from a mid-epoch start), and the same padded
last eval batch and mask.
"""

import numpy as np
import pytest

from moma_tpu.data import pipeline as JP
from moma_tpu_torch.data import pipeline as TP


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_dataset_matches(seed):
    got = TP.synthetic_dataset(37, 16, 5, seed=seed)
    want = JP.synthetic_dataset(37, 16, 5, seed=seed)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.labels.dtype == want.labels.dtype == np.int32


@pytest.mark.parametrize("seed,epochs", [(0, (0, 1, 2)), (12345, (0, 5))])
def test_train_loader_order_matches(seed, epochs):
    data = JP.synthetic_dataset(37, 8, 5, seed=1)
    got_l = TP.Loader(TP.ArrayDataset(data.images, data.labels), 8,
                      train=True, seed=seed)
    want_l = JP.Loader(data, 8, train=True, seed=seed)
    assert len(got_l) == len(want_l) == 4  # the ragged tail is dropped
    for epoch in epochs:
        got_l.set_epoch(epoch)
        want_l.set_epoch(epoch)
        got, want = list(got_l), list(want_l)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["image"], w["image"])
            np.testing.assert_array_equal(g["label"], w["label"])


@pytest.mark.parametrize("start", [1, 3, 4])
def test_train_loader_starts_mid_epoch_alike(start):
    """set_start_batch (a resume from a preemption save) skips the first
    batches of the epoch's order; the setting persists until changed."""
    data = JP.synthetic_dataset(37, 8, 5, seed=1)
    got_l = TP.Loader(TP.ArrayDataset(data.images, data.labels), 8,
                      train=True, seed=3)
    want_l = JP.Loader(data, 8, train=True, seed=3)
    full = [b["label"] for b in got_l]
    for loader in (got_l, want_l):
        loader.set_epoch(2)
        loader.set_start_batch(start)
    got, want = list(got_l), list(want_l)
    assert len(got) == len(want) == 4 - start
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["label"], w["label"])
    got_l.set_epoch(0)
    assert [b["label"].tolist() for b in got_l] == [
        x.tolist() for x in full[start:]]


@pytest.mark.parametrize("n", [32, 37])
def test_eval_loader_pads_and_masks_alike(n):
    data = JP.synthetic_dataset(n, 8, 5, seed=2)
    got = list(TP.Loader(TP.ArrayDataset(data.images, data.labels), 8,
                         train=False))
    want = list(JP.Loader(data, 8, train=False))
    assert len(got) == len(want) == -(-n // 8)
    for g, w in zip(got, want):
        for k in ("image", "label", "mask"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert int(got[-1]["mask"].sum()) == n - 8 * (len(got) - 1)


def _imagefolder(root, n_per_class=3, size=12):
    """A tiny ImageFolder tree of PNGs (lossless, so both packages decode
    the same pixels)."""
    from PIL import Image

    rs = np.random.RandomState(0)
    for split in ("train", "val"):
        for cls in ("a", "b"):
            d = root / split / cls
            d.mkdir(parents=True)
            for i in range(n_per_class):
                Image.fromarray(rs.randint(0, 256, (size, size, 3),
                                           dtype=np.uint8)).save(
                    d / f"{i}.png")


def test_histo_datasets_load_like_the_jax_package(tmp_path):
    """The port's own copy of data/histo.py + data/manifests.py: the same
    packed images and labels for the same tree, and the manifests agree."""
    from types import SimpleNamespace

    from moma_tpu.data import histo as JH
    from moma_tpu.data import manifests as JM
    from moma_tpu_torch.data import histo as TH
    from moma_tpu_torch.data import manifests as TM

    assert sorted(TM.PREPARERS) == sorted(JM.PREPARERS)
    assert sorted(TM.TEST_ONLY_PREPARERS) == sorted(JM.TEST_ONLY_PREPARERS)
    out = []
    for mod, sub in ((TH, "t"), (JH, "j")):
        root = tmp_path / sub
        _imagefolder(root)
        cfg = SimpleNamespace(dataset="imagenet", data_dir=str(root),
                              image_size=8, fold_idx=-1, n_folds=5)
        out.append(mod.load_histo_dataset(cfg))
    for got, want in zip(*out):
        assert len(got) == len(want) == 6
        np.testing.assert_array_equal(got.labels, want.labels)
        np.testing.assert_array_equal(np.asarray(got.images),
                                      np.asarray(want.images))
    pairs = [(f"p{i}", i % 3) for i in range(30)]
    assert TM.stratified_kfold(pairs, 1, 5) == JM.stratified_kfold(pairs, 1, 5)


def test_histo_errors_are_kept(tmp_path):
    from types import SimpleNamespace

    from moma_tpu_torch.data import histo as TH

    cfg = SimpleNamespace(dataset="no_such_set", data_dir=str(tmp_path),
                          image_size=8, fold_idx=-1, n_folds=5)
    with pytest.raises(KeyError, match="no_such_set"):
        TH.load_histo_dataset(cfg)
    with pytest.raises(KeyError, match="no_such_set"):
        TH.load_histo_testset("no_such_set", str(tmp_path), 8)
    (tmp_path / "train").mkdir()
    cfg.dataset = "imagenet"
    with pytest.raises(FileNotFoundError):
        TH.load_histo_dataset(cfg)
    with pytest.raises(ValueError, match="no test split"):
        TH.load_histo_testset("imagenet", str(tmp_path), 8)
