"""The port's native host data layer against moma_tpu's, on the CPU.

- The batcher (moma_tpu_torch/data/native/batcher.cpp): gather, the
  prefetch FIFO and get_view / release against moma_tpu's NativeBatcher
  and numpy, byte for byte; submit_into assembles into the caller's buffer.
- The decoder (decoder.cpp): decode_files / decode_mem against moma_tpu's
  on resized, unresized, grayscale and fast-mode JPEGs, byte for byte, and
  the same failure flags for a PNG, a missing and a corrupt file.
- The pack: one JPEG tree (resized sources, grayscale, a truncated JPEG,
  PNG bytes under a .jpg name, a PNG) packed by both packages'
  PackedCache gives the same .bin bytes.  Before the port had its own
  decoder it resized with PIL, which differs from the native resize by a
  grey level in 10-18% of the bytes of a resized source.
- The Loader over a pack against moma_tpu's: two epochs, a mid-epoch
  start and extras; an abandoned iteration followed by a full one; a
  failed build of the batcher raises; --num_workers reaches the batcher.

Small data throughout: packs of a few dozen 8x8 rows, JPEGs of at most
300x400.
"""

import io
import os

import numpy as np
import pytest
from PIL import Image

from moma_tpu.data import native as jnative
from moma_tpu.data import pipeline as jpipeline
from moma_tpu.data.histo import PackedCache as JPackedCache

from moma_tpu_torch.data import native
from moma_tpu_torch.data import pipeline
from moma_tpu_torch.data.histo import PackedCache


def _img(rs, h, w):
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 90 * np.sin(x / 17.0),
                     128 + 90 * np.cos(y / 23.0),
                     128 + 60 * np.sin((x + y) / 31.0)], axis=-1)
    return np.clip(base + rs.randint(-20, 20, (h, w, 3)), 0,
                   255).astype(np.uint8)


def _jpeg(arr, quality=90):
    """JPEG bytes of an (h, w, 3) RGB or (h, w) grayscale array."""
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


# ------------------------------------------------------------- batcher

N_ROWS, ROW = 37, (8, 8, 3)


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    rs = np.random.RandomState(0)
    arr = rs.randint(0, 256, (N_ROWS, *ROW), dtype=np.uint8)
    path = str(tmp_path_factory.mktemp("pack") / "rows.bin")
    arr.tofile(path)
    return path, arr


def _both(pack):
    path, _ = pack
    return (native.NativeBatcher(path, N_ROWS, ROW),
            jnative.NativeBatcher(path, N_ROWS, ROW))


@pytest.mark.parametrize("threads", [1, 4])
def test_gather_matches_the_jax_batcher_and_numpy(pack, threads):
    idx = np.random.RandomState(1).randint(0, N_ROWS, 29)
    ours, ref = _both(pack)
    got = ours.gather(idx, threads=threads)
    assert got.dtype == np.uint8 and got.shape == (29, *ROW)
    np.testing.assert_array_equal(got, ref.gather(idx, threads=threads))
    np.testing.assert_array_equal(got, pack[1][idx])
    ours.close()
    ref.close()


def test_prefetch_fifo_and_views_match_the_jax_batcher(pack):
    rs = np.random.RandomState(2)
    batches = [rs.randint(0, N_ROWS, 5) for _ in range(9)]
    ours, ref = _both(pack)
    for b in (ours, ref):
        b.start(5, depth=3, threads=3)
        for idx in batches[:3]:
            b.submit(idx)
    for i, idx in enumerate(batches):
        if i % 3 == 2:   # zero-copy dequeues between copying ones
            (a, ta), (r, tr) = ours.get_view(), ref.get_view()
            np.testing.assert_array_equal(a, r)
            np.testing.assert_array_equal(a, pack[1][idx])
            ours.release(ta)
            ref.release(tr)
        else:
            a, r = ours.get(), ref.get()
            np.testing.assert_array_equal(a, r)
            np.testing.assert_array_equal(a, pack[1][idx])
        if i + 3 < len(batches):
            ours.submit(batches[i + 3])
            ref.submit(batches[i + 3])
    ours.close()
    ref.close()


def test_submit_into_assembles_in_the_callers_buffer(pack):
    rs = np.random.RandomState(3)
    batches = [rs.randint(0, N_ROWS, 6) for _ in range(5)]
    bufs = [np.full((6, *ROW), 7, np.uint8) for _ in batches]
    b = native.NativeBatcher(pack[0], N_ROWS, ROW)
    b.start(6, depth=4, threads=2)
    for idx, buf in zip(batches, bufs):
        b.submit_into(idx, buf.ctypes.data)
    for idx, buf in zip(batches, bufs):
        view, token = b.get_view()
        assert view.ctypes.data == buf.ctypes.data   # no copy was made
        b.release(token)
        np.testing.assert_array_equal(buf, pack[1][idx])
    b.close()


# ------------------------------------------------------------- decoder

@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """{name: path}: JPEGs resized and not, grayscale, truncated, PNG
    bytes under a .jpg name, a PNG, a corrupt file and a missing one."""
    d = tmp_path_factory.mktemp("jpegs")
    rs = np.random.RandomState(4)
    blobs = {
        "big.jpg": _jpeg(_img(rs, 300, 300)),
        "wide.jpg": _jpeg(_img(rs, 300, 400)),
        "tall.jpg": _jpeg(_img(rs, 280, 150)),
        "exact.jpg": _jpeg(_img(rs, 128, 128)),
        "small.jpg": _jpeg(_img(rs, 90, 70)),
        "gray.jpg": _jpeg(_img(rs, 200, 200)[..., 0]),
        "trunc.jpg": _jpeg(_img(rs, 160, 160))[:3000],
    }
    for name, blob in blobs.items():
        (d / name).write_bytes(blob)
    png = io.BytesIO()
    Image.fromarray(_img(rs, 150, 120)).save(png, format="PNG")
    (d / "pngbytes.jpg").write_bytes(png.getvalue())
    Image.fromarray(_img(rs, 100, 130)).save(d / "plain.png")
    (d / "corrupt.jpg").write_bytes(b"\xff\xd8\xff\xe0" + b"\x13" * 500)
    names = sorted(blobs) + ["pngbytes.jpg", "plain.png", "corrupt.jpg",
                             "missing.jpg"]
    return {n: str(d / n) for n in names}


@pytest.mark.parametrize("size,fast", [(128, False), (64, False),
                                       (64, True)])
def test_decode_files_matches_the_jax_decoder(jpegs, size, fast):
    paths = list(jpegs.values())
    got, failed = native.decode_files(paths, size, fast=fast, threads=3)
    want, jfailed = jnative.decode_files(paths, size, fast=fast, threads=3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(failed, jfailed)
    flagged = {n for n, f in zip(jpegs, failed) if f}
    assert flagged == {"pngbytes.jpg", "plain.png", "corrupt.jpg",
                       "missing.jpg"}
    assert not got[failed].any()


@pytest.mark.parametrize("name", ["big.jpg", "wide.jpg", "exact.jpg",
                                  "gray.jpg", "trunc.jpg", "corrupt.jpg"])
@pytest.mark.parametrize("fast", [False, True])
def test_decode_mem_matches_the_jax_decoder(jpegs, name, fast):
    with open(jpegs[name], "rb") as f:
        blob = f.read()
    got = native.decode_mem(blob, 128, fast=fast)
    want = jnative.decode_mem(blob, 128, fast=fast)
    if name == "corrupt.jpg":
        assert got is None and want is None
    else:
        np.testing.assert_array_equal(got, want)


def test_pack_bytes_equal_the_jax_packages(jpegs, tmp_path):
    """The fault: both packages build <data_dir>/_moma_pack/pack_<key>.bin
    under the same key, so whichever builds a split first fixes its bytes
    for the other."""
    pairs = [(p, i % 3) for i, (n, p) in enumerate(jpegs.items())
             if n not in ("corrupt.jpg", "missing.jpg")]
    for size in (224, 128):
        ours = PackedCache(str(tmp_path / "port"))
        a = ours.build_or_open(pairs, size)
        b = JPackedCache(str(tmp_path / "jax")).build_or_open(pairs, size)
        assert os.path.basename(a.bin_path) == os.path.basename(b.bin_path)
        with open(a.bin_path, "rb") as fa, open(b.bin_path, "rb") as fb:
            assert fa.read() == fb.read(), size
        assert ours.last_build["route"] == "native"
        assert ours.last_build["pil_rows"] == 2   # the two PNGs


def test_a_corrupt_file_fails_the_pack_in_both_packages(jpegs, tmp_path):
    pairs = [(jpegs["big.jpg"], 0), (jpegs["corrupt.jpg"], 1)]
    errors = []
    for cache in (PackedCache(str(tmp_path / "p")),
                  JPackedCache(str(tmp_path / "j"))):
        with pytest.raises(Exception) as e:
            cache.build_or_open(pairs, 64)
        errors.append(type(e.value))
    assert errors[0] is errors[1]


def test_without_the_native_decoder_the_pack_says_so_and_uses_pil(
        jpegs, tmp_path, monkeypatch, capsys):
    """A host without libjpeg's headers: the build fails, PackedCache
    prints one line with g++'s first error line and decodes with PIL."""
    broken = tmp_path / "src"
    broken.mkdir()
    (broken / "decoder.cpp").write_text("#include <no_such_header_x.h>\n")
    monkeypatch.setattr(native, "HERE", broken)
    native._load.cache_clear()
    native.get_decoder_lib.cache_clear()
    try:
        pairs = [(jpegs["wide.jpg"], 0), (jpegs["plain.png"], 1)]
        cache = PackedCache(str(tmp_path / "c"))
        ds = cache.build_or_open(pairs, 64)
    finally:
        native._load.cache_clear()
        native.get_decoder_lib.cache_clear()
    out = capsys.readouterr().out
    key = cache.last_build["key"]
    line = [ln for ln in out.splitlines() if ln.startswith("[data]")]
    assert len(line) == 1 and line[0].startswith(
        f"[data] pack {key}: native decoder unavailable (")
    assert "no_such_header_x.h" in line[0]
    assert line[0].endswith("); decoding with PIL")
    assert cache.last_build["route"] == "pil"
    for row, (path, _) in zip(ds.images, pairs):
        with Image.open(path) as im:
            ref = np.asarray(im.convert("RGB").resize((64, 64),
                                                      Image.BILINEAR))
        np.testing.assert_array_equal(row, ref)


# -------------------------------------------------------------- Loader

def _loaders(pack, bs=4, **kw):
    path, arr = pack
    rs = np.random.RandomState(5)
    labels = rs.randint(0, 5, N_ROWS)
    extras = {"w": rs.randn(N_ROWS, 3).astype(np.float32),
              "c": rs.randint(0, 9, (N_ROWS, 2)).astype(np.int32)}
    mm = np.memmap(path, dtype=np.uint8, mode="r", shape=(N_ROWS, *ROW))
    ours = pipeline.Loader(
        pipeline.ArrayDataset(mm, labels, bin_path=path), bs, True, seed=3,
        extras=extras, **kw)
    ref = jpipeline.Loader(
        jpipeline.ArrayDataset(mm, labels, bin_path=path), bs, True, seed=3,
        extras=extras, **kw)
    return ours, ref


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_loader_over_a_pack_matches_the_jax_loader(pack):
    ours, ref = _loaders(pack, num_workers=3)
    for epoch, start in ((0, 0), (1, 0), (1, 3)):
        for ld in (ours, ref):
            ld.set_epoch(epoch)
            ld.set_start_batch(start)
        got = list(ours)
        assert len(got) == N_ROWS // 4 - start
        _same_batches(got, list(ref))
    # both went through their native batcher
    assert isinstance(ours._batcher, native.NativeBatcher)
    assert isinstance(ref._batcher, jnative.NativeBatcher)


def test_an_abandoned_iteration_leaves_nothing_for_the_next(pack):
    ours, ref = _loaders(pack)
    ours.set_epoch(2)
    ref.set_epoch(2)
    want = list(ref)
    it = iter(ours)
    first = [next(it) for _ in range(2)]   # 4 more are submitted
    it.close()
    _same_batches(first, want[:2])
    _same_batches(list(ours), want)
    for stop_after in (0, 7):              # an exception mid-epoch
        with pytest.raises(KeyError):
            for i, _ in enumerate(ours):
                if i == stop_after:
                    raise KeyError
        _same_batches(list(ours), want)


def test_eval_and_in_memory_loaders_gather_with_numpy(pack):
    ours, _ = _loaders(pack)
    ev = pipeline.Loader(ours.ds, 8, train=False)
    assert [b["mask"].sum() for b in ev] == [8, 8, 8, 8, 5]
    assert ev._batcher is None
    ram = pipeline.Loader(pipeline.ArrayDataset(pack[1], ours.ds.labels), 4,
                          True, seed=3, extras=ours.extras)
    ours.set_epoch(0)
    _same_batches(list(ram), list(ours))
    assert ram._batcher is None


def test_a_failed_batcher_build_raises(pack, tmp_path, monkeypatch):
    broken = tmp_path / "src"
    broken.mkdir()
    (broken / "batcher.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "HERE", broken)
    native._load.cache_clear()
    native.get_lib.cache_clear()
    try:
        ours, _ = _loaders(pack)
        with pytest.raises(RuntimeError, match="g\\+\\+ failed to build "
                                               "batcher.cpp"):
            next(iter(ours))
    finally:
        native._load.cache_clear()
        native.get_lib.cache_clear()


def test_host_libraries_are_built_outside_the_source_tree():
    for name in ("batcher", "decoder"):
        path = native.lib_path(name)
        assert path.parent == native.HOST_BUILD_DIR
        assert path.parent.parts[-3:] == ("build", "moma_tpu_torch", "host")
    assert not list(native.HERE.glob("*.so"))
