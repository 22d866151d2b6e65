"""The port's own copies of the JAX-free modules (``wsiseg_tpu_torch.config``,
``.slides``, ``.ops.geometry``, ``.utils.filesystem``) against the JAX
package's: the same configs, the same slide bytes through every reader
``open_slide`` routes to here, and the same tile grids."""

import dataclasses
import os
import tracemalloc

import numpy as np
import pytest

from wsiseg_tpu import config as jax_config
from wsiseg_tpu.ops import geometry as jax_geometry
from wsiseg_tpu.slides import open_slide as jax_open_slide
from wsiseg_tpu.slides.reader import glob_slides as jax_glob_slides
from wsiseg_tpu.utils import filesystem as jax_filesystem
from wsiseg_tpu_torch import config
from wsiseg_tpu_torch.ops import geometry
from wsiseg_tpu_torch.slides import SyntheticSlide, open_slide
from wsiseg_tpu_torch.slides.reader import glob_slides
from wsiseg_tpu_torch.utils import filesystem


@pytest.mark.parametrize("argv", [
    [],
    ["--tile_w", "256", "--tile_h", "128", "--compute_dtype", "float32"],
    ["--raw_val_pth", "/x", "--wsi_mask_pth", "", "--seed", "7",
     "--val_save_pth", "/y"],
])
def test_config_equals_jax(argv):
    assert dataclasses.asdict(config.default_config()) == \
        dataclasses.asdict(jax_config.default_config())
    assert dataclasses.asdict(config.parse_args(argv)) == \
        dataclasses.asdict(jax_config.parse_args(argv))


def test_config_rejects_like_jax():
    for mod in (config, jax_config):
        with pytest.raises(ValueError):
            mod.default_config(tile_w=0)


@pytest.fixture(scope="module")
def slide_files(tmp_path_factory):
    """One pyramid written three ways: .npy (level 0), .wsiraw and a
    tiled TIFF with edge tiles (dims not multiples of 128)."""
    from wsiseg_tpu_torch.slides.native import (write_raw_pyramid,
                                                write_tiled_pyramid)
    d = tmp_path_factory.mktemp("port_slides")
    syn = SyntheticSlide(width=900, height=700, num_levels=2, seed=4)
    levels = [syn.read_level(0), syn.read_level(1)]
    np.save(d / "a.npy", levels[0])
    write_raw_pyramid(str(d / "b.wsiraw"), levels)
    write_tiled_pyramid(str(d / "c.tif"), levels, tile_size=128)
    return d, ("a.npy", "b.wsiraw", "c.tif")


def test_open_slide_reads_jax_bytes(slide_files):
    d, names = slide_files
    for name in names:
        got, ref = open_slide(str(d / name)), jax_open_slide(str(d / name))
        assert type(got).__name__ == type(ref).__name__
        assert got.level_count == ref.level_count
        assert tuple(got.level_dimensions) == tuple(ref.level_dimensions)
        assert tuple(got.level_downsamples) == tuple(ref.level_downsamples)
        for lv in range(ref.level_count):
            np.testing.assert_array_equal(got.read_level(lv),
                                          ref.read_level(lv))
        np.testing.assert_array_equal(
            got.read_region((850, 650), 0, (100, 90)),
            ref.read_region((850, 650), 0, (100, 90)))


def test_glob_slides_equals_jax(slide_files):
    d, _ = slide_files
    for kw in ({}, {"case_dirs": True}, {"include_npy": False}):
        assert glob_slides(str(d), **kw) == jax_glob_slides(str(d), **kw)


@pytest.mark.parametrize("seed", [0, 1])
def test_tile_grid_equals_jax(seed):
    r = np.random.RandomState(seed)
    iw, ih = int(r.randint(600, 2000)), int(r.randint(600, 2000))
    args = (iw, ih, 256, 256, 128, 128)
    got, ref = geometry.wsi_tile_grid(*args), jax_geometry.wsi_tile_grid(*args)
    mask = (r.rand(ih // 4, iw // 4) > 0.6).astype(np.uint8)
    got_f = geometry.filter_grid_by_mask(got, mask, 4.0)
    ref_f = jax_geometry.filter_grid_by_mask(ref, mask, 4.0)
    for g, rf in ((got, ref), (got_f, ref_f)):
        assert len(g) == len(rf)
        for field in dataclasses.fields(rf):
            np.testing.assert_array_equal(getattr(g, field.name),
                                          getattr(rf, field.name))


def _blobs(r, h, w, block, share):
    """Seeded tissue-like foreground: random blocks of ``block`` px (about
    ``share`` of them set) at a random offset, salted so window counts are
    not multiples of a block."""
    coarse = r.rand(h // block + 2, w // block + 2) < share
    blobs = np.repeat(np.repeat(coarse, block, 0), block, 1)
    oy, ox = r.randint(block), r.randint(block)
    return blobs[oy:oy + h, ox:ox + w] ^ (r.rand(h, w) > 0.97)


def _blob_mask(r, h, w):
    """A {0,255} u8 mask at the benchmark's level-2 size and blob scale."""
    return _blobs(r, h, w, 384, 0.4).astype(np.uint8) * 255


def _masks(r, h, w):
    """The same foreground as {0,1} u8, {0,255} u8, bool, {-1,1} i16
    (background below zero) and a non-contiguous view (a slice of a wider
    array). The left third is background, as a slide's margin."""
    fg = _blobs(r, h, w, 48, 0.2)
    fg[:, :w // 3] = False
    wide = np.concatenate([fg, np.ones((h, 7), bool)], 1).astype(np.uint8)
    return {"u8_01": fg.astype(np.uint8), "u8_0255": fg.astype(np.uint8) * 255,
            "bool": fg, "i16_pm1": fg.astype(np.int16) * 2 - 1,
            "view": wide[:, :w]}


def _filter_case(name):
    """(grid, mask, mask scale, the (x, y) origins kept or None)."""
    r = np.random.RandomState(FILTER_CASES.index(name))
    if name.startswith("scale"):
        _, m, kind = name.split("_", 2)
        m = {"0.25": 0.25, "2/3": 2 / 3, "1": 1.0, "4": 4.0}[m]
        iw, ih = int(r.randint(600, 1500)), int(r.randint(600, 1500))
        t = max(int(64 / m), 8)
        grid = geometry.wsi_tile_grid(iw, ih, t, t, t // 2, t // 2)
        # a few mask rows and columns short of the image: the edge-snap
        # windows are clipped at the mask's far edge
        mask = _masks(r, int(ih * m) - 3, int(iw * m) - 5)[kind]
        assert kind != "view" or not mask.flags.c_contiguous
        return grid, mask, m, None
    if name == "far_edge":
        mask = np.ones((40, 50), np.uint8)
        grid = geometry.TileGrid(
            np.array([0, 30, 45, 50, 60, 10, 12], np.int32),
            np.array([0, 20, 35, 10, 0, 40, 45], np.int32), 16, 16, 70, 70)
        # clipped windows are kept; windows starting at or beyond the
        # edge are empty and dropped
        return grid, mask, 1.0, [(0, 0), (30, 20), (45, 35)]
    if name == "exact_thresh":
        mask = np.zeros((64, 64), np.uint8)
        mask[0, :20] = 1            # 20 of 400 = thresh · size: kept
        mask[0, 30:49] = 1          # 19 of 400: dropped
        mask[30, :21] = 1           # 21 of 400: kept
        grid = geometry.TileGrid(np.array([0, 30, 0], np.int32),
                                 np.array([0, 0, 30], np.int32),
                                 20, 20, 64, 64)
        return grid, mask, 1.0, [(0, 0), (0, 30)]
    if name == "empty_grid":
        grid = geometry.TileGrid(np.zeros(0, np.int32), np.zeros(0, np.int32),
                                 32, 32, 256, 256)
        return grid, np.ones((64, 64), np.uint8), 0.25, []
    if name == "dy_zero":
        grid = geometry.TileGrid(np.array([0, 8], np.int32),
                                 np.array([4, 0], np.int32), 8, 3, 32, 32)
        # a window under one mask row: the grid passes ungated
        return grid, np.zeros((8, 8), np.uint8), 0.25, [(0, 4), (8, 0)]
    if name == "short_slide":
        # a level lower than the tile: the edge-snap row's origin is
        # negative, and so is its window's top corner
        grid = geometry.wsi_tile_grid(900, 200, 256, 256, 128, 128)
        assert (grid.ys < 0).any()
        mask = np.zeros((50, 225), np.uint8)
        mask[30:, :100] = 1
        mask[:30, 100:] = 1         # above the wrapped rows: not counted
        return grid, mask, 0.25, None
    assert name == "bench"
    grid = geometry.wsi_tile_grid(4096, 3072, 512, 512, 128, 128)
    return grid, _blob_mask(r, 3072, 4096), 1.0, None


FILTER_CASES = ([f"scale_{m}_{k}" for m in ("0.25", "2/3", "1", "4")
                 for k in ("u8_01", "u8_0255", "bool", "i16_pm1", "view")]
                + ["far_edge", "exact_thresh", "empty_grid", "dy_zero",
                   "short_slide", "bench"])


@pytest.mark.parametrize("case", FILTER_CASES)
def test_filter_grid_equals_jax(case):
    grid, mask, m, kept = _filter_case(case)
    ref_grid = jax_geometry.TileGrid(**{
        f.name: getattr(grid, f.name) for f in dataclasses.fields(grid)})
    got = geometry.filter_grid_by_mask(grid, mask, m)
    ref = jax_geometry.filter_grid_by_mask(ref_grid, mask, m)
    assert len(got) == len(ref)
    for field in dataclasses.fields(ref):
        a, b = getattr(got, field.name), getattr(ref, field.name)
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype
    if kept is not None:
        assert list(zip(got.xs.tolist(), got.ys.tolist())) == kept
    else:
        assert 0 < len(got) < len(grid)


def test_filter_grid_memory_stays_under_two_masks():
    """The filter's scratch memory is about one band of the mask, not a
    full-size table: its peak stays under twice the mask's bytes."""
    mask = _blob_mask(np.random.RandomState(5), 3072, 4096)
    grid = geometry.wsi_tile_grid(4096, 3072, 512, 512, 128, 128)
    tracemalloc.start()
    try:
        got = geometry.filter_grid_by_mask(grid, mask, 1.0)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert 0 < len(got) < len(grid)
    assert peak < 2 * mask.nbytes, (peak, mask.nbytes)


def test_make_folder_equals_jax(tmp_path):
    for k, mod in enumerate((filesystem, jax_filesystem)):
        p = tmp_path / str(k) / "a" / "b"
        mod.make_folder(str(p))
        mod.make_folder(str(p))
        assert os.path.isdir(p)
