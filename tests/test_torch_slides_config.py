"""The port's own copies of the JAX-free modules (``wsiseg_tpu_torch.config``,
``.slides``, ``.ops.geometry``, ``.utils.filesystem``) against the JAX
package's: the same configs, the same slide bytes through every reader
``open_slide`` routes to here, and the same tile grids."""

import dataclasses
import os

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


def test_make_folder_equals_jax(tmp_path):
    for k, mod in enumerate((filesystem, jax_filesystem)):
        p = tmp_path / str(k) / "a" / "b"
        mod.make_folder(str(p))
        mod.make_folder(str(p))
        assert os.path.isdir(p)
