"""Frames decoded from image files: the port's loaders against the JAX
package's, bit for bit.

Both decode with PIL and resize with PIL's ``Image.resize`` at its default
filter. The frames are seeded PNG and JPEG files away from model size
(96x112 and 720x1280 -> 128), read through ``load_video_frames`` (a
directory and a path list) and ``AsyncFrameLoader``. At model size both
resizes are the identity, so only frames of another size tell the loaders
apart (the torch bilinear that the port once used here was up to 106 uint8
levels away at 720x1280 -> 128).
"""

import os

import numpy as np
import pytest

import det_sam2_tpu.utils.misc as jax_misc
from det_sam2_tpu_torch.utils import misc

Image = pytest.importorskip("PIL.Image")

SIZE = 128  # the model size the frames are resized to


def _write_frames(path, hw, ext, n=3, seed=0):
    rng = np.random.default_rng(seed)
    h, w = hw
    for i in range(n):
        f = rng.integers(0, 256, (h, w, 3), np.uint8)
        f[h // 4:h // 2, w // 3:w // 2] = (230, 60, 50)  # an edge to smooth
        Image.fromarray(f).save(os.path.join(path, f"{i}{ext}"))
    return str(path)


@pytest.mark.parametrize("ext", [".png", ".jpg"])
@pytest.mark.parametrize("hw", [(96, 112), (720, 1280)], ids=["96x112", "720x1280"])
def test_image_file_frames_equal_jax(tmp_path, ext, hw):
    d = _write_frames(tmp_path, hw, ext)
    paths = misc.list_frame_dir(d)
    assert paths == jax_misc.list_frame_dir(d) and len(paths) == 3
    for src in (d, paths):
        got, gh, gw = misc.load_video_frames(src, SIZE)
        want, wh, ww = jax_misc.load_video_frames(src, SIZE)
        assert (gh, gw) == (wh, ww) == hw
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.dtype == np.uint8 and g.shape == (SIZE, SIZE, 3)
            np.testing.assert_array_equal(g, w)
    loader = misc.AsyncFrameLoader(paths, SIZE)
    jloader = jax_misc.AsyncFrameLoader(paths, SIZE)
    for i in range(3):
        np.testing.assert_array_equal(loader[i], jloader[i])
    assert (loader.video_height, loader.video_width) == hw
