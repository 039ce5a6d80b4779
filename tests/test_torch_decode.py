"""Image-folder decoding (core/data.py) without silent fallbacks.

- cv2 reads what it can, PIL what cv2 cannot (here a GIF that cv2 is made
  to refuse: cv2 builds differ in GIF support); `decoders` counts the files
  each read. A PNG decodes, crops and resizes to exactly the JAX
  package's `load_image` result.
- A file that no decoder reads raises an error naming the file and every
  decoder tried, also when cv2 or both decoders are missing.
"""

import sys

import cv2
import numpy as np
import pytest
from PIL import Image

from imagegeneration_tpu.core import data as jdata
from imagegeneration_tpu_torch.core import data as tdata

SIZE = (24, 40)


@pytest.fixture()
def folder(tmp_path):
    rng = np.random.default_rng(4)
    d = tmp_path / "data" / "landscape"
    d.mkdir(parents=True)
    for name, (h, w) in (("a.png", (30, 70)), ("b.jpg", (50, 40))):
        cv2.imwrite(str(d / name), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    Image.fromarray(rng.integers(0, 256, (20, 20, 3), dtype=np.uint8)).save(d / "c.gif")
    return tmp_path / "data"


def test_decoders_are_counted_and_match_jax(folder, monkeypatch):
    imread = cv2.imread
    monkeypatch.setattr(cv2, "imread",
                        lambda path, flags: None if path.endswith(".gif") else imread(path, flags))
    ds = tdata.ImageFolderDataset(folder, SIZE)
    assert ds.decoders == {"cv2": 2, "PIL": 1}
    assert ds.images.shape == (3, *SIZE, 3)
    png = folder / "landscape" / "a.png"
    np.testing.assert_array_equal(tdata.load_image(png, SIZE), jdata.load_image(png, SIZE))


def test_an_unreadable_file_names_itself_and_the_decoders(folder, monkeypatch):
    bad = folder / "landscape" / "d.jpg"
    bad.write_bytes(b"not an image")
    with pytest.raises(ValueError, match=r"d\.jpg: tried cv2 \(cannot read it\); PIL"):
        tdata.ImageFolderDataset(folder, SIZE)
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 now raises ImportError
    with pytest.raises(ValueError, match=r"d\.jpg: tried cv2 \(not installed\); PIL \("):
        tdata.load_image(bad, SIZE)
    bad.unlink()
    assert tdata.ImageFolderDataset(folder, SIZE).decoders == {"PIL": 3}
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ValueError, match=r"tried cv2 \(not installed\); PIL \(not installed\)"):
        tdata.load_image(folder / "landscape" / "a.png", SIZE)
