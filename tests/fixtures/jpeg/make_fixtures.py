"""Writes this folder's JPEG fixtures with PIL and each file's
``imageio.v2.imread`` decode as ``.npy`` (the bytes the port's decoder must
give).  Run from the repository root:

    python tests/fixtures/jpeg/make_fixtures.py
"""

import io
import os

import imageio.v2 as imageio
import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))

# name: (height, width, grey, PIL save options); no size a multiple of 16.
FIXTURES = {
    "yuv444_q90_29x37": (29, 37, False, dict(quality=90, subsampling=0)),
    "yuv422_q75_23x45": (23, 45, False, dict(quality=75, subsampling=1)),
    "yuv420_q50_33x51": (33, 51, False, dict(quality=50, subsampling=2)),
    "grey_q85_19x29": (19, 29, True, dict(quality=85)),
    "yuv420_q80_rst2_opt_35x47": (35, 47, False, dict(quality=80, subsampling=2, optimize=True,
                                                      restart_marker_blocks=2)),
}


def pattern(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = np.sin(xx / 4.0) * 70 + np.cos(yy / 3.0) * 50 + 120 + rng.integers(0, 40, (h, w))
    return ((base[..., None] + np.array([0, 60, 130])) % 256).astype(np.uint8)


def main():
    for i, (name, (h, w, grey, opts)) in enumerate(sorted(FIXTURES.items())):
        img = pattern(h, w, i)
        im = Image.fromarray(img[..., 0] if grey else img, "L" if grey else "RGB")
        buf = io.BytesIO()
        im.save(buf, format="JPEG", **opts)
        data = buf.getvalue()
        with open(os.path.join(HERE, name + ".jpg"), "wb") as f:
            f.write(data)
        np.save(os.path.join(HERE, name + ".npy"), imageio.imread(data))


if __name__ == "__main__":
    main()
