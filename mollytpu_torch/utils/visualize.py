"""Trajectory visualization without plotting dependencies.

The port's numpy copy of mollytpu/utils/visualize.py: renders frames
(numpy arrays or tensors on any device) as orthographic-projection
PPM images (pure numpy) and optionally assembles an animated GIF
(uncompressed GIF89a, also pure python). Suitable for quick looks in any
image viewer; no GLMakie/matplotlib needed in the image.
"""

from __future__ import annotations

import numpy as np


def _host(x):
    """A numpy array of x, which may be a tensor on the card."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def render_frame(coords, boundary=None, size=512, radius=3,
                 colors=None, axis=2):
    """Render one frame to an (H, W, 3) uint8 image (orthographic along
    `axis`, depth-shaded)."""
    c = _host(coords)
    keep = [i for i in range(3) if i != axis]
    xy = c[:, keep]
    depth = c[:, axis]
    if boundary is not None:
        sides = _host(boundary.side_lengths)
        lo = np.zeros(2)
        hi = sides[keep]
        dlo, dhi = 0.0, float(sides[axis])
    else:
        lo = xy.min(axis=0) - 0.1
        hi = xy.max(axis=0) + 0.1
        dlo, dhi = float(depth.min()), float(depth.max()) + 1e-9
    img = np.zeros((size, size, 3), dtype=np.uint8)
    px = ((xy - lo) / np.maximum(hi - lo, 1e-9) * (size - 1)).astype(int)
    px = np.clip(px, 0, size - 1)
    shade = 0.35 + 0.65 * (depth - dlo) / max(dhi - dlo, 1e-9)
    if colors is None:
        colors = np.tile(np.asarray([[90, 160, 255]]), (c.shape[0], 1))
    else:
        colors = np.asarray(colors)
    order = np.argsort(depth)  # far first
    yy, xx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    disk = (yy ** 2 + xx ** 2) <= radius ** 2
    dy, dx = np.nonzero(disk)
    dy, dx = dy - radius, dx - radius
    for i in order:
        col = np.clip(colors[i % len(colors)] * shade[i], 0, 255)
        ys = np.clip(px[i, 1] + dy, 0, size - 1)
        xs = np.clip(px[i, 0] + dx, 0, size - 1)
        img[size - 1 - ys, xs] = col.astype(np.uint8)
    return img


def write_ppm(path, img):
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(img.tobytes())


def _gif_palette(img, n=128):
    flat = img.reshape(-1, 3)
    # 3-3-2 bit quantization palette
    q = (flat[:, 0] >> 5) << 5 | (flat[:, 1] >> 5) << 2 | (flat[:, 2] >> 6)
    return q.astype(np.uint8)


def visualize(coord_frames, path, boundary=None, size=256, radius=2,
              colors=None, delay_cs=5):
    """Render stacked (T, N, 3) coordinates to an animated GIF (or a single
    PPM when path ends in .ppm)."""
    frames = (_host(coord_frames) if hasattr(coord_frames, "detach")
              else np.asarray(coord_frames))
    if frames.ndim == 2:
        frames = frames[None]
    if path.endswith(".ppm"):
        write_ppm(path, render_frame(frames[-1], boundary, size, radius,
                                     colors))
        return path
    # GIF89a with a global 3-3-2 palette and uncompressed-style LZW
    with open(path, "wb") as f:
        f.write(b"GIF89a")
        f.write(np.uint16(size).tobytes() + np.uint16(size).tobytes())
        f.write(bytes([0xF7, 0, 0]))  # GCT 256 entries
        pal = bytearray()
        for i in range(256):
            r = (i >> 5) & 7
            g = (i >> 2) & 7
            b = i & 3
            pal += bytes([r * 255 // 7, g * 255 // 7, b * 255 // 3])
        f.write(bytes(pal))
        f.write(b"\x21\xFF\x0BNETSCAPE2.0\x03\x01\x00\x00\x00")  # loop
        for t in range(frames.shape[0]):
            img = render_frame(frames[t], boundary, size, radius, colors)
            idx = _gif_palette(img)
            f.write(b"\x21\xF9\x04\x00" + np.uint16(delay_cs).tobytes()
                    + b"\x00\x00")
            f.write(b"\x2C\x00\x00\x00\x00"
                    + np.uint16(size).tobytes() + np.uint16(size).tobytes()
                    + b"\x00")
            f.write(bytes([8]))  # LZW min code size
            # emit 9-bit codes: CLEAR before every pixel so no table needed
            bits = bytearray()
            acc = 0
            nbits = 0

            def put(code, acc, nbits):
                acc |= code << nbits
                nbits += 9
                while nbits >= 8:
                    bits.append(acc & 0xFF)
                    acc >>= 8
                    nbits -= 8
                return acc, nbits

            CLEAR, END = 256, 257
            acc, nbits = put(CLEAR, acc, nbits)
            for k, v in enumerate(idx.tolist()):
                acc, nbits = put(v, acc, nbits)
                if (k + 1) % 100 == 0:
                    acc, nbits = put(CLEAR, acc, nbits)
            acc, nbits = put(END, acc, nbits)
            if nbits:
                bits.append(acc & 0xFF)
            for off in range(0, len(bits), 255):
                chunk = bits[off:off + 255]
                f.write(bytes([len(chunk)]) + bytes(chunk))
            f.write(b"\x00")
        f.write(b"\x3B")
    return path
