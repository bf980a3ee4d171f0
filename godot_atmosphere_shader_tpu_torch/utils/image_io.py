"""Image export: a dependency-free PNG codec and the cubemap atlas
pipeline (numpy and zlib only).

Counterpart of ``godot_atmosphere_shader_tpu/utils/image_io.py``: the
editor export flow of ``tools/plugin.gd:39-103`` — a NoiseCubemap's six
faces packed into a 3×2 atlas (``noise_cubemap.gd:143-155``) and written as
a PNG with a Godot ``.import`` sidecar (cubemap importer, lossless, 3×2
arrangement), so a game loads the baked cubemap instead of regenerating
it.  The PNG bytes are the JAX package's, byte for byte.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """Write an 8-bit PNG.  ``image``: uint8 ``(H, W)`` gray or ``(H, W, 3|4)``."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError("write_png expects uint8 (use to_uint8)")
    if image.ndim == 2:
        color_type = 0
        channels = 1
    elif image.shape[2] == 3:
        color_type = 2
        channels = 3
    elif image.shape[2] == 4:
        color_type = 6
        channels = 4
    else:
        raise ValueError(f"unsupported image shape {image.shape}")

    h, w = image.shape[:2]
    raw = image.reshape(h, w * channels)
    scanlines = b"".join(b"\x00" + raw[y].tobytes() for y in range(h))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                                color_type, 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(scanlines, 6)))
        f.write(_png_chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader for our own files (8-bit, no interlace)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos = 8
    idat = b""
    w = h = color_type = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        chunk = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, bit_depth, color_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", chunk)
            assert bit_depth == 8 and interlace == 0
        elif tag == b"IDAT":
            idat += chunk
        elif tag == b"IEND":
            break
    channels = {0: 1, 2: 3, 6: 4}[color_type]
    raw = zlib.decompress(idat)
    stride = w * channels
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for y in range(h):
        filt = raw[pos]
        line = np.frombuffer(raw[pos + 1:pos + 1 + stride], np.uint8).astype(np.int32)
        pos += 1 + stride
        if filt == 0:
            cur = line
        elif filt == 1:
            cur = line.copy()
            for x in range(channels, stride):
                cur[x] = (cur[x] + cur[x - channels]) & 0xFF
        elif filt == 2:
            cur = (line + prev) & 0xFF
        elif filt == 3:
            cur = line.copy()
            for x in range(stride):
                left = cur[x - channels] if x >= channels else 0
                cur[x] = (cur[x] + ((left + prev[x]) >> 1)) & 0xFF
        elif filt == 4:
            cur = line.copy()
            for x in range(stride):
                a = cur[x - channels] if x >= channels else 0
                b = prev[x]
                c = prev[x - channels] if x >= channels else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
        else:
            raise ValueError(f"unsupported PNG filter {filt}")
        out[y] = cur.astype(np.uint8)
        prev = cur
    img = out.reshape(h, w, channels)
    return img[..., 0] if channels == 1 else img


def read_image_rgb(path: str) -> np.ndarray:
    """Decode any common image (webp/png/jpg…) to uint8 (H, W, 3).

    The reference demo's panorama is a ``.webp``
    (``demo/planet_atmosphere_test.tscn`` → ``space_background.webp``);
    PNGs go through the dependency-free codec above, everything else
    through PIL when available.  Raises ``ValueError`` when the format
    can't be decoded in this environment.
    """
    if path.lower().endswith(".png"):
        img = read_png(path)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        return np.ascontiguousarray(img[..., :3])
    try:
        from PIL import Image
    except ImportError as e:  # PIL is optional: PNGs need none
        raise ValueError(
            f"cannot decode {path!r}: non-PNG image and PIL unavailable "
            "(pre-convert to .png)") from e
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def to_uint8(image: np.ndarray) -> np.ndarray:
    """[0,1] float → uint8 with round-to-nearest."""
    return np.clip(np.asarray(image) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def cubemap_atlas(faces: np.ndarray) -> np.ndarray:
    """Pack ``(6, res, res)`` faces into the 3×2 atlas layout of
    ``noise_cubemap.gd:143-155`` (row-major: faces 0,1,2 / 3,4,5)."""
    faces = np.asarray(faces)
    _, res, _ = faces.shape
    atlas = np.zeros((2 * res, 3 * res), faces.dtype)
    for i in range(6):
        y, x = divmod(i, 3)
        atlas[y * res:(y + 1) * res, x * res:(x + 1) * res] = faces[i]
    return atlas


def atlas_to_cubemap(atlas: np.ndarray) -> np.ndarray:
    """Inverse of :func:`cubemap_atlas`."""
    atlas = np.asarray(atlas)
    res = atlas.shape[0] // 2
    faces = np.zeros((6, res, res), atlas.dtype)
    for i in range(6):
        y, x = divmod(i, 3)
        faces[i] = atlas[y * res:(y + 1) * res, x * res:(x + 1) * res]
    return faces


#: .import sidecar matching tools/plugin.gd:63-80 (cubemap importer, 3×2,
#: lossless) so the exported PNG drops into a Godot project unchanged.
_IMPORT_TEMPLATE = """[remap]

importer="cubemap_texture"
type="CompressedCubemap"

[deps]

source_file="res://{name}"

[params]

compress/mode=3
compress/high_quality=false
compress/lossy_quality=0.7
compress/hdr_compression=1
compress/normal_map=0
compress/channel_pack=0
mipmaps/generate=false
mipmaps/limit=-1
roughness/mode=0
roughness/src_normal=""
process/fix_alpha_border=true
process/premult_alpha=false
process/normal_map_invert_y=false
process/hdr_as_srgb=false
process/hdr_clamp_exposure=false
process/size_limit=0
detect_3d/compress_to=1
slices/arrangement=1
"""


def write_import_file(png_path: str) -> str:
    """Write the Godot ``.import`` sidecar (``tools/plugin.gd:91-103``)."""
    import os

    name = os.path.basename(png_path)
    out = png_path + ".import"
    with open(out, "w") as f:
        f.write(_IMPORT_TEMPLATE.format(name=name))
    return out
