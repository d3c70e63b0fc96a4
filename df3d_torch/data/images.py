"""Camera images on the host: decode, resize, normalize, pad (port of
df3d/data/images.py).

The counterparts of det3d's `LoadPointCloudImageFromFile`, mmdet3d's
`LoadMultiViewImageFromFiles` with `MyResize` (keep_ratio), `MyNormalize`
and `MyPad`, and pcdet's `get_image`. Everything runs in numpy at static
shapes: the model takes (n_cam, H, W, 3) float32 images and (3, 4)
lidar -> image projections with the applied resize folded into their
first two rows. Pillow decodes and resizes (its bilinear filter, as the
reference's pipelines use), reads an image's size from its header and
writes JPEGs; it is imported inside the functions that need it, and an
image already at its target size needs none.
"""

from __future__ import annotations

import numpy as np

# the img_norm_cfg of every 3D-Dual-Fusion config (mmdet3d / det3d)
IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)


def decode_image(path) -> np.ndarray:
    """JPEG/PNG -> (H, W, 3) uint8 RGB."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "decoding camera images needs Pillow (PIL); install it or train "
            f"with --synthetic: {e}") from e
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def read_image_shape(path) -> tuple[int, int]:
    """An image file's (H, W), read from its header (nothing decoded)."""
    from PIL import Image

    with Image.open(path) as im:
        w, h = im.size
    return h, w


def write_jpeg(path, rgb: np.ndarray, quality: int = 90) -> None:
    """(H, W, 3) uint8 -> a baseline JPEG file, as nuScenes stores its
    camera images."""
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(rgb, np.uint8)).save(
        path, format="JPEG", quality=quality)


def resize_normalize_pad(img: np.ndarray, target_hw: tuple[int, int],
                         mean: np.ndarray = IMAGENET_MEAN,
                         std: np.ndarray = IMAGENET_STD,
                         keep_ratio: bool = True):
    """uint8 (H, W, 3) -> (float32 (th, tw, 3), the (sy, sx) scale
    applied).

    MyResize(keep_ratio=True): one scale, the smaller of target / size over
    the two axes, bilinear; MyNormalize (RGB mean and std); MyPad with
    zeros at the bottom and right. The scale returned is the one the
    rounded size applies, so that projections scaled by it land on the
    resized image's pixels."""
    th, tw = int(target_hw[0]), int(target_hw[1])
    h, w = img.shape[:2]
    if keep_ratio:
        sy = sx = min(th / h, tw / w)
    else:
        sy, sx = th / h, tw / w
    nh = min(th, max(1, int(round(h * sy))))
    nw = min(tw, max(1, int(round(w * sx))))
    if (nh, nw) != (h, w):
        from PIL import Image

        img = np.asarray(Image.fromarray(img).resize((nw, nh),
                                                     Image.BILINEAR))
        sy, sx = nh / h, nw / w
    out = np.zeros((th, tw, 3), np.float32)
    out[:nh, :nw] = (img.astype(np.float32) - mean) / std
    return out, (sy, sx)


def scale_projection(proj: np.ndarray, sy: float, sx: float) -> np.ndarray:
    """A resize folded into a (3, 4) lidar -> image projection: u' = sx u,
    v' = sy v (rows 0 and 1 scaled, the depth row kept)."""
    out = np.asarray(proj, np.float32).copy()
    out[0] *= sx
    out[1] *= sy
    return out


def load_camera_frame(paths, projs: np.ndarray, target_hw: tuple[int, int],
                      mean: np.ndarray = IMAGENET_MEAN,
                      std: np.ndarray = IMAGENET_STD,
                      keep_ratio: bool = True):
    """One frame's cameras: image files and their (n_cam, 3, 4) projections
    at the files' resolution -> (images (n_cam, th, tw, 3) float32, proj
    (n_cam, 3, 4) with the resize folded in)."""
    images, out_projs = [], []
    for path, proj in zip(paths, np.asarray(projs, np.float32)):
        img, (sy, sx) = resize_normalize_pad(decode_image(path), target_hw,
                                             mean, std, keep_ratio)
        images.append(img)
        out_projs.append(scale_projection(proj, sy, sx))
    return np.stack(images), np.stack(out_projs)


def finalize_camera_sample(sample: dict, target_hw: tuple[int, int],
                           mean: np.ndarray = IMAGENET_MEAN,
                           std: np.ndarray = IMAGENET_STD) -> dict:
    """A one-camera sample (KITTI) after augmentation: its raw uint8
    `image` (H, W, 3) and `proj` (3, 4) -> a copy with `images` (1, th, tw,
    3) float32 and `proj` (1, 3, 4), the multi-camera layout."""
    img, (sy, sx) = resize_normalize_pad(sample["image"], target_hw, mean,
                                         std)
    sample = dict(sample)
    sample["images"] = img[None]
    sample["proj"] = scale_projection(sample["proj"], sy, sx)[None]
    return sample
