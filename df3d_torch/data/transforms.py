"""The composed per-sample training transform (port of
df3d/data/transforms.py): the df3d analog of pcdet's DataAugmentor chain
and det3d's Preprocess.

`make_train_transform` returns a callable for `PrefetchLoader`'s
`transform`: gt-database sampling (with the depth-ordered image paste when
asked), then world flip, rotation, scaling and translation, the drawn
values recorded under `aug_params` for the camera projection to undo. The
train CLI passes no transform, as the JAX package's does.
"""

from __future__ import annotations

import numpy as np

from df3d_torch.data.augment import (
    GTSampler, WorldAugParams, apply_world_augs, paste_objects_to_image,
    project_box_to_image_bbox,
)


def make_train_transform(
    gt_sampler: GTSampler | None = None,
    flip_axes=("x",),
    rot_range=(-0.785, 0.785),
    scale_range=(0.95, 1.05),
    translate_std: float | None = None,
    image_paste: bool = False,
    class_names=("Car",),
):
    aug_cfg = dict(
        flip_axes=flip_axes, rot_range=rot_range, scale_range=scale_range,
        translate_std=translate_std,
    )

    def transform(sample: dict, rng: np.random.RandomState) -> dict:
        points = sample["points"]
        boxes = sample.get("gt_boxes")
        names = sample.get("gt_names")

        if gt_sampler is not None:
            n_before = 0 if boxes is None else len(boxes)
            # road-plane lift only on the LiDAR-only path (the reference
            # disables it when image-pasting — database_sampler.py:246)
            points, boxes, names, infos = gt_sampler(
                points, boxes, names, rng,
                road_plane=(None if image_paste
                            else sample.get("road_plane")),
                calib=sample.get("calib"))
            if (
                image_paste and "image" in sample and "proj" in sample
                and boxes is not None and len(boxes) > n_before
            ):
                # composite the SAMPLED objects' STORED db crops into the
                # camera image, ordered by depth (pcdet database_sampler
                # copy_paste_to_image); objects whose db entry carries no
                # crop are skipped, never faked
                new = boxes[n_before:]
                crops, bboxes2d, depths = [], [], []
                h, w = sample["image"].shape[:2]
                for b, info in zip(new, infos):
                    crop = gt_sampler.load_crop(info)
                    if crop is None or crop.size == 0:
                        continue
                    bb, depth = project_box_to_image_bbox(
                        b[:7], sample["proj"], (h, w)
                    )
                    if bb[2] - bb[0] < 2 or bb[3] - bb[1] < 2 or depth <= 0.1:
                        continue
                    crops.append(crop.astype(sample["image"].dtype, copy=False))
                    bboxes2d.append(bb)
                    depths.append(depth)
                if crops:
                    sample["image"] = paste_objects_to_image(
                        sample["image"], crops, np.asarray(bboxes2d), depths
                    )

        points, boxes, params = apply_world_augs(points, boxes, rng, aug_cfg)

        out = dict(sample)
        out["points"] = points
        if boxes is not None:
            out["gt_boxes"] = boxes
            out["gt_names"] = names
            out["gt_classes"] = np.array(
                [list(class_names).index(n) if n in class_names else 0
                 for n in names], np.int32,
            )
        out["aug_params"] = params
        return out

    return transform
