"""Camera files (port of custom_diffusion360_tpu/io/cameras_io.py): a
plain ``.npz`` with the R/T/focal_length/principal_point/image_size arrays
of each split under ``<split>.<field>``. The converter from the reference's
torch ``camera.bin`` needs pytorch3d and is not ported."""
from __future__ import annotations

import numpy as np

from ..geometry.cameras import Cameras


def save_cameras_npz(path: str, **splits: Cameras) -> None:
    """save_cameras_npz(p, train=cams_train, val=cams_val)"""
    data = {}
    for name, cams in splits.items():
        for field in Cameras._fields:
            data[f"{name}.{field}"] = np.asarray(getattr(cams, field).detach().cpu())
    np.savez(path, **data)


def load_cameras_npz(path: str) -> dict:
    """{split: Cameras} of float32 CPU tensors."""
    with np.load(path) as f:
        raw = dict(f)
    splits: dict = {}
    for key, val in raw.items():
        name, field = key.rsplit(".", 1)
        splits.setdefault(name, {})[field] = val
    return {
        name: Cameras.create(fields["R"], fields["T"], fields["focal_length"],
                             fields["principal_point"], fields["image_size"])
        for name, fields in splits.items()
    }
