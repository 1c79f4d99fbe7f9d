"""The port's host data pipeline vs the JAX package, on the CPU: the CO3D
dataset's items and the loader's batches (on the synthetic tree of
tests/test_data.py), the native preprocessing library, and the camera
helpers the loader runs in numpy.

Tolerances: items and batches equal (the same numpy and PIL code on the
same generator; the cameras within 1e-6), the native functions equal, the
camera helpers within 1e-6 of max(1, max|JAX|).
"""
import numpy as np
import pytest
import torch

from custom_diffusion360_tpu.data import co3d as jco3d
from custom_diffusion360_tpu.data import native as jnative
from custom_diffusion360_tpu.data.tokenizer import make_test_tokenizer as j_tokenizer
from custom_diffusion360_tpu.geometry import cameras as jcam
from custom_diffusion360_torch.data import co3d as tco3d
from custom_diffusion360_torch.data import native as tnative
from custom_diffusion360_torch.data.tokenizer import make_test_tokenizer as t_tokenizer
from custom_diffusion360_torch.geometry import cameras as tcam
from tests.test_cameras import random_cameras
from tests.test_data import make_synthetic_co3d

CAM_TOL = 1e-6
WORDS = ["photo", "of", "a", "car"]


@pytest.fixture(scope="module")
def co3d_root(tmp_path_factory):
    return make_synthetic_co3d(tmp_path_factory.mktemp("co3d"))


def _fields(cams):
    return [np.asarray(f) for f in tuple(cams)]


def _assert_cams(got, want, tol=CAM_TOL):
    for g, w in zip(_fields(got), _fields(want)):
        assert g.shape == w.shape
        assert np.abs(g - w).max(initial=0.0) <= tol * max(1.0, np.abs(w).max(initial=0.0))


CONFIGS = {
    "train": dict(img_size=64, num_images=3, repeat=2),
    "capture": dict(img_size=64, num_images=2, repeat=1, addlen=True, onlyref=True,
                    drop_ratio=0.0, drop_txt=0.0),
    "test_split_no_bbox": dict(img_size=32, num_images=4, repeat=1, split="test", bbox=False,
                               drop_ratio=0.5),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_items_equal_jax(co3d_root, name):
    kw = dict(CONFIGS[name], root=co3d_root)
    jds = jco3d.Co3dDataset(jco3d.Co3dConfig(**kw))
    tds = tco3d.Co3dDataset(tco3d.Co3dConfig(**kw))
    assert tds.valid_ids == jds.valid_ids and len(tds) == len(jds)
    for i in range(len(jds)):
        want = jds.__getitem__(i, rng=np.random.default_rng([7, i]))
        got = tds.__getitem__(i, rng=np.random.default_rng([7, i]))
        assert set(got) == set(want)
        for k, w in want.items():
            if k == "cams":
                _assert_cams(got[k], w)
            elif isinstance(w, (list, str)):
                assert got[k] == w, k
            else:
                assert np.asarray(got[k]).dtype == np.asarray(w).dtype, k
                np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(w), err_msg=k)
    # validation items (no dropout draws), as the capture pass reads them
    want = jds.__getitem__(0, rng=np.random.default_rng(0), validation=True)
    got = tds.__getitem__(0, rng=np.random.default_rng(0), validation=True)
    np.testing.assert_array_equal(got["image_ref"], want["image_ref"])


@pytest.mark.parametrize("num_workers", [0, 2])
def test_loader_batches_equal_jax(co3d_root, num_workers):
    kw = dict(CONFIGS["train"], root=co3d_root)
    jtok, ttok = j_tokenizer(WORDS), t_tokenizer(WORDS)
    jl = jco3d.DataLoader(jco3d.Co3dDataset(jco3d.Co3dConfig(**kw)), 2, jtok, jtok, seed=3,
                          num_workers=num_workers)
    tl = tco3d.DataLoader(tco3d.Co3dDataset(tco3d.Co3dConfig(**kw)), 2, ttok, ttok, seed=3,
                          num_workers=num_workers)
    assert len(tl) == len(jl)
    n = 0
    for want, got in zip(jl, tl):
        assert set(got) == set(want)
        for k, w in want.items():
            if k in ("txt", "txt_ref"):
                assert got[k] == w
            elif k == "cams":
                assert all(isinstance(f, torch.Tensor) for f in got[k])
                _assert_cams(got[k], w)
            else:
                assert isinstance(got[k], torch.Tensor)
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(w), err_msg=k)
        n += 1
    assert n == len(jl)


def test_loader_stops_its_thread_when_closed(co3d_root):
    import threading

    ds = tco3d.Co3dDataset(tco3d.Co3dConfig(**dict(CONFIGS["train"], root=co3d_root)))
    before = threading.active_count()
    it = iter(tco3d.DataLoader(ds, 1, num_workers=2, prefetch=1))
    next(it)
    it.close()
    assert threading.active_count() == before


def test_collate_device_none_and_cpu_give_cpu_tensors(co3d_root):
    ds = tco3d.Co3dDataset(tco3d.Co3dConfig(**dict(CONFIGS["train"], root=co3d_root)))
    items = [ds.__getitem__(i, rng=np.random.default_rng(i)) for i in range(2)]
    for device in (None, "cpu"):
        batch = tco3d.collate(items, device=device)
        assert batch["image"].device.type == "cpu" and batch["image"].shape == (2, 64, 64, 3)
        assert batch["cams"].R.shape == (2, 3, 3, 3) and isinstance(batch["cams"].R, torch.Tensor)
        assert batch["original_size_ref"].shape == (4, 2)


def test_native_library_matches_jax_native():
    assert tnative.native_available()
    assert tnative.wrapper.library_path().parent.name == "_build"
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (37, 53, 3), np.uint8)
    np.testing.assert_array_equal(tnative.resize_bicubic_to_pm1(img, 24, 16),
                                  jnative.resize_bicubic_to_pm1(img, 24, 16))
    m = (rng.uniform(size=(21, 17)) > 0.9).astype(np.float32)
    np.testing.assert_array_equal(tnative.dilate7(m), jnative.dilate7(m))
    for x0, y0 in ((-5, 3), (10, -7), (40, 30)):
        np.testing.assert_array_equal(tnative.crop_u8(img, x0, y0, 20, 25),
                                      jnative.crop_u8(img, x0, y0, 20, 25))


def _host(jc):
    """The same cameras as JAX host (numpy) and port host cameras."""
    fields = [np.asarray(f) for f in tuple(jc)]
    return jcam.Cameras(*fields), tcam.Cameras(*fields)


def test_normalize_cameras_matches_jax():
    jc, tc = _host(random_cameras(7, seed=3))
    jn, jp, js = jcam.normalize_cameras(jc)
    tn, tp, ts = tcam.normalize_cameras(tc)
    _assert_cams(tn, jn)
    assert np.abs(tp - np.asarray(jp)).max() <= CAM_TOL * max(1.0, np.abs(jp).max())
    assert abs(float(ts) - float(js)) <= CAM_TOL * float(js)
    jpi, jd = jcam.optical_axis_intersection(jc)
    tpi, td = tcam.optical_axis_intersection(tc)
    assert np.abs(td - np.asarray(jd)).max() <= CAM_TOL * np.abs(jd).max()
    assert np.abs(tcam._intersect_skew_lines(tc.T, tc.R[:, 2]) - np.asarray(
        jcam._intersect_skew_lines(jc.T, jc.R[:, 2]))).max() <= CAM_TOL * 10
    # a given scale
    _assert_cams(tcam.normalize_cameras(tc, scale=2.5)[0], jcam.normalize_cameras(jc, 2.5)[0])


def test_crop_and_scale_intrinsics_match_jax():
    rng = np.random.default_rng(4)
    jc, tc = _host(random_cameras(5, seed=5))
    sizes = rng.uniform(300, 900, size=(5, 2)).astype(np.float32)
    jc, tc = jc._replace(image_size=sizes), tc._replace(image_size=sizes)
    boxes = np.concatenate([rng.uniform(-20, 60, (5, 2)), rng.uniform(100, 400, (5, 2))],
                           -1).astype(np.float32)
    _assert_cams(tcam.adjust_camera_to_bbox_crop(tc, boxes),
                 jcam.adjust_camera_to_bbox_crop(jc, boxes))
    _assert_cams(tcam.adjust_camera_to_image_scale(tc, (64, 96)),
                 jcam.adjust_camera_to_image_scale(jc, (64, 96)))
    fx, fy, cx, cy = tcam._ndc_to_px(tc)
    want = jcam._ndc_to_px(jc)
    for g, w in zip((fx, fy, cx, cy), want):
        assert np.abs(g - np.asarray(w)).max() <= CAM_TOL * np.abs(w).max()
    focal, pp = tcam._px_to_ndc(fx, fy, cx, cy, sizes)
    jf, jpp = jcam._px_to_ndc(*want, sizes)
    assert np.abs(focal - np.asarray(jf)).max() <= CAM_TOL * 10
    assert np.abs(pp - np.asarray(jpp)).max() <= CAM_TOL * 10


def test_stack_and_concat_cameras_take_numpy_and_tensors():
    jc, tc = _host(random_cameras(4, seed=6))
    _assert_cams(tcam.concat_cameras([tc[0:1], tc[1:4]]), jcam.concat_cameras([jc[0:1], jc[1:4]]))
    _assert_cams(tcam.stack_cameras([tc[0], tc[2]]), jcam.stack_cameras([jc[0], jc[2]]))
    tt = tc.tensors()
    assert isinstance(tt.R, torch.Tensor) and tt.R.dtype == torch.float32
    got = tcam.concat_cameras([tt[0:2], tt[2:4]])
    assert isinstance(got.T, torch.Tensor)
    _assert_cams(got, jc)
    host = tcam.Cameras.create(np.asarray(jc.R), np.asarray(jc.T), 2.0, 0.0, xp=np)
    assert isinstance(host.R, np.ndarray) and host.focal_length.shape == (4, 2)
