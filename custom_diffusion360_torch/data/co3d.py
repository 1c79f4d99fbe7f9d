"""CO3Dv2 / NAVI multiview data pipeline, host side (port of
custom_diffusion360_tpu/data/co3d.py).

PIL and numpy on the host, the camera math through the port's numpy camera
helpers (geometry/cameras.py, ``xp=np``), the crops' bicubic resize and the
mask dilation through the native library (data/native), a plain-Python
loader with worker threads.

* annotation parsing (frame/sequence jgz + set_lists + bbox jgz),
  viewpoint quality > 0.5, every-``skip`` frame valid ids, the test split
  the complement;
* camera normalization once per sequence (optical-axis skew-line
  intersection to the origin, scaled by the largest distance);
* per item: target frame ``(index*skip) % len`` + (num_images-1) spread and
  jittered reference views; square bbox crops for the references, the full
  padded square for the target; crop/rescale intrinsics; 7x7-dilated
  latent-res masks; reg-image substitution with p=drop_ratio and text
  dropout p=drop_txt; the modifier-token prompt;
* the onlyref/addlen capture variant (reference image last + one zero image
  appended; it feeds train/capture.py);
* ``collate``: the Engine's batch contract as torch tensors, moved to the
  device from pinned memory without blocking.

``__getitem__`` is numpy with the caller's ``np.random.Generator``, so an
item equals the JAX loader's for the same generator.
"""
from __future__ import annotations

import dataclasses
import gzip
import json
import os
import os.path as osp
from typing import Optional, Sequence

import numpy as np

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None

import torch

from ..geometry.cameras import (
    Cameras,
    adjust_camera_to_bbox_crop,
    adjust_camera_to_image_scale,
    normalize_cameras,
    stack_cameras,
)


def square_bbox(bbox, padding: float = 0.0):
    """xyxy -> square xyxy (data_co3d.py:162-183)."""
    bbox = np.asarray(bbox, np.float32)
    center = np.round((bbox[:2] + bbox[2:]) / 2).astype(int)
    extents = (bbox[2:] - bbox[:2]) / 2
    s = np.round(max(extents) * (1 + padding)).astype(int)
    return np.array(
        [center[0] - s, center[1] - s, center[0] + s, center[1] + s], np.float32
    )


def _crop_bbox(bbox):
    bbox = square_bbox(np.asarray(bbox, np.float32))
    side = bbox[2] - bbox[0]
    center = (bbox[:2] + bbox[2:]) / 2
    extent = side / 2
    ul = np.round(center - extent).astype(int)
    lr = ul + np.round(2 * extent).astype(int)
    return np.concatenate([ul, lr])


def _padded_bbox(w, h):
    return square_bbox(np.array([0, 0, w, h], np.float32))


def _crop_pil(img, bbox):
    """Crop with zero padding outside bounds (torchvision F.crop semantics)."""
    return img.crop((int(bbox[0]), int(bbox[1]), int(bbox[2]), int(bbox[3])))


def _dilate7(mask):
    """7x7 max-pool dilation, 'same' padding (data_co3d.py:471); native C++
    path with numpy fallback."""
    from .native import dilate7

    return dilate7(np.asarray(mask, np.float32))


@dataclasses.dataclass
class Co3dConfig:
    root: str = "data/co3d"
    category: str = "car"
    split: str = "train"
    skip: int = 2
    img_size: int = 512
    num_images: int = 5  # 1 target + 4 refs (train_co3d_concept.yaml:153)
    single_id: int = 0
    bbox: bool = True
    modifier_token: Optional[str] = "<new1>"
    categoryname: Optional[str] = None
    addreg: bool = False
    reg_dir: Optional[str] = None
    drop_ratio: float = 0.25
    drop_txt: float = 0.1
    repeat: int = 100
    addlen: bool = False
    onlyref: bool = False
    mask_images: bool = True
    # Bounded LRU over DECODED frames (post decode+crop+resize float32
    # arrays), keyed by (filepath, crop-variant). The concept training set is
    # ~50 frames reused for 1610 steps and every per-frame transform here is
    # deterministic, so after one epoch the loader reduces to selection +
    # collate (~3.1 MB/entry at 512^2; 128 entries ~= 400 MB host RAM).
    # 0 disables. Reg-pool images are cached under the same budget.
    cache_frames: int = 128


class Co3dDataset:
    """Host-side dataset; __getitem__ is pure numpy/PIL."""

    def __init__(self, cfg: Co3dConfig):
        import collections
        import threading

        self.cfg = cfg
        self.sequences = {}
        self.category_map = {}
        self._cache = collections.OrderedDict()
        self._cache_lock = threading.Lock()

        for c in sorted(cfg.category.split(",")):
            category_dir = osp.join(cfg.root, c)
            with open(osp.join(category_dir, "set_lists/set_lists_fewview_dev.json")) as f:
                subset_lists = json.load(f)
            with gzip.open(osp.join(category_dir, "sequence_annotations.jgz")) as f:
                sequence_data = json.loads(f.read())
            with gzip.open(osp.join(category_dir, "frame_annotations.jgz")) as f:
                frame_data = json.loads(f.read())
            bbox_path = osp.join(category_dir, f"{c}_bbox.jgz")
            bbox_data = {}
            if osp.exists(bbox_path):
                with gzip.open(bbox_path) as f:
                    bbox_data = json.loads(f.read())

            frames = {}
            for fd in frame_data:
                frames.setdefault(fd["sequence_name"], {})[fd["frame_number"]] = fd

            good = {
                sd["sequence_name"]
                for sd in sequence_data
                if sd["viewpoint_quality_score"] > 0.5
            }
            for seq_name, frame_number, filepath in subset_lists["train"]:
                if seq_name not in good:
                    continue
                fd = frames[seq_name][frame_number]
                mask_path = filepath.replace("images", "masks").replace(".jpg", ".png")
                self.sequences.setdefault(seq_name, []).append(
                    {
                        "filepath": filepath,
                        "R": np.asarray(fd["viewpoint"]["R"], np.float32),
                        "T": np.asarray(fd["viewpoint"]["T"], np.float32),
                        "focal_length": np.asarray(
                            fd["viewpoint"]["focal_length"], np.float32
                        ),
                        "principal_point": np.asarray(
                            fd["viewpoint"]["principal_point"], np.float32
                        ),
                        "mask": mask_path,
                        "txt": f"a {cfg.categoryname or c}",
                        "bbox": np.asarray(bbox_data.get(mask_path, ()), np.float32),
                    }
                )
                self.category_map[seq_name] = c

        # normalize cameras per sequence (data_co3d.py:296-318)
        drop = []
        for seq_name, annos in self.sequences.items():
            cams = Cameras.create(
                R=np.stack([a["R"] for a in annos]),
                T=np.stack([a["T"] for a in annos]),
                focal_length=np.stack([a["focal_length"] for a in annos]),
                principal_point=np.stack([a["principal_point"] for a in annos]),
                xp=np,
            )
            try:
                norm, _, scale = normalize_cameras(cams)
            except Exception:
                drop.append(seq_name)
                continue
            if not np.isfinite(np.asarray(norm.T)).all() or float(
                np.abs(np.asarray(norm.T)).sum()
            ) > 1e5:
                drop.append(seq_name)
                continue
            for i, a in enumerate(annos):
                a["R"] = np.asarray(norm.R[i])
                a["T"] = np.asarray(norm.T[i])
        for s in drop:
            del self.sequences[s]

        self.sequence_list = sorted(self.sequences.keys())
        seq = self.sequence_list[self.cfg.single_id]
        n = len(self.sequences[seq])
        self.valid_ids = list(range(0, n, cfg.skip))
        if cfg.split == "test":
            self.valid_ids = sorted(set(range(n)) - set(self.valid_ids))

        self.regcaptions = None
        if cfg.addreg and cfg.reg_dir:
            with open(osp.join(cfg.reg_dir, "caption.txt")) as f:
                self.regcaptions = f.read().splitlines()

    def __len__(self):
        return len(self.valid_ids) * self.cfg.repeat + (1 if self.cfg.addlen else 0)

    # -- image loading -------------------------------------------------------

    def _cached(self, key, fn):
        """Bounded thread-safe LRU over deterministic decode work. Values
        are returned SHARED — callers must not mutate them in place (both
        call sites np.stack/assign-copy immediately). A racing miss computes
        twice; both results are identical, so last-write-wins is fine."""
        if not self.cfg.cache_frames:
            return fn()
        with self._cache_lock:
            if key in self._cache:
                self._cache.move_to_end(key)
                return self._cache[key]
        val = fn()
        with self._cache_lock:
            self._cache[key] = val
            self._cache.move_to_end(key)
            while len(self._cache) > self.cfg.cache_frames:
                self._cache.popitem(last=False)
        return val

    def _load_frame(self, anno, use_bbox_crop):
        """Decoded-frame cache front: everything in
        _load_frame_impl is a pure function of (filepath, crop variant) for
        a fixed dataset config, and the concept set reuses ~50 frames for
        the whole 1610-step run (reference data_co3d.py:497-589 re-decodes
        every touch)."""
        return self._cached(
            (anno["filepath"], bool(use_bbox_crop)),
            lambda: self._load_frame_impl(anno, use_bbox_crop),
        )

    def _load_frame_impl(self, anno, use_bbox_crop):
        cfg = self.cfg
        img = Image.open(osp.join(cfg.root, anno["filepath"])).convert("RGB")
        seq = osp.normpath(anno["filepath"]).split(os.sep)
        mask_path = osp.join(cfg.root, anno["mask"])
        if osp.exists(mask_path):
            mask = Image.open(mask_path).convert("L")
            if mask.size != img.size:
                mask = mask.resize(img.size)
            mask_np = np.asarray(mask) > 125
        else:
            mask_np = np.ones((img.height, img.width), bool)
        mask = Image.fromarray(mask_np.astype(np.uint8) * 255)
        mask_padded = Image.fromarray(np.full_like(mask_np, 255, np.uint8))

        w, h = img.width, img.height
        bbox = anno["bbox"]
        if bbox.size == 0:
            bbox = np.array([0, 0, w, h], np.float32)
        bbox = _crop_bbox(bbox) if use_bbox_crop else _padded_bbox(w, h)
        bbox = bbox.astype(int)

        img = _crop_pil(img, bbox)
        mask = _crop_pil(mask, bbox)
        mask_padded = _crop_pil(mask_padded, bbox)

        s = cfg.img_size
        from .native import resize_bicubic_to_pm1

        image = resize_bicubic_to_pm1(np.asarray(img, np.uint8), s, s)  # (H, W, 3)
        mask = mask.resize((s // 8, s // 8), Image.BILINEAR)
        mask_padded = mask_padded.resize((s // 8, s // 8), Image.BILINEAR)
        mask_np = np.asarray(mask, np.float32)[..., None] / 255.0
        maskpad_np = np.asarray(mask_padded, np.float32)[..., None] / 255.0
        crop_xywh = np.array(
            [bbox[0], bbox[1], bbox[2] - bbox[0], bbox[3] - bbox[1]], np.float32
        )
        orig_size = np.array([w, h, bbox[2] - bbox[0], bbox[3] - bbox[1]], np.float32)
        return image, mask_np, maskpad_np, crop_xywh, orig_size

    # -- item ----------------------------------------------------------------

    def select_ids(self, index, rng):
        """Target + spread/jittered reference ids (data_co3d.py:427-440)."""
        cfg = self.cfg
        seq = self.sequence_list[cfg.single_id]
        metadata = self.sequences[seq]
        n_ref = cfg.num_images - 1
        listofindices = self.valid_ids.copy()
        max_diff = max(len(listofindices) // n_ref, 1)
        tgt = (index * cfg.skip) % len(metadata)
        if tgt in listofindices:
            listofindices.remove(tgt)
        starts = rng.choice(
            np.arange(0, len(listofindices) + 1, max_diff), n_ref, replace=False
        )
        rem = rng.integers(0, max_diff)
        references = [
            listofindices[(int(x) + int(rem)) % len(listofindices)] for x in starts
        ]
        if cfg.onlyref:
            return references + [tgt]
        return [tgt] + references

    def __getitem__(self, index, rng=None, validation=False, ids=None):
        cfg = self.cfg
        rng = rng or np.random.default_rng()
        seq = self.sequence_list[cfg.single_id]
        metadata = self.sequences[seq]

        drop_im = (not validation) and rng.uniform() < cfg.drop_ratio
        drop_txt = (
            (not validation) and (not drop_im) and rng.uniform() < cfg.drop_txt
        )

        if ids is None:
            ids = self.select_ids(index, rng)
        annos = [metadata[i] for i in ids]

        frames = [
            self._load_frame(a, cfg.bbox and c > 0) for c, a in enumerate(annos)
        ]
        images = np.stack([f[0] for f in frames])
        masks = np.stack([f[1] for f in frames])
        maskpads = np.stack([f[2] for f in frames])
        crops = np.stack([f[3] for f in frames])
        orig_sizes = np.stack([f[4] for f in frames])

        # cameras: crop + rescale intrinsics (data_co3d.py:458-467), one
        # batched numpy pass over all views
        cams = Cameras.create(
            R=np.stack([a["R"] for a in annos]),
            T=np.stack([a["T"] for a in annos]),
            focal_length=np.stack([a["focal_length"] for a in annos]),
            principal_point=np.stack([a["principal_point"] for a in annos]),
            image_size=orig_sizes[:, [1, 0]],  # (H, W) per view
            xp=np,
        )
        cams = adjust_camera_to_bbox_crop(cams, crops)
        cams = adjust_camera_to_image_scale(cams, (cfg.img_size, cfg.img_size))

        txt = annos[0]["txt"]
        if cfg.modifier_token is not None:
            name = cfg.categoryname or self.category_map[seq]
            txt = f"photo of a {cfg.modifier_token} {name}"
        txts_ref = [txt] * (len(ids) - 1)

        if drop_im and self.regcaptions is not None:
            rid = rng.integers(0, len(self.regcaptions))

            def load_reg(rid=int(rid)):
                reg = Image.open(
                    osp.join(cfg.reg_dir, "images", f"{rid}.png")
                ).convert("RGB")
                reg = reg.resize((cfg.img_size, cfg.img_size), Image.BICUBIC)
                return np.asarray(reg, np.float32) / 255.0 * 2.0 - 1.0

            images[0] = self._cached(("reg", int(rid)), load_reg)
            txt = self.regcaptions[rid]
            # reference pins the size-conditioning tuple to 1024 for reg
            # images regardless of img_size (data_co3d.py:455)
            orig_sizes[0] = 1024

        depth = masks[0].copy()  # un-dilated (data_co3d.py:470)
        mask_dil = np.clip(_dilate7(masks[0][..., 0]), 0, 1)[..., None]

        # capture zero row (data_co3d.py:476-477)
        if cfg.addlen and index == len(self) - 1:
            images[0] = 0.0

        image_ref = images[1:]
        if drop_im:
            image_ref = rng.uniform(-1, 1, image_ref.shape).astype(np.float32)
            txts_ref = [""] * (len(ids) - 1)
            mask_dil = np.ones_like(mask_dil)

        return {
            "image": images[0],
            "txt": "" if drop_txt else txt,
            "image_ref": image_ref,
            "txt_ref": txts_ref,
            "cams": cams,
            "mask": mask_dil,
            "mask_ref": maskpads[1:],
            "opacity": depth,
            "original_size": orig_sizes[0][2:][::-1].copy(),  # (h, w)
            "target_size": np.array([cfg.img_size, cfg.img_size], np.float32),
            "crop_coords": np.zeros(2, np.float32),
            "original_size_ref": orig_sizes[1:, 2:][:, ::-1].copy(),
            "target_size_ref": np.full((len(ids) - 1, 2), cfg.img_size, np.float32),
            "crop_coords_ref": np.zeros((len(ids) - 1, 2), np.float32),
            "drop_im": np.float32(1.0 - drop_im),
        }


def _to_device(x, device):
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device is None or torch.device(device).type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def collate(items: Sequence[dict], tokenizer_clip=None, tokenizer_open=None, device=None):
    """Stack items into the Engine's batch contract, as tensors on
    ``device`` (CPU tensors when None; a CUDA device gets them from pinned
    memory without blocking). Reference fields are concatenated
    sample-major ((b n) rows). ``txt`` and ``txt_ref`` stay lists of
    strings."""

    def stack(key):
        return _to_device(np.stack([it[key] for it in items]), device)

    def cat_ref(key):
        return _to_device(np.concatenate([it[key] for it in items], axis=0), device)

    cams = stack_cameras([it["cams"] for it in items])
    batch = {
        "image": stack("image"),
        "image_ref": stack("image_ref"),
        "mask": stack("mask"),
        "mask_ref": stack("mask_ref"),
        "opacity": stack("opacity"),
        "drop_im": stack("drop_im"),
        "cams": Cameras(*(_to_device(np.asarray(f, np.float32), device) for f in cams)),
        "original_size": stack("original_size"),
        "target_size": stack("target_size"),
        "crop_coords": stack("crop_coords"),
        "original_size_ref": cat_ref("original_size_ref"),
        "target_size_ref": cat_ref("target_size_ref"),
        "crop_coords_ref": cat_ref("crop_coords_ref"),
    }
    txts = [it["txt"] for it in items]
    txts_ref = [t for it in items for t in it["txt_ref"]]
    if tokenizer_clip is not None:
        batch["tokens_clip"] = _to_device(tokenizer_clip(txts), device)
        batch["tokens_clip_ref"] = _to_device(tokenizer_clip(txts_ref), device)
    if tokenizer_open is not None:
        batch["tokens_open"] = _to_device(tokenizer_open(txts), device)
        batch["tokens_open_ref"] = _to_device(tokenizer_open(txts_ref), device)
    batch["txt"] = txts
    batch["txt_ref"] = txts_ref
    return batch


class DataLoader:
    """Shuffling batch loader with a worker thread pool and a bounded
    prefetch queue (replaces torch DataLoader + CustomDataDictLoader,
    data_co3d.py:636-737; the reference trains with num_workers=4).

    Items are loaded/decoded by ``num_workers`` threads (PIL decode and the
    native preprocessing release the GIL) and whole batches are collated —
    including the copy to ``device`` from pinned memory — ``prefetch``
    batches ahead of the training step.

    Determinism: per-item PRNGs are derived from (seed, epoch, position), so
    the data stream is identical for any num_workers (including 0 =
    synchronous, the test path).
    """

    def __init__(
        self,
        dataset: Co3dDataset,
        batch_size: int,
        tokenizer_clip=None,
        tokenizer_open=None,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        num_workers: int = 4,
        prefetch: int = 2,
        device=None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.tokenizer_clip = tokenizer_clip
        self.tokenizer_open = tokenizer_open
        self.shuffle = shuffle
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = max(prefetch, 1)
        self.device = device
        self._epoch = 0

    def _epoch_plan(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        epoch = self._epoch
        self._epoch += 1
        plan = []
        for i in range(0, len(order), self.batch_size):
            idxs = order[i : i + self.batch_size]
            if self.drop_last and len(idxs) < self.batch_size:
                break
            plan.append(
                [(int(j), (self.seed, epoch, i + k)) for k, j in enumerate(idxs)]
            )
        return plan

    def _load_item(self, job):
        j, seed_key = job
        return self.dataset.__getitem__(j, rng=np.random.default_rng(seed_key))

    def __iter__(self):
        plan = self._epoch_plan()
        if self.num_workers <= 0:
            for jobs in plan:
                items = [self._load_item(job) for job in jobs]
                yield collate(items, self.tokenizer_clip, self.tokenizer_open, self.device)
            return

        import queue
        import threading
        from concurrent.futures import ThreadPoolExecutor

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for jobs in plan:
                        if stop.is_set():
                            return
                        items = list(pool.map(self._load_item, jobs))
                        q.put(collate(items, self.tokenizer_clip, self.tokenizer_open,
                                      self.device))
            except Exception as e:  # surface worker errors to the consumer
                q.put(e)
                return
            q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
            # A consumer that stops early leaves the producer parked on
            # q.put (or mid device copy in collate); drain so it can observe
            # `stop`, and join so no thread outlives the iteration.
            for wait in (10.0, 10.0):
                try:
                    while True:
                        q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=wait)
                if not t.is_alive():
                    break
            else:
                import warnings

                warnings.warn("DataLoader producer thread still alive after drain",
                              RuntimeWarning, stacklevel=2)

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        return n if self.drop_last else -(-len(self.dataset) // self.batch_size)
