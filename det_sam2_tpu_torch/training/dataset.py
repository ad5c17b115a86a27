"""VOS training data pipeline (host numpy), without cv2.

Counterpart of the JAX package's ``training/dataset.py`` (after the
reference's training/dataset/*): raw datasets (MOSE / DAVIS PNG layout,
SA-V PNG and JSON layouts, SA-1B images as 1-frame videos, procedural
videos), the frame / object samplers, the video-consistent augmentations
and the batching to [T, B, S, S, 3] images / [T, B(, K), S, S] masks.
Every draw comes from the same ``random.Random`` / numpy calls in the same
order as in the JAX package, so one seed gives one clip stream.

The JAX package warps and resizes with cv2; the card's machine has no cv2,
so this module computes cv2's arithmetic in numpy, bit for bit (checked
against cv2 5.0 in the CPU tests):
  * ``warpAffine`` (cv2 >= 4.11's kernels): the inverse map in float32, the
    source x as fma(x, m00, y * m01 + m02) (and y likewise), bilinear
    frames as three fused multiply-adds over the four neighbours, rounded
    half to even; nearest masks at the coordinates rounded half to even;
    a constant-0 border;
  * ``resize`` INTER_LINEAR on uint8: ``utils.cv2_resize.resize_linear``,
    which the frame preparation (``utils.misc.prepare_frame``) shares;
  * ``resize`` INTER_NEAREST: source index floor(dst * src / dst_size).
The hue jitter (off in the MOSE recipe) still converts to HSV with cv2,
imported when it runs; PIL decodes the image files, imported likewise.
"""

from __future__ import annotations

import dataclasses
import os
import random
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from det_sam2_tpu_torch.utils.cv2_resize import _fma32, resize_linear
from det_sam2_tpu_torch.utils.misc import IMG_MEAN, IMG_STD


@dataclasses.dataclass
class VideoClip:
    frames: List[np.ndarray]  # RGB uint8 [H, W, 3]
    masks: List[Dict[int, np.ndarray]]  # per frame: obj_id -> bool [H, W]


def _image_files_by_stem(directory: str) -> Dict[str, str]:
    """stem -> full path for every .jpg/.jpeg/.png (case-insensitive), the
    exact match rule frame_names() applies."""
    out: Dict[str, str] = {}
    for n in sorted(os.listdir(directory)):
        stem, ext = os.path.splitext(n)
        if ext.lower() in (".jpg", ".jpeg", ".png"):
            out[stem] = os.path.join(directory, n)
    return out


class PNGRawDataset:
    """<root>/JPEGImages/<video>/*.jpg + <root>/Annotations/<video>/*.png
    (DAVIS/MOSE layout)."""

    def __init__(self, img_folder: str, gt_folder: str,
                 file_list: Optional[Sequence[str]] = None):
        self.img_folder = img_folder
        self.gt_folder = gt_folder
        self.videos = (
            list(file_list) if file_list else sorted(os.listdir(img_folder))
        )

    def __len__(self):
        return len(self.videos)

    def frame_names(self, video: str) -> List[str]:
        d = os.path.join(self.img_folder, video)
        return sorted(
            os.path.splitext(n)[0]
            for n in os.listdir(d)
            if os.path.splitext(n)[-1].lower() in (".jpg", ".jpeg", ".png")
        )

    def load_frames(self, video: str, names: Sequence[str]) -> VideoClip:
        from PIL import Image

        d = os.path.join(self.img_folder, video)
        by_stem = _image_files_by_stem(d)
        frames, masks = [], []
        for name in names:
            # the same case-insensitive matching frame_names used: a
            # silent skip here would misalign frames with masks
            frames.append(
                np.asarray(Image.open(by_stem[name]).convert("RGB"))
            )
            mask_path = os.path.join(self.gt_folder, video, name + ".png")
            per_obj: Dict[int, np.ndarray] = {}
            if os.path.exists(mask_path):
                arr = np.asarray(Image.open(mask_path))
                for obj_id in np.unique(arr):
                    if obj_id != 0:
                        per_obj[int(obj_id)] = arr == obj_id
            masks.append(per_obj)
        return VideoClip(frames, masks)


class SyntheticRawDataset:
    """Procedural moving-shape videos for tests/smoke training."""

    def __init__(self, num_videos: int = 8, num_frames: int = 8,
                 hw: Tuple[int, int] = (128, 128), seed: int = 0):
        self.num_videos = num_videos
        self.num_frames = num_frames
        self.hw = hw
        self.seed = seed
        self.videos = [f"synthetic_{i}" for i in range(num_videos)]

    def __len__(self):
        return self.num_videos

    def frame_names(self, video: str) -> List[str]:
        return [f"{i:05d}" for i in range(self.num_frames)]

    def load_frames(self, video: str, names: Sequence[str]) -> VideoClip:
        h, w = self.hw
        vid_idx = self.videos.index(video)
        rng = np.random.default_rng(self.seed + vid_idx)
        x0, y0 = rng.integers(5, w // 3), rng.integers(5, h // 3)
        dx, dy = rng.integers(1, 5), rng.integers(1, 4)
        size = int(rng.integers(16, 32))
        frames, masks = [], []
        for t, _ in enumerate(names):
            f = np.full((h, w, 3), 30, np.uint8)
            x = min(x0 + dx * t, w - size - 1)
            y = min(y0 + dy * t, h - size - 1)
            f[y : y + size, x : x + size] = (200, 40, 40)
            m = np.zeros((h, w), bool)
            m[y : y + size, x : x + size] = True
            frames.append(f)
            masks.append({1: m})
        return VideoClip(frames, masks)


def decode_coco_rle(rle: Dict) -> np.ndarray:
    """Decode a COCO RLE segmentation (compressed string or uncompressed
    counts list) to a bool [H, W] mask — replaces pycocotools.mask.decode
    for the SA-V / SA-1B loaders (vos_segment_loader.py uses mask_utils)."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        if isinstance(counts, str):
            counts = counts.encode()
        # COCO compressed RLE: LEB128-style with sign folding + delta coding
        out, i, prev = [], 0, 0
        while i < len(counts):
            x, k = 0, 0
            more = True
            while more:
                c = counts[i] - 48
                x |= (c & 0x1F) << (5 * k)
                more = bool(c & 0x20)
                i += 1
                k += 1
            if x & (1 << (5 * k - 1)):
                x -= 1 << (5 * k)
            if len(out) > 2:
                x += out[-2]
            out.append(x)
        counts = out
    flat = np.zeros(h * w, bool)
    pos = 0
    val = False
    for c in counts:
        if val:
            flat[pos : pos + c] = True
        pos += c
        val = not val
    # COCO RLE is column-major
    return flat.reshape(w, h).T


class MultiplePNGRawDataset:
    """SA-V-extracted layout: <img_folder>/<video>/*.jpg frame dirs +
    <gt_folder>/<video>/<obj_id>/<frame:05d>.png per-object mask dirs
    (reference MultiplePNGSegmentLoader,
    training/dataset/vos_segment_loader.py:151-232). A missing PNG means
    an empty mask for that (object, frame); folder names are integer
    object ids, offset by +1 since background is 0.

    single_object_mode: gt_folder points at ONE object's directory
    (<video>/<obj_id>) whose name supplies the object id."""

    def __init__(self, img_folder: str, gt_folder: str,
                 file_list: Optional[Sequence[str]] = None,
                 single_object_mode: bool = False):
        self.img_folder = img_folder
        self.gt_folder = gt_folder
        self.single_object_mode = single_object_mode
        self.videos = (
            list(file_list) if file_list else sorted(os.listdir(img_folder))
        )

    def __len__(self):
        return len(self.videos)

    def frame_names(self, video: str) -> List[str]:
        d = os.path.join(self.img_folder, video)
        return sorted(
            os.path.splitext(n)[0]
            for n in os.listdir(d)
            if os.path.splitext(n)[-1].lower() in (".jpg", ".jpeg", ".png")
        )

    def _mask_root(self, video: str) -> str:
        return os.path.join(self.gt_folder, video)

    def _object_dirs(self, video: str) -> List[Tuple[int, str]]:
        root = self._mask_root(video)
        if self.single_object_mode:
            # the directory name IS the object id (reference :158-172)
            return [(int(os.path.basename(root.rstrip("/"))) + 1, root)]
        out = []
        for name in sorted(os.listdir(root)):
            p = os.path.join(root, name)
            if os.path.isdir(p):
                out.append((int(name) + 1, p))
        if not out:
            raise FileNotFoundError(f"no object mask dirs under {root}")
        return out

    def load_frames(self, video: str, names: Sequence[str]) -> VideoClip:
        from PIL import Image

        by_stem = _image_files_by_stem(os.path.join(self.img_folder, video))
        objects = self._object_dirs(video)
        frames, masks = [], []
        for name in names:
            frames.append(
                np.asarray(Image.open(by_stem[name]).convert("RGB"))
            )
            per_obj: Dict[int, np.ndarray] = {}
            for obj_id, obj_dir in objects:
                # mask files are zero-padded frame indices (:183, :202)
                fname = f"{int(name):05d}.png" if name.isdigit() else (
                    name + ".png"
                )
                p = os.path.join(obj_dir, fname)
                if os.path.exists(p):
                    per_obj[obj_id] = np.asarray(Image.open(p)) > 0
                # missing PNG -> empty mask (reference :195-198); keep the
                # object absent so first-frame object selection matches
                # the reference's presence test
            masks.append(per_obj)
        return VideoClip(frames, masks)


class SA1BRawDataset:
    """SA-1B static images as 1-frame videos: <img_folder>/sa_X.jpg +
    <gt_folder>/sa_X.json (reference vos_raw_dataset.py:148-212 +
    SA1BSegmentLoader vos_segment_loader.py:261-330)."""

    def __init__(self, img_folder: str, gt_folder: str,
                 file_list: Optional[Sequence[str]] = None,
                 num_frames: int = 1,
                 mask_area_frac_thresh: float = 1.1,
                 uncertain_iou: float = -1.0):
        self.img_folder = img_folder
        self.gt_folder = gt_folder
        self.num_frames = num_frames
        self.mask_area_frac_thresh = mask_area_frac_thresh
        self.uncertain_iou = uncertain_iou
        if file_list is not None:
            self.videos = [os.path.splitext(v)[0] for v in file_list]
        else:
            self.videos = sorted(
                os.path.splitext(p)[0]
                for p in os.listdir(img_folder)
                if p.endswith(".jpg")
            )

    def __len__(self):
        return len(self.videos)

    def frame_names(self, video: str) -> List[str]:
        return ["00000"] * self.num_frames  # static image repeated

    def load_frames(self, video: str, names: Sequence[str]) -> VideoClip:
        import json

        from PIL import Image

        img = np.asarray(
            Image.open(os.path.join(self.img_folder, video + ".jpg"))
            .convert("RGB")
        )
        with open(os.path.join(self.gt_folder, video + ".json")) as f:
            annots = json.load(f)["annotations"]
        area = img.shape[0] * img.shape[1]
        per_obj: Dict[int, np.ndarray] = {}
        for ann in annots:
            if not ann.get("area", 0) > 0:
                continue
            if ann.get("uncertain_iou", 1e9) < self.uncertain_iou:
                continue
            if (
                self.mask_area_frac_thresh <= 1.0
                and ann["area"] / area >= self.mask_area_frac_thresh
            ):
                continue
            per_obj[len(per_obj) + 1] = decode_coco_rle(ann["segmentation"])
        return VideoClip([img] * len(names), [dict(per_obj)] * len(names))


class JSONRawDataset:
    """SA-V style videos: <img_folder>/<video>/*.jpg frame dirs +
    <gt_folder>/<video>/<video>_manual.json (or <video>.json) holding
    per-frame RLE masklets (vos_raw_dataset.py:215-299 + JSONSegmentLoader
    vos_segment_loader.py:23-101)."""

    def __init__(self, img_folder: str, gt_folder: str,
                 file_list: Optional[Sequence[str]] = None,
                 ann_every: int = 1, frames_fps: int = 24,
                 rm_unannotated: bool = True):
        self.img_folder = img_folder
        self.gt_folder = gt_folder
        self.ann_every = ann_every
        self.frames_fps = frames_fps
        self.rm_unannotated = rm_unannotated
        self.videos = (
            list(file_list) if file_list else sorted(os.listdir(img_folder))
        )
        # SA-V masklet JSONs run to tens of MB; frame_names + load_frames
        # both need them, so parse each video's annotations once
        self._annot_cache: Dict[str, tuple] = {}

    def __len__(self):
        return len(self.videos)

    def _load_annots(self, video: str):
        import json

        if video in self._annot_cache:
            return self._annot_cache[video]
        for cand in (f"{video}_manual.json", f"{video}.json"):
            p = os.path.join(self.gt_folder, video, cand)
            if not os.path.exists(p):
                p = os.path.join(self.gt_folder, cand)
            if os.path.exists(p):
                with open(p) as f:
                    data = json.load(f)
                break
        else:
            raise FileNotFoundError(f"no SA-V json for {video}")
        ann_every = self.ann_every
        if isinstance(data, dict):
            annots = data.get("masklet", data.get("masks"))
            fps = data.get("fps")
            if fps is not None:
                fps = int(fps[0] if isinstance(fps, list) else fps)
                # the reference asserts this divisibility (vos_raw_dataset);
                # a silent floor would pair frames with wrong masklets
                if fps <= 0 or self.frames_fps % fps != 0:
                    raise ValueError(
                        f"{video}: annotation fps {fps} must divide "
                        f"frames_fps {self.frames_fps}"
                    )
                ann_every = self.frames_fps // fps
        else:
            annots = data
        self._annot_cache[video] = (annots, ann_every)
        return annots, ann_every

    def frame_names(self, video: str) -> List[str]:
        d = os.path.join(self.img_folder, video)
        names = sorted(
            os.path.splitext(n)[0]
            for n in os.listdir(d)
            if os.path.splitext(n)[-1].lower() in (".jpg", ".jpeg", ".png")
        )
        annots, ann_every = self._load_annots(video)
        if self.rm_unannotated:
            names = [
                n for i, n in enumerate(names)
                if i % ann_every == 0 and i // ann_every < len(annots)
            ]
        return names

    def load_frames(self, video: str, names: Sequence[str]) -> VideoClip:
        from PIL import Image

        annots, ann_every = self._load_annots(video)
        by_stem = _image_files_by_stem(os.path.join(self.img_folder, video))
        name_to_idx = {n: i for i, n in enumerate(sorted(by_stem))}
        frames, masks = [], []
        for name in names:
            frames.append(
                np.asarray(Image.open(by_stem[name]).convert("RGB"))
            )
            fi = name_to_idx[name]
            rles = annots[fi // ann_every]
            per_obj = {
                oid + 1: decode_coco_rle(rle)
                for oid, rle in enumerate(rles)
                if rle is not None
            }
            masks.append(per_obj)
        return VideoClip(frames, masks)


class RandomUniformSampler:
    """Pick num_frames sorted frames and <= max_num_objects objects
    (vos_sampler.py:31-78)."""

    def __init__(self, num_frames: int = 8, max_num_objects: int = 3,
                 reverse_time_prob: float = 0.0):
        self.num_frames = num_frames
        self.max_num_objects = max_num_objects
        self.reverse_time_prob = reverse_time_prob

    def sample(self, rng: random.Random, names: List[str]) -> List[str]:
        if len(names) < self.num_frames:
            picks = sorted(rng.choices(range(len(names)), k=self.num_frames))
        else:
            start = rng.randint(0, len(names) - self.num_frames)
            picks = list(range(start, start + self.num_frames))
        if rng.random() < self.reverse_time_prob:
            picks = picks[::-1]
        return [names[i] for i in picks]


class EvalSampler:
    """All frames, all first-frame objects (vos_sampler.py:81-105)."""

    num_frames = None
    max_num_objects = 10**9

    def sample(self, rng: random.Random, names: List[str]) -> List[str]:
        return sorted(names)


# ---------------------------------------------------------------------------
# cv2's geometric transforms in numpy
# ---------------------------------------------------------------------------


def rotation_matrix_2d(center: Tuple[float, float], angle: float,
                       scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D: the centre is a float32 point."""
    a = np.deg2rad(angle)
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    cx, cy = (float(np.float32(v)) for v in center)
    return np.asarray([[alpha, beta, (1 - alpha) * cx - beta * cy],
                       [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


class AffineWarp:
    """cv2.warpAffine(x, m, (w, h)) with the same m for every frame and mask
    of a clip: the source coordinates, neighbours and weights are computed
    once. Frames: INTER_LINEAR on uint8 [H, W, 3]; masks: INTER_NEAREST;
    the border is constant 0."""

    def __init__(self, m: np.ndarray, h: int, w: int):
        m = np.asarray(m, np.float64).reshape(-1).copy()
        d = m[0] * m[4] - m[1] * m[3]  # cv2's inversion of the forward map
        d = 1.0 / d if d != 0 else 0.0
        a11, a22 = m[4] * d, m[0] * d
        m[0], m[1], m[3], m[4] = a11, -m[1] * d, -m[3] * d, a22
        m[2], m[5] = -m[0] * m[2] - m[1] * m[5], -m[3] * m[2] - m[4] * m[5]
        mi = m.astype(np.float32)
        xs = np.arange(w, dtype=np.float32)[None]
        ys = np.arange(h, dtype=np.float32)[:, None]
        # cv2's vector loop takes fma(x, m0, y * m1 + m2); the columns past
        # the last full vector (16 float lanes: its AVX-512 dispatch) take
        # its scalar loop, (x * m0 + y * m1) + m2 contracted to
        # fma(x, m0, y * m1) + m2
        tail = xs >= (w // 16) * 16
        sx = np.where(tail, _fma32(xs, mi[0], ys * mi[1]) + mi[2],
                      _fma32(xs, mi[0], ys * mi[1] + mi[2]))
        sy = np.where(tail, _fma32(xs, mi[3], ys * mi[4]) + mi[5],
                      _fma32(xs, mi[3], ys * mi[4] + mi[5]))
        self.h, self.w = h, w
        # INTER_NEAREST: rounded half to even
        self._near = self._index(np.rint(sy), np.rint(sx))
        # INTER_LINEAR: the four neighbours and the fractions
        ix, iy = np.floor(sx), np.floor(sy)
        self._fx = (sx - ix).astype(np.float32).reshape(-1, 1)
        self._fy = (sy - iy).astype(np.float32).reshape(-1, 1)
        self._taps = [self._index(iy + dy, ix + dx) for dy in (0, 1) for dx in (0, 1)]

    def _index(self, yy, xx) -> np.ndarray:
        """Flat source indices; a point outside the image reads index h * w,
        a zero pixel appended to the source (the constant border)."""
        yy, xx = yy.astype(np.int64), xx.astype(np.int64)
        inside = (xx >= 0) & (xx < self.w) & (yy >= 0) & (yy < self.h)
        return np.where(inside, yy * self.w + xx, self.h * self.w).reshape(-1)

    def _source(self, x: np.ndarray) -> np.ndarray:
        flat = np.ascontiguousarray(x).reshape(self.h * self.w, -1)
        return np.concatenate([flat, np.zeros((1, flat.shape[1]), flat.dtype)])

    def frame(self, img: np.ndarray) -> np.ndarray:
        src = self._source(img)
        p00, p01, p10, p11 = (src.take(idx, axis=0).astype(np.float32)
                              for idx in self._taps)
        p0 = _fma32(self._fx, p01 - p00, p00)
        p1 = _fma32(self._fx, p11 - p10, p10)
        v = _fma32(self._fy, p1 - p0, p0)
        out = np.clip(np.rint(v), 0, 255).astype(np.uint8)
        return out.reshape(img.shape)

    def mask(self, msk: np.ndarray) -> np.ndarray:
        return self._source(msk).take(self._near, axis=0).reshape(msk.shape)


def resize_nearest(msk: np.ndarray, size: int) -> np.ndarray:
    """cv2.resize(msk, (size, size), interpolation=INTER_NEAREST)."""
    h, w = msk.shape[:2]

    def idx(src):
        return np.minimum(np.floor(np.arange(size) * (1.0 / (size / src))).astype(np.int64),
                          src - 1)

    return msk[idx(h)][:, idx(w)]


# ---------------------------------------------------------------------------
# video-consistent augmentations
# ---------------------------------------------------------------------------


def affine_clip(clip: VideoClip, rng: random.Random, degrees: float = 25.0,
                shear: float = 20.0) -> VideoClip:
    """Consistent random rotation+shear across the clip (reference
    transforms.RandomAffine, MOSE yaml :28-32). Nearest for masks."""
    h, w = clip.frames[0].shape[:2]
    angle = rng.uniform(-degrees, degrees)
    sh = np.deg2rad(rng.uniform(-shear, shear))
    m = rotation_matrix_2d((w / 2, h / 2), angle, 1.0)
    m_shear = np.asarray([[1.0, np.tan(sh), 0.0], [0.0, 1.0, 0.0]], np.float64)
    m3 = np.vstack([m, [0, 0, 1]]) @ np.vstack([m_shear, [0, 0, 1]])
    warp = AffineWarp(m3[:2], h, w)
    frames = [warp.frame(f) for f in clip.frames]
    masks = [
        {k: warp.mask(msk.astype(np.uint8)).astype(bool) for k, msk in per.items()}
        for per in clip.masks
    ]
    return VideoClip(frames, masks)


def grayscale_clip(clip: VideoClip) -> VideoClip:
    """Consistent RandomGrayscale (MOSE yaml :43-45)."""
    frames = []
    for f in clip.frames:
        g = (
            0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
        ).astype(np.uint8)
        frames.append(np.stack([g, g, g], axis=-1))
    return VideoClip(frames, clip.masks)


def hflip_clip(clip: VideoClip) -> VideoClip:
    return VideoClip(
        [f[:, ::-1] for f in clip.frames],
        [{k: m[:, ::-1] for k, m in per.items()} for per in clip.masks],
    )


def _jitter_one(f: np.ndarray, rng: random.Random, brightness: float,
                contrast: float, saturation: float,
                hue: Optional[float]) -> np.ndarray:
    """torchvision ColorJitter on one frame: factors drawn uniformly from
    [1-x, 1+x], ops applied in a random order (transforms.ColorJitter).
    hue=None disables the hue op (the MOSE recipe sets hue: null)."""
    img = f.astype(np.float32)
    ops = []
    if brightness > 0:
        b = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
        ops.append(lambda x: x * b)
    if contrast > 0:
        c = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)

        def _contrast(x, c=c):
            # torchvision blends with the mean of the grayscale image
            g = (0.299 * x[..., 0] + 0.587 * x[..., 1]
                 + 0.114 * x[..., 2]).mean()
            return c * x + (1 - c) * g

        ops.append(_contrast)
    if saturation > 0:
        s = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)

        def _saturate(x, s=s):
            g = (0.299 * x[..., 0] + 0.587 * x[..., 1]
                 + 0.114 * x[..., 2])[..., None]
            return s * x + (1 - s) * g

        ops.append(_saturate)
    if hue:
        h = rng.uniform(-hue, hue)

        def _hue(x, h=h):
            import cv2

            hsv = cv2.cvtColor(
                np.clip(x, 0, 255).astype(np.uint8), cv2.COLOR_RGB2HSV
            )
            hsv[..., 0] = (hsv[..., 0].astype(np.int32)
                           + int(h * 180)) % 180
            return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB).astype(np.float32)

        ops.append(_hue)
    rng.shuffle(ops)
    for op in ops:
        img = op(img)
    return np.clip(img, 0, 255).astype(np.uint8)


def color_jitter_clip(clip: VideoClip, rng: random.Random,
                      brightness: float = 0.1, contrast: float = 0.03,
                      saturation: float = 0.03,
                      hue: Optional[float] = None,
                      consistent: bool = True) -> VideoClip:
    """ColorJitter over a clip (reference training/dataset/transforms.py
    ColorJitter). consistent=True draws ONE set of factors for the whole
    clip (video-consistent, MOSE yaml :37-42); consistent=False re-draws
    per frame (the recipe's second jitter, yaml :46-51)."""
    if consistent:
        # one rng state for the whole clip: clone the sampled choices by
        # drawing them once through a frozen child rng per frame
        seed = rng.random()
        frames = [
            _jitter_one(f, random.Random(seed), brightness, contrast,
                        saturation, hue)
            for f in clip.frames
        ]
    else:
        frames = [
            _jitter_one(f, rng, brightness, contrast, saturation, hue)
            for f in clip.frames
        ]
    return VideoClip(frames, clip.masks)


def resize_clip(clip: VideoClip, size: int) -> VideoClip:
    frames = [resize_linear(f, size) for f in clip.frames]
    masks = [
        {k: resize_nearest(m.astype(np.uint8), size).astype(bool) for k, m in per.items()}
        for per in clip.masks
    ]
    return VideoClip(frames, masks)


# ---------------------------------------------------------------------------
# loader
# ---------------------------------------------------------------------------


class VOSDataLoader:
    """Random-clip iterator producing training batches (host numpy).

    Each element: (images [T, B, S, S, 3] fp32 normalized,
                   gt_masks [T, B, S, S] fp32) where B rows are
    (video, object) tracks."""

    def __init__(
        self,
        dataset,
        sampler: Optional[RandomUniformSampler] = None,
        image_size: int = 128,
        batch_size: int = 2,
        hflip_prob: float = 0.5,
        color_jitter_prob: float = 0.8,
        affine_prob: float = 0.0,  # MOSE recipe uses 1.0, degrees 25/shear 20
        grayscale_prob: float = 0.0,  # MOSE recipe: 0.05
        # consistent-jitter strengths (MOSE yaml :37-42)
        color_jitter_strengths: Tuple[float, float, float] = (0.1, 0.03, 0.03),
        # the recipe's SECOND jitter re-draws factors per frame
        # (consistent_transform: False, yaml :46-51); None disables
        per_frame_jitter_strengths: Optional[Tuple[float, float, float]] = None,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.sampler = sampler or RandomUniformSampler()
        self.image_size = image_size
        self.batch_size = batch_size
        self.hflip_prob = hflip_prob
        self.color_jitter_prob = color_jitter_prob
        self.affine_prob = affine_prob
        self.grayscale_prob = grayscale_prob
        self.color_jitter_strengths = tuple(color_jitter_strengths)
        self.per_frame_jitter_strengths = (
            tuple(per_frame_jitter_strengths)
            if per_frame_jitter_strengths is not None else None
        )
        self.seed = seed
        # ONE rng advanced across batches() calls: re-seeding per call
        # would make every epoch replay the exact same clips/augs (the
        # reference re-samples per epoch via epoch-seeded samplers)
        self._rng = random.Random(seed)

    def _load_track(self, rng: random.Random):
        video = rng.choice(self.dataset.videos)
        names = self.sampler.sample(rng, self.dataset.frame_names(video))
        clip = self.dataset.load_frames(video, names)
        # reference ComposeAPI order (MOSE yaml :26-51): flip, affine,
        # resize, consistent jitter, grayscale, per-frame jitter
        if rng.random() < self.hflip_prob:
            clip = hflip_clip(clip)
        if rng.random() < self.affine_prob:
            clip = affine_clip(clip, rng)
        clip = resize_clip(clip, self.image_size)
        if rng.random() < self.color_jitter_prob:
            b, c, s = self.color_jitter_strengths
            clip = color_jitter_clip(
                clip, rng, brightness=b, contrast=c, saturation=s,
                consistent=True,
            )
        if rng.random() < self.grayscale_prob:
            clip = grayscale_clip(clip)
        if self.per_frame_jitter_strengths is not None:
            b, c, s = self.per_frame_jitter_strengths
            clip = color_jitter_clip(
                clip, rng, brightness=b, contrast=c, saturation=s,
                consistent=False,
            )
        # choose up to max_num_objects present in the first frame
        # (vos_sampler.py:31-78; missing objects pad with empty masks)
        obj_ids = sorted(clip.masks[0].keys()) or sorted(
            {o for per in clip.masks for o in per.keys()}
        )
        if not obj_ids:
            return None
        k = max(self.sampler.max_num_objects, 1)
        if k > 256:  # "all objects" samplers (EvalSampler uses 10**9):
            k = len(obj_ids)  # pad only to the clip's real object count
        chosen = rng.sample(obj_ids, k=min(k, len(obj_ids)))
        imgs = np.stack(
            [
                ((f.astype(np.float32) / 255.0) - IMG_MEAN) / IMG_STD
                for f in clip.frames
            ]
        )
        hw = imgs.shape[1:3]
        masks = np.stack(
            [
                np.stack(
                    [
                        per.get(chosen[j], np.zeros(hw, bool))
                        if j < len(chosen)
                        else np.zeros(hw, bool)
                        for j in range(k)
                    ]
                )
                for per in clip.masks
            ]
        ).astype(np.float32)  # [T, K, H, W]
        if k == 1:
            masks = masks[:, 0]
        return imgs, masks

    def batches(self, num_batches: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        rng = self._rng
        for _ in range(num_batches):
            rows = []
            while len(rows) < self.batch_size:
                item = self._load_track(rng)
                if item is not None:
                    rows.append(item)
            imgs = np.stack([r[0] for r in rows], axis=1)  # [T, B, S, S, 3]
            masks = np.stack([r[1] for r in rows], axis=1)  # [T, B, S, S]
            yield imgs, masks


class MixedDataLoader:
    """Sample batches from multiple datasets with per-dataset weights
    (reference TorchTrainMixedDataset / MixedDataLoader,
    training/dataset/sam2_datasets.py:18-113 — chunked multi-dataset epochs
    become weighted sampling over per-dataset loaders)."""

    def __init__(self, loaders, weights=None, seed: int = 0):
        self.loaders = list(loaders)
        if weights is None:
            weights = [1.0] * len(self.loaders)
        w = np.asarray(weights, np.float64)
        self.probs = w / w.sum()
        self.seed = seed
        # persistent choice rng (fresh mixture every epoch, like the
        # sub-loaders' persistent rngs)
        self._rng = np.random.default_rng(seed)

    def batches(self, num_batches: int):
        rng = self._rng
        iters = [None] * len(self.loaders)
        for _ in range(num_batches):
            i = int(rng.choice(len(self.loaders), p=self.probs))
            if iters[i] is None:
                iters[i] = self.loaders[i].batches(num_batches)
            try:
                yield next(iters[i])
            except StopIteration:
                iters[i] = self.loaders[i].batches(num_batches)
                yield next(iters[i])
