"""NeRF dataset ingestion: transforms.json → NerfDataset.

Python re-implementation of the reference loader's behavior
(ref: src/nerf_loader.cu, nerf_loader.h:65-182):
- merges one or more transforms.json files
- global keys: camera_angle_x/y or fl_x/fl_y, cx/cy/w/h, k1/k2/p1/p2,
  aabb_scale, scale, offset, per-frame overrides, sharpness culling
- **fork defaults**: scale = 1.0, offset = (0,0,0) (identity world mapping
  so Blender units pass through; ref: nerf_loader.h:28,84 +
  src/nerf_loader.cu:185,406) — upstream instant-ngp used 0.33/(.5,.5,.5)
- NeRF→NGP convention: cycle axes xyz←yzx, negate columns 1,2, apply
  scale+offset (ref: nerf_matrix_to_ngp, nerf_loader.h:112-132)
- images loaded in parallel (thread pool), sRGB→linear premultiplied RGBA
- sidecars: <name>.alpha.<ext> alpha override, dynamic_mask_<name>.png
  (masked pixels get negative red and are skipped in training),
  per-frame depth maps via integer_depth_scale
"""
from __future__ import annotations

import dataclasses
import json
import math
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np

NERF_SCALE = 1.0  # fork default (ref: nerf_loader.h:28)


@dataclasses.dataclass
class NerfDataset:
    """Host-side dataset; arrays are numpy, stacked per image."""
    images: np.ndarray            # (I, H, W, 4) float32 linear premultiplied
    xforms: np.ndarray            # (I, 3, 4) camera→world, NGP convention
    xforms_end: np.ndarray        # (I, 3, 4) rolling-shutter end transforms
    focal: np.ndarray             # (I, 2) fl_x, fl_y in pixels
    principal: np.ndarray         # (I, 2) cx, cy normalized to [0,1]
    resolution: np.ndarray        # (I, 2) W, H
    lens_params: np.ndarray       # (I, 7): OpenCV k1 k2 p1 p2 0 0 0, or
                                  # F-theta p0..p4 w h (ref: read_lens)
    lens_is_opencv: bool
    depth_images: Optional[np.ndarray]   # (I, H, W) float32 or None
    aabb_scale: int
    scale: float
    offset: np.ndarray            # (3,)
    n_extra_learnable_dims: int
    sharpness: np.ndarray         # (I,)
    paths: list
    up: np.ndarray                # (3,) up vector (NGP space)
    rays: Optional[np.ndarray] = None    # (I, H, W, 6) o+d, NGP space
    render_aabb: Optional[np.ndarray] = None  # (2,3) crop box (ngp units)
    envmap: Optional[np.ndarray] = None       # (He, We, 4) linear RGBA
    lens_mode: str = "perspective"  # perspective|opencv|ftheta|latlong
    # sRGB uint8 originals when every image round-trips losslessly
    # (LDR, unsharpened, unmasked) — device fast path
    images_u8: Optional[np.ndarray] = None

    @property
    def n_images(self) -> int:
        return self.images.shape[0]


class LazyImageArray:
    """Float32 linear-RGBA view of the stacked sRGB uint8 images,
    converted per image on first access.

    Training ships the uint8 stack to the device and converts per
    sampled texel, so the float copy is only ever read one image at a
    time (eval GT, sharpness maps). Converting every frame eagerly
    dominated dataset load (fox on a single-core host: ~4 s/image of
    LUT + premultiply work, ~1.7 GB resident) for data that was mostly
    never touched."""

    def __init__(self, u8: np.ndarray):
        self._u8 = u8
        self.shape = u8.shape
        self.dtype = np.float32
        self._cache: dict[int, np.ndarray] = {}
        self._dense: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return self.shape[0]

    @property
    def ndim(self) -> int:
        return self._u8.ndim

    def __getitem__(self, i):
        if isinstance(i, (int, np.integer)):
            j = int(i)
            if j < 0:
                j += self.shape[0]
            if j not in self._cache:
                if len(self._cache) > 4:      # eval touches 1-2 views
                    self._cache.clear()
                from ngp_jax.data.image_io import u8_to_linear_rgba
                self._cache[j] = u8_to_linear_rgba(self._u8[j])
            return self._cache[j]
        return self.materialize()[i]

    def __array__(self, dtype=None, copy=None):
        m = self.materialize()
        return m.astype(dtype) if dtype is not None else m

    def materialize(self) -> np.ndarray:
        if self._dense is None:
            from ngp_jax.data.image_io import u8_to_linear_rgba
            self._dense = u8_to_linear_rgba(self._u8)
        return self._dense


def nerf_matrix_to_ngp(m: np.ndarray, scale: float, offset: np.ndarray,
                       from_mitsuba: bool = False,
                       scale_columns: bool = False) -> np.ndarray:
    """ref: nerf_loader.h:112-132 (``scale_columns`` is the crop-box
    variant that scales the rotation columns too)."""
    r = np.array(m[:3, :4], np.float32)
    r[:, 0] *= scale if scale_columns else 1.0
    r[:, 1] *= -scale if scale_columns else -1.0
    r[:, 2] *= -scale if scale_columns else -1.0
    r[:, 3] = r[:, 3] * scale + offset
    if from_mitsuba:
        r[:, 0] *= -1
        r[:, 2] *= -1
    else:
        r = r[[1, 2, 0], :]
    return r


def ngp_matrix_to_nerf(m: np.ndarray, scale: float, offset: np.ndarray,
                       from_mitsuba: bool = False,
                       scale_columns: bool = False) -> np.ndarray:
    r = np.array(m[:3, :4], np.float32)
    if from_mitsuba:
        r[:, 0] *= -1
        r[:, 2] *= -1
    else:
        r = r[[2, 0, 1], :]
    r[:, 0] *= 1.0 / scale if scale_columns else 1.0
    r[:, 1] *= -1.0 / scale if scale_columns else -1.0
    r[:, 2] *= -1.0 / scale if scale_columns else -1.0
    r[:, 3] = (r[:, 3] - offset) / scale
    return r


def _load_image_rgba(path: Path, white_transparent: bool = False,
                     black_transparent: bool = False,
                     defer: bool = False):
    """→ (float32 linear premultiplied RGBA, sRGB uint8 RGBA or None).
    The uint8 copy exists only when it losslessly round-trips to the
    float image (LDR source, no transparency rewrite) — the trainer ships
    it to the device at ¼ the bytes and converts per sampled texel.
    ``defer`` skips the float conversion on that fast path (returns
    (None, u8)); callers materialize via u8_to_linear_rgba on demand."""
    from ngp_jax.data.image_io import load_exr, load_stbi
    if path.suffix.lower() == ".exr":
        img = load_exr(path)
        if img.shape[-1] == 3:
            img = np.concatenate([img, np.ones_like(img[..., :1])], -1)
        return img.astype(np.float32), None
    if white_transparent or black_transparent:
        # NSVF-style flags: pure white/black byte pixels get alpha 0
        # BEFORE premultiplying (ref: convert_rgba32, nerf_loader.cu:59-73)
        from PIL import Image
        from ngp_jax.data.image_io import _srgb_lut
        with Image.open(path) as im:
            arr = np.asarray(im.convert("RGBA"), np.uint8)
        a = arr[..., 3].astype(np.float32) / 255.0
        solid = arr[..., :3]
        if white_transparent:
            a = np.where((solid == 255).all(-1), 0.0, a)
        if black_transparent:
            a = np.where((solid == 0).all(-1), 0.0, a)
        rgb = _srgb_lut()[arr[..., :3]] * a[..., None]
        return np.concatenate([rgb, a[..., None]],
                              -1).astype(np.float32), None
    if defer:
        from PIL import Image
        with Image.open(path) as im:
            u8 = np.asarray(im.convert("RGBA"), np.uint8)
        return None, u8
    img, u8 = load_stbi(path, return_u8=True)
    return img, u8


def _sharpen_image(img: np.ndarray, amount: float) -> np.ndarray:
    """5-tap unsharp filter on all 4 channels; center weight ranges from 5
    (strong) to ∞ (none) (ref: sharpen kernel, nerf_loader.cu:103-130) —
    edge pixels clamp instead of the reference's linear-index wrap."""
    center_w = 4.0 + 1.0 / max(amount, 1e-6)
    p = np.pad(img, ((1, 1), (1, 1), (0, 0)), mode="edge")
    out = (center_w * img - p[:-2, 1:-1] - p[2:, 1:-1]
           - p[1:-1, :-2] - p[1:-1, 2:]) / (center_w - 4.0)
    return np.maximum(out, 0.0).astype(np.float32)


def _find_image_path(dirpath: Path, rel: str) -> Optional[Path]:
    p = dirpath / rel
    if p.exists():
        return p
    for ext in (".png", ".jpg", ".jpeg", ".exr", ".bmp", ".tga"):
        q = p.with_suffix(ext)
        if q.exists():
            return q
    return None


def load_nerf(paths, sharpen: float = 0.0,
              sharpness_discard_threshold: Optional[float] = None,
              max_images: Optional[int] = None,
              downscale: int = 1,
              scale: Optional[float] = None,
              offset: Optional[np.ndarray] = None) -> NerfDataset:
    """Load and merge one or more transforms.json files.

    ``paths``: dataset dir, a transforms.json path, or a list of either.
    """
    if not isinstance(paths, (list, tuple)):
        paths = [paths]
    json_paths = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            # dir scan like the reference: all *.json with "transforms" in
            # the name, else transforms.json (ref: testbed_nerf.cu:2735-2758)
            cands = sorted(p.glob("*transforms*.json")) or [p / "transforms.json"]
            json_paths += cands
        else:
            json_paths.append(p)

    frames, globals_list = [], []
    for jp in json_paths:
        cfg = json.loads(Path(jp).read_text())
        globals_list.append((jp.parent, cfg))
        fs = sorted(cfg.get("frames", []), key=lambda f: f.get("file_path", ""))
        if "n_frames" in cfg:
            fs = fs[: int(cfg["n_frames"])]
        for fr in fs:
            frames.append((jp.parent, cfg, fr))

    basedir, g0 = globals_list[0]
    aabb_scale = int(g0.get("aabb_scale", 1))
    if aabb_scale & (aabb_scale - 1) or aabb_scale > 128:
        raise ValueError(f"aabb_scale must be a power of two ≤ 128, got {aabb_scale}")
    # fork default: identity mapping (Blender units pass through). Upstream
    # instant-ngp used 0.33/(.5,.5,.5) — callers can override (e.g. for the
    # classic fox/nerf-synthetic captures whose cameras otherwise end up
    # far outside the AABB and the background becomes unexplainable).
    if scale is None:
        scale = float(g0.get("scale", NERF_SCALE))
    if offset is None:
        offset = np.asarray(g0.get("offset", [0.0, 0.0, 0.0]), np.float32)
    else:
        offset = np.asarray(offset, np.float32)
    if "aabb" in g0:
        # isotropic fit of the given [[min],[max]] box into the unit cube
        # (ref: nerf_loader.cu:506-512); explicit caller scale/offset wins
        box = np.asarray(g0["aabb"], np.float32)
        length = max(float(np.max(np.abs(box[1] - box[0]))), 1e-6)
        scale = 1.0 / length
        offset = (-(box[1] + box[0]) * 0.5 * scale + 0.5).astype(np.float32)
    render_aabb = None
    if "render_aabb" in g0:
        render_aabb = np.asarray(g0["render_aabb"], np.float32)
    sharpen_amount = float(g0.get("sharpen", sharpen))
    white_transparent = bool(g0.get("white_transparent", False))
    black_transparent = bool(g0.get("black_transparent", False))
    envmap = None
    if "envmap" in g0:
        epath = basedir / g0["envmap"]
        if not epath.exists():
            raise FileNotFoundError(f"Environment map {epath} does not exist")
        from ngp_jax.data.image_io import load_exr, load_stbi
        if epath.suffix.lower() == ".exr":
            envmap = load_exr(epath)
            if envmap.shape[-1] == 3:
                envmap = np.concatenate(
                    [envmap, np.ones_like(envmap[..., :1])], -1)
        else:
            envmap = load_stbi(epath, premultiply=False)
        envmap = envmap.astype(np.float32)
    from_mitsuba = bool(g0.get("from_mitsuba", False))
    n_extra = int(g0.get("n_extra_learnable_dims", 0))
    integer_depth_scale = float(g0.get("integer_depth_scale", 0.0))
    up_nerf = np.asarray(g0.get("up", [0.0, 1.0, 0.0]), np.float32)
    up = up_nerf[[1, 2, 0]] if not from_mitsuba else -up_nerf

    # sharpness-based blurry-frame culling (ref: src/nerf_loader.cu:365-390)
    thresh = sharpness_discard_threshold
    if thresh is None:
        thresh = float(g0.get("sharpness_discard_threshold", 0.0))
    if thresh > 0.0 and frames:
        sharp = np.array([f[2].get("sharpness", 1e9) for f in frames])
        keep = []
        for i in range(len(frames)):
            lo, hi = max(0, i - 1), min(len(frames), i + 2)
            if sharp[i] >= np.mean(sharp[lo:hi]) * thresh:
                keep.append(frames[i])
        frames = keep

    if max_images:
        frames = frames[:max_images]
    if not frames:
        raise ValueError("no frames found")

    def intrinsics_for(cfg: dict, fr: dict, W: float, H: float):
        src = {**cfg, **fr}  # per-frame overrides win
        if "fl_x" in src:
            fx = float(src["fl_x"])
        elif "camera_angle_x" in src:
            fx = 0.5 * W / math.tan(0.5 * float(src["camera_angle_x"]))
        else:
            fx = 0.0
        if "fl_y" in src:
            fy = float(src["fl_y"])
        elif "camera_angle_y" in src:
            fy = 0.5 * H / math.tan(0.5 * float(src["camera_angle_y"]))
        else:
            fy = fx
        if fx == 0.0:
            fx = fy
        cx = float(src.get("cx", W / 2.0)) / W
        cy = float(src.get("cy", H / 2.0)) / H
        lens = np.zeros(7, np.float32)
        if "ftheta_p0" in src:
            # F-theta fisheye polynomial + its native resolution
            # (ref: read_lens, nerf_loader.cu:250-258)
            lens[:5] = [float(src[f"ftheta_p{i}"]) for i in range(5)]
            lens[5] = float(src.get("w", W))
            lens[6] = float(src.get("h", H))
        else:
            lens[:4] = [float(src.get(k, 0.0)) for k in
                        ("k1", "k2", "p1", "p2")]
        return fx, fy, cx, cy, lens

    def load_frame(args):
        dirpath, cfg, fr = args
        ipath = _find_image_path(dirpath, fr["file_path"])
        if ipath is None:
            return None
        img, u8 = _load_image_rgba(ipath, white_transparent,
                                   black_transparent, defer=True)

        def as_float():
            # materialize the deferred float copy (a transform below
            # rewrites pixels, so the u8 fast path no longer round-trips)
            nonlocal img, u8
            if img is None:
                from ngp_jax.data.image_io import u8_to_linear_rgba
                img = u8_to_linear_rgba(u8)
            u8 = None
            return img

        if downscale > 1:
            img = img[::downscale, ::downscale] if img is not None else None
            u8 = u8[::downscale, ::downscale] if u8 is not None else None
        if sharpen_amount > 0.0:
            img = _sharpen_image(as_float(), sharpen_amount)
        H, W = (img if img is not None else u8).shape[:2]
        # alpha sidecar (ref: nerf_loader.cu:586-601)
        apath = ipath.with_name(ipath.stem + ".alpha" + ipath.suffix)
        if apath.exists():
            from ngp_jax.data.image_io import load_stbi
            a = load_stbi(apath, premultiply=False)[..., 0:1]
            f = as_float()
            img = np.concatenate([f[..., :3] * a, a], -1)
        # dynamic mask sidecar → negative red sentinel
        mpath = ipath.with_name("dynamic_mask_" + ipath.stem + ".png")
        if mpath.exists():
            from PIL import Image
            with Image.open(mpath) as im:
                m = np.asarray(im.convert("L"), np.float32) / 255.0
            img = as_float().copy()
            img[..., 0] = np.where(m > 0.5, -1.0, img[..., 0])
        # explicit per-pixel ray dumps (fork Blender workflow sidecar,
        # ref: rays_<name>.dat handling src/nerf_loader.cu:645-666 —
        # raw float32 Ray{o,d} per pixel; disables camera-derived rays)
        rays = None
        rpath = ipath.with_name("rays_" + ipath.stem + ".dat")
        if rpath.exists():
            raw = np.fromfile(rpath, np.float32)
            if raw.size == H * W * 6 * (downscale ** 2):
                rays = raw.reshape(H * downscale, W * downscale, 6)
                rays = rays[::downscale, ::downscale].copy()
                o = rays[..., :3] * scale + offset
                d = rays[..., 3:]
                # nerf→ngp axis cycle (ref: nerf_ray_to_ngp)
                rays = np.concatenate([o[..., [1, 2, 0]],
                                       d[..., [1, 2, 0]]], -1)
        depth = None
        if "depth_path" in fr and integer_depth_scale > 0:
            dpath = dirpath / fr["depth_path"]
            if dpath.exists():
                from PIL import Image
                with Image.open(dpath) as im:
                    # depth is stored in dataset units — apply the world
                    # scale like the transforms (ref: nerf_loader.cu:732
                    # passes depth_scale * result.scale)
                    depth = np.asarray(im, np.float32) * \
                        (integer_depth_scale * scale)
                if downscale > 1:
                    depth = depth[::downscale, ::downscale]
        mat = np.asarray(fr.get("transform_matrix",
                                fr.get("transform_matrix_start")), np.float32)
        mat_end = np.asarray(fr.get("transform_matrix_end", mat), np.float32)
        xf = nerf_matrix_to_ngp(mat, scale, offset, from_mitsuba)
        xf_end = nerf_matrix_to_ngp(mat_end, scale, offset, from_mitsuba)
        fx, fy, cx, cy, lens = intrinsics_for(
            cfg, fr, W * downscale, H * downscale)
        fx, fy = fx / downscale, fy / downscale
        return (img, xf, xf_end, np.array([fx, fy], np.float32),
                np.array([cx, cy], np.float32), np.array([W, H], np.int32),
                lens, depth, float(fr.get("sharpness", 1000.0)), ipath,
                rays, u8)

    with ThreadPoolExecutor(max_workers=16) as pool:
        results = [r for r in pool.map(load_frame, frames) if r is not None]
    if not results:
        raise ValueError("no images could be loaded")

    # The engine batches per-image arrays; resolutions must agree (the
    # reference supports mixed sizes — pad to the max and mask).
    Hs = [(r[0] if r[0] is not None else r[11]).shape[0] for r in results]
    Ws = [(r[0] if r[0] is not None else r[11]).shape[1] for r in results]
    Hm, Wm = max(Hs), max(Ws)
    depths = None
    if any(r[7] is not None for r in results):
        depths = np.zeros((len(results), Hm, Wm), np.float32)
        for i, r in enumerate(results):
            if r[7] is not None:
                h, w = r[7].shape[:2]
                depths[i, :h, :w] = r[7]

    rays_arr = None
    if any(r[10] is not None for r in results):
        rays_arr = np.zeros((len(results), Hm, Wm, 6), np.float32)
        for i, r in enumerate(results):
            if r[10] is not None:
                h, w = r[10].shape[:2]
                rays_arr[i, :h, :w] = r[10]

    imgs_u8 = None
    if all(r[11] is not None for r in results):
        imgs_u8 = np.zeros((len(results), Hm, Wm, 4), np.uint8)
        for i, r in enumerate(results):
            h, w = r[11].shape[:2]
            imgs_u8[i, :h, :w] = r[11]

    if imgs_u8 is not None and all(r[0] is None for r in results):
        # LDR fast path end to end: float images are a lazy view
        imgs = LazyImageArray(imgs_u8)
    else:
        from ngp_jax.data.image_io import u8_to_linear_rgba
        imgs = np.zeros((len(results), Hm, Wm, 4), np.float32)
        for i, r in enumerate(results):
            f = r[0] if r[0] is not None else u8_to_linear_rgba(r[11])
            h, w = f.shape[:2]
            imgs[i, :h, :w] = f

    lens = np.stack([r[6] for r in results])
    # lens mode (ref: read_lens — FTheta/LatLong override OpenCV)
    if bool(g0.get("latlong", False)):
        lens_mode = "latlong"
    elif "ftheta_p0" in g0 or any(np.abs(lens[:, 4:]).sum(1) > 0):
        lens_mode = "ftheta"
    elif np.abs(lens[:, :4]).sum() > 0:
        lens_mode = "opencv"
    else:
        lens_mode = "perspective"
    return NerfDataset(
        images=imgs,
        xforms=np.stack([r[1] for r in results]),
        xforms_end=np.stack([r[2] for r in results]),
        focal=np.stack([r[3] for r in results]),
        principal=np.stack([r[4] for r in results]),
        resolution=np.stack([r[5] for r in results]),
        lens_params=lens,
        lens_is_opencv=lens_mode == "opencv",
        lens_mode=lens_mode,
        depth_images=depths,
        rays=rays_arr,
        aabb_scale=aabb_scale,
        scale=scale,
        offset=offset,
        n_extra_learnable_dims=n_extra,
        sharpness=np.asarray([r[8] for r in results], np.float32),
        paths=[r[9] for r in results],
        up=up,
        render_aabb=render_aabb,
        envmap=envmap,
        images_u8=imgs_u8,
    )
