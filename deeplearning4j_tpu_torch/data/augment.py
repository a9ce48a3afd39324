"""Image augmentation transforms — the DataVec ImageTransform family.

The counterpart of ``deeplearning4j_tpu/data/augment.py`` (reference:
datavec-data-image org.datavec.image.transform.{Flip,Crop,Resize,Rotate,
Pipeline}ImageTransform + ImageTransformProcess). As the reference runs
the whole batch as one program on its device, the port runs it as torch
ops on the batch's device: random flips, crops and rotations of every
image at once.

Transforms operate on [B, H, W, C] float tensors (the internal layout);
``ImageAugmentationPreProcessor`` is the DataSetPreProcessor adapter
that converts from/to the NCHW API layout around them. It first puts the
batch on its device (the card unless the caller passes ``device="cpu"``,
``device.resolve_device``), so host batches from an iterator are
augmented there, as the reference moves them to its accelerator. Each
transform splits into its draws (``draw(key, shape, device)``: the
random numbers for images of that [B, H, W, C] shape, from a
``torch.Generator`` seeded by a ``StepKey``) and their application
(``applyDrawn(images, draws)``: deterministic), so a
caller can replay another run's draws, the reference's included. The
preprocessor's key is (seed, batch counter), so a restarted run redraws
the same stream; torch's Philox stream is not JAX's threefry, so the
draws themselves differ from the reference's (a stated deviation, as for
dropout). Rotation samples bilinearly with zero fill exactly as
``jax.scipy.ndimage.map_coordinates(order=1, mode="constant")``: each of
the four corners contributes only where it lies inside the image, and
the corners are summed in the reference's order; the angle's cosine and
sine are taken in f64 and rounded, so the card and the CPU sample at the
same coordinates.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn.conf.dropout import StepKey

__all__ = ["ImageTransform", "FlipImageTransform", "RandomCropTransform",
           "ResizeImageTransform", "RotateImageTransform",
           "PipelineImageTransform", "ImageAugmentationPreProcessor"]


class ImageTransform:
    """Base: ``apply(key, images[B,H,W,C]) -> images``, the draws of
    ``draw(key, images.shape, images.device)`` applied by
    ``applyDrawn``."""

    def draw(self, key, shape, device):
        return None

    def applyDrawn(self, images, draws):
        raise NotImplementedError

    def apply(self, key, images):
        return self.applyDrawn(images, self.draw(key, images.shape,
                                                 images.device))

    def __call__(self, key, images):
        return self.apply(key, images)


class FlipImageTransform(ImageTransform):
    """Random horizontal flip per image (reference: FlipImageTransform;
    flipMode=1). Draws: a [B] bool tensor."""

    def __init__(self, p=0.5):
        if not (0.0 <= p <= 1.0):
            raise ValueError(f"flip probability must be in [0,1], got {p}")
        self.p = float(p)

    def draw(self, key, shape, device):
        g = key.generator(device)
        return torch.rand(shape[0], generator=g, device=device) < self.p

    def applyDrawn(self, images, flips):
        flips = flips.to(images.device)
        return torch.where(flips[:, None, None, None],
                           images.flip(2), images)


class RandomCropTransform(ImageTransform):
    """Zero-pad by `pad`, then crop a random [height, width] window per
    image (reference: CropImageTransform with random coordinates, the
    pad-and-crop recipe). Draws: ([B] rows, [B] columns) of the
    windows' corners."""

    def __init__(self, height, width, pad=0):
        self.h, self.w, self.pad = int(height), int(width), int(pad)

    def _limits(self, H, W):
        max_y = H + 2 * self.pad - self.h
        max_x = W + 2 * self.pad - self.w
        if max_y < 0 or max_x < 0:
            raise ValueError(
                f"crop {self.h}x{self.w} larger than padded image "
                f"{H + 2 * self.pad}x{W + 2 * self.pad}")
        return max_y, max_x

    def draw(self, key, shape, device):
        max_y, max_x = self._limits(shape[1], shape[2])
        ys = torch.randint(0, max_y + 1, (shape[0],),
                           generator=key.fold(0).generator(device),
                           device=device)
        xs = torch.randint(0, max_x + 1, (shape[0],),
                           generator=key.fold(1).generator(device),
                           device=device)
        return ys, xs

    def applyDrawn(self, images, draws):
        B, H, W, _ = images.shape
        self._limits(H, W)
        ys, xs = (d.to(images.device, torch.long) for d in draws)
        p = self.pad
        xp = F.pad(images, (0, 0, p, p, p, p))
        dev = images.device
        rows = ys[:, None] + torch.arange(self.h, device=dev)[None, :]
        cols = xs[:, None] + torch.arange(self.w, device=dev)[None, :]
        b = torch.arange(B, device=dev)[:, None, None]
        return xp[b, rows[:, :, None], cols[:, None, :]]


class ResizeImageTransform(ImageTransform):
    """Deterministic bilinear resize, half-pixel centres, antialiased
    when shrinking (reference: ResizeImageTransform)."""

    def __init__(self, height, width):
        self.h, self.w = int(height), int(width)

    def applyDrawn(self, images, draws):
        x = images.permute(0, 3, 1, 2)
        dt = x.dtype
        y = F.interpolate(x.float(), size=(self.h, self.w),
                          mode="bilinear", align_corners=False,
                          antialias=True)
        return y.to(dt).permute(0, 2, 3, 1)


class RotateImageTransform(ImageTransform):
    """Random rotation, angle uniform in [-maxAngleDeg, +maxAngleDeg]
    about the image centre, bilinear sampling, zero fill (reference:
    RotateImageTransform). Draws: [B] float32 angles in radians."""

    def __init__(self, maxAngleDeg):
        self.max_rad = float(maxAngleDeg) * np.pi / 180.0

    def draw(self, key, shape, device):
        g = key.generator(device)
        u = torch.rand(shape[0], generator=g, device=device)
        return (u * (2 * self.max_rad) - self.max_rad).float()

    def applyDrawn(self, images, angles):
        B, H, W, C = images.shape
        dev = images.device
        a = angles.to(dev, torch.float32)[:, None, None]
        # the coordinate grid stays f32 whatever the image dtype (bf16
        # cannot hold integers past 256)
        yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32,
                                             device=dev),
                                torch.arange(W, dtype=torch.float32,
                                             device=dev), indexing="ij")
        cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
        # cos and sin in f64, rounded once: the card's f32 cos and the
        # CPU's differ by an ulp, which moves a far corner's sample by
        # ~1e-5 of a pixel at 224^2
        ca = torch.cos(a.double()).float()
        sa = torch.sin(a.double()).float()
        sy = cy + (yy - cy) * ca - (xx - cx) * sa
        sx = cx + (yy - cy) * sa + (xx - cx) * ca
        img = images.float()
        b = torch.arange(B, device=dev)[:, None, None]
        y0 = torch.floor(sy)
        x0 = torch.floor(sx)
        wy1 = sy - y0
        wx1 = sx - x0
        ys = [(y0.long(), 1 - wy1), (y0.long() + 1, wy1)]
        xs = [(x0.long(), 1 - wx1), (x0.long() + 1, wx1)]
        out = None
        for iy, wy in ys:
            for ix, wx in xs:
                valid = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
                v = img[b, iy.clamp(0, H - 1), ix.clamp(0, W - 1)]
                v = torch.where(valid[..., None], v, 0.0)
                term = (wy * wx)[..., None] * v
                out = term if out is None else out + term
        return out.to(images.dtype)


class PipelineImageTransform(ImageTransform):
    """Sequential composition with an independent key a stage (reference:
    PipelineImageTransform / ImageTransformProcess). Draws: one entry a
    stage."""

    def __init__(self, *transforms):
        if len(transforms) == 1 and isinstance(transforms[0], (list, tuple)):
            transforms = tuple(transforms[0])
        if not transforms:
            raise ValueError("PipelineImageTransform needs >= 1 transform")
        self.transforms = list(transforms)

    def apply(self, key, images):
        draws = []
        for i, t in enumerate(self.transforms):
            d = t.draw(key.fold(i), images.shape, images.device)
            images = t.applyDrawn(images, d)
            draws.append(d)
        self.lastDraws = draws
        return images

    def applyDrawn(self, images, draws):
        for t, d in zip(self.transforms, draws):
            images = t.applyDrawn(images, d)
        return images


class ImageAugmentationPreProcessor:
    """DataSetPreProcessor adapter: set on any DataSetIterator with
    setPreProcessor. Copies each batch's features to ``device`` (the
    card unless ``"cpu"`` is asked for) and applies the transform there
    (NCHW API batches are converted to NHWC around it). A batch counter
    folds into the seed, so a restarted run redraws the same
    augmentation stream; the draws of the last batch are kept in
    ``lastDraws`` (a pipeline's: one entry a stage)."""

    def __init__(self, transform: ImageTransform, seed=123,
                 dataFormat="NCHW", device=None):
        self.transform = transform
        self.seed = int(seed)
        fmt = str(dataFormat).upper()
        if fmt not in ("NCHW", "NHWC"):
            raise ValueError(f"dataFormat must be NCHW or NHWC, got "
                             f"{dataFormat!r}")
        self.dataFormat = fmt
        self.device = resolve_device(device)
        self._counter = 0
        self.lastDraws = None

    def run(self, x, draws=None):
        """The transform on a [B, C, H, W] (or NHWC) batch, a tensor or a
        host array, on ``device``: under `draws` when given, else under
        the next key."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        x = x.to(self.device)
        if x.dim() != 4:
            raise ValueError(
                f"image augmentation needs 4-d features, got shape "
                f"{tuple(x.shape)}")
        nchw = self.dataFormat == "NCHW"
        if nchw:
            x = x.permute(0, 2, 3, 1)
        if draws is None:
            key = StepKey(self.seed, self._counter)
            self._counter += 1
            t = self.transform
            if isinstance(t, PipelineImageTransform):
                x = t.apply(key, x)
                self.lastDraws = t.lastDraws
            else:
                self.lastDraws = t.draw(key, x.shape, x.device)
                x = t.applyDrawn(x, self.lastDraws)
        else:
            x = self.transform.applyDrawn(x, draws)
        if nchw:
            x = x.permute(0, 3, 1, 2)
        return x.contiguous()

    def preProcess(self, ds):
        x = ds.getFeatures()
        if hasattr(x, "tensor"):
            x = x.tensor()
        ds.setFeatures(self.run(x))
        return ds
