"""Frame-differencing comparator (the reference's "brain"): the port of
``jpeg_tpu.pipelines.diff``.

Capability parity with ``main/brain.c``:

* 4x4 box subsampling (``subsample_4x4``, brain.c:16-44), torch ops on the
  frame's device.  No BGR->RGB swap: the engine is RGB end to end
  (SURVEY §7.1).
* frame store (``store``, brain.c:51-58): the previous frame stays on the
  comparator's device (the reference persists it to SD,
  ``main/main.c:160-163``; ``save``/``load`` do that here).
* perceptually weighted change detection (brain.c:184-195): per pixel,
  with cR = (R_new + R_old) / 2,
      dR^2 * (2 + cR/256) + dG^2 * 4 + dB^2 * (2 + (255-cR)/256) > 600
  on the device for the whole frame at once; each weighted term is
  truncated to an integer like the C uint32 assignments.
* region growing (brain.c:110-235): row runs stitched across adjacent
  rows when their horizontal gap is <= 1, i.e. 8-connected components of
  the change mask, each giving its bounding box.  The mask is small
  (160x160 bools at 640x640), so this sequential stage runs on the host
  after one copy of the mask.
* MCU alignment (``enlargeAdjust``, brain.c:244-261): x4 scale to full
  resolution, center-expanded to multiples of 16, clamped to the frame.
* post-adjust merge of regions closer than 2 px (``overlap2``,
  brain.c:72-76, 211-219) and the small-region filter (w < 32 and h < 24,
  brain.c:221-233).  The region count is capped at 100 (brain.c:158-170).

The device side is eager elementwise torch ops in ``jpeg_tpu``'s order:
no ``torch.compile``, no fused kernel (which could contract a product and
a sum into one FMA and flip a truncation), no TF32 or bf16.  The host side
(``find_regions`` to ``filter_small``) is a copy of ``jpeg_tpu``'s
(``tests/test_torch_diff.py`` holds both equal).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..core.types import Area
from .encode import _device

MAX_REGIONS = 100
DEFAULT_THRESHOLD = 600


def subsample_4x4(rgb: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] uint8 -> [..., H/4, W/4, 3] uint8 box mean (trunc /16).

    Sums one frame at a time in int32, so the temporaries stay one
    frame's size whatever the batch (16 1920x1280 frames: 118 MB of u8,
    whose int32 copy would be 472 MB).  The sums are non-negative, so the
    floor division is the reference's truncation.
    """
    *lead, h, w, c = rgb.shape
    frames = rgb.reshape(-1, h // 4, 4, w // 4, 4, c)
    out = torch.empty((frames.shape[0], h // 4, w // 4, c), dtype=torch.uint8,
                      device=rgb.device)
    for i in range(frames.shape[0]):
        s = frames[i].sum(dim=(1, 3), dtype=torch.int32)
        out[i] = s.floor_divide_(16)
    return out.reshape(*lead, h // 4, w // 4, c)


def change_mask(sub: torch.Tensor, saved: torch.Tensor,
                threshold: int = DEFAULT_THRESHOLD) -> torch.Tensor:
    """Weighted-delta change mask on the subsampled frames (bool, on their
    device).

    Exact brain.c:184-195 arithmetic: deltas squared in int32
    (mathematically the C code's wrapping u32 (new-old)^2) and cast to
    f32, red/blue weights from the mean red channel, each weighted term
    truncated before the sum.  Channel by channel, so that the int32
    temporaries are a third of the frames' size.
    """
    new_r, old_r = sub[..., 0].to(torch.int32), saved[..., 0].to(torch.int32)
    c_r = (new_r + old_r).to(torch.float32) / 2.0
    dr2, dg2, db2 = ((d * d).to(torch.float32) for d in (
        new_r - old_r,
        sub[..., 1].to(torch.int32) - saved[..., 1].to(torch.int32),
        sub[..., 2].to(torch.int32) - saved[..., 2].to(torch.int32)))
    r_term = torch.trunc(dr2 * (2.0 + c_r / 256.0))
    b_term = torch.trunc(db2 * (2.0 + (255.0 - c_r) / 256.0))
    total = r_term + dg2 * 4.0 + b_term
    return total > threshold


@dataclasses.dataclass
class RawRect:
    """Run-extent rect in subsampled coords: x/y = min col/row, X/Y = max."""
    x: int
    y: int
    X: int
    Y: int


def find_regions(mask: np.ndarray) -> list[RawRect]:
    """8-connected components of the change mask -> bounding rects.

    Equivalent to the reference's row-run stitching (brain.c:122-209):
    runs in adjacent rows connect when their horizontal gap <= 1, and
    ``done``-index merging makes connectivity transitive.
    """
    h, w = mask.shape
    runs = []            # (row, beg, end)
    run_id_rows: list[list[int]] = []
    for r in range(h):
        row = mask[r]
        idx = np.flatnonzero(np.diff(np.concatenate([[0], row.view(np.uint8), [0]])))
        row_runs = []
        for k in range(0, len(idx), 2):
            runs.append((r, int(idx[k]), int(idx[k + 1]) - 1))
            row_runs.append(len(runs) - 1)
        run_id_rows.append(row_runs)

    parent = list(range(len(runs)))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    def union(i, j):
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[rj] = ri

    for r in range(1, h):
        for i in run_id_rows[r]:
            _, bi, ei = runs[i]
            for j in run_id_rows[r - 1]:
                _, bj, ej = runs[j]
                if not (ei < bj - 1 or bi > ej + 1):
                    union(i, j)

    rects: dict[int, RawRect] = {}
    for i, (r, b, e) in enumerate(runs):
        root = find(i)
        if root in rects:
            rc = rects[root]
            rc.x, rc.y = min(rc.x, b), min(rc.y, r)
            rc.X, rc.Y = max(rc.X, e), max(rc.Y, r)
        else:
            rects[root] = RawRect(b, r, e, r)
    out = list(rects.values())

    # Cap fallback (brain.c:158-170): merge near-overlapping rects.
    while len(out) > MAX_REGIONS:
        merged = _merge_pass(out, gap=1)
        if len(merged) == len(out):
            out = out[:MAX_REGIONS]
            break
        out = merged
    return out


def _merge_pass(rects: list[RawRect], gap: int) -> list[RawRect]:
    out: list[RawRect] = []
    for rc in rects:
        for o in out:
            if not (rc.x > o.X + gap or rc.X + gap < o.x or
                    rc.y > o.Y + gap or rc.Y + gap < o.y):
                o.x, o.y = min(o.x, rc.x), min(o.y, rc.y)
                o.X, o.Y = max(o.X, rc.X), max(o.Y, rc.Y)
                break
        else:
            out.append(rc)
    return out


def enlarge_adjust(rect: RawRect, width: int, height: int) -> Area:
    """Subsampled run-extent rect -> full-res MCU-aligned Area.

    Exact ``enlargeAdjust`` arithmetic (brain.c:244-261): x4 scale,
    center-expand w/h to multiples of 16, clamp into the frame.
    """
    x, y = rect.x, rect.y
    w = rect.X - rect.x + 1
    h = rect.Y - rect.y + 1
    x, y, w, h = x * 4, y * 4, w * 4, h * 4
    x -= (16 - (w % 16)) // 2
    y -= (16 - (h % 16)) // 2
    w += (16 - w % 16) if w % 16 else 0
    h += (16 - h % 16) if h % 16 else 0
    w = min(w, width)
    h = min(h, height)
    x -= max(0, (x + w) - width)
    y -= max(0, (y + h) - height)
    x = max(0, x)
    y = max(0, y)
    return Area(x=x, y=y, w=w, h=h)


def _align_area(x: int, y: int, w: int, h: int, width: int, height: int,
                multiple: int = 16) -> Area:
    """Center-expand an arbitrary box to ``multiple``-multiples, clamped."""
    m = multiple
    x -= (m - (w % m)) // 2 if w % m else 0
    y -= (m - (h % m)) // 2 if h % m else 0
    w += (m - w % m) if w % m else 0
    h += (m - h % m) if h % m else 0
    w = min(w, width)
    h = min(h, height)
    x -= max(0, (x + w) - width)
    y -= max(0, (y + h) - height)
    return Area(x=max(0, x), y=max(0, y), w=w, h=h)


def merge_adjusted(areas: list[Area], width: int, height: int) -> list[Area]:
    """Merge areas within 2 px of each other (``overlap2``, brain.c:211-219).

    Deliberate divergence from the reference: its post-adjust ``sumAreas``
    takes (min x, min y, max w, max h), which can silently fail to cover
    one of the inputs (brain.c:96-99 applied to x/y/w/h-semantic areas).
    We merge to the true bounding union and re-align it to MCU multiples —
    coverage-preserving and still spec-valid.
    """
    out: list[Area] = []
    for a in areas:
        merged = a
        changed = True
        while changed:
            changed = False
            for i, o in enumerate(out):
                if not (merged.x > o.x + o.w + 2 or merged.x + merged.w + 2 < o.x or
                        merged.y > o.y + o.h + 2 or merged.y + merged.h + 2 < o.y):
                    nx, ny = min(merged.x, o.x), min(merged.y, o.y)
                    nX = max(merged.x + merged.w, o.x + o.w)
                    nY = max(merged.y + merged.h, o.y + o.h)
                    out.pop(i)
                    merged = _align_area(nx, ny, nX - nx, nY - ny,
                                         width, height)
                    changed = True
                    break
        out.append(merged)
    return out


def filter_small(areas: list[Area]) -> list[Area]:
    """Drop regions with w < 32 and h < 24 (brain.c:221-233)."""
    return [a for a in areas if not (a.w < 32 and a.h < 24)]


class FrameComparator:
    """Frame comparator on a device: subsample, store, compare.

    The stored reference frame stays on ``device`` between frames,
    mirroring the reference's ``saved[]`` PSRAM buffer (``main/main.c:27``).
    ``device`` is a CUDA device (which must exist) unless the caller passes
    ``"cpu"``.
    """

    def __init__(self, height: int, width: int,
                 threshold: int = DEFAULT_THRESHOLD,
                 snap_multiple: int | None = None,
                 device: str | torch.device = "cuda"):
        """``snap_multiple`` (a multiple of 16, e.g. 64): additionally
        center-expand region sizes to that granularity.  Not in the
        reference; bounds the number of distinct region shapes, and so the
        per-shape state (encoders, buffers) a region encoder keeps."""
        if height % 16 or width % 16:
            raise ValueError("frame dims must be multiples of 16")
        if snap_multiple and snap_multiple % 16:
            raise ValueError("snap_multiple must be a multiple of 16")
        self.height, self.width = height, width
        self.threshold = threshold
        self.snap_multiple = snap_multiple
        self.device = _device(device)
        self._saved = None

    def to_device(self, frames) -> torch.Tensor:
        """Frames (numpy or torch) as a uint8 tensor on ``device``."""
        if not torch.is_tensor(frames):
            frames = torch.from_numpy(np.ascontiguousarray(frames))
        return frames.to(self.device, torch.uint8)

    def subsample(self, rgb) -> torch.Tensor:
        return subsample_4x4(self.to_device(rgb))

    def store(self, sub) -> None:
        self._saved = None if sub is None else self.to_device(sub)

    @property
    def stored(self):
        return self._saved

    def save(self, path: str) -> None:
        """Persist the stored frame with an atomic swap (``.npy``, the
        format ``jpeg_tpu`` writes and reads).

        Mirrors the firmware persisting ``/sdcard/stored`` via
        unlink+rename (``main/main.c:160-163``) so a crash never leaves a
        torn reference frame.
        """
        if self._saved is None:
            raise RuntimeError("no stored frame to save")
        tmp = path + ".tmp"
        np.save(tmp, self._saved.cpu().numpy())
        os.replace(tmp + ".npy", path)

    def load(self, path: str) -> None:
        """Restore a persisted stored frame (on ``device`` afterwards)."""
        arr = np.load(path)
        if arr.shape != (self.height // 4, self.width // 4, 3):
            raise ValueError(f"stored frame shape {arr.shape} does not match "
                             f"comparator geometry")
        self._saved = self.to_device(arr.astype(np.uint8, copy=False))

    def compare(self, sub) -> list[Area]:
        """Subsampled frame vs stored -> MCU-aligned difference regions.

        One copy of the mask to the host (160x160 bools at 640x640)."""
        if self._saved is None:
            raise RuntimeError("no stored frame; call store() first")
        mask = change_mask(self.to_device(sub), self._saved, self.threshold)
        return self.regions_from_mask(mask.cpu().numpy())

    def regions_from_mask(self, mask: np.ndarray) -> list[Area]:
        """Host region pipeline on a precomputed change mask."""
        rects = find_regions(mask)
        areas = [enlarge_adjust(r, self.width, self.height) for r in rects]
        areas = merge_adjusted(areas, self.width, self.height)
        areas = filter_small(areas)
        if self.snap_multiple:
            areas = [_align_area(a.x, a.y, a.w, a.h, self.width, self.height,
                                 multiple=self.snap_multiple) for a in areas]
        return areas

    def compare_pairwise_batch(self, frames) -> list[list[Area]]:
        """Batched frame-to-previous-frame differencing.

        One subsample of all N frames and one mask pass over the N-1 pairs
        (frame i vs frame i-1) on the device, one copy of the masks to the
        host: the batch-throughput mode of the comparator.  Semantics
        differ from the reference loop only in the stored-frame policy:
        this compares each frame to its immediate predecessor, the right
        model when every frame is retained (video), while ``process``
        keeps the reference's update-on-change stored frame (surveillance
        idle periods).
        """
        subs = subsample_4x4(self.to_device(frames))
        masks = change_mask(subs[1:], subs[:-1], self.threshold).cpu().numpy()
        return [self.regions_from_mask(m) for m in masks]

    def process(self, rgb) -> list[Area]:
        """Full cycle on a raw frame: subsample, compare, re-store.

        The new frame replaces the stored one only when differences are
        found, matching the firmware loop (``main/main.c:147-163``).
        """
        sub = self.subsample(rgb)
        if self._saved is None:
            self.store(sub)
            return []
        areas = self.compare(sub)
        if areas:
            self.store(sub)
        return areas
