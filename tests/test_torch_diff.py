"""The port's frame comparator (``jpeg_tpu_torch.pipelines.diff``) against
``jpeg_tpu.pipelines.diff`` on the CPU: subsample, change mask (pairs on
the threshold included), the host region stages, ``process``,
``compare_pairwise_batch``, ``snap_multiple`` and save/load across the
packages.  Masks and areas must be exactly equal."""
import numpy as np
import pytest
import torch

from jpeg_tpu.pipelines import diff as JD
from jpeg_tpu_torch import FrameComparator
from jpeg_tpu_torch.pipelines import diff as D


def areas(xs) -> list[tuple]:
    """Areas of either package as (x, y, w, h) tuples."""
    return [(a.x, a.y, a.w, a.h) for a in xs]


def rects(xs) -> list[tuple]:
    return [(r.x, r.y, r.X, r.Y) for r in xs]


def port_mask(sub, saved, threshold=D.DEFAULT_THRESHOLD) -> np.ndarray:
    return D.change_mask(torch.from_numpy(sub), torch.from_numpy(saved),
                         threshold).numpy()


def jax_mask(sub, saved, threshold=D.DEFAULT_THRESHOLD) -> np.ndarray:
    return np.asarray(JD.change_mask(sub, saved, threshold))


def _checkerboard(h, w, seed=0):
    """``tests/conftest.py``'s synthetic frame (its fixture pair's source)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((yy // 16 + xx // 16) % 2) * 180 + 40
    img = np.stack([base, 255 - base, (xx * 255 // max(w - 1, 1))], axis=-1)
    noise = rng.integers(-20, 21, size=img.shape)
    return np.clip(img + noise, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def pair640():
    """The synthetic 640x640 pair of ``tests/conftest.py`` (an 80x120
    window inverted)."""
    img = _checkerboard(640, 640, seed=1)
    new = img.copy()
    new[100:180, 300:420] = 255 - new[100:180, 300:420]
    return img, new


# -- device side --------------------------------------------------------------


@pytest.mark.parametrize("shape", [(16, 32, 3), (2, 64, 48, 3),
                                   (2, 3, 32, 16, 3)])
def test_subsample_matches(shape):
    img = np.random.default_rng(len(shape)).integers(
        0, 256, shape, dtype=np.uint8)
    got = D.subsample_4x4(torch.from_numpy(img))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JD.subsample_4x4(img)))


@pytest.mark.parametrize("threshold", [600, 100, 0])
def test_change_mask_matches_on_random_frames(threshold):
    rng = np.random.default_rng(threshold)
    old = rng.integers(0, 256, (3, 40, 48, 3), dtype=np.uint8)
    step = rng.integers(-30, 31, old.shape)
    new = np.clip(old.astype(int) + step, 0, 255).astype(np.uint8)
    new[0] = rng.integers(0, 256, new[0].shape, dtype=np.uint8)
    got = port_mask(new, old, threshold)
    assert got.dtype == bool and got.shape == old.shape[:-1]
    np.testing.assert_array_equal(got, jax_mask(new, old, threshold))
    assert got.any()


def _weighted_sums(new_r, old_r, dg, db):
    """brain.c's weighted sum in f32, term by term in the reference order
    (numpy's f32 ops round each step as torch's and XLA's do)."""
    f = np.float32
    c_r = (new_r + old_r).astype(f) / f(2.0)
    dr2 = ((new_r - old_r) ** 2).astype(f)
    r_term = np.trunc(dr2 * (f(2.0) + c_r / f(256.0)))
    b_raw = (db * db).astype(f) * (f(2.0) + (f(255.0) - c_r) / f(256.0))
    return r_term + (dg * dg).astype(f) * f(4.0) + np.trunc(b_raw), \
        dr2 * (f(2.0) + c_r / f(256.0)), b_raw


def _threshold_pairs(target: int, n: int = 48):
    """(old, new) subsampled pixels whose weighted sum is ``target``, found
    by a search over small deltas and mean reds, each pair with a red and
    a blue term that truncation shortens (a fractional part dropped)."""
    old_r, new_r, dg, db = np.meshgrid(np.arange(0, 256, 3),
                                       np.arange(0, 256, 5),
                                       np.arange(0, 13), np.arange(1, 18),
                                       indexing="ij")
    old_r, new_r, dg, db = (a.ravel() for a in (old_r, new_r, dg, db))
    keep = np.abs(new_r - old_r) <= 17
    old_r, new_r, dg, db = old_r[keep], new_r[keep], dg[keep], db[keep]
    total, r_raw, b_raw = _weighted_sums(new_r, old_r, dg, db)
    hit = np.flatnonzero((total == target) & (r_raw != np.trunc(r_raw))
                         & (b_raw != np.trunc(b_raw)))
    hit = hit[np.linspace(0, len(hit) - 1, n).astype(int)]
    old = np.stack([old_r[hit], np.full(n, 100), np.full(n, 120)], -1)
    new = np.stack([new_r[hit], 100 + dg[hit], 120 - db[hit]], -1)
    return old.astype(np.uint8)[None], new.astype(np.uint8)[None]


@pytest.mark.parametrize("target", [599, 600, 601])
def test_change_mask_on_the_threshold(target):
    old, new = _threshold_pairs(target)
    got = port_mask(new, old)
    np.testing.assert_array_equal(got, jax_mask(new, old))
    assert got.all() == (target > D.DEFAULT_THRESHOLD)
    assert got.any() == (target > D.DEFAULT_THRESHOLD)


# -- host region stages ------------------------------------------------------


def test_find_regions_gap_of_one_connects_and_two_does_not():
    mask = np.zeros((10, 12), bool)
    mask[1, 1:4] = True
    mask[2, 4] = True        # the next column, diagonally: connects
    mask[4, 1:3] = True
    mask[5, 4] = True        # one empty column between: separate
    mask[7, 11] = True       # touches the right edge
    mask[9, 0:12] = True     # a full row along the bottom edge
    got = rects(D.find_regions(mask))
    assert got == rects(JD.find_regions(mask))
    assert (1, 1, 4, 2) in got and (4, 5, 4, 5) in got
    assert (0, 9, 11, 9) in got and len(got) == 5


@pytest.mark.parametrize("ringed", [True, False], ids=["merge", "cut"])
def test_find_regions_region_cap(ringed):
    """More than 100 components.  Ringed: 110 hollow squares, each around
    a dot (220 components, two to a cell, whose boxes overlap): the cap's
    merge pass joins each pair, and the 110 boxes left are cut to 100.
    Otherwise 110 dots, which no pass merges: cut to 100 at once."""
    mask = np.zeros((80, 88), bool)
    for y in range(0, 80, 8):
        for x in range(0, 88, 8):
            mask[y + 2, x + 2] = True
            if ringed:
                mask[y:y + 5, x] = mask[y:y + 5, x + 4] = True
                mask[y, x:x + 5] = mask[y + 4, x:x + 5] = True
    got = rects(D.find_regions(mask))
    assert got == rects(JD.find_regions(mask))
    assert len(got) == D.MAX_REGIONS
    assert all(r[2] - r[0] == (4 if ringed else 0) for r in got)


@pytest.mark.parametrize("h,w", [(160, 96), (640, 640)])
def test_edge_runs_align_inside_the_frame(h, w):
    mask = np.zeros((h // 4, w // 4), bool)
    mask[0, :5] = True
    mask[-1, -3:] = True
    mask[-6:, 0] = True
    mask[10:12, -1] = True
    comp = FrameComparator(h, w, device="cpu")
    got = comp.regions_from_mask(mask)
    assert areas(got) == areas(JD.FrameComparator(h, w).regions_from_mask(
        mask))
    for a in got:
        assert a.x + a.w <= w and a.y + a.h <= h


# -- the comparator ----------------------------------------------------------


def test_areas_on_the_fixture_pair_match(pair640):
    old, new = pair640
    got, want = FrameComparator(640, 640, device="cpu"), \
        JD.FrameComparator(640, 640)
    for c in (got, want):
        c.store(c.subsample(old))
    assert areas(got.compare(got.subsample(new))) \
        == areas(want.compare(want.subsample(new)))
    assert got.compare(got.subsample(new))


@pytest.mark.parametrize("snap", [64, 128])
def test_snap_multiple_matches(pair640, snap):
    old, new = pair640
    got = FrameComparator(640, 640, snap_multiple=snap, device="cpu")
    want = JD.FrameComparator(640, 640, snap_multiple=snap)
    for c in (got, want):
        c.store(c.subsample(old))
    res = got.compare(got.subsample(new))
    assert res and areas(res) == areas(want.compare(want.subsample(new)))
    assert all(a.w % snap == 0 or a.w == 640 for a in res)


def _sequence(h=96, w=160, seed=3):
    """Six frames: a background; a rectangle; the rectangle moved and a
    second one; the same frame again; noise far below the threshold; three
    distant patches (three regions)."""
    rng = np.random.default_rng(seed)
    bg = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    f1 = bg.copy()
    f1[8:32, 12:52] = (250, 10, 10)
    f2 = bg.copy()
    f2[16:40, 24:64] = (250, 10, 10)
    f2[64:88, 120:150] = (10, 240, 30)
    step = rng.integers(-3, 4, f2.shape)
    f4 = np.clip(f2.astype(int) + step, 0, 255).astype(np.uint8)
    f5 = f4.copy()
    for y, x in ((0, 128), (80, 0), (40, 64)):
        f5[y:y + 16, x:x + 32] = 255 - f5[y:y + 16, x:x + 32]
    return np.stack([bg, f1, f2, f2, f4, f5])


def test_process_sequence_matches():
    frames = _sequence()
    got = FrameComparator(96, 160, device="cpu")
    want = JD.FrameComparator(96, 160)
    seen = []
    for f in frames:
        res = got.process(f)
        assert areas(res) == areas(want.process(f))
        np.testing.assert_array_equal(got.stored.numpy(),
                                      np.asarray(want.stored))
        seen.append(len(res))
    assert seen == [0, 1, 2, 0, 0, 3]


def test_pairwise_batch_matches_sequential_and_jpeg_tpu():
    frames = _sequence()
    comp = FrameComparator(96, 160, device="cpu")
    got = comp.compare_pairwise_batch(frames)
    assert [areas(a) for a in got] == [
        areas(a) for a in JD.FrameComparator(96, 160).compare_pairwise_batch(
            frames)]
    for i in range(1, len(frames)):
        comp.store(comp.subsample(frames[i - 1]))
        assert areas(comp.compare(comp.subsample(frames[i]))) \
            == areas(got[i - 1])
    assert got[2] == [] and any(got)


def test_save_load_across_packages(tmp_path, pair640):
    old, new = pair640
    port = FrameComparator(640, 640, device="cpu")
    port.store(port.subsample(old))
    jax_c = JD.FrameComparator(640, 640)
    jax_c.store(jax_c.subsample(old))
    port.save(str(tmp_path / "port.npy"))
    jax_c.save(str(tmp_path / "jax.npy"))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["jax.npy",
                                                          "port.npy"]
    from_port = JD.FrameComparator(640, 640)
    from_port.load(str(tmp_path / "port.npy"))
    from_jax = FrameComparator(640, 640, device="cpu")
    from_jax.load(str(tmp_path / "jax.npy"))
    assert from_jax.stored.dtype == torch.uint8
    np.testing.assert_array_equal(from_jax.stored.numpy(),
                                  np.asarray(from_port.stored))
    assert areas(from_jax.compare(from_jax.subsample(new))) == areas(
        from_port.compare(from_port.subsample(new)))


@pytest.mark.parametrize("call", ["dims", "snap", "compare", "save", "load"])
def test_errors_match(tmp_path, call):
    def run(mod, **kw):
        if call == "dims":
            return mod.FrameComparator(40, 64, **kw)
        if call == "snap":
            return mod.FrameComparator(64, 64, snap_multiple=24, **kw)
        c = mod.FrameComparator(64, 64, **kw)
        if call == "compare":
            return c.compare(c.subsample(np.zeros((64, 64, 3), np.uint8)))
        if call == "save":
            return c.save(str(tmp_path / "x.npy"))
        np.save(tmp_path / "bad.npy", np.zeros((8, 8, 3), np.uint8))
        return c.load(str(tmp_path / "bad.npy"))
    exc = ValueError if call in ("dims", "snap", "load") else RuntimeError
    with pytest.raises(exc) as want:
        run(JD)
    with pytest.raises(exc) as got:
        run(D, device="cpu")
    assert str(got.value) == str(want.value)


def test_comparator_needs_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FrameComparator(64, 64)
