"""JPEG decode on the card: ``decode_jpeg`` and ``decode_jpeg_batch``.

The port of ``jpeg_tpu.pipelines.decode``.  A stream's format picks its
route:

* a baseline single-scan stream with restart markers, interleaved 4:2:0,
  4:2:2 or 4:4:4 (Cb and Cr sharing tables) or gray
  (``_parse_device_eligible``): its segments are un-stuffed and packed on
  the host, and kernel G (``kernels.huffdec.decode_segments``) decodes
  every segment, one per lane, of any count;
* a baseline stream without restart markers: gray, the 3-scan layout
  (the engine's default output) and interleaved 4:2:0, 4:2:2 or 4:4:4
  with shared chroma tables (``pipelines.speculative``): the speculative
  decode on kernels H (positions) and G (payload);
* any other stream (progressive, other samplings, three quantizers), or
  one whose speculation finds no fixpoint (a fact about its bits, such
  as a corrupt stream): the host entropy decode
  (``golden.decoder.parse_coefficients``, the native ``decode_scan``).
  Under ``entropy_engine="auto"`` it warns, under ``"device"`` it raises.

Dequantize, IDCT (one ``[N, 64] @ [64, 64]`` f32 matmul on the flat
basis, no TF32: ``ops.dct.set_exact_matmul``), 2x chroma upsample and the
BT.601 color conversion then run as torch ops on the same device.  On the
CPU the RGB equals ``jpeg_tpu``'s; on the card the matmul may sum in
another order, within ``jpeg_tpu``'s own device-vs-host bound (max
|diff| <= 2, > 99.9 % within 1).  The entry points take
``device="cuda"`` unless the caller asks for the CPU, and return uint8
tensors on that device: [H, W, 3] RGB or [H, W] gray.
"""
from __future__ import annotations

import functools
import itertools
import warnings

import numpy as np
import torch

from ..core import tables as T
from ..golden.decoder import _reconstruct, parse_coefficients
from ..kernels import huffdec as hd
from ..ops.color import SAMPLING_GEOMETRY
from ..ops.dct import set_exact_matmul
from ..utils.guards import check_entropy_engine
from ..utils.profiling import span
from .encode import _device

_CALLS = itertools.count()  # decode_jpeg_batch's running call number
# jpeg_tpu's text for a stream its device paths cannot take
_HOST_FALLBACK = ("device entropy decode unavailable for this stream (not "
                  "an eligible restart stream and the speculative path was "
                  "ineligible or did not converge); falling back to the "
                  "host entropy decoder")


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device):
    """(flat DCT basis [64, 64] f32, zig-zag order [64]) on ``device``."""
    m = torch.from_numpy(np.asarray(T.dct_flat_basis()[0], np.float32))
    scan = torch.from_numpy(np.asarray(T.SCAN_ORDER, np.int64))
    return m.to(device), scan.to(device)


def _plane_b(zz: torch.Tensor, q: torch.Tensor, ph: int, pw: int):
    """zz [B, nblk, 64] + per-image quantizers q [B, 64] (raster order)
    -> [B, ph, pw] f32 pixels (before rounding)."""
    m, scan = _consts(zz.device)
    qz = q[:, scan].to(torch.float32)
    deq = zz.to(torch.float32) * qz[:, None, :]
    x = torch.matmul(deq.reshape(-1, 64), m) + 128.0  # zz = M @ x - bias
    blocks = x.reshape(zz.shape[0], ph // 8, pw // 8, 8, 8)
    return blocks.permute(0, 1, 3, 2, 4).reshape(zz.shape[0], ph, pw)


def _up2h_b(p: torch.Tensor) -> torch.Tensor:
    """Triangle-filter 2x upsample (3/4-1/4, edge-replicated; the host
    decoder's and libjpeg's "fancy" mode) along the last axis."""
    left = torch.cat([p[..., :1], p[..., :-1]], dim=-1)
    right = torch.cat([p[..., 1:], p[..., -1:]], dim=-1)
    a = 0.75 * p + 0.25 * left
    b = 0.75 * p + 0.25 * right
    return torch.stack([a, b], dim=-1).reshape(*p.shape[:-1],
                                               p.shape[-1] * 2)


def _pixels(plane: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(plane), 0, 255)


def _quant(q, like: torch.Tensor) -> torch.Tensor:
    """Quantizer(s) (array or tensor) as [B, 64] on ``like``'s device."""
    return torch.as_tensor(q, device=like.device).reshape(-1, 64)


def reconstruct_batch(y_zz, cb_zz, cr_zz, luma_q, chroma_q, height: int,
                      width: int, samp: str = "420") -> torch.Tensor:
    """Coefficient stacks [B, nblk, 64] (zig-zag, per plane in raster block
    order) with per-image quantizers [B, 64] -> [B, H, W, 3] uint8 RGB.

    ``samp`` is the chroma geometry: "420" (H/2 x W/2), "422" (H x W/2)
    or "444".  Each plane is rounded and clipped before the upsample, as
    in the host decoder.
    """
    set_exact_matmul()
    ch_h = height // 2 if samp == "420" else height
    ch_w = width // 2 if samp in ("420", "422") else width
    y = _pixels(_plane_b(y_zz, _quant(luma_q, y_zz), height, width))
    cb = _pixels(_plane_b(cb_zz, _quant(chroma_q, cb_zz), ch_h, ch_w))
    cr = _pixels(_plane_b(cr_zz, _quant(chroma_q, cr_zz), ch_h, ch_w))
    if samp == "420":
        def up(p):
            return _up2h_b(_up2h_b(p.transpose(-1, -2)).transpose(-1, -2))
    elif samp == "422":
        up = _up2h_b
    else:
        def up(p):
            return p
    cb = up(cb) - 128.0
    cr = up(cr) - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    return _pixels(torch.stack([r, g, b], dim=-1)).to(torch.uint8)


def reconstruct(y_zz, cb_zz, cr_zz, luma_q, chroma_q, height: int,
                width: int, samp: str = "420") -> torch.Tensor:
    """One image's planes [nblk, 64] -> [H, W, 3] uint8 RGB
    (``reconstruct_batch`` on a batch of one)."""
    return reconstruct_batch(y_zz[None], cb_zz[None], cr_zz[None], luma_q,
                             chroma_q, height, width, samp)[0]


def reconstruct_420(y_zz, cb_zz, cr_zz, luma_q, chroma_q, height: int,
                    width: int) -> torch.Tensor:
    return reconstruct(y_zz, cb_zz, cr_zz, luma_q, chroma_q, height, width,
                       samp="420")


def reconstruct_gray_batch(y_zz, luma_q, height: int,
                           width: int) -> torch.Tensor:
    """[B, nblk, 64] + [B, 64] quantizers -> [B, H, W] uint8."""
    set_exact_matmul()
    y = _plane_b(y_zz, _quant(luma_q, y_zz), height, width)
    return _pixels(y).to(torch.uint8)


def reconstruct_gray(y_zz, luma_q, height: int, width: int) -> torch.Tensor:
    return reconstruct_gray_batch(y_zz[None], luma_q, height, width)[0]


def reconstruct_items(items) -> list[torch.Tensor]:
    """Decoded coefficients of several images -> their uint8 images, in
    order; images of one sampling and padded size reconstruct in one
    batched call.  Each item: (samp, y, cb, cr, luma q, chroma q,
    (padded height, width), (height, width)), planes [nblk, 64] on one
    device (cb, cr and chroma q None for "gray")."""
    groups: dict = {}
    for k, item in enumerate(items):
        groups.setdefault((item[0], item[6]), []).append(k)
    out: list = [None] * len(items)
    with span("decode.reconstruct"):
        for (samp, (ph, pw)), ks in groups.items():
            ys = torch.stack([items[k][1] for k in ks])
            qls = torch.from_numpy(np.stack([items[k][4] for k in ks]))
            if samp == "gray":
                imgs = reconstruct_gray_batch(ys, qls, ph, pw)
            else:
                cbs = torch.stack([items[k][2] for k in ks])
                crs = torch.stack([items[k][3] for k in ks])
                qcs = torch.from_numpy(np.stack([items[k][5] for k in ks]))
                imgs = reconstruct_batch(ys, cbs, crs, qls, qcs, ph, pw,
                                         samp=samp)
            for k, img in zip(ks, imgs):
                h, w = items[k][7]
                out[k] = img[:h, :w]
    return out


def _parse_device_eligible(data: bytes):
    """``_parse_device_eligible_inner``, with a malformed stream meaning
    "host route" (None), never a raised KeyError."""
    try:
        return _parse_device_eligible_inner(data)
    except (KeyError, IndexError, ValueError):
        return None


def _parse_device_eligible_inner(data: bytes):
    """Marker parse + eligibility check for kernel G.

    Eligible: a baseline interleaved 3-component scan with restart
    markers (a short final segment is fine), Cb/Cr sharing Huffman and
    quant tables, or a gray scan with restart markers.  Returns None for
    ineligible streams, else a dict with the per-segment bytes, the
    Huffman table quad, per-segment block counts, and the geometry.
    ``jpeg_tpu`` also sends a stream with a segment over 16000 bytes
    (``_MAX_SEG_BYTES``, its VMEM block) to the host; kernel G reads its
    streams from global memory, so the port has no such limit.
    """
    st = hd.parse_scan_structure(data)
    if st is None:
        return None
    comps = st["comps"]
    if len(comps) == 1:
        # single-component scan: data units are bare 8x8 blocks
        (cid0, _, _, qid0), qid1 = comps[0], comps[0][3]
        cid1 = cid0
        samp = "gray"
        mcu_h = mcu_w = 8
    else:
        samplings = tuple((h, v) for _, h, v, _ in comps)
        samp = hd.SAMPLING_OF_FACTORS.get(samplings)
        if samp is None:
            return None
        (cid0, _, _, qid0), (cid1, _, _, qid1), (cid2, _, _, qid2) = comps
        if qid1 != qid2 or st["tabs"][cid1] != st["tabs"][cid2]:
            return None
        mcu_w, mcu_h = SAMPLING_GEOMETRY[samp][:2]
    width, height = st["width"], st["height"]
    mx, my = -(-width // mcu_w), -(-height // mcu_h)
    mcus = mx * my
    ri = st["restart_interval"]
    S = -(-mcus // ri)
    try:  # final segment may be short (foreign streams; ours keep ri|mcus)
        segs = hd.unstuff_segments(st["entropy"], n_expected=S)
    except ValueError:
        return None
    dht = st["dht"]
    dc0, ac0 = st["tabs"][cid0]
    dc1, ac1 = st["tabs"][cid1]
    try:
        quad = (dht[(0, dc0)], dht[(1, ac0)], dht[(0, dc1)],
                dht[(1, ac1)])
    except KeyError:
        return None
    period = len(hd._PATTERN[samp])
    nblk = [ri * period] * (S - 1) + [(mcus - (S - 1) * ri) * period]
    return dict(samp=samp, segs=segs, quad=quad, nblk=nblk, ri=ri,
                mx=mx, my=my, mcus=mcus, period=period,
                ql=st["quant"][qid0], qc=st["quant"][qid1],
                dims=(my * mcu_h, mx * mcu_w), true_dims=(height, width))


def _em_to_planes(em: torch.Tensor, samp: str, mx: int, my: int):
    """Emission-order blocks [mcus, period, 64] -> per-plane raster block
    arrays (a pure reshape/permute: the inverse of the encoder's MCU
    order)."""
    mcus = mx * my
    if samp == "420":
        y = em[:, :4].reshape(my, mx, 2, 2, 64).permute(0, 2, 1, 3, 4)
        y = y.reshape(4 * mcus, 64)
        cb, cr = em[:, 4], em[:, 5]
    elif samp == "422":
        y = em[:, :2].reshape(2 * mcus, 64)
        cb, cr = em[:, 2], em[:, 3]
    elif samp == "gray":
        return em[:, 0], None, None
    else:
        y, cb, cr = em[:, 0], em[:, 1], em[:, 2]
    return y, cb, cr


def _lane_inputs(infos: list[dict]):
    """Kernel G's arguments for the segments of every stream in ``infos``
    (all of one sampling), as numpy arrays: (streams, maxc, delt, hvp,
    nblk_lane, sampling, nblk_seg, max_words).

    Each segment is one lane, packed exactly: ``jpeg_tpu``'s 128-lane
    padding and power-of-two word buckets serve its TPU compiler and are
    dropped.  Lanes of one image share its four tables.
    """
    segs, nblks, tabs = [], [], []
    for inf in infos:
        segs.extend(inf["segs"])
        nblks.extend(inf["nblk"])
        one = hd.lane_tables([inf["quad"]])
        n = len(inf["segs"])
        tabs.append((np.repeat(one[0], n, axis=1),
                     np.repeat(one[1], n, axis=1),
                     np.repeat(one[2], n, axis=0)))
    streams, max_words = hd.pack_streams(segs)
    return (streams, np.concatenate([t[0] for t in tabs], axis=1),
            np.concatenate([t[1] for t in tabs], axis=1),
            np.concatenate([t[2] for t in tabs], axis=0),
            np.asarray(nblks, np.int32)[None], infos[0]["samp"],
            max(inf["ri"] * inf["period"] for inf in infos), max_words)


def check_mesh(mesh, dev: torch.device) -> None:
    """A decode over ``mesh`` runs on the mesh's device type."""
    if mesh is not None and mesh.device_type != dev.type:
        raise ValueError(f"a {mesh.device_type} mesh cannot decode on "
                         f"{dev}")


def _decode_lanes(infos: list[dict], device, mesh=None,
                  mesh_axis: str = "space") -> torch.Tensor:
    """One kernel G launch over the segments of every stream in ``infos``
    -> zz [S, nblk_seg, 64] on ``device``; with a ``mesh``, one launch a
    rank over its share of the segments, gathered within ``mesh_axis``
    (``kernels.huffdec.decode_segments_sharded``)."""
    with span("decode.lanes"):
        *arrays, samp, nblk_seg, max_words = _lane_inputs(infos)
        lanes = [torch.from_numpy(a).to(device) for a in arrays]
    with span("decode.payload"):
        return hd.decode_segments_sharded(mesh, *lanes, samp, nblk_seg,
                                          max_words, axis=mesh_axis)


def _planes_of(zz: torch.Tensor, info: dict):
    """One stream's lanes [S, >= ri * period, 64] -> its planes."""
    S = len(info["segs"])
    em = zz[:S, :info["ri"] * info["period"]]
    em = em.reshape(S * info["ri"], info["period"], 64)[:info["mcus"]]
    return _em_to_planes(em, info["samp"], info["mx"], info["my"])


def device_entropy_zz(data: bytes, info=None,
                      device: str | torch.device = "cuda"):
    """Kernel G's decode of an eligible restart stream.

    See ``_parse_device_eligible`` for eligibility (``info`` forwards an
    already-parsed result).  Returns (y_zz, cb_zz, cr_zz in raster block
    order on ``device``, luma_q, chroma_q, padded dims, true dims, samp)
    or None when the stream must take the host route.
    """
    dev = _device(device)
    if info is None:
        info = _parse_device_eligible(data)
    if info is None:
        return None
    y, cb, cr = _planes_of(_decode_lanes([info], dev), info)
    return (y, cb, cr, torch.from_numpy(info["ql"]).to(dev),
            torch.from_numpy(info["qc"]).to(dev), info["dims"],
            info["true_dims"], info["samp"])


def _host_decode(data: bytes, dev: torch.device) -> torch.Tensor:
    """Host entropy decode (native ``decode_scan``), reconstruction on
    ``dev``; the host reconstruction for geometries the device one does
    not cover."""
    comps, coeffs, quant, width, height = parse_coefficients(data)

    def host():
        return torch.from_numpy(
            _reconstruct(comps, coeffs, quant, width, height)).to(dev)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    if len(comps) == 1:
        comp = comps[0]
        ph, pw = -(-height // 8) * 8, -(-width // 8) * 8
        if comp.bw and (comp.bw * 8 != pw or comp.bh * 8 != ph):
            return host()
        out = reconstruct_gray(put(coeffs[comp.comp_id]),
                               quant[comp.quant_id], ph, pw)
        return out[:height, :width]
    samplings = [(c.h_samp, c.v_samp) for c in comps]
    samp = hd.SAMPLING_OF_FACTORS.get(tuple(samplings))
    if len(comps) != 3 or samp is None:
        return host()
    luma, cb, cr = comps
    mcu_w, mcu_h = SAMPLING_GEOMETRY[samp][:2]
    ph, pw = -(-height // mcu_h) * mcu_h, -(-width // mcu_w) * mcu_w
    if cb.quant_id != cr.quant_id:
        # reconstruct takes one chroma quantizer; rare 3-table streams go
        # through the general host path
        return host()
    if luma.bw and (luma.bw * 8 != pw or luma.bh * 8 != ph):
        # non-MCU-padded block grid (padded non-interleaved stream from
        # another encoder): host reconstruction handles the general case
        return host()
    out = reconstruct(put(coeffs[luma.comp_id]), put(coeffs[cb.comp_id]),
                      put(coeffs[cr.comp_id]), quant[luma.quant_id],
                      quant[cb.quant_id], ph, pw, samp=samp)
    return out[:height, :width]


def decode_jpeg(data: bytes, entropy_engine: str = "auto",
                device: str | torch.device = "cuda") -> torch.Tensor:
    """Baseline or progressive JFIF bytes -> [H, W, 3] uint8 RGB (or
    [H, W] gray) on ``device``.

    ``entropy_engine``: "auto" decodes an eligible restart stream (see
    ``_parse_device_eligible``) in kernel G, a stream without restarts
    that the speculative decode takes (``pipelines.speculative``) in
    kernels H and G, and any other stream on the host, with a warning;
    "host" always decodes on the host; "device" raises ``ValueError``
    where the card's routes cannot take the stream.
    """
    check_entropy_engine(entropy_engine)
    dev = _device(device)
    # The route depends on the stream's format, and the speculative one on
    # whether its fixpoint converges.  jpeg_tpu also sends every stream to
    # the host off a TPU; under "auto" a restart stream of under 48
    # segments (_MIN_AUTO_SEGMENTS, calibrated on its lanes), and under
    # "device" it first tries one of under 320 segments
    # (_SPEC_RST_MAX_SEGS) on its speculative path.  The port has none of
    # these: every eligible restart stream takes kernel G.
    if entropy_engine != "host":
        info = _parse_device_eligible(data)
        if info is not None:
            y, cb, cr, ql, qc, (ph, pw), (height, width), samp = \
                device_entropy_zz(data, info=info, device=dev)
            if samp == "gray":
                out = reconstruct_gray(y, ql, ph, pw)
            else:
                out = reconstruct(y, cb, cr, ql, qc, ph, pw, samp=samp)
            return out[:height, :width]
        from .speculative import speculative_decode
        out = speculative_decode(data, device=dev)
        if out is not None:
            return out
        if entropy_engine == "device":
            raise ValueError("stream not eligible for device entropy "
                             "decode (needs a baseline interleaved "
                             "3-component or grayscale scan with "
                             "restart markers, or a non-interleaved "
                             "stream large enough for the speculative "
                             "path)")
        warnings.warn(_HOST_FALLBACK, stacklevel=2)
    return _host_decode(data, dev)


def decode_jpeg_batch(datas, entropy_engine: str = "auto",
                      device: str | torch.device = "cuda", mesh=None,
                      mesh_axis: str = "space") -> list[torch.Tensor]:
    """Decode a batch of JPEGs with shared kernel launches.

    The restart segments of every eligible stream of one sampling decode
    in one kernel G launch (each lane carries its own tables and block
    count); the streams without restarts that the speculative decode
    takes share its launches, one set per sampling; images of one
    geometry reconstruct in one batched call.  A stream neither route
    takes decodes on the host (under "auto": with a warning naming the
    stream; under "device": ``ValueError``).  Returns a list of
    [H, W, 3] (or [H, W] gray) uint8 tensors on ``device`` in input
    order.

    ``mesh``: a ``parallel.mesh.make_mesh`` mesh whose ``mesh_axis`` ranks
    share the lanes of every launch of kernels G and H (independent
    segments or chunks; each rank decodes a contiguous share and the
    shares are gathered).  Every rank of that group calls this with the
    same streams and returns every image, equal to the decode without a
    mesh.  ``device`` must be of the mesh's device type.
    """
    with span("decode.call", next(_CALLS)):
        check_entropy_engine(entropy_engine)
        dev = _device(device)
        check_mesh(mesh, dev)
        datas = list(datas)
        results: list = [None] * len(datas)
        groups: dict = {}
        spec_idx = []
        for i, d in enumerate(datas):
            info = None
            if entropy_engine != "host":
                with span("decode.parse"):
                    info = _parse_device_eligible(d)
            if info is None:
                spec_idx.append(i)
            else:
                groups.setdefault(info["samp"], []).append((i, info))
        if spec_idx:
            if entropy_engine != "host":  # non-restart streams: speculative
                from .speculative import speculative_decode_batch
                outs = speculative_decode_batch(
                    [datas[i] for i in spec_idx], device=dev, mesh=mesh,
                    mesh_axis=mesh_axis)
            else:
                outs = [None] * len(spec_idx)
            for i, out in zip(spec_idx, outs):
                if out is not None:
                    results[i] = out
                    continue
                if entropy_engine == "device":
                    raise ValueError(f"stream {i} not eligible for device "
                                     "entropy decode")
                if entropy_engine == "auto":
                    warnings.warn(f"stream {i}: speculative device decode "
                                  "ineligible or non-converged; falling "
                                  "back to the host entropy decoder",
                                  stacklevel=2)
                results[i] = _host_decode(datas[i], dev)

        for samp, items in groups.items():
            # jpeg_tpu first reroutes a group of under 320 segments
            # (_SPEC_RST_MAX_SEGS, its VPU-lane occupancy) through its
            # speculative path on a TPU; the port decodes every group here
            zz = _decode_lanes([inf for _, inf in items], dev, mesh,
                               mesh_axis)
            planes = []
            off = 0
            for i, inf in items:
                S = len(inf["segs"])
                y, cb, cr = _planes_of(zz[off:off + S], inf)
                off += S
                planes.append((inf["samp"], y, cb, cr, inf["ql"],
                               inf["qc"], inf["dims"], inf["true_dims"]))
            for (i, _), img in zip(items, reconstruct_items(planes)):
                results[i] = img
        return results
