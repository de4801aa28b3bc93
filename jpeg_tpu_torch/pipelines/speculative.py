"""Speculative entropy decode of baseline streams without restart markers.

The port of ``jpeg_tpu.pipelines.speculative``.  It covers single-component
scans (gray images and the scans of the reference's 3-scan layout) and
interleaved single-scan color without a DRI (default libjpeg/Pillow output).
The decode is bit-serial within a scan; Huffman codes resynchronize, which
the speculation rides (after "Accelerating JPEG Decompression on GPUs",
arxiv 2111.09219):

1. every scan's un-stuffed bytes split into about equal chunks, and the
   chunks of all scans together are the lanes of one launch (each lane
   carries its own tables);
2. kernel H (``kernels.huffdec.scan_positions``) walks blocks from each
   lane's guessed entry bit until the lane crosses its chunk's end, and
   gives its exit bit, block count and bad flag.  Interleaved scans also
   guess each lane's MCU phase (which block of the period comes first);
3. the host iterates the (entry bit, phase) fixpoint of each chain of
   lanes: lane k's true entry is lane k-1's exit, and a chain's head is
   exact from the start.  Only the exits, counts and bad flags
   (3 x S int32) come back each round;
4. one launch of kernel G (``decode_segments`` with per-lane entry bits,
   phases and block counts) decodes the coefficients; torch ops on the
   card stitch the lanes of each chain and add each lane's DC base (an
   exclusive sum of the finals of the lanes before it, per component).

``None`` from the fixpoint (no fixpoint within the round budget, a block
cap too small even after its one retry, a broken chain, a count that does
not add up) is a fact about the stream's bits, never about the card: the
caller then decodes the stream on the host.  Kernel failures raise, and
nothing here catches them.

Kept from ``jpeg_tpu``, since they define the algorithm and which streams
converge: ``_SLACK``, ``_auto_lane_bytes`` with ``_LANE_TARGET`` and the
256-lanes-per-scan split, the byte-proportional phase prior, the round
budgets, the block cap rule (a power of two >= max(64, 3 x the average
blocks per lane), one x4 retry) and the tail clamp and count checks.
Retuning the split for this card is later work, measured on the card.
Dropped, as answers for the TPU: ``_MIN_LANES = 8`` (a route calibrated
on its lanes; a one-lane chain's head is exact, so it converges in one
round), ``_MAX_WORDS = 4096`` (a VMEM bound; kernels H and G read global
memory), ``_PAYLOAD_PEEL``, the power-of-two bucket of the payload's
blocks per lane (the port takes the largest count), the 128-lane padding,
and the fused single-jit driver (``_spec_scans_fused``, ``_fused_jit``,
``_image_recon_key``, ``_reconstruct_traced``), which exists for the
TPU's dispatch latency and decides exactly as ``_spec_scans`` does.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels import huffdec as hd
from ..ops.color import SAMPLING_GEOMETRY
from ..utils.profiling import span
from .decode import (_em_to_planes, _parse_device_eligible, check_mesh,
                     reconstruct_items)
from .encode import _device

_SLACK = 384          # bytes past the chunk end each lane can read (one
#                       worst-case block is ~213 bytes)
_LANE_TARGET = 640    # lanes the adaptive chunking aims to fill
_MAX_ROUNDS = 8
_MAX_ROUNDS_PHASED = 16   # interleaved chains may repair lane by lane
_MAX_LANES_PER_SCAN = 256


def _auto_lane_bytes(total_bytes: int) -> int:
    """Per-lane chunk size: the whole workload in about _LANE_TARGET
    lanes, each of 512 to 4096 bytes."""
    return int(min(4096, max(512, total_bytes // _LANE_TARGET)))


def _spec_scans(scan_list, device: str | torch.device = "cuda",
                target_lane_bytes: int | None = None,
                sampling: str = "gray", mesh=None, mesh_axis: str = "space"):
    """Decode a list of (entropy, table quad, nblk) scans in one combined
    speculative launch -> list of zz [nblk, 64] int32 tensors on
    ``device`` (block emission order), or None (the caller decodes on the
    host).

    ``sampling`` selects the MCU pattern of every chain: "gray" for
    single-component scans (tables at quad rows 0/1), or an interleaved
    mode, whose lanes also guess the MCU phase of their first block.
    ``mesh``: the ranks of its ``mesh_axis`` share every launch's lanes.
    """
    with span("decode.lanes"):
        lanes = scan_lanes(scan_list, _device(device), target_lane_bytes,
                           sampling, mesh, mesh_axis)
    return None if lanes is None else _spec_lanes(lanes)


def scan_lanes(scan_list, dev: torch.device,
               target_lane_bytes: int | None = None,
               sampling: str = "gray", mesh=None, mesh_axis: str = "space"):
    """The lanes of a list of (entropy, quad, nblk) scans, or None where a
    scan holds RSTn markers (the restart path is better)."""
    if target_lane_bytes is None:
        target_lane_bytes = _auto_lane_bytes(
            sum(len(e) for e, _, _ in scan_list))
    chains = []
    for entropy, quad, nblk in scan_list:
        segs = hd.unstuff_segments(entropy)
        if len(segs) != 1:
            return None
        chains.append((segs[0], quad, nblk))
    return prepare_lanes(chains, dev, target_lane_bytes, sampling, mesh,
                         mesh_axis)


@dataclass
class SpecLanes:
    """One combined launch's lanes: the kernels' inputs on the card and
    the host's view of the chains."""
    sampling: str
    streams: torch.Tensor   # [S, max_words] int32
    tables: tuple           # maxc, delt [64, S], hvp [S, 256] int32
    limits: torch.Tensor    # [1, S] int32, bits
    max_words: int
    starts: np.ndarray      # [S] first byte of each lane's chunk
    limit_bits: np.ndarray  # [S]
    prior: np.ndarray       # [S] phase prior (heads: 0)
    chain: np.ndarray       # [S] chain of each lane
    head: np.ndarray        # [S] bool, the first lane of its chain
    need: list              # true block count of each chain
    mesh: object = None     # the ranks of its mesh_axis share the lanes
    mesh_axis: str = "space"

    @property
    def period(self) -> int:
        return len(hd._PATTERN[self.sampling])


def prepare_lanes(chains, dev: torch.device, target_lane_bytes: int,
                  sampling: str, mesh=None,
                  mesh_axis: str = "space") -> SpecLanes:
    """Chunk every (un-stuffed bytes, quad, nblk) chain into lanes of
    about ``target_lane_bytes`` (at most 256 a chain), each reading
    ``_SLACK`` bytes past its chunk, and put the kernels' inputs on
    ``dev`` (the kernels run over ``mesh``'s ``mesh_axis`` when given)."""
    check_mesh(mesh, dev)
    rows, tabs, chain, starts, limits, prior = [], [], [], [], [], []
    period = len(hd._PATTERN[sampling])
    for i, (b, quad, nblk) in enumerate(chains):
        nbytes = len(b)
        n = int(min(max(nbytes // target_lane_bytes, 1),
                    _MAX_LANES_PER_SCAN))
        o = np.linspace(0, nbytes, n + 1).round().astype(np.int64)
        for s, e in zip(o[:-1], o[1:]):
            rows.append(b[s:min(e + _SLACK, nbytes)])
            chain.append(i)
            starts.append(int(s))
            limits.append(8 * int(e - s))
            # blocks are about uniform in bytes: a byte-proportional
            # guess usually lands within a repair round of the truth
            prior.append(int(round(s * nblk / max(nbytes, 1))) % period)
        one = hd.lane_tables([quad])
        tabs.append((np.repeat(one[0], n, axis=1),
                     np.repeat(one[1], n, axis=1),
                     np.repeat(one[2], n, axis=0)))
    streams, max_words = hd.pack_streams(rows)
    tables = tuple(torch.from_numpy(np.concatenate(
        [t[k] for t in tabs], axis=1 if k < 2 else 0)).to(dev)
        for k in range(3))
    limit_bits = np.asarray(limits, np.int64)
    chain = np.asarray(chain)
    head = np.ones(len(chain), bool)
    head[1:] = chain[1:] != chain[:-1]
    return SpecLanes(sampling, torch.from_numpy(streams).to(dev), tables,
                     _put(dev, limit_bits), max_words,
                     np.asarray(starts, np.int64), limit_bits,
                     np.asarray(prior, np.int64), chain, head,
                     [int(n) for _, _, n in chains], mesh, mesh_axis)


def _put(dev, *arrays) -> torch.Tensor:
    """Host int arrays of one length -> one [n, S] int32 tensor on dev."""
    return torch.from_numpy(np.stack(arrays).astype(np.int32)).to(dev)


def positions(lanes: SpecLanes, entries: np.ndarray, phases: np.ndarray,
              cap: int):
    """One launch of kernel H at (entry bit, phase) guesses relative to
    each lane's row -> (exits, counts, bad) as host int64 arrays."""
    dev = lanes.streams.device
    with span("decode.round"):
        ep = _put(dev, entries, phases)
        out = torch.stack(hd.scan_positions_sharded(
            lanes.mesh, lanes.streams, *lanes.tables, ep[0:1], lanes.limits,
            cap_blocks=cap, max_words=lanes.max_words,
            sampling=lanes.sampling, phase=ep[1:2], axis=lanes.mesh_axis))
        return tuple(out.cpu().numpy().astype(np.int64))


def first_cap(lanes: SpecLanes) -> int:
    """The positions pass's first block cap: a power of two >= max(64,
    3 x the average blocks per lane).  Equal-byte chunks vary maybe +-50 %
    in blocks; a lane past the cap (runaway garbage, or a chunk of nearly
    empty blocks) takes the one x4 retry."""
    avg = max(1, sum(lanes.need) // len(lanes.starts))
    return 1 << int(np.ceil(np.log2(max(64, 3 * avg))))


def fixpoint(lanes: SpecLanes):
    """The (entry bit, phase) fixpoint of every chain, one kernel H launch
    a round -> (entries, phases relative to each row, counts with each
    chain's tail clamped), or None (no fixpoint within the round budget
    even after the cap's retry, a broken chain, a count that does not add
    up: the stream goes to the host)."""
    starts, limits, chain = lanes.starts, lanes.limit_bits, lanes.chain
    period = lanes.period
    tail = np.ones(len(starts), bool)
    tail[:-1] = lanes.head[1:]
    upd = ~lanes.head[1:]
    cap = first_cap(lanes)
    entries = 8 * starts                 # absolute bit guesses
    phases = lanes.prior.copy()          # heads are true
    rounds = _MAX_ROUNDS if period == 1 else _MAX_ROUNDS_PHASED
    for _attempt in range(2):
        converged = False
        for _r in range(rounds):
            exits, counts, bad = positions(lanes, entries - 8 * starts,
                                           phases, cap)
            bad = bad.astype(bool)
            capped = (~bad) & (exits < limits) & (counts >= cap)
            if capped.any():
                break  # cap too small: retry larger
            # (entry bit, phase) of lane k = exit state of lane k-1 in its
            # chain; a desynchronized predecessor proposes garbage outside
            # lane k's window: reset those to the chunk start (and the
            # phase to its prior) and keep iterating; accept only a
            # fixpoint with every proposal in its window
            prop = exits[:-1] + 8 * starts[:-1]
            lo = 8 * starts[1:]
            in_range = (prop >= lo) & (prop <= lo + 8 * _SLACK)
            new = entries.copy()
            new[1:][upd] = np.where(in_range, prop, lo)[upd]
            newp = phases.copy()
            prop_p = (phases[:-1] + counts[:-1]) % period
            newp[1:][upd] = np.where(in_range, prop_p,
                                     lanes.prior[1:])[upd]
            fix = (new == entries).all() and (newp == phases).all()
            if fix and in_range[upd].all() and not bad[~tail].any():
                converged = True
                break
            if fix:
                return None  # stuck on a broken chain: corrupt stream
            entries, phases = new, newp
        if converged:
            break
        if not capped.any():
            return None  # no fixpoint within the round budget
        cap *= 4
    else:
        return None

    # each chain's last lane also walks the byte-pad tail: clamp its count
    # to the scan's true block count
    for i, nblk in enumerate(lanes.need):
        sel = np.flatnonzero(chain == i)
        t = sel[-1]
        lastn = nblk - int(counts[sel].sum() - counts[t])
        if not 0 <= lastn <= int(counts[t]):
            return None
        counts[t] = lastn
    return entries - 8 * starts, phases, counts


def payload_inputs(lanes: SpecLanes, entries, phases, counts):
    """Kernel G's speculative-mode arguments at a fixpoint: (streams,
    maxc, delt, hvp, nblk_lane, sampling, nblk_seg, max_words) and the
    keywords (entry, phase, phased), on the card."""
    ecp = _put(lanes.streams.device, entries, phases, counts)
    return ((lanes.streams, *lanes.tables, ecp[2:3], lanes.sampling,
             max(1, int(counts.max())), lanes.max_words),
            dict(entry=ecp[0:1], phase=ecp[1:2], phased=lanes.period > 1))


def _spec_lanes(lanes: SpecLanes):
    """The fixpoint, the payload and the stitch of one combined launch ->
    each chain's zz [nblk, 64] on the card, or None."""
    with span("decode.fixpoint"):
        fx = fixpoint(lanes)
    if fx is None:
        return None
    with span("decode.payload"):
        args, kw = payload_inputs(lanes, *fx)
        out = hd.decode_segments_sharded(lanes.mesh, *args,
                                         axis=lanes.mesh_axis, **kw)
        dev = out.device
        head_of = np.flatnonzero(lanes.head)[np.cumsum(lanes.head) - 1]
        zz = _stitch(out, args[4][0].to(torch.int64),
                     kw["phase"][0].to(torch.int64),
                     torch.from_numpy(head_of).to(dev), lanes.sampling,
                     sum(lanes.need))
    bounds = np.cumsum([0] + lanes.need)
    return [zz[a:b] for a, b in zip(bounds[:-1], bounds[1:])]


def _stitch(out: torch.Tensor, ct: torch.Tensor, phases: torch.Tensor,
            head_of: torch.Tensor, sampling: str, total: int) -> torch.Tensor:
    """The payload's lanes [S, nblk_seg, 64] -> every chain's blocks in
    order, concatenated [total, 64], on the card.

    Block ``d`` lies in the lane where the running sum of the counts
    passes it; each lane's DC terms (cumulative from 0 in the lane, per
    component) get the sum of the finals of the lanes before it in its
    chain (``head_of``: each lane's chain head), per component."""
    dev = out.device
    S, nblk_seg = out.shape[:2]
    period = len(hd._PATTERN[sampling])
    comp_of = torch.tensor([c for _, _, c in hd._PATTERN[sampling]],
                           device=dev)
    cum = torch.cumsum(ct, 0)
    di = torch.arange(total, device=dev)
    lane = torch.searchsorted(cum, di, right=True).clamp(max=S - 1)
    off = (di - (cum - ct)[lane]).clamp(0, nblk_seg - 1)
    zz = out[lane, off]
    jj = torch.arange(nblk_seg, device=dev)
    cseq = comp_of[(phases[:, None] + jj) % period]
    live = jj < ct[:, None]
    lk = torch.arange(S, device=dev)
    fin = torch.zeros((S, 3), dtype=torch.int64, device=dev)
    for c in range(3 if period > 1 else 1):
        last = torch.where(live & (cseq == c), jj, -1).max(1).values
        fin[:, c] = torch.where(last >= 0,
                                out[lk, last.clamp(min=0), 0].to(torch.int64),
                                0)
    before = torch.cumsum(fin, 0) - fin
    base = before - before[head_of]
    comp = comp_of[(phases[lane] + off) % period]
    zz[:, 0] += base[lane, comp].to(torch.int32)
    return zz


def speculative_scan_zz(entropy: bytes, dc_spec, ac_spec, nblk: int,
                        device: str | torch.device = "cuda",
                        target_lane_bytes: int | None = None):
    """One single-component scan -> zig-zagged [nblk, 64] int32 on
    ``device``, or None.  ``dc_spec``/``ac_spec`` are (bits [17],
    huffval) DHT arrays; ``nblk`` the scan's true data-unit count."""
    got = _spec_scans([(entropy, (dc_spec, ac_spec, dc_spec, ac_spec),
                        nblk)], device=device,
                      target_lane_bytes=target_lane_bytes)
    return None if got is None else got[0]


def _color_geometry(comps, width, height, grids):
    """-> (samp, (ph, pw)) for an MCU-padded 3-component stream with
    shared chroma quantizers, else None."""
    samp = hd.SAMPLING_OF_FACTORS.get(
        tuple((h_s, v_s) for _, h_s, v_s, _ in comps))
    (cy, _, _, _qy), (cb, _, _, qb), (cr, _, _, qr) = comps
    if samp is None or qb != qr:
        return None
    mcu_w, mcu_h = SAMPLING_GEOMETRY[samp][:2]
    ph = -(-height // mcu_h) * mcu_h
    pw = -(-width // mcu_w) * mcu_w
    ch_h = ph // 2 if samp == "420" else ph
    ch_w = pw // 2 if samp in ("420", "422") else pw
    if grids[cy] != (pw // 8, ph // 8) or \
            grids[cb] != (ch_w // 8, ch_h // 8) or grids[cb] != grids[cr]:
        return None  # non-MCU-padded foreign grid: host path
    return samp, (ph, pw)


def _parse_spec(data: bytes):
    """``_parse_spec_inner``, with a malformed stream (bad table ids,
    truncated segments) meaning "host route" (None), never a raised
    KeyError that would abort a whole batch."""
    try:
        return _parse_spec_inner(data)
    except (KeyError, IndexError, ValueError):
        return None


def _parse_spec_inner(data: bytes):
    """Parse and validate a stream for the speculative path.

    Non-interleaved streams (gray, the 3-scan layout) and single-scan
    interleaved streams without restart markers.  Returns None for
    anything else (progressive, restarts, non-MCU-padded color grids,
    split chroma quantizers); else a dict with ``sampling``,
    ``scan_list`` (for ``_spec_scans``) and the reconstruction's data.
    """
    info = hd.parse_noninterleaved_scans(data)
    if info is not None:
        comps = info["comps"]
        width, height = info["width"], info["height"]
        hmax = max(c[1] for c in comps)
        vmax = max(c[2] for c in comps)
        grids = {}
        for cid, h_s, v_s, _qid in comps:
            cw = -(-width * h_s // hmax)
            ch = -(-height * v_s // vmax)
            grids[cid] = (-(-cw // 8), -(-ch // 8))  # (bw, bh)
        if len(comps) == 3:
            geo = _color_geometry(comps, width, height, grids)
            if geo is None:
                return None
            info["samp"], info["pdims"] = geo
        elif len(comps) != 1:
            return None
        scan_list = [
            (s["entropy"],
             (s["dc_spec"], s["ac_spec"], s["dc_spec"], s["ac_spec"]),
             grids[s["cid"]][0] * grids[s["cid"]][1])
            for s in info["scans"]]
        return dict(kind="scans", sampling="gray", scan_list=scan_list,
                    info=info, grids=grids)

    # interleaved single scan, no DRI (default foreign output)
    st = hd.parse_scan_structure(data, require_restarts=False)
    if st is None or st["restart_interval"] or len(st["comps"]) != 3:
        return None
    comps = st["comps"]
    samp = hd.SAMPLING_OF_FACTORS.get(
        tuple((h_s, v_s) for _, h_s, v_s, _ in comps))
    (cid0, _, _, qid0), (cid1, _, _, qid1), (cid2, _, _, qid2) = comps
    if samp is None or qid1 != qid2 \
            or st["tabs"][cid1] != st["tabs"][cid2]:
        return None
    mcu_w, mcu_h = SAMPLING_GEOMETRY[samp][:2]
    mx, my = -(-st["width"] // mcu_w), -(-st["height"] // mcu_h)
    dht = st["dht"]
    dc0, ac0 = st["tabs"][cid0]
    dc1, ac1 = st["tabs"][cid1]
    try:
        quad = (dht[(0, dc0)], dht[(1, ac0)], dht[(0, dc1)],
                dht[(1, ac1)])
    except KeyError:
        return None
    period = len(hd._PATTERN[samp])
    scan_list = [(st["entropy"], quad, mx * my * period)]
    return dict(kind="interleaved", sampling=samp, scan_list=scan_list,
                st=st, mx=mx, my=my, pdims=(my * mcu_h, mx * mcu_w),
                ql=st["quant"][qid0], qc=st["quant"][qid1])


def _planes_spec(p, zzs):
    """Per-scan coefficients of one parsed stream -> ``reconstruct_items``'
    item (samp, y, cb, cr, luma q, chroma q, padded dims, true dims)."""
    if p["kind"] == "interleaved":
        st, samp = p["st"], p["sampling"]
        em = zzs[0].reshape(p["mx"] * p["my"], -1, 64)
        y, cb, cr = _em_to_planes(em, samp, p["mx"], p["my"])
        return (samp, y, cb, cr, p["ql"], p["qc"], p["pdims"],
                (st["height"], st["width"]))
    info, grids = p["info"], p["grids"]
    comps = info["comps"]
    dims = (info["height"], info["width"])
    zz_by_cid = {s["cid"]: zz for s, zz in zip(info["scans"], zzs)}
    if len(comps) == 1:
        cid, _, _, qid = comps[0]
        bw, bh = grids[cid]
        return ("gray", zz_by_cid[cid], None, None, info["quant"][qid],
                None, (bh * 8, bw * 8), dims)
    (cy, _, _, qy), (cb, _, _, qb), (cr, _, _, _qr) = comps
    return (info["samp"], zz_by_cid[cy], zz_by_cid[cb], zz_by_cid[cr],
            info["quant"][qy], info["quant"][qb], info["pdims"], dims)


def _reconstruct_spec(p, zzs) -> torch.Tensor:
    """Per-scan coefficients of one parsed stream -> its uint8 image."""
    return reconstruct_items([_planes_spec(p, zzs)])[0]


def speculative_decode(data: bytes, device: str | torch.device = "cuda",
                       target_lane_bytes: int | None = None, mesh=None,
                       mesh_axis: str = "space"):
    """Non-restart baseline stream -> [H, W, 3] / [H, W] uint8 on
    ``device``, or None (the caller decodes on the host).

    Gray, 3-scan color (the reference's own layout) and interleaved
    single-scan color (default libjpeg output) with MCU-padded component
    grids; all scans share one combined launch of each kernel per round.
    ``mesh``: the ranks of its ``mesh_axis`` share every launch's lanes
    (each calls this with the same stream and gets the whole image).
    """
    p = _parse_spec(data)
    if p is None:
        return None
    got = _spec_scans(p["scan_list"], device=device,
                      target_lane_bytes=target_lane_bytes,
                      sampling=p["sampling"], mesh=mesh,
                      mesh_axis=mesh_axis)
    if got is None:
        return None
    return _reconstruct_spec(p, got)


def _restart_spec(data: bytes):
    """A restart stream as speculative chains, one a segment (bit 0 and
    MCU phase 0 at each head, the DC base reset per chain: T.81
    F.2.1.3.1) -> dict(sampling, chains of (un-stuffed bytes, quad,
    nblk), info), or None where kernel G's route would refuse it."""
    info = _parse_device_eligible(data)
    if info is None:
        return None
    return dict(sampling=info["samp"], info=info,
                chains=[(seg, info["quad"], n)
                        for seg, n in zip(info["segs"], info["nblk"])])


def speculative_decode_restart(data: bytes,
                               device: str | torch.device = "cuda",
                               target_lane_bytes: int | None = None,
                               mesh=None, mesh_axis: str = "space"):
    """Restart stream -> uint8 image on ``device``, or None.

    Each restart segment is a chain of lanes (``_restart_spec``), so a
    stream of few segments still fills many lanes, where kernel G alone
    gives one lane a segment.  ``jpeg_tpu`` sends a restart stream of
    under 320 segments this way under "device"; the port's routes do not
    (``pipelines.decode``), and this function stays for measuring the
    choice.  The lane split counts the un-stuffed segment bytes
    (``jpeg_tpu`` counts the stuffed ones).  ``mesh``: the ranks of its
    ``mesh_axis`` share every launch's lanes.
    """
    p = _restart_spec(data)
    if p is None:
        return None
    info = p["info"]
    if target_lane_bytes is None:
        target_lane_bytes = _auto_lane_bytes(sum(len(s) for s in
                                                 info["segs"]))
    got = _spec_lanes(prepare_lanes(p["chains"], _device(device),
                                    target_lane_bytes, p["sampling"], mesh,
                                    mesh_axis))
    if got is None:
        return None
    em = torch.cat(got).reshape(info["mcus"], info["period"], 64)
    y, cb, cr = _em_to_planes(em, info["samp"], info["mx"], info["my"])
    return reconstruct_items([(info["samp"], y, cb, cr, info["ql"],
                               info["qc"], info["dims"],
                               info["true_dims"])])[0]


def speculative_decode_batch(datas, device: str | torch.device = "cuda",
                             target_lane_bytes: int | None = None,
                             mesh=None, mesh_axis: str = "space"):
    """Batch variant -> list of (image or None), one entry per input.

    The scans of all images of one sampling share combined launches; if a
    combined call fails (one corrupt stream), its images are decoded one
    by one before any is given up.  ``mesh``: as ``speculative_decode``.
    """
    parsed = []
    for d in datas:
        with span("decode.parse"):
            parsed.append(_parse_spec(d))
    zzs: list = [None] * len(datas)
    groups: dict = {}
    for i, p in enumerate(parsed):
        if p is not None:
            groups.setdefault(p["sampling"], []).append(i)
    for sampling, idx in groups.items():
        combined = [s for i in idx for s in parsed[i]["scan_list"]]
        got = _spec_scans(combined, device=device,
                          target_lane_bytes=target_lane_bytes,
                          sampling=sampling, mesh=mesh, mesh_axis=mesh_axis)
        if got is not None:
            off = 0
            for i in idx:
                n = len(parsed[i]["scan_list"])
                zzs[i] = got[off:off + n]
                off += n
            continue
        for i in idx:  # the combined call failed: salvage per image
            zzs[i] = _spec_scans(parsed[i]["scan_list"], device=device,
                                 target_lane_bytes=target_lane_bytes,
                                 sampling=sampling, mesh=mesh,
                                 mesh_axis=mesh_axis)
    done = [i for i, z in enumerate(zzs) if z is not None]
    imgs = reconstruct_items([_planes_spec(parsed[i], zzs[i])
                              for i in done])
    results: list = [None] * len(datas)
    for i, img in zip(done, imgs):
        results[i] = img
    return results
