"""Camera telemetry ingest: GoPro GPMF (MP4), CAMM (MP4 camera-motion
metadata: Insta360/Pixel-class cameras), GyroFlow .gcsv, GyroFlow JSON
gyro data (raw_imu arrays), Betaflight blackbox logs (.bbl) and their
CSV export, plain CSV.

Rebuild of the reference's Rust `telemetry-parser-cpp` cdylib
(ref: rust/telemetry-parser-cpp/src/lib.rs:17-61, C ABI
inc/telemetry-parser.h:7-18), which wraps the external
`telemetry-parser` crate. The native equivalent is a C++ parser
(native/gpmf/, `make -C native/gpmf`, loaded through ctypes when built,
the same `tp_load_gyro` contract); this module is the always-available
Python implementation and the dispatcher. A copy of
rssync_tpu/frontend/telemetry.py (the port imports nothing of the JAX
package) that also owns `apply_orientation`; its `_iter_boxes` also
yields the header length it consumed, which frontend/probe.py prints.

Outputs follow the reference ABI: timestamps in **seconds** (the Rust
wrapper converts ms -> s, lib.rs:52) and angular rates in **rad/s** (it
converts the crate's deg/s, lib.rs:50).

Orientation strings: 3 chars from {x,X,y,Y,z,Z}; output axis i takes
the named source component, negated for a lowercase letter:
out[:, i] = sign(c_i) * src[:, axis(c_i)], sign = +1 for uppercase.
The reference warns its convention is not GyroFlow's (README.md:47);
guess-orient searches all 48 variants regardless
(ref: core_testcode.cpp:184-233).
"""

from __future__ import annotations

import ctypes
import os
import struct
from dataclasses import dataclass

import numpy as np

from rssync_tpu_torch.utils.checks import SyncPanic

# ---------------------------------------------------------------------------
# public surface


@dataclass
class GyroData:
    """Mirror of `tp_gyrodata` (ref: inc/telemetry-parser.h:8-12):
    timestamps (n,) seconds f64; gyro (n, 3) rad/s f64."""

    timestamps: np.ndarray
    gyro: np.ndarray

    @property
    def samples(self) -> int:
        return len(self.timestamps)


_ORIENT_AXES = {"x": 0, "y": 1, "z": 2}


def apply_orientation(gyro: np.ndarray, orient: str | None) -> np.ndarray:
    """Axis remap/sign flip of (n, 3) rates per the orientation string."""
    if not orient:
        return gyro
    if len(orient) != 3 or any(c.lower() not in _ORIENT_AXES for c in orient):
        raise ValueError(f"bad orientation string {orient!r}")
    out = np.empty_like(gyro)
    for i, c in enumerate(orient):
        sign = 1.0 if c.isupper() else -1.0
        out[:, i] = sign * gyro[:, _ORIENT_AXES[c.lower()]]
    return out


def load_gyro(path: str, orient: str | None = None,
              prefer_native: bool = True) -> GyroData:
    """`tp_load_gyro` equivalent: auto-detect format by content/
    extension, return normalized gyro (ref: lib.rs:17-61). Tries the
    native C++ parser first (if built), falls back to Python."""
    if prefer_native:
        native = _native_load(path, orient)
        if native is not None:
            return native
    ext = os.path.splitext(path)[1].lower()
    if ext == ".gcsv":
        data = parse_gcsv(path)
    elif ext in (".json", ".gyroflow"):
        data = parse_gyroflow_json(path)
    elif ext in (".mp4", ".mov", ".360"):
        data = parse_mp4(path)
    elif ext in (".bbl", ".bfl"):
        data = parse_blackbox_bbl(path)
    elif ext == ".csv":
        # blackbox_decode CSVs self-identify via their gyroADC columns
        with open(path, "r") as f:
            head = f.read(4096)
        data = parse_blackbox_csv(path) if "gyroADC[0]" in head else parse_csv(path)
    else:
        # content sniff: MP4 starts with a box header whose type is
        # printable 4cc at offset 4 ('ftyp' usually)
        with open(path, "rb") as f:
            head = f.read(64)
        if len(head) >= 8 and head[4:8] in (b"ftyp", b"moov", b"mdat"):
            data = parse_mp4(path)
        elif head.startswith(b"H Product:Blackbox"):
            data = parse_blackbox_bbl(path)
        elif head.lstrip()[:1] in (b"{", b"["):
            data = parse_gyroflow_json(path)
        else:
            data = parse_gcsv(path)
    data.gyro = apply_orientation(data.gyro, orient)
    return data


# ---------------------------------------------------------------------------
# native C++ parser hook (same C ABI as the reference wrapper)

_NATIVE_LIB = None
_NATIVE_TRIED = False


class _TpGyroData(ctypes.Structure):
    _fields_ = [
        ("samples", ctypes.c_size_t),
        ("timestamps", ctypes.POINTER(ctypes.c_double)),
        ("gyro", ctypes.POINTER(ctypes.c_double)),
    ]


def _native_lib():
    global _NATIVE_LIB, _NATIVE_TRIED
    if _NATIVE_TRIED:
        return _NATIVE_LIB
    _NATIVE_TRIED = True
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for cand in (
        os.path.join(here, "..", "native", "gpmf", "librssync_gpmf.so"),
        os.path.join(here, "native", "librssync_gpmf.so"),
    ):
        cand = os.path.abspath(cand)
        if os.path.exists(cand):
            lib = ctypes.CDLL(cand)
            lib.tp_load_gyro.restype = _TpGyroData
            lib.tp_load_gyro.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
            lib.tp_free.restype = None
            lib.tp_free.argtypes = [_TpGyroData]
            _NATIVE_LIB = lib
            break
    return _NATIVE_LIB


def _native_load(path: str, orient: str | None) -> GyroData | None:
    lib = _native_lib()
    if lib is None:
        return None
    # the native lib parses every format this module dispatches (GPMF/
    # CAMM MP4, GyroFlow JSON, .gcsv, blackbox .bbl, blackbox CSV,
    # plain CSV) — same single-entry-point contract as the reference's
    # telemetry-parser crate (ref: lib.rs:29-37)
    res = lib.tp_load_gyro(
        path.encode(), orient.encode() if orient else None
    )
    if res.samples == 0:
        return None  # fall back to Python for diagnostics
    n = int(res.samples)
    ts = np.ctypeslib.as_array(res.timestamps, shape=(n,)).copy()
    gy = np.ctypeslib.as_array(res.gyro, shape=(n, 3)).copy()
    lib.tp_free(res)
    # the native lib applies orientation itself (ABI parity) — the
    # caller's apply_orientation must not run twice, so return through
    # load_gyro's orient=None path: we already oriented here.
    return GyroData(timestamps=ts, gyro=apply_orientation(gy, None))


# ---------------------------------------------------------------------------
# GyroFlow .gcsv


def parse_gcsv(path: str) -> GyroData:
    """GyroFlow gcsv: header key,value lines (tscale/gscale/...) then
    `t,gx,gy,gz[,ax,ay,az]` rows. gscale converts to rad/s."""
    tscale, gscale = 1.0, 1.0
    rows = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(",")
            k = parts[0].lower()
            if k == "tscale":
                tscale = float(parts[1])
            elif k == "gscale":
                gscale = float(parts[1])
            elif k in ("ascale", "mscale", "version", "id", "orientation",
                       "videofilename", "lensprofile", "lens_profile",
                       "vendor", "frequency", "note"):
                continue
            elif k in ("t", "time"):
                continue  # column header
            else:
                try:
                    rows.append([float(v) for v in parts[:4]])
                except ValueError:
                    continue
    if not rows:
        raise SyncPanic(f"no gyro rows in {path}")
    arr = np.asarray(rows, np.float64)
    return GyroData(timestamps=arr[:, 0] * tscale, gyro=arr[:, 1:4] * gscale)


def parse_csv(path: str) -> GyroData:
    """Plain CSV `t_seconds,gx,gy,gz` (rad/s), optional header line."""
    data = np.genfromtxt(path, delimiter=",", skip_header=0)
    if data.ndim != 2 or np.isnan(data[0]).any():
        data = np.genfromtxt(path, delimiter=",", skip_header=1)
    if data.ndim != 2 or data.shape[1] < 4:
        raise SyncPanic(f"bad gyro csv {path}")
    return GyroData(timestamps=data[:, 0], gyro=data[:, 1:4])


def parse_gyroflow_json(path: str) -> GyroData:
    """GyroFlow JSON gyro data: a top-level sample array, or an object
    with a `raw_imu` array; each sample `{"ts": <ms>, "gyro":
    [x, y, z] deg/s, ...}` (GyroFlow's raw_imu convention; extra keys
    like "accl"/"magn" are ignored). Normalized to seconds / rad/s
    like every other path (ABI parity, ref lib.rs:50-56). Mirrors
    native/gpmf/gpmf_parser.cpp::parse_gyroflow_json."""
    import json

    with open(path, "r") as f:
        doc = json.load(f)
    if isinstance(doc, dict):
        doc = doc.get("raw_imu")
    if not isinstance(doc, list):
        raise SyncPanic(f"no raw_imu sample array in {path}")
    ts, gyro = [], []
    for item in doc:
        if not isinstance(item, dict):
            continue
        t = item.get("ts")
        g = item.get("gyro")
        if t is None or not isinstance(g, (list, tuple)) or len(g) < 3:
            continue
        ts.append(float(t) * 1e-3)
        gyro.append([float(g[0]), float(g[1]), float(g[2])])
    if not ts:
        raise SyncPanic(f"no gyro samples in {path}")
    return GyroData(
        timestamps=np.asarray(ts, np.float64),
        gyro=np.deg2rad(np.asarray(gyro, np.float64)),
    )


# ---------------------------------------------------------------------------
# GoPro GPMF inside MP4

_GPMF_TYPE_FMT = {
    ord("b"): ("b", 1), ord("B"): ("B", 1),
    ord("s"): (">h", 2), ord("S"): (">H", 2),
    ord("l"): (">i", 4), ord("L"): (">I", 4),
    ord("f"): (">f", 4), ord("d"): (">d", 8),
    ord("j"): (">q", 8), ord("J"): (">Q", 8),
}


def _iter_boxes(buf, start, end):
    """Yield (fourcc, payload_start, payload_end, header_length) for
    ISO-BMFF boxes; the box starts at payload_start - header_length (16
    for a 64-bit largesize header whatever the payload's size)."""
    off = start
    while off + 8 <= end:
        size = struct.unpack_from(">I", buf, off)[0]
        typ = bytes(buf[off + 4 : off + 8])
        hdr = 8
        if size == 1:
            if off + 16 > end:
                break
            size = struct.unpack_from(">Q", buf, off + 8)[0]
            hdr = 16
        elif size == 0:
            size = end - off
        # bound by the remaining span: a lying 64-bit size must neither
        # yield an out-of-range payload nor stall the walk
        if size < hdr or size > end - off:
            break
        yield typ, off + hdr, off + size, hdr
        off += size


def _find_box(buf, start, end, path):
    """Descend a path of box fourccs; return (payload_start, payload_end)."""
    cur = [(start, end)]
    for name in path:
        nxt = []
        for s, e in cur:
            for typ, ps, pe, _ in _iter_boxes(buf, s, e):
                if typ == name:
                    nxt.append((ps, pe))
        if not nxt:
            return []
        cur = nxt
    return cur


def _parse_klv(buf, start, end, out, depth=0):
    """Recursive GPMF KLV walk collecting per-stream fields. Depth is
    capped (real GPMF nests 3-4 deep) so a crafted nesting bomb cannot
    exhaust the interpreter stack — mirrors the native parser's cap."""
    if depth > 32:
        return
    off = start
    while off + 8 <= end:
        key = bytes(buf[off : off + 4])
        typ = buf[off + 4]
        ssize = buf[off + 5]
        repeat = struct.unpack_from(">H", buf, off + 6)[0]
        dlen = ssize * repeat
        dstart = off + 8
        if typ == 0:  # nested container
            if key == b"STRM":
                stream: dict = {}
                _parse_klv(buf, dstart, dstart + dlen, stream, depth + 1)
                out.setdefault("streams", []).append(stream)
            else:
                _parse_klv(buf, dstart, dstart + dlen, out, depth + 1)
        else:
            out[key] = (typ, ssize, repeat, dstart)
        off = dstart + ((dlen + 3) & ~3)


def _decode_values(buf, field):
    typ, ssize, repeat, dstart = field
    if typ == ord("c"):
        return bytes(buf[dstart : dstart + ssize * repeat])
    fmt = _GPMF_TYPE_FMT.get(typ)
    if fmt is None:
        return None
    code, width = fmt
    per = ssize // width
    vals = []
    for r in range(repeat):
        base = dstart + r * ssize
        vals.append(
            [struct.unpack_from(code, buf, base + i * width)[0] for i in range(per)]
        )
    return np.asarray(vals, np.float64)


def _orin_remap(raw: np.ndarray, orin: bytes | None, orio: bytes | None):
    """GoPro ORIN/ORIO orientation normalization: for each output axis
    letter in ORIO (default XYZ), pick the ORIN position with the same
    letter (case-insensitive); negate when cases differ."""
    if not orin:
        return raw
    orio = orio or b"XYZ"
    out = np.empty_like(raw)
    for j in range(3):
        want = chr(orio[j])
        for i in range(3):
            have = chr(orin[i])
            if have.lower() == want.lower():
                sign = 1.0 if (have.isupper() == want.isupper()) else -1.0
                out[:, j] = sign * raw[:, i]
                break
        else:
            return raw  # malformed ORIN: leave as-is
    return out


def _mp4_open(path):
    import mmap

    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    return mm, memoryview(mm)


def _find_track(buf, size, match) -> tuple[int, int] | None:
    """First moov/trak whose hdlr or stsd satisfies `match(bytes)`."""
    for ts_, te_ in _find_box(buf, 0, size, [b"moov", b"trak"]):
        hdl = _find_box(buf, ts_, te_, [b"mdia", b"hdlr"])
        if hdl and match(bytes(buf[hdl[0][0] : hdl[0][1]])):
            return ts_, te_
        stsd = _find_box(buf, ts_, te_, [b"mdia", b"minf", b"stbl", b"stsd"])
        if stsd and match(bytes(buf[stsd[0][0] : stsd[0][1]])):
            return ts_, te_
    return None


def _track_samples(buf, ts_, te_):
    """Expand a track's sample tables: per-sample (file offset, size,
    start seconds, duration seconds)."""

    def box(path_):
        r = _find_box(buf, ts_, te_, path_)
        return r[0] if r else None

    mdhd = box([b"mdia", b"mdhd"])
    version = buf[mdhd[0]]
    timescale = struct.unpack_from(
        ">I", buf, mdhd[0] + (20 if version == 1 else 12)
    )[0]

    stbl = [b"mdia", b"minf", b"stbl"]
    stsz = box(stbl + [b"stsz"])
    sample_size = struct.unpack_from(">I", buf, stsz[0] + 4)[0]
    sample_count = struct.unpack_from(">I", buf, stsz[0] + 8)[0]
    # Hostile/mutated tables: no table can describe more entries than its
    # box (or the whole file) has bytes. Clamp every declared count before
    # any O(count) expansion, or a single flipped high byte turns the walk
    # into a multi-GB allocation / billions-iteration loop.
    if sample_size == 0:
        sample_count = min(sample_count, max(0, (stsz[1] - stsz[0] - 12) // 4))
        sizes = np.frombuffer(
            buf, dtype=">u4", count=sample_count, offset=stsz[0] + 12
        ).astype(np.int64)
    else:
        sample_count = min(sample_count, len(buf))
        sizes = np.full(sample_count, sample_size, np.int64)

    co = box(stbl + [b"stco"])
    if co is not None:
        nco = struct.unpack_from(">I", buf, co[0] + 4)[0]
        nco = min(nco, max(0, (co[1] - co[0] - 8) // 4))
        offsets = np.frombuffer(
            buf, dtype=">u4", count=nco, offset=co[0] + 8
        ).astype(np.int64)
    else:
        co = box(stbl + [b"co64"])
        nco = struct.unpack_from(">I", buf, co[0] + 4)[0]
        nco = min(nco, max(0, (co[1] - co[0] - 8) // 8))
        offsets = np.frombuffer(
            buf, dtype=">u8", count=nco, offset=co[0] + 8
        ).astype(np.int64)

    # sample->chunk mapping
    stsc = box(stbl + [b"stsc"])
    nsc = struct.unpack_from(">I", buf, stsc[0] + 4)[0]
    nsc = min(nsc, max(0, (stsc[1] - stsc[0] - 8) // 12))
    stsc_rows = [
        struct.unpack_from(">III", buf, stsc[0] + 8 + 12 * i) for i in range(nsc)
    ]
    # expand to per-sample file offsets
    sample_offsets = np.zeros(sample_count, np.int64)
    si = 0
    for ri, (first_chunk, spc, _) in enumerate(stsc_rows):
        last_chunk = (
            stsc_rows[ri + 1][0] - 1 if ri + 1 < nsc else len(offsets)
        )
        for chunk in range(first_chunk, last_chunk + 1):
            base = offsets[chunk - 1]
            for _ in range(spc):
                if si >= sample_count:
                    break
                sample_offsets[si] = base
                base += sizes[si]
                si += 1
    # sample durations from stts
    stts = box(stbl + [b"stts"])
    nst = struct.unpack_from(">I", buf, stts[0] + 4)[0]
    nst = min(nst, max(0, (stts[1] - stts[0] - 8) // 8))
    durs = []
    for i in range(nst):
        if len(durs) >= sample_count:
            break
        cnt, delta = struct.unpack_from(">II", buf, stts[0] + 8 + 8 * i)
        durs.extend([delta] * min(cnt, sample_count - len(durs)))
    durs = np.asarray(durs[:sample_count], np.float64) / timescale
    starts = np.concatenate([[0.0], np.cumsum(durs)[:-1]])
    return sample_offsets, sizes, starts, durs


def parse_mp4_gpmf(path: str) -> GyroData:
    """Extract the GPMF metadata track and decode GYRO samples with
    SCAL scaling, ORIN/ORIO normalization, and stts-spread timestamps.
    Reads the relevant boxes via mmap-ish buffer (the whole file is
    memory-mapped, only touched pages load)."""
    mm, buf = _mp4_open(path)
    try:
        gp = _find_track(
            buf, len(mm), lambda b: b"gpmd" in b or b"GoPro MET" in b
        )
        if gp is None:
            raise SyncPanic(f"no GPMF track in {path}")
        sample_offsets, sizes, starts, durs = _track_samples(buf, *gp)
        sample_count = len(sizes)

        all_ts, all_gyro = [], []
        for k in range(sample_count):
            payload: dict = {}
            _parse_klv(
                buf, int(sample_offsets[k]), int(sample_offsets[k] + sizes[k]), payload
            )
            for stream in payload.get("streams", []):
                if b"GYRO" not in stream:
                    continue
                raw = _decode_values(buf, stream[b"GYRO"])
                if raw is None or raw.shape[1] != 3:
                    continue
                scal = (
                    _decode_values(buf, stream[b"SCAL"])
                    if b"SCAL" in stream
                    else np.asarray([[1.0]])
                )
                scal = scal.reshape(-1)
                vals = raw / (scal if len(scal) == 3 else scal[0])
                orin = stream.get(b"ORIN")
                orio = stream.get(b"ORIO")
                vals = _orin_remap(
                    vals,
                    _decode_values(buf, orin) if orin else None,
                    _decode_values(buf, orio) if orio else None,
                )
                n = len(vals)
                t = starts[k] + durs[k] * np.arange(n) / max(n, 1)
                all_ts.append(t)
                all_gyro.append(vals)
        if not all_ts:
            raise SyncPanic(f"GPMF track has no GYRO stream in {path}")
        return GyroData(
            timestamps=np.concatenate(all_ts), gyro=np.concatenate(all_gyro)
        )
    finally:
        buf.release()
        mm.close()


# ---------------------------------------------------------------------------
# CAMM (Google camera-motion metadata) inside MP4 — Insta360/Pixel-
# class cameras. Spec: developers.google.com/streetview/publish/camm-spec:
# each sample is one little-endian packet `u16 reserved, u16 type,
# payload`; type 2 = angular velocity, 3x f32 rad/s.


def parse_mp4_camm(path: str) -> GyroData:
    mm, buf = _mp4_open(path)
    try:
        tk = _find_track(buf, len(mm), lambda b: b"camm" in b)
        if tk is None:
            raise SyncPanic(f"no CAMM track in {path}")
        sample_offsets, sizes, starts, durs = _track_samples(buf, *tk)
        ts, gyro = [], []
        for k in range(len(sizes)):
            off = int(sample_offsets[k])
            if sizes[k] < 16:
                continue
            typ = struct.unpack_from("<H", buf, off + 2)[0]
            if typ != 2:
                continue
            gyro.append(struct.unpack_from("<3f", buf, off + 4))
            ts.append(starts[k])
        if not ts:
            raise SyncPanic(f"CAMM track has no gyro packets in {path}")
        return GyroData(
            timestamps=np.asarray(ts, np.float64),
            gyro=np.asarray(gyro, np.float64),
        )
    finally:
        buf.release()
        mm.close()


def parse_mp4(path: str) -> GyroData:
    """MP4 dispatcher: GPMF first (GoPro), then CAMM."""
    try:
        return parse_mp4_gpmf(path)
    except SyncPanic:
        return parse_mp4_camm(path)


# ---------------------------------------------------------------------------
# Betaflight/INAV blackbox CSV (the thesis' FPV-drone use case) —
# `blackbox_decode --csv` output: header row with `time` (us) and
# `gyroADC[0..2]` (deg/s) columns.


def parse_blackbox_bbl(path: str) -> GyroData:
    """Binary Betaflight/INAV blackbox log (.bbl/.bfl): ASCII `H ...`
    header lines defining per-frame field tables, then binary I
    (intra) / P (predicted) frames with variable-byte encodings.

    Implements the published blackbox data-format v2 subset needed for
    `time` + `gyroADC[0..2]`: encodings SIGNED_VB(0), UNSIGNED_VB(1),
    NEG_14BIT(3), TAG8_8SVB(6), TAG2_3S32(7), TAG8_4S16(8), NULL(9)
    and predictors ZERO(0), PREVIOUS(1), STRAIGHT_LINE(2), AVERAGE_2(3),
    INCREMENT(6). S (slow) frames are decoded per their own field table
    so the stream position stays exact; E (event) frames handle sync-
    beep(0), logging-resume(30) and end-of-log(255); any other frame
    type or event terminates the decode at the last good frame (the
    same fail-soft behavior as blackbox_decode's resync-less core).

    Unit convention: the `gyro_scale` header (hex-float or decimal) is
    radians per microsecond per raw LSB, so rad/s = raw * scale * 1e6;
    absent it, raw is assumed 16.4 LSB/(deg/s) (MPU 2000 dps). No real
    .bbl exists in this environment — fixture-validated only (see
    native/gpmf/VALIDATION.md). Mirrors
    native/gpmf/gpmf_parser.cpp::parse_blackbox_bbl bit for bit.
    Replaces the reference crate's blackbox support
    (ref: rust/telemetry-parser-cpp/src/lib.rs:29-37).
    """
    with open(path, "rb") as f:
        data = f.read()
    return _decode_bbl(data)


def _bbl_float(s: str) -> float:
    s = s.strip()
    if s.lower().startswith("0x"):
        return float(
            np.frombuffer(
                struct.pack("<I", int(s, 16)), dtype=np.float32
            )[0]
        )
    return float(s)


class _BblStream:
    """Byte cursor with the blackbox primitive decoders."""

    def __init__(self, buf: bytes, pos: int):
        self.buf = buf
        self.pos = pos

    def eof(self) -> bool:
        return self.pos >= len(self.buf)

    def byte(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def uvb(self) -> int:
        v, shift = 0, 0
        while True:
            b = self.byte()
            v |= (b & 0x7F) << shift
            if not (b & 0x80):
                return v
            shift += 7
            if shift > 42:
                raise ValueError("runaway uvb")

    def svb(self) -> int:
        v = self.uvb()
        return (v >> 1) ^ -(v & 1)  # zigzag


def _sx(v: int, bits: int) -> int:
    m = 1 << (bits - 1)
    return (v ^ m) - m


def _bbl_header_tables(data: bytes):
    """Parse `H name:value` lines; return (tables, scale, body_pos).
    tables[frame_char] = dict(names, predictors, encodings)."""
    tables: dict = {}
    scale = None
    pos = 0
    n = len(data)
    while pos < n and data[pos : pos + 2] == b"H ":
        eol = data.find(b"\n", pos)
        if eol < 0:
            eol = n
        line = data[pos + 2 : eol].decode("latin-1").rstrip("\r")
        pos = eol + 1
        if ":" not in line:
            continue
        name, val = line.split(":", 1)
        name = name.strip()
        if name.startswith("Field ") and len(name.split()) >= 3:
            _, fc, what = name.split(None, 2)
            t = tables.setdefault(
                fc, {"name": [], "predictor": [], "encoding": []}
            )
            if what in ("name",):
                t["name"] = [c.strip() for c in val.split(",")]
            elif what in ("predictor", "encoding"):
                t[what] = [int(c) for c in val.split(",")]
        elif name in ("gyro_scale", "gyro.scale"):
            scale = _bbl_float(val)
    return tables, scale, pos


def _decode_bbl(data: bytes) -> GyroData:
    tables, scale, pos = _bbl_header_tables(data)
    it = tables.get("I")
    if not it or not it["name"]:
        raise SyncPanic("no blackbox I-frame field table")
    names = it["name"]
    pt = tables.get("P") or {"name": names, "predictor": [], "encoding": []}
    st = tables.get("S")
    try:
        i_time = names.index("time")
        i_gyro = [names.index(f"gyroADC[{i}]") for i in range(3)]
    except ValueError:
        raise SyncPanic("blackbox log lacks time/gyroADC fields")

    nf = len(names)
    ip = (it["predictor"] + [0] * nf)[:nf]
    ie = (it["encoding"] + [1] * nf)[:nf]
    pp = (pt["predictor"] + [0] * nf)[:nf]
    pe = (pt["encoding"] + [0] * nf)[:nf]

    def decode_fields(s: _BblStream, enc: list[int], nf_: int) -> list[int]:
        """Decode one frame's raw (pre-predictor) values."""
        vals = [0] * nf_
        i = 0
        while i < nf_:
            e = enc[i]
            if e == 0:
                vals[i] = s.svb()
                i += 1
            elif e == 1:
                vals[i] = s.uvb()
                i += 1
            elif e == 3:
                vals[i] = -_sx(s.uvb() & 0x3FFF, 14)
                i += 1
            elif e == 6:  # TAG8_8SVB over the run of same-encoded fields
                j = i
                while j < nf_ and enc[j] == 6 and j - i < 8:
                    j += 1
                cnt = j - i
                if cnt == 1:
                    vals[i] = s.svb()
                else:
                    hdr = s.byte()
                    for k in range(cnt):
                        vals[i + k] = s.svb() if (hdr >> k) & 1 else 0
                i = j
            elif e == 7:  # TAG2_3S32: groups of 3
                lead = s.byte()
                tag = lead >> 6
                g = [0, 0, 0]
                if tag == 0:
                    g = [
                        _sx((lead >> 4) & 3, 2),
                        _sx((lead >> 2) & 3, 2),
                        _sx(lead & 3, 2),
                    ]
                elif tag == 1:
                    b = s.byte()
                    g = [_sx(lead & 0xF, 4), _sx(b >> 4, 4), _sx(b & 0xF, 4)]
                elif tag == 2:
                    g[0] = _sx(lead & 0x3F, 6)
                    g[1] = _sx(s.byte() & 0x3F, 6)
                    g[2] = _sx(s.byte() & 0x3F, 6)
                else:
                    for k in range(3):
                        sel = (lead >> (2 * k)) & 3
                        nb = sel + 1  # 1/2/3/4 bytes, little-endian
                        raw = 0
                        for bi in range(nb):
                            raw |= s.byte() << (8 * bi)
                        g[k] = _sx(raw, 8 * nb)
                for k in range(3):
                    if i + k < nf_:
                        vals[i + k] = g[k]
                i += 3
            elif e == 8:  # TAG8_4S16 v2: groups of 4, nibble-packed
                sel = s.byte()
                nib: list[int] = []

                def nibble() -> int:
                    if not nib:
                        b = s.byte()
                        nib.append(b & 0xF)
                        return b >> 4
                    return nib.pop()

                g4 = [0, 0, 0, 0]
                for k in range(4):
                    f = (sel >> (2 * k)) & 3
                    if f == 0:
                        g4[k] = 0
                    elif f == 1:
                        g4[k] = _sx(nibble(), 4)
                    elif f == 2:
                        g4[k] = _sx(
                            (nibble() << 4) | nibble(), 8
                        )
                    else:
                        hi = (nibble() << 4) | nibble()
                        lo = (nibble() << 4) | nibble()
                        g4[k] = _sx((hi << 8) | lo, 16)
                for k in range(4):
                    if i + k < nf_:
                        vals[i + k] = g4[k]
                i += 4
            elif e == 9:
                vals[i] = 0
                i += 1
            else:
                raise ValueError(f"unsupported blackbox encoding {e}")
        return vals

    s = _BblStream(data, pos)
    prev: list[int] | None = None
    prev2: list[int] | None = None
    rows: list[tuple[int, int, int, int]] = []

    if st and st["name"]:
        ns = len(st["name"])
        se = (st["encoding"] + [0] * ns)[:ns]
    else:
        ns, se = 0, []

    while not s.eof():
        try:
            fc = chr(s.byte())
            if fc == "I":
                raw = decode_fields(s, ie, nf)
                cur = [0] * nf
                for i in range(nf):
                    p = ip[i]
                    if p == 0:
                        cur[i] = raw[i]
                    elif p == 6:
                        cur[i] = raw[i]  # increment meaningless intra
                    else:
                        cur[i] = raw[i]  # I-frames are self-contained
                prev2 = prev = cur
            elif fc == "P":
                if prev is None:
                    break  # P before any I: unsynced stream
                raw = decode_fields(s, pe, nf)
                cur = [0] * nf
                for i in range(nf):
                    p = pp[i]
                    if p == 0:
                        base = 0
                    elif p == 1:
                        base = prev[i]
                    elif p == 2:
                        base = 2 * prev[i] - (prev2 or prev)[i]
                    elif p == 3:
                        base = (prev[i] + (prev2 or prev)[i]) // 2
                    elif p == 6:
                        base = prev[i] + 1
                    else:
                        # predictors outside the subset (minthrottle,
                        # motor[0], ...) only affect fields we never
                        # read; stream position stays exact either way
                        base = prev[i]
                    cur[i] = base + raw[i]
                prev2, prev = prev, cur
            elif fc == "S" and ns:
                decode_fields(s, se, ns)
                continue
            elif fc == "E":
                ev = s.byte()
                if ev == 255:
                    break  # end of log
                elif ev == 0:
                    s.uvb()  # sync beep time
                    continue
                elif ev == 30:
                    s.uvb()
                    s.uvb()  # logging resume: iteration, time
                    continue
                else:
                    break  # unknown event: stop at last good frame
            else:
                break  # unknown frame type / desync
        except (IndexError, ValueError):
            break  # truncated/corrupt tail: keep decoded prefix
        rows.append((prev[i_time], *(prev[i] for i in i_gyro)))

    if not rows:
        raise SyncPanic("no decodable blackbox frames")
    arr = np.asarray(rows, np.float64)
    if scale is not None:
        g = arr[:, 1:4] * (scale * 1e6)
    else:
        g = np.deg2rad(arr[:, 1:4] / 16.4)
    return GyroData(timestamps=arr[:, 0] * 1e-6, gyro=g)


def parse_blackbox_csv(path: str) -> GyroData:
    with open(path, "r") as f:
        header = None
        for line in f:
            if "gyroADC[0]" in line:
                header = [c.strip().strip('"') for c in line.split(",")]
                break
        if header is None:
            raise SyncPanic(f"no gyroADC columns in {path}")
        it = header.index("time")
        ig = [header.index(f"gyroADC[{i}]") for i in range(3)]
        rows = []
        need = max(it, *ig) + 1
        for line in f:
            parts = line.split(",")
            if len(parts) < need:
                continue
            try:
                rows.append(
                    [float(parts[it])] + [float(parts[i]) for i in ig]
                )
            except ValueError:
                continue
    if not rows:
        raise SyncPanic(f"no gyro rows in {path}")
    arr = np.asarray(rows, np.float64)
    return GyroData(
        timestamps=arr[:, 0] * 1e-6,  # us -> s
        gyro=np.deg2rad(arr[:, 1:4]),  # deg/s -> rad/s
    )


if __name__ == "__main__":
    # `python -m rssync_tpu_torch.frontend.telemetry --probe FILE`: the
    # first-contact diagnostic kit (frontend/probe.py) — dump what the
    # parser sees and where parsing stops on failure.
    from rssync_tpu_torch.frontend.probe import main as _probe_main

    raise SystemExit(_probe_main())
