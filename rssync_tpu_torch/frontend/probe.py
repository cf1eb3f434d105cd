"""First-contact diagnostics for telemetry files.

`python -m rssync_tpu_torch.frontend.probe --probe FILE` (or
`python -m rssync_tpu_torch.frontend.telemetry --probe FILE`) dumps what the
parser SEES — detected container format, ISO-BMFF box tree, track
candidates (hdlr/stsd), sample-table counts, the first GPMF sample's
KLV tree, rate estimate — and, when parsing fails, WHERE it stopped.
The parsers were validated on synthetic fixtures plus structure-aware
fuzzing only (this build environment has no real camera footage —
zero egress), so the first run against a real file must be debuggable
in the field rather than producing a silent empty result.

Reference surface being diagnosed: the upstream crate's auto-detection
(ref: rust/telemetry-parser-cpp/src/lib.rs:29-37), which this rebuild
mirrors in frontend/telemetry.load_gyro. A copy of
rssync_tpu/frontend/probe.py, except that the box dump prints each box's
true start from the header length the walk consumed (rssync_tpu re-derives
it from the payload size, which is wrong for a 64-bit largesize header
over a small payload).
"""

from __future__ import annotations

import os
import struct
import sys
import traceback

import numpy as np


def _w(out, line: str = "") -> None:
    out.write(line + "\n")


def _fourcc(b: bytes) -> str:
    return "".join(chr(c) if 32 <= c < 127 else f"\\x{c:02x}" for c in b)


_CONTAINER_BOXES = {
    b"moov", b"trak", b"mdia", b"minf", b"stbl", b"udta", b"edts",
    b"dinf", b"mvex", b"moof", b"traf",
}


def _dump_boxes(buf, start, end, out, depth=0, max_depth=6):
    """Recursive ISO-BMFF box tree (same walk as telemetry._iter_boxes,
    but reporting malformed headers instead of silently stopping)."""
    from rssync_tpu_torch.frontend.telemetry import _iter_boxes

    indent = "  " * depth
    any_box = False
    off = start
    for typ, ps, pe, hdr in _iter_boxes(buf, start, end):
        any_box = True
        _w(out, f"{indent}{_fourcc(typ)}  [{ps - hdr}..{pe})  payload {pe - ps} B")
        if typ in _CONTAINER_BOXES and depth < max_depth:
            _dump_boxes(buf, ps, pe, out, depth + 1, max_depth)
        off = pe
    if off < end and depth == 0:
        # the walk stopped early: report the offending header bytes
        rem = end - off
        head = bytes(buf[off : min(off + 16, end)])
        _w(out, f"{indent}!! box walk stopped at offset {off} "
                f"({rem} bytes unparsed); next bytes: {head.hex()}")
    if not any_box:
        _w(out, f"{indent}(no boxes parsed in [{start}, {end}))")


def _dump_klv(buf, start, end, out, depth=0, max_depth=8):
    """GPMF KLV tree with type/size/repeat per field."""
    indent = "  " * depth
    if depth > max_depth:
        _w(out, indent + "...")
        return
    off = start
    while off + 8 <= end:
        key = bytes(buf[off : off + 4])
        typ = buf[off + 4]
        ssize = buf[off + 5]
        repeat = struct.unpack_from(">H", buf, off + 6)[0]
        dlen = ssize * repeat
        dstart = off + 8
        if dstart + dlen > end:
            _w(out, f"{indent}!! KLV field {_fourcc(key)} overruns its "
                    f"container at offset {off} (declared {dlen} B, "
                    f"{end - dstart} available)")
            return
        tch = chr(typ) if 32 <= typ < 127 else f"0x{typ:02x}"
        _w(out, f"{indent}{_fourcc(key)} type={tch} ssize={ssize} "
                f"repeat={repeat}")
        if typ == 0:
            _dump_klv(buf, dstart, dstart + dlen, out, depth + 1, max_depth)
        off = dstart + ((dlen + 3) & ~3)
    if off < end and end - off >= 8:
        _w(out, f"{indent}!! KLV walk stopped at offset {off} "
                f"({end - off} bytes left)")


def _probe_mp4(path: str, out) -> None:
    from rssync_tpu_torch.frontend import telemetry as T

    mm, buf = T._mp4_open(path)
    try:
        _w(out, "## box tree")
        _dump_boxes(buf, 0, len(mm), out)
        _w(out)
        _w(out, "## track candidates")
        traks = T._find_box(buf, 0, len(mm), [b"moov", b"trak"])
        if not traks:
            _w(out, "no moov/trak boxes found — not a parseable MP4 "
                    "(fragmented/moof-only files are not supported)")
            return
        for i, (ts_, te_) in enumerate(traks):
            hdl = T._find_box(buf, ts_, te_, [b"mdia", b"hdlr"])
            hdlr = bytes(buf[hdl[0][0] : hdl[0][1]]) if hdl else b""
            stsd = T._find_box(
                buf, ts_, te_, [b"mdia", b"minf", b"stbl", b"stsd"]
            )
            sd = bytes(buf[stsd[0][0] : min(stsd[0][0] + 64, stsd[0][1])]) if stsd else b""
            kind = "?"
            if b"gpmd" in hdlr or b"GoPro MET" in hdlr or b"gpmd" in sd:
                kind = "GPMF (GoPro metadata)"
            elif b"camm" in hdlr or b"camm" in sd:
                kind = "CAMM (camera motion)"
            elif b"vide" in hdlr:
                kind = "video"
            elif b"soun" in hdlr:
                kind = "audio"
            handler = hdlr[16:20] if len(hdlr) >= 20 else b""
            _w(out, f"trak[{i}]: handler={_fourcc(handler)} kind={kind}")
            try:
                offs, sizes, starts, durs = T._track_samples(buf, ts_, te_)
                dur = float(starts[-1] + durs[-1]) if len(durs) else 0.0
                _w(out, f"  samples={len(sizes)} bytes={int(sizes.sum())} "
                        f"duration={dur:.3f}s")
            except Exception as e:  # noqa: BLE001 — diagnostics must survive
                _w(out, f"  !! sample-table expansion failed: {e!r}")
                continue
            if kind.startswith("GPMF") and len(sizes):
                _w(out, "  first sample KLV tree:")
                _dump_klv(
                    buf, int(offs[0]), int(offs[0] + sizes[0]), out, depth=2
                )
    finally:
        buf.release()
        mm.close()


def _probe_text(path: str, out, n_lines: int = 8) -> None:
    with open(path, "rb") as f:
        head = f.read(8192)
    _w(out, f"## first {n_lines} lines")
    for line in head.decode("utf-8", "replace").splitlines()[:n_lines]:
        _w(out, "  " + line[:160])


def _sniff(path: str) -> str:
    """Mirror load_gyro's dispatch decision (telemetry.load_gyro)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".gcsv":
        return "gcsv"
    if ext in (".json", ".gyroflow"):
        return "gyroflow-json"
    if ext in (".mp4", ".mov", ".360"):
        return "mp4"
    if ext in (".bbl", ".bfl"):
        return "blackbox-bbl"
    if ext == ".csv":
        with open(path, "r", errors="replace") as f:
            head = f.read(4096)
        return "blackbox-csv" if "gyroADC[0]" in head else "plain-csv"
    with open(path, "rb") as f:
        head = f.read(64)
    if len(head) >= 8 and head[4:8] in (b"ftyp", b"moov", b"mdat"):
        return "mp4"
    if head.startswith(b"H Product:Blackbox"):
        return "blackbox-bbl"
    if head.lstrip()[:1] in (b"{", b"["):
        return "gyroflow-json"
    return "gcsv"


def probe_file(path: str, orient: str | None = None, out=None) -> bool:
    """Dump everything the telemetry parser can see about `path`.
    Returns True when the full parse succeeded."""
    from rssync_tpu_torch.frontend import telemetry as T

    out = out if out is not None else sys.stdout
    st = os.stat(path)
    _w(out, f"# telemetry probe: {path}")
    _w(out, f"size: {st.st_size} B")
    fmt = _sniff(path)
    _w(out, f"detected format (extension/content sniff): {fmt}")
    _w(out)
    try:
        if fmt == "mp4":
            _probe_mp4(path, out)
        else:
            _probe_text(path, out)
    except Exception as e:  # noqa: BLE001 — structure dump is best-effort
        _w(out, f"!! structure dump failed: {e!r}")
    _w(out)

    _w(out, "## full parse (Python implementation)")
    try:
        data = T.load_gyro(path, orient, prefer_native=False)
    except Exception as e:  # noqa: BLE001 — this is the diagnostic target
        _w(out, f"PARSE FAILED: {e!r}")
        tb = traceback.extract_tb(e.__traceback__)
        for fr in tb[-3:]:
            _w(out, f"  at {fr.filename}:{fr.lineno} in {fr.name}: {fr.line}")
        return False
    n = data.samples
    _w(out, f"samples: {n}")
    if n >= 2:
        span = float(data.timestamps[-1] - data.timestamps[0])
        rate = (n - 1) / span if span > 0 else float("nan")
        mono = bool(np.all(np.diff(data.timestamps) > 0))
        _w(out, f"time span: {data.timestamps[0]:.6f} .. "
                f"{data.timestamps[-1]:.6f} s ({span:.3f} s)")
        _w(out, f"mean rate: {rate:.2f} Hz "
                f"(engine rounds to {round(rate / 50) * 50} Hz)")
        _w(out, f"timestamps strictly increasing: {mono}"
                + ("" if mono else "  !! engine intake will panic"))
        rms = np.sqrt(np.mean(np.square(data.gyro), axis=0))
        _w(out, f"gyro RMS rad/s per axis: "
                f"[{rms[0]:.4f}, {rms[1]:.4f}, {rms[2]:.4f}]")
        finite = bool(np.isfinite(data.gyro).all()
                      and np.isfinite(data.timestamps).all())
        _w(out, f"all values finite: {finite}"
                + ("" if finite else "  !! engine intake will panic"))
    # cross-check the native parser when it is built
    try:
        native = T._native_load(path, orient)
    except Exception as e:  # noqa: BLE001
        _w(out, f"native parser raised: {e!r}")
        native = None
    if native is not None:
        agree = (native.samples == n
                 and np.allclose(native.timestamps, data.timestamps)
                 and np.allclose(native.gyro, data.gyro))
        _w(out, f"native parser: {native.samples} samples, "
                f"{'MATCHES python' if agree else '!! DISAGREES with python'}")
    else:
        _w(out, "native parser: not built or returned nothing "
                "(python path is authoritative)")
    return True


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m rssync_tpu_torch.frontend.probe",
        description="Telemetry file diagnostics (first-contact kit).",
    )
    ap.add_argument("--probe", metavar="FILE", required=True,
                    help="dump container structure, track candidates, "
                         "KLV tree, sample counts, and rate estimate; "
                         "on failure, report where parsing stopped")
    ap.add_argument("--orient", default=None,
                    help="orientation string to apply (e.g. yZX)")
    args = ap.parse_args(argv)
    ok = probe_file(args.probe, args.orient)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
