"""Minimal RData (RDX2) reader/writer for sweep-ledger data.frames — the
port's copy of ``lightgbm_tpu/utils/rdata.py`` (gzip/struct only).

The R workflow checkpoints its 108x9 ``paramGrid`` data.frame with
``save(paramGrid, file = "paramGrid.RData")`` every iteration and resumes
with ``load(...)`` (r/gridsearchCV.R:118,121).  This module implements just
enough of R's XDR serialization (format "RDX2", version 2) to round-trip
that artifact, so a sweep reads and writes R's on-disk checkpoint format
directly; for the same columns its bytes equal the reference package's.

Supported SEXPs: LISTSXP pairlists (the save() wrapper), SYMSXP, VECSXP
(data.frame), REALSXP, INTSXP, LGLSXP, STRSXP/CHARSXP, NILSXP, and REFSXP
for re-referenced symbols.  No R source was consulted or copied — the layout
follows R's public serialization spec ("R Internals", section on
serialization formats).
"""

from __future__ import annotations

import gzip
import struct
from typing import Dict, List, Optional, Tuple, Union

# SEXP type codes (R Internals)
NILSXP = 0
SYMSXP = 1
LISTSXP = 2
LGLSXP = 10
INTSXP = 13
REALSXP = 14
STRSXP = 16
VECSXP = 19
CHARSXP = 9
NILVALUE = 254
REFSXP = 255

HAS_ATTR = 1 << 9
HAS_TAG = 1 << 10

NA_INT = -0x80000000
UTF8_LEVEL = 1 << 3


class _Reader:
    def __init__(self, data: bytes):
        self.b = data
        self.pos = 0
        self.refs: List = []

    def _take(self, n: int) -> bytes:
        out = self.b[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated RData stream")
        self.pos += n
        return out

    def i4(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def f8(self) -> float:
        return struct.unpack(">d", self._take(8))[0]

    def read_item(self):
        flags = self.i4()
        typ = flags & 0xFF
        if typ == REFSXP:
            idx = flags >> 8
            if idx == 0:
                idx = self.i4()
            return self.refs[idx - 1]
        if typ in (NILSXP, NILVALUE):
            return None
        if typ == SYMSXP:
            name = self.read_item()
            self.refs.append(("symbol", name))
            return ("symbol", name)
        if typ == CHARSXP:
            n = self.i4()
            if n == -1:
                return None
            return self._take(n).decode("utf-8", "replace")
        if typ == LISTSXP:
            attr = self.read_item() if flags & HAS_ATTR else None
            tag = self.read_item() if flags & HAS_TAG else None
            car = self.read_item()
            cdr = self.read_item()
            return ("pairlist", tag, car, cdr, attr)
        if typ == LGLSXP or typ == INTSXP:
            n = self.i4()
            vals = [self.i4() for _ in range(n)]
            vals = [None if v == NA_INT else v for v in vals]
            return self._with_attrs(vals, flags)
        if typ == REALSXP:
            n = self.i4()
            vals = [self.f8() for _ in range(n)]
            return self._with_attrs(vals, flags)
        if typ == STRSXP:
            n = self.i4()
            vals = [self.read_item() for _ in range(n)]
            return self._with_attrs(vals, flags)
        if typ == VECSXP:
            n = self.i4()
            vals = [self.read_item() for _ in range(n)]
            return self._with_attrs(vals, flags)
        raise ValueError(f"unsupported SEXP type {typ}")

    def _with_attrs(self, vals, flags):
        if flags & HAS_ATTR:
            attrs = self.read_item()
            return ("attributed", vals, _pairlist_to_dict(attrs))
        return vals


def _pairlist_to_dict(pl) -> Dict[str, object]:
    out: Dict[str, object] = {}
    while pl is not None:
        kind, tag, car, cdr, _ = pl
        assert kind == "pairlist"
        if tag is not None and tag[0] == "symbol":
            out[tag[1]] = car
        pl = cdr
    return out


def _strip(v):
    return v[1] if isinstance(v, tuple) and v[0] == "attributed" else v


def read_rdata(path: str) -> Dict[str, Dict[str, list]]:
    """Read an .RData file -> {object_name: {column: values}} for each saved
    data.frame (other object types are returned raw)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    if not raw.startswith(b"RDX2\n"):
        raise ValueError("not an RDX2 RData file")
    body = raw[5:]
    if not body.startswith(b"X\n"):
        raise ValueError("only XDR (binary) RData is supported")
    r = _Reader(body[2:])
    r.i4()  # serialization version
    r.i4()  # writer R version
    r.i4()  # min reader R version
    top = r.read_item()
    out: Dict[str, Dict[str, list]] = {}
    while top is not None:
        kind, tag, car, cdr, _ = top
        name = tag[1] if tag else f"obj{len(out)}"
        out[name] = _decode_dataframe(car)
        top = cdr
    return out


def _decode_dataframe(obj):
    if not (isinstance(obj, tuple) and obj[0] == "attributed"):
        return obj
    _, cols, attrs = obj
    names = _strip(attrs.get("names"))
    cls = _strip(attrs.get("class"))
    if cls and "data.frame" in cls and names:
        return {n: _strip(c) for n, c in zip(names, cols)}
    return obj


class _Writer:
    def __init__(self):
        self.out = bytearray()
        self.sym_refs: Dict[str, int] = {}

    def i4(self, v: int) -> None:
        self.out += struct.pack(">i", v)

    def f8(self, v: float) -> None:
        self.out += struct.pack(">d", v)

    def charsxp(self, s: str) -> None:
        b = s.encode("utf-8")
        self.i4(CHARSXP | (UTF8_LEVEL << 12))
        self.i4(len(b))
        self.out += b

    def symbol(self, name: str) -> None:
        if name in self.sym_refs:
            self.i4(REFSXP | (self.sym_refs[name] << 8))
            return
        self.i4(SYMSXP)
        self.charsxp(name)
        self.sym_refs[name] = len(self.sym_refs) + 1

    def strsxp(self, vals: List[Optional[str]]) -> None:
        self.i4(STRSXP)
        self.i4(len(vals))
        for s in vals:
            if s is None:
                self.i4(CHARSXP | (UTF8_LEVEL << 12))
                self.i4(-1)
            else:
                self.charsxp(s)

    def intsxp(self, vals: List[Optional[int]]) -> None:
        self.i4(INTSXP)
        self.i4(len(vals))
        for v in vals:
            self.i4(NA_INT if v is None else int(v))

    def realsxp(self, vals: List[float]) -> None:
        self.i4(REALSXP)
        self.i4(len(vals))
        for v in vals:
            self.f8(float(v))

    def column(self, vals: list) -> None:
        if all(v is None or isinstance(v, (int, bool)) for v in vals):
            self.intsxp(vals)
        elif any(isinstance(v, str) for v in vals):
            self.strsxp(vals)
        else:
            self.realsxp([float("nan") if v is None else v for v in vals])


def write_rdata(path: str, name: str, columns: Dict[str, list]) -> None:
    """Write {column: values} as a named data.frame into an .RData file
    byte-compatible with R's load()."""
    ncol = len(columns)
    nrow = len(next(iter(columns.values()))) if ncol else 0
    w = _Writer()
    # pairlist entry: tag = symbol(name), car = data.frame, cdr = NILVALUE
    w.i4(LISTSXP | HAS_TAG)
    w.symbol(name)
    # data.frame: VECSXP with attributes (names, row.names, class)
    w.i4(VECSXP | HAS_ATTR)
    w.i4(ncol)
    for vals in columns.values():
        w.column(list(vals))
    # attribute pairlist
    w.i4(LISTSXP | HAS_TAG)
    w.symbol("names")
    w.strsxp(list(columns.keys()))
    w.i4(LISTSXP | HAS_TAG)
    w.symbol("row.names")
    w.intsxp([None, -nrow])  # compact row.names: c(NA, -n)
    w.i4(LISTSXP | HAS_TAG)
    w.symbol("class")
    w.strsxp(["data.frame"])
    w.i4(NILVALUE)
    w.i4(NILVALUE)  # end of top-level pairlist

    header = bytearray(b"RDX2\nX\n")
    hw = _Writer()
    hw.i4(2)          # serialization format version
    hw.i4(0x030401)   # writer R version (3.4.1, the reference's kernel)
    hw.i4(0x020300)   # min reader version (2.3.0)
    payload = bytes(header) + bytes(hw.out) + bytes(w.out)
    # mtime pinned to 0 and FNAME suppressed so the gzip wrapper is
    # byte-deterministic regardless of the (tmp) filename it was written
    # under: the sweep's kill/resume parity compares RData ledgers as
    # FILES
    with open(path, "wb") as raw:
        with gzip.GzipFile(filename="", fileobj=raw, mode="wb",
                           mtime=0) as f:
            f.write(payload)
