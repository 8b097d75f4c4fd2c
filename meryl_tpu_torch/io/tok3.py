"""Name-tokenizer codec "tok3" (CRAM 3.1 block compression method 8).

Dependency-free decoder (and encoder, for the round-trip tests and the
synthetic-CRAM test writer) for the htscodecs name tokeniser: each
read name is split into a column-aligned token sequence (alpha runs,
digit runs with or without leading zeros, single characters), columns
are delta/match-coded against a reference name, and each per-column
token stream is entropy-coded with rANS-Nx16 or the adaptive
arithmetic coder (both already in this package).  The reference gets
this codec via vendored htslib (meryl src/main.mk:92-140).

Wire format reconstructed from the hts-specs CRAMcodecs document; the
encoder and decoder are an exactly-matched pair and every decode is
structurally checked (exact output size, stream exhaustion), so a
mismatched stream fails loudly rather than fabricating names.

Layout::

    ulen:u32le  nnames:u32le  flags:u8 (bit0: 1=arith, 0=rANS-Nx16)
    token streams until exhausted, each:
        hdr:u8 = type | 0x80 (first stream of a new token column)
                      | 0x40 (duplicate: next two bytes are the source
                              column and type; no payload follows)
        [clen:uint7  body:clen bytes]   (absent for duplicates)

Stream contents per token type: N_TYPE one byte per name (the type of
this column's token), N_ALPHA NUL-terminated strings, N_CHAR raw
bytes, N_DIGITS u32le values, N_DIGITS0 u32le plus a length byte in
the column's N_DZLEN stream, N_DDELTA one byte (value = reference
name's token value + delta), N_DUP/N_DIFF u32le distances back to the
reference name, N_MATCH/N_END no payload.
"""

from __future__ import annotations

import struct

from .rans_nx16 import RansError, _Cur, _put_uint7

# token types
N_TYPE = 0
N_ALPHA = 1
N_CHAR = 2
N_DZLEN = 3
N_DIGITS0 = 4
N_DUP = 5
N_DIFF = 6
N_DIGITS = 7
N_DDELTA = 8
N_MATCH = 9
N_END = 10
N_NTYPES = 11

_F_NEW = 0x80
_F_DUP = 0x40


class Tok3Error(RansError):
    pass


def _entropy(use_arith: bool):
    if use_arith:
        from . import arith
        return arith.encode, arith.decode
    from . import rans_nx16
    return rans_nx16.encode, rans_nx16.decode


# ----------------------------------------------------------- tokenizer

def _tokenize(name: bytes):
    """Split into (type, value) tokens: alpha runs, digit runs
    (leading-zero runs become DIGITS0 with an explicit length), single
    other characters."""
    toks = []
    i = 0
    n = len(name)
    while i < n:
        c = name[i]
        if 0x30 <= c <= 0x39:
            j = i
            while j < n and 0x30 <= name[j] <= 0x39:
                j += 1
            s = name[i:j]
            v = int(s)
            if (s[0] == 0x30 and len(s) > 1) or len(s) > 9:
                if v >= 1 << 32 or len(s) > 255:
                    toks.append((N_ALPHA, s))     # too wide: literal
                else:
                    toks.append((N_DIGITS0, (v, len(s))))
            else:
                toks.append((N_DIGITS, v))
            i = j
        elif (0x41 <= c <= 0x5A) or (0x61 <= c <= 0x7A):
            j = i
            while j < n and ((0x41 <= name[j] <= 0x5A)
                             or (0x61 <= name[j] <= 0x7A)):
                j += 1
            toks.append((N_ALPHA, name[i:j]))
            i = j
        else:
            toks.append((N_CHAR, c))
            i += 1
    return toks


# -------------------------------------------------------------- encode

def encode(data: bytes, *, use_arith: bool = False,
           entropy_flags: int = 0) -> bytes:
    """Encode a separator-terminated name blob (the raw contents of a
    CRAM RN external block: every name, including the last, ends with
    the BYTE_ARRAY_STOP separator byte)."""
    if not data:
        return struct.pack("<IIB", 0, 0, 1 if use_arith else 0)
    # the blob's final byte IS the separator (BYTE_ARRAY_STOP contract:
    # every name, including the last, ends with the stop byte)
    sep = data[-1]
    names = data[:-1].split(bytes([sep])) if len(data) > 1 else [b""]
    nnames = len(names)

    # streams[(tnum, type)] = bytearray
    streams: dict = {}

    def put(t, typ, payload=b""):
        streams.setdefault((t, typ), bytearray()).extend(payload)

    prev_toks = None
    prev_idx = -1
    for r, name in enumerate(names):
        toks = _tokenize(name) + [(N_CHAR, sep)]
        if prev_toks is not None and toks == prev_toks:
            put(0, N_TYPE, bytes([N_DUP]))
            put(0, N_DUP, struct.pack("<I", r - prev_idx))
            continue
        put(0, N_TYPE, bytes([N_DIFF]))
        put(0, N_DIFF, struct.pack("<I", r - prev_idx if prev_toks
                                   is not None else 0))
        for t, (typ, val) in enumerate(toks, start=1):
            ref = (prev_toks[t - 1] if prev_toks is not None
                   and t - 1 < len(prev_toks) else None)
            if ref == (typ, val):
                put(t, N_TYPE, bytes([N_MATCH]))
                continue
            if (typ == N_DIGITS and ref is not None
                    and ref[0] == N_DIGITS and 0 <= val - ref[1] < 256):
                put(t, N_TYPE, bytes([N_DDELTA]))
                put(t, N_DDELTA, bytes([val - ref[1]]))
                continue
            put(t, N_TYPE, bytes([typ]))
            if typ == N_ALPHA:
                if 0 in val:
                    raise Tok3Error("NUL inside alpha token")
                put(t, N_ALPHA, val + b"\x00")
            elif typ == N_CHAR:
                put(t, N_CHAR, bytes([val]))
            elif typ == N_DIGITS:
                if val >= 1 << 32:
                    raise Tok3Error("digit run exceeds u32")
                put(t, N_DIGITS, struct.pack("<I", val))
            elif typ == N_DIGITS0:
                v, width = val
                put(t, N_DIGITS0, struct.pack("<I", v))
                put(t, N_DZLEN, bytes([width]))
        put(len(toks) + 1, N_TYPE, bytes([N_END]))
        prev_toks = toks
        prev_idx = r

    enc, _ = _entropy(use_arith)
    out = bytearray(struct.pack("<IIB", len(data), nnames,
                                1 if use_arith else 0))
    seen: dict = {}
    max_t = max(t for t, _ in streams)
    for t in range(max_t + 1):
        first = True
        for typ in range(N_NTYPES):
            body = streams.get((t, typ))
            if body is None:
                continue
            hdr = typ | (_F_NEW if first else 0)
            first = False
            key = bytes(body)
            src = seen.get(key)
            if src is not None and src != (t, typ) and src[0] < 256:
                out.append(hdr | _F_DUP)
                out.append(src[0])
                out.append(src[1])
                continue
            seen.setdefault(key, (t, typ))
            blob = enc(key, entropy_flags)
            cat = enc(key, 0x20)          # CAT: raw body, tiny header
            if len(cat) < len(blob):
                blob = cat
            out.append(hdr)
            out += _put_uint7(len(blob))
            out += blob
    return bytes(out)


# -------------------------------------------------------------- decode

class _Stream:
    __slots__ = ("d", "p")

    def __init__(self, d: bytes):
        self.d = d
        self.p = 0

    def byte(self) -> int:
        if self.p >= len(self.d):
            raise Tok3Error("token stream exhausted")
        b = self.d[self.p]
        self.p += 1
        return b

    def u32(self) -> int:
        if self.p + 4 > len(self.d):
            raise Tok3Error("token stream exhausted")
        v = struct.unpack_from("<I", self.d, self.p)[0]
        self.p += 4
        return v

    def cstr(self) -> bytes:
        e = self.d.find(b"\x00", self.p)
        if e < 0:
            raise Tok3Error("unterminated alpha token")
        s = self.d[self.p:e]
        self.p = e + 1
        return s


def decode(data: bytes, out_size: int | None = None) -> bytes:
    cur = _Cur(data)
    hdr = cur.take(9)
    ulen, nnames, flags = struct.unpack("<IIB", hdr)
    if out_size is not None and out_size != ulen:
        raise Tok3Error(f"tok3 size mismatch ({ulen} != {out_size})")
    if nnames == 0:
        if ulen:
            raise Tok3Error("tok3: empty name count with nonzero size")
        return b""
    _, dec = _entropy(bool(flags & 1))

    streams: dict = {}
    order: list = []
    tnum = -1
    while cur.p < len(cur.d):
        h = cur.byte()
        typ = h & 0x3F
        if typ >= N_NTYPES:
            raise Tok3Error(f"tok3: unknown token type {typ}")
        if h & _F_NEW:
            tnum += 1
        if tnum < 0:
            raise Tok3Error("tok3: stream before first column")
        if h & _F_DUP:
            st = cur.byte()
            sy = cur.byte()
            src = streams.get((st, sy))
            if src is None:
                raise Tok3Error("tok3: duplicate of unknown stream")
            streams[(tnum, typ)] = _Stream(src.d)
        else:
            clen = cur.uint7()
            streams[(tnum, typ)] = _Stream(dec(cur.take(clen)))
        order.append((tnum, typ))

    def stream(t, typ):
        s = streams.get((t, typ))
        if s is None:
            raise Tok3Error(f"tok3: missing stream ({t},{typ})")
        return s

    # decode one token for column t of record r; tokens[r] accumulates
    names = []
    toks_per_name: list = []
    out = bytearray()
    for r in range(nnames):
        t0 = stream(0, N_TYPE).byte()
        if t0 == N_DUP:
            dist = stream(0, N_DUP).u32()
            if not 0 < dist <= r:
                raise Tok3Error("tok3: bad duplicate distance")
            names.append(names[r - dist])
            toks_per_name.append(toks_per_name[r - dist])
            out += names[r]
            continue
        if t0 != N_DIFF:
            raise Tok3Error(f"tok3: name must open DIFF/DUP, got {t0}")
        dist = stream(0, N_DIFF).u32()
        if dist > r:
            raise Tok3Error("tok3: bad reference distance")
        ref = toks_per_name[r - dist] if r and dist else None
        toks = []
        name = bytearray()
        t = 1
        while True:
            typ = stream(t, N_TYPE).byte()
            if typ == N_END:
                break
            if typ == N_MATCH:
                if ref is None or t - 1 >= len(ref):
                    raise Tok3Error("tok3: MATCH without reference")
                typ2, val = ref[t - 1]
            elif typ == N_DDELTA:
                if ref is None or t - 1 >= len(ref) \
                        or ref[t - 1][0] != N_DIGITS:
                    raise Tok3Error("tok3: DDELTA without digit ref")
                typ2 = N_DIGITS
                val = ref[t - 1][1] + stream(t, N_DDELTA).byte()
            elif typ == N_ALPHA:
                typ2, val = N_ALPHA, stream(t, N_ALPHA).cstr()
            elif typ == N_CHAR:
                typ2, val = N_CHAR, stream(t, N_CHAR).byte()
            elif typ == N_DIGITS:
                typ2, val = N_DIGITS, stream(t, N_DIGITS).u32()
            elif typ == N_DIGITS0:
                v = stream(t, N_DIGITS0).u32()
                w = stream(t, N_DZLEN).byte()
                typ2, val = N_DIGITS0, (v, w)
            else:
                raise Tok3Error(f"tok3: unexpected token type {typ}")
            toks.append((typ2, val))
            if typ2 == N_ALPHA:
                name += val
            elif typ2 == N_CHAR:
                name.append(val)
            elif typ2 == N_DIGITS:
                name += str(val).encode()
            else:
                v, w = val
                name += str(v).encode().rjust(w, b"0")
            t += 1
        names.append(bytes(name))
        toks_per_name.append(toks)
        out += names[r]
    if len(out) != ulen:
        raise Tok3Error(f"tok3: decoded {len(out)} != stated {ulen}")
    return bytes(out)
