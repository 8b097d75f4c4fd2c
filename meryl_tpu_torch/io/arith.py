"""Adaptive arithmetic coder (CRAM 3.1 block compression method 6).

Dependency-free decoder (and encoder, for the round-trip tests) for
the htscodecs "arith dynamic" format: an LZMA-style carry-counting
range coder driving adaptively-updated symbol-frequency models, with
order-0/order-1 contexts, integrated run-length coding, and the same
outer transforms as rANS-Nx16 (STRIPE / PACK / CAT / NOSZ) plus EXT
(bzip2 body).  The reference gets this via vendored htslib
(meryl src/main.mk:92-140).

Stream layout::

    flags:u8 [size:uint7] <transform metadata> <body>

flags: 0x01 ORDER1, 0x04 EXT (bzip2 body), 0x08 STRIPE, 0x10 NOSZ,
0x20 CAT, 0x40 RLE (integrated run-length models), 0x80 PACK.
Entropy-coded bodies open with one byte giving the max symbol value
(0 means 256) so the adaptive models can be sized.
"""

from __future__ import annotations

import bz2 as _bz2

from .rans_nx16 import NOSZ, PACK, RLE, STRIPE, RansError, _Cur, \
    _pack, _put_uint7, _unpack

ORDER1 = 0x01
EXT = 0x04
CAT = 0x20

_TOP = 1 << 24
_STEP = 8
_MAX_FREQ = (1 << 16) - 32


class ArithError(RansError):
    pass


# --------------------------------------------------------- range coder

class _RangeDecoder:
    """LZMA-style decoder: 32-bit range, code fed 5 bytes at start
    (the first is the encoder's initial zero cache byte)."""

    __slots__ = ("d", "p", "range", "code")

    def __init__(self, cur: _Cur):
        self.d = cur.d
        self.p = cur.p
        self.range = 0xFFFFFFFF
        code = 0
        for _ in range(5):
            code = ((code << 8) | self._byte()) & 0xFFFFFFFFFF
        self.code = code & 0xFFFFFFFF

    def _byte(self) -> int:
        # a truncated stream must fail as a codec error, not IndexError
        if self.p >= len(self.d):
            raise ArithError("arith: input exhausted")
        b = self.d[self.p]
        self.p += 1
        return b

    def get_freq(self, tot: int) -> int:
        self.range //= tot
        return self.code // self.range

    def decode(self, start: int, size: int) -> None:
        self.code -= start * self.range
        self.range *= size
        while self.range < _TOP:
            self.code = ((self.code << 8) | self._byte()) & 0xFFFFFFFF
            self.range = (self.range << 8) & 0xFFFFFFFF


class _RangeEncoder:
    __slots__ = ("low", "range", "cache", "cache_size", "out")

    def __init__(self):
        self.low = 0
        self.range = 0xFFFFFFFF
        self.cache = 0
        self.cache_size = 1
        self.out = bytearray()

    def _shift_low(self) -> None:
        if self.low < 0xFF000000 or self.low > 0xFFFFFFFF:
            carry = self.low >> 32
            self.out.append((self.cache + carry) & 0xFF)
            for _ in range(self.cache_size - 1):
                self.out.append((0xFF + carry) & 0xFF)
            self.cache_size = 0
            self.cache = (self.low >> 24) & 0xFF
        self.cache_size += 1
        self.low = (self.low << 8) & 0xFFFFFFFF

    def encode(self, start: int, size: int, tot: int) -> None:
        self.range //= tot
        self.low += start * self.range
        self.range *= size
        while self.range < _TOP:
            self._shift_low()
            self.range = (self.range << 8) & 0xFFFFFFFF

    def finish(self) -> bytes:
        for _ in range(5):
            self._shift_low()
        return bytes(self.out)


# ------------------------------------------------------ adaptive model

class _Model:
    """Frequencies start at 1, bump by 8 per use, halve when the total
    passes ~2^16; symbols bubble toward the front as they gain
    frequency so the linear scan stays short on skewed data.  Encoder
    and decoder perform IDENTICAL updates."""

    __slots__ = ("syms", "freqs", "tot")

    def __init__(self, nsym: int):
        self.syms = list(range(nsym))
        self.freqs = [1] * nsym
        self.tot = nsym

    def _bump(self, i: int) -> None:
        f = self.freqs
        f[i] += _STEP
        self.tot += _STEP
        if self.tot > _MAX_FREQ:
            t = 0
            for j in range(len(f)):
                f[j] -= f[j] >> 1
                t += f[j]
            self.tot = t
        if i > 0 and f[i] > f[i - 1]:
            s = self.syms
            f[i], f[i - 1] = f[i - 1], f[i]
            s[i], s[i - 1] = s[i - 1], s[i]

    def encode(self, rc: _RangeEncoder, sym: int) -> None:
        syms = self.syms
        acc = 0
        i = 0
        while syms[i] != sym:
            acc += self.freqs[i]
            i += 1
        rc.encode(acc, self.freqs[i], self.tot)
        self._bump(i)

    def decode(self, rc: _RangeDecoder) -> int:
        fr = rc.get_freq(self.tot)
        if fr >= self.tot:  # corrupt stream desynced the range coder
            raise ArithError("arith: frequency out of range")
        freqs = self.freqs
        acc = 0
        i = 0
        while acc + freqs[i] <= fr:
            acc += freqs[i]
            i += 1
        rc.decode(acc, freqs[i])
        sym = self.syms[i]
        self._bump(i)
        return sym


# ------------------------------------------------------------- bodies

def _native_body(cur: _Cur, out_sz: int, order1: bool, rle: bool):
    """Native entropy core (~100x the Python decoder), or None —
    callers fall back to the Python reference implementation, which
    also raises precise errors on malformed input."""
    try:
        from .. import native
        fast = native.arith_core(cur.d, cur.p, order1, rle, out_sz)
    except Exception:
        return None
    if fast is None:
        return None
    buf, cur.p = fast
    return buf


def _max_sym_byte(data: bytes) -> tuple:
    m = (max(data) + 1) if data else 1
    return (m if m < 256 else 0), (m if m else 256)


def _decode_o0(cur: _Cur, out_sz: int) -> bytes:
    m = cur.byte() or 256
    model = _Model(m)
    rc = _RangeDecoder(cur)
    out = bytearray(out_sz)
    for i in range(out_sz):
        out[i] = model.decode(rc)
    cur.p = rc.p
    return bytes(out)


def _encode_o0(data: bytes) -> bytes:
    mb, m = _max_sym_byte(data)
    model = _Model(m)
    rc = _RangeEncoder()
    for b in data:
        model.encode(rc, b)
    return bytes([mb]) + rc.finish()


def _decode_o1(cur: _Cur, out_sz: int) -> bytes:
    m = cur.byte() or 256
    models = [_Model(m) for _ in range(m)]
    rc = _RangeDecoder(cur)
    out = bytearray(out_sz)
    last = 0
    for i in range(out_sz):
        last = models[last].decode(rc)
        out[i] = last
    cur.p = rc.p
    return bytes(out)


def _encode_o1(data: bytes) -> bytes:
    mb, m = _max_sym_byte(data)
    models = [_Model(m) for _ in range(m)]
    rc = _RangeEncoder()
    last = 0
    for b in data:
        models[last].encode(rc, b)
        last = b
    return bytes([mb]) + rc.finish()


def _decode_rle(cur: _Cur, out_sz: int, order1: bool) -> bytes:
    """Runs coded per symbol with 4-symbol models, 0..2 extend, 3 =
    'at least 3 more follow'."""
    m = cur.byte() or 256
    if order1:
        models = [_Model(m) for _ in range(m)]
    else:
        model = _Model(m)
    run_models = [_Model(4) for _ in range(m)]
    rc = _RangeDecoder(cur)
    out = bytearray()
    last = 0
    while len(out) < out_sz:
        b = models[last].decode(rc) if order1 else model.decode(rc)
        rm = run_models[b]
        run = 0
        while True:
            part = rm.decode(rc)
            run += part
            if part != 3:
                break
        out += bytes([b]) * (run + 1)
        last = b
    if len(out) != out_sz:
        raise ArithError(f"RLE overrun {len(out)} != {out_sz}")
    cur.p = rc.p
    return bytes(out)


def _encode_rle(data: bytes, order1: bool) -> bytes:
    mb, m = _max_sym_byte(data)
    if order1:
        models = [_Model(m) for _ in range(m)]
    else:
        model = _Model(m)
    run_models = [_Model(4) for _ in range(m)]
    rc = _RangeEncoder()
    last = 0
    i = 0
    n = len(data)
    while i < n:
        b = data[i]
        (models[last] if order1 else model).encode(rc, b)
        j = i + 1
        while j < n and data[j] == b:
            j += 1
        r = j - i - 1
        rm = run_models[b]
        while True:
            part = min(3, r)
            rm.encode(rc, part)
            r -= part
            if part != 3:
                break
        last = b
        i = j
    return bytes([mb]) + rc.finish()


# -------------------------------------------------------------- public

def decode(data: bytes, out_hint: int | None = None) -> bytes:
    cur = _Cur(data)
    flags = cur.byte()
    if flags & STRIPE:
        if flags & NOSZ:
            if out_hint is None:
                raise ArithError("NOSZ stream needs an out-size hint")
            ulen = out_hint
        else:
            ulen = cur.uint7()
        n = cur.byte()
        clens = [cur.uint7() for _ in range(n)]
        out = bytearray(ulen)
        for j in range(n):
            sub_len = ulen // n + (1 if j < ulen % n else 0)
            out[j::n] = decode(cur.take(clens[j]), sub_len)
        return bytes(out)
    if flags & NOSZ:
        if out_hint is None:
            raise ArithError("NOSZ stream needs an out-size hint")
        out_sz = out_hint
    else:
        out_sz = cur.uint7()
    pack_out = pmap = None
    if flags & PACK:
        pack_out = out_sz
        nsym = cur.byte()
        pmap = cur.take(nsym)
        out_sz = cur.uint7()
    if flags & EXT:
        try:
            buf = _bz2.decompress(cur.d[cur.p:])
        except OSError as e:  # corrupt stream is a codec error
            raise ArithError(f"EXT bz2: {e}") from e
        if len(buf) != out_sz:
            raise ArithError(f"EXT body {len(buf)} != {out_sz}")
    elif flags & CAT:
        buf = cur.take(out_sz)
    elif out_sz == 0:
        buf = b""
    else:
        buf = _native_body(cur, out_sz, bool(flags & ORDER1),
                           bool(flags & RLE))
        if buf is None:
            if flags & RLE:
                buf = _decode_rle(cur, out_sz, bool(flags & ORDER1))
            elif flags & ORDER1:
                buf = _decode_o1(cur, out_sz)
            else:
                buf = _decode_o0(cur, out_sz)
    if flags & PACK:
        buf = _unpack(buf, pmap, pack_out)
    return buf


def encode(data: bytes, flags: int = 0, *, stripe_n: int = 4) -> bytes:
    out = bytearray([flags & 0xFF])
    if flags & STRIPE:
        if not (flags & NOSZ):
            out += _put_uint7(len(data))
        out.append(stripe_n)
        subs = [encode(data[j::stripe_n], (flags & ~STRIPE) | NOSZ)
                for j in range(stripe_n)]
        for s in subs:
            out += _put_uint7(len(s))
        for s in subs:
            out += s
        return bytes(out)
    if not (flags & NOSZ):
        out += _put_uint7(len(data))
    if flags & PACK:
        pmap = bytes(sorted(set(data)))
        if len(pmap) > 16:
            raise ArithError("pack needs <= 16 distinct symbols")
        packed = _pack(data, pmap)
        out.append(len(pmap))
        out += pmap
        out += _put_uint7(len(packed))
        data = packed
    if flags & EXT:
        out += _bz2.compress(data)
    elif flags & CAT:
        out += data
    elif len(data) == 0:
        pass
    elif flags & RLE:
        out += _encode_rle(data, bool(flags & ORDER1))
    elif flags & ORDER1:
        out += _encode_o1(data)
    else:
        out += _encode_o0(data)
    return bytes(out)
