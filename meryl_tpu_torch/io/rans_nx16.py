"""rANS-Nx16 codec (CRAM 3.1 block compression method 5).

Dependency-free decoder (and encoder, used by the round-trip tests)
for the htscodecs "rANS Nx16" format: order-0 and order-1 entropy
coding with 4- or 32-way interleaved 16-bit-renormalised rANS states,
plus the meta transforms — STRIPE, PACK, RLE and CAT — per the
hts-specs CRAMcodecs document.  Mirrors the capability htslib gets
from htscodecs (the reference vendors htslib via
meryl src/main.mk:92-140).

Layout of a stream::

    flags:u8 [size:uint7] <transform metadata> <entropy-coded body>

flags bits: 0x01 ORDER1, 0x04 N=32 (else 4), 0x08 STRIPE, 0x10 NOSZ
(no size field; caller supplies), 0x20 CAT (raw body), 0x40 RLE,
0x80 PACK.  uint7 = big-endian base-128 varint (0x80 = continuation).
"""

from __future__ import annotations

ORDER1 = 0x01
X32 = 0x04
STRIPE = 0x08
NOSZ = 0x10
CAT = 0x20
RLE = 0x40
PACK = 0x80

_L = 1 << 15        # lower renormalisation bound of each rANS state
_TF_SHIFT = 12      # order-0 frequency precision (4096)


class RansError(ValueError):
    pass


class _Cur:
    __slots__ = ("d", "p")

    def __init__(self, d: bytes):
        self.d = d
        self.p = 0

    def byte(self) -> int:
        if self.p >= len(self.d):
            raise RansError("truncated rANS-Nx16 stream")
        b = self.d[self.p]
        self.p += 1
        return b

    def take(self, n: int) -> bytes:
        b = self.d[self.p:self.p + n]
        if len(b) != n:
            raise RansError("truncated rANS-Nx16 stream")
        self.p += n
        return b

    def uint7(self) -> int:
        v = 0
        while True:
            b = self.byte()
            v = (v << 7) | (b & 0x7F)
            if not (b & 0x80):
                return v


def _put_uint7(v: int) -> bytes:
    out = [v & 0x7F]
    v >>= 7
    while v:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    return bytes(reversed(out))


# ------------------------------------------------------------ alphabet

def _read_alphabet(cur: _Cur):
    """Symbols present, ascending; runs of consecutive symbols are
    RLE'd (an explicit symbol equal to prev+1 is followed by a count
    of further consecutive symbols); a 0 byte terminates."""
    syms = []
    rle = 0
    sym = cur.byte()
    last = sym
    while True:
        if len(syms) >= 256:
            raise RansError("corrupt alphabet (unterminated)")
        syms.append(sym)
        if rle:
            rle -= 1
            sym += 1
        else:
            sym = cur.byte()
            if sym == last + 1:
                rle = cur.byte()
        last = sym
        if sym == 0:
            return syms


def _write_alphabet(syms) -> bytes:
    out = bytearray()
    i = 0
    n = len(syms)
    while i < n:
        out.append(syms[i])
        j = i + 1
        while j < n and syms[j] == syms[j - 1] + 1:
            j += 1
        if j > i + 1:                    # consecutive run
            out.append(syms[i] + 1)      # explicit prev+1 ...
            out.append(j - i - 2)        # ... then count of the rest
        i = j
    out.append(0)
    return bytes(out)


def _norm_to(freqs: dict, total: int) -> dict:
    """Scale positive counts to sum EXACTLY total (every symbol >=1)."""
    t = sum(freqs.values())
    out = {}
    for s, f in freqs.items():
        out[s] = max(1, (f * total) // t)
    # fix rounding drift on the largest symbol
    drift = total - sum(out.values())
    big = max(out, key=lambda s: out[s])
    out[big] += drift
    if out[big] < 1:
        raise RansError("cannot normalise frequencies")
    return out


# ----------------------------------------------------------- order-0

def _read_freqs0(cur: _Cur):
    syms = _read_alphabet(cur)
    F = [0] * 256
    t = 0
    for s in syms:
        F[s] = cur.uint7()
        t += F[s]
    # stored sum is 4096 >> k: double back up to 4096
    if t not in (0, 1 << _TF_SHIFT):
        while t < (1 << _TF_SHIFT):
            t <<= 1
            for s in syms:
                F[s] <<= 1
        if t != 1 << _TF_SHIFT:
            raise RansError("order-0 frequencies do not sum to 4096")
    C = [0] * 257
    for i in range(256):
        C[i + 1] = C[i] + F[i]
    ssym = bytearray(1 << _TF_SHIFT)
    for s in syms:
        ssym[C[s]:C[s] + F[s]] = bytes([s]) * F[s]
    return F, C, ssym


def _decode_o0(cur: _Cur, out_sz: int, N: int) -> bytes:
    from .. import native
    fast = native.ransnx16_core(cur.d, cur.p, False, N, out_sz)
    if fast is not None:
        buf, cur.p = fast
        return buf
    F, C, ssym = _read_freqs0(cur)
    d = cur.d
    p = cur.p
    R = []
    for _ in range(N):
        R.append(d[p] | (d[p + 1] << 8) | (d[p + 2] << 16)
                 | (d[p + 3] << 24))
        p += 4
    out = bytearray(out_sz)
    mask = (1 << _TF_SHIFT) - 1
    j = 0
    for i in range(out_sz):
        x = R[j]
        m = x & mask
        s = ssym[m]
        x = F[s] * (x >> _TF_SHIFT) + m - C[s]
        if x < _L:
            if p + 1 >= len(d):
                raise RansError("rans: input exhausted")
            x = (x << 16) | d[p] | (d[p + 1] << 8)
            p += 2
        out[i] = s
        R[j] = x
        j += 1
        if j == N:
            j = 0
    cur.p = p
    return bytes(out)


def _encode_o0(data: bytes, N: int) -> bytes:
    if not data:
        raise RansError("cannot order-0 encode empty data")
    counts = {}
    for b in data:
        counts[b] = counts.get(b, 0) + 1
    F = _norm_to(counts, 1 << _TF_SHIFT)
    syms = sorted(F)
    C = {}
    acc = 0
    for s in range(256):
        C[s] = acc
        acc += F.get(s, 0)
    head = bytearray(_write_alphabet(syms))
    for s in syms:
        head += _put_uint7(F[s])
    # run states FORWARD to find each step's renorm, then emit in
    # reverse (classic rANS): simulate decode order i ascending,
    # state i%N; encode = exact inverse, i descending.
    R = [_L] * N
    chunks = []
    for i in range(len(data) - 1, -1, -1):
        j = i % N
        s = data[i]
        f = F[s]
        x = R[j]
        x_max = ((_L >> _TF_SHIFT) << 16) * f
        if x >= x_max:
            chunks.append(bytes((x & 0xFF, (x >> 8) & 0xFF)))
            x >>= 16
        R[j] = ((x // f) << _TF_SHIFT) + (x % f) + C[s]
    states = bytearray()
    for j in range(N):
        x = R[j]
        states += bytes((x & 0xFF, (x >> 8) & 0xFF,
                         (x >> 16) & 0xFF, (x >> 24) & 0xFF))
    body = b"".join(reversed(chunks))
    return bytes(head) + bytes(states) + body


# ----------------------------------------------------------- order-1

def _read_freqs1(cur: _Cur, shift: int):
    syms = _read_alphabet(cur)
    tot = 1 << shift
    tables = {}
    for ctx in syms:
        F = [0] * 256
        t = 0
        run = 0
        for s in syms:
            if run:
                run -= 1
                continue
            f = cur.uint7()
            F[s] = f
            t += f
            if f == 0:
                run = cur.byte()
        if t == 0:
            continue                      # context never used
        if t != tot:
            while t < tot:
                t <<= 1
                for s in syms:
                    F[s] <<= 1
            if t != tot:
                raise RansError("order-1 frequencies do not sum to "
                                f"2^{shift}")
        C = [0] * 257
        for i in range(256):
            C[i + 1] = C[i] + F[i]
        ssym = bytearray(tot)
        for s in syms:
            if F[s]:
                ssym[C[s]:C[s] + F[s]] = bytes([s]) * F[s]
        tables[ctx] = (F, C, ssym)
    return tables


def _decode_o1(cur: _Cur, out_sz: int, N: int) -> bytes:
    from .. import native
    fast = native.ransnx16_core(cur.d, cur.p, True, N, out_sz)
    if fast is not None:
        buf, cur.p = fast
        return buf
    comp = cur.byte()
    shift = comp >> 4
    if comp & 1:
        u_sz = cur.uint7()
        c_sz = cur.uint7()
        sub = _Cur(cur.take(c_sz))
        tbl = _Cur(_decode_o0(sub, u_sz, 4))
    else:
        tbl = cur
    tables = _read_freqs1(tbl, shift)
    d = cur.d
    p = cur.p
    R = []
    for _ in range(N):
        R.append(d[p] | (d[p + 1] << 8) | (d[p + 2] << 16)
                 | (d[p + 3] << 24))
        p += 4
    out = bytearray(out_sz)
    mask = (1 << shift) - 1
    seg = out_sz // N
    last = [0] * N
    for i in range(seg):
        for j in range(N):
            F, C, ssym = tables[last[j]]
            x = R[j]
            m = x & mask
            s = ssym[m]
            x = F[s] * (x >> shift) + m - C[s]
            if x < _L:
                if p + 1 >= len(d):
                    raise RansError("rans: input exhausted")
                x = (x << 16) | d[p] | (d[p + 1] << 8)
                p += 2
            out[j * seg + i] = s
            R[j] = x
            last[j] = s
    # tail beyond N full segments: state N-1 continues its context
    jN = N - 1
    for i in range(N * seg, out_sz):
        F, C, ssym = tables[last[jN]]
        x = R[jN]
        m = x & mask
        s = ssym[m]
        x = F[s] * (x >> shift) + m - C[s]
        if x < _L:
            if p + 1 >= len(d):
                raise RansError("rans: input exhausted")
            x = (x << 16) | d[p] | (d[p + 1] << 8)
            p += 2
        out[i] = s
        R[jN] = x
        last[jN] = s
    cur.p = p
    return bytes(out)


def _encode_o1(data: bytes, N: int, compress_table: bool = False) -> bytes:
    if len(data) < N:
        raise RansError("order-1 input shorter than state count")
    shift = 12
    tot = 1 << shift
    seg = len(data) // N
    # transition counts; first byte of each segment has context 0,
    # the tail (beyond N*seg) continues state N-1's chain
    counts = {}

    def bump(ctx, s):
        row = counts.setdefault(ctx, {})
        row[s] = row.get(s, 0) + 1

    for j in range(N):
        bump(0, data[j * seg])
        for i in range(1, seg):
            bump(data[j * seg + i - 1], data[j * seg + i])
    for i in range(N * seg, len(data)):
        bump(data[i - 1], data[i])
    alpha = sorted(set(data) | set(counts) | {0})
    F = {}
    C = {}
    for ctx, row in counts.items():
        nf = _norm_to(row, tot)
        F[ctx] = nf
        acc = 0
        cc = {}
        for s in range(256):
            cc[s] = acc
            acc += nf.get(s, 0)
        C[ctx] = cc
    # serialize the table
    tb = bytearray(_write_alphabet(alpha))
    for ctx in alpha:
        row = F.get(ctx, {})
        zrun = 0
        pend = []
        for s in alpha:
            f = row.get(s, 0)
            if zrun:
                zrun -= 1
                continue
            pend.append(_put_uint7(f))
            if f == 0:
                later = 0
                k = alpha.index(s) + 1
                while k < len(alpha) and row.get(alpha[k], 0) == 0:
                    later += 1
                    k += 1
                later = min(later, 255)
                pend.append(bytes([later]))
                zrun = later
        tb += b"".join(pend)
    if compress_table:
        comp = _encode_o0(bytes(tb), 4)
        head = (bytes([(shift << 4) | 1]) + _put_uint7(len(tb))
                + _put_uint7(len(comp)) + comp)
    else:
        head = bytes([shift << 4]) + bytes(tb)
    # encode segments in exact reverse of decode order: decode does
    # columns i ascending with j inner ascending, then the tail
    R = [_L] * N
    chunks = []

    def enc(j, ctx, s):
        f = F[ctx][s]
        x = R[j]
        x_max = ((_L >> shift) << 16) * f
        if x >= x_max:
            chunks.append(bytes((x & 0xFF, (x >> 8) & 0xFF)))
            x >>= 16
        R[j] = ((x // f) << shift) + (x % f) + C[ctx][s]

    for i in range(len(data) - 1, N * seg - 1, -1):
        enc(N - 1, data[i - 1], data[i])
    for i in range(seg - 1, -1, -1):
        for j in range(N - 1, -1, -1):
            ctx = data[j * seg + i - 1] if i else 0
            enc(j, ctx, data[j * seg + i])
    states = bytearray()
    for j in range(N):
        x = R[j]
        states += bytes((x & 0xFF, (x >> 8) & 0xFF,
                         (x >> 16) & 0xFF, (x >> 24) & 0xFF))
    return bytes(head) + bytes(states) + b"".join(reversed(chunks))


# ---------------------------------------------------------- transforms

def _unpack(data: bytes, pmap: bytes, out_sz: int) -> bytes:
    import numpy as np
    n = len(pmap)
    if n <= 1:
        return pmap[:1] * out_sz
    arr = np.frombuffer(data, np.uint8)
    if n <= 2:
        vals = np.unpackbits(arr, bitorder="little")
    elif n <= 4:
        vals = ((arr[:, None] >> np.array([0, 2, 4, 6], np.uint8)) & 3) \
            .reshape(-1)
    elif n <= 16:
        vals = ((arr[:, None] >> np.array([0, 4], np.uint8)) & 15) \
            .reshape(-1)
    else:
        raise RansError(f"pack with {n} symbols")
    if len(vals) < out_sz:
        raise RansError("packed stream shorter than output")
    pm = np.zeros(16, np.uint8)  # pad: stray high bits in the final
    pm[:n] = np.frombuffer(pmap, np.uint8)  # byte must not index OOB
    return pm[vals[:out_sz]].tobytes()


def _pack(data: bytes, pmap: bytes) -> bytes:
    n = len(pmap)
    inv = {s: i for i, s in enumerate(pmap)}
    if n <= 1:
        return b""
    if n <= 2:
        per, bits = 8, 1
    elif n <= 4:
        per, bits = 4, 2
    else:
        per, bits = 2, 4
    out = bytearray((len(data) + per - 1) // per)
    for i, b in enumerate(data):
        out[i // per] |= inv[b] << ((i % per) * bits)
    return bytes(out)


def _rle_expand(lit: bytes, meta: bytes, out_sz: int) -> bytes:
    import numpy as np
    mc = _Cur(meta)
    n = mc.byte()
    if n == 0:
        n = 256
    runsyms = mc.take(n)
    la = np.frombuffer(lit, np.uint8)
    isrun = np.zeros(256, bool)
    isrun[np.frombuffer(runsyms, np.uint8)] = True
    mask = isrun[la]
    counts = np.ones(len(la), np.int64)
    runs = np.empty(int(mask.sum()), np.int64)
    for i in range(len(runs)):           # uint7 per run occurrence
        runs[i] = mc.uint7()
    counts[mask] += runs
    out = np.repeat(la, counts)
    if len(out) != out_sz:
        raise RansError(f"RLE expansion {len(out)} != {out_sz}")
    return out.tobytes()


def _rle_contract(data: bytes, runsyms) -> tuple:
    """-> (literals, meta) with runsyms run-length encoded."""
    runsyms = sorted(set(runsyms))
    meta = bytearray([len(runsyms) & 0xFF]) + bytes(runsyms)
    rs = frozenset(runsyms)
    lit = bytearray()
    i = 0
    n = len(data)
    while i < n:
        b = data[i]
        lit.append(b)
        if b in rs:
            j = i + 1
            while j < n and data[j] == b:
                j += 1
            meta += _put_uint7(j - i - 1)
            i = j
        else:
            i += 1
    return bytes(lit), bytes(meta)


# -------------------------------------------------------------- public

def decode(data: bytes, out_hint: int | None = None) -> bytes:
    """Decode one rANS-Nx16 stream.  out_hint is required when the
    stream has the NOSZ flag (CRAM stores block raw sizes outside)."""
    cur = _Cur(data)
    flags = cur.byte()
    if flags & STRIPE:
        if flags & NOSZ:
            if out_hint is None:
                raise RansError("NOSZ stream needs an out-size hint")
            ulen = out_hint
        else:
            ulen = cur.uint7()
        n = cur.byte()
        clens = [cur.uint7() for _ in range(n)]
        out = bytearray(ulen)
        for j in range(n):
            sub_len = ulen // n + (1 if j < ulen % n else 0)
            sub = decode(cur.take(clens[j]), sub_len)
            if len(sub) != sub_len:
                raise RansError("stripe sub-stream length mismatch")
            out[j::n] = sub
        return bytes(out)
    if flags & NOSZ:
        if out_hint is None:
            raise RansError("NOSZ stream needs an out-size hint")
        out_sz = out_hint
    else:
        out_sz = cur.uint7()
    pack_out = pmap = None
    if flags & PACK:
        pack_out = out_sz
        nsym = cur.byte()
        pmap = cur.take(nsym)
        out_sz = cur.uint7()
    rle_out = rle_meta = None
    if flags & RLE:
        rle_out = out_sz
        m = cur.uint7()
        lit_len = cur.uint7()
        if m & 1:
            rle_meta = cur.take(m >> 1)
        else:
            cm = cur.uint7()
            rle_meta = _decode_o0(_Cur(cur.take(cm)), m >> 1, 4)
        out_sz = lit_len
    N = 32 if flags & X32 else 4
    if flags & CAT:
        buf = cur.take(out_sz)
    elif out_sz == 0:
        buf = b""
    elif flags & ORDER1:
        buf = _decode_o1(cur, out_sz, N)
    else:
        buf = _decode_o0(cur, out_sz, N)
    if flags & RLE:
        buf = _rle_expand(buf, rle_meta, rle_out)
    if flags & PACK:
        buf = _unpack(buf, pmap, pack_out)
    return buf


def encode(data: bytes, flags: int = 0, *, rle_syms=None,
           compress_rle_meta: bool = False, stripe_n: int = 4,
           compress_o1_table: bool = False) -> bytes:
    """Encode per `flags` (test/round-trip support; the product only
    decodes).  With RLE, rle_syms picks the run-encoded symbols
    (default: all 256)."""
    out = bytearray([flags & 0xFF])
    if flags & STRIPE:
        if not (flags & NOSZ):
            out += _put_uint7(len(data))
        n = stripe_n
        out.append(n)
        subs = []
        sub_flags = (flags & ~STRIPE) | NOSZ
        for j in range(n):
            subs.append(encode(data[j::n], sub_flags,
                               rle_syms=rle_syms,
                               compress_rle_meta=compress_rle_meta,
                               compress_o1_table=compress_o1_table))
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
            raise RansError("pack needs <= 16 distinct symbols")
        packed = _pack(data, pmap)
        out.append(len(pmap))
        out += pmap
        out += _put_uint7(len(packed))
        data = packed
    if flags & RLE:
        lit, meta = _rle_contract(
            data, range(256) if rle_syms is None else rle_syms)
        if compress_rle_meta:
            cmeta = _encode_o0(meta, 4)
            out += _put_uint7(len(meta) << 1)
            out += _put_uint7(len(lit))
            out += _put_uint7(len(cmeta))
            out += cmeta
        else:
            out += _put_uint7((len(meta) << 1) | 1)
            out += _put_uint7(len(lit))
            out += meta
        data = lit
    N = 32 if flags & X32 else 4
    if (flags & ORDER1) and not (flags & CAT) and len(data) < N:
        # too short for order-1 state count: downgrade to order-0
        # in the stream flags, as the reference encoder does
        flags &= ~ORDER1
        out[0] = flags & 0xFF
    if flags & CAT:
        out += data
    elif len(data) == 0:
        pass
    elif flags & ORDER1:
        out += _encode_o1(data, N, compress_o1_table)
    else:
        out += _encode_o0(data, N)
    return bytes(out)
