"""fqzcomp quality codec (CRAM 3.1 block compression method 7).

Dependency-free decoder (and encoder, for the round-trip tests and the
synthetic-CRAM test writer) for the htscodecs "fqzcomp qual" format:
the adaptive range coder of the arith codec (io/arith.py) driving a
16-bit context model over qualities, where each context mixes the
recent quality history (qtab/qbits/qshift/qloc), the position within
the record (ptab/ploc), the run-delta (dtab/dloc) and an optional
per-record parameter selector (sloc).  The reference gets this codec
via vendored htslib (meryl src/main.mk:92-140).

Wire format reconstructed from the hts-specs CRAMcodecs document; the
encoder and decoder are an exactly-matched pair and every decode is
structurally checked (exact output size, exact stream consumption), so
a mismatched stream fails loudly rather than garbling.

Stream layout::

    vers:u8(=5)  gflags:u8
    [nparam:u8 if MULTI_PARAM]  [max_sel:u8 + stab:array256 if HAVE_STAB]
    nparam x parameter block:
        context:u16be  pflags:u8  max_sym:u8
        (qbits<<4|qshift):u8  (qloc<<4|sloc):u8  (ploc<<4|dloc):u8
        [qmap: max_sym bytes if HAVE_QMAP]   [qtab: array256 if HAVE_QTAB]
        [ptab: array1024 if HAVE_PTAB]       [dtab: array256 if HAVE_DTAB]
    <range-coded body>

Arrays are the monotone run-length form: successive run lengths (one
per level k = 0,1,2,...), each a 255-continued byte sum, with a repeat
count byte after any run equal to the previous one.
"""

from __future__ import annotations

from .arith import _Model, _RangeDecoder, _RangeEncoder, ArithError
from .rans_nx16 import _Cur

VERS = 5

GFLAG_MULTI_PARAM = 0x01
GFLAG_HAVE_STAB = 0x02
GFLAG_DO_REV = 0x04

PFLAG_DO_DEDUP = 0x02
PFLAG_DO_LEN = 0x04
PFLAG_DO_SEL = 0x08
PFLAG_HAVE_QMAP = 0x10
PFLAG_HAVE_PTAB = 0x20
PFLAG_HAVE_DTAB = 0x40
PFLAG_HAVE_QTAB = 0x80


class FqzError(ArithError):
    pass


# ------------------------------------------------------ table arrays

def _read_array(cur: _Cur, size: int) -> list:
    """Monotone table: entry j gets level k, where the run length of
    each successive level is a 255-continued byte sum; a run equal to
    the previous one is followed by a byte giving how many further
    identical runs follow without re-encoding."""
    arr = [0] * size
    j = 0
    k = 0
    last = -1
    pending = 0
    while j < size:
        if pending:
            pending -= 1
            run = last
        else:
            run = 0
            while True:
                r = cur.byte()
                run += r
                if r != 255:
                    break
            if run == last:
                pending = cur.byte()
            last = run
        n = min(run, size - j)
        for _ in range(n):
            arr[j] = k
            j += 1
        if run > n:
            break
        k += 1
    return arr


def _write_array(arr, size: int) -> bytes:
    kmax = max(arr) if arr else 0
    runs = []
    j = 0
    for k in range(kmax + 1):
        n = 0
        while j < size and arr[j] == k:
            n += 1
            j += 1
        runs.append(n)
    if j != size:
        raise FqzError("table array must be monotone non-decreasing")
    out = bytearray()
    last = -1
    i = 0
    while i < len(runs):
        run = runs[i]
        v = run
        while v >= 255:
            out.append(255)
            v -= 255
        out.append(v)
        i += 1
        if run == last:
            z = 0
            while i + z < len(runs) and runs[i + z] == run and z < 255:
                z += 1
            out.append(z)
            i += z
        last = run
    return bytes(out)


# ---------------------------------------------------------- parameters

class _Param:
    __slots__ = ("context", "pflags", "max_sym", "qbits", "qshift",
                 "qloc", "sloc", "ploc", "dloc", "qmap", "qtab",
                 "ptab", "dtab", "qmask")

    def __init__(self, context=0, pflags=PFLAG_DO_LEN, max_sym=64,
                 qbits=9, qshift=5, qloc=7, sloc=0, ploc=0, dloc=0,
                 qmap=None, qtab=None, ptab=None, dtab=None):
        self.context = context
        self.pflags = pflags
        self.max_sym = max_sym
        self.qbits = qbits
        self.qshift = qshift
        self.qloc = qloc
        self.sloc = sloc
        self.ploc = ploc
        self.dloc = dloc
        self.qmap = qmap
        self.qtab = qtab if qtab is not None else list(range(256))
        self.ptab = ptab if ptab is not None else [0] * 1024
        self.dtab = dtab if dtab is not None else [0] * 256
        self.qmask = (1 << qbits) - 1

    @classmethod
    def read(cls, cur: _Cur) -> "_Param":
        context = (cur.byte() << 8) | cur.byte()
        pflags = cur.byte()
        max_sym = cur.byte()
        x = cur.byte()
        qbits, qshift = x >> 4, x & 15
        x = cur.byte()
        qloc, sloc = x >> 4, x & 15
        x = cur.byte()
        ploc, dloc = x >> 4, x & 15
        qmap = None
        if pflags & PFLAG_HAVE_QMAP:
            qmap = list(cur.take(max_sym))
        qtab = _read_array(cur, 256) if pflags & PFLAG_HAVE_QTAB else None
        ptab = _read_array(cur, 1024) if pflags & PFLAG_HAVE_PTAB else None
        dtab = _read_array(cur, 256) if pflags & PFLAG_HAVE_DTAB else None
        return cls(context, pflags, max_sym, qbits, qshift, qloc, sloc,
                   ploc, dloc, qmap, qtab, ptab, dtab)

    def write(self) -> bytes:
        out = bytearray()
        out.append((self.context >> 8) & 0xFF)
        out.append(self.context & 0xFF)
        out.append(self.pflags)
        out.append(self.max_sym)
        out.append((self.qbits << 4) | self.qshift)
        out.append((self.qloc << 4) | self.sloc)
        out.append((self.ploc << 4) | self.dloc)
        if self.pflags & PFLAG_HAVE_QMAP:
            out += bytes(self.qmap)
        if self.pflags & PFLAG_HAVE_QTAB:
            out += _write_array(self.qtab, 256)
        if self.pflags & PFLAG_HAVE_PTAB:
            out += _write_array(self.ptab, 1024)
        if self.pflags & PFLAG_HAVE_DTAB:
            out += _write_array(self.dtab, 256)
        return bytes(out)


class _State:
    __slots__ = ("qctx", "prevq", "delta", "p", "s")

    def reset(self, length: int, sel: int) -> None:
        self.qctx = 0
        self.prevq = 0
        self.delta = 0
        self.p = length
        self.s = sel


def _update_ctx(pm: _Param, st: _State, q: int) -> int:
    st.qctx = ((st.qctx << pm.qshift) + pm.qtab[q]) & 0xFFFFFFFF
    ctx = pm.context
    ctx += (st.qctx & pm.qmask) << pm.qloc
    if pm.pflags & PFLAG_HAVE_PTAB:
        ctx += pm.ptab[min(1023, st.p)] << pm.ploc
    if pm.pflags & PFLAG_HAVE_DTAB:
        ctx += pm.dtab[min(255, st.delta)] << pm.dloc
    if pm.pflags & PFLAG_DO_SEL:
        ctx += st.s << pm.sloc
    st.p -= 1
    st.delta += (st.prevq != q)
    st.prevq = q
    return ctx & 0xFFFF


class _Models:
    def __init__(self, nsym: int, max_sel: int):
        self.nsym = max(1, nsym)
        self.qual: dict = {}
        self.len = [_Model(256) for _ in range(4)]
        self.rev = _Model(2)
        self.dup = _Model(2)
        self.sel = _Model(max_sel + 1)

    def qual_model(self, ctx: int) -> _Model:
        m = self.qual.get(ctx)
        if m is None:
            m = self.qual[ctx] = _Model(self.nsym)
        return m


# -------------------------------------------------------------- decode

def decode(data: bytes, out_size: int) -> bytes:
    """Decode a flat quality byte stream of exactly `out_size` bytes
    (the CRAM block's raw size); record lengths are internal."""
    cur = _Cur(data)
    if cur.byte() != VERS:
        raise FqzError("fqzcomp: bad version byte")
    gflags = cur.byte()
    nparam = cur.byte() if gflags & GFLAG_MULTI_PARAM else 1
    if gflags & GFLAG_HAVE_STAB:
        max_sel = cur.byte()
        stab = _read_array(cur, 256)
    else:
        max_sel = nparam - 1
        stab = [min(i, nparam - 1) for i in range(256)]
    params = [_Param.read(cur) for _ in range(nparam)]
    for pm in params:
        if pm.pflags & PFLAG_HAVE_QMAP and pm.max_sym == 0:
            raise FqzError("fqzcomp: QMAP with zero symbols")

    if out_size == 0:
        return b""
    try:                  # native core (~250x); Python loop = fallback
        from .. import native
        fast = native.fqz_core(cur.d, cur.p, gflags, max_sel, stab,
                               params, out_size)
    except Exception:
        fast = None
    if fast is not None:
        return fast[0]

    nsym = max(pm.max_sym for pm in params)
    models = _Models(nsym, max_sel)
    rc = _RangeDecoder(cur)
    st = _State()
    out = bytearray(out_size)
    rev_flags = []
    rec_bounds = []     # (start, length) per record, for DO_REV
    i = 0
    pm = params[0]
    last_len = 0
    first = True
    ctx = 0
    rec_len = 0
    while i < out_size:
        # record boundary
        if first or st.p == 0:
            sel = 0
            if gflags & (GFLAG_MULTI_PARAM | GFLAG_HAVE_STAB):
                sel = models.sel.decode(rc)
                x = stab[sel] if sel < 256 else max_sel
                if x >= nparam:
                    raise FqzError("fqzcomp: selector out of range")
                pm = params[x]
            if (pm.pflags & PFLAG_DO_LEN) or first:
                b0 = models.len[0].decode(rc)
                b1 = models.len[1].decode(rc)
                b2 = models.len[2].decode(rc)
                b3 = models.len[3].decode(rc)
                last_len = b0 | (b1 << 8) | (b2 << 16) | (b3 << 24)
            rec_len = last_len
            if rec_len <= 0 or i + rec_len > out_size:
                raise FqzError(
                    f"fqzcomp: record length {rec_len} overruns output "
                    f"({i}/{out_size})")
            if gflags & GFLAG_DO_REV:
                rev_flags.append(models.rev.decode(rc))
                rec_bounds.append((i, rec_len))
            st.reset(rec_len, sel)
            first = False
            if pm.pflags & PFLAG_DO_DEDUP:
                if models.dup.decode(rc):
                    if i < rec_len:
                        raise FqzError("fqzcomp: dup with no previous")
                    out[i:i + rec_len] = out[i - rec_len:i]
                    i += rec_len
                    st.p = 0
                    continue
            ctx = pm.context
        q = models.qual_model(ctx).decode(rc)
        out[i] = pm.qmap[q] if pm.qmap is not None else q
        i += 1
        ctx = _update_ctx(pm, st, q)
    if st.p != 0:
        raise FqzError("fqzcomp: output ended mid-record")
    if gflags & GFLAG_DO_REV:
        for f, (a, n) in zip(rev_flags, rec_bounds):
            if f:
                out[a:a + n] = out[a:a + n][::-1]
    return bytes(out)


# -------------------------------------------------------------- encode

def encode(records, *, params=None, gflags: int = 0,
           stab=None, revs=None) -> bytes:
    """Encode a list of per-record quality byte strings.

    `params`: list of _Param (default: one auto-sized parameter set
    with per-record lengths and a 9-bit quality history context).
    `stab`: 256-entry selector->param table (sets HAVE_STAB).
    `revs`: per-record bools; flagged records are stored reversed and
    restored by the decoder (sets DO_REV).
    With multiple parameter sets, record r uses set stab[r % nsel].
    """
    records = [bytes(r) for r in records]
    if params is None:
        msym = max((max(r) for r in records if r), default=0) + 1
        params = [_Param(max_sym=msym)]
    nparam = len(params)
    if nparam > 1:
        gflags |= GFLAG_MULTI_PARAM
    if stab is not None:
        gflags |= GFLAG_HAVE_STAB
        max_sel = max(stab)
        if max_sel >= 256:
            raise FqzError("stab selector out of range")
        full_stab = list(stab) + [stab[-1]] * (256 - len(stab))
    else:
        max_sel = nparam - 1
        full_stab = [min(i, nparam - 1) for i in range(256)]
    if revs is not None:
        gflags |= GFLAG_DO_REV
    else:
        revs = [False] * len(records)

    out = bytearray([VERS, gflags])
    if gflags & GFLAG_MULTI_PARAM:
        out.append(nparam)
    if gflags & GFLAG_HAVE_STAB:
        out.append(max_sel)
        out += _write_array(full_stab, 256)
    for pm in params:
        out += pm.write()

    nsym = max(pm.max_sym for pm in params)
    models = _Models(nsym, max_sel)
    rc = _RangeEncoder()
    st = _State()
    last_len = 0
    first = True
    prev = None
    nsel = max_sel + 1
    for r, rec in enumerate(records):
        body = rec[::-1] if revs[r] else rec
        sel = r % nsel if (gflags & (GFLAG_MULTI_PARAM
                                     | GFLAG_HAVE_STAB)) else 0
        if gflags & (GFLAG_MULTI_PARAM | GFLAG_HAVE_STAB):
            models.sel.encode(rc, sel)
        pm = params[full_stab[sel]]
        if (pm.pflags & PFLAG_DO_LEN) or first:
            n = len(body)
            models.len[0].encode(rc, n & 0xFF)
            models.len[1].encode(rc, (n >> 8) & 0xFF)
            models.len[2].encode(rc, (n >> 16) & 0xFF)
            models.len[3].encode(rc, (n >> 24) & 0xFF)
            last_len = n
        elif len(body) != last_len:
            raise FqzError("fixed-length params but lengths vary")
        if gflags & GFLAG_DO_REV:
            models.rev.encode(rc, 1 if revs[r] else 0)
        st.reset(len(body), sel)
        first = False
        if pm.pflags & PFLAG_DO_DEDUP:
            dup = 1 if body == prev else 0
            models.dup.encode(rc, dup)
            if dup:
                prev = body
                continue
        if pm.qmap is not None:
            inv = {v: i for i, v in enumerate(pm.qmap)}
        ctx = pm.context
        for b in body:
            q = inv[b] if pm.qmap is not None else b
            if q >= nsym:
                raise FqzError(f"quality {q} exceeds max_sym {nsym}")
            models.qual_model(ctx).encode(rc, q)
            ctx = _update_ctx(pm, st, q)
        prev = body
    return bytes(out) + rc.finish()
