"""position-lookup: map query-sequence kmers to reference positions
(counterpart of meryl_tpu/tools/position_lookup.py; same options and
output bytes).

Mirrors meryl src/meryl-lookup/position-lookup.C:25-437: build a kmer
-> [reference positions] table from a reference DB plus the reference
sequence, then for each query sequence report hits:
  -m refdb -s refseq [-hpq FILE] [-mpb FILE] [-qpb FILE] queries...
  -hpq: per query 'nPer<TAB>tCov<TAB>length<TAB>ident' where tCov is
        the number of query kmers found and nPer the total number of
        reference positions those kmers map to
  -mpb: 'pos count' lines — kmer hits painted on reference positions
  -qpb: 'pos count' lines — distinct (kmer, query) pairs painted
  -device cpu|cuda (default cuda)

Reference positions are global (concatenated over reference sequences).
The canonical k-mers come from the extraction kernel and are ranked on
the device; only the ranks cross to the host.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .. import kmer as km
from .. import resolve_device
from ..db import MerylDB
from ..io.sequence import iter_sequences
from ..lookup import ExactLookup, _lower_bound
from ..lookup_cli import _extract_positions
from ..reports import format_int_table


def _index_kernel(db_key, offsets, q_key, valid, k, b, iters):
    """Rank of each query kmer in the sorted DB keys; -1 if absent (the
    reference's merylExactLookup::index).  Shares the lower bound with
    lookup._query_kernel."""
    idx, found = _lower_bound(db_key, offsets, q_key, k, b, iters)
    return torch.where(found & valid, idx, -1)


def _canonical_positions(lookup: ExactLookup, codes: np.ndarray):
    """Valid canonical kmers of a sequence -> (positions, table_indices)
    for the kmers present in the table (table_index is the kmer's rank
    in the lookup's sorted keys)."""
    if len(codes) < lookup.k:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    key, _, valid = _extract_positions(codes, lookup.k, lookup.device,
                                       canonical=True)
    idx = _index_kernel(lookup._key, lookup._offsets, key, valid,
                        lookup.k, lookup.B, lookup._iters)
    idx = idx.to(torch.int32).cpu().numpy()
    loc = np.flatnonzero(idx >= 0)
    return loc.astype(np.int64), idx[loc].astype(np.int64)


class PositionTable:
    """kmer rank -> list of global reference positions."""

    def __init__(self, ref_db: str, ref_seq: str, device="cuda"):
        self.lookup = ExactLookup(MerylDB.open(ref_db), device=device)
        if not self.lookup._device_resident:
            raise RuntimeError(
                "position-lookup: the reference DB does not fit the device "
                "budget (MERYL_TPU_LOOKUP_DEVICE_GB)")
        pos_all = []
        idx_all = []
        offset = 0
        for _, seq, _ in iter_sequences(ref_seq):
            codes = km.CODE_LUT[np.frombuffer(seq, np.uint8)]
            p, ix = _canonical_positions(self.lookup, codes)
            pos_all.append(p + offset)
            idx_all.append(ix)
            offset += len(seq)
        pos = np.concatenate(pos_all) if pos_all else np.zeros(0, np.int64)
        idx = np.concatenate(idx_all) if idx_all else np.zeros(0, np.int64)
        order = np.argsort(idx, kind="stable")
        self._pos = pos[order]
        self._rank = idx[order]        # rank of each position of _pos
        self.n = self.lookup._values.shape[0]
        self._start = np.searchsorted(self._rank, np.arange(self.n + 1))
        self.ref_len = offset

    def positions_of(self, rank: int) -> np.ndarray:
        return self._pos[self._start[rank]:self._start[rank + 1]]

    def n_occurrences(self, ranks: np.ndarray) -> np.ndarray:
        return self._start[ranks + 1] - self._start[ranks]

    def paint(self, paint: np.ndarray, ranks: np.ndarray) -> None:
        """Add 1 at every reference position of each rank in `ranks`
        (ranks may repeat), into the uint32 array `paint`."""
        cnt = np.bincount(ranks, minlength=self.n).astype(np.uint32)
        paint[self._pos] += cnt[self._rank]


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ref_db = ref_seq = hpq = mpb = qpb = None
    device = "cuda"
    inputs = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-m":
            i += 1
            ref_db = argv[i]
        elif a == "-s":
            i += 1
            ref_seq = argv[i]
        elif a == "-hpq":
            i += 1
            hpq = argv[i]
        elif a == "-mpb":
            i += 1
            mpb = argv[i]
        elif a == "-qpb":
            i += 1
            qpb = argv[i]
        elif a == "-device":
            i += 1
            device = argv[i]
        else:
            import os
            if os.path.exists(a):
                inputs.append(a)
            else:
                sys.stderr.write(f"unknown option '{a}'\n")
                return 1
        i += 1
    if not ref_db or not ref_seq:
        sys.stderr.write("usage: position-lookup -m refdb -s refseq "
                         "[-hpq F] [-mpb F] [-qpb F] [-device cpu|cuda] "
                         "queries...\n")
        return 1
    try:
        device = resolve_device(device)
    except (RuntimeError, ValueError) as e:
        sys.stderr.write(f"position-lookup: {e}\n")
        return 1

    table = PositionTable(ref_db, ref_seq, device)
    f_hpq = open(hpq, "w") if hpq else None
    mer_paint = np.zeros(table.ref_len + 1, np.uint32) if mpb else None
    qry_paint = np.zeros(table.ref_len + 1, np.uint32) if qpb else None

    # reads are queried in ~2M-base concatenated batches (0xFF breakers
    # invalidate cross-read windows); per-read counts come from bincount
    # over the read each hit position falls in
    for path in inputs:
        it = iter_sequences(path)
        done = False
        while not done:
            batch = []
            nb = 0
            while nb < (1 << 21):
                r = next(it, None)
                if r is None:
                    done = True
                    break
                batch.append(r)
                nb += len(r[1])
            if not batch:
                break
            codes_list = [km.CODE_LUT[np.frombuffer(r[1], np.uint8)]
                          for r in batch]
            n = len(batch)
            buf, offs, _lens = km.concat_codes_with_breakers(codes_list)
            positions, ranks = _canonical_positions(table.lookup, buf)
            read_of = np.searchsorted(offs, positions, "right") - 1
            tcov = np.bincount(read_of, minlength=n)
            occ = table.n_occurrences(ranks) if len(ranks) else \
                np.zeros(0, np.int64)
            nper = np.bincount(read_of, weights=occ,
                               minlength=n).astype(np.int64)
            if f_hpq:
                for i, (name, seq, _) in enumerate(batch):
                    f_hpq.write(f"{int(nper[i])}\t{int(tcov[i])}"
                                f"\t{len(seq)}\t{name}\n")
            if mer_paint is not None:
                table.paint(mer_paint, ranks)
            if qry_paint is not None:
                # distinct (read, kmer) pairs, one int64 key each
                pairs = np.unique(read_of * table.n + ranks)
                table.paint(qry_paint, pairs % table.n)
    if f_hpq:
        f_hpq.close()
    for path, paint in ((mpb, mer_paint), (qpb, qry_paint)):
        if paint is not None:
            # 'pos count' lines: the table's one tab a line becomes a space
            p = np.flatnonzero(paint)
            with open(path, "wb") as f:
                f.write(format_int_table([p, paint[p]]).replace(b"\t", b" "))
    return 0


if __name__ == "__main__":
    sys.exit(main())
