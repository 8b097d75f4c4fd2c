"""Value histogram, statistics, and ploidy peak model.

Equivalent of the reference's merylHistogram (interface reconstructed
from call sites, SURVEY.md section 2.3: histogramValue/
histogramOccurrences, numUnique/numDistinct/numTotal, load(file),
computePloidyPeaks/getNoiseTrough/getCoverage/getDepth — used by
meryl src/meryl/merylOp-histogram.C:104-156 and
merylOp-nextMer.C:66-125).  The peak-detection internals live in the
absent meryl-utility submodule, so the model here is our own: smooth the
histogram, find the error/genomic trough, then locate up to four
coverage peaks near integer multiples of the haploid peak.
"""

from __future__ import annotations

import numpy as np


class MerylHistogram:
    """Sparse value histogram: values[i] -> occurrences[i], ascending."""

    def __init__(self, values: np.ndarray, occurrences: np.ndarray):
        self.values = np.asarray(values, dtype=np.uint64)
        self.occurrences = np.asarray(occurrences, dtype=np.uint64)
        self._peaks = None
        self._trough = None

    @classmethod
    def from_counts(cls, counts) -> "MerylHistogram":
        counts = np.asarray(counts)
        if len(counts) == 0:
            return cls(np.zeros(0, np.uint64), np.zeros(0, np.uint64))
        v, o = np.unique(counts, return_counts=True)
        return cls(v, o)

    @classmethod
    def load(cls, path: str) -> "MerylHistogram":
        """Load from a 'value<TAB>occurrences' text file (`ploidy` accepts
        histogram files as input, merylOp-histogram.C:127-131)."""
        vals, occ = [], []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                a, b = line.split()[:2]
                vals.append(int(a))
                occ.append(int(b))
        return cls(np.array(vals, np.uint64), np.array(occ, np.uint64))

    # --- merylHistogram interface ---

    def histogram_length(self) -> int:
        return len(self.values)

    def histogram_value(self, i: int) -> int:
        return int(self.values[i])

    def histogram_occurrences(self, i: int) -> int:
        return int(self.occurrences[i])

    def num_unique(self) -> int:
        one = np.searchsorted(self.values, 1)
        if one < len(self.values) and self.values[one] == 1:
            return int(self.occurrences[one])
        return 0

    def num_distinct(self) -> int:
        return int(self.occurrences.sum())

    def num_total(self) -> int:
        return int((self.values * self.occurrences).sum())

    # --- ploidy model (our design; capability parity with
    #     computePloidyPeaks/getNoiseTrough/getCoverage/getDepth) ---

    def _dense(self, max_v: int = 100000):
        hi = int(min(self.values[-1], max_v)) if len(self.values) else 0
        d = np.zeros(hi + 1, dtype=np.float64)
        for v, o in zip(self.values, self.occurrences):
            if v <= hi:
                d[int(v)] = float(o)
        return d

    def compute_ploidy_peaks(self, verbose: bool = False):
        if self._peaks is not None:
            return
        d = self._dense()
        if len(d) < 4:
            self._trough = 0.0
            self._peaks = [(float(i + 1), 0.0) for i in range(4)]
            return
        # light smoothing to suppress shot noise
        kern = np.array([1.0, 2.0, 3.0, 2.0, 1.0])
        kern /= kern.sum()
        s = np.convolve(d, kern, mode="same")
        # trough: first local minimum after value 1 (error kmers decay,
        # genomic kmers rise toward the coverage peak)
        trough = 0
        for i in range(2, len(s) - 1):
            if s[i] <= s[i - 1] and s[i] < s[i + 1]:
                trough = i
                break
        if trough == 0:
            trough = 1
        # primary peak: global max after the trough
        if trough + 1 < len(s):
            p1 = int(np.argmax(s[trough + 1:]) + trough + 1)
        else:
            p1 = trough
        peaks = []
        for n in range(1, 5):
            center = p1 * n
            lo = max(trough + 1, int(center - p1 * 0.5))
            hi = min(len(s) - 1, int(center + p1 * 0.5))
            if lo >= hi:
                peaks.append((float(n), 0.0))
                continue
            loc = int(np.argmax(s[lo:hi + 1]) + lo)
            peaks.append((loc / p1 if p1 else float(n), float(loc)))
        self._trough = float(trough)
        self._peaks = peaks

    def get_noise_trough(self) -> float:
        self.compute_ploidy_peaks()
        return self._trough

    def get_coverage(self, n: int) -> float:
        self.compute_ploidy_peaks()
        return self._peaks[n - 1][0]

    def get_depth(self, n: int) -> float:
        self.compute_ploidy_peaks()
        return self._peaks[n - 1][1]
