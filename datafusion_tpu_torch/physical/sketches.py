"""Approximate-aggregate sketches.

Reference parity: HyperLogLog (`physical-expr/src/aggregate/hyperloglog.rs`
— 2^14 registers, bias-corrected estimate) and TDigest
(`physical-expr-common/src/aggregate/tdigest.rs` — bounded-size centroid
digest for approx_percentile_cont).  Both are implemented as dense numpy
state updated with vectorized scatter-max / sort+bin compaction — one
sketch row per group id, matching the GroupsAccumulator layout.
"""
from __future__ import annotations

import math

import numpy as np

# ---------------------------------------------------------------------------
# HyperLogLog
# ---------------------------------------------------------------------------

HLL_P = 14                      # 2^14 registers, stderr ~= 1.04/sqrt(m) = 0.81%
HLL_M = 1 << HLL_P


class HyperLogLog:
    """Dense (n_groups, 2^p) uint8 register matrix; one HLL per group."""

    def __init__(self):
        self.regs = np.zeros((0, HLL_M), np.uint8)

    def _grow(self, n_groups: int) -> None:
        if self.regs.shape[0] < n_groups:
            grown = np.zeros((n_groups, HLL_M), np.uint8)
            grown[: self.regs.shape[0]] = self.regs
            self.regs = grown

    def add_hashed(self, hashes: np.ndarray, group_ids: np.ndarray,
                   n_groups: int) -> None:
        """hashes: uint64 (already well-mixed), group_ids: int64."""
        self._grow(n_groups)
        idx = (hashes >> np.uint64(64 - HLL_P)).astype(np.int64)
        w = hashes << np.uint64(HLL_P) >> np.uint64(HLL_P)  # low 64-p bits
        # rank of the first set bit from the top of the (64-p)-bit word;
        # w < 2^50 so float64 log2 is exact for the leading-bit position
        nz = w != 0
        rho = np.full(len(w), 64 - HLL_P + 1, np.uint8)
        if nz.any():
            rho[nz] = (64 - HLL_P - np.floor(
                np.log2(w[nz].astype(np.float64))).astype(np.int64)
            ).astype(np.uint8)
        np.maximum.at(self.regs, (group_ids, idx), rho)

    def merge_regs(self, other_regs: np.ndarray, group_ids: np.ndarray,
                   n_groups: int) -> None:
        self._grow(n_groups)
        np.maximum.at(self.regs, group_ids, other_regs)

    def estimate(self, n_groups: int) -> np.ndarray:
        """Bias-corrected cardinality per group (original HLL corrections)."""
        self._grow(n_groups)
        r = self.regs[:n_groups].astype(np.float64)
        m = float(HLL_M)
        alpha = 0.7213 / (1.0 + 1.079 / m)
        raw = alpha * m * m / np.sum(np.exp2(-r), axis=1)
        zeros = np.sum(self.regs[:n_groups] == 0, axis=1).astype(np.float64)
        # small-range: linear counting when raw <= 2.5m and empty registers
        small = (raw <= 2.5 * m) & (zeros > 0)
        with np.errstate(divide="ignore"):
            linear = m * np.log(np.where(zeros > 0, m / np.maximum(zeros, 1e-9),
                                         1.0))
        est = np.where(small, linear, raw)
        # large-range correction for 64-bit hashes is negligible; skip
        return np.rint(est).astype(np.int64)


# ---------------------------------------------------------------------------
# TDigest
# ---------------------------------------------------------------------------

TDIGEST_MAX = 128               # reference DEFAULT_MAX_SIZE = 100 centroids


def tdigest_compress(x: np.ndarray, w: np.ndarray,
                     max_size: int = TDIGEST_MAX):
    """Compress weighted samples into <= max_size centroids (k1 scale:
    k(q) = d/(2*pi) * asin(2q-1); equal-k bins get merged)."""
    if len(x) <= max_size:
        order = np.argsort(x, kind="stable")
        return x[order], w[order]
    order = np.argsort(x, kind="stable")
    xs, ws = x[order], w[order]
    total = ws.sum()
    # midpoint quantile of each sample
    cum = np.cumsum(ws) - ws * 0.5
    q = np.clip(cum / total, 0.0, 1.0)
    k = (max_size / (2.0 * np.pi)) * np.arcsin(2.0 * q - 1.0)
    bins = np.floor(k - k[0]).astype(np.int64)
    bins = np.minimum(bins, max_size - 1)
    nb = bins.max() + 1
    wsum = np.zeros(nb, np.float64)
    xsum = np.zeros(nb, np.float64)
    np.add.at(wsum, bins, ws)
    np.add.at(xsum, bins, xs * ws)
    keep = wsum > 0
    return xsum[keep] / wsum[keep], wsum[keep]


def tdigest_quantile(x: np.ndarray, w: np.ndarray, q: float) -> float:
    """Interpolated quantile from sorted centroids (tdigest.rs
    estimate_quantile)."""
    if len(x) == 0:
        return np.nan
    if len(x) == 1:
        return float(x[0])
    total = w.sum()
    target = q * total
    # centroid midpoints in cumulative-weight space
    cum = np.cumsum(w) - w * 0.5
    if target <= cum[0]:
        return float(x[0])
    if target >= cum[-1]:
        return float(x[-1])
    hi = int(np.searchsorted(cum, target))
    lo = hi - 1
    t = (target - cum[lo]) / max(cum[hi] - cum[lo], 1e-300)
    return float(x[lo] + t * (x[hi] - x[lo]))


class GroupedTDigest:
    """Per-group t-digest with batched compaction: raw samples buffer up and
    are compressed group-by-group once the buffer exceeds a threshold."""

    def __init__(self, max_size: int = TDIGEST_MAX):
        self.max_size = max_size
        self._buf_x: list = []
        self._buf_w: list = []
        self._buf_g: list = []
        self._digests: dict = {}       # group id -> (x, w)
        self._buffered = 0

    def add(self, x: np.ndarray, group_ids: np.ndarray,
            w: np.ndarray = None) -> None:
        if len(x) == 0:
            return
        self._buf_x.append(x.astype(np.float64))
        self._buf_w.append(np.ones(len(x), np.float64) if w is None
                           else w.astype(np.float64))
        self._buf_g.append(group_ids)
        self._buffered += len(x)
        if self._buffered > 1 << 20:
            self._compact()

    def _compact(self) -> None:
        if not self._buf_x:
            return
        x = np.concatenate(self._buf_x)
        w = np.concatenate(self._buf_w)
        g = np.concatenate(self._buf_g)
        self._buf_x, self._buf_w, self._buf_g, self._buffered = [], [], [], 0
        order = np.argsort(g, kind="stable")
        xs, ws, gs = x[order], w[order], g[order]
        bounds = np.nonzero(np.concatenate([[True], gs[1:] != gs[:-1]]))[0]
        bounds = np.append(bounds, len(gs))
        for i in range(len(bounds) - 1):
            lo, hi = bounds[i], bounds[i + 1]
            gid = int(gs[lo])
            cx, cw = xs[lo:hi], ws[lo:hi]
            if gid in self._digests:
                px, pw = self._digests[gid]
                cx = np.concatenate([px, cx])
                cw = np.concatenate([pw, cw])
            self._digests[gid] = tdigest_compress(cx, cw, self.max_size)

    def quantile(self, q: float, n_groups: int):
        """-> (values float64[n_groups], seen bool[n_groups])."""
        self._compact()
        out = np.zeros(n_groups, np.float64)
        seen = np.zeros(n_groups, bool)
        for gid, (x, w) in self._digests.items():
            if gid < n_groups and len(x):
                out[gid] = tdigest_quantile(x, w, q)
                seen[gid] = True
        return out, seen


# --------------------------------------------------------------------------
# Reference-faithful t-digest (semantics of
# physical-expr-common/src/aggregate/tdigest.rs, reimplemented): the scaled
# k->q limit schedule, the merge-then-flush centroid compression with its
# exact floating-point accumulation order, and the rank-interpolating
# quantile estimator. Used by approx_percentile_cont / approx_median so
# results are bit-identical to the reference on identical input order.
# --------------------------------------------------------------------------

def _k_to_q(k: float, d: float) -> float:
    kd = k / d
    if kd >= 0.5:
        base = 1.0 - kd
        return 1.0 - 2.0 * base * base
    return 2.0 * kd * kd


class RefTDigest:
    __slots__ = ("max_size", "centroids", "count", "min", "max")

    def __init__(self, max_size: int = 100):
        self.max_size = max_size
        self.centroids: list = []   # [(mean, weight)] sorted by mean
        self.count = 0.0
        self.min = float("nan")
        self.max = float("nan")

    # -- compression core: sorted (mean, weight) stream -> centroid list ----
    def _compress(self, pairs, count):
        d = float(self.max_size)
        compressed = []
        k_limit = 1.0
        q_limit_times_count = _k_to_q(k_limit, d) * count
        k_limit += 1.0
        it = iter(pairs)
        curr_m, curr_w = next(it)
        weight_so_far = curr_w
        sums = 0.0
        weights = 0.0
        for m, w in it:
            weight_so_far += w
            if weight_so_far <= q_limit_times_count:
                sums += m * w
                weights += w
            else:
                new_sum = sums + curr_w * curr_m
                curr_w += weights
                curr_m = new_sum / curr_w
                compressed.append((curr_m, curr_w))
                q_limit_times_count = _k_to_q(k_limit, d) * count
                k_limit += 1.0
                sums = 0.0
                weights = 0.0
                curr_m, curr_w = m, w
        new_sum = sums + curr_w * curr_m
        curr_w += weights
        curr_m = new_sum / curr_w
        compressed.append((curr_m, curr_w))
        compressed.sort(key=lambda c: c[0])
        return compressed

    def merge_sorted(self, sorted_values: np.ndarray) -> "RefTDigest":
        """merge_sorted_f64: fold a sorted batch of unit-weight values into
        the digest (returns a new digest)."""
        n = len(sorted_values)
        if n == 0:
            return self
        out = RefTDigest(self.max_size)
        out.count = self.count + n
        lo, hi = float(sorted_values[0]), float(sorted_values[-1])
        if self.count > 0.0:
            out.min = min(self.min, lo)
            out.max = max(self.max, hi)
        else:
            out.min, out.max = lo, hi
        vals = [(float(v), 1.0) for v in sorted_values]
        merged = _merge_by_mean(self.centroids, vals)
        out.centroids = out._compress(merged, out.count)
        return out

    @staticmethod
    def merge_digests(digests, max_size: int = 100) -> "RefTDigest":
        pairs = []
        count = 0.0
        lo, hi = float("inf"), float("-inf")
        for dg in digests:
            if dg.count > 0.0:
                lo = min(lo, dg.min)
                hi = max(hi, dg.max)
                count += dg.count
                pairs.extend(dg.centroids)
        out = RefTDigest(max_size)
        if not pairs:
            return out
        pairs.sort(key=lambda c: c[0])
        out.count = count
        out.min, out.max = lo, hi
        out.centroids = out._compress(pairs, count)
        return out

    def estimate_quantile(self, q: float) -> float:
        if not self.centroids:
            return 0.0
        count = self.count
        rank = q * count
        cents = self.centroids
        if q > 0.5:
            if q >= 1.0:
                return self.max
            pos = 0
            t = count
            for k in range(len(cents) - 1, -1, -1):
                t -= cents[k][1]
                if rank >= t:
                    pos = k
                    break
        else:
            if q <= 0.0:
                return self.min
            pos = len(cents) - 1
            t = 0.0
            for k, c in enumerate(cents):
                if rank < t + c[1]:
                    pos = k
                    break
                t += c[1]
        delta = 0.0
        lo, hi = self.min, self.max
        if len(cents) > 1:
            if pos == 0:
                delta = cents[1][0] - cents[0][0]
                hi = cents[1][0]
            elif pos == len(cents) - 1:
                delta = cents[pos][0] - cents[pos - 1][0]
                lo = cents[pos - 1][0]
            else:
                delta = (cents[pos + 1][0] - cents[pos - 1][0]) / 2.0
                lo = cents[pos - 1][0]
                hi = cents[pos + 1][0]
        value = cents[pos][0] + ((rank - t) / cents[pos][1] - 0.5) * delta
        if math.isnan(lo) and math.isnan(hi):
            return value
        return min(max(value, lo), hi)


def _merge_by_mean(a, b):
    """Two-way merge of (mean, weight) lists sorted by mean; ties take from
    ``b`` first (raw values before centroids: the reference picks the
    centroid only when strictly c.mean() < value)."""
    out = []
    i = j = 0
    while i < len(a) and j < len(b):
        if a[i][0] < b[j][0]:
            out.append(a[i]); i += 1
        else:
            out.append(b[j]); j += 1
    out.extend(a[i:])
    out.extend(b[j:])
    return out
