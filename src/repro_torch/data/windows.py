"""Windowing + normalization (paper §4.2) + the streaming client provider.

Per building: Min–Max scale to [0,1] over the entire year, frame into
look-back-8 / horizon-4 windows, split 75:25 chronologically (≈9 months train,
3 months test).

Two data paths share this math:

* :func:`batched_client_windows` materializes the full ``(N, n_win, L, 1)``
  train/test tensors — fine for dozens of clients, quadratic pain at 10k+.
* :class:`ClientWindowProvider` is the streaming replacement: per-client
  series are fetched (or generated) lazily and normalized/windowed on demand,
  so a federated round only ever touches the ``m`` clients selected that
  round.  Ragged histories are supported via count-masking: every batch is
  zero-padded to a fixed ``(m, n_win_max, L, 1)`` shape and carries per-client
  valid-window counts; training draws minibatch indices in ``[0, count_i)``
  so the padding is never read.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Iterator, Sequence, Tuple, Union

import numpy as np

from repro_torch import tracing
from repro_torch.data.synthetic import STEPS_PER_DAY
from repro_torch.data import synthetic as _synthetic


def minmax_normalize(series: np.ndarray) -> Tuple[np.ndarray, Tuple]:
    """series: (..., T). Returns normalized series + (min, max) for inversion."""
    lo = series.min(axis=-1, keepdims=True)
    hi = series.max(axis=-1, keepdims=True)
    scale = np.maximum(hi - lo, 1e-9)
    return (series - lo) / scale, (lo, hi)


def denormalize(x: np.ndarray, stats: Tuple) -> np.ndarray:
    lo, hi = stats
    return x * np.maximum(hi - lo, 1e-9) + lo


def make_windows(series: np.ndarray, lookback: int, horizon: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """series: (T,) -> x: (n, lookback, 1), y: (n, horizon)."""
    T = series.shape[-1]
    n = T - lookback - horizon + 1
    idx = np.arange(lookback)[None, :] + np.arange(n)[:, None]
    x = series[idx][..., None].astype(np.float32)
    yidx = lookback + np.arange(horizon)[None, :] + np.arange(n)[:, None]
    y = series[yidx].astype(np.float32)
    return x, y


def train_test_split(series: np.ndarray, frac: float = 0.75):
    """Chronological split of a (T,) series."""
    cut = int(series.shape[-1] * frac)
    return series[..., :cut], series[..., cut:]


def daily_average_vector(series: np.ndarray, days: int = 273) -> np.ndarray:
    """Privacy-coarsened consumption summary z_k (Alg. 1): daily means of the
    *training* period.  series: (..., T) -> (..., days)."""
    t = days * STEPS_PER_DAY
    s = series[..., :t]
    return s.reshape(*s.shape[:-1], days, STEPS_PER_DAY).mean(axis=-1)


def client_dataset(series: np.ndarray, lookback: int, horizon: int,
                   train_frac: float = 0.75) -> Dict[str, np.ndarray]:
    """Full per-client pipeline: normalize -> split -> window.

    series: (T,) raw kWh. Returns dict with train/test windows (normalized)
    plus the min/max stats for de-normalization.
    """
    norm, stats = minmax_normalize(series)
    tr, te = train_test_split(norm, train_frac)
    x_tr, y_tr = make_windows(tr, lookback, horizon)
    x_te, y_te = make_windows(te, lookback, horizon)
    return {"x_train": x_tr, "y_train": y_tr, "x_test": x_te, "y_test": y_te,
            "stats": stats}


def batched_client_windows(all_series: np.ndarray, lookback: int, horizon: int,
                           train_frac: float = 0.75):
    """Vectorized pipeline over clients: (N, T) -> stacked train/test windows
    of shape (N, n_windows, ...), suitable for vmap/shard_map over axis 0."""
    norm, stats = minmax_normalize(all_series)
    cut = int(all_series.shape[-1] * train_frac)
    tr, te = norm[:, :cut], norm[:, cut:]

    def win(block):
        xs, ys = [], []
        for row in block:
            x, y = make_windows(row, lookback, horizon)
            xs.append(x)
            ys.append(y)
        return np.stack(xs), np.stack(ys)

    x_tr, y_tr = win(tr)
    x_te, y_te = win(te)
    return {"x_train": x_tr, "y_train": y_tr, "x_test": x_te, "y_test": y_te,
            "stats": stats}


# --------------------------------------------------- streaming provider
class ClientWindowProvider:
    """Lazy per-client normalization + windowing for O(m)-per-round training.

    ``series_fn(i)`` returns client ``i``'s raw (T_i,) kWh series; only the
    clients selected in a round are ever fetched, so a 10k+-client federation
    never materializes the full (N, n_win, L, 1) tensor.  ``lengths`` must be
    known up front (cheap metadata) so per-client window *counts* — the
    aggregation/sampling weights and the ragged count-masks — are available
    without touching any series.

    All batches share one fixed shape ``(m, n_win_max, L, 1)``: clients with
    fewer than ``n_win_max`` train windows are zero-padded and report their
    true count, and callers draw minibatch indices in ``[0, count_i)`` (see
    ``partition.ragged_minibatch_indices``), so padding is never read.  On
    equal-length histories every batch is bit-identical to the corresponding
    rows of :func:`batched_client_windows`.
    """

    def __init__(self, series_fn: Callable[[int], np.ndarray],
                 lengths: Sequence[int], lookback: int, horizon: int,
                 train_frac: float = 0.75, cache_size: int = 32):
        self._fn = series_fn
        self.lengths = np.asarray(lengths, np.int64)
        self.lookback, self.horizon = int(lookback), int(horizon)
        self.train_frac = float(train_frac)
        self._cuts = np.array([int(t * train_frac) for t in self.lengths],
                              np.int64)
        win = lookback + horizon - 1
        self.train_counts = (self._cuts - win).astype(np.int64)
        self.test_counts = (self.lengths - self._cuts - win).astype(np.int64)
        bad = np.flatnonzero((self.train_counts < 1) | (self.test_counts < 1))
        if len(bad):
            raise ValueError(
                f"clients {bad[:8].tolist()} have too little history for "
                f"lookback={lookback}, horizon={horizon}, "
                f"train_frac={train_frac} (min length "
                f"{int(self.lengths[bad].min())})")
        self.n_win_max = int(self.train_counts.max())
        self.test_win_max = int(self.test_counts.max())
        self._cache: "OrderedDict[int, Dict[str, np.ndarray]]" = OrderedDict()
        self._raw: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._cache_size = int(cache_size)

    # ------------------------------------------------------- constructors
    @classmethod
    def from_series(cls, series: Union[np.ndarray, Sequence[np.ndarray]],
                    lookback: int, horizon: int, train_frac: float = 0.75,
                    cache_size: int = 32) -> "ClientWindowProvider":
        """Wrap an in-memory (N, T) array or a ragged list of (T_i,) series."""
        if isinstance(series, np.ndarray) and series.ndim == 2:
            lengths = [series.shape[1]] * series.shape[0]
            fn = lambda i: series[i]
        else:
            rows = [np.asarray(s).reshape(-1) for s in series]
            lengths = [len(s) for s in rows]
            fn = lambda i: rows[i]
        return cls(fn, lengths, lookback, horizon, train_frac, cache_size)

    @classmethod
    def from_synthetic(cls, state: str, building_ids: Sequence[int],
                       lookback: int, horizon: int,
                       days: Union[int, Sequence[int]] = 365,
                       train_frac: float = 0.75, cache_size: int = 32
                       ) -> "ClientWindowProvider":
        """On-demand generator variant: client i's year is synthesized only
        when selected (deterministic in (state, building_id)), so population
        size N costs metadata only.  ``days`` may be per-client for ragged
        histories."""
        ids = list(building_ids)
        days_arr = np.broadcast_to(np.asarray(days, np.int64), (len(ids),))
        fn = lambda i: _synthetic.generate_buildings(
            state, [ids[i]], days=int(days_arr[i]))[0]
        return cls(fn, days_arr * STEPS_PER_DAY, lookback, horizon,
                   train_frac, cache_size)

    @property
    def n_clients(self) -> int:
        return len(self.lengths)

    # ------------------------------------------------------- per-client core
    def _series(self, i: int) -> np.ndarray:
        """Fetch client i's raw series — the ONE fetch point (`_client` and
        `daily_summary` share it), with its own small LRU so clustering
        summaries and the rounds that follow don't regenerate series
        back-to-back.  Kept in the source dtype: normalizing in the series'
        own precision keeps provider batches bit-identical to
        batched_client_windows rows."""
        hit = self._raw.get(i)
        if hit is not None:
            self._raw.move_to_end(i)
            return hit
        series = np.asarray(self._fn(i)).reshape(-1)
        if series.shape[0] != self.lengths[i]:
            raise ValueError(f"client {i}: series_fn returned length "
                             f"{series.shape[0]}, expected {self.lengths[i]}")
        if self._cache_size > 0:
            self._raw[i] = series
            while len(self._raw) > self._cache_size:
                self._raw.popitem(last=False)
        return series

    def _client(self, i: int) -> Dict[str, np.ndarray]:
        """Normalize + split + window ONE client (LRU-cached, unpadded)."""
        hit = self._cache.get(i)
        if hit is not None:
            self._cache.move_to_end(i)
            return hit
        series = self._series(i)
        norm, (lo, hi) = minmax_normalize(series)
        cut = self._cuts[i]
        x_tr, y_tr = make_windows(norm[:cut], self.lookback, self.horizon)
        x_te, y_te = make_windows(norm[cut:], self.lookback, self.horizon)
        out = {"x_train": x_tr, "y_train": y_tr, "x_test": x_te,
               "y_test": y_te, "lo": np.float32(lo[0]),
               "hi": np.float32(hi[0])}
        if self._cache_size > 0:
            self._cache[i] = out
            while len(self._cache) > self._cache_size:
                self._cache.popitem(last=False)
        return out

    def _stack(self, ids, xk: str, yk: str, counts: np.ndarray, n_max: int):
        ids = np.asarray(ids)
        x0 = self._client(int(ids[0]))[xk]
        x = np.zeros((len(ids), n_max) + x0.shape[1:], np.float32)
        y = np.zeros((len(ids), n_max, self.horizon), np.float32)
        for j, i in enumerate(ids):
            c = self._client(int(i))
            x[j, :counts[j]] = c[xk]
            y[j, :counts[j]] = c[yk]
        return x, y

    # ----------------------------------------------------------- round API
    def round_batch(self, ids) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Train windows for the clients selected THIS round.

        Returns ``(x, y, counts)`` with x: (m, n_win_max, L, 1),
        y: (m, n_win_max, H), counts: (m,) float32 valid-window counts.
        """
        with tracing.span("fl.round_batch", clients=len(ids)):
            counts = self.train_counts[np.asarray(ids)]
            x, y = self._stack(ids, "x_train", "y_train", counts,
                               self.n_win_max)
            return x, y, counts.astype(np.float32)

    def test_batch(self, ids):
        """Test windows + per-client (lo, hi) stats, same padding scheme."""
        ids = np.asarray(ids)
        counts = self.test_counts[ids]
        x, y = self._stack(ids, "x_test", "y_test", counts, self.test_win_max)
        lo = np.array([[self._client(int(i))["lo"]] for i in ids], np.float32)
        hi = np.array([[self._client(int(i))["hi"]] for i in ids], np.float32)
        return x, y, counts.astype(np.float32), (lo, hi)

    def iter_test_flat(self, ids=None, clients_per_chunk: int = 64
                       ) -> Iterator[Tuple[np.ndarray, np.ndarray, Tuple]]:
        """Stream flat test windows in client chunks for O(chunk) eval memory.

        Yields ``(x, y, (lo, hi))`` with only VALID windows (no padding), the
        row-repeated stats matching :func:`flatten_test_windows` layout.
        """
        ids = np.arange(self.n_clients) if ids is None else np.asarray(ids)
        for s in range(0, len(ids), clients_per_chunk):
            chunk = ids[s:s + clients_per_chunk]
            xs, ys, los, his = [], [], [], []
            for i in chunk:
                c = self._client(int(i))
                xs.append(c["x_test"])
                ys.append(c["y_test"])
                n = len(c["x_test"])
                los.append(np.full((n, 1), c["lo"], np.float32))
                his.append(np.full((n, 1), c["hi"], np.float32))
            yield (np.concatenate(xs), np.concatenate(ys),
                   (np.concatenate(los), np.concatenate(his)))

    # ------------------------------------------------------------ summaries
    def daily_summary(self, ids, days: int) -> np.ndarray:
        """Privacy-coarsened per-client daily means (Alg. 1's z_k), streamed.

        Matches :func:`daily_average_vector` on clients with ≥ ``days`` days
        of training history; shorter (ragged) clients contribute only their
        TRAIN-period days (never the chronological test split, which must not
        inform cluster assignment) and are right-padded with their own mean
        so k-means sees a fixed-width summary.
        """
        ids = np.asarray(ids)
        out = np.empty((len(ids), days), np.float64)
        for j, i in enumerate(ids):
            series = self._series(int(i))
            cut = int(self._cuts[i])
            d = min(days, cut // STEPS_PER_DAY)
            if d == 0:      # train period shorter than one day: flat summary
                out[j, :] = series[:cut].mean()
                continue
            z = series[:d * STEPS_PER_DAY].reshape(d, STEPS_PER_DAY).mean(-1)
            out[j, :d] = z
            out[j, d:] = z.mean()
        return out


def flatten_test_windows(data):
    """(N, n_win, ...) stacked test windows -> flat (N*n_win, ...) plus the
    per-row (lo, hi) stats for kWh-space metric computation."""
    x = data["x_test"]
    n, n_win = x.shape[:2]
    lo, hi = data["stats"]
    rep = lambda a: np.repeat(a, n_win, axis=0)
    return (x.reshape(n * n_win, *x.shape[2:]),
            data["y_test"].reshape(n * n_win, -1),
            (rep(lo), rep(hi)))
