"""Streamed time-series forcing with asynchronous read-ahead.

The reference's ``-atmosphere given``/``-surface given`` read monthly
forcing fields from NetCDF on the fly during the run; this rebuild must
do the same without stalling the device loop on file I/O (SURVEY.md §5
hard part: "async prefetch of forcing time slices"). Small forcings are
simply pre-loaded to the device as ``(Nt, My, Mx)`` stacks (see
``coupler/atmosphere.py Given``); this module covers forcings too large
for HBM:

- a :class:`ForcingStream` keeps a bounded host-RAM cache of decoded time
  slices, and a reader thread prefetches the next ``lookahead`` slices
  whenever one is consumed — the NetCDF/HDF5 decode happens concurrently
  with device compute;
- inside the jitted step, ``slice_at(t)`` is a ``jax.pure_callback``: the
  host side only does a RAM lookup (the prefetcher has already read the
  slice) plus one host->device copy of a single field.

Piecewise-constant-in-time lookup with end clamping and optional
periodization, matching the pre-loaded couplers' semantics.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np

from ..io.nc4 import File


class ForcingStream:
    def __init__(self, path: str, var: str, time_var: str = "time", *,
                 lookahead: int = 4, cache_slices: int = 16,
                 period: float = None, dtype=np.float32,
                 time_extrapolation: bool = True):
        self.path = path
        self.var = var
        self.period = period
        self.lookahead = lookahead
        self.cache_slices = max(cache_slices, lookahead + 2)
        self.dtype = dtype
        #: reference input.forcing.time_extrapolation: with False, sampling
        #: outside the covered interval stops the run (PISM errors) instead
        #: of holding the end values
        self.time_extrapolation = time_extrapolation
        self._f = File(path, "r")
        self.times = np.asarray(self._f.read(time_var), np.float64)
        shp = self._f.h5[var].shape
        self.nt = shp[0]
        self.shape = tuple(shp[1:])
        self._cache: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._lock = threading.Lock()
        self._io_lock = threading.Lock()   # h5py handles are not thread-safe
        self.prefetch_hits = 0
        self.misses = 0

    # -- host side -------------------------------------------------------------
    def _read(self, idx: int) -> np.ndarray:
        with self._io_lock:
            return np.asarray(self._f.read_slice(self.var, idx), self.dtype)

    def _get(self, idx: int) -> np.ndarray:
        idx = int(np.clip(idx, 0, self.nt - 1))
        with self._lock:
            if idx in self._cache:
                self._cache.move_to_end(idx)
                self.prefetch_hits += 1
                hit = True
            else:
                hit = False
        if not hit:
            self.misses += 1
            data = self._read(idx)
            with self._lock:
                self._cache[idx] = data
        self._trigger_prefetch(idx)
        with self._lock:
            while len(self._cache) > self.cache_slices:
                self._cache.popitem(last=False)
            return self._cache[idx]

    def _trigger_prefetch(self, idx: int) -> None:
        def work():
            for j in range(idx + 1, idx + 1 + self.lookahead):
                jj = j % self.nt if self.period else min(j, self.nt - 1)
                with self._lock:
                    if jj in self._cache:
                        continue
                data = self._read(jj)
                with self._lock:
                    self._cache[jj] = data
        threading.Thread(target=work, daemon=True).start()

    def _index_of(self, t: float) -> int:
        tt = t % self.period if self.period else t
        if not self.time_extrapolation and not self.period:
            t0, t1 = self.times[0], self.times[-1]
            # the last record covers [times[-1], +one spacing)
            span = (self.times[-1] - self.times[0]) \
                / max(self.nt - 1, 1) if self.nt > 1 else 0.0
            if tt < t0 - 1e-6 or tt > t1 + span + 1e-6:
                raise RuntimeError(
                    f"forcing {self.var!r} from {self.path!r} does not "
                    f"cover model time {tt:.6g} s "
                    "(input.forcing.time_extrapolation is off)")
        return int(np.clip(np.searchsorted(self.times, tt, side="right") - 1,
                           0, self.nt - 1))

    @staticmethod
    def config_kwargs(config):
        """Streaming knobs from the config: buffer size from
        input.forcing.buffer_size (the pre-2.0 spelling
        climate_forcing.buffer_size wins when explicitly set) and the
        time-extrapolation policy."""
        n = config.get_int("climate_forcing.buffer_size") \
            if config.is_set("climate_forcing.buffer_size") \
            else config.get_int("input.forcing.buffer_size")
        return dict(cache_slices=n,
                    time_extrapolation=config.get_flag(
                        "input.forcing.time_extrapolation"))

    # -- traced side -------------------------------------------------------------
    def slice_at(self, t):
        """Forcing slice at model time t (piecewise constant), usable inside
        jit: a pure_callback that resolves to a host RAM lookup."""
        def host(tval):
            return self._get(self._index_of(float(tval)))

        out = jax.pure_callback(
            host, jax.ShapeDtypeStruct(self.shape, self.dtype), t)
        return out

    def close(self):
        self._f.close()
