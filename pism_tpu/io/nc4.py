"""CF/NetCDF-4 compatible file I/O on h5py.

The reference (PISM ``src/util/io/``) reads/writes NetCDF with pluggable
backends (serial NetCDF, parallel NetCDF-4/HDF5, PNetCDF, PIO). NetCDF-4
files ARE HDF5 files; this module writes HDF5 with netCDF-4 conventions
(dimension scales, ``_Netcdf4Dimid``/``_Netcdf4Coordinates`` attributes,
``_NCProperties``) so standard NetCDF tools (ncdump, xarray, PISM itself)
can open our output, without requiring the netCDF4 python package.

Fields are fetched from the device and written on the host (the analog of
PISM's collective writes); inside jitted loops I/O goes through host
callbacks scheduled at segment boundaries (see model.output).

h5py is an I/O-only dependency: the model's stepping path never imports it,
and a NetCDF-4 file opened without it raises :data:`H5PY_MISSING`.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

try:
    import h5py
except ImportError:   # output-only dependency; see the module docstring
    h5py = None

H5PY_MISSING = ("NetCDF-4 (HDF5) files need the h5py package, which is not "
                "installed: install h5py or write classic NetCDF with "
                "-o_format netcdf3 -o_size small")

_NC_PROPS = b"version=2,pism_tpu=0.1"


class File:
    """Minimal NetCDF-4-compatible file (PISM ``pism::File`` analog).

    Opening an existing file for reading sniffs the magic number: classic
    NetCDF (CDF-1/2/5 — the format most PISM input files ship in) is
    served read-only through scipy; NetCDF-4/HDF5 through h5py. The
    reference supports the same formats via the NetCDF C library
    (``io::NCFile`` backends)."""

    def __new__(cls, path: str, mode: str = "r", format: str = "netcdf4"):
        if cls is File and mode == "r":
            with open(path, "rb") as fh:
                magic = fh.read(3)
            if magic == b"CDF":
                return ClassicFile(path)
        if cls is File and mode in ("w", "w-", "x") and format == "netcdf3":
            return ClassicWriteFile(path)
        return super().__new__(cls)

    #: gzip deflate level applied to newly defined non-scalar variables
    #: (reference output.compression_level; 0 = off). Set per-process via
    #: set_compression_level (output.py reads the config).
    compression_level = 0

    @classmethod
    def set_compression_level(cls, level: int):
        cls.compression_level = int(level)

    def __init__(self, path: str, mode: str = "r", format: str = "netcdf4"):
        if h5py is None:
            raise ImportError(H5PY_MISSING)
        self.h5 = h5py.File(path, mode)
        if mode in ("w", "w-", "x"):
            self.h5.attrs.create("_NCProperties", _NC_PROPS)
        self._dims: Dict[str, int] = {}
        if mode == "r" or mode == "a":
            for name, ds in self.h5.items():
                if isinstance(ds, h5py.Dataset) and ds.attrs.get("CLASS") == b"DIMENSION_SCALE":
                    self._dims[name] = ds.shape[0] if ds.shape else 0

    # -- dimensions ----------------------------------------------------------
    def define_dimension(self, name: str, length: Optional[int],
                         values: Optional[np.ndarray] = None,
                         attrs: Optional[dict] = None):
        """length=None creates an unlimited (time) dimension."""
        if name in self.h5:
            return
        if length is None:
            ds = self.h5.create_dataset(name, shape=(0,), maxshape=(None,),
                                        dtype="f8")
            self._dims[name] = 0
        else:
            data = values if values is not None else np.zeros(length)
            ds = self.h5.create_dataset(name, data=np.asarray(data, "f8"))
            self._dims[name] = length
        ds.make_scale(name)
        ds.attrs["_Netcdf4Dimid"] = np.int32(len(self._dims) - 1)
        for k, v in (attrs or {}).items():
            ds.attrs[k] = v

    def dimension_length(self, name: str) -> int:
        return self.h5[name].shape[0]

    # -- variables -----------------------------------------------------------
    def define_variable(self, name: str, dims, dtype="f8",
                        attrs: Optional[dict] = None):
        if name in self.h5:
            return self.h5[name]
        shape = tuple(self.h5[d].shape[0] for d in dims)
        maxshape = tuple(None if self.h5[d].maxshape[0] is None else self.h5[d].shape[0]
                         for d in dims)
        fill = (attrs or {}).get("_FillValue")
        kw = {}
        if self.compression_level > 0 and len(shape) >= 2:
            kw = dict(compression="gzip",
                      compression_opts=min(self.compression_level, 9),
                      chunks=True)
        ds = self.h5.create_dataset(name, shape=shape, maxshape=maxshape,
                                    dtype=dtype, fillvalue=fill, **kw)
        for i, d in enumerate(dims):
            ds.dims[i].attach_scale(self.h5[d])
        for k, v in (attrs or {}).items():
            if k != "_FillValue":
                ds.attrs[k] = v
        return ds

    def write(self, name: str, data, dims=None, attrs=None, time_index=None):
        """Write a variable; with time_index, append/overwrite one record of
        a time-dependent variable (first dim = time)."""
        data = np.asarray(data)
        if name not in self.h5:
            if dims is None:
                raise ValueError(f"new variable {name!r} needs dims")
            self.define_variable(name, dims, dtype=data.dtype, attrs=attrs)
        ds = self.h5[name]
        if time_index is None:
            ds[...] = data
        else:
            if ds.shape[0] <= time_index:
                ds.resize(time_index + 1, axis=0)
            ds[time_index, ...] = data

    def append_time(self, t: float, name: str = "time"):
        ds = self.h5[name]
        n = ds.shape[0]
        ds.resize(n + 1, axis=0)
        ds[n] = t
        return n

    def read(self, name: str) -> np.ndarray:
        return np.asarray(self.h5[name])

    def read_slice(self, name: str, index: int) -> np.ndarray:
        """Read one leading-dimension slice lazily (no full-variable load)."""
        return np.asarray(self.h5[name][index])

    def read_attrs(self, name: str) -> dict:
        return dict(self.h5[name].attrs)

    def variables(self):
        return [k for k, v in self.h5.items()
                if isinstance(v, h5py.Dataset)
                and v.attrs.get("CLASS") != b"DIMENSION_SCALE"]

    def set_global_attr(self, key: str, value):
        self.h5.attrs[key] = value

    def get_global_attr(self, key: str):
        v = self.h5.attrs.get(key)
        if isinstance(v, bytes):
            v = v.decode()
        return v

    def has_variable(self, name):
        return name in self.h5

    def close(self):
        self.h5.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class ClassicFile:
    """Read-only classic NetCDF (CDF-1/2/5) backend on scipy, with the
    same reading interface as :class:`File`."""

    def __init__(self, path: str):
        from scipy.io import netcdf_file
        # mmap keeps reads lazy (read_slice of big forcing variables)
        self.nc = netcdf_file(path, "r", mmap=True, maskandscale=False)

    @staticmethod
    def _decode(v):
        return v.decode() if isinstance(v, bytes) else v

    def dimension_length(self, name: str) -> int:
        n = self.nc.dimensions[name]
        if n is None:   # unlimited: take the record count from a variable
            for var in self.nc.variables.values():
                if var.dimensions and var.dimensions[0] == name:
                    return var.shape[0]
            return 0
        return n

    @staticmethod
    def _native(arr):
        """Classic NetCDF data is big-endian; jax only takes native."""
        if arr.dtype.byteorder == ">":
            return arr.astype(arr.dtype.newbyteorder("="))
        return arr

    def read(self, name: str) -> np.ndarray:
        return self._native(np.array(self.nc.variables[name].data))

    def read_slice(self, name: str, index: int) -> np.ndarray:
        return self._native(np.array(self.nc.variables[name].data[index]))

    def read_attrs(self, name: str) -> dict:
        return {k: self._decode(v)
                for k, v in self.nc.variables[name]._attributes.items()}

    def variables(self):
        return [k for k in self.nc.variables if k not in self.nc.dimensions]

    def get_global_attr(self, key: str):
        return self._decode(self.nc._attributes.get(key))

    def has_variable(self, name):
        return name in self.nc.variables

    def close(self):
        self.nc.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class ClassicWriteFile:
    """Classic NetCDF (CDF-2 / 64-bit offset) WRITER through scipy, with
    the same interface as :class:`File` (reference ``-o_format netcdf3``:
    output readable by tools without HDF5 support). The unlimited (time)
    dimension must come first in variable shapes, as in the classic data
    model."""

    def __init__(self, path: str):
        from scipy.io import netcdf_file
        self.nc = netcdf_file(path, "w", version=2)
        self._unlimited = None

    # -- dimensions ----------------------------------------------------------
    def define_dimension(self, name, length, values=None, attrs=None):
        if name in self.nc.dimensions:
            return
        self.nc.createDimension(name, length)
        if length is None:
            self._unlimited = name
            v = self.nc.createVariable(name, "d", (name,))
        else:
            v = self.nc.createVariable(name, "d", (name,))
            v[:] = np.asarray(values if values is not None
                              else np.zeros(length), "d")
        for k, val in (attrs or {}).items():
            setattr(v, k, val)

    def dimension_length(self, name):
        n = self.nc.dimensions[name]
        if n is None:
            var = self.nc.variables.get(name)
            return var.shape[0] if var is not None and var.shape else 0
        return n

    # -- variables -----------------------------------------------------------
    def define_variable(self, name, dims, dtype="f8", attrs=None):
        if name in self.nc.variables:
            return self.nc.variables[name]
        tc = np.dtype(dtype).char
        if tc == "l":
            tc = "i"      # classic NetCDF-2 has no 64-bit ints
        if tc in ("?",):
            tc = "b"
        v = self.nc.createVariable(name, tc, tuple(dims))
        for k, val in (attrs or {}).items():
            if k != "_FillValue":
                setattr(v, k, val)
        return v

    def write(self, name, data, dims=None, attrs=None, time_index=None):
        data = np.asarray(data)
        if name not in self.nc.variables:
            if dims is None:
                raise ValueError(f"new variable {name!r} needs dims")
            dt = data.dtype
            if dt == np.int64:
                dt = np.int32
            self.define_variable(name, dims, dtype=dt, attrs=attrs)
        v = self.nc.variables[name]
        if time_index is None:
            v[:] = data.astype(v.data.dtype) if v.shape else data
        else:
            v[time_index] = np.asarray(data)[0] if data.ndim == len(v.dimensions) \
                else data

    def append_time(self, t, name="time"):
        v = self.nc.variables[name]
        n = v.shape[0] if v.shape else 0
        v[n] = float(t)
        return n

    # -- attrs / misc ----------------------------------------------------------
    def set_global_attr(self, key, value):
        setattr(self.nc, key, value)

    def get_global_attr(self, key):
        v = self.nc._attributes.get(key)
        return v.decode() if isinstance(v, bytes) else v

    def read(self, name):
        return np.array(self.nc.variables[name].data)

    def read_attrs(self, name):
        return {k: (v.decode() if isinstance(v, bytes) else v)
                for k, v in self.nc.variables[name]._attributes.items()}

    def variables(self):
        return [k for k in self.nc.variables if k not in self.nc.dimensions]

    def has_variable(self, name):
        return name in self.nc.variables

    def close(self):
        self.nc.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
