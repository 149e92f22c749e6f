"""MATLAB ``.mat`` I/O (port of ``waveforminversionust_tpu.data.matio``).

The reference's ``RecordedData.mat`` is a MATLAB v7.3 file (HDF5 with MATLAB
attributes) and ``REC.mat`` a classic v5 file. v5 files go through
``scipy.io``; v7.3 files need h5py, which is imported only when such a file
is read or written, so that a host without h5py still reads v5 files and
imports this module. Without h5py, ``save_mat`` writes v5.
"""

from __future__ import annotations

import warnings

import numpy as np

_HDF5_SIGNATURE = b"\x89HDF\r\n\x1a\n"


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise RuntimeError("h5py is required for MATLAB v7.3 (HDF5) .mat "
                           "files and is not installed") from e
    return h5py


def _is_hdf5(path: str) -> bool:
    # MATLAB v7.3 files carry a 512-byte userblock, so the HDF5 signature
    # sits at offset 512, not 0.
    with open(path, "rb") as fh:
        head = fh.read(1024 + 8)
    return any(head[o:o + 8] == _HDF5_SIGNATURE for o in (0, 512, 1024))


def _from_h5(node):
    data = np.asarray(node)
    if data.dtype.names and set(data.dtype.names) >= {"real", "imag"}:
        data = data["real"] + 1j * data["imag"]
    # MATLAB v7.3 stores arrays transposed (column-major on disk).
    return data.T


def load_mat(path: str) -> dict:
    """Load a .mat file (v7.3/HDF5 or classic v5) into {name: ndarray}, in
    MATLAB's logical orientation (the reference's ``REC_DATA`` as (256, 256)
    [tx, rx])."""
    if _is_hdf5(path):
        h5py = _h5py()
        out = {}
        with h5py.File(path, "r") as fh:
            for key in fh.keys():
                if key.startswith("#"):
                    continue
                node = fh[key]
                if isinstance(node, h5py.Dataset):
                    out[key] = _from_h5(node)
        return out
    from scipy.io import loadmat as scipy_loadmat
    raw = scipy_loadmat(path)
    return {k: v for k, v in raw.items() if not k.startswith("__")}


def _matlab_2d(value: np.ndarray) -> np.ndarray:
    """MATLAB's view of an array: a scalar as 1x1, a vector as a column."""
    if value.ndim == 0:
        return value.reshape(1, 1)
    if value.ndim == 1:
        return value.reshape(-1, 1)
    return value


def save_mat(path: str, arrays: dict) -> None:
    """Write a MATLAB v7.3-compatible (HDF5) .mat file: numeric arrays only,
    complex data as MATLAB's compound real/imag dtype, arrays transposed to
    column-major as MATLAB expects. On a host without h5py the same arrays
    (0-d as 1x1, 1-d as columns) go into a classic v5 file through
    ``scipy.io``, which MATLAB and :func:`load_mat` read as well, and a
    warning names the format written."""
    try:
        import h5py
    except ImportError:
        from scipy.io import savemat
        warnings.warn(f"h5py is not installed: {path} is written as a MATLAB "
                      "v5 file, not v7.3", stacklevel=2)
        savemat(path, {name: _matlab_2d(np.asarray(value))
                       for name, value in arrays.items()})
        return
    userblock = 512
    with h5py.File(path, "w", userblock_size=userblock) as fh:
        for name, value in arrays.items():
            value = _matlab_2d(np.asarray(value))
            matlab_class = {
                "f8": b"double", "f4": b"single",
                "i4": b"int32", "i8": b"int64",
            }.get(value.dtype.str[1:], b"double")
            if np.iscomplexobj(value):
                comp = np.empty(value.T.shape,
                                dtype=[("real", "<f8"), ("imag", "<f8")])
                comp["real"] = value.T.real
                comp["imag"] = value.T.imag
                ds = fh.create_dataset(name, data=comp)
                matlab_class = b"double"
            else:
                ds = fh.create_dataset(name, data=value.T.astype(np.float64)
                                       if value.dtype.kind == "f" else value.T)
            ds.attrs["MATLAB_class"] = np.bytes_(matlab_class)
    # MATLAB v7.3 magic header in the HDF5 userblock.
    header = ("MATLAB 7.3 MAT-file, written by waveforminversionust_tpu_torch"
              .encode().ljust(116, b" ")
              + b"\x00" * 8 + np.uint16(0x0200).tobytes() + b"HM")
    with open(path, "r+b") as fh:
        fh.write(header[:128])


def load_recorded_dataset(path: str):
    """Load a RecordedData.mat-schema file (SimulateData.m:62-63) into a
    :class:`~.synthesize.RingDataset`."""
    from .synthesize import RingDataset
    raw = load_mat(path)
    return RingDataset(
        x=np.asarray(raw["x"]).ravel(),
        y=np.asarray(raw["y"]).ravel(),
        c=np.asarray(raw["C"]),
        x_circ=np.asarray(raw["x_circ"]).ravel(),
        y_circ=np.asarray(raw["y_circ"]).ravel(),
        f=float(np.asarray(raw["f"]).ravel()[0]),
        rec_data=np.asarray(raw["REC_DATA"]).astype(np.complex64),
    )


def save_recorded_dataset(path: str, ds) -> None:
    """Write a RingDataset in the RecordedData.mat schema."""
    save_mat(path, {
        "x": ds.x.reshape(-1, 1), "y": ds.y.reshape(-1, 1), "C": ds.c,
        "x_circ": ds.x_circ.reshape(-1, 1), "y_circ": ds.y_circ.reshape(-1, 1),
        "f": np.float64(ds.f), "REC_DATA": ds.rec_data.astype(np.complex128),
    })
