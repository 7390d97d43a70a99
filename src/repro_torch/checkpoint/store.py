"""The manifest layer of ``repro.checkpoint.store``, without JAX or ml_dtypes.

A *manifest directory* is a directory of ``.npy`` files plus a
``manifest.json`` recording name/file/shape/dtype/crc32 per array and
arbitrary JSON ``extra`` metadata.  Writes go to ``<dir>.tmp`` and are
renamed into place after the manifest is fsynced, so a crash mid-write never
corrupts the latest good artifact.  The format is the reference's byte for
byte, so a directory either package writes, the other reads.

Numpy has no bfloat16 or float8 types.  The reference stores such arrays as
raw void records (``V2`` for bf16, ``V1`` for fp8) and records the logical
dtype (``"bfloat16"``, ``"float8_e4m3fn"``, ``"float8_e5m2"``) in the
manifest; here they travel as their raw bits, in the unsigned integer of the
same width, and the writer takes their logical dtype in a side mapping
(``dtypes``).  The reader hands them back as raw bits too.
"""

from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

#: logical name of each narrow float dtype -> the numpy type of its raw bits
NARROW_DTYPES = {
    "bfloat16": np.uint16,
    "float8_e4m3fn": np.uint8,
    "float8_e5m2": np.uint8,
}


def write_manifest_dir(final: str, arrays: Mapping[str, np.ndarray],
                       extra: Optional[Dict] = None,
                       dtypes: Optional[Mapping[str, str]] = None) -> str:
    """Atomically write named arrays + JSON metadata as a manifest directory.

    Each array lands as ``<name>.npy`` with its crc32 recorded in
    ``manifest.json``; the whole directory is staged at ``<final>.tmp`` and
    renamed into place after the manifest is fsynced.  ``dtypes`` names the
    logical dtype of arrays handed over as raw bits (a key of
    ``NARROW_DTYPES``); each such array must hold that dtype's raw-bits
    type.  Array names must be filesystem-safe.
    """
    dtypes = dict(dtypes or {})
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"arrays": [], "extra": extra or {}}
    for name, value in arrays.items():
        arr = np.asarray(value)
        fname = f"{name}.npy"
        dtype = dtypes.pop(name, None)
        disk = arr
        if dtype is not None:
            bits = NARROW_DTYPES.get(dtype)
            if bits is None or arr.dtype != bits:
                raise ValueError(
                    f"{name}: logical dtype {dtype!r} needs its raw bits as "
                    f"{np.dtype(bits).name if bits else 'a known type'}, "
                    f"got {arr.dtype}")
            # raw void records, as the reference writes extended dtypes
            disk = arr.view(f"V{arr.dtype.itemsize}")
        np.save(os.path.join(tmp, fname), disk)
        manifest["arrays"].append({
            "name": name, "file": fname, "shape": list(arr.shape),
            "dtype": dtype or str(arr.dtype),
            "crc": zlib.crc32(arr.tobytes()) & 0xFFFFFFFF,
        })
    if dtypes:
        raise ValueError(f"dtypes names arrays not written: {sorted(dtypes)}")
    mpath = os.path.join(tmp, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def read_manifest_dir(path: str, verify: bool = True
                      ) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Load a manifest directory back as ``(arrays, extra)``.

    Narrow float arrays (void records whose manifest dtype is a key of
    ``NARROW_DTYPES``) come back as their raw bits; ``verify`` checks every
    crc and raises ``IOError`` on corruption.
    """
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if "arrays" not in manifest and "leaves" in manifest:
        # legacy checkpoint manifest (pre-manifest-layer format): same
        # per-record fields under "leaves", tree metadata at top level
        manifest = {
            "arrays": [{**rec, "name": rec["file"][:-len(".npy")]}
                       for rec in manifest["leaves"]],
            "extra": {"step": manifest["step"],
                      "n_leaves": manifest["n_leaves"],
                      "paths": [rec["path"] for rec in manifest["leaves"]],
                      "extra": manifest.get("extra", {})},
        }
    arrays: Dict[str, np.ndarray] = {}
    for rec in manifest["arrays"]:
        arr = np.load(os.path.join(path, rec["file"]))
        if arr.dtype.kind == "V" and rec["dtype"] in NARROW_DTYPES:
            arr = arr.view(NARROW_DTYPES[rec["dtype"]])
        if verify and (zlib.crc32(arr.tobytes()) & 0xFFFFFFFF) != rec["crc"]:
            raise IOError(f"crc mismatch in {rec['file']} ({rec['name']})")
        arrays[rec["name"]] = arr
    return arrays, manifest.get("extra", {})


def manifest_exists(path: str) -> bool:
    return os.path.exists(os.path.join(path, "manifest.json"))
